"""Fold a run's host span trace into a per-phase wall-clock table
(tools/trace_report.py).

    python -m draco_tpu_torch.obs.trace_report DIR [--json FILE]

``DIR`` holds ``trace.json`` (written by ``obs/tracer.py`` under
``--trace-dir``) or is the file itself; ``metrics.jsonl`` beside it adds the
step count, the mean ``step_ms`` and the first and last loss. For each
phase (gather, dispatch, sync, flush, eval and the step's draco_* phases):
calls, total, mean and max milliseconds, and the share of the traced wall
(the envelope of all spans). The header shows the tracer's
``droppedEvents``: a long run's trace is a window of its newest spans.

It tolerates what a killed run leaves: a ``trace.json`` cut short (the
complete events before the cut are read and the header says so), a missing
or empty ``metrics.jsonl`` and a torn last line of it. It imports neither
torch nor the rest of the package.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys


def _salvage(text: str) -> list:
    """The complete events of a ``traceEvents`` array cut short."""
    start = text.find("[", max(text.find('"traceEvents"'), 0))
    if start < 0:
        return []
    dec = json.JSONDecoder()
    events, i = [], start + 1
    while True:
        while i < len(text) and text[i] in " \t\r\n,":
            i += 1
        if i >= len(text) or text[i] == "]":
            return events
        try:
            ev, i = dec.raw_decode(text, i)
        except ValueError:
            return events  # the torn tail
        if isinstance(ev, dict):
            events.append(ev)


def load_trace(path: str) -> "tuple[list, int, bool]":
    """(events, droppedEvents, torn)."""
    with open(path) as fh:
        text = fh.read()
    try:
        payload = json.loads(text)
    except ValueError:
        return _salvage(text), 0, True
    if isinstance(payload, list):  # the bare event-array form
        return payload, 0, False
    events = payload.get("traceEvents", [])
    if not isinstance(events, list):
        raise SystemExit(f"{path}: no traceEvents array")
    return events, int(payload.get("droppedEvents", 0) or 0), False


def fold_spans(events: list) -> "tuple[dict, float]":
    """name -> {count, total_ms, mean_ms, max_ms, share}; the traced wall is
    the envelope of all complete events."""
    by_name = collections.defaultdict(lambda: {"count": 0, "total_ms": 0.0,
                                               "max_ms": 0.0})
    t_lo, t_hi = float("inf"), float("-inf")
    for ev in events:
        if ev.get("ph") != "X" or "ts" not in ev:
            continue
        dur_ms = float(ev.get("dur", 0.0)) / 1e3
        row = by_name[ev["name"]]
        row["count"] += 1
        row["total_ms"] += dur_ms
        row["max_ms"] = max(row["max_ms"], dur_ms)
        t_lo = min(t_lo, float(ev["ts"]))
        t_hi = max(t_hi, float(ev["ts"]) + float(ev.get("dur", 0.0)))
    wall_ms = (t_hi - t_lo) / 1e3 if t_hi > t_lo else 0.0
    for row in by_name.values():
        row["mean_ms"] = row["total_ms"] / row["count"]
        row["share"] = row["total_ms"] / wall_ms if wall_ms else 0.0
    return dict(by_name), wall_ms


def fold_metrics(path: str) -> dict:
    """Step count, mean step_ms and the first/last loss of the training
    records of ``metrics.jsonl`` (eval records and torn lines skipped);
    {} when the file is missing."""
    recs = []
    try:
        fh = open(path)
    except OSError:
        return {}
    with fh:
        for line in fh:
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # blank, or the torn tail of an interrupted run
            if isinstance(rec, dict) and "loss" in rec \
                    and rec.get("split") != "eval":
                recs.append(rec)
    out = {"train_records": len(recs)}
    ms = [float(r["step_ms"]) for r in recs if "step_ms" in r]
    if ms:
        out["mean_step_ms"] = sum(ms) / len(ms)
    if recs:
        out["first_loss"] = recs[0]["loss"]
        out["last_loss"] = recs[-1]["loss"]
    return out


# the step's phases (obs/tracer.PHASES), as profiler ranges
DEVICE_PHASES = ("draco_comp", "draco_encode", "draco_decode",
                 "draco_update")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def fold_device_phases(events: list) -> dict:
    """Device time of a torch.profiler trace (Chrome format) by the step's
    phase: each kernel, copy or set is charged to the innermost draco_*
    range (``cat`` user_annotation) open when the runtime call that queued
    it was made (matched by ``correlation``), on any thread: the backward's
    kernels are launched by autograd's device thread while the step's
    thread waits inside draco_comp. Returns ``{"phases_ms": {phase: ms,
    "other": ms, "unattributed": ms}, "busy_ms": total}``: "other" is
    device work queued outside every phase, "unattributed" work whose
    runtime call the trace lacks."""
    ranges, launches = [], {}
    for ev in events:
        cat, args = ev.get("cat"), ev.get("args") or {}
        if cat == "user_annotation" and ev.get("name") in DEVICE_PHASES:
            ranges.append((float(ev["ts"]),
                           float(ev["ts"]) + float(ev.get("dur", 0)),
                           ev["name"]))
        elif cat in ("cuda_runtime", "cuda_driver") \
                and "correlation" in args:
            launches[args["correlation"]] = float(ev["ts"])
    out = {k: 0.0 for k in DEVICE_PHASES + ("other", "unattributed")}
    busy = 0.0
    for ev in events:
        if ev.get("cat") not in _DEVICE_CATS:
            continue
        dur = float(ev.get("dur", 0.0)) / 1e3
        busy += dur
        ts = launches.get((ev.get("args") or {}).get("correlation"))
        if ts is None:
            out["unattributed"] += dur
            continue
        held = [r for r in ranges if r[0] <= ts <= r[1]]
        # the innermost range: the latest to open
        out[max(held)[2] if held else "other"] += dur
    return {"phases_ms": out, "busy_ms": busy}


def make_report(trace_path: str, metrics_path=None) -> dict:
    events, dropped, torn = load_trace(trace_path)
    phases, wall_ms = fold_spans(events)
    report = {"trace": trace_path, "traced_wall_ms": wall_ms,
              "dropped_events": dropped, "torn": torn,
              "phases": dict(sorted(phases.items()))}
    if metrics_path:
        metrics = fold_metrics(metrics_path)
        if metrics:
            report["metrics"] = {**metrics, "path": metrics_path}
    return report


def print_table(report: dict, out=None) -> None:
    out = out if out is not None else sys.stdout
    head = (f"trace: {report['trace']}   traced wall: "
            f"{report['traced_wall_ms']:.1f} ms")
    if report["dropped_events"]:
        head += (f"   DROPPED EVENTS: {report['dropped_events']} (a window: "
                 f"totals undercount the run)")
    if report["torn"]:
        head += "   TORN FILE: the complete events before the cut"
    print(head, file=out)
    hdr = (f"{'phase':<22}{'count':>7}{'total ms':>12}{'mean ms':>10}"
           f"{'max ms':>10}{'share':>8}")
    print(hdr, file=out)
    print("-" * len(hdr), file=out)
    for name, r in sorted(report["phases"].items(),
                          key=lambda kv: -kv[1]["total_ms"]):
        print(f"{name:<22}{r['count']:>7}{r['total_ms']:>12.2f}"
              f"{r['mean_ms']:>10.3f}{r['max_ms']:>10.2f}"
              f"{r['share']:>8.1%}", file=out)
    m = report.get("metrics")
    if m:
        bits = [f"train_records={m['train_records']}"]
        if "mean_step_ms" in m:
            bits.append(f"mean step_ms={m['mean_step_ms']:.2f}")
        if "last_loss" in m:
            bits.append(f"loss {m['first_loss']:.4f} -> {m['last_loss']:.4f}")
        print("metrics: " + "  ".join(bits), file=out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", help="trace.json, or a directory holding it "
                                 "(and metrics.jsonl)")
    ap.add_argument("--metrics", default="",
                    help="metrics.jsonl (default: beside the trace)")
    ap.add_argument("--json", default="",
                    help="also write the folded report as JSON here")
    args = ap.parse_args(argv)
    trace_path = args.path
    if os.path.isdir(trace_path):
        trace_path = os.path.join(trace_path, "trace.json")
    metrics_path = args.metrics or os.path.join(
        os.path.dirname(trace_path), "metrics.jsonl")
    report = make_report(trace_path, metrics_path)
    print_table(report)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(report, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
