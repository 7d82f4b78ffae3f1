"""Fold a run's host span trace into a per-phase wall-clock table
(tools/trace_report.py).

    python -m draco_tpu_torch.obs.trace_report DIR [--json FILE]
        [--profile-dir P] [--merged FILE]

``DIR`` holds ``trace.json`` (written by ``obs/tracer.py`` under
``--trace-dir``) or is the file itself; ``metrics.jsonl`` beside it adds the
step count, the mean ``step_ms`` and the first and last loss. For each
phase (gather, dispatch, sync, flush, eval and the step's draco_* phases):
calls, total, mean and max milliseconds, and the share of the traced wall
(the envelope of all spans). The header shows the tracer's
``droppedEvents``: a long run's trace is a window of its newest spans.

It tolerates what a killed run leaves: a ``trace.json`` cut short (the
complete events before the cut are read and the header says so), a missing
or empty ``metrics.jsonl`` and a torn last line of it. With a profiler
capture (``--profile-dir P``, else the trace's own directory is probed) the
report grows the device table of ``obs/device_attr.fold_capture``: the
window's device time by phase, with ``other`` and ``unattributed``.
``--merged FILE`` writes the host spans and the capture's events as one
Perfetto-loadable timeline on the tracer's clock
(``obs/device_attr.merge_timeline``, anchored by the capture's
``host_anchor.json``), keeping the longest ``MERGED_DEVICE_EVENTS``
device events (a viewer loads no more) and naming the count it dropped.
It imports neither torch nor the package's modules beyond
``obs/device_attr.py``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
from typing import Optional

from draco_tpu_torch.obs import device_attr
from draco_tpu_torch.obs.device_attr import fold_capture, fold_device_phases

# the merged timeline's longest device events kept
MERGED_DEVICE_EVENTS = 100_000

__all__ = ["fold_device", "fold_device_phases", "fold_metrics", "fold_spans",
           "load_trace", "main", "make_report", "merged_timeline",
           "print_table"]


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


def fold_device(profile_dir: str) -> Optional[dict]:
    """The device half: a profiler capture under ``profile_dir``
    (``obs/profiling.py``) folded by ``obs/device_attr.fold_capture`` into
    the per-phase device table; None when there is none, or it is torn."""
    fold = fold_capture(profile_dir)
    if not fold:
        return None
    out = {"trace": fold["trace"], "programs": []}
    steps = (fold.get("anchor") or {}).get("steps_profiled")
    if steps is not None:
        out["steps_profiled"] = steps
    for prog in fold["programs"]:
        out["programs"].append({
            "module": prog["module"], "mode": prog["mode"],
            "total_device_us": round(prog["total_device_us"], 1),
            "busy_us": round(prog["busy_us"], 1),
            "wall_us": round(prog["wall_us"], 1),
            "replays": prog["replays"],
            "replays_mapped": prog["replays_mapped"],
            "phases": {k: {"time_us": round(v["time_us"], 1),
                           "frac": round(v["frac"], 4),
                           "events": v["events"]}
                       for k, v in prog["phases"].items()},
            "collectives": prog["collectives"]})
    return out


def make_report(trace_path: str, metrics_path=None,
                profile_dir=None) -> dict:
    events, dropped, torn = load_trace(trace_path)
    phases, wall_ms = fold_spans(events)
    report = {"trace": trace_path, "traced_wall_ms": wall_ms,
              "dropped_events": dropped, "torn": torn,
              "phases": dict(sorted(phases.items()))}
    if metrics_path:
        metrics = fold_metrics(metrics_path)
        if metrics:
            report["metrics"] = {**metrics, "path": metrics_path}
    # the device half: by default the trace's own directory is probed
    device = fold_device(profile_dir or os.path.dirname(trace_path) or ".")
    if device:
        report["device"] = device
    return report


def merged_timeline(trace_path: str, profile_dir: str) -> Optional[dict]:
    """The host spans of ``trace_path`` and the capture under
    ``profile_dir`` on one clock (``device_attr.merge_timeline``); None
    when there is no capture."""
    path = device_attr.find_capture(profile_dir)
    if path is None:
        return None
    host, _, _ = load_trace(trace_path)
    events, _ = device_attr.load_trace(path)
    return device_attr.merge_timeline(
        host, events, device_attr.load_anchor(profile_dir),
        max_device_events=MERGED_DEVICE_EVENTS)


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
    dev = report.get("device")
    for prog in (dev or {}).get("programs", []):
        steps = dev.get("steps_profiled")
        print(f"device program {prog['module']} ({prog['mode']}): "
              f"{prog['total_device_us'] / 1e3:.1f} ms device time "
              f"({prog['busy_us'] / 1e3:.1f} ms busy)"
              + (f" over {steps} profiled steps" if steps else "")
              + (f", {prog['replays_mapped']} of {prog['replays']} graph "
                 f"replays mapped" if prog["replays"] else ""), file=out)
        hdr = (f"  {'device phase':<20}{'events':>8}{'total ms':>12}"
               f"{'share':>8}")
        print(hdr, file=out)
        print("  " + "-" * (len(hdr) - 2), file=out)
        for name, r in sorted(prog["phases"].items(),
                              key=lambda kv: -kv[1]["time_us"]):
            print(f"  {name:<20}{r['events']:>8}{r['time_us'] / 1e3:>12.2f}"
                  f"{r['frac']:>8.1%}", file=out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", help="trace.json, or a directory holding it "
                                 "(and metrics.jsonl)")
    ap.add_argument("--metrics", default="",
                    help="metrics.jsonl (default: beside the trace)")
    ap.add_argument("--json", default="",
                    help="also write the folded report as JSON here")
    ap.add_argument("--profile-dir", default="",
                    help="a --profile-dir capture for the device table "
                         "(default: the trace's own directory)")
    ap.add_argument("--merged", default="",
                    help="also write the host and device timeline, merged "
                         "on the tracer's clock, here")
    args = ap.parse_args(argv)
    trace_path = args.path
    if os.path.isdir(trace_path):
        trace_path = os.path.join(trace_path, "trace.json")
    metrics_path = args.metrics or os.path.join(
        os.path.dirname(trace_path), "metrics.jsonl")
    report = make_report(trace_path, metrics_path,
                         profile_dir=args.profile_dir or None)
    print_table(report)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(report, fh, indent=1)
    if args.merged:
        prof = args.profile_dir or os.path.dirname(trace_path) or "."
        merged = merged_timeline(trace_path, prof)
        if merged is None:
            print(f"merged: no capture to merge under {prof}",
                  file=sys.stderr)
            return 1
        with open(args.merged, "w") as fh:
            json.dump(merged, fh)
        mt = merged["mergedTimeline"]
        print(f"merged timeline: {args.merged} (anchor "
              f"{mt['anchor_kind']}, device offset {mt['device_offset_us']}"
              f" us, {mt['droppedDeviceEvents']} device events dropped)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
