"""Per-step wall time of the port's legs in two checkouts, in alternating
processes: an A/B of a change against its parent on one card.

    python -m draco_tpu_torch.obs.step_ab --trees PARENT CHANGE
        [--pairs 10] [--legs shared,approx,shared_bf16,lm_shared_flash]
        [--steps 10] [--chunk K] [--out FILE] [--device cpu --ci]

Each round runs one process per tree, the order alternating (A B, then
B A, ...) so that slow drift of the host falls on both alike. A process
imports ``draco_tpu_torch`` from its own tree, builds each leg at full
width through the entry points a user calls (``Trainer``, or the LM
route's builder and ``TokenLoop``) with the configurations of
``analysis/registry.py``, takes two warm-up steps and times ``--steps``
calls of ``step()`` on the host clock (each ends in the metric reads,
which wait for the card). With ``--chunk K`` it runs the chunked loop
instead (``steps_per_call`` K: on the card a captured step replayed K
times): two warm-up chunks (the first captures), then ``--steps`` chunks,
each assembled and dispatched through the loop's engine client and timed
to its block's fetch, reported a step (chunk ms / K). No profiler runs in
these processes.
``--device cpu --ci`` runs the legs at the registry's CI size on the CPU,
to check the script itself.

A tree that has ``obs/tracer.py`` also reports what its disabled tracer
costs a step: the time of one no-op ``phase()`` and of one no-op loop span
(enter and exit, less an empty loop's), and how many of each one step
opens (counted after the timed steps by one step with a tracer attached).

Prints, per leg, each tree's median, min and max over its processes of
the mean ms/step, and the median of the rounds' paired differences
(second tree minus first); writes the whole record as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

MARK = "step_ab: "
DEFAULT_LEGS = "shared,approx,shared_bf16,lm_shared_flash"
WARMUP = 2


def _tracer_cost(tr, reps: int = 200_000) -> dict:
    """ns of one disabled ``phase()`` and one no-op loop span, enter and
    exit, each less the loop's own cost."""
    def per(body) -> float:
        t0 = time.perf_counter()
        body()
        return (time.perf_counter() - t0) / reps * 1e9

    def empty():
        for _ in range(reps):
            pass

    def phases():
        for _ in range(reps):
            with tr.phase("draco_comp"):
                pass

    def spans():
        null = tr.NULL_TRACER
        for _ in range(reps):
            with null.span("dispatch"):
                pass

    base = min(per(empty) for _ in range(3))
    return {"phase_ns": min(per(phases) for _ in range(3)) - base,
            "span_ns": min(per(spans) for _ in range(3)) - base}


def _count_spans(tr, runner, trace_dir: str) -> dict:
    """The spans one step opens: draco_* phases and loop spans."""
    tracer = tr.SpanTracer(os.path.join(trace_dir, "trace.json"))
    runner.tracer = tracer
    runner.step()
    names = [e["name"] for e in tracer._events if e.get("ph") == "X"]
    return {"phases": sum(n in tr.PHASES for n in names),
            "loop_spans": sum(n not in tr.PHASES for n in names)}


def _chunk_ms(runner, chunks: int) -> list:
    """ms a step of ``chunks`` timed chunks after WARMUP chunks, through
    the runner's engine client, each timed to its block's fetch."""
    client = runner.chunk_client(1, runner.cfg.max_steps)
    ms = []
    try:
        for i in range(WARMUP + chunks):
            t0 = time.perf_counter()
            chunk = client.assemble(i, client.ranges)
            runner.state, block = client.dispatch(runner.state, chunk)
            block.cpu()
            if i >= WARMUP:
                ms.append((time.perf_counter() - t0) * 1e3 / chunk.k)
    finally:
        client.cleanup()
    return ms


def child(tree: str, legs: list, steps: int, device: str,
          chunk: int = 0) -> dict:
    """Time ``legs`` ([name, route, config fields]) with the package of
    ``tree`` on ``device``: eager steps, or chunks of ``chunk`` steps."""
    sys.path[0] = os.path.abspath(tree)  # not this file's directory
    import torch

    from draco_tpu_torch.config import TrainConfig
    from draco_tpu_torch.runtime import resolve_device
    try:
        from draco_tpu_torch.obs import tracer as tr
    except ImportError:
        tr = None

    dev = resolve_device(device)
    out = {"tree": tree, "legs": {}, "spans": {}}
    dataset = None
    for name, route, fields in legs:
        if chunk:
            cfg = TrainConfig(**fields, max_steps=(WARMUP + steps) * chunk,
                              steps_per_call=chunk).validate()
        else:
            cfg = TrainConfig(**fields,
                              max_steps=WARMUP + steps + 1).validate()
        if route == "cnn":
            from draco_tpu_torch.data.datasets import load_dataset
            from draco_tpu_torch.training.trainer import Trainer

            dataset = dataset or (
                load_dataset(cfg.dataset) if dev.type == "cuda" else
                load_dataset(cfg.dataset, synthetic_train=256,
                             synthetic_test=16))
            runner = Trainer(cfg, device=dev, dataset=dataset, quiet=True)
        else:
            from draco_tpu_torch.parallel import build_route_setup
            from draco_tpu_torch.parallel.token_loop import TokenLoop

            runner = TokenLoop(build_route_setup(cfg, dev), cfg,
                               quiet=True)
        if chunk:
            out["legs"][name] = _chunk_ms(runner, steps)
            del runner
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            continue
        for _ in range(WARMUP):
            runner.step()
        ms = []
        for _ in range(steps):
            t0 = time.perf_counter()
            runner.step()
            ms.append((time.perf_counter() - t0) * 1e3)
        out["legs"][name] = ms
        if tr is not None:
            out["spans"][name] = _count_spans(
                tr, runner, os.path.join(tree, "draco_tpu_torch", "_build",
                                         "step_ab_trace"))
        del runner
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if tr is not None:
        out["tracer_off"] = _tracer_cost(tr)
    return out


def _run_child(tree: str, legs: list, steps: int, device: str,
               chunk: int = 0) -> dict:
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", tree,
         "--spec", json.dumps(legs), "--steps", str(steps), "--device",
         device, "--chunk", str(chunk)],
        cwd=tree, capture_output=True, text=True, timeout=900)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(MARK)]
    if proc.returncode or not lines:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n"
                           f"{proc.stderr[-3000:]}")
    return json.loads(lines[-1][len(MARK):])


def _spec(names: list, ci: bool) -> list:
    from draco_tpu_torch.analysis import registry

    out = []
    for name in names:
        lp = registry.get(name)
        cnn = lp.route == "cnn"
        base = registry.CNN_FULL if cnn else registry.LM_FULL
        small = (registry.CNN_CI if cnn else registry.LM_CI) if ci else {}
        out.append([name, lp.route, {**base, **lp.overrides, **small}])
    return out


def summarize(trees: list, runs: list, names: list) -> dict:
    """Per leg: each tree's per-process mean ms/step (median, min, max),
    and the paired differences of the rounds (second minus first)."""
    table = {}
    for name in names:
        per_tree = {t: [statistics.fmean(r["legs"][name]) for r in runs
                        if r["tree"] == t] for t in trees}
        a, b = per_tree[trees[0]], per_tree[trees[1]]
        diffs = [y - x for x, y in zip(a, b)]
        table[name] = {
            **{t: {"median": statistics.median(v), "min": min(v),
                   "max": max(v), "runs": v} for t, v in per_tree.items()},
            "diff_median": statistics.median(diffs),
            "second_slower": sum(d > 0 for d in diffs),
            "rounds": len(diffs)}
    return table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs=2, metavar=("A", "B"),
                    help="two checkouts: the parent, then the change")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--legs", default=DEFAULT_LEGS)
    ap.add_argument("--steps", type=int, default=10,
                    help="timed steps a leg and process, after 2 warm-ups")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--chunk", type=int, default=0,
                    help="time chunks of K steps (0: eager steps)")
    ap.add_argument("--ci", action="store_true",
                    help="the registry's CI size (a check on the CPU)")
    ap.add_argument("--child", default="", help=argparse.SUPPRESS)
    ap.add_argument("--spec", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(MARK + json.dumps(child(args.child, json.loads(args.spec),
                                      args.steps, args.device, args.chunk)),
              flush=True)
        return 0
    if not args.trees:
        ap.error("--trees A B is required")
    names = [n for n in args.legs.split(",") if n]
    legs = _spec(names, args.ci)
    trees = [os.path.abspath(t) for t in args.trees]
    runs = []
    for i in range(args.pairs):
        for t in (trees if i % 2 == 0 else trees[::-1]):
            t0 = time.perf_counter()
            runs.append(_run_child(t, legs, args.steps, args.device,
                                   args.chunk))
            ms = {n: statistics.fmean(runs[-1]["legs"][n]) for n in names}
            print(f"round {i + 1} {os.path.basename(t)}: "
                  + ", ".join(f"{n} {v:.2f}" for n, v in ms.items())
                  + f" ms/step ({time.perf_counter() - t0:.0f} s)",
                  flush=True)
    table = summarize(trees, runs, names)
    a, b = (os.path.basename(t) for t in trees)
    print(f"leg: {a} median [min-max] | {b} median [min-max] | median of "
          f"{b} - {a} over rounds, rounds {b} slower (ms/step)")
    for name, row in table.items():
        ra, rb = row[trees[0]], row[trees[1]]
        print(f"{name}: {ra['median']:.2f} [{ra['min']:.2f}-{ra['max']:.2f}]"
              f" | {rb['median']:.2f} [{rb['min']:.2f}-{rb['max']:.2f}] | "
              f"{row['diff_median']:+.2f}, {row['second_slower']}/"
              f"{row['rounds']}")
    off = [r for r in runs if "tracer_off" in r]
    if off:
        cost = {k: statistics.median(r["tracer_off"][k] for r in off)
                for k in ("phase_ns", "span_ns")}
        per_step = {n: (s["phases"] * cost["phase_ns"] + s["loop_spans"]
                        * cost["span_ns"]) / 1e3
                    for n, s in off[-1]["spans"].items()}
        print(f"tracer off: {cost['phase_ns']:.1f} ns a phase(), "
              f"{cost['span_ns']:.1f} ns a loop span; per step "
              + ", ".join(f"{n} {s['phases']} phases + {s['loop_spans']} "
                          f"spans = {per_step[n]:.2f} us"
                          for n, s in off[-1]["spans"].items()))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"trees": trees, "legs": names, "steps": args.steps,
                       "chunk": args.chunk, "runs": runs, "table": table},
                      f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
