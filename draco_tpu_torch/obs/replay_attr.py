"""Measure how the device fold attributes a replayed CUDA graph's kernels
on one card (``obs/device_attr.py``), and whether the profiler kept every
kernel record of each replay.

    python -m draco_tpu_torch.obs.replay_attr [--runs 4] [--out FILE]

The chunked flagship (the registry's ``simulate`` leg: ResNet-18, n=8,
``simulate``, batch 32, K=4, 16 steps) at full width through the Trainer,
under deterministic cuDNN, profiled over steps [5, 12): chunks 2-3, eight
replays of the step graph captured at chunk 1, whose map the warm-up wrote
to ``device_graph_map.json``. For each of ``--runs`` runs in one process:
the fold's rows and ``replays_short``, the device events of each replay,
and each replay's kernel names whose count differs from the map's (the
map's count, the replay's, their µs, the phases the map gives the name).
Then one eager run (K=1) profiled over the same eight steps, [5, 13),
whose fractions each run's are held against (the largest gap printed).

Prints one line a run and writes the record as JSON to ``--out``. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from draco_tpu_torch.obs import device_attr as da

STEPS = 16
WINDOW = (5, 12)  # snapped to chunks 2-3: replays only
EAGER_WINDOW = (5, 13)  # the same eight steps, eagerly
K = 4


def census(events: list, maps: dict) -> dict:
    """Each replay of a capture against its program's map: ``{"replays":
    [{"program", "events", "differ": [[name, map count, replay count, µs,
    {phase: count}], ...]}, ...]}`` (the replays in their launches'
    order)."""
    launches = da._launches(events)
    programs = da._Ranges(events, lambda n: n.startswith(da.REPLAY_RANGE))
    groups: dict = collections.defaultdict(list)
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in da._DEVICE_CATS:
            continue
        corr = (ev.get("args") or {}).get("correlation")
        launch = launches.get(corr)
        if launch is not None and da._is_graph_launch(launch[1]):
            groups[corr].append(ev)
    out = []
    for corr in sorted(groups, key=lambda c: launches[c][0]):
        ts, _, thread = launches[corr]
        prog = programs.innermost(ts, thread)
        prog = prog[len(da.REPLAY_RANGE):] if prog is not None else None
        entries = maps.get(prog) or []
        want = collections.Counter(n for n, _ in entries)
        have = collections.Counter(e.get("name", "") for e in groups[corr])
        differ = []
        for name in sorted(set(want) | set(have)):
            if want[name] != have[name]:
                us = sum(float(e.get("dur", 0.0)) for e in groups[corr]
                         if e.get("name", "") == name)
                phases = collections.Counter(ph for n, ph in entries
                                             if n == name)
                differ.append([name, want[name], have[name], us,
                               dict(phases)])
        out.append({"program": prog, "events": len(groups[corr]),
                    "differ": differ})
    return {"replays": out}


def one_run(lp, ds, dev, root: str, i: int, k: int = K,
            window: tuple = WINDOW, steps: int = STEPS) -> dict:
    import torch

    from draco_tpu_torch.runtime import cudnn_deterministic
    from draco_tpu_torch.training.trainer import Trainer

    d = os.path.join(root, f"run{i}")
    prof = os.path.join(root, f"prof{i}")
    cfg = lp.config(True, max_steps=steps, steps_per_call=k, log_every=1,
                    train_dir=d)
    with cudnn_deterministic():
        tr = Trainer(cfg, device=dev, dataset=ds, quiet=True)
        t0 = time.perf_counter()
        tr.run(profile_dir=prof, profile_steps=window)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tr.close()
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    events, _ = da.load_trace(da.find_capture(prof))
    maps = da.load_graph_maps(prof)
    led = da.fold_events(events, maps)
    return {"run": i, "wall_s": wall,
            "map_events": {p: len(v) for p, v in maps.items()},
            "fracs": {k: v["frac"] for k, v in led["phases"].items()},
            "total_device_us": led["total_device_us"],
            "replays_mapped": led["replays_mapped"],
            "replays_short": led["replays_short"],
            **census(events, maps)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--out", type=str, default="")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("replay_attr: needs a CUDA device", file=sys.stderr)
        return 1
    from draco_tpu_torch import _build
    from draco_tpu_torch.analysis import registry
    from draco_tpu_torch.data.datasets import load_dataset
    from draco_tpu_torch.runtime import resolve_device

    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    _build.build_all()
    lp = registry.get("simulate")
    ds = load_dataset(lp.config(True).dataset)
    root = tempfile.mkdtemp(prefix="replay_attr_")
    try:
        runs = [one_run(lp, ds, dev, root, i) for i in range(args.runs)]
        eager = one_run(lp, ds, dev, root, args.runs, k=1,
                        window=EAGER_WINDOW, steps=EAGER_WINDOW[1] - 1)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for r in runs + [eager]:
        r["gap"] = max(abs(v - eager["fracs"][k])
                       for k, v in r["fracs"].items())
        sizes = [x["events"] for x in r["replays"]]
        fr = ", ".join(f"{k} {v:.4f}" for k, v in r["fracs"].items())
        print(f"run {r['run']}: replays' device events {sizes}; map "
              f"{r['map_events']}; {r['replays_mapped']} mapped, "
              f"{r['replays_short']} short; {fr}; the largest gap to the "
              f"eager run's {r['gap']:.4f}", flush=True)
    record = {"card": card, "runs": runs, "eager": eager}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
