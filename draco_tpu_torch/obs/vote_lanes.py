"""Measure what the repetition code's vote relies on, on one card: are the
honest lanes of a group bit-identical at cuDNN's default settings, and what
does the route's deterministic cuDNN cost?

    python -m draco_tpu_torch.obs.vote_lanes [--steps 8] [--rounds 3]
        [--out FILE]

The ``majvote`` leg of the registry (preset rep-resnet18: ResNet-18 on
synthetic CIFAR-10, n=9 in groups of 3, batch 32) at full width, built
through the Trainer:

  lanes  without its adversary, ``--steps`` steps at cuDNN's default
         settings (the step's ``vote_lanes`` replaced by a no-op for this
         measurement) and then under the route's deterministic cuDNN:
         vote_agree and flagged_groups a step, and where the rows of a
         group's members differ — the coordinates, and the parameter
         tensors they fall in, of each member against the group's first
  cost   with its adversary, in ``--rounds`` rounds that take the two
         settings in turn: K=4 eager steps and one chunk of the same K
         steps (replays of the captured step), each by CUDA events

Prints one line a phase and writes the record as JSON to ``--out``. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys

import torch

from draco_tpu_torch.analysis import registry
from draco_tpu_torch.coding import repetition
from draco_tpu_torch.data.datasets import load_dataset
from draco_tpu_torch.training import step as step_mod

K = 4  # steps of a chunk


@contextlib.contextmanager
def cudnn_setting(deterministic: bool):
    """The majvote step at the route's setting, or at cuDNN's default."""
    saved = step_mod.vote_lanes
    if not deterministic:
        step_mod.vote_lanes = lambda device: contextlib.nullcontext()
    try:
        yield
    finally:
        step_mod.vote_lanes = saved


@contextlib.contextmanager
def vote_rows():
    """Inside: every (n, d) row matrix the step hands the vote."""
    rows, vote = [], repetition.majority_vote

    def spy(code, grads, *args, **kwargs):
        rows.append(grads.detach().clone())
        return vote(code, grads, *args, **kwargs)

    step_mod.rep_mod.majority_vote = spy
    try:
        yield rows
    finally:
        step_mod.rep_mod.majority_vote = vote


def where_rows_differ(rows: torch.Tensor, r: int, layout) -> dict:
    """Each member against its group's first: differing coordinates and the
    parameter tensors (by name) they fall in."""
    bits = rows.view(torch.int32)
    offsets = torch.as_tensor(layout.offsets, device=rows.device)
    out = {}
    for g in range(rows.shape[0] // r):
        for m in range(1, r):
            diff = bits[g * r] != bits[g * r + m]
            cum = torch.cat([diff.new_zeros(1, dtype=torch.int64),
                             diff.cumsum(0)])
            per = (cum[offsets[1:]] - cum[offsets[:-1]]).tolist()
            out[f"group {g} member {m}"] = {
                "coordinates": int(cum[-1]),
                "tensors": sum(c > 0 for c in per),
                "by_tensor": {name: c for name, c in zip(layout.names, per)
                              if c}}
    return out


def lanes(dev, ds, steps: int, deterministic: bool) -> dict:
    with cudnn_setting(deterministic):
        prog = registry.get("majvote").build(dev, full=True,
                                             max_steps=steps + 1, dataset=ds,
                                             worker_fail=0)
        with vote_rows() as rows:
            recs = [prog.runner.step() for _ in range(steps)]
        cfg, layout = prog.cfg, prog.runner.setup.layout
        diffs = [where_rows_differ(g, cfg.group_size, layout) for g in rows]
    return {"deterministic": deterministic,
            "vote_agree": [r["vote_agree"] for r in recs],
            "flagged_groups": [r["flagged_groups"] for r in recs],
            "dim": layout.dim, "differ": diffs}


def _timed(fn) -> tuple:
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def cost(dev, ds, deterministic: bool) -> dict:
    """K eager steps, then the chunk of the same K steps (after its
    capturing chunk), from one state: ms a step each."""
    with cudnn_setting(deterministic):
        prog = registry.get("majvote").build(dev, full=True,
                                             max_steps=1 + 3 * K, dataset=ds,
                                             steps_per_call=K)
        runner = prog.runner
        runner.step()
        recs, eager_ms = _timed(lambda: [runner.step() for _ in range(K)])
        client = runner.chunk_client(runner.state.step,
                                     runner.state.step + 2 * K - 1)
        try:
            ranges = [(runner.state.step, K), (runner.state.step + K, K)]
            client.dispatch(runner.state, client.assemble(0, ranges))
            chunk = client.assemble(1, ranges)
            (_, block), chunk_ms = _timed(
                lambda: client.dispatch(runner.state, chunk))
        finally:
            client.cleanup()
        agree = block[:, client.block_names.index("vote_agree")].tolist()
    return {"deterministic": deterministic, "eager_ms": eager_ms / K,
            "chunk_ms": chunk_ms / K,
            "vote_agree_eager": [r["vote_agree"] for r in recs],
            "vote_agree_chunk": agree}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("vote_lanes: no CUDA device", file=sys.stderr)
        return 1
    from draco_tpu_torch.runtime import resolve_device

    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    ds = load_dataset(registry.CNN_FULL["dataset"])
    record = {"card": card, "lanes": [], "cost": []}
    for det in (False, True):
        res = lanes(dev, ds, args.steps, det)
        record["lanes"].append(res)
        worst = max((v["coordinates"] for st in res["differ"]
                     for v in st.values()), default=0)
        print(f"vote_lanes lanes deterministic={det}: vote_agree "
              f"{res['vote_agree']}, flagged_groups {res['flagged_groups']}; "
              f"differing member rows a step "
              f"{[len(st) for st in res['differ']]}, at most {worst} of "
              f"{res['dim']} coordinates", flush=True)
        torch.cuda.empty_cache()
    for rnd in range(args.rounds):
        for det in (False, True):
            res = cost(dev, ds, det)
            record["cost"].append({"round": rnd, **res})
            print(f"vote_lanes cost round {rnd} deterministic={det}: eager "
                  f"{res['eager_ms']:.2f} ms/step, chunk "
                  f"{res['chunk_ms']:.2f} ms/step; vote_agree eager "
                  f"{res['vote_agree_eager']} chunk "
                  f"{res['vote_agree_chunk']}", flush=True)
            torch.cuda.empty_cache()
    for key in ("eager_ms", "chunk_ms"):
        med = {det: statistics.median(c[key] for c in record["cost"]
                                      if c["deterministic"] == det)
               for det in (False, True)}
        record[f"median_{key}"] = {"default": med[False],
                                   "deterministic": med[True]}
        print(f"vote_lanes median {key}: default {med[False]:.2f}, "
              f"deterministic {med[True]:.2f} "
              f"({100 * (med[True] / med[False] - 1):+.1f}%)", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
