"""Negative controls of the program lint: one seeded defect per rule
(draco_tpu/analysis/controls.py).

A lint that stops seeing defects is worse than none. Each control is the
same miniature step — a parameter vector with its momentum buffer and
per-worker statistics updated in place, one (n, d) host batch uploaded by a
pinned asynchronous copy, a mean as the aggregate — with exactly ONE
defect of the kind its rule exists to catch. A control passes when its
step trips exactly that rule and every other rule stays green; the honest
miniature (:func:`honest_program`) trips none.

The controls stand alone (no model or route imports), so a change to a
route cannot blunt them. Two need the card (their rules read the
profiler's copies and the peak memory); the collective runs on a
world-size-1 gloo group on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from draco_tpu_torch.analysis.registry import (
    DEFAULT_DTYPES,
    Manifest,
    Program,
)

N, D = 4, 64
BIG = 1 << 20  # floats: the baked constant (4 MiB) and the hog's temp
MINI_PEAK = 16 << 20  # the miniature's memory budget on the card


@dataclasses.dataclass(frozen=True)
class Control:
    name: str
    expected_fail: str  # the one rule the defect must trip
    build: Callable  # device -> Program
    card_only: bool = False


def _mini(device, step_body, manifest=None, name="honest") -> Program:
    """The miniature step around ``step_body(state, g) -> g``, which may
    seed a defect; ``g`` is the aggregated (d,) gradient."""
    from draco_tpu_torch import optim
    from draco_tpu_torch.runtime import resolve_device, upload
    from draco_tpu_torch.training.step import TrainState

    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    host_batch = torch.randn((N, D), generator=gen)
    state = TrainState(params={"w": torch.zeros(D, device=dev)},
                       stats={"s": torch.zeros((N, 2), device=dev)},
                       opt=optim.build_optimizer("sgd", 0.01, 0.9))
    box = {"state": state}
    if manifest is None:
        manifest = Manifest(uploads={"batch (f32)": N * D * 4},
                            max_peak_bytes=MINI_PEAK)

    @torch.no_grad()
    def step():
        st = box["state"]
        x = upload(host_batch, dev)
        g = step_body(st, x.mean(0))
        st.opt.step(st.params, {"w": g})
        st.stats["s"].copy_(torch.stack([x.mean(1), x.var(1)], dim=1))
        st.step += 1

    step()  # the first step makes the optimizer's buffers and count
    return Program(f"control_{name}", manifest, dev, step,
                   lambda: box["state"].tensors())


def honest_program(device=None) -> Program:
    """The miniature without a defect: every rule green."""
    return _mini(device, lambda st, g: g)


def _baked_constant(device) -> Program:
    """A d-sized host constant shipped to the card every step (by a pinned
    asynchronous copy, so no sync): only the copy's bytes show it."""
    from draco_tpu_torch.runtime import upload

    const = torch.ones(BIG)

    def body(st, g):
        return g + upload(const, g.device)[:D]

    return _mini(device, body, name="baked_constant")


def _out_of_place(device) -> Program:
    """The parameter rebound to a new tensor instead of updated."""
    def body(st, g):
        st.params["w"] = st.params["w"] - 0.0 * g
        return g

    return _mini(device, body, name="out_of_place_carry")


def _f64_upcast(device) -> Program:
    """An accumulation in float64 inside the step."""
    return _mini(device, lambda st, g: g.double().cumsum(0).float(),
                 name="f64_upcast")


def _extra_all_reduce(device) -> Program:
    """An all_reduce nobody budgeted, on a world-size-1 gloo group (the
    step runs on the CPU)."""
    import torch.distributed as dist

    def body(st, g):
        if not dist.is_initialized():  # an in-memory store: no file, no port
            dist.init_process_group("gloo", store=dist.HashStore(),
                                    world_size=1, rank=0)
        dist.all_reduce(g)
        return g

    return _mini("cpu", body, name="extra_all_reduce")


def _item_in_step(device) -> Program:
    """A scalar read inside the step: the host waits for the card."""
    def body(st, g):
        scale = float(g.abs().max().item())
        return g / max(scale, 1.0)

    return _mini(device, body, name="item_in_step")


def _wide_int8_wire(device) -> Program:
    """A step that declares the int8 wire but ships f32: the manifest
    requires int8 and the step never makes one."""
    m = Manifest(allowed_dtypes=DEFAULT_DTYPES | {torch.int8},
                 required_dtypes=frozenset({torch.int8}),
                 uploads={"batch (f32)": N * D * 4},
                 max_peak_bytes=MINI_PEAK)
    return _mini(device, lambda st, g: g, m, name="wide_int8_wire")


def _memory_hog(device) -> Program:
    """A temporary far over the miniature's memory budget."""
    def body(st, g):
        waste = torch.ones(8 * BIG, device=g.device)  # 32 MiB
        return g + 0.0 * waste[:D]

    return _mini(device, body, name="memory_hog")


CONTROLS = (
    Control("control_baked_constant", "constant_bloat", _baked_constant,
            card_only=True),
    Control("control_out_of_place_carry", "in_place", _out_of_place),
    Control("control_f64_upcast", "dtype", _f64_upcast),
    Control("control_extra_all_reduce", "collectives", _extra_all_reduce),
    Control("control_item_in_step", "host_traffic", _item_in_step),
    Control("control_wide_int8_wire", "dtype", _wide_int8_wire),
    Control("control_memory_hog", "memory_budget", _memory_hog,
            card_only=True),
)


def release() -> None:
    """Tear down the gloo group the collective control made, if any."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
