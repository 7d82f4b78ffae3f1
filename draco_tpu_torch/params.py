"""Weights, statistics and flat gradients carried between the reference's
layout and the port's.

The reference flattens a gradient pytree with ``jax.tree.leaves`` — dict
keys sorted at every level — with each leaf in its JAX layout: convolution
kernels HWIO, dense kernels (in, out). The port's (n, d) codeword matrix
and its random projection must match the reference coordinate for
coordinate, so :func:`flatten` lays a gradient out in exactly that order and
layout, and :func:`unflatten` inverts it. That costs one permuted copy of
the gradient per step.

ResNet-18 has 62 leaves and d = 11,173,962.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
from torch import nn


def flax_path(name: str) -> tuple:
    """Torch parameter name -> the reference's pytree path:
    ``BasicBlock_0.Conv_1.weight`` -> ``("BasicBlock_0", "Conv_1", "kernel")``;
    a BatchNorm ``weight`` is Flax's ``scale``."""
    parts = name.split(".")
    leaf = parts[-1]
    if leaf == "weight":
        leaf = "scale" if parts[-2].startswith("BatchNorm") else "kernel"
    return tuple(parts[:-1]) + (leaf,)


def torch_name(path: Sequence[str]) -> str:
    """Inverse of :func:`flax_path`."""
    *parent, leaf = path
    if leaf in ("kernel", "scale"):
        leaf = "weight"
    return ".".join(list(parent) + [leaf])


def _to_jax_layout(t: torch.Tensor, lead: int = 0) -> torch.Tensor:
    """Trailing OIHW -> HWIO, trailing Linear (out, in) -> (in, out), after
    ``lead`` leading batch dims."""
    if t.dim() - lead == 4:
        return t.movedim((-4, -3), (-1, -2))
    if t.dim() - lead == 2:
        return t.transpose(-1, -2)
    return t


@dataclasses.dataclass(frozen=True)
class Layout:
    """Leaf order and shapes of a model's flat parameter vector."""

    names: tuple  # torch names in the reference's leaf order
    jax_shapes: tuple
    offsets: np.ndarray  # (L+1,) leaf boundaries in the flat vector

    @property
    def dim(self) -> int:
        return int(self.offsets[-1])


def layout(model: nn.Module) -> Layout:
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    names = tuple(sorted(shapes, key=flax_path))
    jax_shapes = tuple(
        tuple(_to_jax_layout(torch.empty(shapes[n], device="meta")).shape)
        for n in names)
    sizes = [int(np.prod(s)) for s in jax_shapes]
    return Layout(names, jax_shapes, np.cumsum([0] + sizes).astype(np.int64))


def flatten(tensors: dict, lay: Layout, lead: int = 0) -> torch.Tensor:
    """Dict of torch-layout tensors (each with ``lead`` leading batch dims)
    -> one (..., d) vector in the reference's order and layout."""
    parts = []
    for name in lay.names:
        t = _to_jax_layout(tensors[name], lead)
        parts.append(t.reshape(t.shape[:lead] + (-1,)))
    return torch.cat(parts, dim=lead)


def unflatten(flat: torch.Tensor, lay: Layout) -> dict:
    """(d,) vector in the reference's layout -> dict of torch-layout
    tensors."""
    out = {}
    for i, name in enumerate(lay.names):
        a, b = int(lay.offsets[i]), int(lay.offsets[i + 1])
        t = flat[a:b].reshape(lay.jax_shapes[i])
        if t.dim() == 4:
            t = t.movedim((-1, -2), (-4, -3))
        elif t.dim() == 2:
            t = t.transpose(-1, -2)
        out[name] = t.contiguous()
    return out


def _walk(tree, path=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def from_jax(params_np: dict, batch_stats_np: dict = None, device="cpu"):
    """The reference's parameters (nested dicts of numpy arrays, Flax
    layout) -> ``(params, stats)`` for the port: params keyed by torch name
    in torch layout, statistics keyed ``"<path>/mean"`` with any leading
    axes (the per-worker n axis) kept."""
    params = {}
    for path, v in _walk(params_np):
        t = torch.from_numpy(np.array(v, np.float32))
        if t.dim() == 4:  # HWIO -> OIHW
            t = t.permute(3, 2, 0, 1)
        elif t.dim() == 2:  # Dense (in, out) -> Linear (out, in)
            t = t.t()
        params[torch_name(path)] = t.contiguous().to(device)
    stats = {}
    for path, v in _walk(batch_stats_np or {}):
        stats["/".join(path)] = torch.from_numpy(
            np.array(v, np.float32)).to(device)
    return params, stats
