"""Weights, statistics and flat gradients carried between the reference's
layout and the port's.

The reference flattens a gradient pytree with ``jax.tree.leaves`` — dict
keys sorted as strings at every level — with each leaf in its JAX layout:
convolution kernels HWIO, dense kernels (in, out), embedding tables and
norm scales as they are. The port's (n, d) codeword matrix
and its random projection must match the reference coordinate for
coordinate, so :func:`flatten` lays a gradient out in exactly that order and
layout, and :func:`unflatten` inverts it. That costs one permuted copy of
the gradient per step.

A leaf's layout follows its role (``leaf_role``: the module that owns it),
not its rank: an Embedding's (vocab, dim) table is 2-D and kept as it is.

A checkpoint holds the state as the reference's ``jax.tree.leaves``:
:class:`StateLeaf` is one such leaf, read from the port's live tensor and
written back into it in place (``TrainState.leaves``,
``training/step.py``).

ResNet-18 has 62 leaves and d = 11,173,962; the TransformerLM of the LM
benchmark (dim 768, 8 layers, vocab 8192) 66 leaves and d = 62,958,336,
with four Switch experts a block 74 leaves and d = 176,321,280 (the
expert stacks ``moe.w1``/``b1``/``w2``/``b2`` keep their layout in both
packages; ``moe.router`` is a Dense); its pipeline tree
(``blocks.loop.b.*``, ``embed``, ``final_ln``) 10 leaves and the same d.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch
from torch import nn


# a leaf's layout change between the two packages, by role
CONV, DENSE, SAME = "conv", "dense", "same"


def leaf_role(module: nn.Module, leaf: str) -> tuple:
    """(Flax leaf name, layout kind) of parameter ``leaf`` of ``module``:
    a convolution weight is Flax's ``kernel`` (OIHW <-> HWIO), a Linear
    weight its Dense ``kernel`` ((out, in) <-> (in, out)), a BatchNorm or
    LayerNorm weight its ``scale`` and an Embedding weight its
    ``embedding`` table (vocab, dim) in both, kept as it is."""
    if leaf != "weight":
        return leaf, SAME
    if isinstance(module, nn.Conv2d):
        return "kernel", CONV
    if isinstance(module, nn.Linear):
        return "kernel", DENSE
    if isinstance(module, nn.Embedding):
        return "embedding", SAME
    return "scale", SAME  # the norms' weights


def torch_name(path: Sequence[str]) -> str:
    """Flax path -> torch parameter name: ``kernel``, ``scale`` and
    ``embedding`` are torch's ``weight``."""
    *parent, leaf = path
    if leaf in ("kernel", "scale", "embedding"):
        leaf = "weight"
    return ".".join(list(parent) + [leaf])


def to_jax_layout(t: torch.Tensor, kind: str) -> torch.Tensor:
    """Trailing OIHW -> HWIO, trailing (out, in) -> (in, out); leading
    batch dims kept."""
    if kind == CONV:
        return t.movedim((-4, -3), (-1, -2))
    if kind == DENSE:
        return t.transpose(-1, -2)
    return t


def from_jax_layout(t: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == CONV:
        return t.movedim((-1, -2), (-4, -3))
    if kind == DENSE:
        return t.transpose(-1, -2)
    return t


@dataclasses.dataclass(frozen=True)
class Layout:
    """Leaf order, layouts and shapes of a model's flat parameter vector."""

    names: tuple  # torch names in the reference's leaf order
    kinds: tuple  # CONV | DENSE | SAME per leaf
    jax_shapes: tuple
    offsets: np.ndarray  # (L+1,) leaf boundaries in the flat vector

    @property
    def dim(self) -> int:
        return int(self.offsets[-1])


def layout(model: nn.Module) -> Layout:
    """The reference's leaf order: ``jax.tree.leaves`` sorts dict keys as
    strings at every level (``block1`` < ``block10`` < ``block2``)."""
    leaves = {}
    for name, p in model.named_parameters():
        parent, _, leaf = name.rpartition(".")
        flax_leaf, kind = leaf_role(model.get_submodule(parent), leaf)
        path = tuple(parent.split(".") if parent else ()) + (flax_leaf,)
        leaves[name] = (path, kind, tuple(p.shape))
    names = tuple(sorted(leaves, key=lambda n: leaves[n][0]))
    kinds = tuple(leaves[n][1] for n in names)
    jax_shapes = tuple(
        tuple(to_jax_layout(torch.empty(leaves[n][2], device="meta"),
                             leaves[n][1]).shape) for n in names)
    sizes = [int(np.prod(s)) for s in jax_shapes]
    return Layout(names, kinds, jax_shapes,
                  np.cumsum([0] + sizes).astype(np.int64))


def flatten(tensors: dict, lay: Layout, lead: int = 0) -> torch.Tensor:
    """Dict of torch-layout tensors (each with ``lead`` leading batch dims)
    -> one (..., d) vector in the reference's order and layout."""
    parts = []
    for name, kind in zip(lay.names, lay.kinds):
        t = to_jax_layout(tensors[name], kind)
        parts.append(t.reshape(t.shape[:lead] + (-1,)))
    return torch.cat(parts, dim=lead)


def unflatten(flat: torch.Tensor, lay: Layout) -> dict:
    """(d,) vector in the reference's layout -> dict of torch-layout
    tensors."""
    out = {}
    for i, (name, kind) in enumerate(zip(lay.names, lay.kinds)):
        a, b = int(lay.offsets[i]), int(lay.offsets[i + 1])
        t = flat[a:b].reshape(lay.jax_shapes[i])
        out[name] = from_jax_layout(t, kind).contiguous()
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
        if path[-1] == "kernel":  # HWIO -> OIHW, Dense (in, out) -> (out, in)
            t = from_jax_layout(t, CONV if t.dim() == 4 else DENSE)
        params[torch_name(path)] = t.contiguous().to(device)
    stats = {}
    for path, v in _walk(batch_stats_np or {}):
        stats["/".join(path)] = torch.from_numpy(
            np.array(v, np.float32)).to(device)
    return params, stats


@dataclasses.dataclass(frozen=True)
class StateLeaf:
    """One leaf of the reference's ``TrainState``: its shape and dtype
    there; ``read()`` gives it as a numpy array (a copy off the device),
    ``write(array)`` copies an array of that shape into the port's live
    tensor in place, or ignores a leaf the port derives from others."""

    shape: tuple
    dtype: np.dtype
    read: Callable[[], np.ndarray]
    write: Callable[[np.ndarray], None]


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t`` that no later update of ``t`` reaches (on the
    CPU ``.cpu()`` would share the storage)."""
    return np.array(t.cpu().numpy(), copy=True)


def _np_dtype(t: torch.Tensor) -> np.dtype:
    return torch.empty((), dtype=t.dtype).numpy().dtype


def tensor_leaves(tensors: dict, lay: Layout) -> list:
    """A leaf a parameter of ``tensors`` (keyed by torch name, each shaped
    as its parameter): the reference's leaf order and layout."""
    out = []
    for name, kind, shape in zip(lay.names, lay.kinds, lay.jax_shapes):
        t = tensors[name]

        def read(t=t, kind=kind):
            return _host_copy(to_jax_layout(t.detach(), kind))

        def write(a, t=t, kind=kind):
            t.copy_(from_jax_layout(torch.from_numpy(a), kind))

        out.append(StateLeaf(tuple(shape), _np_dtype(t), read, write))
    return out


def zero_leaves(lay: Layout) -> list:
    """Float32 zeros shaped as the parameters: a buffer the reference
    keeps and never updates (SGD's momentum at momentum 0)."""
    return [StateLeaf(tuple(s), np.dtype(np.float32),
                      lambda s=s: np.zeros(s, np.float32), lambda a: None)
            for s in lay.jax_shapes]


def scalar_leaf(t: torch.Tensor) -> StateLeaf:
    """A 0-d tensor (a count) as a 0-d leaf of its dtype."""
    dt = _np_dtype(t)
    return StateLeaf((), dt, lambda: np.asarray(t.item(), dt),
                     lambda a: t.fill_(a.item()))


def stats_leaves(stats: dict) -> list:
    """BatchNorm statistics keyed ``"<path>/mean"``, in the reference's
    order (its nested dict's keys sorted at every level), each with its
    leading worker axis."""
    out = []
    for key in sorted(stats, key=lambda k: tuple(k.split("/"))):
        t = stats[key]

        def write(a, t=t):
            t.copy_(torch.from_numpy(a))

        out.append(StateLeaf(tuple(t.shape), _np_dtype(t),
                             lambda t=t: _host_copy(t.detach()), write))
    return out
