"""The layers every CNN of the port is built from, with the reference's
compute dtype (draco_tpu/models/*.py, ``dtype=``).

``Conv`` and ``Dense`` cast their input, weight and bias to the model's
compute dtype and compute in it, as Flax's ``nn.Conv`` / ``nn.Dense`` at
``dtype=bfloat16`` do; the parameters stay float32, so their gradients
reach the flat gradient as float32 through the cast. A compute dtype of
None computes in the weights' own dtype (float32, or float64 in a test),
and then every cast is a no-op. ``BatchNorm`` computes in at least
float32 whatever its input (Flax's ``force_float32_reductions``: the
statistics, x − mean, the scale and the bias) and returns its input's
dtype. The classifier that makes the logits computes in its weights'
dtype on an input cast to it (``classify``), as the reference's float32
``Dense`` on ``x.astype(float32)``.

BatchNorm is functional in its running statistics: ``forward(x, stats,
new_stats)`` reads ``stats``, a flat dict keyed ``"<path>/mean"`` /
``"<path>/var"``, and writes the updated ones into ``new_stats``. That
lets ``torch.func.vmap`` carry one set of statistics per worker lane
(they are never aggregated), and it gives the reference's semantics:
Flax's ``momentum=0.9`` (torch's 0.1) and a running variance updated with
the *biased* batch variance, where ``nn.BatchNorm2d`` would use the
unbiased one. Given ``new_stats=None`` it evaluates: it normalises with
the running statistics (Flax's ``use_running_average``) and updates none.
Every model's ``forward(..., train=False)`` runs that way, and without
dropout.

Dropout takes its keep-mask as an input (``dropout``): the training step
draws the masks on the device per global batch row from the reference's
key chain (``ops/draws.dropout_keep``), so every lane that computes a
batch drops the same units, the reference's units.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BN_MOMENTUM = 0.9  # Flax convention: new = m·old + (1-m)·batch
BN_EPS = 1e-5
DROPOUT_KEEP = 0.5  # the reference's nn.Dropout(0.5)


class Conv(nn.Conv2d):
    """NCHW convolution in ``compute_dtype`` (None: the weights')."""

    def __init__(self, cin, cout, k, stride=1, padding=0, bias=True,
                 compute_dtype=None):
        super().__init__(cin, cout, k, stride=stride, padding=padding,
                         bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype or self.weight.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), b, self.stride,
                        self.padding)


class Dense(nn.Linear):
    """A Dense layer in ``compute_dtype`` (None: the weights')."""

    def __init__(self, fin, fout, compute_dtype=None):
        super().__init__(fin, fout)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype or self.weight.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class BatchNorm(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))  # Flax "scale"
        self.bias = nn.Parameter(torch.zeros(features))
        self.path = ""  # set by name_norms: its Flax path

    def forward(self, x, stats: dict, new_stats):
        """Training-mode BN on NCHW ``x`` with batch statistics; writes the
        updated running statistics into ``new_stats``. ``new_stats=None``:
        evaluation, with the running statistics of ``stats``."""
        dt = x.dtype
        x = x.to(torch.promote_types(dt, torch.float32))
        key = self.path
        if new_stats is None:
            mean, var = stats[key + "/mean"], stats[key + "/var"]
        else:
            dims = (0, 2, 3)
            mean = x.mean(dim=dims)
            # Flax's fast variance: E[x²] − E[x]², clipped at 0
            var = torch.clamp_min((x * x).mean(dim=dims) - mean * mean, 0.0)
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        y = (x - mean[None, :, None, None]) * mul[None, :, None, None]
        y = y + self.bias[None, :, None, None]
        if new_stats is None:
            return y.to(dt)
        new_stats[key + "/mean"] = (BN_MOMENTUM * stats[key + "/mean"]
                                    + (1.0 - BN_MOMENTUM) * mean.detach())
        new_stats[key + "/var"] = (BN_MOMENTUM * stats[key + "/var"]
                                   + (1.0 - BN_MOMENTUM) * var.detach())
        return y.to(dt)


def classify(dense: Dense, x):
    """The logits: ``dense`` (compute dtype None) on ``x`` cast to its
    weights' dtype."""
    return dense(x.to(dense.weight.dtype))


def to_compute(x, dtype):
    """The model's input in its compute dtype (None: as it is)."""
    return x if dtype is None else x.to(dtype)


def dropout(x, keep):
    """Flax's ``nn.Dropout(0.5)`` with its keep-mask given: kept units
    scaled by 1/keep, the others 0."""
    return torch.where(keep, x / DROPOUT_KEEP, torch.zeros_like(x))


def name_norms(model: nn.Module) -> None:
    """Give each BatchNorm its Flax path, the key of its statistics."""
    for name, mod in model.named_modules():
        if isinstance(mod, BatchNorm):
            mod.path = name.replace(".", "/")


def nhwc_flatten(x):
    """(B, C, H, W) -> (B, H·W·C): Flax's flatten of the NHWC map, which
    the first Dense layer's kernel rows follow."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def init_stats(model: nn.Module) -> dict:
    """Fresh running statistics: mean 0, var 1 per BN feature ({} for a
    model without BatchNorm)."""
    stats = {}
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            f = mod.weight.shape[0]
            stats[mod.path + "/mean"] = torch.zeros(f)
            stats[mod.path + "/var"] = torch.ones(f)
    return stats


@torch.no_grad()
def init_params(model: nn.Module, seed: int, roots: dict = None) -> None:
    """The reference's ``model.init`` with ``{"params": key(seed)}``, leaf
    for leaf, on the parameters' device: each kernel (a convolution's or a
    Dense layer's) Flax's LeCun normal (truncated at ±2, variance 1/fan_in,
    fan_in read in the JAX layout), each ``Embed`` table its normal of
    variance 1/dim, each drawn from its module's key (``rng.param_key`` of
    the module path, which is the Flax path) in the JAX layout and carried
    to the port's; a Switch MoE's expert stacks (``PARAM_DRAWS``) LeCun
    normals over the whole (E, in, out) stack at their own rng counts, its
    biases zeros; zero biases, unit norm scales. A module of a scanned
    stack (inside a module with ``scanned`` set: the LM's ``blocks``, the
    pipeline's ``b``) holds a leading layer axis: each layer's slice is
    drawn from its own key (``rng.scan_param_key``), as Flax's ``nn.scan``
    draws it.

    ``roots``: top-level child name -> the key that part of the tree is
    initialised from on its own (``part.init(root)``, so the part's own
    name leaves its path): the pipeline's ``embed``, ``blocks`` and
    ``final_ln`` from ``split(key(seed), 3)``."""
    from draco_tpu_torch import params as params_mod
    from draco_tpu_torch import rng

    stacks = {p: m.layers for p, m in model.named_modules()
              if getattr(m, "scanned", False)}

    def scan_layers(path):
        """The layer count of the scanned stack ``path`` lies in, or
        None."""
        return next((n for p, n in stacks.items()
                     if path == p or path.startswith(p + ".")), None)

    def draw(path, shape, kind, fan_in, count, scope_params, device):
        """The leaf ``count`` of the module at ``path`` (its JAX-layout
        ``shape`` per layer), stacked over the layers of its scan."""
        names = path.split(".") if path else []
        root = rng.key(seed)
        if roots is not None and names and names[0] in roots:
            root, names = roots[names[0]], names[1:]
        layers = scan_layers(path)
        if layers is None:
            return rng.init_leaf(seed, names, shape, kind, fan_in, device,
                                 k=rng.param_key(root, names, count))
        return torch.stack([rng.init_leaf(
            seed, names, shape, kind, fan_in, device,
            k=rng.scan_param_key(root, layers, i, names,
                                 scope_params + count))
            for i in range(layers)])

    for path, mod in model.named_modules():
        own = len(list(mod.parameters(recurse=False)))
        experts = getattr(mod, "PARAM_DRAWS", None)
        if experts is not None:
            for pname, (count, lecun) in experts.items():
                p = getattr(mod, pname)
                if not lecun:
                    p.zero_()
                    continue
                shape = p.shape[1:] if scan_layers(path) else p.shape
                p.copy_(draw(path, shape, "lecun", shape[-2], count, own,
                             p.device))
            continue
        weight = getattr(mod, "weight", None)
        if isinstance(weight, torch.Tensor):
            if isinstance(mod, (nn.Conv2d, nn.Linear, nn.Embedding)):
                # the layout map of params.leaf_role: OIHW <-> HWIO,
                # (out, in) <-> (in, out), an embedding table as it is
                _, kind = params_mod.leaf_role(mod, "weight")
                jshape = params_mod.to_jax_layout(
                    torch.empty(weight.shape, device="meta"), kind).shape
                if scan_layers(path):
                    jshape = jshape[1:]
                embed = isinstance(mod, nn.Embedding)
                fan_in = jshape[-1] if embed else int(
                    np.prod(jshape[:-1], dtype=np.int64))
                leaf = draw(path, jshape, "embed" if embed else "lecun",
                            fan_in, 1, own, weight.device)
                weight.copy_(params_mod.from_jax_layout(leaf, kind))
            else:
                weight.fill_(1.0)  # a norm's scale
        bias = getattr(mod, "bias", None)
        if isinstance(bias, torch.Tensor):
            bias.zero_()
