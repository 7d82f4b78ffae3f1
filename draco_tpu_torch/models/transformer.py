"""Decoder-only Transformer LM (draco_tpu/models/transformer.py).

Pre-LN blocks, rotary embeddings, GELU MLP, weight-tied logits; the
attention function is injected (dense streaming attention by default, the
flash kernels with ``attn_impl="flash"``). Submodules carry the reference's
Flax names (``block0``, ``LayerNorm_0``, ``qkv``, ``proj``, ``mlp_in``,
``mlp_out``, ``embed``, ``final_ln``) and it matches Flax's numerics:

  * LayerNorm without bias, epsilon 1e-6, statistics in float32 by the fast
    variance E[x²] − E[x]² clipped at 0;
  * GELU is the tanh approximation;
  * the logits are ``embed.attend`` in float32;
  * rope's frequencies come from numpy float64 and are applied in float32;
  * q, k, v are cast to float32 before rope and attention;
  * with ``dtype=torch.bfloat16`` the Dense layers and the block's
    LayerNorms compute in bfloat16 on float32 parameters (Flax's ``dtype=``);
    the final LayerNorm and the logits stay float32.

Dense kernels are ``nn.Linear`` weights (out, in); ``params.py`` lays them
out as Flax's (in, out).

``experts`` > 0 puts a Switch mixture of experts (``models/moe.py``,
the reference's ``moe`` submodule) in place of each block's
``mlp_in``/``mlp_out``. ``tensor_shards`` > 1 gives each Dense its
Megatron tensor-parallel form (:class:`Dense`, :data:`TP_FORMS`), the
shard axis a tensor axis (``parallel/tp_step.py``).

Two options of the reference change how the block stack runs, not what it
computes:

  * ``remat`` recomputes each block in the backward from its saved input
    (the reference's ``nn.remat``): :class:`_Remat`, a
    ``torch.autograd.Function`` whose backward runs ``torch.func.vjp`` of
    the block. ``torch.utils.checkpoint`` does not run under the step's
    ``torch.func.vmap(grad_and_value(...))``: with ``use_reentrant=False``
    functorch refuses its saved-tensor hooks, with ``use_reentrant=True``
    its Function has no ``setup_context``. The blocks draw nothing (no
    dropout), so the recompute is the forward again: the same kernels on
    the same shapes. It gives the non-remat gradients bit for bit, on the
    CPU and on the card (``chip_smoke.py``'s ``stack_twin_checks``: the
    remat leg's updates equal its twin's). The recompute runs outside
    functorch's record of the backward, so only one block's activations
    live at a time.
  * ``scan_layers`` keeps the blocks' parameters as one ``blocks``
    submodule whose leaves carry a leading layer axis (the reference's
    ``nn.scan`` over ``BlockScan``: ``blocks.qkv.kernel`` (L, dim, 3·dim)
    in Flax's layout), and runs the one block body L times over the
    layers' slices. The slices are taken with one ``torch.unbind`` a
    leaf, whose backward is one ``stack`` of the L slices' gradients
    (``p[i]`` would make autograd write a zero-filled (L, ...) gradient
    a layer and a lane). A scanned and an unrolled parameter tree are not
    interchangeable; their initial draws differ too (``init_params``).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from draco_tpu_torch.models.layers import init_params  # noqa: F401

LN_EPS = 1e-6  # Flax nn.LayerNorm's default (torch's is 1e-5)

AttnFn = Callable[..., torch.Tensor]  # (q, k, v) -> o, all (B, T, H, Dh)


@functools.lru_cache(maxsize=None)
def _rope_freqs(half: int, base: float, device: torch.device) -> torch.Tensor:
    """rope's frequencies from numpy float64, as float32 on ``device``;
    cached, since a host-to-device copy waits for the device to drain."""
    freqs = 1.0 / (base ** (np.arange(0, half) / half))
    return torch.as_tensor(freqs, dtype=torch.float32).to(device)


def rope(x: torch.Tensor, positions: torch.Tensor,
         base: float = 10000.0) -> torch.Tensor:
    """Rotary embedding. x: (B, T, H, Dh) float32, positions: (T,)."""
    half = x.shape[-1] // 2
    freqs = _rope_freqs(half, base, x.device)
    angles = positions.to(torch.float32)[:, None] * freqs[None, :]
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm(use_bias=False)``; ``weight`` is Flax's
    ``scale``. ``dtype=None`` returns the promotion of the input's and the
    scale's types, as Flax does."""

    def __init__(self, dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.dtype = dtype

    def forward(self, x):
        xf = x.to(torch.float32)
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp_min((xf * xf).mean(dim=-1, keepdim=True)
                              - mean * mean, 0.0)
        y = (x - mean) * (torch.rsqrt(var + LN_EPS) * self.weight)
        out = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return y.to(out)


class Dense(nn.Linear):
    """Flax ``nn.Dense`` computing in ``dtype`` on float32 parameters.

    ``shards`` > 1 with ``parallel`` "column" or "row": the layer's
    Megatron tensor-parallel form, the shard axis a tensor axis (the
    reference's GSPMD partition, ``parallel/tp_step.py``). Column-parallel:
    one product a contiguous block of the output columns (and of the
    bias), concatenated; the input's gradient is then the sum of the
    blocks' partials, as the reference's all-reduce gives it. Row-parallel:
    one product a contiguous block of the contraction, each in the compute
    dtype, summed over the shards in ascending order, and the replicated
    bias added once after the sum."""

    def __init__(self, cin: int, cout: int, bias: bool, dtype: torch.dtype,
                 shards: int = 1, parallel: Optional[str] = None):
        super().__init__(cin, cout, bias=bias)
        self.dtype, self.shards, self.parallel = dtype, shards, parallel

    def forward(self, x):
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        x, w = x.to(dt), self.weight.to(dt)
        if self.shards == 1 or self.parallel is None:
            return F.linear(x, w, b)
        if self.parallel == "column":
            bs = [None] * self.shards if b is None else b.chunk(self.shards)
            return torch.cat([F.linear(x, wi, bi) for wi, bi in
                              zip(w.chunk(self.shards, 0), bs)], dim=-1)
        parts = zip(x.chunk(self.shards, -1), w.chunk(self.shards, 1))
        out = None
        for xi, wi in parts:
            y = F.linear(xi, wi)
            out = y if out is None else out + y
        return out if b is None else out + b


# Megatron's tensor-parallel form of each Dense of a Block: the one place
# the choice is made (tp_step.param_partition_spec derives the
# reference's partition from it)
TP_FORMS = {"qkv": "column", "proj": "row", "mlp_in": "column",
            "mlp_out": "row"}


class Block(nn.Module):
    """``experts`` > 0: a Switch MoE (``moe``, models/moe.py) in place of
    ``mlp_in``/``mlp_out``. ``tensor_shards``: each Dense in its
    :data:`TP_FORMS` form."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4,
                 attn_fn: Optional[AttnFn] = None,
                 dtype: torch.dtype = torch.float32, experts: int = 0,
                 tensor_shards: int = 1):
        super().__init__()
        self.dim, self.heads, self.attn_fn = dim, heads, attn_fn

        def dense(name, cin, cout, bias):
            return Dense(cin, cout, bias, dtype, tensor_shards,
                         TP_FORMS[name])

        self.LayerNorm_0 = LayerNorm(dim, dtype)
        self.qkv = dense("qkv", dim, 3 * dim, False)
        self.proj = dense("proj", dim, dim, False)
        self.LayerNorm_1 = LayerNorm(dim, dtype)
        self.experts = experts
        if experts > 0:
            from draco_tpu_torch.models.moe import MoeMlp

            self.moe = MoeMlp(dim, experts, mlp_ratio, dtype=dtype)
        else:
            self.mlp_in = dense("mlp_in", dim, mlp_ratio * dim, True)
            self.mlp_out = dense("mlp_out", mlp_ratio * dim, dim, True)

    def forward(self, x, positions, pos_offset: int = 0):
        """x (B, T, dim); positions (T,) = pos_offset + arange(T)."""
        b, t, _ = x.shape
        dh = self.dim // self.heads
        h = self.LayerNorm_0(x)
        qkv = self.qkv(h).reshape(b, t, 3 * self.heads, dh)
        q, k, v = qkv.split(self.heads, dim=2)
        # attention math in float32; projections back in the compute dtype
        q = rope(q.to(torch.float32), positions)
        k = rope(k.to(torch.float32), positions)
        v = v.to(torch.float32)
        attn = self.attn_fn
        if attn is None:
            from draco_tpu_torch.parallel.ring_attention import dense_attention

            attn = lambda q, k, v: dense_attention(  # noqa: E731
                q, k, v, q_offset=pos_offset, k_offset=pos_offset)
        o = attn(q, k, v).reshape(b, t, self.dim)
        x = x + self.proj(o)
        h = self.LayerNorm_1(x)
        if self.experts > 0:
            return x + self.moe(h)
        h = F.gelu(self.mlp_in(h), approximate="tanh")
        return x + self.mlp_out(h)


class _Remat(torch.autograd.Function):
    """``fn(x, positions, *params)`` whose backward recomputes ``fn`` from
    the saved inputs with ``torch.func.vjp``: only the inputs are saved
    (the parameters are the model's own tensors, ``x`` the block's input).
    ``setup_context`` and the generated vmap rule let it run under
    ``torch.func.vmap(grad_and_value(...))``; ``fn`` closes over no
    tensor (functorch's levels refuse one), so the positions come in as
    an input."""

    generate_vmap_rule = True

    @staticmethod
    def forward(fn, x, positions, *params):
        return fn(x, positions, *params)

    @staticmethod
    def setup_context(ctx, inputs, output):
        fn, *saved = inputs
        ctx.fn = fn
        ctx.save_for_backward(*saved)

    @staticmethod
    def backward(ctx, gy):
        x, positions, *params = ctx.saved_tensors
        # torch.func's grad records the backward (create_graph=True): the
        # recompute under no_grad keeps it out of that record, so each
        # block's activations live only while its own vjp runs (vjp, a
        # transform, still differentiates under an outer no_grad)
        with torch.no_grad():
            _, vjp_fn = torch.func.vjp(
                lambda x, *ps: ctx.fn(x, positions, *ps), x, *params)
            gx, *gps = vjp_fn(gy)
        return (None, gx, None, *gps)


def _run_block(body: nn.Module, weights: dict, x, positions, pos_offset,
               remat: bool):
    """``body`` with ``weights`` (torch names relative to the block) on
    ``x``, recomputed in the backward under ``remat``."""
    names = tuple(weights)

    def fn(x, positions, *ws):
        return torch.func.functional_call(body, dict(zip(names, ws)),
                                          (x, positions, pos_offset))
    if remat:
        return _Remat.apply(fn, x, positions, *weights.values())
    return fn(x, positions, *weights.values())


class BlockStack(nn.Module):
    """The reference's ``blocks`` (``nn.scan`` of ``BlockScan`` over
    ``layers``): a Block's submodules with every parameter stacked on a
    leading layer axis, the one body run over the layers' slices."""

    scanned = True  # init_params draws each layer's slice from its own key

    def __init__(self, layers: int, dim: int, heads: int,
                 attn_fn: Optional[AttnFn] = None,
                 dtype: torch.dtype = torch.float32, remat: bool = False,
                 **block):
        super().__init__()
        self.layers, self.remat = layers, remat
        like = Block(dim, heads, attn_fn=attn_fn, dtype=dtype, **block)
        for mod in like.modules():
            for pname, p in list(mod.named_parameters(recurse=False)):
                setattr(mod, pname, nn.Parameter(
                    p.detach()[None].repeat(layers, *([1] * p.dim()))))
        for name, mod in like.named_children():
            self.add_module(name, mod)
        # the body the slices run through: its own parameters are never
        # read (functional_call replaces every one), so they live on meta
        with torch.device("meta"):
            self.__dict__["body"] = Block(dim, heads, attn_fn=attn_fn,
                                          dtype=dtype, **block)

    def forward(self, x, positions, pos_offset: int = 0, params=None):
        """``params``: the stack's parameters by name (default its own),
        each with the leading layer axis (a pipeline stage's slice)."""
        params = dict(self.named_parameters()) if params is None else params
        names = list(params)
        per_layer = zip(*(p.unbind(0) for p in params.values()))
        for ws in per_layer:
            x = _run_block(self.body, dict(zip(names, ws)), x, positions,
                           pos_offset, self.remat)
        return x


class TransformerLM(nn.Module):
    """tokens (B, T) int -> next-token logits (B, T, vocab) float32."""

    def __init__(self, vocab: int = 256, dim: int = 128, heads: int = 4,
                 layers: int = 2, attn_fn: Optional[AttnFn] = None,
                 dtype: torch.dtype = torch.float32, remat: bool = False,
                 scan_layers: bool = False, experts: int = 0,
                 tensor_shards: int = 1):
        super().__init__()
        self.layers, self.dtype = layers, dtype
        self.remat, self.scan_layers = remat, scan_layers
        self.embed = nn.Embedding(vocab, dim)
        block = dict(attn_fn=attn_fn, dtype=dtype, experts=experts,
                     tensor_shards=tensor_shards)
        if scan_layers:
            self.blocks = BlockStack(layers, dim, heads, remat=remat,
                                     **block)
        else:
            for i in range(layers):
                setattr(self, f"block{i}", Block(dim, heads, **block))
        self.final_ln = LayerNorm(dim)

    def forward(self, tokens, pos_offset: int = 0):
        x = self.embed(tokens).to(self.dtype)
        positions = pos_offset + torch.arange(tokens.shape[1],
                                              device=tokens.device)
        if self.scan_layers:
            x = self.blocks(x, positions, pos_offset)
        else:
            for i in range(self.layers):
                blk = getattr(self, f"block{i}")
                x = _run_block(blk, dict(blk.named_parameters()), x,
                               positions, pos_offset, self.remat)
        x = self.final_ln(x)
        # weight-tied logits in float32
        return x.to(torch.float32) @ self.embed.weight.t()
