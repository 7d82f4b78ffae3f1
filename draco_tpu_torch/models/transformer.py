"""Decoder-only Transformer LM (draco_tpu/models/transformer.py), unrolled.

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
    """Flax ``nn.Dense`` computing in ``dtype`` on float32 parameters."""

    def __init__(self, cin: int, cout: int, bias: bool, dtype: torch.dtype):
        super().__init__(cin, cout, bias=bias)
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4,
                 attn_fn: Optional[AttnFn] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.heads, self.attn_fn = dim, heads, attn_fn
        self.LayerNorm_0 = LayerNorm(dim, dtype)
        self.qkv = Dense(dim, 3 * dim, False, dtype)
        self.proj = Dense(dim, dim, False, dtype)
        self.LayerNorm_1 = LayerNorm(dim, dtype)
        self.mlp_in = Dense(dim, mlp_ratio * dim, True, dtype)
        self.mlp_out = Dense(mlp_ratio * dim, dim, True, dtype)

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
        h = F.gelu(self.mlp_in(h), approximate="tanh")
        return x + self.mlp_out(h)


class TransformerLM(nn.Module):
    """tokens (B, T) int -> next-token logits (B, T, vocab) float32."""

    def __init__(self, vocab: int = 256, dim: int = 128, heads: int = 4,
                 layers: int = 2, attn_fn: Optional[AttnFn] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers, self.dtype = layers, dtype
        self.embed = nn.Embedding(vocab, dim)
        for i in range(layers):
            setattr(self, f"block{i}", Block(dim, heads, attn_fn=attn_fn,
                                             dtype=dtype))
        self.final_ln = LayerNorm(dim)

    def forward(self, tokens, pos_offset: int = 0):
        x = self.embed(tokens).to(self.dtype)
        positions = pos_offset + torch.arange(tokens.shape[1],
                                              device=tokens.device)
        for i in range(self.layers):
            x = getattr(self, f"block{i}")(x, positions, pos_offset)
        x = self.final_ln(x)
        # weight-tied logits in float32
        return x.to(torch.float32) @ self.embed.weight.t()
