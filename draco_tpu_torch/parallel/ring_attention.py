"""Single-shard exact attention with streaming-softmax accumulators
(draco_tpu/parallel/ring_attention.py: ``dense_attention`` and
``dense_attention_lse``).

The default ``attn_impl="dense"`` of the LM, and the plain version of the
flash-attention kernels' forward (``ops/flash_attention.py``). The ring
itself (sequence parallelism over devices) is not ported yet.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _block_attn(q, k, v, q_pos, k_pos, scale, causal, o, m, l):
    """Fold one K/V block into the accumulators. q: (B, Tq, H, Dh); k, v:
    (B, Tk, H, Dh); o (B, Tq, H, Dh); m, l (B, Tq, H)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]  # (Tq, Tk)
        s = torch.where(mask[None, None], s, NEG_INF)
    m_blk = s.amax(dim=-1).movedim(1, 2)  # (B, Tq, H)
    m_new = torch.maximum(m, m_blk)
    # a row masked everywhere stays at 0 through the NEG_INF offset
    p = torch.exp(s - m_new.movedim(1, 2)[..., None])  # (B, H, Tq, Tk)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1).movedim(1, 2)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return o * corr[..., None] + pv, m_new, l_new


def dense_attention(q, k, v, q_offset=0, k_offset=0, causal: bool = True):
    """Causal (or full) attention of (B, T, H, Dh) q, k, v."""
    return dense_attention_lse(q, k, v, q_offset, k_offset, causal)[0]


def dense_attention_lse(q, k, v, q_offset=0, k_offset=0, causal: bool = True):
    """dense_attention and the per-row log-sum-exp (B, T, H) f32."""
    b, tq, h, dh = q.shape
    tk = k.shape[1]
    scale = 1.0 / (dh ** 0.5)
    dev = q.device
    q_pos = q_offset + torch.arange(tq, device=dev)
    k_pos = k_offset + torch.arange(tk, device=dev)
    o = torch.zeros((b, tq, h, dh), dtype=torch.float32, device=dev)
    m = torch.full((b, tq, h), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, tq, h), dtype=torch.float32, device=dev)
    o, m, l = _block_attn(q, k, v, q_pos, k_pos, scale, causal, o, m, l)
    l = torch.clamp_min(l, 1e-30)
    return (o / l[..., None]).to(q.dtype), m + torch.log(l)
