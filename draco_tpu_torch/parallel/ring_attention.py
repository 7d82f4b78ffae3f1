"""Exact attention with streaming-softmax accumulators, and the ring over
sequence shards (draco_tpu/parallel/ring_attention.py).

``dense_attention`` / ``dense_attention_lse``: single-shard attention, the
default ``attn_impl="dense"`` of the LM and the plain version of the
flash kernels' forward (``ops/flash_attention.py``).

``ring_attention`` and ``ring_flash_attention``: the reference's ring in
its one-card form. The reference holds each of ``sp`` sequence shards on a
device and passes K/V blocks around the ring, one ``ppermute`` hop at a
time; after r hops shard i holds the block of owner (i − r) mod sp. On one
card the shard axis is a tensor axis: q, k, v (B, T, H, Dh) are viewed as
(B, sp, T/sp, H, Dh) and every hop is a static slice of that axis.

Under the causal mask a hop's block is fully visible to shard i when its
owner precedes i, and fully masked when the owner follows it (the
reference skips that hop, ``lax.cond``). A fully masked hop is an exact
no-op of the reference's fold (the streaming accumulators: the max stays,
the correction is exp(0) = 1 and every p is 0; the lse merge:
``logaddexp(lse, −1e30)`` is lse, the weights 1 and 0). So hop r (1 ≤ r <
sp) is one non-causal pass over the visible pairs only, q's shards [r, sp)
against k/v's shards [0, sp − r), and hop 0 one causal pass over every
shard's own block. Each shard folds its owners in the reference's order
(i − 1, i − 2, ..., 0). Rolling k/v over the shard axis, as the
non-causal ring does (every hop visible), would give the same results for
the causal ring, but would compute the masked future blocks as well: the
slices skip them with no host sync, so a CUDA graph captures the hops.

There is no interconnect on one card, so the ring buys no memory there:
the flash kernels already keep attention to O(T·Dh). The route exists so
that a reference configuration with ``seq_shards > 1`` runs on the port
and gives the reference's results.
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


def _shard_view(x: torch.Tensor, shards: int) -> torch.Tensor:
    """(B, T, ...) -> (B, shards, T / shards, ...): the sequence shards."""
    b, t = x.shape[:2]
    if t % shards:
        raise ValueError(f"sequence length {t} not divisible by "
                         f"{shards} shards")
    return x.reshape(b, shards, t // shards, *x.shape[2:])


def _fold(x: torch.Tensor) -> torch.Tensor:
    """(B, S, t, ...) -> (B·S, t, ...): shards side by side as batch rows."""
    return x.reshape(-1, *x.shape[2:])


def _hops(qs, ks, vs, causal: bool):
    """Hop r's (first shard it updates, q, k, v of those shards): the
    causal ring's visible pairs, the non-causal ring's rolled blocks."""
    sp = qs.shape[1]
    for r in range(1, sp):
        if causal:
            yield r, qs[:, r:], ks[:, :sp - r], vs[:, :sp - r]
        else:
            yield 0, qs, ks.roll(r, dims=1), vs.roll(r, dims=1)


def _splice(acc: torch.Tensor, r: int, new: torch.Tensor) -> torch.Tensor:
    """``acc`` (B, sp, ...) with shards [r, sp) replaced by ``new``."""
    new = new.reshape(acc.shape[0], -1, *acc.shape[2:])
    return new if r == 0 else torch.cat([acc[:, :r], new], dim=1)


def ring_attention(q, k, v, shards: int, causal: bool = True):
    """Exact attention of (B, T, H, Dh) q, k, v over ``shards`` sequence
    shards, each folding its owners' K/V blocks into the streaming
    accumulators in the reference's ring order. ``shards=1``: single-shard
    dense attention."""
    if shards == 1:
        return dense_attention(q, k, v, causal=causal)
    b, t_all, h, dh = q.shape
    qs, ks, vs = (_shard_view(x, shards) for x in (q, k, v))
    t = t_all // shards
    scale = 1.0 / (dh ** 0.5)
    dev = q.device
    pos = torch.arange(t, device=dev)  # a shard's own block: local = global
    rows = (b * shards, t, h)
    o = torch.zeros(rows + (dh,), dtype=torch.float32, device=dev)
    m = torch.full(rows, NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(rows, dtype=torch.float32, device=dev)
    o, m, l = _block_attn(_fold(qs), _fold(ks), _fold(vs), pos, pos, scale,
                          causal, o, m, l)
    acc = [x.reshape(b, shards, *x.shape[1:]) for x in (o, m, l)]
    for r, qh, kh, vh in _hops(qs, ks, vs, causal):
        new = _block_attn(_fold(qh), _fold(kh), _fold(vh), pos, pos, scale,
                          False, *(_fold(x[:, r:]) for x in acc))
        acc = [_splice(x, r, y) for x, y in zip(acc, new)]
    o, _, l = acc
    o = o / torch.clamp_min(l, 1e-30)[..., None]
    return o.reshape(b, t_all, h, dh).to(q.dtype)


def ring_flash_attention(q, k, v, shards: int, causal: bool = True):
    """The ring with the flash kernels at every hop: hop 0 causal on each
    shard's own block, hop r non-causal on the visible pairs, the per-hop
    (o, lse) pairs merged in float32 by log-sum-exp weights in the
    reference's order. The kernels' lse is differentiable, so the merge's
    lse cotangent reaches their backward as dlse. ``shards=1``: the
    single-shard kernel."""
    from draco_tpu_torch.ops.flash_attention import (
        flash_attention_with_lse as attn_with_lse)

    if shards == 1:
        return attn_with_lse(q, k, v, causal=causal)[0]
    b, t_all, h, dh = q.shape
    qs, ks, vs = (_shard_view(x, shards) for x in (q, k, v))
    o, lse = attn_with_lse(_fold(qs), _fold(ks), _fold(vs), causal=causal)
    o = o.to(torch.float32).reshape(b, shards, *o.shape[1:])
    lse = lse.reshape(b, shards, *lse.shape[1:])
    for r, qh, kh, vh in _hops(qs, ks, vs, causal):
        o_h, lse_h = attn_with_lse(_fold(qh), _fold(kh), _fold(vh),
                                   causal=False)
        o_acc, lse_acc = _fold(o[:, r:]), _fold(lse[:, r:])
        lse_new = torch.logaddexp(lse_acc, lse_h)
        w1 = torch.exp(lse_acc - lse_new)
        w2 = torch.exp(lse_h - lse_new)
        o_new = o_acc * w1[..., None] + o_h.to(torch.float32) * w2[..., None]
        o, lse = _splice(o, r, o_new), _splice(lse, r, lse_new)
    return o.reshape(b, t_all, h, dh).to(q.dtype)
