"""All-to-all (Ulysses-style) sequence-parallel exact attention
(draco_tpu/parallel/a2a_attention.py) in its one-card form.

The reference trades each device's sequence shard for a head group with
one ``all_to_all``: device j then holds the full sequence for heads [j·H/sp,
(j+1)·H/sp), runs the inner attention on it and a second ``all_to_all``
restores the sequence layout. On one card the shard axis is a tensor
axis, and the head scatter is a permute: (B, T, H, Dh) is viewed as sp
head groups (B, T, sp, H/sp, Dh), the groups go side by side as batch rows
(sp·B, T, H/sp, Dh), the inner attention runs on them over the full
sequence, and the inverse permute puts the heads back. As with the ring
(``ring_attention.py``), one card has no interconnect to save: the route
exists so that a reference configuration with ``sp_attn="a2a"`` runs on
the port and gives the reference's results.
"""

from __future__ import annotations

from draco_tpu_torch.parallel.ring_attention import dense_attention


def a2a_attention(q, k, v, shards: int, causal: bool = True, inner=None):
    """Exact attention of (B, T, H, Dh) q, k, v by head groups of H /
    ``shards`` heads over the full sequence. ``inner``: the attention run
    on each head group, (q, k, v) -> o, causal (the flash kernels); the
    default is dense attention. H must be divisible by ``shards``;
    ``shards=1`` runs the inner attention on all heads."""
    if shards == 1:
        return (inner(q, k, v) if inner is not None
                else dense_attention(q, k, v, causal=causal))
    b, t, h, dh = q.shape
    if h % shards:
        raise ValueError(f"a2a_attention: heads {h} not divisible by "
                         f"sp={shards}")
    hg = h // shards

    def scatter(x):  # (B, T, H, Dh) -> (sp·B, T, H/sp, Dh)
        return (x.reshape(b, t, shards, hg, dh).permute(2, 0, 1, 3, 4)
                .reshape(shards * b, t, hg, dh))

    qh, kh, vh = scatter(q), scatter(k), scatter(v)
    oh = (inner(qh, kh, vh) if inner is not None
          else dense_attention(qh, kh, vh, causal=causal))
    return (oh.reshape(shards, b, t, hg, dh).permute(1, 2, 0, 3, 4)
            .reshape(b, t, h, dh))
