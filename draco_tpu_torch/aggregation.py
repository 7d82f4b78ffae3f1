"""Robust gradient aggregation rules as (n, d) -> (d,) functions
(draco_tpu/aggregation.py). The reference has no kernel here; these are
plain torch.

Every rule takes an optional ``present`` mask ((n,) bool): False rows never
arrived (stragglers) and are excluded from the statistic, with every shape
static. Ranks are taken with stable sorts (``jnp.argsort`` is stable), and
the coordinate median averages the two middle values at an even count
(``jnp.median``; ``torch.median`` would return the lower one).
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch


def mean(grads: torch.Tensor,
         present: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain averaging (update mode "normal"), over present rows."""
    if present is None:
        return grads.mean(dim=0)
    w = present.to(grads.dtype)
    return (w @ grads) / torch.clamp_min(w.sum(), 1.0)


def geometric_median(grads: torch.Tensor, iters: int = 80,
                     eps: float = 1e-8,
                     present: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weiszfeld iteration from the mean, a fixed number of steps; absent
    rows get weight 0."""
    pw = None if present is None else present.to(grads.dtype)
    y = mean(grads, present)
    for _ in range(iters):
        dist = torch.linalg.vector_norm(grads - y[None, :], dim=1)
        w = 1.0 / torch.clamp_min(dist, eps)
        if pw is not None:
            w = w * pw
        y = (w @ grads) / torch.clamp_min(w.sum(), 1e-30)
    return y


def _ranks(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Each entry's rank along ``dim`` (stable: ties keep row order)."""
    order = torch.argsort(x, dim=dim, stable=True)
    return torch.argsort(order, dim=dim, stable=True)


def _krum_scores(grads: torch.Tensor, s: int,
                 present: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Krum scores (shared by krum / multi_krum / bulyan): each row's sum of
    its n-s-2 smallest squared distances to the other rows. Absent and
    non-finite rows score +inf and rank last as neighbours, with a bounded
    penalty (twice the largest distance plus one) so the sums stay
    finite."""
    n = grads.shape[0]
    k = n - s - 2
    finite = torch.isfinite(grads).all(dim=1)
    g_safe = torch.where(finite[:, None], grads, torch.zeros_like(grads))
    # ||gi-gj||^2 from the Gram matrix, f32 products (TF32 is off on the
    # card: runtime.full_f32)
    gram = g_safe @ g_safe.T
    norms = torch.diagonal(gram)
    sq = torch.clamp_min(norms[:, None] + norms[None, :] - 2.0 * gram, 0.0)
    big = 2.0 * sq.max() + 1.0
    sq = sq + torch.eye(n, dtype=grads.dtype, device=grads.device) * big
    sq = sq + big * (~finite)[None, :].to(grads.dtype)
    if present is not None:
        sq = sq + big * (~present)[None, :].to(grads.dtype)
    neighbor_sorted = torch.sort(sq, dim=1).values
    scores = neighbor_sorted[:, :k].sum(dim=1)
    inf = torch.full_like(scores, float("inf"))
    scores = torch.where(finite, scores, inf)
    if present is not None:
        scores = torch.where(present, scores, inf)
    return scores


def krum(grads: torch.Tensor, s: int,
         present: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Krum (Blanchard et al.): the row closest to its n-s-2 nearest
    neighbours (argmin of the scores, the first on a tie)."""
    n = grads.shape[0]
    if n < s + 3:
        raise ValueError(f"krum requires n >= s+3 (got n={n}, s={s})")
    return grads.index_select(
        0, torch.argmin(_krum_scores(grads, s, present)).view(1))[0]


def _masked_median(grads: torch.Tensor,
                   present: torch.Tensor) -> torch.Tensor:
    """Per-coordinate median over present rows only: absent rows sort to
    +inf and the median index comes from the present count; the two middle
    values averaged."""
    inf = torch.full_like(grads, float("inf"))
    x = torch.sort(torch.where(present[:, None], grads, inf), dim=0).values
    n_p = present.sum().to(torch.int64)
    lo = torch.clamp_min((n_p - 1) // 2, 0)
    hi = torch.clamp_min(n_p // 2, 0)
    d = grads.shape[1]
    take = lambda i: x.gather(0, i.view(1, 1).expand(1, d))[0]  # noqa: E731
    return 0.5 * (take(lo) + take(hi))


def coordinate_median(grads: torch.Tensor,
                      present: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Coordinate-wise median (Yin et al. 2018), over present rows. Without
    a mask a NaN in a coordinate makes its median NaN (``jnp.median``)."""
    if present is not None:
        return _masked_median(grads, present)
    n = grads.shape[0]
    x = torch.sort(grads, dim=0).values
    med = 0.5 * (x[(n - 1) // 2] + x[n // 2])
    return torch.where(torch.isnan(grads).any(0),
                       torch.full_like(med, float("nan")), med)


def trimmed_mean(grads: torch.Tensor, s: int,
                 present: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Coordinate-wise s-trimmed mean (Yin et al. 2018): drop the s largest
    and s smallest values a coordinate, average the rest. With a present
    mask the trim runs over the present rows only: ranks [s, n_present - s)
    of the present values."""
    n = grads.shape[0]
    if n <= 2 * s:
        raise ValueError(f"trimmed_mean requires n > 2s (got n={n}, s={s})")
    if present is None:
        ordered = torch.sort(grads, dim=0).values
        kept = ordered[s:n - s] if s > 0 else ordered
        return kept.mean(dim=0)
    x = torch.where(present[:, None], grads, torch.full_like(grads,
                                                             float("inf")))
    ranks = _ranks(x, dim=0)
    n_p = present.sum().to(torch.int64)
    hi = torch.clamp_min(n_p - s, s + 1)  # keep >= 1 row when n_p <= 2s
    w = (ranks >= s) & (ranks < hi) & present[:, None]
    # select by where, not by multiply: 0·inf/NaN = NaN
    kept = torch.where(w, grads, torch.zeros_like(grads))
    return kept.sum(dim=0) / torch.clamp_min(w.to(grads.dtype).sum(dim=0),
                                             1.0)


def multi_krum(grads: torch.Tensor, s: int, m: Optional[int] = None,
               present: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-Krum: average the m lowest-score rows (m = n_present - s - 2
    by default)."""
    n = grads.shape[0]
    if n < s + 3:
        raise ValueError(f"multi_krum requires n >= s+3 (got n={n}, s={s})")
    rank = _ranks(_krum_scores(grads, s, present))
    if m is not None:
        keep = m
    elif present is None:
        keep = n - s - 2
    else:
        keep = torch.clamp_min(present.sum() - s - 2, 1)
    w = rank < keep
    if present is not None:
        w = w & present
    kept = torch.where(w[:, None], grads, torch.zeros_like(grads))
    return kept.sum(dim=0) / torch.clamp_min(w.to(grads.dtype).sum(), 1.0)


def bulyan(grads: torch.Tensor, s: int,
           present: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bulyan (El Mhamdi et al. 2018): Multi-Krum-select θ = n_present - 2s
    rows, then a coordinate-wise average of the β = θ - 2s selected values
    closest to the selection's coordinate median."""
    n = grads.shape[0]
    if n <= 2 * s or n < s + 3:
        raise ValueError(f"bulyan requires n > 2s and n >= s+3 (n={n}, s={s})")
    if n < 4 * s + 3:
        warnings.warn(
            f"bulyan: n={n} < 4s+3={4 * s + 3}; the full Byzantine guarantee "
            f"does not hold and the rule degrades toward per-coordinate "
            f"nearest-to-median (beta clamps to 1)", stacklevel=2)
    rank = _ranks(_krum_scores(grads, s, present))
    if present is None:
        n_p = torch.full((), n, device=grads.device)
        pmask = torch.ones(n, dtype=torch.bool, device=grads.device)
    else:
        n_p = present.sum()
        pmask = present
    theta = torch.clamp_min(n_p - 2 * s, 1)
    sel = (rank < theta) & pmask
    med = _masked_median(grads, sel)
    beta = torch.clamp_min(theta - 2 * s, 1)
    dist = torch.where(sel[:, None], (grads - med[None, :]).abs(),
                       torch.full_like(grads, float("inf")))
    w = (_ranks(dist, dim=0) < beta) & sel[:, None]
    kept = torch.where(w, grads, torch.zeros_like(grads))
    return kept.sum(dim=0) / torch.clamp_min(w.to(grads.dtype).sum(dim=0),
                                             1.0)


def aggregate(grads: torch.Tensor, mode: str, s: int = 0,
              geomedian_iters: int = 80,
              present: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The baseline step's rule. An absent row's values never arrived: they
    are zeroed first, so no rule's masked arithmetic meets a NaN there."""
    if present is not None:
        present = present.to(device=grads.device, dtype=torch.bool)
        grads = torch.where(present[:, None], grads, torch.zeros_like(grads))
    if mode == "normal":
        return mean(grads, present)
    if mode == "geometric_median":
        return geometric_median(grads, iters=geomedian_iters,
                                present=present)
    if mode == "krum":
        return krum(grads, s, present)
    if mode == "coord_median":
        return coordinate_median(grads, present)
    if mode == "trimmed_mean":
        return trimmed_mean(grads, s, present)
    if mode == "multi_krum":
        return multi_krum(grads, s, present=present)
    if mode == "bulyan":
        return bulyan(grads, s, present)
    raise ValueError(f"unknown aggregation mode: {mode}")
