"""Small dense linear algebra of the cyclic decode, batched over a leading
axis (draco_tpu/coding/linalg.py, the "fused tier").

These are the plain-torch counterparts of the primitives the reference's
fused locator runs, op for op, so the port's plain locator
(``coding/cyclic.locator_core``) follows the same arithmetic:

  jacobi_lstsq    truncated least squares by one-sided Jacobi SVD, a fixed
                  JACOBI_SWEEPS sweeps; σ below rcond·σmax (or ≤ λ) dropped
  gauss_inv_c     complex Gauss–Jordan inverse, partial pivoting on |a|²
                  with the lowest-index tie-break, (re, im) pairs
  topk_mask       top-m by pairwise rank, ties to the lower index
  select_matrix   the (m, n) 0/1 compaction matrix of a mask with m set lanes
  masked_median   rank-selection median over masked lanes (nanmedian)

and, for the approx code's decode weights, ``truncated_lstsq`` at λ = 0:
the reference's ``jnp.linalg.lstsq(a, b, rcond)``.
"""

from __future__ import annotations

import torch

JACOBI_SWEEPS = 12
_TINY = 1e-30


def jacobi_lstsq(a: torch.Tensor, b: torch.Tensor, rcond: float,
                 sweeps: int = JACOBI_SWEEPS, lam: float = 0.0):
    """min ‖A x − b‖ for a (bb, m, m), b (bb, m) -> x (bb, m)."""
    bb, m, _ = a.shape
    w = a.clone()
    v = torch.eye(m, dtype=a.dtype, device=a.device).expand(bb, m, m).clone()
    for _ in range(sweeps):
        for p in range(m - 1):
            for q in range(p + 1, m):
                wp, wq = w[:, :, p], w[:, :, q]
                alpha = (wp * wp).sum(1)
                beta = (wq * wq).sum(1)
                gamma = (wp * wq).sum(1)
                live = gamma.abs() > _TINY
                g_safe = torch.where(live, gamma, torch.ones_like(gamma))
                zeta = (beta - alpha) / (2.0 * g_safe)
                sgn = torch.where(zeta >= 0.0, 1.0, -1.0)
                t = sgn / (zeta.abs() + torch.sqrt(1.0 + zeta * zeta))
                t = torch.where(live, t, torch.zeros_like(t))
                c = 1.0 / torch.sqrt(1.0 + t * t)
                s = (c * t)[:, None]
                c = c[:, None]
                w[:, :, p], w[:, :, q] = c * wp - s * wq, s * wp + c * wq
                vp, vq = v[:, :, p].clone(), v[:, :, q].clone()
                v[:, :, p], v[:, :, q] = c * vp - s * vq, s * vp + c * vq
    sig2 = (w * w).sum(1)
    sig2max = sig2.max(dim=1, keepdim=True).values
    keep = sig2 > (rcond * rcond) * sig2max
    wtb = (w * b[:, :, None]).sum(1)
    if lam > 0.0:
        keep = keep & (sig2 > lam * lam)
    coef = torch.where(keep, wtb / torch.clamp_min(sig2, _TINY),
                       torch.zeros_like(wtb))
    return (v * coef[:, None, :]).sum(2)


def truncated_lstsq(a: torch.Tensor, b: torch.Tensor,
                    rcond: float) -> torch.Tensor:
    """min ‖A x − b‖ by SVD for a (m, k), b (m,) -> x (k,), as
    ``jnp.linalg.lstsq(a, b, rcond)``: singular values σ > 0 with
    σ ≥ rcond·σmax are inverted, the others dropped. On a rank-deficient
    system (an approx cluster wholly absent) the rule decides the answer:
    the minimal-norm solution over the kept directions."""
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    keep = (s > 0) & (s >= rcond * s[0])
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    return vt.T @ (s_inv * (u.T @ b))


def gauss_inv_c(a_re: torch.Tensor, a_im: torch.Tensor):
    """Batched complex inverse of (bb, m, m) pairs -> (inv_re, inv_im)."""
    bb, m, _ = a_re.shape
    a_re, a_im = a_re.clone(), a_im.clone()
    inv_re = torch.eye(m, dtype=a_re.dtype,
                       device=a_re.device).expand(bb, m, m).clone()
    inv_im = torch.zeros_like(a_re)
    rowix = torch.arange(m, dtype=a_re.dtype, device=a_re.device)
    rowix = rowix.expand(bb, m)
    bidx = torch.arange(bb, device=a_re.device)
    for k in range(m):
        mod = a_re[:, :, k] ** 2 + a_im[:, :, k] ** 2
        mod = torch.where(rowix >= k, mod, torch.full_like(mod, -1.0))
        mx = mod.max(dim=1, keepdim=True).values
        r = torch.where(mod == mx, rowix, torch.full_like(rowix, float(m)))
        # lowest-index argmax; r = m (no row) when a NaN modulus made the
        # maximum NaN, and row k is then swapped with a zero row, as in
        # the reference
        r = r.min(dim=1).values.long()
        none = (r == m)[:, None]
        r_ix = torch.clamp_max(r, m - 1)
        for t in (a_re, a_im, inv_re, inv_im):
            row_k = t[:, k, :].clone()
            row_r = torch.where(none, 0.0, t[bidx, r_ix, :])
            # the reference's arithmetic swap: row_k + (row_r − row_k)
            t[:, k, :] = row_k + (row_r - row_k)
            t[bidx, r_ix, :] = torch.where(
                (r == k)[:, None] | none, t[bidx, r_ix, :],
                row_r + (row_k - row_r))
        p_re, p_im = a_re[:, k, k], a_im[:, k, k]
        pm = torch.clamp_min(p_re * p_re + p_im * p_im, _TINY)
        ip_re = (p_re / pm)[:, None]
        ip_im = (-p_im / pm)[:, None]
        rk_re, rk_im = a_re[:, k, :], a_im[:, k, :]
        ik_re, ik_im = inv_re[:, k, :], inv_im[:, k, :]
        srk_re = rk_re * ip_re - rk_im * ip_im
        srk_im = rk_re * ip_im + rk_im * ip_re
        sik_re = ik_re * ip_re - ik_im * ip_im
        sik_im = ik_re * ip_im + ik_im * ip_re
        isk = rowix == k
        f_re = torch.where(isk, 0.0, a_re[:, :, k])[:, :, None]
        f_im = torch.where(isk, 0.0, a_im[:, :, k])[:, :, None]
        srk_re, srk_im = srk_re[:, None, :], srk_im[:, None, :]
        sik_re, sik_im = sik_re[:, None, :], sik_im[:, None, :]
        a_re2 = a_re - (f_re * srk_re - f_im * srk_im)
        a_im2 = a_im - (f_re * srk_im + f_im * srk_re)
        inv_re2 = inv_re - (f_re * sik_re - f_im * sik_im)
        inv_im2 = inv_im - (f_re * sik_im + f_im * sik_re)
        isrow = isk[:, :, None]
        a_re = torch.where(isrow, srk_re, a_re2)
        a_im = torch.where(isrow, srk_im, a_im2)
        inv_re = torch.where(isrow, sik_re, inv_re2)
        inv_im = torch.where(isrow, sik_im, inv_im2)
    return inv_re, inv_im


def _lower(n: int, device) -> torch.Tensor:
    """(n, n) bool: [i, j] = j < i."""
    i = torch.arange(n, device=device)
    return i[None, :] < i[:, None]


def topk_mask(mag: torch.Tensor, m: int) -> torch.Tensor:
    """Bool mask of the top-m entries per row of mag (bb, n)."""
    n = mag.shape[1]
    gt = (mag[:, None, :] > mag[:, :, None]) | (
        (mag[:, None, :] == mag[:, :, None]) & _lower(n, mag.device))
    rank = gt.sum(dim=2)  # entries ahead of i
    return rank < m


def select_matrix(mask: torch.Tensor, m: int) -> torch.Tensor:
    """(bb, m, n) f32: S[r, i] = 1 iff lane i is the r-th set lane."""
    pos = torch.cumsum(mask.long(), dim=1) - 1
    r = torch.arange(m, device=mask.device)[None, :, None]
    return ((pos[:, None, :] == r) & mask[:, None, :]).float()


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of x (bb, n) over masked lanes (mean of the two middle order
    statistics for even counts); NaN for an empty mask."""
    n = x.shape[1]
    xs = torch.where(mask, x, torch.zeros_like(x))
    lt = (xs[:, None, :] < xs[:, :, None]) | (
        (xs[:, None, :] == xs[:, :, None]) & _lower(n, x.device))
    lt = lt & mask[:, None, :]
    rank = lt.sum(dim=2).to(x.dtype)
    p = mask.to(x.dtype).sum(dim=1, keepdim=True)
    k1 = torch.floor((p - 1.0) * 0.5)
    k2 = torch.floor(p * 0.5)

    def at_rank(k):
        hit = (rank == k) & mask
        return torch.where(hit, xs, torch.zeros_like(xs)).sum(dim=1)

    med = 0.5 * (at_rank(k1) + at_rank(k2))
    return torch.where(p[:, 0] > 0, med, torch.full_like(med, float("nan")))
