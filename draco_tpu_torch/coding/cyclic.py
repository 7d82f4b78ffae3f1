"""Cyclic (DFT) gradient code — construction, encode, decode
(draco_tpu/coding/cyclic.py).

n workers, s Byzantine, ŝ = 2s+1. C = DFT(n)/√n; C1 = first n−2s columns,
C2 = last 2s. Worker i evaluates the ŝ batch gradients of its cyclic window
and ships Σ_k W[i,k]·g_k, W = C1·Q. The decode projects the received rows
R = W·G + ε onto a random vector, forms the syndrome C2ᴴ·(R·f), solves the
s×s Hankel system for the error-locator polynomial, picks the n−2s rows the
locator calls honest, and recombines with v supported on them, vᵀC1 = e1ᵀ,
which gives vᵀR = Σ_k g_k exactly.

The construction is host numpy, copied from the reference. The decode's
O(n·d) products run through ``ops.coded``; the per-column locator runs
through ``ops.decode_kernels.cyclic_locator`` — on a CUDA tensor both are
the hand-written kernels, on a CPU tensor their plain versions.
:func:`locator_core` is the plain version of the locator kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from draco_tpu_torch.coding import linalg as linalg_mod
from draco_tpu_torch.ops import coded as ops_coded

LOCATOR_RCOND = 1e-5  # relative singular-value cutoff of the locator solve
HEALTH_REL_TOL = 1e-3  # row-flagging threshold, relative amplitude
SPREAD_PHI = 0.6180339887498949  # λ-path tie-break ordering (golden ratio)
LOUD_REL_TOL = 30.0  # loud-row threshold, relative energy vs the median


# --------------------------------------------------------------------------
# Construction (host numpy, identical on every participant)
# --------------------------------------------------------------------------

def _dft_c(n: int) -> np.ndarray:
    """Symmetric scaled DFT matrix C[p,q] = exp(-2πi·pq/n)/√n."""
    p, q = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    return np.exp(-2j * np.pi * p * q / n) / np.sqrt(n)


def _cyclic_support(n: int, hat_s: int) -> np.ndarray:
    """0/1 mask, row i supported on the cyclic window [i, i+hat_s)."""
    mask = np.zeros((n, n))
    for i in range(n):
        mask[i, (np.arange(i, i + hat_s) % n)] = 1.0
    return mask


def _solve_w(c1: np.ndarray, support: np.ndarray) -> np.ndarray:
    """W with columns in span(C1), support matching ``support``, Q[0,:]=1."""
    n, m = c1.shape
    w = np.zeros((n, n), dtype=complex)
    for k in range(n):
        zero_rows = np.where(support[:, k] == 0)[0]
        a = c1[zero_rows, 1:]
        b = -c1[zero_rows, 0]
        q_tail, *_ = np.linalg.lstsq(a, b, rcond=None)
        q = np.concatenate([[1.0 + 0j], q_tail])
        w[:, k] = c1 @ q
    return w


@dataclasses.dataclass(frozen=True)
class CyclicCode:
    """All constants the encode/decode need, as host f32 arrays."""

    n: int
    s: int
    w_sel_re: np.ndarray  # (n, hat_s): W[i, batch_ids[i, k]]
    w_sel_im: np.ndarray
    batch_ids: np.ndarray  # (n, hat_s) int32
    c2h_re: np.ndarray  # (2s, n) syndrome operator C2^H
    c2h_im: np.ndarray
    c1_re: np.ndarray  # (n, n-2s)
    c1_im: np.ndarray
    est_re: np.ndarray  # (n, s+1) locator evaluation grid
    est_im: np.ndarray
    w_masked_re: np.ndarray  # (n, n) support-masked W (shared encode)
    w_masked_im: np.ndarray

    @property
    def hat_s(self) -> int:
        return 2 * self.s + 1

    def tensors(self, device) -> dict:
        """The f32 constants as tensors on ``device`` (cached per device)."""
        cache = self.__dict__.setdefault("_tensors", {})
        key = str(device)
        if key not in cache:
            names = ("w_sel_re", "w_sel_im", "c2h_re", "c2h_im", "c1_re",
                     "c1_im", "est_re", "est_im", "w_masked_re",
                     "w_masked_im")
            cache[key] = {k: torch.as_tensor(getattr(self, k)).to(device)
                          for k in names}
        return cache[key]


def build_cyclic_code(n: int, s: int) -> CyclicCode:
    if n <= 4 * s:
        raise ValueError(f"cyclic code needs n > 4s, got n={n}, s={s}")
    hat_s = 2 * s + 1
    c = _dft_c(n)
    c1 = c[:, : n - hat_s + 1]  # n-2s columns
    support = _cyclic_support(n, hat_s)
    w = _solve_w(c1, support)
    c2 = c[:, n - hat_s + 1 :]
    c2h = c2.conj().T  # (2s, n)
    batch_ids = np.stack([np.where(support[i] != 0)[0] for i in range(n)]).astype(np.int32)
    w_sel = np.take_along_axis(w, batch_ids, axis=1)  # (n, hat_s)
    t = np.arange(n)
    z = np.exp(2j * np.pi * t / n)
    est = np.stack([z**j for j in range(s + 1)], axis=1)  # (n, s+1)
    f32 = lambda x: np.ascontiguousarray(x, dtype=np.float32)  # noqa: E731
    return CyclicCode(
        n=n,
        s=s,
        w_sel_re=f32(w_sel.real),
        w_sel_im=f32(w_sel.imag),
        batch_ids=batch_ids,
        c2h_re=f32(c2h.real),
        c2h_im=f32(c2h.imag),
        c1_re=f32(c1.real),
        c1_im=f32(c1.imag),
        est_re=f32(est.real),
        est_im=f32(est.imag),
        w_masked_re=f32(w.real * support),
        w_masked_im=f32(w.imag * support),
    )


# --------------------------------------------------------------------------
# Encode
# --------------------------------------------------------------------------

def encode(code: CyclicCode, grads: torch.Tensor):
    """grads (n, hat_s, d), grads[i, k] = gradient of batch batch_ids[i, k]
    computed by worker i -> (enc_re, enc_im), each (n, d)."""
    t = code.tensors(grads.device)
    return (torch.einsum("nk,nkd->nd", t["w_sel_re"], grads),
            torch.einsum("nk,nkd->nd", t["w_sel_im"], grads))


def encode_shared(code: CyclicCode, batch_grads: torch.Tensor):
    """Encode from one-copy batch gradients (n, d): one complex matmul."""
    t = code.tensors(batch_grads.device)
    return ops_coded.complex_matmul(t["w_masked_re"], t["w_masked_im"],
                                    batch_grads)


# --------------------------------------------------------------------------
# Decode
# --------------------------------------------------------------------------

def spread_rank(n: int) -> torch.Tensor:
    """(n,) f32 rank of frac(r·φ) by pairwise f32 comparison — the λ path's
    tie-break ordering, computed as the reference's kernel body does."""
    k = torch.arange(n, dtype=torch.float32) * SPREAD_PHI
    k = k - torch.floor(k)
    return (k[None, :] < k[:, None]).sum(dim=1).float()


def locator_core(e_re, e_im, c2h_re, c2h_im, c1_re, c1_im, est_re, est_im,
                 pres_f, s: int, rel_tol: float = HEALTH_REL_TOL,
                 lam: float = 0.0):
    """Decode steps 2–5 + health, batched over projected columns: the plain
    version of the ``cyclic_locator`` kernel (reference:
    ``coding/cyclic.locator_core``, op for op).

    e_re, e_im: (bb, n). pres_f: (1 or bb, n) f32 presence. Returns
    ``(v_re, v_im, honest, flagged, loud, residual)``: the first five
    (bb, n), ``residual`` (bb,). The v pair carries no 1/n."""
    bb, n = e_re.shape
    m = n - 2 * s
    pres_f = pres_f.expand(bb, n)
    energy = e_re ** 2 + e_im ** 2
    msq = ((energy * pres_f).sum(dim=1)
           / torch.clamp_min(pres_f.sum(dim=1), 1.0))[:, None]

    if s > 0:
        # 2. syndrome (bb, 2s)
        e2_re = e_re @ c2h_re.T - e_im @ c2h_im.T
        e2_im = e_re @ c2h_im.T + e_im @ c2h_re.T
        # 3. Hankel system A[i, j] = E2[s-1-i+j], b[i] = E2[2s-1-i]
        a_re = torch.stack([e2_re[:, s - 1 - i:2 * s - 1 - i]
                            for i in range(s)], dim=1)
        a_im = torch.stack([e2_im[:, s - 1 - i:2 * s - 1 - i]
                            for i in range(s)], dim=1)
        b_re = torch.stack([e2_re[:, 2 * s - 1 - i] for i in range(s)], 1)
        b_im = torch.stack([e2_im[:, 2 * s - 1 - i] for i in range(s)], 1)
        # scale-free normalisation by the syndrome magnitude; the λ path
        # divides by the signal scale and gates on syndrome significance
        syn = torch.sqrt(torch.clamp_min(
            (e2_re ** 2 + e2_im ** 2).max(dim=1).values, 1e-60))[:, None]
        scale = syn if lam == 0.0 else torch.clamp_min(torch.sqrt(msq), 1e-30)
        big = torch.cat([torch.cat([a_re, -a_im], dim=2),
                         torch.cat([a_im, a_re], dim=2)], dim=1)
        big = big / scale[:, :, None]
        rhs = torch.cat([b_re, b_im], dim=1) / scale
        al = linalg_mod.jacobi_lstsq(big, rhs, LOCATOR_RCOND, lam=lam)
        alpha_re, alpha_im = al[:, :s], al[:, s:]
        # 4. locator polynomial on the DFT grid
        one = torch.ones((bb, 1), dtype=e_re.dtype, device=e_re.device)
        poly_re = torch.cat([-alpha_re, one], dim=1)
        poly_im = torch.cat([-alpha_im, torch.zeros_like(one)], dim=1)
        val_re = poly_re @ est_re.T - poly_im @ est_im.T
        val_im = poly_re @ est_im.T + poly_im @ est_re.T
        mag = val_re ** 2 + val_im ** 2
        if lam > 0.0:
            live = (syn / scale) > 2.0 * lam
            mag = torch.where(live, mag, torch.ones_like(mag))
    else:
        mag = torch.ones((bb, n), dtype=e_re.dtype, device=e_re.device)

    # deterministic tie-break (index, or spread rank on the λ path) and
    # absent rows never eligible
    if lam == 0.0:
        bias = torch.arange(n, dtype=torch.float32, device=e_re.device)
    else:
        bias = spread_rank(n).to(e_re.device)
    mag = mag + bias[None, :] * ((1e-3 / n) * mag.mean(dim=1, keepdim=True))
    mag = torch.where(pres_f > 0, mag, torch.full_like(mag, -1.0))

    # 5. honest set, recombination vector and health fit through one
    #    Gauss–Jordan inverse of the (m, m) honest-row submatrix
    honest = linalg_mod.topk_mask(mag, m)
    sel = linalg_mod.select_matrix(honest, m)  # (bb, m, n)
    rec_re = sel @ c1_re
    rec_im = sel @ c1_im
    e_sel_re = (sel * e_re[:, None, :]).sum(2)
    e_sel_im = (sel * e_im[:, None, :]).sum(2)
    inv_re, inv_im = linalg_mod.gauss_inv_c(rec_re, rec_im)
    # vᵀ rec = e1ᵀ ⇒ v = row 0 of rec⁻¹, scattered back through sel
    v_re = (inv_re[:, 0, :, None] * sel).sum(1)
    v_im = (inv_im[:, 0, :, None] * sel).sum(1)
    q_re = ((inv_re * e_sel_re[:, None, :]).sum(2)
            - (inv_im * e_sel_im[:, None, :]).sum(2))
    q_im = ((inv_re * e_sel_im[:, None, :]).sum(2)
            + (inv_im * e_sel_re[:, None, :]).sum(2))
    fit_re = q_re @ c1_re.T - q_im @ c1_im.T
    fit_im = q_re @ c1_im.T + q_im @ c1_re.T
    dev = (e_re - fit_re) ** 2 + (e_im - fit_im) ** 2
    flagged = (dev > (rel_tol ** 2) * msq) & (pres_f > 0)
    resid_sq = ((torch.where(flagged, torch.zeros_like(dev), dev) * pres_f)
                .sum(dim=1)
                / torch.clamp_min((energy * pres_f).sum(dim=1), 1e-30))
    med = linalg_mod.masked_median(energy,
                                   (pres_f > 0) & ~torch.isnan(energy))
    loud = (energy > LOUD_REL_TOL * med[:, None]) & (pres_f > 0)
    return v_re, v_im, honest, flagged, loud, torch.sqrt(resid_sq)


def decode(code: CyclicCode, r_re: torch.Tensor, r_im: torch.Tensor,
           rand_factor: torch.Tensor, present: Optional[torch.Tensor] = None,
           with_health: bool = False, rel_tol: float = HEALTH_REL_TOL,
           lam: float = 0.0):
    """Recover the exact mean of the n batch gradients from (n, d) received
    rows with ≤ s corrupt: project -> locator -> recombine with v/n.

    Returns (decoded (d,), honest (n,) bool) and, with ``with_health``, the
    health dict (``residual`` scalar, ``flagged`` and ``loud`` (n,) bool).
    """
    from draco_tpu_torch.ops import decode_kernels

    n = code.n
    # 1. project to one column: e = R @ f (the first O(n·d) pass)
    e_re, e_im = ops_coded.complex_project(r_re, r_im, rand_factor)
    pres_f = (torch.ones((1, n), dtype=torch.float32, device=r_re.device)
              if present is None else present.float().reshape(1, n))
    v_re, v_im, honest_l, flagged_l, loud_l, resid_l = (
        decode_kernels.cyclic_locator(code, e_re[None, :], e_im[None, :],
                                      pres_f, rel_tol, lam=lam))
    # 6. recombine: Re(vᵀR) with the 1/n folded into v (the second pass)
    decoded = ops_coded.complex_recombine(v_re[0] / n, v_im[0] / n,
                                          r_re, r_im)
    honest = honest_l[0]
    if with_health:
        return decoded, honest, {"residual": resid_l[0],
                                 "flagged": flagged_l[0],
                                 "loud": loud_l[0]}
    return decoded, honest
