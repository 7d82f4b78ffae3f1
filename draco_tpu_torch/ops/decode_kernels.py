"""The fused cyclic error locator (draco_tpu/ops/decode_kernels.py).

``cyclic_locator`` runs decode steps 2–5 and the decode health on a stack
of projected columns: syndrome → Hankel solve by one-sided Jacobi →
locator on the DFT grid → top-(n−2s) honest mask → one complex
Gauss–Jordan inverse giving the recombination vector and the codeword fit
→ flagged / loud / residual. On a CUDA tensor it launches the kernel of
``csrc/cyclic_locator.cu`` (one thread block per column); on a CPU tensor
it runs the plain version, ``coding/cyclic.locator_core``. The wrapper
counts its kernel launches in ``cyclic_locator.launches``.
"""

from __future__ import annotations

import torch

from draco_tpu_torch import _build

MAX_N = 64  # the kernel's block width; rank counts are exact to 64 rows


def resolve_decode_impl(value: str, device) -> str:
    """cfg.decode_impl -> which locator runs on ``device``: ``"cuda"`` (the
    kernel) for a CUDA device, ``"plain"`` (``locator_core``) for the CPU.
    ``auto`` and ``pallas`` mean the same here: the kernel wherever it can
    run. There is no fallback from the kernel on a CUDA device."""
    if value not in ("auto", "pallas"):
        raise ValueError(f"decode_impl must be auto|pallas, got {value!r}")
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    return "cuda" if dev.type == "cuda" else "plain"


def cyclic_locator(code, e_re_l, e_im_l, pres_f, rel_tol: float,
                   lam: float = 0.0):
    """(L, n) projected-column stack -> ``(v_re, v_im, honest, flagged,
    loud, residual)`` of :func:`~draco_tpu_torch.coding.cyclic.locator_core`:
    the first five (L, n), ``residual`` (L,). ``pres_f``: (1, n) f32
    presence shared by every column."""
    from draco_tpu_torch.coding import cyclic as cyclic_mod

    dev = e_re_l.device
    t = code.tensors(dev)
    if resolve_decode_impl("auto", dev) == "plain":
        return cyclic_mod.locator_core(
            e_re_l, e_im_l, t["c2h_re"], t["c2h_im"], t["c1_re"], t["c1_im"],
            t["est_re"], t["est_im"], pres_f, code.s, rel_tol, lam=lam)
    L, n = e_re_l.shape
    s = code.s
    if n != code.n or n > MAX_N:
        raise ValueError(f"cyclic_locator: columns of {n} rows for a code of "
                         f"n={code.n} (the kernel takes n <= {MAX_N})")
    ins = (e_re_l, e_im_l, pres_f)
    for x in ins:
        if x.device != dev or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError("cyclic_locator takes contiguous float32 tensors "
                             f"on one device; got {x.dtype} on {x.device}")
    if e_im_l.shape != (L, n) or pres_f.shape != (1, n):
        raise ValueError(f"cyclic_locator: e {tuple(e_re_l.shape)} / "
                         f"{tuple(e_im_l.shape)}, pres {tuple(pres_f.shape)}")
    v = torch.empty((2, L, n), dtype=torch.float32, device=dev)
    masks = torch.empty((3, L, n), dtype=torch.bool, device=dev)
    resid = torch.empty((L,), dtype=torch.float32, device=dev)
    c = [t[k] for k in ("c2h_re", "c2h_im", "c1_re", "c1_im", "est_re",
                        "est_im")]
    err = _build.library("cyclic_locator").draco_cyclic_locator(
        e_re_l.data_ptr(), e_im_l.data_ptr(), *(x.data_ptr() for x in c),
        pres_f.data_ptr(), v[0].data_ptr(), v[1].data_ptr(),
        masks[0].data_ptr(), masks[1].data_ptr(), masks[2].data_ptr(),
        resid.data_ptr(), L, n, s, cyclic_mod.linalg_mod.JACOBI_SWEEPS,
        cyclic_mod.LOCATOR_RCOND ** 2, lam, lam * lam, 2.0 * lam,
        1e-3 / n, rel_tol ** 2, cyclic_mod.LOUD_REL_TOL,
        cyclic_mod.SPREAD_PHI, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "cyclic_locator")
    cyclic_locator.launches += 1
    return v[0], v[1], masks[0], masks[1], masks[2], resid


cyclic_locator.launches = 0
