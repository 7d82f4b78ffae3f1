"""Complex-arithmetic products of the cyclic gradient code
(draco_tpu/ops/coded.py).

  * ``complex_matmul``    encode:     (Wr + i·Wi) @ G            for real G
  * ``complex_project``   decode in:  (Rr + i·Ri) @ f            for real f
  * ``complex_recombine`` decode out: Re[(vr + i·vi)ᵀ (Rr + i·Ri)]

Each wrapper launches its CUDA kernel (``csrc/coded.cu``) on a CUDA tensor
and computes its plain version (``*_plain``, the reference's XLA
formulation) on a CPU tensor; any other device raises. A wrapper counts its
kernel launches in ``<wrapper>.launches``. The launch itself (``*_launch``)
writes into outputs the caller allocated, which lets the kernel audit
(``analysis/kernel_audit.py``) hand it guarded buffers.
"""

from __future__ import annotations

import torch

from draco_tpu_torch import _build


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA inputs (checked for the kernel), False for CPU ones."""
    dev = tensors[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"coded ops run on cuda or cpu tensors, got {dev}")
    for t in tensors:
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                "coded kernels take contiguous float32 tensors on one device; "
                f"got {t.dtype} {tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
    return True


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# --------------------------------------------------------------------------
# encode
# --------------------------------------------------------------------------

def complex_matmul_plain(w_re, w_im, g):
    return w_re @ g, w_im @ g


def complex_matmul(w_re, w_im, g):
    """(Wr + i·Wi) @ G for real G: W (m, n), G (n, d) -> (re, im), (m, d)."""
    if not _on_cuda(g, w_re, w_im):
        return complex_matmul_plain(w_re, w_im, g)
    (m, n), d = w_re.shape, g.shape[1]
    if w_im.shape != (m, n) or g.shape[0] != n or n > 64 or m > 64:
        raise ValueError(f"complex_matmul: W {tuple(w_re.shape)} / "
                         f"{tuple(w_im.shape)}, G {tuple(g.shape)} (n, m <= 64)")
    out_re = torch.empty((m, d), dtype=torch.float32, device=g.device)
    out_im = torch.empty_like(out_re)
    complex_matmul_launch(w_re, w_im, g, out_re, out_im)
    complex_matmul.launches += 1
    return out_re, out_im


def complex_matmul_launch(w_re, w_im, g, out_re, out_im) -> None:
    """The encode kernel into ``out_re``, ``out_im`` (m, d)."""
    (m, n), d = w_re.shape, g.shape[1]
    err = _build.library("coded").draco_complex_matmul(
        w_re.data_ptr(), w_im.data_ptr(), g.data_ptr(), out_re.data_ptr(),
        out_im.data_ptr(), m, n, d, _stream())
    _build.check(err, "complex_matmul")


complex_matmul.launches = 0


# --------------------------------------------------------------------------
# decode projection
# --------------------------------------------------------------------------

def complex_project_plain(r_re, r_im, f):
    return r_re @ f, r_im @ f


def complex_project(r_re, r_im, f):
    """(Rr + i·Ri) @ f for real f (d,): returns (re, im), each (n,)."""
    if not _on_cuda(r_re, r_im, f):
        return complex_project_plain(r_re, r_im, f)
    n, d = r_re.shape
    if r_im.shape != (n, d) or f.shape != (d,) or d < 1:
        raise ValueError(f"complex_project: R {tuple(r_re.shape)} / "
                         f"{tuple(r_im.shape)}, f {tuple(f.shape)}")
    chunks = project_chunks(n, d)
    part = torch.empty((2, n, chunks), dtype=torch.float32, device=f.device)
    e = torch.empty((2, n), dtype=torch.float32, device=f.device)
    complex_project_launch(r_re, r_im, f, part[0], part[1], e[0], e[1])
    complex_project.launches += 1
    return e[0], e[1]


def project_chunks(n: int, d: int) -> int:
    """Pass-1 blocks of the projection of n rows of length d (one whole
    wave of the card): its (n, chunks) partials."""
    return _build.library("coded").draco_project_chunks(n, d)


def complex_project_launch(r_re, r_im, f, part_re, part_im, e_re,
                           e_im) -> None:
    """Both passes of the projection: the (n, chunks) partials, then
    ``e_re``, ``e_im`` (n,)."""
    n, d = r_re.shape
    err = _build.library("coded").draco_complex_project(
        r_re.data_ptr(), r_im.data_ptr(), f.data_ptr(), part_re.data_ptr(),
        part_im.data_ptr(), e_re.data_ptr(), e_im.data_ptr(), n, d,
        part_re.shape[1], _stream())
    _build.check(err, "complex_project")


complex_project.launches = 0


# --------------------------------------------------------------------------
# decode recombination
# --------------------------------------------------------------------------

def complex_recombine_plain(v_re, v_im, r_re, r_im):
    return v_re @ r_re - v_im @ r_im


def complex_recombine(v_re, v_im, r_re, r_im):
    """Re[(vr + i·vi)ᵀ (Rr + i·Ri)] = vrᵀRr − viᵀRi: returns real (d,)."""
    if not _on_cuda(r_re, r_im, v_re, v_im):
        return complex_recombine_plain(v_re, v_im, r_re, r_im)
    n, d = r_re.shape
    if r_im.shape != (n, d) or v_re.shape != (n,) or v_im.shape != (n,):
        raise ValueError(f"complex_recombine: v {tuple(v_re.shape)} / "
                         f"{tuple(v_im.shape)}, R {tuple(r_re.shape)} / "
                         f"{tuple(r_im.shape)}")
    out = torch.empty((d,), dtype=torch.float32, device=r_re.device)
    complex_recombine_launch(v_re, v_im, r_re, r_im, out)
    complex_recombine.launches += 1
    return out


def complex_recombine_launch(v_re, v_im, r_re, r_im, out) -> None:
    """The recombination kernel into ``out`` (d,)."""
    n, d = r_re.shape
    err = _build.library("coded").draco_complex_recombine(
        v_re.data_ptr(), v_im.data_ptr(), r_re.data_ptr(), r_im.data_ptr(),
        out.data_ptr(), n, d, _stream())
    _build.check(err, "complex_recombine")


complex_recombine.launches = 0
