"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into a shared library with a plain C
interface, loaded with ``ctypes``; nothing includes PyTorch's headers, so a
build takes seconds. Libraries go to ``draco_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of the source and the flags, so an edited
source is rebuilt at its next use. :func:`build_all` starts one ``nvcc`` per
source, all at once; :func:`library` builds one source if its library is
missing and returns it loaded.

Pointers and the stream go to the C functions as ``c_void_p`` and 64-bit
lengths as ``c_longlong``: ctypes would otherwise pass them as 32-bit ints.

Every library also exports the resource query of ``csrc/audit.cuh``
(``AUDIT_SIGNATURES``), which the kernel audit reads
(``analysis/kernel_audit.py``); a header's contents are part of the hash of
every source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from draco_tpu_torch.obs import compile_watch

PKG_DIR = Path(__file__).resolve().parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# no --use_fast_math and no -ftz=true, here or below: csrc/numerics.cu
# counts float32 subnormals, which flushing to zero would hide
# the locator is a chain of small dot products whose rounding the plain
# version sets; keep nvcc from contracting a*b + c into one FMA there
EXTRA_FLAGS = {"cyclic_locator": ("--fmad=false",)}

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_U = ctypes.c_uint
SIGNATURES = {
    "coded": {
        "draco_complex_matmul": [_P, _P, _P, _P, _P, _I, _I, _LL, _P],
        "draco_project_chunks": [_I, _LL],
        "draco_complex_project": [_P, _P, _P, _P, _P, _P, _P, _I, _LL, _I, _P],
        "draco_complex_recombine": [_P, _P, _P, _P, _P, _I, _LL, _P],
        "draco_complex_project_segments": [_P] * 4 + [_I, _I] + [_P] * 4
        + [_I, _LL, _P],
        "draco_complex_recombine_segments": [_P] * 5 + [_I, _P, _I, _LL, _P],
    },
    "cyclic_locator": {
        "draco_cyclic_locator": [_P] * 15 + [_I] * 5 + [_F] * 8 + [_P],
    },
    "narrow_decode": {
        "draco_narrow_recombine": [_P] * 7 + [_I, _LL, _I, _I, _LL, _P],
        "draco_approx_decode_chunks": [_LL],
        "draco_approx_decode": [_P] * 8 + [_I, _LL, _LL, _LL, _I, _I, _LL, _I,
                                           _F, _P],
        "draco_narrow_recombine_segments": [_P] * 7 + [_I, _P, _I, _LL, _I,
                                                       _I, _LL, _P],
    },
    "flash_attention": {
        "draco_flash_fwd": [_P] * 5 + [_I] * 3 + [_F, _I, _P],
        "draco_flash_dq": [_P] * 8 + [_I] * 3 + [_F, _I, _P],
        "draco_flash_dkv": [_P] * 9 + [_I] * 3 + [_F, _I, _P],
    },
    "vote": {
        "draco_row_fingerprints": [_P, _P, _P, _I, _LL, _I, _P],
    },
    "draws": {
        "draco_random_inject": [_P, _P, _P, _P, _U, _F, _I, _LL, _P],
        "draco_round_draw": [_P, _P, _U, _I, _LL, _I, _P],
        "draco_synthetic_text": [_P, _P, _U, _I, _I, _I, _P],
        "draco_augment_draws": [_P, _P, _U, _I, _I, _I, _I, _P],
        "draco_dropout_keep": [_P, _P, _U, _I, _I, _I, _U, _U, _LL, _F, _P],
        "draco_vote_salts": [_P, _P, _U, _P],
    },
    "numerics": {
        "draco_stage_grid": [_LL, _LL, _LL],
        "draco_stage_stats": [_P, _P, _LL, _LL, _LL, _P, _P, _F, _P],
        "draco_nonfinite_rows": [_P, _P, _I, _LL, _P],
    },
    "controls": {
        "draco_control_mistiled_copy": [_P, _P, _I, _I, _P],
        "draco_control_overlaunch": [_P, _LL, _P],
        "draco_control_spill": [_P, _P, _P, _LL, _P],
    },
}
# name -> (argtypes, restype) of the resource query every source exports
AUDIT_SIGNATURES = {
    "draco_audit_count": ([], ctypes.c_int),
    "draco_audit_name": ([_I], ctypes.c_char_p),
    "draco_audit_kernel": ([_I, _LL, _LL, _P], ctypes.c_int),
}

_LOADED: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc was not found (PATH or /usr/local/cuda/bin): the CUDA "
            "kernels are built from csrc/ at first use on a machine with the "
            "CUDA toolkit")
    return path


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def lib_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` at its current contents
    lives."""
    h = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source into a temporary file; None if the library
    is already built."""
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_flags(name), "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return name, proc, tmp, out


def _finish(job) -> None:
    name, proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def build_all() -> list:
    """Build every source under csrc/ that has no current library, one nvcc
    per source, all started together. Returns the names built."""
    jobs = [j for j in (_start(n) for n in sorted(SIGNATURES)) if j]
    try:
        for job in jobs:
            _finish(job)
    finally:
        for _, proc, _, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return [job[0] for job in jobs]


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed. Its
    first load in the process is reported to the compile sentinel
    (``obs/compile_watch.report``, a ``kernel_build`` with the seconds of
    the load and of nvcc, 0 when the library was built already)."""
    lib = _LOADED.get(name)
    if lib is None:
        t0 = time.perf_counter()
        job = _start(name)
        if job:
            _finish(job)
        nvcc_s = time.perf_counter() - t0 if job else 0.0
        lib = ctypes.CDLL(str(lib_path(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        for fn, (argtypes, restype) in AUDIT_SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LOADED[name] = lib
        compile_watch.report("kernel_build", name, time.perf_counter() - t0,
                             nvcc_s=round(nvcc_s, 6), cached=job is None)
    return lib


class CudaError(RuntimeError):
    """A C entry point returned a non-zero ``cudaError_t`` (``code``)."""

    def __init__(self, what: str, code: int):
        super().__init__(f"{what}: CUDA error {code}")
        self.code = code


def check(err: int, what: str) -> None:
    """Raise :class:`CudaError` if a C entry point returned a non-zero
    ``cudaError_t``."""
    if err != 0:
        raise CudaError(what, err)
