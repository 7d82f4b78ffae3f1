"""The kernel audit of the port (tools/tpu_attn_lowering_check.py with
tools/_lowering_common.run_rows).

    python -m draco_tpu_torch.analysis.kernel_audit [--device cpu|cuda]
        [--kernels NAME,...] [--out FILE]

One row per kernel entry point of ``csrc/*.cu`` — the twenty-one of the
main paths and the three negative controls of ``csrc/controls.cu`` — each
grouping the ``__global__`` functions it launches, held to the
:class:`KernelSpec` below by four rules:

  resources      from the libraries this run built (the resource query of
                 ``csrc/audit.cuh``: cudaFuncGetAttributes and the
                 launcher's own block and dynamic shared memory at the main
                 path's shape): registers a thread at most the spec's,
                 local (spill and stack) bytes at most the spec's (0 unless
                 it says why), and at least one resident block a SM
  launch_limits  every block within the card's threads, static plus dynamic
                 shared memory within 48 KB — or the opt-in limit where the
                 source raises it — at the largest configuration
                 ``config.validate()`` accepts (n = 64 workers, s = 15, one
                 decode column), and a real launch there
  coverage       a small ragged shape with every output poisoned (a NaN of
                 its own bit pattern; 0xA5 for one-byte outputs) and a
                 guard band of 256 elements on both sides: every element is
                 written and no guard element touched
  sanitizer      a child process runs the coverage shapes under
                 ``compute-sanitizer --tool memcheck``, and ``--tool
                 racecheck`` for the kernels with shared memory; both must
                 report 0 errors and the child must finish. An entry point
                 fails when the tool names one of its functions in an
                 error, or (errors naming none, or a child that died or
                 timed out under the tool) when the child never reported
                 it done. Only a tool that is absent or refuses the device
                 ("Device not supported") makes the row record ``"ran":
                 false``, with the path looked at and the tool's answer

A real kernel's row is ok when no rule fails; a control's when exactly its
rule does (the mis-tiled copy: coverage, 576 outputs unwritten and 0 guard
elements touched, its output still equal to its plain version bit for bit;
the over-launch: launch_limits, CUDA error 9 — cudaErrorInvalidConfiguration
— through ``_build.check``; the spill: resources, local bytes > 0). On the
CPU only coverage runs, on the plain versions (which write their whole
result; the mis-tiled plain copy writes what its grid covers). The report
is rewritten after every row (default
``draco_tpu_torch/_build/audit/kernel_audit.json``).
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
from typing import Callable, Optional

import torch

from draco_tpu_torch import _build
from draco_tpu_torch.analysis.rows import run_rows

AUDIT_DIR = _build.BUILD_DIR / "audit"
DEFAULT_OUT = str(AUDIT_DIR / "kernel_audit.json")
RULES = ("resources", "launch_limits", "coverage", "sanitizer")
GUARD = 256  # guard elements on each side of every output
POISON_F32 = 0x7FF0DEAD  # a NaN no kernel writes (they write 0x7FC00000)
POISON_BYTE = 0xA5
CUDA_HOME = "/usr/local/cuda/bin"
# the largest configuration config.validate() accepts for a coded step
MAX_N, MAX_S = 64, 15
_OUT_LEN = 10  # csrc/audit.cuh's Out
INVALID_CONFIGURATION = 9  # cudaErrorInvalidConfiguration


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One entry point: its ``__global__`` functions (the names of
    ``csrc/audit.cuh``'s table), the TPU kernel it replaces, and its
    manifest. ``shape`` / ``largest_shape`` are the (a, b) its dynamic
    shared memory depends on at the main path and at the largest
    configuration (``largest``, where it is also launched for real);
    ``main`` the functions the main path runs (all, if empty)."""

    name: str
    source: str
    functions: tuple
    replaces: str
    max_registers: int
    local_bytes: Optional[dict] = None  # function -> allowed bytes (else 0)
    local_reason: str = ""
    shape: tuple = (0, 0)
    largest: Optional[dict] = None  # {"n": 64, ...}: launched for real
    largest_shape: tuple = (0, 0)
    racecheck: bool = True
    control: str = ""  # the one rule a control trips
    main: tuple = ()


# registers and local bytes: what nvcc 12.8 gives each function for sm_90a
# (the audit's first run on an H100, PERF.md §6); more is a regression to
# look at, and a row that allows local memory says why
SPECS = (
    # the encode takes float4 (<4>, the LM's d, 128 registers) or
    # single-float (<1>, 67) column groups, or float2 groups stored a
    # 128-byte line at a time through shared memory (lines, ResNet-18's d ≡
    # 2 mod 8, 92; 64 KB at the largest W, the launcher opts in), 8 rows of
    # G in flight a thread and the sums of 8 output rows, at 2 blocks a SM
    KernelSpec("complex_matmul", "coded",
               ("complex_matmul_kernel<4>", "complex_matmul_lines_kernel",
                "complex_matmul_kernel<1>"),
               "draco_tpu/ops/coded.py:82", 128, shape=(8, 8),
               largest={"m": MAX_N, "n": MAX_N},
               largest_shape=(MAX_N, MAX_N),
               main=("complex_matmul_kernel<4>",
                     "complex_matmul_lines_kernel")),
    # the projection's first pass reads float2 pairs (<2>, an even d) or
    # floats (<1>), kUnroll column groups of 8 rows in flight a thread
    KernelSpec("complex_project", "coded",
               ("project_partial_kernel<2>", "project_partial_kernel<1>",
                "project_final_kernel"),
               "draco_tpu/ops/coded.py:152", 120,
               main=("project_partial_kernel<2>", "project_final_kernel")),
    KernelSpec("complex_recombine", "coded", ("complex_recombine_kernel",),
               "draco_tpu/ops/coded.py:201", 32, shape=(8, 0),
               largest={"n": MAX_N}, largest_shape=(MAX_N, 0)),
    # the locator: one warp a column, one row a lane (two, n > 32), the
    # Hankel solve's rows in registers at s = 1, 2 (<kRow1M2> 64 registers,
    # <kRow1M4> 72) or in a per-warp shared tile (<kRow1> 80, <kRow2> 96);
    # no run-time-indexed array and no slow-path call, so no local memory
    # (ops/decode_kernels.LOCATOR_ROUTES picks the instance)
    KernelSpec("cyclic_locator", "cyclic_locator",
               ("cyclic_locator_kernel<kRow1M2>",
                "cyclic_locator_kernel<kRow1M4>",
                "cyclic_locator_kernel<kRow1>",
                "cyclic_locator_kernel<kRow2>"),
               "draco_tpu/ops/decode_kernels.py:127", 96,
               shape=(8, 1), largest={"n": MAX_N, "s": MAX_S, "L": 1},
               largest_shape=(MAX_N, MAX_S),
               main=("cyclic_locator_kernel<kRow1M2>",
                     "cyclic_locator_kernel<kRow1M4>")),
    # the narrow decode reads strips of 16-byte chunks (the approx decode:
    # 4 columns), the loads of a row group in flight (the recombination: 4
    # rows of each buffer at 2 blocks a SM, kInt8 127 registers; kInt8Any,
    # an int8 block the strip does not divide, holds its 16 block indices
    # at 1 block a SM; the approx decode: 8 rows, and since its offset
    # entry a row stride and a first column: kF32 128 registers, 2 blocks a
    # SM)
    KernelSpec("cyclic_narrow_recombine", "narrow_decode",
               ("narrow_recombine_kernel<kF32>",
                "narrow_recombine_kernel<kBF16>",
                "narrow_recombine_kernel<kInt8>",
                "narrow_recombine_kernel<kInt8Any>"),
               "draco_tpu/ops/decode_kernels.py:378", 167, shape=(8, 0),
               largest={"n": MAX_N}, largest_shape=(MAX_N, 0),
               main=("narrow_recombine_kernel<kBF16>",
                     "narrow_recombine_kernel<kInt8>")),
    KernelSpec("approx_decode", "narrow_decode",
               ("approx_decode_partial_kernel<kF32>",
                "approx_decode_partial_kernel<kBF16>",
                "approx_decode_partial_kernel<kInt8>",
                "approx_decode_partial_kernel<kInt8Any>",
                "approx_decode_final_kernel"),
               "draco_tpu/ops/decode_kernels.py:271", 128, shape=(8, 0),
               largest={"n": MAX_N}, largest_shape=(MAX_N, 0),
               main=("approx_decode_partial_kernel<kF32>",
                     "approx_decode_partial_kernel<kInt8>",
                     "approx_decode_final_kernel")),
    # the flash kernels on the tensor cores: each thread holds its rows'
    # float32 totals, the scores of a pass and split operands in registers
    # (the dk/dv instances up to the 255 a thread has); their tiles are
    # dynamic shared memory, above 48 KB at Dh 64 and 128 (the launchers
    # opt in)
    KernelSpec("flash_fwd", "flash_attention",
               tuple(f"flash_fwd_kernel<{d}>" for d in (16, 32, 64, 128)),
               "draco_tpu/ops/flash_attention.py:174", 223,
               main=("flash_fwd_kernel<64>",)),
    KernelSpec("flash_dq", "flash_attention",
               tuple(f"flash_dq_kernel<{d}>" for d in (16, 32, 64, 128)),
               "draco_tpu/ops/flash_attention.py:328", 205,
               local_bytes={"flash_dq_kernel<128>": 8},
               local_reason="ptxas keeps two 4-byte values of the <128> "
                            "instance (Dh 65-128, not on the LM path) in an "
                            "8-byte frame at 168 registers (ptxas -v: 8 "
                            "bytes spill stores, 16 bytes spill loads)",
               main=("flash_dq_kernel<64>",)),
    KernelSpec("flash_dkv", "flash_attention",
               tuple(f"flash_dkv_kernel<{d}>" for d in (16, 32, 64, 128)),
               "draco_tpu/ops/flash_attention.py:353", 255,
               main=("flash_dkv_kernel<64>",)),
    # the vote's fingerprints: two 32-bit sums a thread, 16-byte loads of
    # f32 (<4>) or bf16 (<2>) elements
    KernelSpec("row_fingerprints", "vote",
               ("row_fingerprints_kernel<4>", "row_fingerprints_kernel<2>"),
               "draco_tpu/coding/repetition.py:94", 32,
               largest={"n": MAX_N}, largest_shape=(MAX_N, 0),
               main=("row_fingerprints_kernel<4>",)),
    # the segmented decode over a segment plan: the projection's first
    # pass (one block a column tile) holds 2 columns of 8 rows of each
    # buffer in flight a thread (126 registers, 2 blocks a SM), the f32
    # recombination one column's sums; the narrow one reads the strips of
    # the whole-d kernel with each strip's v pair (kInt8 126 registers at 2
    # blocks a SM, kBF16 116; kInt8Any, a block the strip does not divide,
    # 186 at 1 block a SM)
    KernelSpec("complex_project_segments", "coded",
               ("project_segments_partial_kernel",
                "project_segments_final_kernel"),
               "draco_tpu/ops/coded.py:152", 128),
    KernelSpec("complex_recombine_segments", "coded",
               ("recombine_segments_kernel",), "draco_tpu/ops/coded.py:201",
               40, shape=(8, 0), largest={"n": MAX_N},
               largest_shape=(MAX_N, 0)),
    KernelSpec("cyclic_narrow_recombine_segments", "narrow_decode",
               ("narrow_recombine_segments_kernel<kBF16>",
                "narrow_recombine_segments_kernel<kInt8>",
                "narrow_recombine_segments_kernel<kInt8Any>"),
               "draco_tpu/ops/decode_kernels.py:378", 186,
               largest={"n": MAX_N},
               main=("narrow_recombine_segments_kernel<kInt8>",)),
    # the device draws (csrc/draws.cu): one threefry a draw, the normal's
    # erfinv beside it, the key chain in registers (31 and 29 registers,
    # 22 and 21, 26)
    KernelSpec("random_inject", "draws",
               ("random_inject_kernel<true>", "random_inject_kernel<false>"),
               "draco_tpu/attacks.py:40", 32, largest={"n": MAX_N},
               largest_shape=(MAX_N, 0),
               main=("random_inject_kernel<true>",)),
    KernelSpec("round_draw", "draws",
               ("round_draw_kernel<false>", "round_draw_kernel<true>"),
               "draco_tpu/obs/numerics.py:494", 24),
    KernelSpec("synthetic_text", "draws", ("synthetic_text_kernel",),
               "draco_tpu/parallel/sp_step.py:83", 32),
    # the training step's draws: a sample's key chain (15 threefry calls)
    # or a row-layer's in registers
    KernelSpec("augment_draws", "draws", ("augment_draws_kernel",),
               "draco_tpu/data/augment.py:18", 40),
    KernelSpec("dropout_keep", "draws", ("dropout_keep_kernel",),
               "draco_tpu/models/vgg.py:52", 32),
    KernelSpec("vote_salts", "draws", ("vote_salts_kernel",),
               "draco_tpu/coding/repetition.py:115", 32),
    # the observatory (csrc/numerics.cu): the statistics' ten counters, Σ x²
    # in f64 and 8 loaded values a lane in registers (64 registers, 4
    # blocks a SM); the ingest check's exponent test of 16-byte chunks (20)
    KernelSpec("stage_stats", "numerics",
               ("stage_stats_kernel<32>", "stage_stats_kernel<256>",
                "stage_finish_kernel"),
               "draco_tpu/obs/numerics.py:446", 64,
               main=("stage_stats_kernel<32>", "stage_finish_kernel")),
    KernelSpec("nonfinite_rows", "numerics", ("nonfinite_rows_kernel",),
               "draco_tpu/obs/forensics.py:161", 32, largest={"n": MAX_N},
               largest_shape=(MAX_N, 0)),
    KernelSpec("control_mistiled_copy", "controls",
               ("control_mistiled_copy_kernel",),
               "tools/tpu_attn_lowering_check.py:111", 8, racecheck=False,
               control="coverage"),
    KernelSpec("control_overlaunch", "controls",
               ("control_overlaunch_kernel",), "", 8, racecheck=False,
               control="launch_limits"),
    KernelSpec("control_spill", "controls", ("control_spill_kernel",), "",
               32, racecheck=False, control="resources"),
)


def spec(name: str) -> KernelSpec:
    for s in SPECS:
        if s.name == name:
            return s
    raise KeyError(f"no kernel {name!r}; audited: {[s.name for s in SPECS]}")


# --------------------------------------------------------------------------
# coverage: poisoned, guarded outputs
# --------------------------------------------------------------------------

def _guarded(shape, dtype, dev):
    """(buffer, view): ``view`` of ``shape`` inside GUARD elements of
    poison on each side."""
    n = math.prod(shape)
    if dtype in (torch.float32, torch.int32):
        buf = torch.full((n + 2 * GUARD,), POISON_F32, dtype=torch.int32,
                         device=dev).view(dtype)
    else:  # one-byte outputs: the locator's masks
        buf = torch.full((n + 2 * GUARD,), POISON_BYTE, dtype=torch.uint8,
                         device=dev)
    return buf, buf[GUARD:GUARD + n].view(shape)


def _verdict(buf, n: int) -> tuple:
    """(unwritten, guard elements touched) of a guarded buffer."""
    if buf.dtype in (torch.float32, torch.int32):
        bits, poison = buf.view(torch.int32), POISON_F32
    else:
        bits, poison = buf, POISON_BYTE
    body = bits[GUARD:GUARD + n]
    guards = torch.cat([bits[:GUARD], bits[GUARD + n:]])
    return int((body == poison).sum()), int((guards != poison).sum())


def _put(outs: dict, **values) -> None:
    """The plain versions' results into the guarded outputs (CPU)."""
    for k, v in values.items():
        if tuple(v.shape) != tuple(outs[k].shape):
            raise ValueError(f"{k}: the plain version gives "
                             f"{tuple(v.shape)}, the kernel writes "
                             f"{tuple(outs[k].shape)}")
        outs[k].copy_(v)


@dataclasses.dataclass
class Case:
    label: str
    outputs: dict  # name -> (shape, dtype)
    run: Callable  # (outs) -> None: launch (cuda) or plain (cpu)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _cases(name: str, dev) -> list:
    """The coverage cases of one entry point on ``dev``: small, ragged
    against the kernels' blocks."""
    from draco_tpu_torch.obs import numerics
    from draco_tpu_torch.ops import coded, controls
    from draco_tpu_torch.ops import flash_attention as fa

    cuda = dev.type == "cuda"
    g = torch.Generator(device=dev).manual_seed(7)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    f32 = torch.float32
    cases = []
    if name == "complex_matmul":
        for m, n, d, offset in ENCODE_CASES:
            w_re, w_im = rnd(m, n), rnd(m, n)
            gr = offset_copy(rnd(n, d), offset)

            def run(o, w_re=w_re, w_im=w_im, gr=gr):
                if cuda:
                    coded.complex_matmul_launch(w_re, w_im, gr, o["out_re"],
                                                o["out_im"])
                else:
                    re, im = coded.complex_matmul_plain(w_re, w_im, gr)
                    _put(o, out_re=re, out_im=im)
            where = f", G at byte {offset}" if offset else ""
            cases.append(Case(f"m={m} n={n} d={d}{where}",
                              {"out_re": ((m, d), f32),
                               "out_im": ((m, d), f32)}, run))
    elif name == "complex_project":
        n = 9  # two row groups; float2 pairs at the even d, floats at the odd
        for d in (5002, 5003):
            r_re, r_im, f = rnd(n, d), rnd(n, d), rnd(d)
            outs = {"e_re": ((n,), f32), "e_im": ((n,), f32)}
            if cuda:
                chunks = coded.project_chunks(n, d)
                outs.update(part_re=((n, chunks), f32),
                            part_im=((n, chunks), f32))

            def run(o, r_re=r_re, r_im=r_im, f=f):
                if cuda:
                    coded.complex_project_launch(r_re, r_im, f, o["part_re"],
                                                 o["part_im"], o["e_re"],
                                                 o["e_im"])
                else:
                    re, im = coded.complex_project_plain(r_re, r_im, f)
                    _put(o, e_re=re, e_im=im)
            cases.append(Case(f"n={n} d={d}", outs, run))
    elif name == "complex_recombine":
        n, d = 9, 1003
        v_re, v_im, r_re, r_im = rnd(n), rnd(n), rnd(n, d), rnd(n, d)

        def run(o):
            if cuda:
                coded.complex_recombine_launch(v_re, v_im, r_re, r_im,
                                               o["out"])
            else:
                _put(o, out=coded.complex_recombine_plain(v_re, v_im, r_re,
                                                          r_im))
        cases.append(Case(f"n={n} d={d}", {"out": ((d,), f32)}, run))
    elif name == "cyclic_locator":
        for n, s, L, per_column in LOCATOR_CASES:
            cases.append(_locator_case(n, s, L, dev, cuda, rnd, per_column))
    elif name in ("cyclic_narrow_recombine", "approx_decode"):
        cases += _narrow_cases(name, dev, cuda, rnd)
        if name == "approx_decode":
            cases += _approx_offset_cases(dev, cuda, rnd)
    elif name.endswith("_segments"):
        cases += _segment_cases(name, dev, cuda, rnd)
    elif name in ("random_inject", "round_draw", "synthetic_text",
                  "augment_draws", "dropout_keep", "vote_salts"):
        cases += _draw_cases(name, dev, cuda, rnd)
    elif name == "row_fingerprints":
        cases += _vote_cases(dev, cuda, rnd)
    elif name in ("stage_stats", "nonfinite_rows"):
        cases += _numerics_cases(name, dev, cuda, rnd)
    elif name.startswith("flash_"):
        G, T = 2, 70  # ragged against the 64- and 32-row tiles
        for dh in (16, 24, 64, 100):  # instances 16, 32, 64, 128
            q, k, v, do = rnd(G, T, dh), rnd(G, T, dh), rnd(G, T, dh), \
                rnd(G, T, dh)
            o_p, lse = fa.flash_fwd_plain(q, k, v)
            dcap = (do * o_p).sum(-1)
            dlse = rnd(G, T)
            if name == "flash_fwd":
                outs = {"o": ((G, T, dh), f32), "lse": ((G, T), f32)}

                def run(o, q=q, k=k, v=v):
                    if cuda:
                        fa.flash_fwd_launch(q, k, v, o["o"], o["lse"])
                    else:
                        ro, rl = fa.flash_fwd_plain(q, k, v)
                        _put(o, o=ro, lse=rl)
            elif name == "flash_dq":
                outs = {"dq": ((G, T, dh), f32)}

                def run(o, a=(q, k, v, do, lse, dcap, dlse)):
                    if cuda:
                        fa.flash_dq_launch(*a, o["dq"])
                    else:
                        _put(o, dq=fa.flash_dq_plain(*a))
            else:
                outs = {"dk": ((G, T, dh), f32), "dv": ((G, T, dh), f32)}

                def run(o, a=(q, k, v, do, lse, dcap, dlse)):
                    if cuda:
                        fa.flash_dkv_launch(*a, o["dk"], o["dv"])
                    else:
                        dk, dv = fa.flash_dkv_plain(*a)
                        _put(o, dk=dk, dv=dv)
            cases.append(Case(f"G={G} T={T} Dh={dh}, dlse", outs, run))
    elif name == "control_mistiled_copy":
        x = rnd(*controls.SHAPE)

        def run(o):
            if cuda:
                err = _build.library("controls").draco_control_mistiled_copy(
                    x.data_ptr(), o["o"].data_ptr(), controls.SHAPE[0],
                    controls.SHAPE[1], _stream())
                _build.check(err, "control_mistiled_copy")
            else:
                controls.control_mistiled_copy_plain(x, out=o["o"])
        cases.append(Case("(16, 48), tile (4, 12), grid 4",
                          {"o": (controls.SHAPE, f32)}, run))
    elif name == "control_spill":
        n = 1003
        x = torch.randint(-8, 8, (n,), generator=g, device=dev).to(f32)
        idx = torch.randint(0, 1 << 20, (n,), generator=g,
                            device=dev).to(torch.int32)

        def run(o):
            if cuda:
                err = _build.library("controls").draco_control_spill(
                    x.data_ptr(), idx.data_ptr(), o["o"].data_ptr(), n,
                    _stream())
                _build.check(err, "control_spill")
            else:
                _put(o, o=controls.control_spill_plain(x, idx))
        cases.append(Case(f"n={n}", {"o": ((n,), f32)}, run))
    return cases


# the locator's coverage, one case an instance (ops/decode_kernels
# .LOCATOR_ROUTES): (n, s, L) with L ragged against the block's columns
# (4 warps; 2 at n > 32); the two-rows-a-lane instance at n = 40
# (n, s, L, presence a row a column): the last, the tree topology's groups
LOCATOR_CASES = ((8, 1, 3, False), (9, 2, 5, False), (32, 3, 5, False),
                 (40, 3, 3, False), (8, 1, 3, True))


def _locator_case(n: int, s: int, L: int, dev, cuda: bool, rnd,
                  per_column: bool = False) -> Case:
    """The locator at (n, s) on L random columns with row 6 absent; with
    ``per_column`` a presence row a column, column c's absent row c."""
    from draco_tpu_torch.coding import cyclic
    from draco_tpu_torch.ops import decode_kernels

    code = cyclic.build_cyclic_code(n, s)
    e_re, e_im = rnd(L, n), rnd(L, n)
    pres = torch.ones((L if per_column else 1, n), device=dev)
    if per_column:
        pres[torch.arange(L), torch.arange(L)] = 0.0
    else:
        pres[0, 6] = 0.0
    f32, b = torch.float32, torch.uint8

    def run(o):
        if cuda:
            decode_kernels.cyclic_locator_launch(
                code, e_re, e_im, pres, cyclic.HEALTH_REL_TOL, 0.0,
                o["v_re"], o["v_im"], o["honest"], o["flagged"], o["loud"],
                o["resid"])
        else:
            t = code.tensors(dev)
            r = cyclic.locator_core(
                e_re, e_im, t["c2h_re"], t["c2h_im"], t["c1_re"],
                t["c1_im"], t["est_re"], t["est_im"], pres, code.s)
            _put(o, v_re=r[0], v_im=r[1], honest=r[2], flagged=r[3],
                 loud=r[4], resid=r[5])
    absent = ("column c's row c absent (a presence row a column)"
              if per_column else "row 6 absent")
    return Case(f"L={L} n={n} s={s} ({decode_kernels.locator_instance(n, s)}"
                f"), {absent}",
                {"v_re": ((L, n), f32), "v_im": ((L, n), f32),
                 "honest": ((L, n), b), "flagged": ((L, n), b),
                 "loud": ((L, n), b), "resid": ((L,), f32)}, run)


# the encode's coverage: two row groups of W (m = 9) and of G (n = 64), a
# ragged last window; float4 columns (d = 1024: every row on a 128-byte
# line), float2 stored a line at a time (d = 1002 ≡ 2 mod 8: row i starts
# 40·i mod 128 bytes past a line; d = 1004; d = 1024 with G starting 8
# bytes into its storage) and single floats (d = 1003); the guarded
# outputs start 128-byte aligned at 256 elements past their poison
ENCODE_CASES = ((9, 7, 1003, 0), (9, 7, 1002, 0), (9, 7, 1004, 0),
                (9, 7, 1024, 0), (9, 7, 1024, 8), (5, 64, 1002, 0))


# the narrow decode's coverage: n = 9 (two groups of 8 rows), d = 1003 and
# 1002 (≡ 10 mod 16, as the main path's d), each wire at block 64, int8 at
# a block the strip does not divide (24) and at block 1; and int8 / bf16
# buffers that start off a 16-byte chunk (at byte 3 / 2 of their storage),
# so the first strip takes the scalar loop
NARROW_WIRES = (("f32", 64, 0), ("bf16", 64, 0), ("int8", 64, 0),
                ("int8", 24, 0), ("int8", 1, 0), ("int8", 24, 3),
                ("bf16", 64, 2))


def offset_copy(t: torch.Tensor, offset: int) -> torch.Tensor:
    """A copy of ``t`` that starts ``offset`` bytes into its storage (a
    multiple of its element size); ``t`` itself at 0."""
    if not offset:
        return t
    size = t.element_size()
    store = torch.empty(t.numel() + offset // size + 1, dtype=t.dtype,
                        device=t.device)
    out = store[offset // size:offset // size + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def _narrow_cases(name: str, dev, cuda: bool, rnd) -> list:
    from draco_tpu_torch.obs import numerics
    from draco_tpu_torch.ops import coded, decode_kernels

    f32 = torch.float32
    n = 9
    cases = []
    for d in (1003, 1002):
        a, b = rnd(n, d), rnd(n, d)
        vr, vi = rnd(n), rnd(n)
        pres = torch.ones(n, device=dev)
        pres[[2, 5]] = 0.0
        for mode, block, offset in NARROW_WIRES:
            blk, nb = (block, -(-d // block)) if mode == "int8" else (1, 0)
            where = f" at byte {offset}" if offset else ""
            if name == "cyclic_narrow_recombine":
                bufs = [{"q": x} if mode == "f32"
                        else numerics.narrow_wire_rows(x, mode, block)
                        for x in (a, b)]
                for buf in bufs:
                    buf["q"] = offset_copy(buf["q"], offset)

                def run(o, mode=mode, bufs=bufs, block=block, blk=blk,
                        nb=nb, vr=vr, vi=vi):
                    if cuda:
                        decode_kernels.narrow_recombine_launch(
                            vr, vi, mode, bufs[0]["q"], bufs[0].get("scale"),
                            bufs[1]["q"], bufs[1].get("scale"), blk, nb,
                            o["out"])
                    elif mode == "f32":
                        _put(o, out=coded.complex_recombine_plain(
                            vr, vi, bufs[0]["q"], bufs[1]["q"]))
                    else:
                        _put(o, out=decode_kernels
                             .cyclic_narrow_recombine_plain(
                                 vr, vi, (mode, bufs[0], bufs[1], block)))
                cases.append(Case(f"{mode} n={n} d={d} block {block}{where}",
                                  {"out": ((d,), f32)}, run))
                continue
            rows = a.clone()
            rows[2] = float("nan")  # an absent row's payload never read
            vn = vr / n
            buf = ({"q": rows} if mode == "f32"
                   else numerics.narrow_wire_rows(rows, mode, block))
            buf["q"] = offset_copy(buf["q"], offset)
            wire = None if mode == "f32" else (mode, buf, block)
            outs = {"decoded": ((d,), f32), "sums": ((2,), f32)}
            if cuda:
                outs["part"] = ((2, decode_kernels.approx_decode_chunks(d)),
                                f32)

            def run(o, mode=mode, buf=buf, wire=wire, blk=blk, nb=nb, vn=vn,
                    b=b, pres=pres):
                if cuda:
                    decode_kernels.approx_decode_launch(
                        mode, buf["q"], buf.get("scale"), blk, nb, b, vn,
                        pres, o["decoded"], o["part"], o["sums"])
                else:
                    dec, sd, sg = decode_kernels.approx_decode_plain(
                        buf["q"] if wire is None else None, b, vn, pres, wire)
                    _put(o, decoded=dec, sums=torch.stack([sd, sg]))
            cases.append(Case(f"{mode} n={n} d={d} block {block}{where}, "
                              f"rows 2, 5 absent", outs, run))
    return cases


# the approx decode's offset entry: views [a, b) of an (n, 1003) buffer
# that start on and off a 4-column strip and a 16-byte chunk, the last one
# ending the buffer, each wire, int8 at blocks 64 and 24, and a buffer
# that starts 3 bytes into its storage
APPROX_VIEWS = ((0, 10), (3, 700), (8, 1003), (517, 1003))
OFFSET_WIRES = (("f32", 1, 0), ("bf16", 64, 0), ("int8", 64, 0),
                ("int8", 24, 0), ("int8", 64, 3))


def _approx_offset_cases(dev, cuda: bool, rnd) -> list:
    from draco_tpu_torch.obs import numerics
    from draco_tpu_torch.ops import decode_kernels

    f32 = torch.float32
    n, d = 9, 1003
    rows, bg, vn = rnd(n, d), rnd(n, d), rnd(n) / n
    rows[2] = float("nan")  # an absent row's payload never read
    pres = torch.ones(n, device=dev)
    pres[[2, 5]] = 0.0
    cases = []
    for mode, block, offset in OFFSET_WIRES:
        buf = ({"q": rows} if mode == "f32"
               else numerics.narrow_wire_rows(rows, mode, block))
        buf["q"] = offset_copy(buf["q"], offset)
        wire = None if mode == "f32" else (mode, buf, block)
        blk, nb = (block, -(-d // block)) if mode == "int8" else (1, 0)
        for a, b in APPROX_VIEWS:
            outs = {"decoded": ((b - a,), f32), "sums": ((2,), f32)}
            if cuda:
                outs["part"] = ((2, decode_kernels.approx_decode_chunks(
                    b - a)), f32)

            def run(o, mode=mode, buf=buf, wire=wire, blk=blk, nb=nb, a=a,
                    b=b):
                if cuda:
                    decode_kernels.approx_decode_launch(
                        mode, buf["q"], buf.get("scale"), blk, nb, bg, vn,
                        pres, o["decoded"], o["part"], o["sums"], a, b)
                else:
                    out = torch.empty(d, device=dev)
                    dec, sd, sg = decode_kernels.approx_decode_segment(
                        buf["q"] if wire is None else None, bg, vn, pres, a,
                        b, wire, out)
                    _put(o, decoded=dec, sums=torch.stack([sd, sg]))
            where = f" at byte {offset}" if offset else ""
            cases.append(Case(f"{mode} block {block}{where} n={n} view "
                              f"[{a}, {b}) of d={d}, rows 2, 5 absent",
                              outs, run))
    return cases


# the segment kernels' coverage: n = 9 (two row groups), d = 5003, cuts
# with segments of 1 and 9 columns, a segment of one tile and one column
# more, cuts off every 16-byte chunk and int8 block (two in one 16-column
# strip at 2059, 2060; three at 5, 9, 12 and two at 41, 47), and one
# segment; the narrow wires at blocks the strip divides and does not,
# int8 and bf16 buffers starting 3 / 2 bytes into their storage
SEGMENT_CUTS = ((0, 1, 10, 2059, 2060, 4100, 5003), (0, 5003),
                (0, 5, 9, 12, 40, 41, 47, 5003))
SEGMENT_WIRES = (("bf16", 256, 0), ("int8", 256, 0), ("int8", 24, 0),
                 ("int8", 1, 0), ("int8", 256, 3), ("bf16", 64, 2))


def _segment_cases(name: str, dev, cuda: bool, rnd) -> list:
    from draco_tpu_torch.obs import numerics
    from draco_tpu_torch.ops import coded, decode_kernels

    f32 = torch.float32
    n, d = 9, 5003
    r_re, r_im, f = rnd(n, d), rnd(n, d), rnd(d)
    cases = []
    for cuts in SEGMENT_CUTS:
        plan = coded.segment_plan(cuts, dev)
        S = plan.segments
        v_re, v_im = rnd(S, n), rnd(S, n)
        label = f"n={n} d={d}, {S} segments"
        if name == "complex_project_segments":
            outs = {"e_re": ((S, n), f32), "e_im": ((S, n), f32)}
            if cuda:
                outs.update(part_re=((n, plan.tiles), f32),
                            part_im=((n, plan.tiles), f32))

            def run(o, plan=plan):
                if cuda:
                    coded.complex_project_segments_launch(
                        r_re, r_im, f, plan, o["part_re"], o["part_im"],
                        o["e_re"], o["e_im"])
                else:
                    re, im = coded.complex_project_segments_plain(
                        r_re, r_im, f, plan)
                    _put(o, e_re=re, e_im=im)
            cases.append(Case(label, outs, run))
        elif name == "complex_recombine_segments":
            def run(o, plan=plan, v_re=v_re, v_im=v_im):
                if cuda:
                    coded.complex_recombine_segments_launch(
                        v_re, v_im, r_re, r_im, plan, o["out"])
                else:
                    _put(o, out=coded.complex_recombine_segments_plain(
                        v_re, v_im, r_re, r_im, plan))
            cases.append(Case(label, {"out": ((d,), f32)}, run))
        else:
            for mode, block, offset in SEGMENT_WIRES:
                bufs = [numerics.narrow_wire_rows(x, mode, block)
                        for x in (r_re, r_im)]
                for buf in bufs:
                    buf["q"] = offset_copy(buf["q"], offset)
                wire = (mode, *bufs, block)
                blk, nb = (block, -(-d // block)) if mode == "int8" else \
                    (1, 0)

                def run(o, plan=plan, v_re=v_re, v_im=v_im, wire=wire,
                        mode=mode, blk=blk, nb=nb):
                    if cuda:
                        decode_kernels.narrow_recombine_segments_launch(
                            v_re, v_im, mode, wire[1]["q"],
                            wire[1].get("scale"), wire[2]["q"],
                            wire[2].get("scale"), blk, nb, plan, o["out"])
                    else:
                        _put(o, out=decode_kernels
                             .cyclic_narrow_recombine_segments_plain(
                                 v_re, v_im, wire, plan))
                where = f" at byte {offset}" if offset else ""
                cases.append(Case(f"{mode} block {block}{where} {label}",
                                  {"out": ((d,), f32)}, run))
    return cases


# the fingerprints' coverage: n = 9 rows of d = 1003 and 1002, f32 and
# bf16, and buffers that start 4 / 2 bytes into their storage, so every
# row's head and tail take the scalar loop
VOTE_CASES = (("f32", 0), ("bf16", 0), ("f32", 4), ("bf16", 2))


def _vote_cases(dev, cuda: bool, rnd) -> list:
    from draco_tpu_torch.ops import vote

    n = 9
    salts = vote.salts_tensor((0x1234567, 0x89ABCDEF), dev)
    cases = []
    for d in (1003, 1002):
        for dtype, offset in VOTE_CASES:
            rows = rnd(n, d).to({"f32": torch.float32,
                                 "bf16": torch.bfloat16}[dtype])
            rows = offset_copy(rows, offset)
            where = f" at byte {offset}" if offset else ""

            def run(o, rows=rows):
                if cuda:
                    vote.row_fingerprints_launch(rows, salts, o["out"])
                else:
                    _put(o, out=vote.as_int32_bits(
                        vote.row_fingerprints(rows, salts)))
            cases.append(Case(f"{dtype} n={n} d={d}{where}",
                              {"out": ((n, 2), torch.int32)}, run))
    return cases


# the observatory's coverage: stage_stats's 12 columns over one and two
# parts of (3, 1003) at blocks 7 and 5000 (a warp and a CTA a block);
# nonfinite_rows at n = 9 rows of 1003 and 1002 (a NaN in row 4)
def _numerics_cases(name: str, dev, cuda: bool, rnd) -> list:
    from draco_tpu_torch.ops import numerics as ops_numerics

    cases = []
    if name == "stage_stats":
        for parts, block in ((1, 7), (2, 7), (1, 5000), (2, 5000)):
            xs = [rnd(3, 1003) for _ in range(parts)]

            def run(o, xs=xs, block=block):
                if cuda:
                    ops_numerics.stage_stats_launch(xs, block, o["out"])
                else:
                    _put(o, out=ops_numerics.stage_stats_plain(xs, block))
            cases.append(Case(f"parts={parts} (3, 1003) block={block}",
                              {"out": ((12,), torch.float32)}, run))
        return cases
    for d in (1003, 1002):
        x = rnd(9, d)
        x[4, d // 2] = float("nan")

        def run(o, x=x):
            if cuda:
                ops_numerics.nonfinite_rows_launch(x, o["out"])
            else:
                _put(o, out=ops_numerics.nonfinite_rows_plain(x)
                     .to(torch.uint8))
        cases.append(Case(f"n=9 d={d}", {"out": ((9,), torch.uint8)}, run))
    return cases


# the draws' coverage: random_inject on every row of n = 9, d = 1003 (the
# plain form over poison; the pair, which adds in place, over zeros, every
# element still 0 after it poisoned again: a draw is never 0, since the
# uniform it maps onto (lo, 1) never lands on 0), round_draw at d = 1003
# and 1002, one and two parts, synthetic_text at n·B = 6 sequences of
# T = 37; augment_draws at 5 rows of 3 samples and 6 rows in groups of 3;
# dropout_keep at 3 rows of 2 layers of (2, 37) units and one layer at 4
# rows in groups of 2; vote_salts
def _draw_cases(name: str, dev, cuda: bool, rnd) -> list:
    from draco_tpu_torch.ops import draws

    step = torch.tensor(5, dtype=torch.int32, device=dev)
    cases, f32 = [], torch.float32
    if name == "random_inject":
        n, d = 9, 1003
        mask = torch.ones(n, dtype=torch.bool, device=dev)
        for pair in (True, False):
            def run(o, pair=pair):
                im = o["im"] if pair else None
                if pair:
                    o["re"].zero_()
                    im.zero_()
                if cuda:
                    draws.random_inject_launch(o["re"], mask, step, 435,
                                               -100.0, im)
                else:
                    draws.random_inject_plain(o["re"], mask, step, 435,
                                              -100.0, im)
                for t in (o["re"], im) if pair else ():
                    bits = t.view(torch.int32)
                    bits.copy_(torch.where(t == 0, torch.full_like(
                        bits, POISON_F32), bits))
            outs = {"re": ((n, d), f32)}
            if pair:
                outs["im"] = ((n, d), f32)
            cases.append(Case(f"{'pair' if pair else 'plain'} n={n} d={d}",
                              outs, run))
    elif name == "round_draw":
        for d in (1003, 1002):
            for parts, mode in ((1, "bf16"), (2, "int8")):
                def run(o, d=d, parts=parts, mode=mode):
                    if cuda:
                        draws.round_draw_launch(step, 445, mode, o["out"])
                    else:
                        r = draws.round_draw_plain(step, 445, d, mode, parts)
                        _put(o, out=r.view(torch.int32))
                cases.append(Case(f"{mode} parts={parts} d={d}",
                                  {"out": ((parts, d), torch.int32)}, run))
    elif name == "augment_draws":
        for rows, div, b in ((5, 1, 3), (6, 3, 3)):
            def run(o, rows=rows, div=div, b=b):
                if cuda:
                    draws.augment_draws_launch(step, 430, div, o["out"])
                else:
                    _put(o, out=draws.augment_draws_plain(step, 430, rows, b,
                                                          div))
            cases.append(Case(f"rows={rows} div={div} B={b}",
                              {"out": ((3, rows, b), torch.int32)}, run))
    elif name == "dropout_keep":
        for rows, count, div in ((3, 2, 1), (4, 1, 2)):
            def run(o, rows=rows, count=count, div=div):
                if cuda:
                    draws.dropout_keep_launch(step, 431, div, o["out"])
                else:
                    _put(o, out=draws.dropout_keep_plain(
                        step, 431, rows, count, 2, 37, div).to(torch.uint8))
            cases.append(Case(f"rows={rows} layers={count} div={div} 2x37",
                              {"out": ((rows, count, 2, 37), torch.uint8)},
                              run))
    elif name == "vote_salts":
        def run(o):
            if cuda:
                draws.vote_salts_launch(step, 432, o["out"])
            else:
                _put(o, out=draws.vote_salts_plain(step, 432))
        cases.append(Case("(2,)", {"out": ((2,), torch.int32)}, run))
    else:
        n, b, t, vocab = 3, 2, 37, 8192

        def run(o):
            if cuda:
                draws.synthetic_text_launch(step, 428, vocab, o["out"])
            else:
                _put(o, out=draws.synthetic_text_plain(step, 428, n, b, t,
                                                       vocab))
        cases.append(Case(f"n={n} B={b} T={t}",
                          {"out": ((n, b, t), torch.int32)}, run))
    return cases


def rule_coverage(s: KernelSpec, dev) -> dict:
    if s.name == "control_overlaunch":
        return {"ok": True, "skipped": True,
                "reason": "the launch is refused (launch_limits): it writes "
                          "nothing"}
    cases = []
    unwritten = touched = 0
    for case in _cases(s.name, dev):
        bufs, outs = {}, {}
        for k, (shape, dtype) in case.outputs.items():
            bufs[k], outs[k] = _guarded(shape, dtype, dev)
        case.run(outs)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        per = {}
        for k, buf in bufs.items():
            u, t = _verdict(buf, math.prod(case.outputs[k][0]))
            per[k] = {"elements": math.prod(case.outputs[k][0]),
                      "unwritten": u, "guard_touched": t}
            unwritten += u
            touched += t
        cases.append({"case": case.label, "outputs": per})
    res = {"unwritten": unwritten, "guard_touched": touched, "cases": cases}
    if unwritten or touched:
        return {"ok": False, **res,
                "error": f"{unwritten} output elements never written, "
                         f"{touched} guard elements touched"}
    return {"ok": True, **res}


def mistiled_matches_plain(dev) -> dict:
    """The mis-tiled control through its wrapper against its plain version,
    bit for bit (NaN positions included)."""
    from draco_tpu_torch.ops import controls

    x = torch.randn(controls.SHAPE, generator=torch.Generator().manual_seed(5))
    k = controls.control_mistiled_copy(x.to(dev)).cpu()
    p = controls.control_mistiled_copy_plain(x)
    return {"bitwise_equal": torch.equal(k.view(torch.int32),
                                         p.view(torch.int32)),
            "nan": int(k.isnan().sum()),
            "copied_region_equal": torch.equal(k[:, :controls.TILE[1]],
                                               x[:, :controls.TILE[1]])}


# --------------------------------------------------------------------------
# resources and launch limits: the libraries as built
# --------------------------------------------------------------------------

def device_limits(dev) -> dict:
    """The card's launch limits (CUDA's device attributes, as torch reads
    them); a block's threads are capped by each function's own
    ``maxThreadsPerBlock`` from the query."""
    p = torch.cuda.get_device_properties(dev)
    return {"smem_block": p.shared_memory_per_block,
            "smem_block_optin": p.shared_memory_per_block_optin,
            "regs_sm": p.regs_per_multiprocessor,
            "smem_sm": p.shared_memory_per_multiprocessor,
            "sms": p.multi_processor_count}


def query(source: str, a: int = 0, b: int = 0) -> dict:
    """Every function of one library's audit table: name -> resources at
    the launcher's (a, b)."""
    lib = _build.library(source)
    keys = ("registers", "local_bytes", "static_smem", "const_bytes",
            "max_threads", "threads", "dynamic_smem", "opt_in",
            "resident_blocks", "binary_version")
    out = {}
    for i in range(lib.draco_audit_count()):
        vals = (ctypes.c_longlong * _OUT_LEN)()
        _build.check(lib.draco_audit_kernel(i, a, b, vals),
                     f"draco_audit_kernel {source}[{i}]")
        out[lib.draco_audit_name(i).decode()] = dict(zip(keys, vals))
    return out


def rule_resources(s: KernelSpec, funcs: dict) -> dict:
    rows, bad = [], []
    for fn in s.functions:
        r = funcs[fn]
        rows.append({"function": fn, **r})
        if r["registers"] > s.max_registers:
            bad.append(f"{fn}: {r['registers']} registers > "
                       f"{s.max_registers}")
        allowed = (s.local_bytes or {}).get(fn, 0)
        if r["local_bytes"] > allowed:
            bad.append(f"{fn}: {r['local_bytes']} local bytes a thread > "
                       f"{allowed}")
        if r["threads"] <= r["max_threads"] and r["resident_blocks"] < 1:
            bad.append(f"{fn}: no block fits on a SM")
    res = {"functions": rows, "max_registers": s.max_registers,
           "local_bytes_allowed": s.local_bytes or {}}
    if s.local_reason:
        res["local_reason"] = s.local_reason
    if bad:
        return {"ok": False, **res, "error": "; ".join(bad)}
    return {"ok": True, **res}


def _launch_largest(s: KernelSpec, dev) -> None:
    """Launch ``s`` for real at its largest configuration (small d)."""
    from draco_tpu_torch.coding import cyclic
    from draco_tpu_torch.obs import numerics
    from draco_tpu_torch.ops import coded, decode_kernels

    n, d = MAX_N, 300
    g = torch.Generator(device=dev).manual_seed(3)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    if s.name == "complex_matmul":
        coded.complex_matmul_launch(rnd(n, n), rnd(n, n), rnd(n, d),
                                    empty(n, d), empty(n, d))
    elif s.name == "complex_recombine":
        coded.complex_recombine_launch(rnd(n), rnd(n), rnd(n, d), rnd(n, d),
                                       empty(d))
    elif s.name == "cyclic_locator":
        code = cyclic.build_cyclic_code(n, MAX_S)
        b = torch.bool
        decode_kernels.cyclic_locator_launch(
            code, rnd(1, n), rnd(1, n), torch.ones((1, n), device=dev),
            cyclic.HEALTH_REL_TOL, 0.0, empty(1, n), empty(1, n),
            empty(1, n, dtype=b), empty(1, n, dtype=b), empty(1, n, dtype=b),
            empty(1))
    elif s.name == "cyclic_narrow_recombine":
        q = [numerics.narrow_wire_rows(rnd(n, d), "int8", 64)
             for _ in range(2)]
        decode_kernels.narrow_recombine_launch(
            rnd(n), rnd(n), "int8", q[0]["q"], q[0]["scale"], q[1]["q"],
            q[1]["scale"], 64, -(-d // 64), empty(d))
    elif s.name == "complex_recombine_segments":
        plan = coded.segment_plan((0, 7, d), dev)
        coded.complex_recombine_segments_launch(
            rnd(2, n), rnd(2, n), rnd(n, d), rnd(n, d), plan, empty(d))
    elif s.name == "cyclic_narrow_recombine_segments":
        plan = coded.segment_plan((0, 7, d), dev)
        q = [numerics.narrow_wire_rows(rnd(n, d), "int8", 64)
             for _ in range(2)]
        decode_kernels.narrow_recombine_segments_launch(
            rnd(2, n), rnd(2, n), "int8", q[0]["q"], q[0]["scale"],
            q[1]["q"], q[1]["scale"], 64, -(-d // 64), plan, empty(d))
    elif s.name == "row_fingerprints":
        from draco_tpu_torch.ops import vote

        vote.row_fingerprints_launch(
            rnd(n, d), vote.public_salts(dev),
            empty(n, 2, dtype=torch.int32))
    elif s.name == "random_inject":
        from draco_tpu_torch.ops import draws

        draws.random_inject_launch(
            rnd(n, d), torch.ones(n, dtype=torch.bool, device=dev),
            torch.ones((), dtype=torch.int32, device=dev), 435, -100.0,
            rnd(n, d))
    elif s.name == "nonfinite_rows":
        from draco_tpu_torch.ops import numerics as ops_numerics

        ops_numerics.nonfinite_rows_launch(rnd(n, d),
                                           empty(n, dtype=torch.bool))
    elif s.name == "approx_decode":
        chunks = decode_kernels.approx_decode_chunks(d)
        decode_kernels.approx_decode_launch(
            "f32", rnd(n, d), None, 1, 0, rnd(n, d), rnd(n),
            torch.ones(n, device=dev), empty(d), empty(2, chunks), empty(2))
    torch.cuda.synchronize(dev)


def rule_launch_limits(s: KernelSpec, funcs_largest: dict, limits: dict,
                       dev) -> dict:
    from draco_tpu_torch.ops import controls

    bad, rows = [], []
    for fn in s.functions:
        r = funcs_largest[fn]
        cap = limits["smem_block_optin"] if r["opt_in"] else \
            limits["smem_block"]
        smem = r["static_smem"] + r["dynamic_smem"]
        rows.append({"function": fn, "threads": r["threads"],
                     "static_smem": r["static_smem"],
                     "dynamic_smem_largest": r["dynamic_smem"],
                     "smem_limit": cap})
        if r["threads"] > r["max_threads"]:
            bad.append(f"{fn}: {r['threads']} threads a block > "
                       f"{r['max_threads']}")
        if smem > cap:
            bad.append(f"{fn}: {smem} shared bytes > {cap}")
    res = {"functions": rows, "largest": s.largest}
    if s.name == "control_overlaunch":
        try:
            controls.control_overlaunch(torch.empty(4096, device=dev))
            bad.append("the over-launch was accepted")
        except _build.CudaError as e:
            res["error_code"] = e.code
            bad.append(f"the launch was refused: CUDA error {e.code}")
            if e.code != INVALID_CONFIGURATION:
                res["wrong_error"] = (f"expected CUDA error "
                                      f"{INVALID_CONFIGURATION} "
                                      f"(cudaErrorInvalidConfiguration)")
    elif s.largest:
        try:
            _launch_largest(s, dev)
            res["launched_largest"] = True
        except _build.CudaError as e:
            bad.append(f"the launch at {s.largest} failed: CUDA error "
                       f"{e.code}")
    if bad:
        return {"ok": False, **res, "error": "; ".join(bad)}
    return {"ok": True, **res}


# --------------------------------------------------------------------------
# compute-sanitizer
# --------------------------------------------------------------------------

CHILD_DONE = "sanitizer child: done"
CHILD_OK = "sanitizer child: ok "  # + the entry point, after its launches
_REFUSED = re.compile(r"=+ Error: (Device not supported[^\n]*)")


def _tool(name: str) -> tuple:
    path = shutil.which(name) or os.path.join(CUDA_HOME, name)
    return (path if os.path.exists(path) else None), path


def _child(names) -> None:
    """The coverage launches of ``names`` on the card (under the
    sanitizer), each entry point reported once its launches have
    finished."""
    dev = torch.device("cuda")
    for name in names:
        for case in _cases(name, dev):
            outs = {k: _guarded(shape, dtype, dev)[1]
                    for k, (shape, dtype) in case.outputs.items()}
            case.run(outs)
            torch.cuda.synchronize(dev)
        print(CHILD_OK + name, flush=True)
    print(CHILD_DONE, flush=True)


def parse_sanitizer(run, text: str, returncode, path: str,
                    timed_out: bool = False) -> dict:
    """One tool's verdict over the child's run of the entry points
    ``run``, from its output ``text``. ``ran`` is false only when the tool
    refused the device; otherwise ``failed`` lists the entry points whose
    functions an error names (all of ``run`` when errors name none) and,
    when the child died or timed out under the tool, those it never
    reported done."""
    refused = _REFUSED.search(text)
    if refused:
        return {"ran": False, "path": path, "kernels": run,
                "returncode": returncode,
                "reason": refused.group(1).strip()}
    counts = [int(c) for c in re.findall(r"ERROR SUMMARY: (\d+) error",
                                         text)]
    counts += [int(c) for c in re.findall(
        r"hazards? displayed \((\d+) errors?", text)]
    errors = max(counts) if counts else None
    finished = CHILD_DONE in text and errors is not None and not timed_out
    res = {"ran": True, "path": path, "kernels": run, "errors": errors,
           "completed": finished, "returncode": returncode}
    hz = re.search(r"(\d+) hazards? displayed \((\d+) errors?, (\d+) "
                   r"warnings?\)", text)
    if hz:
        res["hazards"] = int(hz.group(1))
        res["warnings"] = int(hz.group(3))
    failed = set()
    if errors:
        named = {n for n in run for fn in spec(n).functions
                 if fn.split("<")[0] in text}
        failed |= named or set(run)
    if not finished:
        done = set(re.findall(re.escape(CHILD_OK) + r"(\S+)", text))
        failed |= {n for n in run if n not in done}
        res["reason"] = ("timed out under the tool" if timed_out else
                         "the child did not finish under the tool")
    res["failed"] = [n for n in run if n in failed]
    if failed:
        res["head"] = "\n".join(line for line in text.splitlines()
                                 if line.startswith("========="))[:3000]
        res["tail"] = text[-600:]
    return res


def run_sanitizer(names, timeout: int = 300) -> dict:
    """Each tool once over the coverage launches of ``names`` (racecheck
    over those with shared memory): tool -> :func:`parse_sanitizer`'s
    verdict."""
    path, looked = _tool("compute-sanitizer")
    if path is None:
        return {t: {"ran": False, "looked_at": looked,
                    "reason": "compute-sanitizer not found"}
                for t in ("memcheck", "racecheck")}
    out = {}
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1")
    for tool in ("memcheck", "racecheck"):
        run = [n for n in names if tool == "memcheck" or spec(n).racecheck]
        cmd = [path, "--tool", tool, sys.executable, "-m",
               "draco_tpu_torch.analysis.kernel_audit", "--sanitizer-child",
               "--kernels", ",".join(run)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=timeout, env=env,
                                  cwd=str(_build.PKG_DIR.parent))
            out[tool] = parse_sanitizer(run, proc.stdout + proc.stderr,
                                        proc.returncode, path)
        except subprocess.TimeoutExpired as e:
            text = "".join(x.decode(errors="replace")
                           if isinstance(x, bytes) else (x or "")
                           for x in (e.stdout, e.stderr))
            out[tool] = parse_sanitizer(run, text, None, path,
                                        timed_out=True)
        if not out[tool]["ran"]:
            # the device is refused to every tool: do not start the other
            other = "racecheck" if tool == "memcheck" else "memcheck"
            out.setdefault(other, {**out[tool], "kernels": [
                n for n in names if other == "memcheck"
                or spec(n).racecheck]})
            break
    return out


def rule_sanitizer(s: KernelSpec, san: dict) -> dict:
    if s.name == "control_overlaunch":
        return {"ok": True, "skipped": True,
                "reason": "the refused launch is launch_limits' finding"}
    res, bad = {}, []
    for tool, r in san.items():
        if tool == "racecheck" and not s.racecheck:
            res[tool] = {"ran": False, "reason": "no shared memory"}
            continue
        if not r.get("ran"):
            res[tool] = {k: v for k, v in r.items() if k != "kernels"}
            continue
        hit = s.name in r["failed"]
        res[tool] = {"ran": True, "errors": r["errors"] if hit else 0,
                     "completed": r["completed"]}
        if hit:
            bad.append(f"{tool}: {r['errors']} errors" + (
                "" if r["completed"] else f", {r['reason']}"))
    if bad:
        return {"ok": False, **res, "error": "; ".join(bad)}
    return {"ok": True, **res}


# --------------------------------------------------------------------------
# the audit
# --------------------------------------------------------------------------

def audit_row(s: KernelSpec, dev, ctx: dict) -> dict:
    rules = {}
    if dev.type == "cuda":
        funcs = query(s.source, *s.shape)
        funcs_largest = query(s.source, *s.largest_shape)
        rules["resources"] = rule_resources(s, funcs)
        rules["launch_limits"] = rule_launch_limits(s, funcs_largest,
                                                    ctx["limits"], dev)
    else:
        for r in ("resources", "launch_limits"):
            rules[r] = {"ok": True, "skipped": True,
                        "reason": "needs the card"}
    rules["coverage"] = rule_coverage(s, dev)
    rules["sanitizer"] = (rule_sanitizer(s, ctx["sanitizer"])
                          if dev.type == "cuda" else
                          {"ok": True, "skipped": True,
                           "reason": "needs the card"})
    failed = [r for r in RULES if not rules[r]["ok"]]
    row = {"source": f"draco_tpu_torch/csrc/{s.source}.cu",
           "replaces": s.replaces,
           "control": bool(s.control), "failed_rules": failed,
           "rules": rules}
    if dev.type == "cuda":
        row["library"] = str(_build.lib_path(s.source))
    if s.main:
        row["main_path_functions"] = list(s.main)
    if s.control and dev.type != "cuda" and s.control != "coverage":
        row["expected_fail"] = s.control
        row["ok"] = True
        row["skipped"] = f"its rule ({s.control}) runs on the card"
    elif s.control:
        row["expected_fail"] = s.control
        row["ok"] = failed == [s.control]
        if s.name == "control_mistiled_copy":
            row["plain"] = mistiled_matches_plain(dev)
            row["ok"] = row["ok"] and row["plain"]["bitwise_equal"]
        if "wrong_error" in rules["launch_limits"]:
            row["ok"] = False
            row["wrong_error"] = rules["launch_limits"]["wrong_error"]
    else:
        row["ok"] = not failed
    if not row["ok"]:
        row["error"] = (f"failed {failed}" + (
            f", expected exactly [{s.control}]" if s.control else "") + ": "
            + "; ".join(rules[r].get("error", "") for r in failed)
            + (f"; {row['wrong_error']}" if "wrong_error" in row else ""))
    return row


def run_audit(device=None, out: str = DEFAULT_OUT, names=None) -> dict:
    from draco_tpu_torch.runtime import resolve_device

    dev = resolve_device(device)
    specs = [s for s in SPECS if names is None or s.name in names]
    ctx, extra = {}, {"device": str(dev)}
    if dev.type == "cuda":
        _build.build_all()
        ctx["limits"] = extra["device_limits"] = device_limits(dev)
        extra["card"] = torch.cuda.get_device_name(dev)
        ctx["sanitizer"] = extra["sanitizer"] = run_sanitizer(
            [s.name for s in specs])
    return run_rows(
        out, "the port's kernels against their manifests: resources and "
        "launch limits from the built libraries, coverage of poisoned and "
        "guarded outputs, compute-sanitizer; control_* rows are seeded "
        "defects whose ok means 'tripped exactly its rule'",
        [(s.name, lambda s=s: audit_row(s, dev, ctx)) for s in specs],
        extra=extra)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--kernels", default="",
                    help="comma-separated entry points (default: all)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--sanitizer-child", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    names = [n for n in args.kernels.split(",") if n] or None
    if args.sanitizer_child:
        _child(names or [s.name for s in SPECS])
        return 0
    report = run_audit(args.device, args.out, names)
    print(json.dumps({"all_ok": report["all_ok"],
                      "rows": len(report["rows"]), "out": args.out}))
    return 0 if report["all_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
