"""Time the narrow-wire decode's read path and the cyclic encode against
their variants on one card: which part of the kernels of
``csrc/narrow_decode.cu`` and ``csrc/coded.cu`` pays.

    python -m draco_tpu_torch.obs.narrow_read_ab [--rounds 5] [--reps 20]
        [--cases encode,segments,narrow,approx] [--encode-d D,...]
        [--out FILE]

Builds ``obs/narrow_read_ab.cu`` (the port's narrow_decode source with the
old one-thread-a-column kernels and two variants beside it, see its
header) and ``obs/encode_ab.cu`` (the port's coded source with the old
encode and the variants below) with nvcc and times, at the main path's
shapes (n = 8, d = 11,173,962, int8 block 256; the approx decode with rows
2 and 5 absent, row 2 a NaN payload; the segmented recombination at the
``shared_int8_seg4`` leg's 4 block-aligned segments; the encode also at
the LM's d = 62,958,336, or at the d's of ``--encode-d``), in ``--rounds``
rounds that take the variants in turn, each timed over ``--reps``
back-to-back launches with CUDA events:

  complex_matmul (encode): old, new (the port's kernel: float4 columns at
      the LM's d, float2 stored a 128-byte line at a time at ResNet-18's),
      lines (the line-stored float2 path at the LM's d), unstaged (float2,
      each thread storing its own columns: the kernel before the line
      staging), loads_aligned / stores_aligned (unstaged, G / the outputs
      at a row stride of d rounded up to 64 floats, the other at d); and
      ``torch.matmul`` of the stacked W on G (the library call, not
      bitwise)
  cyclic_narrow_recombine_segments int8, bf16: old, new (the port's
      kernel: the strip read over the plan); and the whole-d kernel on the
      same buffers (the same bytes, not bitwise: one v pair)
  cyclic_narrow_recombine int8: old, (a) one 32-bit block index and one
      scale a row per 256 columns, (b) the 16-byte strip read alone, new
      (the port's kernel: 16-byte chunks), new at 8-byte chunks; bf16: old,
      new
  approx_decode f32, bf16, int8: old, new

Every variant's output must equal the old kernel's bit for bit (the same
products summed in the same order); the approx decode's two sums, summed
in another order, to 1e-5 relative. Prints one line per kernel and wire
(median ms over the rounds, min–max, the byte bound and the share of it)
and writes the record as JSON to ``--out``. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys

import torch

from draco_tpu_torch import _build
from draco_tpu_torch.obs import numerics
from draco_tpu_torch.coding import cyclic
from draco_tpu_torch.ops import coded, decode_kernels

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
N, D, BLOCK = 8, 11_173_962, 256
LM_D = 62_958_336  # the LM's flat gradient
SEGMENTS = 4  # the shared_int8_seg4 leg's wire segments
CASES = ("encode", "segments", "narrow", "approx")
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
SIGNATURES = {
    "narrow_read_ab": {
        "draco_ab_recombine": [_I] + [_P] * 7 + [_I, _LL, _I, _I, _LL, _P],
        "draco_ab_recombine_cw2": [_P] * 7 + [_I, _LL, _I, _LL, _P],
        "draco_ab_segments_old": [_P] * 7 + [_I, _P, _I, _LL, _I, _I, _LL,
                                             _P],
        "draco_ab_approx_old_chunks": [_LL],
        "draco_ab_approx_old": [_P] * 8 + [_I, _LL, _I, _I, _LL, _I, _F,
                                           _P],
    },
    "encode_ab": {
        "draco_ab_matmul": [_I] + [_P] * 5 + [_I, _I, _LL, _P],
        "draco_ab_matmul_strided": [_P] * 5 + [_I, _I, _LL, _LL, _LL, _P],
    },
}


def build() -> dict:
    """Both A/B libraries, one nvcc each, started together."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SIGNATURES:
        out = _build.BUILD_DIR / f"lib{name}.so"
        src = _build.PKG_DIR / "obs" / f"{name}.cu"
        procs[name] = (out, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)]))
    libs = {}
    for name, (out, proc) in procs.items():
        if proc.wait() != 0:
            raise SystemExit(f"nvcc failed on obs/{name}.cu")
        lib = ctypes.CDLL(str(out))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def time_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def recombine_variants(lib, mode: str, dev) -> tuple:
    """name -> launcher into its own output, the (re, im) wire, and the
    bytes the function must move."""
    g = torch.Generator(device=dev).manual_seed(11)
    v_re = torch.randn(N, generator=g, device=dev)
    v_im = torch.randn(N, generator=g, device=dev)
    bufs = [numerics.narrow_wire_rows(
        torch.randn((N, D), generator=g, device=dev), mode, BLOCK)
        for _ in range(2)]
    code = decode_kernels.WIRE_CODES[mode]
    blk, nb = (BLOCK, -(-D // BLOCK)) if mode == "int8" else (1, 0)
    s_re, s_im = (b.get("scale") for b in bufs)
    ptr = decode_kernels._ptr
    args = (v_re.data_ptr(), v_im.data_ptr(), bufs[0]["q"].data_ptr(),
            bufs[1]["q"].data_ptr(), ptr(s_re), ptr(s_im))

    def variant(k):
        out = torch.empty(D, device=dev)
        return out, lambda: _build.check(lib.draco_ab_recombine(
            k, *args, out.data_ptr(), N, D, code, blk, nb, _stream()), "ab")

    def new():
        out = torch.empty(D, device=dev)
        return out, lambda: decode_kernels.narrow_recombine_launch(
            v_re, v_im, mode, bufs[0]["q"], s_re, bufs[1]["q"], s_im, blk,
            nb, out)

    def cw2():
        out = torch.empty(D, device=dev)
        return out, lambda: _build.check(lib.draco_ab_recombine_cw2(
            *args, out.data_ptr(), N, D, blk, nb, _stream()), "ab cw2")

    runs = {"old": variant(0), "new": new()}
    if mode == "int8":
        runs.update({"a_group_scale": variant(1), "b_strip_read": variant(2),
                     "new_8byte_chunks": cw2()})
    scales = 2 * N * nb * 4
    nbytes = 2 * N * D * (1 if mode == "int8" else 2) + scales + 2 * N * 4 \
        + D * 4
    return runs, nbytes, ()


def encode_variants(lib, d: int, dev) -> tuple:
    """The encode of the shared legs (the code's masked W, 8×8) on random
    batch gradients (8, d): name -> launcher, the bytes, and the names not
    held bit for bit (the library call)."""
    g = torch.Generator(device=dev).manual_seed(13)
    t = cyclic.build_cyclic_code(N, 1).tensors(dev)
    w_re, w_im = t["w_masked_re"], t["w_masked_im"]
    grads = torch.randn((N, d), generator=g, device=dev)
    w_stack = torch.cat([w_re, w_im])

    def outs():
        return torch.empty((2, N, d), device=dev)

    def variant(k):
        o = outs()
        return o, lambda: _build.check(lib.draco_ab_matmul(
            k, w_re.data_ptr(), w_im.data_ptr(), grads.data_ptr(),
            o[0].data_ptr(), o[1].data_ptr(), N, N, d, _stream()), "ab")

    def new():
        o = outs()
        return o, lambda: coded.complex_matmul_launch(w_re, w_im, grads,
                                                      o[0], o[1])

    def library():
        o = outs().view(2 * N, d)
        return o, lambda: torch.matmul(w_stack, grads, out=o)

    # G or the outputs at a row stride of d rounded up to 64 floats (every
    # row 256-byte aligned), the other at d
    ld = -(-d // 64) * 64
    g_pad = torch.zeros((N, ld), device=dev)
    g_pad[:, :d] = grads

    def strided(ld_g, ld_out):
        o = torch.empty((2, N, ld_out), device=dev)[..., :d]
        src = g_pad if ld_g != d else grads
        return o, lambda: _build.check(lib.draco_ab_matmul_strided(
            w_re.data_ptr(), w_im.data_ptr(), src.data_ptr(),
            o[0].data_ptr(), o[1].data_ptr(), N, N, d, ld_g, ld_out,
            _stream()), "ab strided")

    runs = {"old": variant(0), "new": new()}
    if d % 32 == 0:  # the new kernel takes float4 here
        runs["lines"] = variant(1)
    runs["library"] = library()
    if d % 2 == 0:
        runs["unstaged"] = strided(d, d)
    if d % 2 == 0 and d != ld:
        runs.update({"loads_aligned": strided(ld, d),
                     "stores_aligned": strided(d, ld)})
    return runs, 4 * (2 * N * N + N * d + 2 * N * d), ("library",)


def segment_variants(lib, mode: str, dev) -> tuple:
    """The segmented narrow recombination at the shared_int8_seg4 leg's
    cuts: old, new and the whole-d kernel on the same buffers."""
    g = torch.Generator(device=dev).manual_seed(14)
    bounds = numerics.wire_segment_bounds(D, SEGMENTS, BLOCK)
    plan = coded.segment_plan(bounds, dev)
    v_re = torch.randn((plan.segments, N), generator=g, device=dev)
    v_im = torch.randn((plan.segments, N), generator=g, device=dev)
    bufs = [numerics.narrow_wire_rows(
        torch.randn((N, D), generator=g, device=dev), mode, BLOCK)
        for _ in range(2)]
    code = decode_kernels.WIRE_CODES[mode]
    blk, nb = (BLOCK, -(-D // BLOCK)) if mode == "int8" else (1, 0)
    s_re, s_im = (b.get("scale") for b in bufs)
    ptr = decode_kernels._ptr

    def old():
        out = torch.empty(D, device=dev)
        return out, lambda: _build.check(lib.draco_ab_segments_old(
            v_re.data_ptr(), v_im.data_ptr(), bufs[0]["q"].data_ptr(),
            bufs[1]["q"].data_ptr(), ptr(s_re), ptr(s_im),
            plan.table.data_ptr(), plan.tiles, out.data_ptr(), N, D, code,
            blk, nb, _stream()), "ab segments old")

    def new():
        out = torch.empty(D, device=dev)
        return out, lambda: decode_kernels.narrow_recombine_segments_launch(
            v_re, v_im, mode, bufs[0]["q"], s_re, bufs[1]["q"], s_im, blk,
            nb, plan, out)

    def whole_d():
        out = torch.empty(D, device=dev)
        return out, lambda: decode_kernels.narrow_recombine_launch(
            v_re[0], v_im[0], mode, bufs[0]["q"], s_re, bufs[1]["q"], s_im,
            blk, nb, out)

    scales = 2 * N * nb * 4
    nbytes = 2 * N * D * (1 if mode == "int8" else 2) + scales \
        + 2 * plan.segments * N * 4 + D * 4
    return ({"old": old(), "new": new(), "whole_d": whole_d()}, nbytes,
            ("whole_d",))


def approx_variants(lib, mode: str, dev) -> tuple:
    g = torch.Generator(device=dev).manual_seed(12)
    bg = torch.randn((N, D), generator=g, device=dev)
    rows = torch.randn((N, D), generator=g, device=dev)
    absent = [2, 5]
    rows[absent] = 0.0
    rows[absent[0]] = float("nan")
    pres = torch.ones(N, device=dev)
    pres[absent] = 0.0
    vn = torch.randn(N, generator=g, device=dev) / N
    buf = ({"q": rows} if mode == "f32"
           else numerics.narrow_wire_rows(rows, mode, BLOCK))
    blk, nb = (BLOCK, -(-D // BLOCK)) if mode == "int8" else (1, 0)
    q, scale = buf["q"], buf.get("scale")
    code = decode_kernels.WIRE_CODES[mode]

    def old():
        chunks = lib.draco_ab_approx_old_chunks(D)
        outs = (torch.empty(D, device=dev),
                torch.empty((2, chunks), device=dev),
                torch.empty(2, device=dev))
        return outs, lambda: _build.check(lib.draco_ab_approx_old(
            q.data_ptr(), decode_kernels._ptr(scale), bg.data_ptr(),
            vn.data_ptr(), pres.data_ptr(), outs[0].data_ptr(),
            outs[1].data_ptr(), outs[2].data_ptr(), N, D, code, blk, nb,
            chunks, 1.0 / N, _stream()), "ab approx old")

    def new():
        chunks = decode_kernels.approx_decode_chunks(D)
        outs = (torch.empty(D, device=dev),
                torch.empty((2, chunks), device=dev),
                torch.empty(2, device=dev))
        return outs, lambda: decode_kernels.approx_decode_launch(
            mode, q, scale, blk, nb, bg, vn, pres, *outs)

    pr = N - len(absent)
    wire = {"f32": 4, "bf16": 2, "int8": 1}[mode]
    nbytes = pr * D * wire + (pr * nb * 4 if scale is not None else 0) \
        + N * D * 4 + D * 4 + 2 * N * 4
    return {"old": old(), "new": new()}, nbytes, ()


def measure(runs: dict, rounds: int, reps: int) -> dict:
    times = {k: [] for k in runs}
    for r in range(rounds):
        order = list(runs) if r % 2 == 0 else list(reversed(runs))
        for k in order:
            times[k].append(time_ms(runs[k][1], reps))
    return times


def _bits(t):
    return t.contiguous().view(torch.int32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--cases", default=",".join(CASES),
                    help=f"a comma-separated subset of {','.join(CASES)}")
    ap.add_argument("--encode-d", default=f"{D},{LM_D}",
                    help="the encode's d's, comma-separated (its rows' "
                         "alignment is d·4 bytes apart)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    chosen = args.cases.split(",")
    if not set(chosen) <= set(CASES):
        ap.error(f"--cases: {args.cases!r} (of {','.join(CASES)})")
    if not torch.cuda.is_available():
        print("narrow_read_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    libs = build()
    narrow, enc = libs["narrow_read_ab"], libs["encode_ab"]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    record = {"card": card, "n": N, "d": D, "block": BLOCK, "rows": []}
    print(f"card: {card}", flush=True)
    cases = []
    if "encode" in chosen:
        cases += [("complex_matmul", f"d={d}",
                   lambda lib, _, dev, d=d: encode_variants(enc, d, dev))
                  for d in map(int, args.encode_d.split(","))]
    if "segments" in chosen:
        cases += [("cyclic_narrow_recombine_segments", m,
                   lambda lib, m, dev: segment_variants(narrow, m, dev))
                  for m in ("int8", "bf16")]
    if "narrow" in chosen:
        cases += [("cyclic_narrow_recombine", m, recombine_variants)
                  for m in ("int8", "bf16")]
    if "approx" in chosen:
        cases += [("approx_decode", m, approx_variants)
                  for m in ("f32", "bf16", "int8")]
    for name, mode, make in cases:
        runs, nbytes, loose = make(narrow, mode, dev)
        times = measure(runs, args.rounds, args.reps)
        ref = runs["old"][0]
        for k, (outs, _) in runs.items():
            if k in loose:
                continue
            a = outs if isinstance(outs, torch.Tensor) else outs[0]
            b = ref if isinstance(ref, torch.Tensor) else ref[0]
            if not torch.equal(_bits(a), _bits(b)):
                raise SystemExit(f"{name} {mode} {k}: output differs from "
                                 f"the old kernel's")
            if isinstance(outs, tuple):
                rel = ((outs[2] - ref[2]).abs() / ref[2].abs()).max().item()
                if not rel <= 1e-5:
                    raise SystemExit(f"{name} {mode} {k}: sums rel err {rel}")
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        for k, ts in times.items():
            med = statistics.median(ts)
            row = {"kernel": name, "wire": mode, "variant": k, "ms": med,
                   "ms_min": min(ts), "ms_max": max(ts), "bound_ms": bound,
                   "share_of_bound": bound / med,
                   "bitwise_old": k not in loose}
            record["rows"].append(row)
            print(f"{name} [{mode}] {k}: {med:.4f} ms [{min(ts):.4f}-"
                  f"{max(ts):.4f}], bound {bound:.4f} ms (bytes), "
                  f"{100 * bound / med:.1f}% of bound"
                  f"{'' if k in loose else ', bit for bit old'}", flush=True)
        del runs, ref
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
