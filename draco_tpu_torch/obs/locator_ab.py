"""Time the error locator's kernel against the old one-block-a-column kernel
on one card, and the wrapper's host cost against the old wrapper.

    python -m draco_tpu_torch.obs.locator_ab [--rounds 4] [--reps 100]
        [--out FILE]

Builds ``obs/locator_ab.cu`` (the port's ``csrc/cyclic_locator.cu`` with
the old one-block-a-column kernel beside it, ``old_cyclic_locator_kernel``)
with nvcc and, at each (n, s, L) of ``SHAPES``, runs both kernels on the
same columns (``columns``: a real encode of random batch gradients, the
attacked rows reversed, one absent row where s allows it, projected per
layer): whether their discrete outputs (honest, flagged, loud) are equal
and the largest difference of their v — at (64, 15) the code is too
ill-conditioned in f32 to hold either kernel to the other, so that shape is
timed only. Each kernel is timed from a CUDA graph of ``--reps``
back-to-back launches with CUDA events, in ``--rounds`` rounds of turns
(old, new, new, old). Beside them, the new kernel's SM cycles by phase
for column 0 (``PHASES``, from the build's clock64() marks), and the same
for a second build whose Jacobi rotation takes IEEE division and square
root as the plain version does (the new kernel's outputs must stay
discrete-equal to it). Then the wrapper: back-to-back calls of
``ops.decode_kernels.cyclic_locator`` against the old wrapper
(``old_wrapper``, the same kernel behind it), in turns, at n=8, s=1 and
n=9, s=2, one column. Prints a line per shape and writes the record as
JSON to ``--out``. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys

import torch

from draco_tpu_torch import _build, attacks
from draco_tpu_torch.coding import cyclic
from draco_tpu_torch.ops import coded, decode_kernels

# (n, s, L): the main path's codes (ResNet-18 n=8, s=1; VGG-11 n=9, s=2)
# on one column and at the layer legs' 62 and 69 columns; the reference's
# int8 study code n=32, s=3 and its construction ceiling n=32, s=5; the
# largest configuration config.validate() admits
SHAPES = ((8, 1, 1), (9, 2, 1), (8, 1, 62), (8, 1, 69), (32, 3, 1),
          (32, 5, 1), (64, 15, 1))
TIMED_ONLY = {(64, 15)}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
OLD_SIGNATURE = [_P] * 15 + [_I] * 4 + [_F] * 8 + [_P]


def start_build(ieee_rotation: bool = False):
    """Start nvcc on ``obs/locator_ab.cu`` (the locator's flags; with
    ``ieee_rotation`` the new kernel's Jacobi rotation on IEEE division and
    square root, ``DRACO_LOCATOR_IEEE_ROTATION``); returns the job for
    :func:`finish_build`."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    name = "liblocator_ab_ieee.so" if ieee_rotation else "liblocator_ab.so"
    out = _build.BUILD_DIR / name
    src = _build.PKG_DIR / "obs" / "locator_ab.cu"
    define = ["-DDRACO_LOCATOR_IEEE_ROTATION"] if ieee_rotation else []
    proc = subprocess.Popen(
        [_build._nvcc(), *_build._flags("cyclic_locator"), *define, "-o",
         str(out), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    return out, proc


def finish_build(job) -> ctypes.CDLL:
    out, proc = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on obs/locator_ab.cu:\n{log}")
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in (
            ("draco_ab_locator_old", OLD_SIGNATURE),
            ("draco_cyclic_locator", _build.SIGNATURES["cyclic_locator"][
                "draco_cyclic_locator"]),
            ("draco_ab_locator_marks", [_P])):
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def scenario(n: int, s: int) -> tuple:
    """(attacked, absent) rows at (n, s): one attacked row at s = 1; else
    s − 1 attacked rows and one absent one (t + e = s)."""
    if s == 1:
        return (3,), ()
    return tuple(range(1, 1 + 3 * (s - 1), 3)), (2,)


def columns(code, L, attacked, absent, dev, g, width=64):
    """(L, n) projected columns of a real encode: random batch gradients
    over L layers of ``width`` coordinates, encoded, the ``attacked`` rows
    reversed (rev_grad), the ``absent`` rows zero-filled, projected per
    layer on a loc=1 normal factor. Returns (e_re, e_im, pres_f). (The
    columns of ``chip_smoke.locator_columns``.)"""
    t, n = code.tensors(dev), code.n
    grads = torch.randn((n, L * width), generator=g, device=dev)
    enc_re, enc_im = coded.complex_matmul_plain(t["w_masked_re"],
                                                t["w_masked_im"], grads)
    mask = torch.zeros(n, dtype=torch.bool, device=dev)
    mask[list(attacked)] = True
    enc_re, enc_im = attacks.inject_cyclic(enc_re, enc_im, mask, "rev_grad")
    pres = torch.ones(n, device=dev)
    pres[list(absent)] = 0.0
    enc_re, enc_im = enc_re * pres[:, None], enc_im * pres[:, None]
    f = 1.0 + torch.randn(L * width, generator=g, device=dev)
    proj = lambda r: (r.view(n, L, width) * f.view(L, width)).sum(-1).T  # noqa: E731
    return (proj(enc_re).contiguous(), proj(enc_im).contiguous(),
            pres[None, :].contiguous())


def outputs(L: int, n: int, dev) -> tuple:
    f32, b = torch.float32, torch.bool
    return (torch.empty((L, n), dtype=f32, device=dev),
            torch.empty((L, n), dtype=f32, device=dev),
            torch.empty((L, n), dtype=b, device=dev),
            torch.empty((L, n), dtype=b, device=dev),
            torch.empty((L, n), dtype=b, device=dev),
            torch.empty((L,), dtype=f32, device=dev))


def old_launch(lib, code, e_re, e_im, pres, rel_tol, lam, outs) -> None:
    """The old kernel into ``outs`` (v_re, v_im, honest, flagged, loud,
    resid), with the wrapper's arguments."""
    t = code.tensors(e_re.device)
    L, n = e_re.shape
    err = lib.draco_ab_locator_old(
        e_re.data_ptr(), e_im.data_ptr(),
        *(t[k].data_ptr() for k in ("c2h_re", "c2h_im", "c1_re", "c1_im",
                                    "est_re", "est_im")),
        pres.data_ptr(), *(o.data_ptr() for o in outs), L, n, code.s,
        cyclic.linalg_mod.JACOBI_SWEEPS, cyclic.LOCATOR_RCOND ** 2, lam,
        lam * lam, 2.0 * lam, 1e-3 / n, rel_tol ** 2, cyclic.LOUD_REL_TOL,
        cyclic.SPREAD_PHI, torch.cuda.current_stream(e_re.device).cuda_stream)
    _build.check(err, "old_cyclic_locator")


def old_locator(lib, code, e_re, e_im, pres, rel_tol, lam=0.0) -> tuple:
    """The old kernel's ``(v_re, v_im, honest, flagged, loud, resid)``."""
    outs = outputs(*e_re.shape, e_re.device)
    old_launch(lib, code, e_re, e_im, pres, rel_tol, lam, outs)
    return outs


# the kernel's phases between its marks (csrc/cyclic_locator.cu
# LOCATOR_MARK): loads and the mean energy; the syndrome; the Jacobi solve;
# the locator values; the bias, ranks and compaction; C1's honest rows and
# the identity; the Gauss–Jordan inverse; v and the fit; the median
PHASES = ("load", "syndrome", "jacobi", "values", "honest", "gj_init",
          "gauss_jordan", "fit", "median")


def phase_cycles(lib, code, e_re, e_im, pres, rel_tol) -> tuple:
    """(SM cycles of each phase of column 0, the outputs) of one launch of
    the marked build of the new kernel (``obs/locator_ab.cu``), after a
    warm-up."""
    t = code.tensors(e_re.device)
    L, n = e_re.shape
    outs = outputs(L, n, e_re.device)
    for _ in range(2):
        err = lib.draco_cyclic_locator(
            e_re.data_ptr(), e_im.data_ptr(),
            *(t[k].data_ptr() for k in ("c2h_re", "c2h_im", "c1_re",
                                        "c1_im", "est_re", "est_im")),
            pres.data_ptr(), *(o.data_ptr() for o in outs), L, n, code.s,
            0, cyclic.linalg_mod.JACOBI_SWEEPS, cyclic.LOCATOR_RCOND ** 2, 0.0,
            0.0, 0.0, 1e-3 / n, rel_tol ** 2, cyclic.LOUD_REL_TOL,
            cyclic.SPREAD_PHI,
            torch.cuda.current_stream(e_re.device).cuda_stream)
        _build.check(err, "cyclic_locator (marked)")
        torch.cuda.synchronize()
    marks = (ctypes.c_longlong * (len(PHASES) + 1))()
    _build.check(lib.draco_ab_locator_marks(marks), "locator marks")
    return {p: marks[i + 1] - marks[i] for i, p in enumerate(PHASES)}, outs


def old_wrapper(code, e_re_l, e_im_l, pres_f, rel_tol: float,
                 lam: float = 0.0):
    """The old ``decode_kernels.cyclic_locator`` on a CUDA column stack, as
    it was (two lookups of the code's tensors, the constants' pointers
    gathered and the scalars read every call, three output allocations),
    launching the port's kernel: the yardstick of the wrapper's host
    cost."""
    from draco_tpu_torch.coding import cyclic as cyclic_mod

    dev = e_re_l.device
    t = code.tensors(dev)
    if decode_kernels.resolve_decode_impl("auto", dev) == "plain":
        return cyclic_mod.locator_core(
            e_re_l, e_im_l, t["c2h_re"], t["c2h_im"], t["c1_re"], t["c1_im"],
            t["est_re"], t["est_im"], pres_f, code.s, rel_tol, lam=lam)
    L, n = e_re_l.shape
    if n != code.n or n > decode_kernels.MAX_N:
        raise ValueError(f"cyclic_locator: columns of {n} rows for a code of "
                         f"n={code.n}")
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
    _old_launch(code, e_re_l, e_im_l, pres_f, rel_tol, lam, v[0], v[1],
                 masks[0], masks[1], masks[2], resid)
    return v[0], v[1], masks[0], masks[1], masks[2], resid


def _old_launch(code, e_re_l, e_im_l, pres_f, rel_tol, lam, v_re, v_im,
                 honest, flagged, loud, resid) -> None:
    """The old ``cyclic_locator_launch``."""
    from draco_tpu_torch.coding import cyclic as cyclic_mod

    dev = e_re_l.device
    L, n = e_re_l.shape
    t = code.tensors(dev)
    c = [t[k] for k in ("c2h_re", "c2h_im", "c1_re", "c1_im", "est_re",
                        "est_im")]
    err = _build.library("cyclic_locator").draco_cyclic_locator(
        e_re_l.data_ptr(), e_im_l.data_ptr(), *(x.data_ptr() for x in c),
        pres_f.data_ptr(), v_re.data_ptr(), v_im.data_ptr(),
        honest.data_ptr(), flagged.data_ptr(), loud.data_ptr(),
        resid.data_ptr(), L, n, code.s, 0,
        cyclic_mod.linalg_mod.JACOBI_SWEEPS,
        cyclic_mod.LOCATOR_RCOND ** 2, lam, lam * lam, 2.0 * lam,
        1e-3 / n, rel_tol ** 2, cyclic_mod.LOUD_REL_TOL,
        cyclic_mod.SPREAD_PHI, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "cyclic_locator")


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
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


def graph_of(fn, reps: int) -> torch.cuda.CUDAGraph:
    """``reps`` calls of ``fn`` captured in one CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return graph


def turns(runs: dict, rounds: int) -> tuple:
    """({name: median ms}, {name: every ms}) of the two entries of ``runs``
    (name -> a function that times one turn), in rounds of turns (a, b, b,
    a)."""
    times = {k: [] for k in runs}
    a, b = runs
    for _ in range(rounds):
        for k in (a, b, b, a):
            times[k].append(runs[k]())
    return {k: statistics.median(ts) for k, ts in times.items()}, times


def _discrete_equal(x, y) -> bool:
    return all(torch.equal(a, b) for a, b in zip(x[2:5], y[2:5]))


def _v_diff(x, y) -> float:
    return max((torch.nan_to_num(a, nan=0.0) - torch.nan_to_num(b, nan=0.0))
               .abs().max().item() for a, b in zip(x[:2], y[:2]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=100,
                    help="launches a CUDA graph holds")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("locator_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", torch.cuda.current_device())
    jobs = start_build(), start_build(ieee_rotation=True)
    _build.library("cyclic_locator")
    lib, ieee = (finish_build(j) for j in jobs)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    record = {"card": card, "rounds": args.rounds, "reps": args.reps,
              "shapes": [], "wrapper": []}
    print(f"card: {card}", flush=True)
    g = torch.Generator(device=dev).manual_seed(14)
    tol = cyclic.HEALTH_REL_TOL
    for n, s, L in SHAPES:
        code = cyclic.build_cyclic_code(n, s)
        attacked, absent = scenario(n, s)
        e_re, e_im, pres = columns(code, L, attacked, absent, dev, g)
        new = outputs(L, n, dev)
        old = outputs(L, n, dev)

        def run_new(new=new, code=code, e=(e_re, e_im, pres)):
            decode_kernels.cyclic_locator_launch(code, *e, tol, 0.0, *new)

        def run_old(old=old, code=code, e=(e_re, e_im, pres)):
            old_launch(lib, code, *e, tol, 0.0, old)

        run_new()
        run_old()
        torch.cuda.synchronize()
        row = {"n": n, "s": s, "L": L, "attacked": list(attacked),
               "absent": list(absent),
               "instance": decode_kernels.locator_instance(n, s)}
        if (n, s) not in TIMED_ONLY:
            row["discrete_equal"] = _discrete_equal(new, old)
            row["v_max_diff"] = _v_diff(new, old)
            row["v_scale"] = max(old[0].abs().max().item(),
                                 old[1].abs().max().item())
        graphs = {"old": graph_of(run_old, args.reps),
                  "new": graph_of(run_new, args.reps)}
        med, times = turns(
            {k: (lambda gr=gr: time_ms(gr.replay, 3) / args.reps)
             for k, gr in graphs.items()}, args.rounds)
        row["cycles"], _ = phase_cycles(lib, code, e_re, e_im, pres, tol)
        row["ieee_rotation_cycles"], ieee_out = phase_cycles(
            ieee, code, e_re, e_im, pres, tol)
        if (n, s) not in TIMED_ONLY:
            row["ieee_rotation_discrete_equal"] = _discrete_equal(ieee_out,
                                                                  new)
        row.update({"old_ms": med["old"], "new_ms": med["new"],
                    "old_ms_all": times["old"], "new_ms_all": times["new"],
                    "speedup": med["old"] / med["new"]})
        record["shapes"].append(row)
        same = "timed only"
        if "discrete_equal" in row:
            same = (f"discrete outputs "
                    f"{'equal' if row['discrete_equal'] else 'DIFFER'}, v "
                    f"max diff {row['v_max_diff']:.3e} (of "
                    f"{row['v_scale']:.3e})")
        print(f"cyclic_locator n={n} s={s} L={L} ({row['instance']}): old "
              f"{med['old']:.4f} ms, new {med['new']:.4f} ms "
              f"({row['speedup']:.2f}x); {same}; column 0's cycles by phase "
              f"{row['cycles']}; the Jacobi solve on IEEE rotations "
              f"{row['ieee_rotation_cycles']['jacobi']} cycles"
              + ("" if (n, s) in TIMED_ONLY else ", discrete outputs "
                 + ("equal" if row["ieee_rotation_discrete_equal"]
                    else "DIFFER")), flush=True)
        del graphs
    for n, s in ((8, 1), (9, 2)):
        code = cyclic.build_cyclic_code(n, s)
        e_re, e_im, pres = columns(code, 1, *scenario(n, s), dev, g)
        a = old_wrapper(code, e_re, e_im, pres, tol)
        b = decode_kernels.cyclic_locator(code, e_re, e_im, pres, tol)
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        med, times = turns(
            {"old": lambda: time_ms(
                lambda: old_wrapper(code, e_re, e_im, pres, tol), 200),
             "new": lambda: time_ms(
                lambda: decode_kernels.cyclic_locator(code, e_re, e_im, pres,
                                                      tol), 200)},
            args.rounds)
        record["wrapper"].append({"n": n, "s": s, "old_launch_ms":
                                  med["old"], "launch_ms": med["new"],
                                  "old_all": times["old"],
                                  "new_all": times["new"],
                                  "outputs_equal": same})
        print(f"cyclic_locator wrapper n={n} s={s}: launch_ms old "
              f"{med['old']:.4f}, now {med['new']:.4f} (back-to-back "
              f"calls); outputs {'equal' if same else 'DIFFER'}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
