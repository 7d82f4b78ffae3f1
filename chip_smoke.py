#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``draco_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--steps N] [--out FILE]

Phases, each of which raises on failure (the script then exits non-zero and
prints no result line):

  1. build    every kernel of ``draco_tpu_torch/csrc`` with nvcc, in parallel
  2. kernels  each kernel against its plain PyTorch version on the card, at
              the main path's shapes (n=8, d=11,173,962 for the coded
              products; L=1 and L=62 columns at n=8, s=1 for the locator,
              with an attacked row, an absent row and a λ>0 case); times
              the kernel, its plain version, its bound and, for the coded
              products, one torch.matmul computing the same function
  3. legs     ResNet-18 on synthetic CIFAR-10 at full width, n=8 workers,
              batch 32, s=1, a rev_grad adversary every step: the cyclic
              ``simulate`` leg, the geometric-median leg and the cyclic
              ``shared`` leg, each with the launch counts zeroed just before
              it and read just after; every coded step must locate the
              adversary (honest_located=6, located_errors=det_tp=det_adv=1)
  4. check    the decode at the main path's size, and one small coded step,
              on the card against the same on the CPU through the plain
              versions

``--profile`` adds one torch.profiler step per leg (device time by kernel
and the device's busy share); ``--out`` writes the whole record as JSON.

It imports nothing of JAX and nothing of the JAX package. Without a CUDA
device it exits with status 1 before printing anything on stdout.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import torch

from draco_tpu_torch import _build, attacks, ops
from draco_tpu_torch import rng as drng
from draco_tpu_torch.coding import cyclic
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.data.datasets import load_dataset
from draco_tpu_torch.ops import coded, decode_kernels
from draco_tpu_torch.runtime import resolve_device
from draco_tpu_torch.training.trainer import Trainer

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
N, S, D = 8, 1, 11_173_962  # ResNet-18's flat gradient at n=8, s=1
SEED = 428


class SmokeFailure(RuntimeError):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA
    events, after ``warmup`` calls)."""
    for _ in range(warmup):
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


def bound(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def coded_kernels(code, dev) -> list:
    g = torch.Generator(device=dev).manual_seed(SEED)
    t = code.tensors(dev)
    grads = torch.randn((N, D), generator=g, device=dev)
    f = drng.random_projection_factors(SEED, D).to(dev)
    rows = []

    def entry(name, source_line, err, tol, ms, plain_ms, lib_ms, nbytes,
              flops):
        b_ms, b_by = bound(nbytes, flops)
        print(f"kernel {name}: max_abs_err={err:.3e} (tol {tol:.3e}) "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by})", flush=True)
        require(err <= tol, f"{name}: max_abs_err {err} > tol {tol}")
        rows.append({"name": name, "route": "cuda",
                     "source": "draco_tpu_torch/csrc/coded.cu",
                     "replaces": source_line, "ok": True,
                     "max_abs_err": err, "tol": tol,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib_ms})

    # encode (shared leg): 8-term f32 sums in another order agree to a
    # few ulps of the output's scale
    w_re, w_im = t["w_masked_re"], t["w_masked_im"]
    k_re, k_im = coded.complex_matmul(w_re, w_im, grads)
    p_re, p_im = coded.complex_matmul_plain(w_re, w_im, grads)
    err = max((k_re - p_re).abs().max().item(),
              (k_im - p_im).abs().max().item())
    tol = 1e-5 * max(p_re.abs().max().item(), p_im.abs().max().item())
    w_stack = torch.cat([w_re, w_im])
    entry("complex_matmul", "draco_tpu/ops/coded.py:82", err, tol,
          time_ms(lambda: coded.complex_matmul(w_re, w_im, grads), 20),
          time_ms(lambda: coded.complex_matmul_plain(w_re, w_im, grads), 20),
          time_ms(lambda: torch.matmul(w_stack, grads), 20),
          4 * (2 * N * N + N * D + 2 * N * D), 2 * 2 * N * N * D)
    del k_re, k_im, p_re, p_im, grads
    r_re, r_im = torch.randn((2, N, D), generator=g, device=dev)

    # projection: an 11M-term reduction; two f32 summation orders agree
    # to 1e-5 of the sum of the terms' magnitudes
    k_re, k_im = coded.complex_project(r_re, r_im, f)
    p_re, p_im = coded.complex_project_plain(r_re, r_im, f)
    scale = max((r_re.abs() @ f.abs()).max().item(),
                (r_im.abs() @ f.abs()).max().item())
    err = max((k_re - p_re).abs().max().item(),
              (k_im - p_im).abs().max().item())
    r_stack = torch.cat([r_re, r_im])
    entry("complex_project", "draco_tpu/ops/coded.py:152", err, 1e-5 * scale,
          time_ms(lambda: coded.complex_project(r_re, r_im, f), 20),
          time_ms(lambda: coded.complex_project_plain(r_re, r_im, f), 20),
          time_ms(lambda: torch.matmul(r_stack, f), 20),
          4 * (2 * N * D + D + 2 * N), 2 * 2 * N * D)

    # recombination: 2n-term sums per column, tolerance 1e-5 of the
    # largest column's sum of magnitudes
    v_re = torch.randn(N, generator=g, device=dev)
    v_im = torch.randn(N, generator=g, device=dev)
    k = coded.complex_recombine(v_re, v_im, r_re, r_im)
    p = coded.complex_recombine_plain(v_re, v_im, r_re, r_im)
    scale = (v_re.abs() @ r_re.abs() + v_im.abs() @ r_im.abs()).max().item()
    v_cat = torch.cat([v_re, -v_im])
    entry("complex_recombine", "draco_tpu/ops/coded.py:201",
          (k - p).abs().max().item(), 1e-5 * scale,
          time_ms(lambda: coded.complex_recombine(v_re, v_im, r_re, r_im), 20),
          time_ms(lambda: coded.complex_recombine_plain(v_re, v_im, r_re,
                                                        r_im), 20),
          time_ms(lambda: torch.matmul(v_cat, r_stack), 20),
          4 * (2 * N * D + 2 * N + D), 2 * 2 * N * D)
    return rows


def locator_columns(code, L, attacked, absent, dev, g, width=64):
    """(L, n) projected columns of a real encode: random batch gradients
    over L layers of ``width`` coordinates, encoded, the ``attacked`` rows
    reversed (rev_grad), the ``absent`` rows zero-filled, projected per
    layer on a loc=1 normal factor. Returns (e_re, e_im, pres_f)."""
    t = code.tensors(dev)
    grads = torch.randn((N, L * width), generator=g, device=dev)
    enc_re, enc_im = coded.complex_matmul_plain(t["w_masked_re"],
                                                t["w_masked_im"], grads)
    mask = torch.zeros(N, dtype=torch.bool, device=dev)
    mask[list(attacked)] = True
    enc_re, enc_im = attacks.inject_cyclic(enc_re, enc_im, mask, "rev_grad")
    pres = torch.ones(N, device=dev)
    pres[list(absent)] = 0.0
    enc_re, enc_im = enc_re * pres[:, None], enc_im * pres[:, None]
    f = 1.0 + torch.randn(L * width, generator=g, device=dev)
    proj = lambda r: (r.view(N, L, width) * f.view(L, width)).sum(-1).T  # noqa: E731
    return (proj(enc_re).contiguous(), proj(enc_im).contiguous(),
            pres[None, :].contiguous())


def locator_kernel(code, dev) -> list:
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    t = code.tensors(dev)

    def plain(e_re, e_im, pres, lam=0.0):
        return cyclic.locator_core(
            e_re, e_im, t["c2h_re"], t["c2h_im"], t["c1_re"], t["c1_im"],
            t["est_re"], t["est_im"], pres, code.s, cyclic.HEALTH_REL_TOL,
            lam=lam)

    def kernel(e_re, e_im, pres, lam=0.0):
        return decode_kernels.cyclic_locator(code, e_re, e_im, pres,
                                             cyclic.HEALTH_REL_TOL, lam=lam)

    # the discrete outputs must be equal; v and the residual are f32 solves
    # of a well-conditioned 6×6 system: 1e-4 of max|v|, 1e-5 absolute
    cases = [("L=1, attacked row 3", 1, (3,), (), 0.0),
             ("L=62, attacked row 5", 62, (5,), (), 0.0),
             ("L=1, attacked row 2, absent row 6", 1, (2,), (6,), 0.0),
             ("L=62, λ=2^-6, attacked row 1", 62, (1,), (), 2.0 ** -6),
             ("L=8, λ=2^-6, clean", 8, (), (), 2.0 ** -6)]
    worst = 0.0
    for label, L, attacked, absent, lam in cases:
        e_re, e_im, pres = locator_columns(code, L, attacked, absent, dev, g)
        k = kernel(e_re, e_im, pres, lam)
        p = plain(e_re, e_im, pres, lam)
        for name, a, b in zip(("honest", "flagged", "loud"), k[2:5], p[2:5]):
            require(torch.equal(a, b), f"cyclic_locator [{label}]: {name} "
                    f"differs: kernel {a.int().tolist()} plain "
                    f"{b.int().tolist()}")
        v_scale = max(p[0].abs().max().item(), p[1].abs().max().item())
        v_err = max((k[0] - p[0]).abs().max().item(),
                    (k[1] - p[1]).abs().max().item())
        r_err = (k[5] - p[5]).abs().max().item()
        require(v_err <= 1e-4 * v_scale,
                f"cyclic_locator [{label}]: v err {v_err} > {1e-4 * v_scale}")
        require(r_err <= 1e-5, f"cyclic_locator [{label}]: residual err "
                f"{r_err} > 1e-5")
        for row in attacked:
            require(not bool(k[2][:, row].any()) and bool(k[3][:, row].all()),
                    f"cyclic_locator [{label}]: attacked row {row} not "
                    f"located")
        for row in absent:
            require(not bool(k[2][:, row].any()),
                    f"cyclic_locator [{label}]: absent row {row} used")
        worst = max(worst, v_err)
        print(f"kernel cyclic_locator [{label}]: discrete outputs equal, "
              f"v err {v_err:.3e}, residual err {r_err:.3e}", flush=True)

    # timed at the main path's shape: one column (global decode)
    e_re, e_im, pres = locator_columns(code, 1, (3,), (), dev, g)
    ms = time_ms(lambda: kernel(e_re, e_im, pres), 200)
    plain_ms = time_ms(lambda: plain(e_re, e_im, pres), 10)
    n, s, m = N, S, N - 2 * S
    nbytes = 4 * (2 * n + 2 * (2 * s * n + n * m + n * (s + 1)) + n
                  + 2 * n + 1) + 3 * n
    flops = locator_flops(n, s)
    b_ms, b_by = bound(nbytes, flops)
    print(f"kernel cyclic_locator: ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={b_ms:.3e} ({b_by}; the launch sets its time)",
          flush=True)
    return [{"name": "cyclic_locator", "route": "cuda",
             "source": "draco_tpu_torch/csrc/cyclic_locator.cu",
             "replaces": "draco_tpu/ops/decode_kernels.py:127", "ok": True,
             "max_abs_err": worst, "tol": "discrete equal; v 1e-4 rel",
             "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
             "bound_by": b_by, "library_ms": None}]


def locator_flops(n: int, s: int, sweeps: int = 12) -> int:
    """Floating-point operations of one locator column (f32, counted from
    the algorithm: syndrome, Jacobi sweeps on the 2s×2s system, locator
    values, complex Gauss–Jordan on the m×m honest rows, fit, median)."""
    M, m = 2 * s, n - 2 * s
    syndrome = 4 * 2 * M * n
    jacobi = sweeps * (M * (M - 1) // 2) * (6 * M + 12 * M + 20) + 4 * M * M
    values = 8 * 2 * (s + 1) * n
    gauss = m * (16 * m + 2 * 8 * m * m)
    fit = 8 * 2 * m * m + 8 * 2 * n * m + 10 * n
    rank = 3 * n * n
    return syndrome + jacobi + values + gauss + fit + rank


# --------------------------------------------------------------------------
# phase 3: the training legs
# --------------------------------------------------------------------------

def leg(name: str, steps: int, expect: tuple, dev, profile: bool = False,
        **cfg_kw) -> dict:
    cfg = TrainConfig(network="ResNet18", dataset="synthetic-cifar10",
                      num_workers=N, worker_fail=S, err_mode="rev_grad",
                      batch_size=32, lr=0.01, momentum=0.9,
                      max_steps=steps + 2, train_dir="", seed=SEED, **cfg_kw)
    tr = Trainer(cfg, device=dev, dataset=load_dataset("synthetic-cifar10"),
                 quiet=True)
    require(tr.setup.decode_impl == "cuda",
            f"{name}: the locator resolved to {tr.setup.decode_impl!r}")
    first = tr.step()  # warm-up: cuDNN plans, first kernel loads
    require(first["loss"] == first["loss"], f"{name}: warm-up loss is NaN")
    ops.reset_launch_counts()
    recs = [tr.step() for _ in range(steps)]
    counts = ops.launch_counts()
    for r in recs:
        require(math.isfinite(r["loss"]),
                f"{name} step {r['step']}: loss {r['loss']}")
        if cfg.approach == "cyclic":
            require(r["honest_located"] == N - 2 * S
                    and r["located_errors"] == 1 and r["det_tp"] == 1
                    and r["det_adv"] == 1,
                    f"{name} step {r['step']}: adversary not located: {r}")
    for k in expect:
        require(counts[k] > 0, f"{name}: kernel {k} was never launched "
                f"({counts})")
    ms = [r["step_ms"] for r in recs]
    out = {"leg": name, "steps": steps, "ms_per_step": sum(ms) / len(ms),
           "ms_steps": ms, "loss": [r["loss"] for r in recs],
           "launches": counts,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    print(f"leg {name}: {out['ms_per_step']:.2f} ms/step over {steps} steps "
          f"(host clock, device synchronised); launches {counts}; "
          f"losses {['%.4f' % x for x in out['loss']]}", flush=True)
    if profile:
        out["profile"] = prof = profile_step(tr)
        print(f"leg {name} profile: wall {prof['wall_ms']:.2f} ms, device "
              f"busy {prof['device_busy_ms']:.2f} ms; top kernels "
              + "; ".join(f"{r['name'][:48]} {r['device_ms']:.2f} ms x"
                          f"{r['calls']}" for r in prof["top"][:8]),
              flush=True)
    del tr
    torch.cuda.empty_cache()
    return out


def cross_device_check(dev) -> dict:
    """The coded step on the card against the same step on the CPU.

    (a) The decode alone at the main path's size: the received rows of a
    real encode with one reversed row, decoded on the card (the kernels)
    and on the CPU (the plain versions); the honest set must be equal and
    the decoded mean agree to 1e-5 of the largest batch gradient.
    (b) One shared-redundancy step of ResNet-18 (n=8, B=4) from the same
    seed, batch and draws on both devices: the discrete metrics must be
    equal, the loss agree to 1e-4 and the parameter update to 5e-2 in
    relative L2 norm — in f32 a pre-activation within rounding of a ReLU
    kink can land on the other side of it on one device, and at a batch of
    a few samples one such unit moves the gradient by ~0.5% (measured
    5.4e-3 on an H100)."""
    code = cyclic.build_cyclic_code(N, S)
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    grads = torch.randn((N, D), generator=g, device=dev)
    t = code.tensors(dev)
    enc = coded.complex_matmul(t["w_masked_re"], t["w_masked_im"], grads)
    mask = torch.zeros(N, dtype=torch.bool, device=dev)
    mask[4] = True
    enc = attacks.inject_cyclic(*enc, mask, "rev_grad")
    f = drng.random_projection_factors(SEED, D)
    dec_c, hon_c = cyclic.decode(code, *enc, f.to(dev))
    dec_p, hon_p = cyclic.decode(code, enc[0].cpu(), enc[1].cpu(), f)
    require(torch.equal(hon_c.cpu(), hon_p) and not bool(hon_p[4]),
            f"decode: honest set cuda {hon_c.tolist()} cpu {hon_p.tolist()}")
    scale = grads.abs().max().item()
    dec_err = (dec_c.cpu() - dec_p).abs().max().item()
    mean_err = (dec_c - grads.mean(0)).abs().max().item()
    print(f"check decode cuda vs cpu (n=8, d={D}, row 4 reversed): "
          f"max_abs_err {dec_err:.3e}, vs the true mean {mean_err:.3e} "
          f"(tol {1e-5 * scale:.3e})", flush=True)
    require(dec_err <= 1e-5 * scale and mean_err <= 1e-5 * scale,
            f"decode err {dec_err} / {mean_err} > {1e-5 * scale}")
    del grads, enc, dec_c

    ds = load_dataset("synthetic-cifar10", synthetic_train=256,
                      synthetic_test=16)
    cfg = TrainConfig(network="ResNet18", dataset="synthetic-cifar10",
                      approach="cyclic", redundancy="shared", num_workers=N,
                      worker_fail=S, err_mode="rev_grad", batch_size=4,
                      max_steps=1, train_dir="", seed=SEED)
    res = {}
    for d in (dev, "cpu"):
        tr = Trainer(cfg, device=d, dataset=ds, quiet=True)
        before = {k: v.detach().cpu().clone()
                  for k, v in tr.state.params.items()}
        rec = tr.step()
        delta = torch.cat([(tr.state.params[k].detach().cpu() - before[k])
                           .reshape(-1) for k in before])
        res[str(d)] = (rec, delta)
    (rc, dc), (rp, dp) = res[str(dev)], res["cpu"]
    for k in ("honest_located", "located_errors", "det_tp", "det_adv"):
        require(rc[k] == rp[k], f"cross-device: {k} cuda {rc[k]} cpu {rp[k]}")
    rel = ((dc - dp).norm() / dp.norm()).item()
    print(f"check step cuda vs cpu (shared, n=8 B=4): update relative L2 "
          f"err {rel:.3e} (tol 5e-2); loss cuda {rc['loss']:.6f} cpu "
          f"{rp['loss']:.6f}", flush=True)
    require(abs(rc["loss"] - rp["loss"]) <= 1e-4 * abs(rp["loss"]),
            f"cross-device loss {rc['loss']} vs {rp['loss']}")
    require(rel <= 5e-2, f"cross-device update relative err {rel} > 5e-2")
    return {"decode_max_abs_err": dec_err, "decode_vs_mean_err": mean_err,
            "update_rel_l2_err": rel, "loss_cuda": rc["loss"],
            "loss_cpu": rp["loss"]}


def profile_step(tr) -> dict:
    """One more step under torch.profiler: device time by kernel name (the
    top 15) and the device's busy time, beside the step's wall time under
    the profiler (which adds host overhead of its own)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side events only (kernels, copies, memsets): an aten op's
    # device total repeats the time of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:15]
    rows = [{"name": e.key[:90], "device_ms": dev_us(e) / 1e3,
             "calls": e.count} for e in top]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "top": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=4,
                    help="timed steps per leg, after one warm-up step")
    ap.add_argument("--out", type=str, default="",
                    help="also write the full record as JSON to this file")
    ap.add_argument("--profile", action="store_true",
                    help="profile one extra step of each leg (torch.profiler)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this smoke "
              "runs the port on a CUDA GPU", file=sys.stderr)
        return 1

    dev = resolve_device("cuda")  # also turns TF32 off (runtime.full_f32)
    card = card_line()
    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda,
              "device": torch.cuda.get_device_name(0)}
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    t0 = time.perf_counter()
    built = _build.build_all()
    record["build_s"] = time.perf_counter() - t0
    print(f"build: nvcc {built or 'nothing (up to date)'} in "
          f"{record['build_s']:.1f} s", flush=True)

    code = cyclic.build_cyclic_code(N, S)
    kernels = coded_kernels(code, dev) + locator_kernel(code, dev)
    torch.cuda.empty_cache()

    legs = [leg("simulate", args.steps,
                ("complex_project", "cyclic_locator", "complex_recombine"),
                dev, args.profile, approach="cyclic", redundancy="simulate"),
            leg("geomedian", args.steps, (), dev, args.profile,
                approach="baseline", mode="geometric_median"),
            leg("shared", args.steps, tuple(ops.KERNELS), dev, args.profile,
                approach="cyclic", redundancy="shared")]
    record["legs"] = legs
    record["cross_device"] = cross_device_check(dev)

    # launches per kernel: from the simulate leg (the main path), and from
    # the shared leg for the encode, which only that leg runs
    for row in kernels:
        src = legs[2] if row["name"] == "complex_matmul" else legs[0]
        row["launches"] = src["launches"][row["name"]]
        row["launches_from_leg"] = src["leg"]
    record["kernels"] = kernels
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(2)
