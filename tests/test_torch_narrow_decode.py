"""The plain versions of the port's narrow-wire decode kernels
(``draco_tpu_torch.ops.decode_kernels.approx_decode`` and
``cyclic_narrow_recombine``) against the JAX package's Pallas kernels in
interpret mode, and the cyclic decode on a narrow wire against the
reference's.

On the CPU each wrapper computes its plain version, so this pins the
arithmetic the CUDA kernels of ``csrc/narrow_decode.cu`` are held to on the
card (``chip_smoke.py``). n = 8 and a ragged d = 5000 (not a multiple of
the Pallas TILE_D = 4096 nor of the int8 block). At an int8 block of 96,
which does not divide TILE_D, the JAX side takes its widened path (the
rows widened, then its f32 kernels), as the reference's decode does.

Tolerances: the decoded / recombined vectors to 1e-5 of the largest
column's Σ|coef|·|row| (f32 sums of n terms in another order: the
interpreter's dot, torch's matmul); the two squared norms to 1e-5
relative (sums of d terms in another order); discrete decode outputs
equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from draco_tpu import attacks as jattacks
from draco_tpu.coding import cyclic as jcyclic
from draco_tpu.obs import numerics as jnx
from draco_tpu.ops import coded as jcoded
from draco_tpu.ops import decode_kernels as jdk
from draco_tpu_torch import attacks, ops
from draco_tpu_torch.coding import cyclic
from draco_tpu_torch.obs import numerics as tnx
from draco_tpu_torch.ops import decode_kernels as dk

torch.set_num_threads(1)

N, D = 8, 5000
T = torch.from_numpy
WIRES = [("f32", 1), ("bf16", 256), ("int8", 256), ("int8", 96)]


def _bufs(rows: np.ndarray, mode: str, block: int):
    """The reference's and the port's narrow buffers of the same rows."""
    return (jnx.narrow_wire_rows(jnp.asarray(rows), mode, block),
            tnx.narrow_wire_rows(T(rows), mode, block))


def _jax_takes_kernel(mode: str, block: int) -> bool:
    return jdk.narrow_kernel_ok((mode, {}, block))


@pytest.mark.parametrize("mode,block", WIRES, ids=[f"{m}-{b}" for m, b in
                                                   WIRES])
def test_approx_decode_plain_vs_interpret(mode, block):
    rs = np.random.RandomState(7)
    bg = rs.randn(N, D).astype(np.float32)
    rows = rs.randn(N, D).astype(np.float32)
    pres = np.ones(N, bool)
    pres[[1, 4]] = False
    rows[1] = np.nan  # an absent row's payload is dropped, NaN or not
    v = (rs.randn(N) * pres).astype(np.float32)
    vn = T(v / N)
    pres_f = T(pres.astype(np.float32))
    if mode == "f32":
        ref = jdk.approx_decode(jnp.asarray(rows), jnp.asarray(bg),
                                jnp.asarray(v), jnp.asarray(pres),
                                interpret=True)
        out = dk.approx_decode(T(rows), T(bg), vn, pres_f)
        wide = np.where(pres[:, None], rows, 0.0)
    else:
        jbuf, tbuf = _bufs(rows, mode, block)
        if _jax_takes_kernel(mode, block):
            ref = jdk.approx_decode(None, jnp.asarray(bg), jnp.asarray(v),
                                    jnp.asarray(pres), interpret=True,
                                    wire=(mode, jbuf, block))
        else:
            ref = jdk.approx_decode(jnx.widen_wire_rows(jbuf, mode, block),
                                    jnp.asarray(bg), jnp.asarray(v),
                                    jnp.asarray(pres), interpret=True)
        out = dk.approx_decode(None, T(bg), vn, pres_f, (mode, tbuf, block))
        wide = np.where(pres[:, None],
                        np.asarray(jnx.widen_wire_rows(jbuf, mode, block)),
                        0.0)
    assert np.isfinite(out[0].numpy()).all()
    scale = (np.abs(v / N) @ np.abs(wide)).max()
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), rtol=0,
                               atol=1e-5 * scale)
    for a, b in zip(out[1:], ref[1:]):
        assert float(a) == pytest.approx(float(b), rel=1e-5)


@pytest.mark.parametrize("mode,block", WIRES[1:], ids=[f"{m}-{b}" for m, b
                                                       in WIRES[1:]])
def test_cyclic_narrow_recombine_plain_vs_interpret(mode, block):
    rs = np.random.RandomState(8)
    r_re, r_im = (rs.randn(N, D).astype(np.float32) for _ in range(2))
    v_re, v_im = (rs.randn(N).astype(np.float32) for _ in range(2))
    jre, tre = _bufs(r_re, mode, block)
    jim, tim = _bufs(r_im, mode, block)
    if _jax_takes_kernel(mode, block):
        ref = jdk.cyclic_narrow_recombine(
            jnp.asarray(v_re), jnp.asarray(v_im), (mode, jre, jim, block),
            interpret=True)
    else:
        ref = jcoded.complex_recombine(
            jnp.asarray(v_re), jnp.asarray(v_im),
            jnx.widen_wire_rows(jre, mode, block),
            jnx.widen_wire_rows(jim, mode, block), force=True,
            interpret=True)
    out = dk.cyclic_narrow_recombine(T(v_re), T(v_im), (mode, tre, tim, block))
    w_re = np.abs(np.asarray(jnx.widen_wire_rows(jre, mode, block)))
    w_im = np.abs(np.asarray(jnx.widen_wire_rows(jim, mode, block)))
    scale = (np.abs(v_re) @ w_re + np.abs(v_im) @ w_im).max()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_cyclic_decode_on_the_narrow_wire(mode):
    """A real shared encode with one reversed row on a narrow wire, decoded
    with the wire's threshold and λ: the port's decode (the narrow
    recombination) against the reference's fused decode (which recombines
    the widened rows); equal honest and flagged sets, the attacked row
    located, the mean to 1e-5 of the largest batch gradient."""
    rs = np.random.RandomState(9)
    g = rs.randn(N, D).astype(np.float32)
    jcode, code = jcyclic.build_cyclic_code(N, 1), cyclic.build_cyclic_code(
        N, 1)
    adv = np.zeros(N, bool)
    adv[3] = True
    j_re, j_im = jcyclic.encode_shared(jcode, jnp.asarray(g))
    j_re, j_im = jattacks.inject_cyclic(j_re, j_im, jnp.asarray(adv),
                                        "rev_grad")
    e_re, e_im = attacks.inject_cyclic(
        *cyclic.encode_shared(code, T(g)), T(adv), "rev_grad")
    rel_tol, lam = tnx.wire_rel_tol(N, 1, mode), tnx.wire_locator_lambda(mode)
    f = rs.normal(loc=1.0, size=D).astype(np.float32)

    class Cfg:
        wire_dtype, shadow_block, shadow_round = mode, 256, "nearest"
        num_workers, worker_fail, seed = N, 1, 0

    j_re, j_im, jwire = jnx.narrow_wire_pair(Cfg, j_re, j_im)
    t_re, t_im, wire = tnx.narrow_wire_pair(Cfg, e_re, e_im)
    ref = jcyclic.decode(jcode, j_re, j_im, jnp.asarray(f), with_health=True,
                         rel_tol=rel_tol, impl="fused", lam=lam, wire=jwire)
    before = ops.launch_counts()
    out = cyclic.decode(code, t_re, t_im, T(f), with_health=True,
                        rel_tol=rel_tol, lam=lam, wire=wire)
    assert ops.launch_counts() == before  # CPU tensors: the plain versions
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(out[2]["flagged"].numpy(),
                                  np.asarray(ref[2]["flagged"]))
    assert not bool(out[1][3]) and bool(out[2]["flagged"][3])
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), rtol=0,
                               atol=1e-5 * np.abs(g).max())


def test_cpu_tensors_take_the_plain_version():
    """A CPU tensor never reaches a kernel: the launch counters stay put
    and the result is the plain version's, bit for bit."""
    rs = np.random.RandomState(10)
    rows, bg = (T(rs.randn(N, 300).astype(np.float32)) for _ in range(2))
    vn, pres = T(rs.randn(N).astype(np.float32)), torch.ones(N)
    wire = ("int8", tnx.narrow_wire_rows(rows, "int8", 64), 64)
    before = ops.launch_counts()
    for a, b in zip(dk.approx_decode(None, bg, vn, pres, wire),
                    dk.approx_decode_plain(None, bg, vn, pres, wire)):
        assert torch.equal(a, b)
    pair = ("bf16", tnx.narrow_wire_rows(rows, "bf16"),
            tnx.narrow_wire_rows(bg, "bf16"), 256)
    assert torch.equal(dk.cyclic_narrow_recombine(vn, vn, pair),
                       dk.cyclic_narrow_recombine_plain(vn, vn, pair))
    assert ops.launch_counts() == before


def test_other_devices_raise():
    meta = torch.empty((N, 300), device="meta")
    vec = torch.empty((N,), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        dk.approx_decode(meta, meta, vec, vec)
    wire = ("bf16", {"q": meta.to(torch.bfloat16)},
            {"q": meta.to(torch.bfloat16)}, 256)
    with pytest.raises(ValueError, match="cuda or cpu"):
        dk.cyclic_narrow_recombine(vec, vec, wire)


def test_narrow_kernel_takes_any_block():
    """The reference needs TILE_D % block == 0 (a TPU tiling limit); the
    port's kernels take any int8 block >= 1 and every bf16 wire."""
    assert dk.narrow_kernel_ok(("int8", {}, {}, 96))
    assert dk.narrow_kernel_ok(("int8", {}, {}, 300))
    assert dk.narrow_kernel_ok(("bf16", {}, {}, 300))
    assert not dk.narrow_kernel_ok(("int8", {}, {}, 0))
    assert not dk.narrow_kernel_ok(None)
    assert set(ops.KERNELS) >= {"approx_decode", "cyclic_narrow_recombine"}
