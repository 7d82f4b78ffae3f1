"""The port's cyclic decode on the CPU — ``coding/linalg`` primitives, the
plain locator ``locator_core`` (the CUDA kernel's plain version) and
``decode`` — against the JAX package's fused lowering (``impl="fused"``,
the same algorithm through XLA) and its historical ``impl="xla"`` path.

Tolerances. The discrete outputs (honest, flagged, loud) must be equal
wherever the data decide them: a corrupt or absent row, or the λ path's
significance gate. On a clean column at λ=0 the locator magnitudes are
f32 noise normalised to O(1) and the honest set is whichever n−2s rows the
noise favours, different for any change of summation order; there the
test holds the flag and loud sets and the size of the honest set. The
recombination vector v comes out of one f32 Gauss–Jordan inverse of a
well-conditioned DFT submatrix: 1e-4 of its largest entry. The residual is
f32 solve noise on both sides: 1e-5 absolute where the data decide the
honest set, and below 1e-4 on both where noise picks it (its fit then
extrapolates the other rows, up to ~1e-5 at n=16).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from draco_tpu.coding import cyclic as jc
from draco_tpu.coding import linalg as jl
from draco_tpu_torch.coding import cyclic as tc
from draco_tpu_torch.coding import linalg as tl

torch.set_num_threads(1)

T = torch.from_numpy
LAM = 2.0 ** -6


# --------------------------------------------------------------------------
# linalg primitives
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["full", "rank_deficient", "lam"])
def test_jacobi_lstsq(case):
    rng = np.random.RandomState(1)
    a = rng.normal(size=(5, 4, 4)).astype(np.float32)
    b = rng.normal(size=(5, 4)).astype(np.float32)
    if case == "rank_deficient":
        a[:, :, 3] = a[:, :, 0]
    lam = 0.3 if case == "lam" else 0.0
    ref = np.asarray(jl.jacobi_lstsq(jnp.asarray(a), jnp.asarray(b), 1e-5,
                                     lam=lam))
    out = tl.jacobi_lstsq(T(a), T(b), 1e-5, lam=lam).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())


def test_gauss_inv_c():
    rng = np.random.RandomState(2)
    a_re = rng.normal(size=(6, 5, 5)).astype(np.float32)
    a_im = rng.normal(size=(6, 5, 5)).astype(np.float32)
    # ties in |a|² down a column exercise the lowest-index pivot rule
    a_re[0, :, 0], a_im[0, :, 0] = 1.0, 0.0
    ref = jl.gauss_inv_c(jnp.asarray(a_re), jnp.asarray(a_im))
    out = tl.gauss_inv_c(T(a_re), T(a_im))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5 * np.abs(np.asarray(r)).max())


def test_topk_mask_and_select_matrix_ties():
    rng = np.random.RandomState(3)
    mag = rng.randint(0, 3, size=(20, 8)).astype(np.float32)  # many ties
    ref = np.asarray(jl.topk_mask(jnp.asarray(mag), 5))
    out = tl.topk_mask(T(mag), 5)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(
        tl.select_matrix(out, 5).numpy(),
        np.asarray(jl.select_matrix(jnp.asarray(ref), 5)))


def test_masked_median():
    rng = np.random.RandomState(4)
    x = rng.normal(size=(12, 9)).astype(np.float32)
    x[1, 2] = x[1, 5]  # a tie
    mask = rng.rand(12, 9) > 0.4
    mask[0] = False  # empty: NaN
    mask[3] = True  # odd count
    mask[4, :8], mask[4, 8] = True, False  # even count
    ref = np.asarray(jl.masked_median(jnp.asarray(x), jnp.asarray(mask)))
    out = tl.masked_median(T(x), T(mask)).numpy()
    np.testing.assert_array_equal(out, ref)
    assert np.isnan(out[0])


# --------------------------------------------------------------------------
# the locator and the decode
# --------------------------------------------------------------------------

def test_code_construction_matches():
    for n, s in ((8, 1), (16, 2)):
        jcode, tcode = jc.build_cyclic_code(n, s), tc.build_cyclic_code(n, s)
        for f in ("w_sel_re", "w_sel_im", "batch_ids", "c2h_re", "c2h_im",
                  "c1_re", "c1_im", "est_re", "est_im", "w_masked_re",
                  "w_masked_im"):
            np.testing.assert_array_equal(getattr(tcode, f),
                                          getattr(jcode, f))


def encoded_rows(code, d, attacked, absent, seed):
    """(n, d) received rows of a real encode (rev_grad on ``attacked``,
    zero-filled ``absent``), the (n,) presence and the batch gradients."""
    rng = np.random.RandomState(seed)
    n = code.n
    grads = rng.normal(size=(n, d)).astype(np.float32)
    r_re = (code.w_masked_re @ grads).astype(np.float32)
    r_im = (code.w_masked_im @ grads).astype(np.float32)
    for i in attacked:
        r_re[i] *= -99.0
        r_im[i] *= -99.0
    present = np.ones(n, bool)
    present[list(absent)] = False
    r_re[~present] = 0.0
    r_im[~present] = 0.0
    return r_re, r_im, present, grads


def scenario_rows(code, scenario, d, seed):
    s = code.s
    if scenario == "clean":
        return encoded_rows(code, d, (), (), seed)
    if scenario == "attacked":
        return encoded_rows(code, d, tuple(range(1, 1 + 3 * s, 3)), (), seed)
    # one absent row plus s-1 adversaries: within the budget adv + missing
    return encoded_rows(code, d, tuple(range(2, 2 + 3 * (s - 1), 3)), (5,),
                        seed)


def columns(r_re, r_im, L, seed):
    """(L, n) projected columns: layer ℓ is coordinates [ℓ·w, (ℓ+1)·w)."""
    rng = np.random.RandomState(seed + 100)
    n, d = r_re.shape
    f = (1.0 + rng.normal(size=d)).astype(np.float32)
    w = d // L
    e_re = np.stack([r_re[:, l * w:(l + 1) * w] @ f[l * w:(l + 1) * w]
                     for l in range(L)]).astype(np.float32)
    e_im = np.stack([r_im[:, l * w:(l + 1) * w] @ f[l * w:(l + 1) * w]
                     for l in range(L)]).astype(np.float32)
    return e_re, e_im, f


CASES = [(n, s, sc, lam) for n, s in ((8, 1), (16, 2))
         for sc in ("clean", "attacked", "absent") for lam in (0.0, LAM)]


def _ids(c):
    return f"n{c[0]}-s{c[1]}-{c[2]}-lam{c[3]:g}"


@functools.lru_cache(maxsize=None)
def _reference_locators(n, s, lam):
    """The reference's fused and xla locators for one (n, s, λ), jitted
    once and shared by the scenarios (an all-True presence is the same
    decode as none)."""
    code = jc.build_cyclic_code(n, s)
    tol = jc.HEALTH_REL_TOL
    fused = jax.jit(functools.partial(jc._run_locator, code, rel_tol=tol,
                                      impl="fused", lam=lam))
    xla = jax.jit(jax.vmap(lambda er, ei, pres: jc._locate_v(
        code, er, ei, pres, tol, lam=lam), in_axes=(0, 0, None)))
    return fused, xla


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_locator_core_vs_fused_and_xla(case):
    n, s, scenario, lam = case
    jcode, tcode = jc.build_cyclic_code(n, s), tc.build_cyclic_code(n, s)
    r_re, r_im, present, _ = scenario_rows(jcode, scenario, 6 * 64, n + s)
    e_re, e_im, _ = columns(r_re, r_im, 6, n)
    tol = jc.HEALTH_REL_TOL
    fused, xla_fn = _reference_locators(n, s, lam)
    args = (jnp.asarray(e_re), jnp.asarray(e_im), jnp.asarray(present))
    ref = [np.asarray(a) for a in fused(*args)]
    pres_f = T(present.astype(np.float32)[None, :])
    t = tcode.tensors("cpu")
    out = [a.numpy() for a in tc.locator_core(
        T(e_re), T(e_im), t["c2h_re"], t["c2h_im"], t["c1_re"], t["c1_im"],
        t["est_re"], t["est_im"], pres_f, s, tol, lam=lam)]
    decided = scenario != "clean" or lam > 0
    xla = xla_fn(*args)
    x_honest = np.asarray(xla[2])
    x_flag, x_loud = np.asarray(xla[3]["flagged"]), np.asarray(xla[3]["loud"])
    for i, name in ((3, "flagged"), (4, "loud")):
        np.testing.assert_array_equal(out[i], ref[i], err_msg=name)
    np.testing.assert_array_equal(out[3], x_flag)
    np.testing.assert_array_equal(out[4], x_loud)
    assert (out[2].sum(axis=1) == n - 2 * s).all()
    if decided:
        np.testing.assert_array_equal(out[2], ref[2])
        np.testing.assert_array_equal(out[2], x_honest)
        v_scale = max(np.abs(ref[0]).max(), np.abs(ref[1]).max())
        np.testing.assert_allclose(out[0], ref[0], atol=1e-4 * v_scale)
        np.testing.assert_allclose(out[1], ref[1], atol=1e-4 * v_scale)
        np.testing.assert_allclose(out[5], ref[5], atol=1e-5)
    else:  # a noise-chosen honest set extrapolates the rest: small, not equal
        assert out[5].max() < 1e-4 and ref[5].max() < 1e-4
    if scenario != "clean":
        bad = ~present | (np.abs(r_re).max(axis=1) > 50 *
                          np.median(np.abs(r_re).max(axis=1)))
        assert not out[2][:, bad].any()


@pytest.mark.parametrize("n,s,scenario", [(8, 1, "attacked"),
                                          (8, 1, "absent"),
                                          (16, 2, "attacked"),
                                          (16, 2, "absent")])
def test_decode_vs_fused(n, s, scenario):
    jcode, tcode = jc.build_cyclic_code(n, s), tc.build_cyclic_code(n, s)
    d = 3000
    r_re, r_im, present, grads = scenario_rows(jcode, scenario, d, 7 * n + s)
    f = (1.0 + np.random.RandomState(9).normal(size=d)).astype(np.float32)
    pres = None if present.all() else present
    ref_dec, ref_honest, ref_h = jc.decode(
        jcode, jnp.asarray(r_re), jnp.asarray(r_im), jnp.asarray(f),
        present=None if pres is None else jnp.asarray(pres),
        with_health=True, impl="fused")
    dec, honest, h = tc.decode(
        tcode, T(r_re), T(r_im), T(f),
        present=None if pres is None else T(pres), with_health=True)
    np.testing.assert_array_equal(honest.numpy(), np.asarray(ref_honest))
    for k in ("flagged", "loud"):
        np.testing.assert_array_equal(h[k].numpy(), np.asarray(ref_h[k]))
    assert float(h["residual"]) == pytest.approx(float(ref_h["residual"]),
                                                 abs=1e-5)
    # the decode is exact: both recover the mean of the batch gradients
    mean = grads.mean(axis=0)
    scale = np.abs(grads).max()
    np.testing.assert_allclose(dec.numpy(), np.asarray(ref_dec),
                               atol=1e-5 * scale)
    np.testing.assert_allclose(dec.numpy(), mean, atol=1e-4 * scale)
