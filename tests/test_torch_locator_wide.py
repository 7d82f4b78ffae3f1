"""The port's plain locator ``locator_core`` (the yardstick the CUDA kernel
is held to on the card) at the wide codes the kernel's shared-tile solve
takes: n=32, s=3 (the reference's int8 study code,
``draco_tpu/coding/cyclic.py:375``) and n=32, s=5 (the construction
ceiling, ``draco_tpu/coding/linalg.py:141-146``), against the JAX
package's fused lowering and its xla path, as ``test_torch_locator.py``
holds n <= 16.

Tolerances (ROADMAP's rule: discrete outputs equal wherever the data decide
them). The data decide the honest set (s or s−1 rows reversed at 99×, one
absent row), the loud set (energies against their median, exact), and the
flags of the attacked and absent rows: those must equal the fused
lowering's and the xla path's, and at λ=0 every attacked row must be
located in every column. They do not decide an honest row's flag: the fit
of the (n−2s)×(n−2s) honest-row submatrix of C1 carries f32 noise of
cond·2⁻²⁴ relative, and cond is 2e4–4e4 at s=3 and 5e5–7e5 at s=5
(printed per case), so an honest row's deviation sits at the flag
threshold (HEALTH_REL_TOL² of the mean energy) in both packages and the
noise decides; those flags are counted, not held. On the λ path the
reference's significance gate can leave a column's attacked rows
unlocated (at s=5 with s attacked rows, in every column here): the port
must then agree with the reference, not locate. v is row 0 of that
inverse: two eliminations in other orders differ by about cond·2⁻²⁴
relative, so v is held to 1e-4 + 4·cond·2⁻²⁴ of its largest entry. The
residual is that noise too (5e-6–3.3e-4 here; an unflagged row's
deviation is under the flag threshold, so it is under HEALTH_REL_TOL by
construction): both sides under HEALTH_REL_TOL, within 2e-4 absolute.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from draco_tpu.coding import cyclic as jc
from draco_tpu_torch.coding import cyclic as tc
from test_torch_locator import LAM, T, _reference_locators, columns
from test_torch_locator import encoded_rows

torch.set_num_threads(1)

CODES = ((32, 3), (32, 5))
CASES = [(n, s, sc, lam) for n, s in CODES for sc in ("attacked", "absent")
         for lam in (0.0, LAM)]
EPS = 2.0 ** -24


@functools.lru_cache(maxsize=None)
def _codes(n, s):
    return jc.build_cyclic_code(n, s), tc.build_cyclic_code(n, s)


def wide_rows(code, scenario, d, seed):
    """s attacked rows, or s − 1 attacked rows and absent row n − 3."""
    s = code.s
    if scenario == "attacked":
        return encoded_rows(code, d, tuple(range(1, 1 + 3 * s, 3)), (), seed)
    return encoded_rows(code, d, tuple(range(1, 1 + 3 * (s - 1), 3)),
                        (code.n - 3,), seed)


@pytest.mark.parametrize(
    "case", CASES, ids=lambda c: f"n{c[0]}-s{c[1]}-{c[2]}-lam{c[3]:g}")
def test_wide_locator_core_vs_fused_and_xla(case):
    n, s, scenario, lam = case
    jcode, tcode = _codes(n, s)
    r_re, r_im, present, _ = wide_rows(jcode, scenario, 6 * 64, n + s)
    e_re, e_im, _ = columns(r_re, r_im, 6, n)
    tol = jc.HEALTH_REL_TOL
    fused, xla_fn = _reference_locators(n, s, lam)
    args = (jnp.asarray(e_re), jnp.asarray(e_im), jnp.asarray(present))
    ref = [np.asarray(a) for a in fused(*args)]
    xla = xla_fn(*args)
    x_flag, x_loud = np.asarray(xla[3]["flagged"]), np.asarray(xla[3]["loud"])
    t = tcode.tensors("cpu")
    out = [a.numpy() for a in tc.locator_core(
        T(e_re), T(e_im), t["c2h_re"], t["c2h_im"], t["c1_re"], t["c1_im"],
        t["est_re"], t["est_im"], T(present.astype(np.float32)[None, :]), s,
        tol, lam=lam)]
    bad = ~present | (np.abs(r_re).max(axis=1) > 50 *
                      np.median(np.abs(r_re).max(axis=1)))
    assert bad.sum() == s
    np.testing.assert_array_equal(out[2], ref[2], err_msg="honest")
    np.testing.assert_array_equal(out[2], np.asarray(xla[2]))
    np.testing.assert_array_equal(out[4], ref[4], err_msg="loud")
    np.testing.assert_array_equal(out[4], x_loud)
    for other in (ref[3], x_flag):
        np.testing.assert_array_equal(out[3][:, bad], other[:, bad],
                                      err_msg="flagged (attacked, absent)")
    assert (out[2].sum(axis=1) == n - 2 * s).all()
    assert not out[2][:, ~present].any() and not out[3][:, ~present].any()
    if lam == 0.0:
        assert not out[2][:, bad].any() and out[3][:, bad & present].all()
    c1 = tcode.c1_re.astype(np.float64) + 1j * tcode.c1_im
    cond = max(np.linalg.cond(c1[h]) for h in out[2])
    v_scale = max(np.abs(ref[0]).max(), np.abs(ref[1]).max())
    v_tol = (1e-4 + 4 * cond * EPS) * v_scale
    v_err = max(np.abs(out[0] - ref[0]).max(), np.abs(out[1] - ref[1]).max())
    missed = sum(out[2][l, bad].any() for l in range(len(out[2])))
    print(f"n={n} s={s} {scenario} λ={lam:g}: cond(C1[honest]) {cond:.3e}, "
          f"v err {v_err:.3e} (tol {v_tol:.3e}), honest rows flagged: port "
          f"{int(out[3][:, ~bad].sum())}, fused {int(ref[3][:, ~bad].sum())}"
          f", xla {int(x_flag[:, ~bad].sum())}; columns the gate leaves "
          f"unlocated {missed}")
    assert v_err <= v_tol
    assert out[5].max() < tol and ref[5].max() < tol
    np.testing.assert_allclose(out[5], ref[5], atol=2e-4)
