"""The port's approximate gradient code (``draco_tpu_torch.coding.approx``
and ``coding.assignment``) against the JAX package's.

Inputs from a numpy seed, n = 8. Tolerances:
  * assignments and encode weights: equal (the same numpy code);
  * ``truncated_lstsq``, ``decode_weights`` (v, u, bound) and
    ``recovered_fraction``: 1e-5 absolute — an 8×8 f32 SVD least squares
    by two LAPACK calls, the singular values kept by the same rule; on a
    whole absent cluster (rank-deficient) the rule decides the answer;
  * the decode (JAX ``impl="fused"``, the reference's kernel formulation
    on the CPU): decoded mean 1e-5 of the largest batch gradient, the
    residual 1e-5 relative plus 1e-6 absolute (f32 sums of d terms in
    another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from draco_tpu.coding import approx as japprox
from draco_tpu.coding import assignment as jassign
from draco_tpu.coding import linalg as jlinalg
from draco_tpu.obs import numerics as jnx
from draco_tpu_torch.coding import approx, assignment, linalg
from draco_tpu_torch.obs import numerics as tnx

torch.set_num_threads(1)

N, D = 8, 5000
CODES = [(1.5, "pairwise"), (2.0, "pairwise"), (2.0, "clustered"),
         (1.0, "pairwise"), (4.0, "clustered")]
MASKS = {
    "all": None,
    "two absent": [1, 1, 0, 1, 1, 0, 1, 1],
    # clustered r=2: cluster 1 wholly absent, W_Sᵀ rank-deficient
    "cluster 1 absent": [1, 1, 0, 0, 1, 1, 1, 1],
    "neighbours absent": [0, 0, 1, 1, 1, 1, 1, 1],
    "one present": [0, 0, 0, 0, 0, 1, 0, 0],
}


@pytest.mark.parametrize("r,scheme", CODES)
def test_assignment_and_code_equal(r, scheme):
    np.testing.assert_array_equal(assignment.build_assignment(N, r, scheme),
                                  jassign.build_assignment(N, r, scheme))
    a = assignment.build_assignment(N, r, scheme)
    np.testing.assert_array_equal(assignment.encode_weights(a),
                                  jassign.encode_weights(a))
    ours, ref = approx.build_approx_code(N, r, scheme), \
        japprox.build_approx_code(N, r, scheme)
    for field in ("assign", "weights"):
        np.testing.assert_array_equal(getattr(ours, field),
                                      getattr(ref, field), err_msg=field)


@pytest.mark.parametrize("bad", [(8, 0.5, "pairwise"), (8, 9.0, "pairwise"),
                                 (8, 1.5, "clustered"), (8, 3.0, "clustered"),
                                 (8, 2.0, "striped")])
def test_assignment_rejects_like_the_reference(bad):
    for mod in (assignment, jassign):
        with pytest.raises(ValueError):
            mod.build_assignment(*bad)


def test_truncated_lstsq_matches_jnp_lstsq():
    rs = np.random.RandomState(3)
    for m, k, rank in ((8, 8, 8), (8, 8, 5), (10, 6, 6), (6, 10, 3)):
        a = (rs.randn(m, rank) @ rs.randn(rank, k)).astype(np.float32)
        b = rs.randn(m).astype(np.float32)
        ref = np.asarray(jlinalg.truncated_lstsq(jnp.asarray(a),
                                                 jnp.asarray(b), 1e-5))
        out = linalg.truncated_lstsq(torch.from_numpy(a), torch.from_numpy(b),
                                     1e-5).numpy()
        np.testing.assert_allclose(out, ref, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("r,scheme", CODES[:3])
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_decode_weights_and_recovered_fraction(r, scheme, mask):
    present = MASKS[mask]
    ours, ref = approx.build_approx_code(N, r, scheme), \
        japprox.build_approx_code(N, r, scheme)
    jp = None if present is None else jnp.asarray(present, bool)
    tp = None if present is None else np.asarray(present, bool)
    for a, b in zip(approx.decode_weights(ours, tp),
                    japprox.decode_weights(ref, jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)
    assert float(approx.recovered_fraction(ours, tp)) == pytest.approx(
        float(japprox.recovered_fraction(ref, jp)), abs=1e-6)
    if present is None:  # every worker present decodes exactly: u = 1
        assert float(approx.decode_weights(ours)[2]) < 1e-5


@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
def test_decode_matches_the_reference(wire):
    """A real encode with two absent rows (one a NaN payload) decoded on
    each wire: the port's decode (plain version on the CPU) against the
    reference's fused decode on the same rows."""
    rs = np.random.RandomState(5)
    bg = rs.randn(N, D).astype(np.float32)
    ours, ref = approx.build_approx_code(N, 1.5), japprox.build_approx_code(
        N, 1.5)
    present = np.ones(N, bool)
    present[[2, 6]] = False
    rows = np.array(japprox.encode_shared(ref, jnp.asarray(bg)))
    np.testing.assert_allclose(
        approx.encode_shared(ours, torch.from_numpy(bg)).numpy(), rows,
        rtol=1e-6, atol=1e-6)
    rows[~present] = 0.0
    rows_in = rows.copy()
    rows_in[2] = np.nan  # an absent worker's payload never counts
    t_wire = None
    if wire != "f32":
        buf = jnx.narrow_wire_rows(jnp.asarray(rows), wire, 256)
        rows = np.asarray(jnx.widen_wire_rows(buf, wire, 256))
        t_wire = (wire, tnx.narrow_wire_rows(torch.from_numpy(rows_in), wire,
                                             256), 256)
    dec_j, v_j, h_j = japprox.decode(
        ref, jnp.asarray(rows), present=jnp.asarray(present),
        with_health=True, batch_grads=jnp.asarray(bg), impl="fused")
    dec_t, v_t, h_t = approx.decode(
        ours, None if t_wire else torch.from_numpy(rows_in),
        torch.from_numpy(bg), present=present, wire=t_wire)
    assert np.isfinite(dec_t.numpy()).all()
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-5)
    np.testing.assert_allclose(dec_t.numpy(), np.asarray(dec_j), rtol=0,
                               atol=1e-5 * np.abs(bg).max())
    assert float(h_t["residual"]) == pytest.approx(float(h_j["residual"]),
                                                   rel=1e-5, abs=1e-6)
    assert float(h_t["bound"]) == pytest.approx(float(h_j["bound"]), abs=1e-5)
    assert float(h_t["recovered_fraction"]) == float(
        h_j["recovered_fraction"])
    slack = tnx.wire_residual_slack(wire)
    assert float(h_t["residual"]) <= float(h_t["bound"]) + slack + 1e-4


def test_full_participation_decodes_exactly():
    rs = np.random.RandomState(6)
    bg = torch.from_numpy(rs.randn(N, D).astype(np.float32))
    code = approx.build_approx_code(N, 1.5)
    dec, _, health = approx.decode(code, approx.encode_shared(code, bg), bg)
    assert float(health["residual"]) < 1e-5
    assert float(health["bound"]) < 1e-5
    np.testing.assert_allclose(dec.numpy(), bg.mean(0).numpy(), atol=1e-5)
