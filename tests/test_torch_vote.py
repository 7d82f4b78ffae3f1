"""The port's repetition code (``draco_tpu_torch.coding.repetition``)
against the JAX package's (``draco_tpu.coding.repetition``) on the CPU.

* The row fingerprints' plain version (``_row_fingerprints``, int64 masked
  to 32 bits; the plain version of the ``row_fingerprints`` kernel) equals
  the reference's uint32 hashes bit for bit, on f32 and bf16 rows, under
  the public salts and under salts drawn from a JAX key and fed in.
* ``majority_vote``, with and without a present mask, by fingerprint and
  exactly: the voted mean to 1e-6 relative (a mean of the same group
  winners, summed in another order) and every health field equal.
* The reference's vote and forgery cases (tests/test_repetition_and_
  aggregation.py), ported: minority corruption, the constant attack, bf16
  rows, the lowest-index tie-break, the top-bit pair flip and the
  position-swap forgery, the exact vote against the fingerprint vote.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from draco_tpu.attacks import inject_plain as jax_inject
from draco_tpu.coding import repetition as jrep
from draco_tpu_torch import attacks
from draco_tpu_torch.coding import repetition
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.ops import vote

T = torch.from_numpy


def key_salts(key):
    """The reference's two salts under ``key``, as the port's salts input."""
    return vote.salts_tensor(np.asarray(jax.random.bits(key, (2,),
                                                        jnp.uint32)))


def rows_pair(rng, n, d, dtype):
    """The same rows for both packages: (jax array, torch tensor)."""
    x = rng.normal(size=(n, d)).astype(np.float32)
    if dtype == "bf16":
        j = jnp.asarray(x).astype(jnp.bfloat16)
        t = T(np.asarray(j.astype(jnp.float32))).to(torch.bfloat16)
        return j, t
    return jnp.asarray(x), T(x)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("keyed", [False, True], ids=["public", "fed"])
def test_fingerprints_match_the_reference(dtype, keyed):
    rng = np.random.RandomState(0)
    jx, tx = rows_pair(rng, 6, 1003, dtype)
    # the bits the fingerprint must separate: a signed zero and a NaN
    jx = jx.at[1, 7].set(-0.0).at[4, 2].set(jnp.nan)
    tx[1, 7], tx[4, 2] = -0.0, float("nan")
    key = jax.random.key(11) if keyed else None
    h1, h2 = jrep._row_fingerprints(jx.reshape(2, 3, -1), key=key)
    want = np.stack([np.asarray(h1).reshape(-1),
                     np.asarray(h2).reshape(-1)], -1).astype(np.int64)
    salts = key_salts(key) if keyed else None
    got = vote.row_fingerprints(tx, salts)
    assert got.dtype == torch.int64 and got.shape == (6, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    # across the plain version's column blocks
    big_j, big_t = rows_pair(rng, 3, 70_001, dtype)
    h1, h2 = jrep._row_fingerprints(big_j[None], key=key)
    np.testing.assert_array_equal(
        vote.row_fingerprints(big_t, salts).numpy(),
        np.stack([np.asarray(h1)[0], np.asarray(h2)[0]], -1))


def test_salts_and_devices():
    s = vote.salts_tensor((0xFFFFFFFF, 5))
    assert s.dtype == torch.int32 and s.tolist() == [-1, 5]
    assert vote.as_int32_bits(torch.tensor([0xFFFFFFFF, 5])).tolist() == [-1, 5]
    assert torch.equal(vote.public_salts("cpu"),
                       vote.salts_tensor(vote.PUBLIC_SALTS))
    with pytest.raises(ValueError, match="cuda or cpu"):
        vote.row_fingerprints(torch.empty((2, 3), device="meta"))
    with pytest.raises(ValueError, match="2/4-byte"):
        vote.row_fingerprints(torch.zeros((2, 3), dtype=torch.float64))
    assert vote.fingerprint_ops(9, 10) == 47 * 90


def grouped_rows(rng, n, r, d, dup_rounds=3):
    """Random rows with planted duplicates inside each group, so agreement
    counts take nontrivial values."""
    rows = rng.normal(size=(n, d)).astype(np.float32)
    for g0 in range(n // r):
        for _ in range(rng.randint(0, dup_rounds + 1)):
            src, dst = rng.randint(0, r, size=2)
            rows[g0 * r + dst] = rows[g0 * r + src]
    return rows


@pytest.mark.parametrize("method", ["fingerprint", "exact"])
@pytest.mark.parametrize("with_present", [False, True],
                         ids=["all_present", "stragglers"])
def test_majority_vote_matches_the_reference(method, with_present):
    rng = np.random.RandomState(3)
    n, r, d = 12, 4, 37
    jcode = jrep.build_repetition_code(n, r)
    code = repetition.build_repetition_code(n, r)
    for trial in range(6):
        rows = grouped_rows(rng, n, r, d)
        present = rng.rand(n) > 0.3 if with_present else None
        if with_present and trial == 0:
            present[:r] = False  # a whole group absent
        key = jax.random.key(trial)
        jv, jh = jrep.majority_vote(
            jcode, jnp.asarray(rows),
            present=None if present is None else jnp.asarray(present),
            key=key, method=method, with_health=True)
        tv, th = repetition.majority_vote(
            code, T(rows), None if present is None else T(present),
            key_salts(key), method, with_health=True)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6,
                                   atol=1e-7)
        assert float(th["vote_agree"]) == float(jh["vote_agree"])
        assert int(th["flagged_groups"]) == int(jh["flagged_groups"])
        np.testing.assert_array_equal(th["flagged"].numpy(),
                                      np.asarray(jh["flagged"]))


def test_absent_members_are_never_flagged():
    code = repetition.build_repetition_code(6, 3)
    rows = torch.randn(2, 5).repeat_interleave(3, 0)
    rows[1] = -rows[1]  # group 0: a dissenting present member
    rows[4] = 7.0  # group 1: a different row, but absent
    present = torch.tensor([1, 1, 1, 1, 0, 1], dtype=torch.bool)
    voted, h = repetition.majority_vote(code, rows, present,
                                        with_health=True)
    assert h["flagged"].tolist() == [False, True, False, False, False, False]
    assert int(h["flagged_groups"]) == 1
    assert float(h["vote_agree"]) == pytest.approx(4 / 5)
    torch.testing.assert_close(voted, (rows[0] + rows[3]) / 2)


# --------------------------------------------------------------------------
# the reference's cases (tests/test_repetition_and_aggregation.py)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    (9, 3, 40, "rev_grad", [0, 4, 8]), (6, 3, 8, "constant", [1, 5])],
    ids=["minority_rev_grad", "constant"])
def test_recovers_the_honest_mean(case):
    n, r, d, mode, bad = case
    rng = np.random.RandomState(4)
    code = repetition.build_repetition_code(n, r)
    honest = rng.randn(n // r, d).astype(np.float32)
    grads = np.repeat(honest, r, axis=0)
    adv = np.zeros(n, dtype=bool)
    adv[bad] = True
    g = attacks.inject_plain(T(grads), T(adv), mode)
    np.testing.assert_array_equal(
        g.numpy(), np.asarray(jax_inject(jnp.asarray(grads),
                                         jnp.asarray(adv), mode)))
    np.testing.assert_allclose(repetition.majority_vote(code, g).numpy(),
                               honest.mean(axis=0), rtol=1e-6)


def test_rejects_bad_group_size():
    with pytest.raises(ValueError):
        repetition.build_repetition_code(7, 3)
    with pytest.raises(ValueError, match="vote_check"):
        TrainConfig(network="ResNet18", approach="maj_vote", num_workers=9,
                    group_size=3, vote_check="sha256").validate()
    with pytest.raises(ValueError, match="fingerprint.*exact"):
        repetition.majority_vote(repetition.build_repetition_code(3, 3),
                                 torch.zeros(3, 4), method="boyer")


def test_vote_on_bfloat16_rows():
    rng = np.random.RandomState(5)
    n, r, d = 6, 3, 33
    code = repetition.build_repetition_code(n, r)
    honest = rng.randn(n // r, d).astype(np.float32)
    grads = T(np.repeat(honest, r, axis=0)).to(torch.bfloat16)
    grads[2] = -grads[2]
    out = repetition.majority_vote(code, grads)
    want = T(honest).to(torch.bfloat16).float().mean(0)
    torch.testing.assert_close(out.float(), want, rtol=2e-2, atol=1e-2)


def test_tiebreak_is_the_lowest_index():
    code = repetition.build_repetition_code(2, 2)
    rows = torch.stack([torch.full((5,), 7.0), torch.full((5,), -7.0)])
    for method in ("fingerprint", "exact"):
        assert torch.equal(repetition.majority_vote(code, rows, method=method),
                           rows[0])


def _fps(rows, salts=None):
    return vote.row_fingerprints(torch.from_numpy(rows), salts).numpy()


@pytest.mark.parametrize("pair", [(0, 1), (3, 40), (62, 63), (17, 18)])
def test_top_bit_pair_flip_does_not_collide(pair):
    i, j = pair
    rng = np.random.RandomState(6)
    bits = rng.randn(1, 64).astype(np.float32).view(np.uint32)
    forged = bits.copy()
    forged[0, i] ^= np.uint32(0x80000000)
    forged[0, j] ^= np.uint32(0x80000000)
    fp = _fps(np.concatenate([bits, forged]).view(np.float32))
    assert not np.array_equal(fp[0], fp[1])


@pytest.mark.parametrize("pair", [(0, 1), (5, 33), (46, 47)])
def test_position_swap_forgery_does_not_collide(pair):
    i, j = pair
    d = 48
    pos = ((np.arange(d, dtype=np.uint64) * 2654435761) % (1 << 32)).astype(
        np.uint32)
    rng = np.random.RandomState(7)
    bits = rng.randn(1, d).astype(np.float32).view(np.uint32)
    forged = bits.copy()
    forged[0, i] = bits[0, j] ^ pos[j] ^ pos[i]
    forged[0, j] = bits[0, i] ^ pos[i] ^ pos[j]
    both = np.concatenate([bits, forged]).view(np.float32)
    for salts in (None, key_salts(jax.random.key(7))):
        fp = _fps(both, salts)
        assert not np.array_equal(fp[0], fp[1])


def test_exact_matches_fingerprint_and_defeats_a_one_bit_forgery():
    rng = np.random.RandomState(8)
    n, r, d = 6, 3, 24
    code = repetition.build_repetition_code(n, r)
    grads = np.repeat(rng.randn(2, d).astype(np.float32), r, axis=0)
    adv = torch.zeros(n, dtype=torch.bool)
    adv[[1, 5]] = True
    g = attacks.inject_plain(T(grads), adv, "rev_grad")
    assert torch.equal(repetition.majority_vote(code, g),
                       repetition.majority_vote(code, g, method="exact"))
    forged = grads.copy()
    forged[0].view(np.uint32)[11] ^= np.uint32(1)
    for method in ("fingerprint", "exact"):
        assert torch.equal(
            repetition.majority_vote(code, T(forged), method=method),
            repetition.majority_vote(code, T(grads), method="exact"))


def test_forged_row_loses_under_fed_salts():
    rng = np.random.RandomState(9)
    code = repetition.build_repetition_code(3, 3)
    honest = rng.randn(1, 32).astype(np.float32)
    grads = np.repeat(honest, 3, axis=0)
    forged = grads[2].view(np.uint32).copy()
    forged[[5, 21]] ^= np.uint32(0x80000000)
    grads[2] = forged.view(np.float32)
    out = repetition.majority_vote(code, T(grads),
                                   salts=key_salts(jax.random.key(123)))
    np.testing.assert_allclose(out.numpy(), honest[0], rtol=1e-6)


def test_signed_zero_disagrees_and_nan_agrees():
    """The fingerprint compares bits: -0.0 against +0.0 is a dissent, a NaN
    row agrees with its bit-identical copies (the reference's docstring)."""
    code = repetition.build_repetition_code(3, 3)
    rows = torch.ones(3, 8)
    rows[2, 3] = -0.0
    rows[0, 3] = rows[1, 3] = 0.0
    _, h = repetition.majority_vote(code, rows, with_health=True)
    assert h["flagged"].tolist() == [False, False, True]
    rows = torch.full((3, 8), float("nan"))
    _, h = repetition.majority_vote(code, rows, with_health=True)
    assert float(h["vote_agree"]) == 1.0 and int(h["flagged_groups"]) == 0


def test_salts_change_fingerprints_but_not_the_vote():
    rng = np.random.RandomState(10)
    code = repetition.build_repetition_code(6, 3)
    grads = np.repeat(rng.randn(2, 16).astype(np.float32), 3, axis=0)
    a, b = (key_salts(jax.random.key(k)) for k in (0, 1))
    assert not np.array_equal(_fps(grads, a), _fps(grads, b))
    assert torch.equal(repetition.majority_vote(code, T(grads), salts=a),
                       repetition.majority_vote(code, T(grads), salts=b))
