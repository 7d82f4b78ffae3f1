"""The port's robust aggregation rules (``draco_tpu_torch.aggregation``)
and its alie / ipm attacks against the JAX package's on the CPU.

Tolerances. Krum selects one row: on inputs whose scores are well
separated the selected row must be the reference's bit for bit. The other
rules are f32 sums, sorts and Gram products in another order: 1e-6
relative, and 1e-7 of the rows' largest magnitude absolute (a mean over a
row scaled by -100 cancels). The attacks build their payload from the
honest rows' mean and standard deviation: the same tolerance.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from draco_tpu import aggregation as jagg
from draco_tpu import attacks as jattacks
from draco_tpu_torch import aggregation, attacks

T = torch.from_numpy
MODES = ("normal", "geometric_median", "krum", "coord_median",
         "trimmed_mean", "multi_krum", "bulyan")
PRESENT = np.array([1, 1, 0, 1, 1, 1, 0, 1, 1, 1], bool)


def rows(seed=0, n=10, d=61):
    """n rows around a common centre, two of them Byzantine (scaled -100
    and shifted), so the Krum scores are far apart."""
    rng = np.random.RandomState(seed)
    g = (1.0 + 0.3 * rng.normal(size=(n, d))).astype(np.float32)
    g[3] *= -100.0
    g[7] += 50.0
    return g


def close(out, ref, g):
    np.testing.assert_allclose(out, ref, rtol=1e-6,
                               atol=1e-7 * np.nanmax(np.abs(g[np.isfinite(g)])))


def both(g, mode, present=None, s=2):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = jagg.aggregate(jnp.asarray(g), mode, s=s, geomedian_iters=12,
                             present=None if present is None
                             else jnp.asarray(present))
        out = aggregation.aggregate(T(g), mode, s, 12,
                                    None if present is None else T(present))
    return out.numpy(), np.asarray(ref)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("with_present", [False, True],
                         ids=["all_present", "stragglers"])
def test_rules_match_the_reference(mode, with_present):
    for seed in range(3):
        g = rows(seed)
        out, ref = both(g, mode, PRESENT if with_present else None)
        if mode == "krum":
            np.testing.assert_array_equal(out, ref)
            assert any(np.array_equal(out, r) for r in g)
        else:
            close(out, ref, g)
        assert np.isfinite(out).all()


@pytest.mark.parametrize("mode", MODES)
def test_an_absent_rows_payload_never_matters(mode):
    g = rows(4)
    poisoned = g.copy()
    poisoned[2] = np.nan
    poisoned[6] = np.inf
    out, ref = both(poisoned, mode, PRESENT)
    clean, _ = both(g, mode, PRESENT)
    np.testing.assert_array_equal(out, clean)
    close(out, ref, g)


@pytest.mark.parametrize("mode", ["krum", "multi_krum", "bulyan",
                                  "coord_median", "trimmed_mean"])
@pytest.mark.parametrize("bad", ["nan", "inf"])
def test_non_finite_rows(mode, bad):
    """A present row with a non-finite entry: the Krum family never selects
    it (finite-row masking, bounded penalty); the masked median and the
    trimmed mean order it last; the unmasked median of a NaN coordinate is
    NaN, as ``jnp.median``'s."""
    g = rows(5)
    g[3, 10] = np.nan if bad == "nan" else np.inf
    for present in (None, PRESENT):
        out, ref = both(g, mode, present)
        close(out, ref, g)
        nan_median = (mode == "coord_median" and bad == "nan"
                      and present is None)
        assert np.isfinite(np.delete(out, 10)).all()
        assert np.isnan(out[10]) == nan_median


def test_krum_scores_match_the_reference():
    g = rows(6)
    for present in (None, PRESENT):
        ref = np.asarray(jagg._krum_scores(
            jnp.asarray(g), 2, None if present is None
            else jnp.asarray(present)))
        out = aggregation._krum_scores(
            T(g), 2, None if present is None else T(present)).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-5)
        assert np.array_equal(np.isinf(out), np.isinf(ref))


def test_median_of_an_even_count_averages_the_middle_pair():
    g = T(np.array([[1.0], [2.0], [10.0], [20.0]], np.float32))
    assert aggregation.coordinate_median(g).item() == 6.0
    assert aggregation.coordinate_median(
        g, torch.tensor([True, True, True, False])).item() == 2.0


def test_rules_refuse_too_few_rows():
    g = torch.zeros(4, 3)
    for fn in (aggregation.krum, aggregation.multi_krum):
        with pytest.raises(ValueError, match="n >= s\\+3"):
            fn(g, 2)
    with pytest.raises(ValueError, match="n > 2s"):
        aggregation.trimmed_mean(g, 2)
    with pytest.raises(ValueError, match="bulyan requires"):
        aggregation.bulyan(g, 2)
    with pytest.raises(ValueError, match="unknown aggregation mode"):
        aggregation.aggregate(g, "median_of_means")


def test_bulyan_warns_below_4s_plus_3():
    g = T(rows(7))
    with pytest.warns(UserWarning, match="4s\\+3"):
        aggregation.bulyan(g, 2)  # n=10 < 11
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        aggregation.bulyan(g, 1)  # n=10 >= 7


@pytest.mark.parametrize("mode", ["alie", "ipm"])
@pytest.mark.parametrize("magnitude", [-100.0, 50.0, -7.5])
@pytest.mark.parametrize("n_mal", [1, 2, 4])
def test_alie_and_ipm_match_the_reference(mode, magnitude, n_mal):
    rng = np.random.RandomState(8)
    g = rng.normal(size=(9, 57)).astype(np.float32)
    mask = np.zeros(9, bool)
    mask[[2, 5, 6, 8][:max(n_mal, 1)]] = True
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = np.asarray(jattacks.inject_plain(
            jnp.asarray(g), jnp.asarray(mask), mode, magnitude, n_mal=n_mal))
        out = attacks.inject_plain(T(g), T(mask), mode, magnitude,
                                   n_mal=n_mal).numpy()
    close(out, ref, g)
    np.testing.assert_array_equal(out[~mask], g[~mask])
    # the sign of the magnitude is ignored: both fix their own direction
    flipped = attacks.inject_plain(T(g), T(mask), mode, -magnitude,
                                   n_mal=n_mal).numpy()
    np.testing.assert_array_equal(flipped, out)


def test_alie_warns_once_when_inert():
    attacks._ALIE_INERT_WARNED.discard((9, 1))
    g, mask = torch.randn(9, 5), torch.zeros(9, dtype=torch.bool)
    mask[0] = True
    with pytest.warns(UserWarning, match="alie is inert"):
        attacks.inject_plain(g, mask, "alie", n_mal=1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        attacks.inject_plain(g, mask, "alie", n_mal=1)
    assert attacks._alie_z(9, 1) == jattacks._alie_z(9, 1)
    assert attacks._alie_z(50, 12) == jattacks._alie_z(50, 12) > 0
