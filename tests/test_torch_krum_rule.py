"""The rule ``chip_smoke.py`` holds Krum's default-cuDNN chunk to
(``krum_pick_rule``): where the chunk picks the eager run's rows, its
update keeps its bound; where a pick differs, the two rows' scores must tie
within the scores' run-to-run spread at that step. Held here on a
constructed near-tie and a clear margin, with the scores a graph-safe
device counter records (``KrumScores``) read back in order, and the
losses' run-to-run spread (``loss_spread``) printed beside the loss
bound."""

import numpy as np
import pytest
import torch

import chip_smoke
from draco_tpu_torch import aggregation


def _runs(noise: float, seed: int = 0, steps: int = 4, n: int = 8):
    """Four runs' (steps, n) scores: one base draw, each run moved by
    ``noise`` at most."""
    rs = np.random.RandomState(seed)
    base = 100.0 + 10.0 * rs.rand(steps, n)
    return [base + noise * (2 * rs.rand(steps, n) - 1) for _ in range(4)]


def test_picks_that_agree_keep_the_update_bound():
    runs = _runs(1e-6)
    rule = chip_smoke.krum_pick_rule(runs[0], runs[2], runs)
    assert rule["agree"] is True
    assert rule["picks_eager"] == rule["picks_chunk"]
    assert "tie" not in rule


def test_a_near_tie_inside_the_spread_is_a_tie():
    runs = _runs(1e-3)
    eager, chunk = runs[0], runs[2]
    # step 2: rows 3 and 5 lead, 4e-4 apart; the chunk's noise swaps them
    eager[1, 3], eager[1, 5] = 50.0, 50.0004
    chunk[1, 3], chunk[1, 5] = 50.0006, 50.0001
    rule = chip_smoke.krum_pick_rule(eager, chunk, runs)
    assert rule["agree"] is False and rule["step"] == 1
    assert rule["rows"] == [3, 5]
    assert rule["gap"] == pytest.approx(4e-4)
    # the spread is read off the other rows only, never the pair's own
    others = [i for i in range(8) if i not in (3, 5)]
    at = np.stack([r[1] for r in runs])[:, others]
    assert rule["spread"] == (at.max(0) - at.min(0)).max()
    assert 4e-4 <= rule["spread"]
    assert rule["tie"] is True


def test_a_gap_past_the_spread_is_not_a_tie():
    runs = _runs(1e-3)
    eager, chunk = runs[0], runs[2]
    others = [i for i in range(8) if i not in (3, 5)]
    spread = (np.stack([r[1] for r in runs])[:, others].max(0)
              - np.stack([r[1] for r in runs])[:, others].min(0)).max()
    # step 2: rows 3 and 5 apart by 1.5 times the other rows' spread
    eager[1, 3], eager[1, 5] = 50.0, 50.0 + 1.5 * spread
    chunk[1, 3], chunk[1, 5] = 50.1, 50.0
    rule = chip_smoke.krum_pick_rule(eager, chunk, runs)
    assert rule["rows"] == [3, 5] and rule["spread"] == spread
    assert rule["tie"] is False
    with pytest.raises(chip_smoke.SmokeFailure, match="more than the"):
        chip_smoke.krum_held("krum", "chunk", rule)


def test_a_clear_margin_is_not_a_tie():
    runs = _runs(1e-6)
    eager, chunk = runs[0], runs[2]
    eager[0, 2], eager[0, 6] = 40.0, 45.0  # row 2 leads by 5.0
    chunk[0, 2], chunk[0, 6] = 46.0, 45.0
    rule = chip_smoke.krum_pick_rule(eager, chunk, runs)
    assert rule["agree"] is False and rule["step"] == 0
    assert rule["rows"] == [2, 6] and rule["gap"] == 5.0
    assert rule["spread"] <= 2e-6
    assert rule["tie"] is False
    with pytest.raises(chip_smoke.SmokeFailure, match="more than the"):
        chip_smoke.krum_held("krum", "chunk", rule)


def test_the_score_watch_records_each_call_in_order():
    g = torch.Generator().manual_seed(3)
    grads = [torch.randn(8, 16, generator=g) for _ in range(5)]
    orig = aggregation._krum_scores
    watch = chip_smoke.KrumScores(8, torch.device("cpu"), slots=4)
    with watch:
        for x in grads:
            aggregation.krum(x, 1)
    want = np.stack([aggregation._krum_scores(x, 1).double().numpy()
                     for x in grads])
    # five calls into four slots: the last four, oldest first
    np.testing.assert_array_equal(watch.take(4), want[1:])
    assert int(watch.count) == 0
    assert aggregation._krum_scores is orig  # the wrap is undone
    with watch:
        aggregation.krum(grads[0], 1)
    np.testing.assert_array_equal(watch.take(1), want[:1])


def test_the_losses_spread_is_the_largest_relative_move():
    a = [{"loss": 2.0}, {"loss": 1.0}]
    b = [{"loss": 2.0}, {"loss": 1.0002}]
    c = [{"loss": 2.0006}, {"loss": 1.0}]
    assert chip_smoke.loss_spread([a, b]) == pytest.approx(2e-4)
    assert chip_smoke.loss_spread([a, b], [a, c]) == pytest.approx(3e-4)
    assert chip_smoke.loss_spread([a, a]) == 0.0
