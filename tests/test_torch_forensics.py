"""The port's packed forensics columns and accusation ledger
(``draco_tpu_torch/obs/forensics.py``) against the JAX package's
(``draco_tpu/obs/forensics.py``), inputs from numpy seeds:

  * ``pack_bits`` word for word the reference's at n = 1, 8, 32, 33 and 64
    (random masks, all-set and all-clear), ``unpack_bits`` and
    ``record_masks`` its inverse as the reference's;
  * ``pack_mask_columns`` the reference's, an absent worker never accused;
  * a word that is a signalling NaN as a float32 — workers 23–30 accused,
    22 clear — through ``training/step.metrics_row``, an eager record
    (``record_value``) and a CPU chunk's flush (``StepGraph`` and
    ``DeferredMetricWriter``) unchanged, where a float conversion would
    have set bit 22;
  * ``AccusationLedger``'s summary, worker rows and episodes equal the
    reference's over the same records (absences, episodes that close and
    stay open, ``forgive``);
  * ``nonfinite_rows`` the reference's on rows with a NaN, an Inf and
    (n, hat_s, d) lanes; the observatory's wrappers refuse other devices.

Everything here is integer and boolean: equality is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from draco_tpu.obs import forensics as ref
from draco_tpu_torch.obs import forensics as port
from draco_tpu_torch.ops import numerics as ops_numerics
from draco_tpu_torch.training.chunk_graph import Chunk, StepGraph
from draco_tpu_torch.training.step import metrics_row
from draco_tpu_torch.utils.metrics import (
    DeferredMetricWriter,
    MetricWriter,
    host_rows,
)

SEED = 428
# workers 23..30 accused and 22 clear: the word's bits 23-30 are set and
# bit 22 is clear, a signalling NaN as a float32
SNAN_WORKERS = list(range(23, 31)) + [0, 5]
SNAN_WORD = sum(1 << w for w in SNAN_WORKERS)


def _ref_words(mask: np.ndarray) -> list:
    packed = np.asarray(ref.pack_bits(jnp.asarray(mask)))
    return packed.view(np.uint32).tolist()


def _port_words(mask: np.ndarray) -> list:
    packed = port.pack_bits(torch.from_numpy(mask))
    return [w & 0xFFFFFFFF for w in packed.view(torch.int32).tolist()]


def _masks(n: int):
    rs = np.random.RandomState(SEED + n)
    yield np.zeros(n, bool)
    yield np.ones(n, bool)
    for _ in range(3):
        yield rs.rand(n) < 0.5


@pytest.mark.parametrize("n", [1, 8, 32, 33, 64])
def test_pack_bits_word_for_word(n):
    assert port.num_mask_words(n) == ref.num_mask_words(n)
    assert port.mask_metric_names(n) == ref.mask_metric_names(n)
    for mask in _masks(n):
        words = _port_words(mask)
        assert words == _ref_words(mask)
        assert port.unpack_bits(words, n) == ref.unpack_bits(words, n)
        assert port.unpack_bits(words, n) == tuple(bool(b) for b in mask)


def test_mask_bounds_and_names():
    for bad in (0, 65):
        with pytest.raises(ValueError):
            port.num_mask_words(bad)
    assert port.is_mask_column("wmask_adv1")
    assert not port.is_mask_column("det_adv")


@pytest.mark.parametrize("n", [5, 33])
def test_pack_mask_columns_as_the_reference(n):
    rs = np.random.RandomState(SEED)
    acc, pres, adv = (rs.rand(3, n) < 0.5)
    for present in (pres, None):
        mine = port.pack_mask_columns(
            torch.from_numpy(acc),
            None if present is None else torch.from_numpy(present),
            torch.from_numpy(adv))
        theirs = ref.pack_mask_columns(
            jnp.asarray(acc), None if present is None else
            jnp.asarray(present), jnp.asarray(adv))
        assert list(mine) == list(theirs) == list(ref.mask_metric_names(n))
        for k in mine:
            assert (port.record_value(k, mine[k])
                    == ref.record_value(k, np.asarray(theirs[k]))), k
        record = {k: port.record_value(k, v) for k, v in mine.items()}
        masks = port.record_masks(record, n)
        assert masks == ref.record_masks(record, n)
        gate = np.ones(n, bool) if present is None else present
        assert masks["accused"] == tuple(bool(a) for a in acc & gate)


def test_the_signalling_nan_word_survives_to_the_records():
    mask = np.zeros(32, bool)
    mask[SNAN_WORKERS] = True
    word = port.pack_bits(torch.from_numpy(mask))[0]
    assert _port_words(mask) == _ref_words(mask) == [SNAN_WORD]
    bits = int(word.view(torch.int32)) & 0xFFFFFFFF
    assert bits == SNAN_WORD and not bits & (1 << 22)
    # a float's round trip quiets it: bit 22, worker 22, appears
    assert (int(np.float32(float(word)).view(np.uint32))
            == SNAN_WORD | (1 << 22))
    names = ("loss", "wmask_accused0", "wmask_present0")
    metrics = {"loss": torch.tensor(0.5), "wmask_accused0": word,
               "wmask_present0": port.pack_bits(torch.ones(32,
                                                           dtype=bool))[0]}
    # the step's metric row, then an eager record
    row = metrics_row(metrics, names)
    assert port.record_value("wmask_accused0", row[1]) == SNAN_WORD
    assert port.record_value("wmask_accused0", word) == SNAN_WORD
    assert port.record_value("wmask_present0", row[2]) == 0xFFFFFFFF
    # a CPU chunk (the step graph's rows) and the deferred flush
    graph = StepGraph("snan", torch.device("cpu"), 2, names,
                      lambda inputs: metrics_row(metrics, names), dict)
    block = graph.run(Chunk(1, 2, {"x": torch.zeros(2, 1)}))
    seen = []
    deferred = DeferredMetricWriter(MetricWriter("", quiet=True),
                                    observer=seen.append)
    deferred.defer([1, 2], names, block)
    last = deferred.flush()
    assert [r["wmask_accused0"] for r in seen] == [SNAN_WORD] * 2
    assert last["wmask_present0"] == 0xFFFFFFFF
    assert host_rows(block, names)[0][1] == SNAN_WORD
    masks = port.record_masks(last, 32)
    assert [w for w in range(32) if masks["accused"][w]] == sorted(
        SNAN_WORKERS)


def _records(n: int, steps: int, seed: int):
    """Records as a loop materialises them: an adversary on workers 1 and
    4 in runs, honest accusations now and then, absences."""
    rs = np.random.RandomState(seed)
    out = []
    for t in range(1, steps + 1):
        adv = np.zeros(n, bool)
        adv[[1, 4]] = (t % 7) < 4
        present = rs.rand(n) > 0.15
        accused = (adv & (rs.rand(n) < 0.9)) | (rs.rand(n) < 0.05)
        cols = port.pack_mask_columns(torch.from_numpy(accused),
                                      torch.from_numpy(present),
                                      torch.from_numpy(adv))
        rec = {"step": t, "loss": 1.0}
        rec.update({k: port.record_value(k, v) for k, v in cols.items()})
        out.append(rec)
    # a record without forensics columns (an eval record) is ignored
    out.insert(5, {"step": 5, "split": "eval", "loss": 0.3})
    return out


@pytest.mark.parametrize("n", [8, 40])
def test_accusation_ledger_as_the_reference(n):
    recs = _records(n, 40, SEED + n)
    mine, theirs = port.AccusationLedger(n), ref.AccusationLedger(n)
    for r in recs:
        assert mine.observe(r) == theirs.observe(r)
        if r["step"] == 20:
            mine.forgive(1)
            theirs.forgive(1)
    assert mine.steps == theirs.steps == 40
    assert mine.to_dict() == theirs.to_dict()
    assert mine.summary(top=5) == theirs.summary(top=5)
    assert mine.open_episodes() == theirs.open_episodes()
    assert mine.to_dict()["summary"]["accused_total"] > 0


def test_nonfinite_rows_as_the_reference():
    rs = np.random.RandomState(SEED)
    for shape in ((6, 50), (5, 3, 40)):
        g = rs.randn(*shape).astype(np.float32)
        g.reshape(shape[0], -1)[2, 7] = np.nan
        g.reshape(shape[0], -1)[4, -1] = -np.inf
        mine = port.nonfinite_rows(torch.from_numpy(g))
        assert mine.dtype == torch.bool
        assert mine.tolist() == np.asarray(
            ref.nonfinite_rows(jnp.asarray(g))).tolist()
        assert mine.tolist() == [False, False, True, False, True] + (
            [False] if shape[0] == 6 else [])


def test_the_wrappers_refuse_other_devices():
    meta = torch.empty((2, 3), device="meta")
    with pytest.raises(ValueError):
        ops_numerics.nonfinite_rows(meta)
    with pytest.raises(ValueError):
        ops_numerics.stage_stats([meta], 4)
