"""The port's checkpoint format and host supervision against the
reference's (draco_tpu/utils/{compress,checkpoint}.py,
draco_tpu/resilience/supervisor.py), on small arrays; JAX only inside the
reference's own calls, seconds.

  compress     the port's numpy stream is the reference's (its native
               backend here) byte for byte, at zlib levels 0 and 1, for
               f32, bf16 (as uint16), int32, bool, 0-d and non-contiguous
               arrays, and each side inflates the other's
  container    a .dcg of the port's loads through the reference's
               ``load`` and the reverse; a flipped byte, a truncation and a
               torn header raise CheckpointCorruptError, a wrong leaf count
               or shape a plain ValueError, in both packages alike;
               ``verify``, ``gc_checkpoints`` (retain-last-N, never the
               newest) and ``available_steps`` as the reference's
  walk-back    a corrupt newest checkpoint is walked past; −1 on an empty
               dir raises FileNotFoundError, as the reference's
  supervision  ``SupervisedPrefetcher`` masks a transient failure of a real
               prefetcher and stops at its bound; ``GracefulStop``'s first
               signal asks, the second escalates, and ``shield`` holds the
               escalation until its block ends
"""

import os
import signal

import jax
import numpy as np
import pytest

from draco_tpu.resilience import supervisor as jsup
from draco_tpu.utils import checkpoint as jckpt
from draco_tpu.utils import compress as jcompress
from draco_tpu_torch.data.prefetch import TokenChunkPrefetcher
from draco_tpu_torch.resilience import supervisor as sup
from draco_tpu_torch.utils import checkpoint as ckpt
from draco_tpu_torch.utils import compress

_R = np.random.RandomState(0)
ARRAYS = {
    "f32": _R.randn(7, 5).astype(np.float32),
    "bf16_as_uint16": (_R.randn(33).astype(np.float32).view(np.uint32)
                       >> 16).astype(np.uint16),
    "int32": np.arange(-5, 6, dtype=np.int32),
    "bool": np.asarray(True),
    "scalar_f32": np.asarray(3.5, np.float32),
    "scalar_int32": np.asarray(12, np.int32),
    "noncontiguous": _R.randn(6, 8).astype(np.float32)[::2, 1::3].T,
    "empty": np.zeros((0, 3), np.float32),
}


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_compress_is_the_references_stream(name, level):
    a = ARRAYS[name]
    ours, ref = compress.compress(a, level), jcompress.compress(a, level)
    assert ours == ref
    for blob in (ours, ref):
        for unpack in (compress.decompress, jcompress.decompress):
            b = unpack(blob)
            assert b.dtype == a.dtype and b.shape == a.shape
            np.testing.assert_array_equal(b, a)


def _leaves():
    return [ARRAYS["f32"], ARRAYS["int32"], ARRAYS["bool"],
            ARRAYS["scalar_int32"]]


def _specs(leaves):
    return [ckpt.LeafSpec(a.shape, a.dtype) for a in leaves]


def _ref_abstract(leaves):
    return [jax.ShapeDtypeStruct(a.shape, a.dtype) for a in leaves]


@pytest.mark.parametrize("compress_ckpt", [False, True])
def test_the_container_loads_in_both_packages(tmp_path, compress_ckpt):
    d = str(tmp_path)
    leaves = _leaves()
    path = ckpt.save(d, 3, leaves, compress=compress_ckpt)
    assert path.endswith("model_step_3.dcg") and os.path.isfile(
        path + ".sha256")
    for got in (jckpt.load(d, 3, _ref_abstract(leaves)),
                ckpt.load(d, 3, _specs(leaves))):
        for a, b in zip(leaves, got):
            assert np.asarray(b).dtype == a.dtype
            np.testing.assert_array_equal(np.asarray(b), a)
    jckpt.save(d, 4, leaves, compress=True)
    for a, b in zip(leaves, ckpt.load(d, 4, _specs(leaves))):
        np.testing.assert_array_equal(b, a)
    # the same leaves at level 1 are the reference's file byte for byte
    if compress_ckpt:
        assert open(path, "rb").read() == open(
            os.path.join(d, "model_step_4.dcg"), "rb").read()
    assert ckpt.available_steps(d) == jckpt.available_steps(d) == [3, 4]
    assert ckpt.exists(d, 4) and not ckpt.exists(d, 5)
    assert ckpt.available_steps(str(tmp_path / "none")) == []


def _tear(path, how):
    raw = bytearray(open(path, "rb").read())
    if how == "flip":
        raw[-5] ^= 0xFF
    elif how == "truncate":
        raw = raw[:len(raw) // 2]
    elif how == "torn_header":
        raw[0] ^= 0xFF
        os.remove(path + ".sha256")  # a sidecar-less checkpoint
    open(path, "wb").write(bytes(raw))


@pytest.mark.parametrize("how", ["flip", "truncate", "torn_header"])
def test_torn_bytes_are_corrupt_in_both_packages(tmp_path, how):
    d = str(tmp_path)
    leaves = _leaves()
    _tear(ckpt.save(d, 1, leaves, compress=True), how)
    with pytest.raises(ckpt.CheckpointCorruptError) as ours:
        ckpt.load(d, 1, _specs(leaves))
    with pytest.raises(jckpt.CheckpointCorruptError) as ref:
        jckpt.load(d, 1, _ref_abstract(leaves))
    assert ours.value.reason == ref.value.reason
    for verify in (ckpt.verify, jckpt.verify):
        with pytest.raises(ValueError, match="corrupt checkpoint"):
            verify(d, 1)


@pytest.mark.parametrize("change", ["count", "shape", "dtype"])
def test_structural_mismatch_is_a_plain_value_error(tmp_path, change):
    d = str(tmp_path)
    leaves = _leaves()
    ckpt.save(d, 1, leaves)
    wrong = list(leaves)
    if change == "count":
        wrong = wrong[:-1]
    elif change == "shape":
        wrong[0] = np.zeros((5, 7), np.float32)
    else:
        wrong[1] = wrong[1].astype(np.int64)
    for load, specs in ((ckpt.load, _specs(wrong)),
                        (jckpt.load, _ref_abstract(wrong))):
        with pytest.raises(ValueError) as e:
            load(d, 1, specs)
        assert not isinstance(e.value, (ckpt.CheckpointCorruptError,
                                        jckpt.CheckpointCorruptError))
    ckpt.verify(d, 1)  # the bytes are sound


def test_a_missing_step_and_an_orbax_directory(tmp_path):
    d = str(tmp_path)
    with pytest.raises(FileNotFoundError):
        ckpt.load(d, 2, _specs(_leaves()))
    os.makedirs(os.path.join(d, "model_step_2"))
    assert ckpt.exists(d, 2) and ckpt.available_steps(d) == [2]
    with pytest.raises(ValueError, match="Orbax"):
        ckpt.load(d, 2, _specs(_leaves()))


def test_keep_checkpoints_gc_as_the_reference(tmp_path):
    leaves = _leaves()
    dirs = {p: str(tmp_path / p) for p in ("port", "ref")}
    for pkg, save, gc in (("port", ckpt.save, ckpt.gc_checkpoints),
                          ("ref", jckpt.save, jckpt.gc_checkpoints)):
        d = dirs[pkg]
        for step in (1, 2, 3):
            save(d, step, leaves, compress=True)  # keep=0: all stay
        assert ckpt.available_steps(d) == [1, 2, 3]
        save(d, 4, leaves, compress=True, keep=2)
        assert ckpt.available_steps(d) == [3, 4]
        assert not os.path.exists(os.path.join(d, "model_step_1.dcg.sha256"))
        save(d, 5, leaves, compress=True, keep=1)  # never the newest
        assert ckpt.available_steps(d) == [5]
        assert gc(d, 0) == [] and gc(d, 1) == []
    assert sorted(os.listdir(dirs["port"])) == sorted(os.listdir(dirs["ref"]))


def test_walkback_skips_a_corrupt_newest(tmp_path):
    d = str(tmp_path)
    old = _leaves()
    new = [a + 1 if a.dtype.kind in "fi" else a for a in old]
    ckpt.save(d, 2, old)
    _tear(ckpt.save(d, 4, new), "flip")
    for walk, specs in ((sup.restore_with_walkback, _specs(old)),
                        (jsup.restore_with_walkback, _ref_abstract(old))):
        got, step, skipped = walk(d, -1, specs)
        assert step == 2 and [s for s, _ in skipped] == [4]
        np.testing.assert_array_equal(np.asarray(got[0]), old[0])
    # an explicit step walks back from there too
    assert sup.restore_with_walkback(d, 4, _specs(old))[1] == 2
    # nothing loadable: the corruption propagates
    _tear(os.path.join(d, "model_step_2.dcg"), "flip")
    with pytest.raises(ckpt.CheckpointCorruptError):
        sup.restore_with_walkback(d, -1, _specs(old))
    # a structural error is not walked past
    ckpt.save(d, 6, old)
    with pytest.raises(ValueError, match="arrays"):
        sup.restore_with_walkback(d, -1, _specs(old[:2]))
    for walk in (sup.restore_with_walkback, jsup.restore_with_walkback):
        with pytest.raises(FileNotFoundError):
            walk(str(tmp_path / "empty"), -1, _specs(old))


class _Flaky(TokenChunkPrefetcher):
    """A real token prefetcher whose worker fails on the first
    ``fails`` assemblies across all instances."""

    fails = 0
    built = 0

    def __init__(self):
        type(self).built += 1
        super().__init__(self._gen, timeout_s=5.0)

    @classmethod
    def _gen(cls, step):
        if cls.fails > 0:
            cls.fails -= 1
            raise RuntimeError(f"transient at step {step}")
        return np.full((2, 3), step, np.int32)


def test_supervised_prefetcher_masks_then_bounds():
    _Flaky.fails, _Flaky.built = 2, 0
    p = sup.SupervisedPrefetcher(_Flaky, restarts=3, backoff_s=0.001)
    try:
        np.testing.assert_array_equal(p.get((4, 2), (6, 2))[:, 0, 0], [4, 5])
        np.testing.assert_array_equal(p.get((6, 2))[:, 0, 0], [6, 7])
    finally:
        p.close()
    assert p.restarts_used == 2 and _Flaky.built == 3
    assert p.stats() == {"prefetch_restarts": 2}
    _Flaky.fails, _Flaky.built = 2, 0
    bounded = sup.SupervisedPrefetcher(_Flaky, restarts=1, backoff_s=0.001)
    with pytest.raises(RuntimeError, match="transient"):
        bounded.get((1, 1))
    bounded.close()
    assert bounded.restarts_used == 1


def test_graceful_stop_asks_then_escalates():
    stop = sup.GracefulStop()  # not entered: the flag path
    assert not sup.stop_requested(stop, None, 3)
    stop.deliver_signal(signal.SIGTERM)
    assert sup.stop_requested(stop, None, 3) and stop.signame == "SIGTERM"
    with pytest.raises(sup.ImmediateStopError):
        stop.deliver_signal(signal.SIGTERM)
    assert stop.escalated
    assert not sup.stop_requested(None, None, 3)


def test_graceful_stop_real_handlers_and_the_shield():
    before = signal.getsignal(signal.SIGTERM)
    with sup.GracefulStop() as stop:
        assert stop.installed == (
            __import__("threading").current_thread()
            is __import__("threading").main_thread())
        stop.deliver_signal(signal.SIGTERM)
        assert stop.requested
        ran = []
        with pytest.raises(sup.ImmediateStopError):
            with stop.shield():
                stop.deliver_signal(signal.SIGTERM)
                ran.append("the rest of the block")
        assert ran == ["the rest of the block"] and stop.escalated
    assert signal.getsignal(signal.SIGTERM) == before
