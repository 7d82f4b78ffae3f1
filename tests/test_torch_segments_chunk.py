"""The segmented wire and the per-layer decode on the LM step, as a chunk,
on the vote, and in the configuration, on the CPU.

* One coded LM step (sp=1, ``LM_CI`` size: dim 64, 2 layers, T=32, n=8,
  s=1, a rev_grad adversary) at ``decode_granularity="layer"`` with
  ``wire_segments=2`` against the JAX package's (``test_torch_lm_step``'s
  harness and tolerances: discrete columns equal, loss 1e-4 relative, the
  update 1e-2 relative L2, the residual below 1e-4 on both).
* The K=2 chunk bit for bit its eager steps (``test_torch_chunk``'s
  harness): the ResNet-18 ``shared_int8_seg4`` and ``shared_layer`` legs at
  the registry's CI size, and the LM at layer granularity with segments.
* ``maj_vote`` at ``wire_segments=4`` bit for bit its S = 1 step: the vote
  is row-wise, the segments cut the wire only.
* ``config.validate`` accepts and rejects the two options where the
  reference does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from draco_tpu.config import TrainConfig as JaxConfig
from draco_tpu.parallel.mesh import make_mesh_2d
from draco_tpu.parallel.sp_step import build_sp_train_setup as jax_setup
from draco_tpu_torch import params as params_mod
from draco_tpu_torch import rng
from draco_tpu_torch.analysis import registry
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.data import datasets
from draco_tpu_torch.parallel.sp_step import build_sp_train_setup
from draco_tpu_torch.parallel.sp_step import synthetic_text
from draco_tpu_torch.training.trainer import Trainer
from test_torch_chunk import assert_chunk_equals_eager, lm_build, lm_chunk
from test_torch_chunk_cnn import cnn_chunk

torch.set_num_threads(1)

SEED = 428
LM = dict(network="TransformerLM", dataset="synthetic-text", lr=0.01,
          momentum=0.9, num_workers=8, worker_fail=1, err_mode="rev_grad",
          batch_size=2, seq_len=32, vocab=64, model_dim=64, model_heads=4,
          model_layers=2, max_steps=3, train_dir="", seed=SEED,
          approach="cyclic", redundancy="shared",
          decode_granularity="layer", wire_segments=2)
RANGES = [(1, 2), (3, 2)]  # two chunks of K=2 (the LM)
CNN_RANGES = [(1, 2)]  # one chunk of K=2 (ResNet-18: seconds a step)


@pytest.fixture(scope="module")
def ds():
    return datasets.load_dataset("synthetic-cifar10", synthetic_train=256,
                                 synthetic_test=16)


def test_lm_layer_segments_step_matches_the_reference():
    jset = jax_setup(JaxConfig(eval_freq=0, log_every=1000, **LM),
                     make_mesh_2d(1, 1))
    init, _ = params_mod.from_jax(jax.device_get(jset.state.params))
    tset = build_sp_train_setup(TrainConfig(**LM), device="cpu", init=init)
    lay = tset.layout
    assert tset.dim == jset.dim
    adv = rng.adversary_schedule(SEED, LM["max_steps"], 8, 1)
    toks = synthetic_text(SEED, 1, 8, 2, 32, 64)
    jstate, jm = jset.train_step(jset.state, jnp.asarray(toks),
                                 jnp.asarray(adv[1]))
    tstate, tm = tset.train_step(tset.state, toks, adv[1])
    port = {k: float(v) for k, v in tm.items()}
    ref = {k: float(jm[k]) for k in tset.metric_names}
    assert port["loss"] == pytest.approx(ref["loss"], rel=1e-4)
    for k in ("located_errors", "det_tp", "det_adv"):
        assert port[k] == ref[k] == 1, k
    assert port["honest_located"] == 6
    assert port["decode_residual"] < 1e-4 and ref["decode_residual"] < 1e-4
    before = params_mod.flatten(init, lay).numpy()
    jp, _ = params_mod.from_jax(jax.device_get(jstate.params))
    d_port = params_mod.flatten(tstate.params, lay).numpy() - before
    d_jax = params_mod.flatten(jp, lay).numpy() - before
    assert np.linalg.norm(d_jax) > 0
    assert np.linalg.norm(d_port - d_jax) <= 1e-2 * np.linalg.norm(d_jax)


def _cnn_build(leg, ds):
    def build():
        cfg = registry.get(leg).config(False, max_steps=3, steps_per_call=2)
        tr = Trainer(cfg, device="cpu", dataset=ds, quiet=True)
        return tr.setup, tr
    return build


@pytest.mark.parametrize("leg", ["shared_int8_seg4", "shared_layer"])
def test_cnn_chunk_equals_eager_steps(ds, leg):
    assert_chunk_equals_eager(_cnn_build(leg, ds), cnn_chunk, CNN_RANGES)


def test_lm_chunk_equals_eager_steps():
    assert_chunk_equals_eager(
        lm_build(dict(LM, steps_per_call=2, max_steps=5)), lm_chunk, RANGES)


def test_maj_vote_segments_change_nothing(ds):
    """The vote at S = 4: the same record and parameters, bit for bit, as
    at S = 1."""
    runs = []
    for segments in (1, 4):
        cfg = registry.get("majvote").config(False, max_steps=2,
                                             wire_segments=segments)
        tr = Trainer(cfg, device="cpu", dataset=ds, quiet=True)
        rec = tr.step()
        runs.append((rec, {k: v.clone() for k, v in
                           tr.state.tensors().items()}))
    (r1, s1), (r4, s4) = runs
    assert {k: v for k, v in r1.items() if k != "step_ms"} == \
        {k: v for k, v in r4.items() if k != "step_ms"}
    assert s1.keys() == s4.keys()
    for k in s1:
        assert torch.equal(_bits(s1[k]), _bits(s4[k])), k


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


CNN = dict(network="ResNet18", dataset="synthetic-cifar10", num_workers=8,
           worker_fail=1, err_mode="rev_grad", lr=0.01, momentum=0.9,
           max_steps=3, train_dir="", seed=SEED)
APPROX = dict(CNN, approach="approx", redundancy="shared", worker_fail=0,
              straggle_mode="drop", straggle_count=2)
CYCLIC = dict(CNN, approach="cyclic", redundancy="shared")


@pytest.mark.parametrize("kw", [
    dict(CYCLIC, wire_segments=0),
    dict(CYCLIC, approach="baseline", wire_segments=2),
    dict(CYCLIC, approach="baseline", mode="krum", wire_segments=4),
    dict(CYCLIC, decode_granularity="channel"),
    dict(LM, approach="baseline", wire_segments=2),
], ids=["segments_0", "baseline_segments", "krum_segments",
        "unknown_granularity", "lm_baseline_segments"])
def test_rejected_where_the_reference_rejects(kw):
    with pytest.raises(ValueError):
        TrainConfig(**kw).validate()
    with pytest.raises(ValueError):
        JaxConfig(**kw).validate()


@pytest.mark.parametrize("kw", [
    dict(CYCLIC, wire_segments=4),
    dict(CYCLIC, wire_segments=4, wire_dtype="int8"),
    dict(CYCLIC, wire_segments=3, wire_dtype="bf16",
         decode_granularity="layer"),
    dict(CYCLIC, decode_granularity="layer", redundancy="simulate"),
    dict(APPROX, wire_segments=4, wire_dtype="int8"),
    dict(APPROX, decode_granularity="layer"),
    dict(CNN, approach="maj_vote", num_workers=9, group_size=3,
         wire_segments=4),
    dict(CNN, approach="baseline", decode_granularity="layer"),
    LM,
    dict(LM, wire_segments=1),
], ids=["cyclic_seg4", "cyclic_int8_seg4", "cyclic_bf16_layer_seg3",
        "simulate_layer", "approx_int8_seg4", "approx_layer",
        "majvote_seg4", "baseline_layer", "lm_layer_seg2", "lm_layer"])
def test_accepted_where_the_reference_accepts(kw):
    TrainConfig(**kw).validate()
    JaxConfig(**kw).validate()


@pytest.mark.parametrize("segments", [1, 2])
def test_dispatch_spans_carry_the_segment_count(tmp_path, segments):
    """The loop's dispatch spans carry ``segments`` only on a segmented
    wire: an S = 1 trace is as it was."""
    import json

    from draco_tpu_torch import cli

    out = tmp_path / "run"
    cli.main(["--network", "TransformerLM", "--dataset", "synthetic-text",
              "--approach", "cyclic", "--redundancy", "shared",
              "--num-workers", "5", "--worker-fail", "1", "--batch-size", "1",
              "--seq-len", "16", "--vocab", "32", "--model-dim", "32",
              "--model-heads", "2", "--model-layers", "1", "--max-steps", "4",
              "--steps-per-call", "2", "--eval-freq", "0",
              "--wire-segments", str(segments), "--device", "cpu",
              "--train-dir", str(out), "--trace-dir", str(out)])
    events = json.loads((out / "trace.json").read_text())["traceEvents"]
    spans = [e for e in events
             if e.get("ph") == "X" and e["name"] == "dispatch"]
    assert len(spans) == 2
    for e in spans:
        assert set(e["args"]) == ({"chunk_start", "k", "segments"}
                                  if segments > 1 else {"chunk_start", "k"})
        assert e["args"].get("segments", 1) == segments
