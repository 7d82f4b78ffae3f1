"""The port's chunked loops against the JAX package.

* The chunk boundaries and index blocks: ``batching.chunk_ranges`` and
  ``indices_{baseline,cyclic}_range`` equal the reference's bit for bit
  (several starts, K, eval_freq, and blocks that cross an epoch), and each
  row of a block equals the port's per-step indices.
* A chunked port run against the reference's **eager** loop on the same
  inputs (the reference's own chunked token loop fails its tests,
  ROADMAP Queue C, so it is no oracle): the same weights
  (``params.from_jax``), batches or tokens and adversary schedule; the
  port draws the reference's in-graph projection and, for the ResNet, its
  augmentation draws itself, from the seed. The port runs the steps
  as one chunk (its CPU loop), the reference step by step; nothing is
  re-synchronised between the steps.

  - the TransformerLM (2 layers, dim 32) on a one-device mesh, cyclic
    ``shared``, three steps in one chunk (K=3), at
    ``test_torch_lm_step.py``'s tolerance: discrete columns equal, loss
    1e-4 relative, the update 1e-2 in relative L2 norm, the parameters
    1e-4 of their scale;
  - cyclic ResNet-18 (``shared``, n=8, s=1, rev_grad, batch 2:
    ``test_torch_step.py``'s shared leg), two steps in one chunk (K=2), at
    that file's tolerance for what it holds per step: discrete columns
    equal, loss 1e-4 relative, prec1 to 1e-6, the parameters 1e-4 of
    their scale. Its update bound is 1e-2 a step, from the reference's
    state each step; here the two steps run from the port's own state, so
    the two-step update is held to 2e-2 (1e-2 for each step it sums: the
    second step's ReLU-kink flips, ~0.5% each in f32 at batch 2, fall
    where the first step left each framework; measured 1.3%).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from draco_tpu.config import TrainConfig as JaxConfig
from draco_tpu.data import batching as jbatching
from draco_tpu.parallel.mesh import make_mesh_2d
from draco_tpu.parallel.sp_step import build_sp_train_setup as jax_lm_setup
from draco_tpu.runtime import make_mesh
from draco_tpu.training.step import build_train_setup as jax_setup
from draco_tpu_torch import params as params_mod
from draco_tpu_torch import rng
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.data import batching, datasets
from draco_tpu_torch.parallel.sp_step import build_sp_train_setup
from draco_tpu_torch.parallel.sp_step import synthetic_text
from draco_tpu_torch.training.step import build_train_setup

torch.set_num_threads(1)

SEED = 428


# --------------------------------------------------------------------------
# boundaries and index blocks
# --------------------------------------------------------------------------

# (start, last, K, eval_freq, n_samples, n, B): chunks of up to K snapped to
# eval_freq; index blocks of K steps from step start − 1, some crossing an
# epoch (cyclic: 200 // 32 = 6 steps an epoch; baseline at B=4: 50) or
# wrapping a dataset that n·B does not divide
CASES = [
    (1, 7, 3, 4, 200, 8, 4),
    (1, 10, 4, 0, 200, 8, 4),
    (5, 23, 8, 5, 200, 8, 4),
    (3, 3, 4, 2, 50, 5, 3),
    (48, 60, 5, 50, 200, 8, 4),
    (1, 100, 7, 10, 37, 5, 2),
    (2, 1, 4, 0, 200, 8, 4),
]


@pytest.mark.parametrize("start,last,K,eval_freq,n_samples,n,b", CASES)
def test_ranges_equal_the_references(start, last, K, eval_freq, n_samples, n,
                                     b):
    ranges = batching.chunk_ranges(start, last, K, eval_freq)
    assert ranges == jbatching.chunk_ranges(start, last, K, eval_freq)
    assert sum(k for _, k in ranges) == max(last - start + 1, 0)
    for port, ref, one in (
            (batching.indices_cyclic_range, jbatching.indices_cyclic_range,
             batching.indices_cyclic),
            (batching.indices_baseline_range,
             jbatching.indices_baseline_range, batching.indices_baseline)):
        block = port(n_samples, start - 1, K, n, b, SEED)
        np.testing.assert_array_equal(
            block, ref(n_samples, start - 1, K, n, b, SEED))
        assert block.shape == (K, n * b)
        for i in range(K):
            np.testing.assert_array_equal(
                block[i], one(n_samples, start - 1 + i, n, b, SEED))


# --------------------------------------------------------------------------
# a chunked run against the reference's eager loop
# --------------------------------------------------------------------------

def _flat(params, lay):
    return params_mod.flatten(params, lay).numpy()


def _hold(port_rows, ref_rows, names, before, port_p, ref_p, upd_tol):
    """test_torch_step / test_torch_lm_step's bounds, per step and on the
    final parameters; the update over the run to ``upd_tol``."""
    for p, r in zip(port_rows, ref_rows):
        assert p["loss"] == pytest.approx(r["loss"], rel=1e-4)
        for k in ("located_errors", "det_tp", "det_adv"):
            if k in names:
                assert p[k] == r[k] == 1, k
        if "decode_residual" in names:
            assert p["decode_residual"] < 1e-4 and r["decode_residual"] < 1e-4
    d_port, d_ref = port_p - before, ref_p - before
    assert np.linalg.norm(d_ref) > 0
    assert np.linalg.norm(d_port - d_ref) <= upd_tol * np.linalg.norm(d_ref)
    np.testing.assert_allclose(port_p, ref_p, rtol=0,
                               atol=1e-4 * np.abs(ref_p).max())


def _rows(block, names):
    return [dict(zip(names, vals)) for vals in block.tolist()]


def test_lm_chunk_against_the_reference_eager_loop():
    kw = dict(network="TransformerLM", dataset="synthetic-text", lr=0.01,
              momentum=0.9, num_workers=8, worker_fail=1,
              err_mode="rev_grad", batch_size=2, seq_len=16, vocab=32,
              model_dim=32, model_heads=2, model_layers=2, max_steps=3,
              train_dir="", seed=SEED, approach="cyclic",
              redundancy="shared")
    jset = jax_lm_setup(JaxConfig(eval_freq=0, log_every=1000, **kw),
                        make_mesh_2d(1, 1))
    init, _ = params_mod.from_jax(jax.device_get(jset.state.params))
    tset = build_sp_train_setup(TrainConfig(steps_per_call=3, **kw),
                                device="cpu", init=init)
    adv = rng.adversary_schedule(SEED, 3, 8, 1)
    toks = np.stack([synthetic_text(SEED, s, 8, 2, 16, 32)
                     for s in (1, 2, 3)])
    jstate, ref_rows = jset.state, []
    for i, step in enumerate((1, 2, 3)):
        jstate, jm = jset.train_step(jstate, jnp.asarray(toks[i]),
                                     jnp.asarray(adv[step]))
        ref_rows.append({k: float(jm[k]) for k in tset.metric_names})
    _, block = tset.train_token_many(
        tset.state, tset.make_chunk(1, toks, adv[1:4]))
    rows = _rows(block, tset.block_names)
    assert all(r["honest_located"] == 6 for r in rows)
    lay = tset.layout
    ref_p, _ = params_mod.from_jax(jax.device_get(jstate.params))
    _hold(rows, ref_rows, tset.metric_names, _flat(init, lay),
          _flat(tset.state.params, lay), _flat(ref_p, lay), 1e-2)


def test_resnet_chunk_against_the_reference_eager_loop():
    n, b = 8, 2
    kw = dict(network="ResNet18", dataset="synthetic-cifar10", lr=0.01,
              momentum=0.9, worker_fail=1, err_mode="rev_grad", max_steps=3,
              train_dir="", seed=SEED, approach="cyclic",
              redundancy="shared", num_workers=n, batch_size=b)
    ds = datasets.load_dataset("synthetic-cifar10", synthetic_train=256,
                               synthetic_test=8)
    jset = jax_setup(JaxConfig(eval_freq=0, log_every=1000,
                               decode_impl="pallas", **kw), make_mesh(n))
    init = params_mod.from_jax(jax.device_get(jset.state.params),
                               jax.device_get(jset.state.batch_stats))
    tset = build_train_setup(TrainConfig(steps_per_call=2, **kw),
                             device="cpu", dataset_name=ds.name, init=init)
    adv = rng.adversary_schedule(SEED, 3, n, 1)
    idx = batching.indices_cyclic_range(len(ds), 0, 2, n, b, SEED)
    batches = [batching.gather(ds, idx[i], n, b) for i in range(2)]
    jstate, ref_rows = jset.state, []
    for i, step in enumerate((1, 2)):
        x, y = batches[i]
        jstate, jm = jset.train_step(jstate, jnp.asarray(x), jnp.asarray(y),
                                     jnp.asarray(adv[step]))
        ref_rows.append({k: float(jm[k]) for k in tset.metric_names})
    chunk = tset.make_chunk(
        1, np.stack([x for x, _ in batches]), np.stack([y for _, y in batches]),
        adv[1:3])
    _, block = tset.train_many(tset.state, chunk)
    rows = _rows(block, tset.block_names)
    for r, ref in zip(rows, ref_rows):
        assert r["honest_located"] == ref["honest_located"] == n - 2
        assert r["prec1"] == pytest.approx(ref["prec1"], abs=1e-6)
    lay = tset.layout
    ref_p, _ = params_mod.from_jax(jax.device_get(jstate.params),
                                   jax.device_get(jstate.batch_stats))
    _hold(rows, ref_rows, tset.metric_names, _flat(init[0], lay),
          _flat(tset.state.params, lay), _flat(ref_p, lay), 2e-2)
