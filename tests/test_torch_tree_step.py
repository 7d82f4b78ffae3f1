"""The tree topology's steps (``topology="tree"``) against the JAX
package's on a one-device mesh, from the same weights: one CNN step
(LeNet, cyclic ``shared`` at n=16, g=8, a rev_grad adversary; the approx
code at n=9, g=3 with two stragglers) and one LM step (n=8, g=4,
s_g = 0): the discrete columns equal, loss 1e-4 relative, the update
1e-2 relative L2 (``test_torch_step.py``'s). The codes, the plans and the
chunks: ``test_torch_tree.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_tree import APPROX_TREE, SEED, TREE

from draco_tpu.config import TrainConfig as JaxConfig
from draco_tpu.parallel.mesh import make_mesh_2d
from draco_tpu.parallel.sp_step import build_sp_train_setup as jax_lm_setup
from draco_tpu.runtime import make_mesh
from draco_tpu.training.step import build_train_setup as jax_setup
from draco_tpu_torch import params as params_mod
from draco_tpu_torch import rng
from draco_tpu_torch.coding import topology
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.data import batching, datasets
from draco_tpu_torch.parallel.sp_step import build_sp_train_setup
from draco_tpu_torch.parallel.sp_step import synthetic_text
from draco_tpu_torch.training.step import build_train_setup

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mnist():
    return datasets.load_dataset("synthetic-mnist", synthetic_train=256,
                                 synthetic_test=8)


def _flat(params, lay):
    return params_mod.flatten(params, lay).numpy()


@pytest.mark.parametrize("kw", [TREE, APPROX_TREE], ids=["cyclic", "approx"])
def test_cnn_tree_step_against_the_reference(mnist, kw):
    n, b, step = kw["num_workers"], kw["batch_size"], 1
    cfg = TrainConfig(**kw)
    jset = jax_setup(JaxConfig(eval_freq=0, log_every=1000,
                               decode_impl="pallas", **kw), make_mesh(1))
    init = params_mod.from_jax(jax.device_get(jset.state.params), None)
    tset = build_train_setup(cfg, device="cpu", dataset_name=mnist.name,
                             init=init)
    adv = rng.adversary_schedule(SEED, kw["max_steps"], n,
                                 cfg.num_adversaries)[step]
    present = None
    if cfg.straggle_mode == "drop":
        present = ~rng.straggler_schedule(SEED, kw["max_steps"], n,
                                          cfg.straggle_count)[step]
    x, y = batching.gather(
        mnist, batching.indices_cyclic(len(mnist), step - 1, n, b, SEED), n,
        b)
    jargs = (jnp.asarray(x), jnp.asarray(y), jnp.asarray(adv))
    if present is not None:
        jargs += (jnp.asarray(present),)
    jstate, jm = jset.train_step(jset.state, *jargs)
    tstate, tm = tset.train_step(tset.state, x, y, adv, present=present)
    jm = {k: float(v) for k, v in jm.items()}
    tm = {k: float(v) for k, v in tm.items()}
    assert tm["loss"] == pytest.approx(jm["loss"], rel=1e-4)
    if cfg.approach == "cyclic":
        for k in ("honest_located", "located_errors", "det_tp", "det_adv"):
            assert tm[k] == jm[k], k
        assert tm["honest_located"] == 12 and tm["located_errors"] == 1
    else:
        for k in ("decode_residual_bound", "recovered_fraction"):
            assert tm[k] == pytest.approx(jm[k], rel=1e-5), k
        assert tm["decode_residual"] == pytest.approx(jm["decode_residual"],
                                                      rel=1e-2)
    lay = tset.layout
    before = _flat(init[0], lay)
    after, _ = params_mod.from_jax(jax.device_get(jstate.params), None)
    d_jax = _flat(after, lay) - before
    d_port = _flat(tstate.params, lay) - before
    assert np.linalg.norm(d_jax) > 0
    assert np.linalg.norm(d_port - d_jax) <= 1e-2 * np.linalg.norm(d_jax)


def test_lm_tree_step_against_the_reference():
    kw = dict(network="TransformerLM", dataset="synthetic-text",
              batch_size=2, max_steps=2, seq_len=16, vocab=64, model_dim=32,
              model_heads=2, model_layers=1, approach="cyclic",
              worker_fail=0, adversary_count=0, redundancy="shared",
              num_workers=8, topology="tree", tree_fanout=4, lr=0.01,
              momentum=0.9, train_dir="", seed=SEED)
    jset = jax_lm_setup(JaxConfig(eval_freq=0, log_every=1000, **kw),
                        make_mesh_2d(1, 1))
    init, _ = params_mod.from_jax(jax.device_get(jset.state.params))
    tset = build_sp_train_setup(TrainConfig(**kw), device="cpu", init=init)
    assert topology.is_tree(tset.code) and tset.code.groups == 2
    adv = rng.adversary_schedule(SEED, 2, 8, 0)
    toks = synthetic_text(SEED, 1, 8, 2, 16, 64)
    jstate, jm = jset.train_step(jset.state, jnp.asarray(toks),
                                 jnp.asarray(adv[1]))
    tstate, tm = tset.train_step(tset.state, toks, adv[1])
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
    for k in ("located_errors", "det_tp", "det_adv"):
        assert float(tm[k]) == float(jm[k]) == 0, k
    assert float(tm["honest_located"]) == 8
    lay = tset.layout
    before = _flat(init, lay)
    after, _ = params_mod.from_jax(jax.device_get(jstate.params))
    d_jax = _flat(after, lay) - before
    d_port = _flat(tstate.params, lay) - before
    assert np.linalg.norm(d_port - d_jax) <= 1e-2 * np.linalg.norm(d_jax)
