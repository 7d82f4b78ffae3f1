"""The port's run state against the reference's, on a one-device mesh at
batch 2 (ROADMAP Queue C):

  lenet_cyclic  LeNet, the cyclic code (n=5, s=1, shared, a rev_grad
                adversary), SGD with momentum: the SGD leaves and the
                resumed coded step
  fc_adamw      FC, the mean over n=2, AdamW under the cosine schedule
                with a warmup and the clip: Adam's count and moments, the
                schedule's count

Per leg the reference's ``Trainer`` trains 2 steps and checkpoints step 2
(``compress_ckpt``), then trains step 3. The checkpoint loads into the
port's ``Trainer`` (``checkpoint_step=2``) leaf for leaf bit for bit; the
port writes it back at zlib levels 0 and 1 and the reference's
``ckpt.load`` reads each bit for bit; resumed from the reference's
checkpoint the port's step 3 agrees with the reference's (loss rtol 1e-4,
the update within 1e-2 relative L2, the port's step tolerances: ROADMAP's
port rules), and resumed from the port's checkpoint the reference's step 3
is its own bit for bit. The TransformerLM's state under AdamW crosses
the container both ways bit for bit too. ``test_torch_run_state_eval.py``
holds the evaluation and a BatchNorm network's statistics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from draco_tpu import rng as jrng
from draco_tpu.config import TrainConfig as JaxConfig
from draco_tpu.data import datasets as jdatasets
from draco_tpu.parallel.mesh import make_mesh_2d
from draco_tpu.parallel.sp_step import build_sp_train_setup as jax_lm
from draco_tpu.parallel.sp_step import synthetic_text
from draco_tpu.runtime import make_mesh
from draco_tpu.training.trainer import Trainer as JaxTrainer
from draco_tpu.utils import checkpoint as jckpt
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.data import datasets
from draco_tpu_torch.parallel.sp_step import build_sp_train_setup
from draco_tpu_torch.training.trainer import Trainer
from draco_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

LEGS = {
    "lenet_cyclic": dict(network="LeNet", approach="cyclic",
                         redundancy="shared", num_workers=5, worker_fail=1,
                         err_mode="rev_grad"),
    "fc_adamw": dict(network="FC", approach="baseline", num_workers=2,
                     optimizer="adamw", lr=1e-3, lr_schedule="cosine",
                     warmup_steps=1, clip_norm=1.0),
}
COMMON = dict(dataset="synthetic-mnist", batch_size=2, max_steps=3,
              eval_freq=2, log_every=1000, test_batch_size=16, seed=428)


def load(pkg):
    return pkg.load_dataset("synthetic-mnist", synthetic_train=128,
                            synthetic_test=16)


def ref_leaves(state):
    return [np.asarray(x) for x in jax.tree.leaves(jax.device_get(state))]


def flat_params(state):
    return np.concatenate([np.asarray(x).ravel() for x in
                           jax.tree.leaves(jax.device_get(state.params))])


@pytest.fixture(scope="module", params=sorted(LEGS))
def leg(request, tmp_path_factory):
    name = request.param
    d = str(tmp_path_factory.mktemp(name))
    kw = dict(COMMON, **LEGS[name])
    jtr = JaxTrainer(JaxConfig(train_dir=d, compress_ckpt=True, **kw),
                     mesh=make_mesh(1), dataset=load(jdatasets), quiet=True)
    jtr.run(max_steps=2)
    at2 = ref_leaves(jtr.state)
    abstract = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                            jtr.state)
    r3 = jtr.run(max_steps=3)
    out = dict(name=name, kw=kw, dir=d, at2=at2, abstract=abstract,
               ref3=(r3, ref_leaves(jtr.state), flat_params(jtr.state)))
    tr = Trainer(TrainConfig(train_dir=d, checkpoint_step=2, **kw),
                 device="cpu", dataset=load(datasets), quiet=True)
    out["port_at2"] = tr.state.arrays(tr.setup.layout)
    out["port_step"] = tr.state.step
    out["port3"] = tr.run()
    out["port_p3"] = np.concatenate([
        x.read().ravel() for x in tr.state.leaves(tr.setup.layout)[
            :len(tr.setup.layout.names)]])
    return out


def test_the_references_checkpoint_loads_leaf_for_leaf(leg):
    assert leg["port_step"] == 3  # the step leaf: the next step to run
    assert len(leg["port_at2"]) == len(leg["at2"])
    for a, b in zip(leg["port_at2"], leg["at2"]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("compress_ckpt", [False, True])
def test_the_ports_checkpoint_loads_into_the_reference(leg, tmp_path,
                                                       compress_ckpt):
    d = str(tmp_path)
    ckpt.save(d, 2, leg["port_at2"], compress=compress_ckpt)
    got = ref_leaves(jckpt.load(d, 2, leg["abstract"]))
    for a, b in zip(got, leg["at2"]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_resumed_steps_agree_across_the_packages(leg, tmp_path):
    """Step 3 from the reference's checkpoint, in the port against the
    reference; and the reference resumed from the port's checkpoint is its
    own uninterrupted run bit for bit."""
    ref3, ref_fin, ref_p3 = leg["ref3"]
    port3 = leg["port3"]
    assert port3["step"] == ref3["step"] == 3
    assert port3["loss"] == pytest.approx(ref3["loss"], rel=1e-4)
    if leg["kw"]["approach"] == "cyclic":
        for k in ("honest_located", "located_errors", "det_tp", "det_adv"):
            assert port3[k] == ref3[k], k
    p2 = np.concatenate([a.ravel() for a in leg["at2"][:_n_params(leg)]])
    d_ref, d_port = ref_p3 - p2, leg["port_p3"] - p2
    assert np.linalg.norm(d_ref) > 0
    assert np.linalg.norm(d_port - d_ref) <= 1e-2 * np.linalg.norm(d_ref)

    d = str(tmp_path)
    ckpt.save(d, 2, leg["port_at2"], compress=True)
    cfg = JaxConfig(train_dir=d, compress_ckpt=True, checkpoint_step=2,
                    **leg["kw"])
    jtr = JaxTrainer(cfg, mesh=make_mesh(1), dataset=load(jdatasets),
                     quiet=True)
    jtr.run()
    for a, b in zip(ref_leaves(jtr.state), ref_fin):
        np.testing.assert_array_equal(a, b)


def _n_params(leg):
    return len(jax.tree.leaves(leg["abstract"].params))


LM = dict(network="TransformerLM", dataset="synthetic-text",
          approach="cyclic", redundancy="shared", num_workers=5,
          worker_fail=1, batch_size=2, seq_len=16, vocab=32, model_dim=32,
          model_heads=2, model_layers=1, optimizer="adamw", lr=1e-3,
          lr_schedule="cosine", warmup_steps=1, max_steps=3, train_dir="",
          seed=428)


def test_an_lm_checkpoint_reads_in_both_packages(tmp_path):
    """The LM's state (AdamW: Adam's count and moments, the schedule's
    count) after one reference step, through each package's container
    into the other, leaf for leaf bit for bit."""
    jset = jax_lm(JaxConfig(eval_freq=0, **LM), make_mesh_2d(1, 1))
    adv = jrng.adversary_schedule(428, 3, 5, 1)
    jstate, _ = jset.train_step(jset.state, jnp.asarray(
        synthetic_text(428, 1, 5, 2, 16, 32)), jnp.asarray(adv[1]))
    ref = ref_leaves(jstate)
    assert int(jstate.step) == 2
    d = str(tmp_path)
    jckpt.save(d, 1, jstate, compress=True)
    tset = build_sp_train_setup(TrainConfig(**LM), device="cpu")
    lay = tset.layout
    tset.state.load(ckpt.load(d, 1, tset.state.specs(lay)), lay)
    assert tset.state.step == 2 and int(tset.state.opt.count) == 1
    ours = tset.state.arrays(lay)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    ckpt.save(str(tmp_path / "port"), 1, ours)
    abstract = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                            jstate)
    for a, b in zip(ref_leaves(jckpt.load(str(tmp_path / "port"), 1,
                                          abstract)), ref):
        np.testing.assert_array_equal(a, b)
