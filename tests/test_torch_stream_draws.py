"""Every draw of the training step from the reference's key chain, with no
draw handed in: the port's numbers against the JAX package's at the same
seed.

  * the augmentation draws (``ops/draws.augment_draws``): bit for bit the
    (top, left, flip) of the reference's ``augment_batch`` under
    fold(key(seed + 2), step, row), a row a batch row or, on the vote, a
    group;
  * VGG-11's dropout keep-masks (``ops/draws.dropout_keep``): bit for bit
    the masks the reference's ``nn.Dropout`` layers draw under fold(key(
    seed + 3), step, row), drawn as ``nn.Dropout.__call__`` draws them
    (``test_torch_vgg_step.jax_dropout_masks``);
  * the vote's fingerprint salts (``ops/draws.vote_salts``): bit for bit
    ``bits(fold(key(seed + 4), step), (2,))``;
  * the decode projection (``rng.projection_factors``, drawn in pieces):
    within 2.4e-7·max(1, |z|) + ulp(1 + z) of the reference's 1 + z (its
    normal's erfinv is the reference's polynomial, within 2.4e-7·max(1,
    |z|), ``test_torch_draws.py``; the 1 + z rounds once more);
  * the initial parameters: ``test_torch_stream_init.py``;
  * a port ``Trainer`` and the reference's ``Trainer`` at one seed:
    LeNet on synthetic CIFAR-10 (augmentation, the projection, the initial
    parameters), cyclic ``shared`` at n=5, s=1, a rev_grad adversary,
    batch 2, 2 steps: the losses within 1e-2 relative and the update
    within 1e-2 relative L2. The step's own dropout masks are held to the
    reference's in ``test_torch_vgg_step.py``, VGG-11's step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_step import jax_aug_draws
from test_torch_vgg_step import jax_dropout_masks

from draco_tpu import rng as jrng
from draco_tpu.config import TrainConfig as JaxConfig
from draco_tpu.data import datasets as jdatasets
from draco_tpu.runtime import make_mesh
from draco_tpu.training.trainer import Trainer as JaxTrainer
from draco_tpu_torch import params as params_mod
from draco_tpu_torch import rng
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.data import datasets
from draco_tpu_torch.ops import draws
from draco_tpu_torch.training.trainer import Trainer

torch.set_num_threads(1)

SEED = 428


def _step(s):
    return torch.tensor(s, dtype=torch.int32)


@pytest.mark.parametrize("step,rows,div,batch", [
    (1, 8, 1, 4), (5, 3, 1, 2), (1234, 5, 1, 3), (7, 9, 3, 2)],
    ids=["shared", "few", "late_step", "vote_groups"])
def test_augmentation_draws_bit_for_bit(step, rows, div, batch):
    got = draws.augment_draws(_step(step), SEED + draws.AUG_SALT, rows,
                              batch, div)
    ref = jax_aug_draws(SEED, step, -(-rows // div), batch)
    for i in range(3):
        want = ref[i].numpy().repeat(div, axis=0)[:rows]
        np.testing.assert_array_equal(got[i].numpy(), want)


def test_dropout_masks_bit_for_bit():
    got = draws.dropout_keep(_step(3), SEED + draws.DROPOUT_SALT, 2, 2, 2,
                             512)
    assert torch.equal(got, jax_dropout_masks("VGG11", 3, 2))


@pytest.mark.parametrize("step", [1, 2, 77])
def test_vote_salts_bit_for_bit(step):
    key = jrng.fold(jax.random.key(SEED + 4), jnp.int32(step))
    ref = np.asarray(jax.random.bits(key, (2,), jnp.uint32)).view(np.int32)
    np.testing.assert_array_equal(
        draws.vote_salts(_step(step), SEED + draws.VOTE_SALT).numpy(), ref)


def test_projection_within_the_normals_tolerance(monkeypatch):
    monkeypatch.setattr(rng, "PIECE", 4096)  # a draw in many pieces
    for seed in (SEED, 7):
        got = rng.projection_factors(seed, 50_003).numpy()
        ref = np.asarray(jrng.random_projection_factors_in_graph(
            seed, 50_003))
        tol = (2.4e-7 * np.maximum(1.0, np.abs(ref - 1.0))
               + np.spacing(np.abs(ref)))
        assert (np.abs(got - ref) <= tol).all()
        assert np.mean(got == ref) > 0.9


CNN_CYCLIC = dict(network="LeNet", dataset="synthetic-cifar10",
                  approach="cyclic", redundancy="shared", num_workers=5,
                  worker_fail=1, batch_size=2, lr=0.01, momentum=0.9,
                  err_mode="rev_grad", max_steps=2, train_dir="",
                  eval_freq=0, seed=SEED)


def _flat(params):
    return np.concatenate([np.asarray(x).ravel()
                           for x in jax.tree.leaves(jax.device_get(params))])


def test_trainer_against_the_references_trainer_no_draws_given():
    jtr = JaxTrainer(JaxConfig(log_every=1000, decode_impl="pallas",
                               **CNN_CYCLIC), mesh=make_mesh(1),
                     dataset=jdatasets.load_dataset(
                         "synthetic-cifar10", synthetic_train=64,
                         synthetic_test=8), quiet=True)
    p0 = _flat(jtr.state.params)
    ref = [jtr.run(max_steps=s) for s in (1, 2)]
    p2 = _flat(jtr.state.params)
    tr = Trainer(TrainConfig(**CNN_CYCLIC), device="cpu",
                 dataset=datasets.load_dataset("synthetic-cifar10",
                                               synthetic_train=64,
                                               synthetic_test=8), quiet=True)
    lay = tr.setup.layout
    q0 = params_mod.flatten(tr.state.params, lay).numpy().copy()
    got = [tr.step() for _ in range(2)]
    q2 = params_mod.flatten(tr.state.params, lay).numpy()
    np.testing.assert_allclose(q0, p0, rtol=0, atol=1e-6 * np.abs(p0).max())
    for g, r in zip(got, ref):
        assert g["loss"] == pytest.approx(r["loss"], rel=1e-2)
        for k in ("honest_located", "located_errors", "det_tp", "det_adv"):
            assert g[k] == r[k], k
        assert g["located_errors"] == 1 and g["honest_located"] == 3
    d_ref, d_port = p2 - p0, q2 - q0
    assert np.linalg.norm(d_ref) > 0
    assert np.linalg.norm(d_port - d_ref) <= 1e-2 * np.linalg.norm(d_ref)
