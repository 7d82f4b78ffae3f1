"""The port's test-set evaluation and a BatchNorm network's checkpoint
against the reference's, at CI size on a one-device mesh:

  * ResNet-18 (synthetic CIFAR-10, the mean over n=2, batch 2): the
    reference's ``Trainer`` trains 2 steps and checkpoints step 2; the
    port's ``Trainer`` resumes it with every leaf bit for bit, the
    statistics' leading worker axis included, and writes it back as the
    reference reads it; its evaluation on worker 0's running statistics
    (16 test images at batch 6: a ragged tail of 4) gives the reference's
    prec@1 and prec@5 exactly, and its logits in evaluation mode the
    reference's ``apply(train=False)`` within 1e-4 relative;
  * VGG-11 (dropout in training): the port's evaluation, with no dropout,
    counts what the reference's ``eval_step`` counts on the same weights;
  * ``masked_full_split_eval`` of both packages with one numpy
    ``count_fn`` at n % bs != 0: equal, and sample-weighted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from draco_tpu.config import TrainConfig as JaxConfig
from draco_tpu.data import datasets as jdatasets
from draco_tpu.runtime import make_mesh
from draco_tpu.training import evaluator as jevaluator
from draco_tpu.training.step import build_train_setup as jax_setup
from draco_tpu.training.trainer import Trainer as JaxTrainer
from draco_tpu.utils import checkpoint as jckpt
from draco_tpu_torch import params as params_mod
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.data import datasets
from draco_tpu_torch.training import evaluator
from draco_tpu_torch.training.step import build_train_setup
from draco_tpu_torch.training.trainer import Trainer
from draco_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

RESNET = dict(network="ResNet18", dataset="synthetic-cifar10",
              approach="baseline", num_workers=2, batch_size=2, max_steps=2,
              eval_freq=2, log_every=1000, test_batch_size=6, seed=428)


def load(pkg):
    return pkg.load_dataset("synthetic-cifar10", synthetic_train=64,
                            synthetic_test=16)


@pytest.fixture(scope="module")
def resnet(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("resnet"))
    jtr = JaxTrainer(JaxConfig(train_dir=d, compress_ckpt=True, **RESNET),
                     mesh=make_mesh(1), dataset=load(jdatasets), quiet=True)
    jtr.run()
    ds = load(jdatasets)
    ref_eval = jevaluator.masked_full_split_eval(
        lambda x, y, v: jtr.setup.eval_step(jtr.state, x, y, v),
        ds.test_x, ds.test_y, 6)
    tr = Trainer(TrainConfig(train_dir=d, checkpoint_step=2, **RESNET),
                 device="cpu", dataset=load(datasets), quiet=True)
    return jtr, tr, ref_eval, d


def test_the_statistics_round_trip_bit_for_bit(resnet, tmp_path):
    jtr, tr, _, _ = resnet
    ref = [np.asarray(x) for x in jax.tree.leaves(jax.device_get(jtr.state))]
    ours = tr.state.arrays(tr.setup.layout)
    assert len(ours) == len(ref) and tr.state.step == 3
    stats = jax.tree.leaves(jax.device_get(jtr.state.batch_stats))
    assert stats[0].shape[0] == 2  # the worker axis
    assert not np.array_equal(stats[0], np.zeros_like(stats[0]))
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    d = str(tmp_path)
    ckpt.save(d, 2, ours)
    abstract = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                            jtr.state)
    for a, b in zip(jax.tree.leaves(jckpt.load(d, 2, abstract)), ref):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_evaluation_counts_the_references(resnet, tmp_path):
    jtr, tr, ref_eval, d = resnet
    rec = tr.evaluate(2, batch_size=6)
    assert (rec["prec1_test"], rec["prec5_test"]) == ref_eval
    assert rec["prec5_test"] * 16 == round(rec["prec5_test"] * 16)
    # the reference's own record of the same evaluation
    import json
    lines = [json.loads(x) for x in open(f"{d}/metrics.jsonl")]
    ref_rec = [r for r in lines if "prec1_test" in r][0]
    assert ref_rec["step"] == 2
    assert (ref_rec["prec1_test"], ref_rec["prec5_test"]) == ref_eval


def test_resnet_logits_in_evaluation_mode(resnet):
    jtr, tr, _, _ = resnet
    ds = load(datasets)
    x = ds.test_x[:6]
    stats0 = jax.tree.map(lambda t: t[0],
                          jax.device_get(jtr.state.batch_stats))
    ref = np.asarray(jtr.setup.model.apply(
        {"params": jax.device_get(jtr.state.params), "batch_stats": stats0},
        jnp.asarray(x), train=False))
    with torch.no_grad():
        ours, new = tr.setup.model(
            torch.from_numpy(x), {k: v[0] for k, v in
                                  tr.state.stats.items()}, None, train=False)
    assert new == {}
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_vgg_evaluation_has_no_dropout():
    kw = dict(network="VGG11", dataset="synthetic-cifar10",
              approach="baseline", num_workers=1, batch_size=2,
              train_dir="", seed=428)
    jset = jax_setup(JaxConfig(eval_freq=0, **kw), make_mesh(1))
    init = params_mod.from_jax(jax.device_get(jset.state.params))
    tset = build_train_setup(TrainConfig(**kw), device="cpu",
                             dataset_name="synthetic-cifar10", init=init)
    ds = load(datasets)
    x, y = ds.test_x[:8], ds.test_y[:8]
    valid = np.arange(8) < 7
    ref = [float(v) for v in jset.eval_step(jset.state, jnp.asarray(x),
                                            jnp.asarray(y),
                                            jnp.asarray(valid))]
    ours = [float(v) for v in tset.eval_step(tset.state, x, y, valid)]
    assert ours == ref
    # the same logits twice: no mask drawn in evaluation
    with torch.no_grad():
        a = tset.model(torch.from_numpy(x), {}, None, train=False)[0]
        b = tset.model(torch.from_numpy(x), {}, None, train=False)[0]
    assert torch.equal(a, b)


def test_masked_full_split_eval_equals_the_references():
    rng = np.random.RandomState(3)
    xs = rng.randn(23, 4).astype(np.float32)
    ys = rng.randint(0, 10, size=23).astype(np.int32)
    table = rng.randn(23, 10)
    seen = {"port": [], "ref": []}

    def count_fn(who):
        def count(x, y, valid):
            seen[who].append((x.shape[0], int(valid.sum())))
            rows = [int(np.flatnonzero((xs == r).all(1))[0]) for r in x]
            logits = table[rows]
            ok1 = (logits.argmax(1) == y) & valid
            top5 = np.argsort(-logits, 1)[:, :5]
            ok5 = (top5 == y[:, None]).any(1) & valid
            return ok1.sum(), ok5.sum()
        return count

    ours = evaluator.masked_full_split_eval(count_fn("port"), xs, ys, 5)
    ref = jevaluator.masked_full_split_eval(count_fn("ref"), xs, ys, 5)
    assert ours == ref
    assert seen["port"] == seen["ref"] == [(5, 5)] * 4 + [(5, 3)]
    logits = table
    want1 = float(((logits.argmax(1) == ys)).sum()) / 23
    assert ours[0] == want1
    assert evaluator.masked_full_split_eval(count_fn("port"), xs[:0],
                                            ys[:0], 5) == (0.0, 0.0)
