"""The port's repetition-code step and robust-baseline steps against the
JAX package's, in the harness of ``test_torch_step.py``: the same weights
(``params.from_jax``), batches, augmentation draws and, for the vote, the
reference's own fingerprint salts, one step each on a one-device mesh at
batch 2 per worker (at batch 1 the reference's step on a multi-device CPU
mesh computes some gradients wrongly, ROADMAP Queue C):

  * ``majvote``: ResNet-18, one group of r=3 (n=3) with a rev_grad
    adversary — the vote outvotes it;
  * ``krum``: ResNet-18, n=5, s=1, a rev_grad adversary and one worker
    dropped by the seeded straggler schedule;
  * ``lm_krum``: the TransformerLM at CI size (n=8, s=1) against
    ``draco_tpu.parallel.sp_step``.

Tolerances are ``test_torch_step``'s: the discrete columns equal
(vote_agree, flagged_groups, det_flagged, det_tp, det_adv), the loss to
1e-4 relative, the update to 1e-2 in relative L2 norm (an f32
pre-activation within rounding of a ReLU kink lands on the other side in
one framework). The honest lanes of a group are bit-identical on the CPU,
as the vote needs. Also here: a K=2 chunk of each ResNet leg against its
eager steps, bit for bit, and the grouped batch indices against the
reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from draco_tpu import rng as jrng
from draco_tpu.config import TrainConfig as JaxConfig
from draco_tpu.data import batching as jbatching
from draco_tpu.obs.forensics import mask_metric_names
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
from test_torch_chunk import assert_chunk_equals_eager
from test_torch_chunk_cnn import cnn_build, cnn_chunk
from test_torch_lm_step import LM
from test_torch_step import COMMON, SEED, _flat_params, _resync

torch.set_num_threads(1)

LEGS = {
    "majvote": dict(approach="maj_vote", group_size=3, num_workers=3,
                    batch_size=2),
    "krum": dict(approach="baseline", mode="krum", num_workers=5,
                 batch_size=2, straggle_mode="drop", straggle_count=1),
}
VOTE_COLUMNS = ("vote_agree", "flagged_groups", "det_flagged", "det_tp",
                "det_adv")


@pytest.fixture(scope="module")
def ds():
    return datasets.load_dataset("synthetic-cifar10", synthetic_train=256,
                                 synthetic_test=8)


def test_grouped_indices_bit_for_bit():
    seeds = rng.group_seeds(SEED, 3)
    np.testing.assert_array_equal(seeds, jrng.group_seeds(SEED, 3))
    for step in (0, 1, 7, 60):
        np.testing.assert_array_equal(
            batching.indices_grouped(200, step, 9, 3, 4, seeds),
            jbatching.indices_grouped(200, step, 9, 3, 4, seeds))
    np.testing.assert_array_equal(
        batching.indices_grouped_range(200, 45, 9, 9, 3, 4, seeds),
        jbatching.indices_grouped_range(200, 45, 9, 9, 3, 4, seeds))
    idx = batching.indices_grouped(200, 3, 9, 3, 4, seeds).reshape(9, 4)
    assert (idx[0] == idx[2]).all() and (idx[3] == idx[5]).all()
    assert not (idx[0] == idx[3]).all()


@pytest.fixture(scope="module", params=sorted(LEGS))
def leg(request, ds):
    """Step 1 of one ResNet leg in both packages: metrics, the flat
    parameters before and after, the per-lane gradients' equality."""
    kw = dict(COMMON, **LEGS[request.param])
    n, b, step = kw["num_workers"], kw["batch_size"], 1
    cfg = TrainConfig(**kw)
    jset = jax_setup(JaxConfig(eval_freq=0, log_every=1000, **kw),
                     make_mesh(1))
    init = params_mod.from_jax(jax.device_get(jset.state.params),
                               jax.device_get(jset.state.batch_stats))
    tset = build_train_setup(cfg, device="cpu", dataset_name=ds.name,
                             init=init)
    adv = rng.adversary_schedule(SEED, kw["max_steps"], n,
                                 cfg.num_adversaries)[step]
    present = None
    if cfg.straggle_mode == "drop":
        present = ~rng.straggler_schedule(SEED, kw["max_steps"], n,
                                          cfg.straggle_count)[step]
    if cfg.approach == "maj_vote":
        idx = batching.indices_grouped(
            len(ds), step - 1, n, cfg.group_size, b,
            rng.group_seeds(SEED, cfg.num_groups))
    else:
        idx = batching.indices_baseline(len(ds), step - 1, n, b, SEED)
    x, y = batching.gather(ds, idx, n, b)
    jargs = (jnp.asarray(x), jnp.asarray(y), jnp.asarray(adv))
    if present is not None:
        jargs += (jnp.asarray(present),)
    jstate, jm = jset.train_step(jset.state, *jargs)
    tstate, tm = tset.train_step(tset.state, x, y, adv, present=present)
    rec = {"cfg": cfg, "names": tset.metric_names, "adv": adv,
           "present": present,
           "jax": {k: float(v) for k, v in jm.items()
                   if k in tset.metric_names},
           "port": {k: float(v) for k, v in tm.items()},
           "before": _flat_params(init[0], tset.layout),
           "port_p": _flat_params(tstate.params, tset.layout)}
    rec["jax_p"] = _flat_params(_resync(tstate, jstate), tset.layout)
    return request.param, rec


def test_metric_columns(leg):
    name, rec = leg
    port, ref = rec["port"], rec["jax"]
    assert tuple(port) == rec["names"]
    assert set(ref) == set(rec["names"])
    assert port["loss"] == pytest.approx(ref["loss"], rel=1e-4)
    assert port["prec1"] == pytest.approx(ref["prec1"], abs=1e-6)
    if name == "majvote":
        # the vote's columns, then the packed forensics masks (the
        # out-voted rows accused), bit for bit the reference's words
        masks = mask_metric_names(rec["cfg"].num_workers)
        assert rec["names"] == ("loss", "prec1") + VOTE_COLUMNS + masks
        for k in VOTE_COLUMNS + masks:
            assert port[k] == ref[k], k
        # the two honest lanes agree bit for bit, the adversary is flagged
        assert port["vote_agree"] == pytest.approx(2 / 3)
        assert port["flagged_groups"] == port["det_flagged"] == 1
        assert port["det_tp"] == port["det_adv"] == 1
    else:
        assert rec["names"] == ("loss", "prec1")
        assert int(rec["present"].sum()) == 4


def test_update(leg):
    _, rec = leg
    d_port = rec["port_p"] - rec["before"]
    d_jax = rec["jax_p"] - rec["before"]
    assert np.linalg.norm(d_jax) > 0
    assert np.linalg.norm(d_port - d_jax) <= 1e-2 * np.linalg.norm(d_jax)


@pytest.mark.parametrize("name,fields,ranges", [
    ("majvote", {}, [(1, 2)]),
    ("krum", dict(straggle_mode="drop", straggle_count=1), [(1, 2), (3, 1)]),
], ids=["majvote", "krum_straggler"])
def test_chunk_equals_eager_steps(ds, name, fields, ranges):
    assert_chunk_equals_eager(cnn_build(name, ds, **fields), cnn_chunk,
                              ranges)


def test_lm_krum_step():
    kw = dict(LM, approach="baseline", mode="krum")
    jset = jax_lm_setup(JaxConfig(eval_freq=0, log_every=1000, **kw),
                        make_mesh_2d(1, 1))
    init, _ = params_mod.from_jax(jax.device_get(jset.state.params))
    tset = build_sp_train_setup(TrainConfig(**kw), device="cpu", init=init)
    adv = rng.adversary_schedule(SEED, kw["max_steps"], 8, 1)[1]
    toks = synthetic_text(SEED, 1, 8, 2, 32, 64)
    jstate, jm = jset.train_step(jset.state, jnp.asarray(toks),
                                 jnp.asarray(adv))
    tstate, tm = tset.train_step(tset.state, toks, adv)
    assert tset.metric_names == ("loss",)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
    lay = tset.layout
    before = params_mod.flatten(init, lay).numpy()
    ref, _ = params_mod.from_jax(jax.device_get(jstate.params))
    d_jax = params_mod.flatten(ref, lay).numpy() - before
    d_port = params_mod.flatten(tstate.params, lay).numpy() - before
    assert np.linalg.norm(d_jax) > 0
    assert np.linalg.norm(d_port - d_jax) <= 1e-2 * np.linalg.norm(d_jax)
