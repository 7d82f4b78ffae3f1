"""The port's repetition-code step on the narrow wire and under the random
attack against the JAX package's, in the harness of
``test_torch_majvote_step.py``: ResNet-18, one group of r=3 (n=3), batch 2,
the same weights, batches, augmentation draws and fingerprint salts, one
step on a one-device mesh:

  * ``bf16_sr`` / ``int8_sr``: the vote on a stochastically rounded bf16 /
    int8 wire (``shadow_round="stochastic"``, the reference's one draw a
    step shared by every row, ``fold_in(key(seed + 17), step)``) with a
    rev_grad adversary: the two honest rows quantize bit for bit alike and
    out-vote it;
  * ``random``: the vote under the random attack (the reference's
    normals, drawn from the step with no ``noise=``).

Tolerances are ``test_torch_step``'s: the vote's columns equal
(vote_agree, flagged_groups, det_flagged, det_tp, det_adv), the loss to
1e-4 relative, the update to 1e-2 in relative L2 norm. The wire's draw is
integer arithmetic, so the rounding itself is the reference's bit for bit
(``test_torch_draws.py``); the update differs only through the gradients'
f32 rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from draco_tpu.config import TrainConfig as JaxConfig
from draco_tpu.obs.forensics import mask_metric_names
from draco_tpu.runtime import make_mesh
from draco_tpu.training.step import build_train_setup as jax_setup
from draco_tpu_torch import params as params_mod
from draco_tpu_torch import rng
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.data import batching, datasets
from draco_tpu_torch.training.step import build_train_setup
from test_torch_majvote_step import VOTE_COLUMNS
from test_torch_step import COMMON, SEED, _flat_params, _resync

torch.set_num_threads(1)

VOTE = dict(COMMON, approach="maj_vote", group_size=3, num_workers=3,
            batch_size=2)
LEGS = {
    "bf16_sr": dict(wire_dtype="bf16", shadow_round="stochastic"),
    "int8_sr": dict(wire_dtype="int8", shadow_round="stochastic"),
    "random": dict(err_mode="random"),
}


@pytest.fixture(scope="module")
def ds():
    return datasets.load_dataset("synthetic-cifar10", synthetic_train=256,
                                 synthetic_test=8)


@pytest.fixture(scope="module", params=sorted(LEGS))
def leg(request, ds):
    kw = dict(VOTE, **LEGS[request.param])
    n, b, step = kw["num_workers"], kw["batch_size"], 1
    cfg = TrainConfig(**kw)
    jset = jax_setup(JaxConfig(eval_freq=0, log_every=1000, **kw),
                     make_mesh(1))
    init = params_mod.from_jax(jax.device_get(jset.state.params),
                               jax.device_get(jset.state.batch_stats))
    tset = build_train_setup(cfg, device="cpu", dataset_name=ds.name,
                             init=init)
    adv = rng.adversary_schedule(SEED, kw["max_steps"], n, 1)[step]
    idx = batching.indices_grouped(len(ds), step - 1, n, cfg.group_size, b,
                                   rng.group_seeds(SEED, cfg.num_groups))
    x, y = batching.gather(ds, idx, n, b)
    jstate, jm = jset.train_step(jset.state, jnp.asarray(x), jnp.asarray(y),
                                 jnp.asarray(adv))
    tstate, tm = tset.train_step(tset.state, x, y, adv)
    lay = tset.layout
    rec = {"names": tset.metric_names,
           "jax": {k: float(v) for k, v in jm.items()
                   if k in tset.metric_names},
           "port": {k: float(v) for k, v in tm.items()},
           "before": _flat_params(init[0], lay),
           "port_p": _flat_params(tstate.params, lay)}
    rec["jax_p"] = _flat_params(_resync(tstate, jstate), lay)
    return request.param, rec


def test_vote_columns(leg):
    _, rec = leg
    port, ref = rec["port"], rec["jax"]
    masks = mask_metric_names(VOTE["num_workers"])
    assert rec["names"] == ("loss", "prec1") + VOTE_COLUMNS + masks
    assert port["loss"] == pytest.approx(ref["loss"], rel=1e-4)
    for k in VOTE_COLUMNS + masks:
        assert port[k] == ref[k], k
    # the honest rows agree bit for bit on the wire, the adversary is
    # out-voted
    assert port["vote_agree"] == pytest.approx(2 / 3)
    assert port["flagged_groups"] == port["det_flagged"] == 1
    assert port["det_tp"] == port["det_adv"] == 1


def test_update(leg):
    _, rec = leg
    d_port = rec["port_p"] - rec["before"]
    d_jax = rec["jax_p"] - rec["before"]
    assert np.linalg.norm(d_jax) > 0
    assert np.linalg.norm(d_port - d_jax) <= 1e-2 * np.linalg.norm(d_jax)
