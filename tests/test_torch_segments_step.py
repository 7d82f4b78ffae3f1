"""The ResNet-18 step on the segmented wire and at the per-layer decode,
against the JAX package's, in the harness of ``test_torch_approx_step.py``:
the same weights (``params.from_jax``), batches, augmentation draws and
projection, CI size (n=5, batch 2 per worker), one step each of

  * ``layer``: the cyclic code (shared, s=1, a rev_grad adversary) at
    ``decode_granularity="layer"``: one locator a parameter tensor (62);
  * ``seg2_f32`` / ``seg2_int8``: the same at global granularity with
    ``wire_segments=2``, on the f32 and the int8 wire (block 256);
  * ``approx_seg2``: the approx code (r=1.5, two stragglers a step) with
    ``wire_segments=2`` on the int8 wire.

The first two here, the int8 pair in ``test_torch_segments_step_int8.py``
(each file within 90 s on one core).

The JAX side decodes with ``decode_impl="pallas"`` (its fused formulation
on the CPU). Tolerances are ``test_torch_approx_step``'s: discrete columns
equal (honest_located the rows honest in every segment, the reference's
fold, at most n − 2s), loss rtol 1e-4, the update within 1e-2
relative L2 (5e-2 on the int8 wire, whose levels each framework rounds on
its own rows), the approx residual 1e-2 relative and within its bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from draco_tpu.config import TrainConfig as JaxConfig
from draco_tpu.runtime import make_mesh
from draco_tpu.training.step import build_train_setup as jax_setup
from draco_tpu_torch import params as params_mod
from draco_tpu_torch import rng
from draco_tpu_torch.coding.cyclic import HEALTH_REL_TOL
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.data import batching, datasets
from draco_tpu_torch.obs import numerics
from draco_tpu_torch.training.step import build_train_setup
from test_torch_step import COMMON, SEED, _flat_params, _resync

torch.set_num_threads(1)

CYCLIC = dict(approach="cyclic", redundancy="shared", num_workers=5,
              batch_size=2)
LEGS = {
    "layer": dict(CYCLIC, decode_granularity="layer"),
    "seg2_f32": dict(CYCLIC, wire_segments=2),
    "seg2_int8": dict(CYCLIC, wire_segments=2, wire_dtype="int8"),
    "approx_seg2": dict(approach="approx", redundancy="shared",
                        worker_fail=0, code_redundancy=1.5,
                        straggle_mode="drop", straggle_count=2,
                        num_workers=5, batch_size=2, wire_segments=2,
                        wire_dtype="int8"),
}
HERE = ("layer", "seg2_f32")
DISCRETE = ("honest_located", "located_errors", "det_tp", "det_adv",
            "recovered_fraction")


@pytest.fixture(scope="module")
def ds():
    return datasets.load_dataset("synthetic-cifar10", synthetic_train=256,
                                 synthetic_test=8)


@pytest.fixture(scope="module", params=HERE)
def leg(request, ds):
    return request.param, step_both(request.param, ds)


def step_both(name, ds) -> dict:
    """Step 1 of one leg in both packages."""
    kw = dict(COMMON, **LEGS[name])
    n, b, step = kw["num_workers"], kw["batch_size"], 1
    cfg = TrainConfig(**kw)
    jset = jax_setup(JaxConfig(eval_freq=0, log_every=1000,
                               decode_impl="pallas", **kw), make_mesh(n))
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
    x, y = batching.gather(
        ds, batching.indices_cyclic(len(ds), step - 1, n, b, SEED), n, b)
    jargs = (jnp.asarray(x), jnp.asarray(y), jnp.asarray(adv))
    if present is not None:
        jargs += (jnp.asarray(present),)
    jstate, jm = jset.train_step(jset.state, *jargs)
    tstate, tm = tset.train_step(tset.state, x, y, adv, present=present)
    rec = {"cfg": cfg, "names": tset.metric_names, "present": present,
           "jax": {k: float(v) for k, v in jm.items()
                   if k in tset.metric_names},
           "port": {k: float(v) for k, v in tm.items()},
           "before": _flat_params(init[0], tset.layout),
           "port_p": _flat_params(tstate.params, tset.layout)}
    rec["jax_p"] = _flat_params(_resync(tstate, jstate), tset.layout)
    return rec


def test_metric_columns(leg):
    check_metric_columns(leg[1])


def test_update(leg):
    check_update(leg[1])


def check_metric_columns(rec) -> None:
    port, ref, cfg = rec["port"], rec["jax"], rec["cfg"]
    assert tuple(port) == rec["names"]
    assert set(ref) == set(rec["names"])
    assert port["loss"] == pytest.approx(ref["loss"], rel=1e-4)
    assert port["prec1"] == pytest.approx(ref["prec1"], abs=1e-6)
    for k in DISCRETE:
        if k in port:
            assert port[k] == ref[k], k
    n = cfg.num_workers
    if cfg.approach == "approx":
        assert port["decode_residual_bound"] == pytest.approx(
            ref["decode_residual_bound"], abs=1e-5)
        assert port["decode_residual"] == pytest.approx(
            ref["decode_residual"], rel=1e-2)
        slack = numerics.wire_residual_slack(cfg.wire_dtype)
        assert port["decode_residual"] <= (port["decode_residual_bound"]
                                           + slack + 1e-4)
        assert int(rec["present"].sum()) == n - 2
        return
    # the folded honest set, the reference's: the rows honest in every
    # segment, at most n − 2s (two segments may exclude different
    # neighbours of the adversary, which tie on the DFT circle)
    assert port["honest_located"] <= n - 2
    assert port["det_tp"] == port["det_adv"] == port["located_errors"] == 1
    tol = (HEALTH_REL_TOL if cfg.wire_dtype == "f32"
           else numerics.wire_rel_tol(n, 1, cfg.wire_dtype))
    assert port["decode_residual"] < tol and ref["decode_residual"] < tol


def check_update(rec) -> None:
    d_port = rec["port_p"] - rec["before"]
    d_jax = rec["jax_p"] - rec["before"]
    assert np.linalg.norm(d_jax) > 0
    tol = 5e-2 if rec["cfg"].wire_dtype == "int8" else 1e-2
    assert np.linalg.norm(d_port - d_jax) <= tol * np.linalg.norm(d_jax)
