"""One step of the port with the wire observatory on (``numerics_watch=
"on"`` and a ``shadow_wire``) against the JAX package's, from the same
weights, batches and schedules, on a one-device mesh. LeNet on synthetic
MNIST at batch 2 (the coded paths are the CNN step's for every model).
This file holds the cyclic code's legs; ``test_torch_watch_step_codes.py``
runs the same tests on the other codes' (its legs share this harness):

  * ``shared_int8``: cyclic ``shared``, n=5, s=1, the int8 shadow;
  * ``simulate_bf16``: cyclic ``simulate``, the bf16 shadow;
  * ``layer_int8``: ``decode_granularity="layer"`` (a locator a leaf, the
    shadow's too);
  * (the other file) ``approx_int8_sr``: the approx code at n=8, r=1.5, 2
    stragglers, the int8 shadow rounded stochastically (its draws at seed
    + 11); ``majvote_int8``: the repetition code, one group (n=3), the
    int8 shadow; ``lm_bf16``: the LM's cyclic ``shared`` step at 2 layers
    with the bf16 shadow.

Held: the schema (every column of the reference's, in its order); the
packed masks and the shadow's discrete columns (``shadow_det_flagged``,
``shadow_det_tp``, ``shadow_flag_agree``) exactly; the numerics columns
within the gradients' f32 rounding between the frameworks — absmax and
rms to 1e-4 relative, a fraction to 2e-4 of the stage's elements (the
elements whose int8 threshold or exponent bin a rounding flips; 0 on the
non-finite fraction); ``shadow_err`` to 2e-2 and ``shadow_residual`` to
2e-2 relative or 1e-6 absolute (a quantized decode of gradients that
differ in their last bits). And the f32 update: turning the watch off
changes no parameter's bits (the port's step with and without it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from draco_tpu.config import TrainConfig as JaxConfig
from draco_tpu.obs.forensics import mask_metric_names
from draco_tpu.parallel.mesh import make_mesh_2d
from draco_tpu.parallel.sp_step import build_sp_train_setup as jax_lm_setup
from draco_tpu.runtime import make_mesh
from draco_tpu.training.step import build_train_setup as jax_setup
from draco_tpu_torch import params as params_mod
from draco_tpu_torch import rng
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.data import batching, datasets
from draco_tpu_torch.obs import numerics
from draco_tpu_torch.parallel.sp_step import build_sp_train_setup
from draco_tpu_torch.parallel.sp_step import synthetic_text
from draco_tpu_torch.training.step import build_train_setup

torch.set_num_threads(1)

SEED = 428
COMMON = dict(network="LeNet", dataset="synthetic-mnist", lr=0.01,
              momentum=0.9, worker_fail=1, err_mode="rev_grad", max_steps=3,
              batch_size=2, train_dir="", seed=SEED, numerics_watch="on")
LEGS = {
    "shared_int8": dict(approach="cyclic", redundancy="shared",
                        num_workers=5, shadow_wire="int8"),
    "simulate_bf16": dict(approach="cyclic", redundancy="simulate",
                          num_workers=5, shadow_wire="bf16"),
    "layer_int8": dict(approach="cyclic", redundancy="shared",
                       num_workers=5, decode_granularity="layer",
                       shadow_wire="int8"),
    "approx_int8_sr": dict(approach="approx", redundancy="shared",
                           worker_fail=0, code_redundancy=1.5,
                           straggle_mode="drop", straggle_count=2,
                           num_workers=8, shadow_wire="int8",
                           shadow_round="stochastic"),
    "majvote_int8": dict(approach="maj_vote", group_size=3, num_workers=3,
                         shadow_wire="int8"),
}
LM = dict(network="TransformerLM", dataset="synthetic-text", lr=0.01,
          momentum=0.9, num_workers=8, worker_fail=1, err_mode="rev_grad",
          batch_size=2, seq_len=32, vocab=64, model_dim=64, model_heads=4,
          model_layers=2, max_steps=3, train_dir="", seed=SEED,
          approach="cyclic", redundancy="shared", numerics_watch="on",
          shadow_wire="bf16")
SHADOW_EXACT = ("shadow_det_flagged", "shadow_det_tp", "shadow_flag_agree")
FRACTION_ATOL = 2e-4
RANGE_RTOL = 1e-4


@pytest.fixture(scope="module")
def ds():
    return datasets.load_dataset("synthetic-mnist", synthetic_train=128,
                                 synthetic_test=8)


def _flat(params, lay):
    return params_mod.flatten(params, lay).numpy()


def _bits(m: dict) -> dict:
    """Metrics as host values, each as its float32 bits' integer."""
    return {k: int(np.float32(float(v)).view(np.uint32))
            for k, v in m.items()}


def run_leg(name: str, ds):
    """One step of leg ``name`` in both packages, and the port's step with
    the watch off: (name, cfg, the reference's names, its metrics, {watch:
    (setup, metrics, flat parameters after)})."""
    step = 1
    if name == "lm_bf16":
        jset = jax_lm_setup(JaxConfig(eval_freq=0, log_every=1000, **LM),
                            make_mesh_2d(1, 1))
        init, _ = params_mod.from_jax(jax.device_get(jset.state.params))
        cfg = TrainConfig(**LM)
        adv = rng.adversary_schedule(SEED, 3, 8, 1)[step]
        toks = synthetic_text(SEED, step, 8, 2, 32, 64)
        _, jm = jset.train_step(jset.state, jnp.asarray(toks),
                                jnp.asarray(adv))
        run = {}
        for watch in (True, False):
            c = cfg if watch else TrainConfig(**dict(
                LM, numerics_watch="off", shadow_wire="off"))
            tset = build_sp_train_setup(c, device="cpu", init=init)
            tstate, tm = tset.train_step(tset.state, toks, adv)
            run[watch] = (tset, tm, _flat(tstate.params, tset.layout))
        return name, cfg, jset.metric_names, jm, run
    kw = dict(COMMON, **LEGS[name])
    cfg = TrainConfig(**kw)
    n, b = cfg.num_workers, cfg.batch_size
    jset = jax_setup(JaxConfig(eval_freq=0, log_every=1000, **kw),
                     make_mesh(1))
    init = params_mod.from_jax(jax.device_get(jset.state.params),
                               jax.device_get(jset.state.batch_stats))
    adv = rng.adversary_schedule(SEED, 3, n, cfg.num_adversaries)[step]
    present = None
    if cfg.straggle_mode == "drop":
        present = ~rng.straggler_schedule(SEED, 3, n,
                                          cfg.straggle_count)[step]
    if cfg.approach == "maj_vote":
        idx = batching.indices_grouped(len(ds), step - 1, n, cfg.group_size,
                                       b, rng.group_seeds(SEED,
                                                          cfg.num_groups))
    else:
        idx = batching.indices_cyclic(len(ds), step - 1, n, b, SEED)
    x, y = batching.gather(ds, idx, n, b)
    jargs = (jnp.asarray(x), jnp.asarray(y), jnp.asarray(adv))
    if present is not None:
        jargs += (jnp.asarray(present),)
    _, jm = jset.train_step(jset.state, *jargs)
    run = {}
    for watch in (True, False):
        c = cfg if watch else TrainConfig(**dict(
            kw, numerics_watch="off", shadow_wire="off"))
        tset = build_train_setup(c, device="cpu", dataset_name=ds.name,
                                 init=init)
        tstate, tm = tset.train_step(tset.state, x, y, adv, present=present)
        run[watch] = (tset, tm, _flat(tstate.params, tset.layout))
    return name, cfg, jset.metric_names, jm, run


@pytest.fixture(scope="module",
                params=["layer_int8", "shared_int8", "simulate_bf16"])
def leg(request, ds):
    return run_leg(request.param, ds)


def test_schema_and_masks(leg):
    name, cfg, jax_names, jm, run = leg
    tset, tm, _ = run[True]
    assert tset.metric_names == tuple(jax_names)
    masks = mask_metric_names(cfg.num_workers)
    assert set(masks) | set(numerics.numerics_metric_names()) \
        | set(numerics.SHADOW_NAMES) <= set(tset.metric_names)
    mine, theirs = _bits({k: tm[k] for k in masks}), _bits(
        {k: jm[k] for k in masks})
    assert mine == theirs
    # the adversary accused (cyclic, vote), every present worker present
    if cfg.approach != "approx":
        assert mine[masks[0]] == mine[masks[2]] != 0


def test_numerics_columns(leg):
    _, _, _, jm, run = leg
    _, tm, _ = run[True]
    for k in numerics.numerics_metric_names():
        a, b = float(tm[k]), float(jm[k])
        stat = k.split("_", 2)[2]
        if stat in ("absmax", "rms"):
            assert a == pytest.approx(b, rel=RANGE_RTOL), k
        elif stat == "nonfinite":
            assert a == b == 0.0, k
        else:
            assert abs(a - b) <= FRACTION_ATOL, (k, a, b)


def test_shadow_columns(leg):
    name, cfg, _, jm, run = leg
    _, tm, _ = run[True]
    for k in SHADOW_EXACT:
        assert float(tm[k]) == float(jm[k]), k
    assert float(tm["shadow_flag_agree"]) == 1.0
    for k in ("shadow_err", "shadow_residual"):
        a, b = float(tm[k]), float(jm[k])
        assert a >= 0.0 and a == pytest.approx(b, rel=2e-2, abs=1e-6), (k, a,
                                                                         b)
    assert 0.0 < float(tm["shadow_err"]) <= numerics.SHADOW_REL_TOL[
        cfg.shadow_wire]


def test_the_watch_leaves_the_update_alone(leg):
    _, _, _, _, run = leg
    _, tm_on, p_on = run[True]
    _, tm_off, p_off = run[False]
    assert np.array_equal(p_on.view(np.uint32), p_off.view(np.uint32))
    assert _bits({k: tm_off[k] for k in tm_off}) == _bits(
        {k: tm_on[k] for k in tm_off})
