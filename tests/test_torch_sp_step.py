"""The port's coded TransformerLM step at ``seq_shards=4`` against the JAX
package's eager sp step (``draco_tpu.parallel.sp_step``) on
``make_mesh_2d(1, 4)``: the n=8 worker lanes vmapped on the w axis, each
worker's sequence over 4 CPU devices, batch 2 per worker (ROADMAP Queue
C: at batch 1 on a multi-device w axis the reference computes some
gradients wrongly). The port runs on the CPU with the shard axis as a
tensor axis of the attention, through the flash kernels' plain versions
(the reference's flash takes its dense fallback off-TPU).

Legs, one reference compile each: the dense ring with cyclic ``shared``,
the flash ring with cyclic ``simulate``, the a2a head scatter around the
flash kernels with the geometric median, and the dense ring with
``remat`` and ``scan_layers`` from the port's own scanned draw (no
parameter handed in). Two steps a leg, the port taking the reference's
parameters and momentum before step 2. Tolerances (those of
``test_torch_lm_step.py`` at one shard): the discrete decode columns and
the packed forensics masks equal, the loss to 1e-4 relative, the update
to 1e-2 in relative L2 and the parameters to 1e-4 of their scale.

Without JAX: the port's sp trajectory against its own sp=1 one (the same
decode columns, losses and parameters within float32 reduction order),
K=3 chunks bit for bit its eager loop, and the LM's autopilot dial at
four shards with remat and the stacked layers.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from draco_tpu import optim as joptim
from draco_tpu.config import TrainConfig as JaxConfig
from draco_tpu.obs.forensics import mask_metric_names
from draco_tpu.parallel.mesh import make_mesh_2d
from draco_tpu.parallel.sp_step import build_sp_train_setup as jax_setup
from draco_tpu_torch import params as params_mod
from draco_tpu_torch import rng
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.parallel.sp_step import build_sp_train_setup
from draco_tpu_torch.parallel.sp_step import synthetic_text
from draco_tpu_torch.parallel.token_loop import TokenLoop

torch.set_num_threads(1)

SEED = 428
SP = 4
LM = dict(network="TransformerLM", dataset="synthetic-text", lr=0.01,
          momentum=0.9, num_workers=8, worker_fail=1, err_mode="rev_grad",
          batch_size=2, seq_len=32, vocab=64, model_dim=64, model_heads=4,
          model_layers=2, max_steps=3, train_dir="", seed=SEED,
          seq_shards=SP)
LEGS = {
    "ring_shared": dict(approach="cyclic", redundancy="shared"),
    "ring_flash_simulate": dict(approach="cyclic", redundancy="simulate",
                                attn_impl="flash"),
    "a2a_flash_geomedian": dict(approach="baseline",
                                mode="geometric_median", geomedian_iters=8,
                                sp_attn="a2a", attn_impl="flash"),
    "ring_remat_scan": dict(approach="cyclic", redundancy="shared",
                            remat=True, scan_layers=True),
}
# the port draws the leg's initial parameters itself
OWN_INIT = ("ring_remat_scan",)


def _momentum(opt_state):
    if isinstance(opt_state, joptim.SGDState):
        return opt_state.momentum_buf
    for part in opt_state:
        found = _momentum(part)
        if found is not None:
            return found
    return None


def _flat(params, lay):
    return params_mod.flatten(params, lay).numpy()


@pytest.fixture(scope="module", params=sorted(LEGS))
def leg(request):
    kw = dict(LM, **LEGS[request.param])
    jset = jax_setup(JaxConfig(eval_freq=0, log_every=1000, **kw),
                     make_mesh_2d(1, SP))
    jstate = jset.state
    ref_init, _ = params_mod.from_jax(jax.device_get(jstate.params))
    own = request.param in OWN_INIT
    tset = build_sp_train_setup(TrainConfig(**kw), device="cpu",
                                init=None if own else ref_init)
    tstate, lay = tset.state, tset.layout
    assert tset.dim == jset.dim
    rec = {"steps": [], "names": tset.metric_names,
           "jax_names": jset.metric_names,
           "init": (_flat(tstate.params, lay), _flat(ref_init, lay))}
    adv = rng.adversary_schedule(SEED, kw["max_steps"], 8, 1)
    before = {k: v.clone() for k, v in tstate.params.items()}
    for step in (1, 2):
        toks = synthetic_text(SEED, step, 8, 2, 32, 64)
        jstate, jm = jset.train_step(jstate, jnp.asarray(toks),
                                     jnp.asarray(adv[step]))
        tstate, tm = tset.train_step(tstate, toks, adv[step])
        st = {"jax": {k: float(jm[k]) for k in tset.metric_names},
              "port": {k: float(v) for k, v in tm.items()},
              "before": _flat(before, lay),
              "port_p": _flat(tstate.params, lay)}
        # hand the port the reference's state for the next step
        before, _ = params_mod.from_jax(jax.device_get(jstate.params))
        bufs, _ = params_mod.from_jax(
            jax.device_get(_momentum(jstate.opt_state)))
        for k, v in before.items():
            tstate.params[k].copy_(v)
        tstate.opt.bufs = bufs
        st["jax_p"] = _flat(before, lay)
        rec["steps"].append(st)
    return request.param, rec


def test_decode_columns_and_loss(leg):
    name, rec = leg
    assert rec["names"] == rec["jax_names"]
    for st in rec["steps"]:
        assert st["port"]["loss"] == pytest.approx(st["jax"]["loss"],
                                                   rel=1e-4)
        if "geomedian" in name:
            assert rec["names"] == ("loss",)
            continue
        for k in mask_metric_names(8) + ("located_errors", "det_tp",
                                         "det_adv"):
            assert st["port"][k] == st["jax"][k], k
        assert st["port"]["located_errors"] == st["port"]["det_tp"] == 1
        assert st["port"]["honest_located"] == 6
        assert st["port"]["decode_residual"] < 1e-4


def test_updates_and_params(leg):
    name, rec = leg
    got, want = rec["init"]
    if name in OWN_INIT:  # the port's scanned draw: Flax's model.init
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    else:
        np.testing.assert_array_equal(got, want)
    for i, st in enumerate(rec["steps"]):
        d_port, d_jax = st["port_p"] - st["before"], st["jax_p"] - st["before"]
        if i == 0 and name in OWN_INIT:
            d_jax = st["jax_p"] - want
        assert np.linalg.norm(d_jax) > 0
        assert np.linalg.norm(d_port - d_jax) <= 1e-2 * np.linalg.norm(d_jax)
        np.testing.assert_allclose(st["port_p"], st["jax_p"], rtol=0,
                                   atol=1e-4 * np.abs(st["jax_p"]).max())


def _trajectory(**kw):
    cfg = TrainConfig(**dict(LM, approach="cyclic", redundancy="shared",
                             attn_impl="flash", **kw)).validate()
    setup = build_sp_train_setup(cfg, device="cpu")
    adv = rng.adversary_schedule(SEED, 3, 8, 1)
    state, recs = setup.state, []
    for step in (1, 2, 3):
        toks = synthetic_text(SEED, step, 8, 2, 32, 64)
        state, m = setup.train_step(state, toks, adv[step])
        recs.append({k: float(v) for k, v in m.items()})
    return recs, params_mod.flatten(state.params, setup.layout).numpy()


@pytest.mark.parametrize("sp_attn", ["ring", "a2a"])
def test_sp_trajectory_is_the_single_shard_one(sp_attn):
    """The shard axis changes only the attention's reduction order: the
    same decode columns every step, the losses to 1e-5 relative and the
    parameters to 1e-5 of their scale after three steps."""
    one, p1 = _trajectory(seq_shards=1)
    sharded, p4 = _trajectory(sp_attn=sp_attn)
    for a, b in zip(one, sharded):
        for k in mask_metric_names(8) + ("located_errors", "det_tp",
                                         "det_adv", "honest_located"):
            assert a[k] == b[k], k
        assert b["loss"] == pytest.approx(a["loss"], rel=1e-5)
    np.testing.assert_allclose(p4, p1, rtol=0, atol=1e-5 * np.abs(p1).max())


def _run_loop(k, d, **kw):
    cfg = TrainConfig(**dict(LM, approach="cyclic", redundancy="shared",
                             attn_impl="flash", max_steps=6, eval_freq=3,
                             log_every=1, steps_per_call=k, train_dir=d,
                             **kw)).validate()
    loop = TokenLoop(build_sp_train_setup(cfg, "cpu"), cfg, quiet=True)
    loop.run()
    with open(os.path.join(d, "metrics.jsonl")) as f:
        recs = [{k: v for k, v in json.loads(x).items() if k != "step_ms"}
                for x in f]
    return recs, torch.cat([p.reshape(-1)
                            for p in loop.state.params.values()])


@pytest.mark.parametrize("sp_attn", ["ring", "a2a"])
def test_chunk_equals_eager_bitwise(tmp_path, sp_attn):
    recs1, p1 = _run_loop(1, str(tmp_path / "k1"), sp_attn=sp_attn)
    recs3, p3 = _run_loop(3, str(tmp_path / "k3"), sp_attn=sp_attn)
    assert torch.equal(p1, p3)
    assert recs1 == recs3
    assert [r["step"] for r in recs3 if "split" not in r] == list(
        range(1, 7))


def test_autopilot_swaps_keep_the_shards_and_the_stack(tmp_path):
    """The reference's LM dial (``test_torch_lm_autopilot.py``) at four
    sequence shards with remat and the stacked layers: a regime swap
    rebuilds the setup on the live model, with the same seq_shards,
    sp_attn, remat and scan_layers; a setup of another model is refused
    on it."""
    from test_torch_lm_autopilot import LM as DIAL, assert_dial, run

    loop, last, rems, status = run(str(tmp_path), dict(
        DIAL, seq_shards=4, remat=True, scan_layers=True))
    assert_dial(loop, last, rems, status)
    assert loop.setup.model.key[-4:] == (4, "ring", True, True)
    with pytest.raises(ValueError, match="live setup's model"):
        build_sp_train_setup(dataclasses.replace(loop.cfg, remat=False),
                             "cpu", live=loop.setup)
