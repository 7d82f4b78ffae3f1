"""The port's training step on the paths this slice adds, against the JAX
package's, in the harness of ``test_torch_step.py``: the same weights
(``params.from_jax``) and batches, the port drawing the reference's
augmentation draws and projection itself, batch 2
per worker, one step each of

  * ``approx``: the approx code at r=1.5 (pairwise, shared), n=8, two
    workers dropped by the seeded straggler schedule;
  * ``cyclic_int8``: the cyclic code (shared, s=1) with a rev_grad
    adversary on the int8 wire, n=8;
  * ``cyclic_straggler``: the cyclic code (shared, s=1) with one worker
    dropped and no adversary, n=5.

The JAX side decodes with ``decode_impl="pallas"``, i.e. its fused
formulation on the CPU. Tolerances are ``test_torch_step``'s: discrete
columns equal (honest_located, located_errors, det_tp, det_adv,
recovered_fraction); loss rtol 1e-4; the update to 1e-2 in relative L2
norm (an f32 pre-activation within rounding of a ReLU kink lands on the
other side in one framework; ~0.5% of the gradient per such unit). The
approx bound is a host solve on both sides: 1e-5. A residual measures the
gradients, so it moves with them: 1e-2 relative on the approx code
(against the true mean), and on the cyclic code below its flag threshold
on both sides (HEALTH_REL_TOL on the f32 wire, the int8 wire's own).

The int8 leg's update is held to 5e-2 instead: each framework quantizes
its own rows, and where their f32 values straddle a rounding boundary the
level differs by one, which moves the value by a whole quantum (its
block's absmax/127). An f32 difference δ far below the quantum q so
becomes ~√(δ·q) in L2: measured 2.1% at batch 2 (1.6% at batch 4, 2.7%
at batch 8). The buffers themselves equal the reference's bit for bit on
equal rows (test_torch_wire.py), and so does the decode
(test_torch_narrow_decode.py).

Also here: ``TrainConfig.validate`` against what the port still refuses,
and the reference's own checks on the new fields.
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

LEGS = {
    "approx": dict(approach="approx", redundancy="shared", worker_fail=0,
                   code_redundancy=1.5, straggle_mode="drop",
                   straggle_count=2, num_workers=8, batch_size=2),
    "cyclic_int8": dict(approach="cyclic", redundancy="shared",
                        wire_dtype="int8", num_workers=8, batch_size=2),
    "cyclic_straggler": dict(approach="cyclic", redundancy="shared",
                             straggle_mode="drop", straggle_count=1,
                             adversary_count=0, num_workers=5, batch_size=2),
}
DISCRETE = ("honest_located", "located_errors", "det_tp", "det_adv",
            "recovered_fraction")


@pytest.fixture(scope="module")
def ds():
    return datasets.load_dataset("synthetic-cifar10", synthetic_train=256,
                                 synthetic_test=8)


@pytest.fixture(scope="module", params=sorted(LEGS))
def leg(request, ds):
    """Step 1 of one leg in both packages: metrics, the flat parameters
    before and after, and the step's presence mask."""
    kw = dict(COMMON, **LEGS[request.param])
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
    return request.param, rec


def test_metric_columns(leg):
    name, rec = leg
    port, ref, cfg = rec["port"], rec["jax"], rec["cfg"]
    assert tuple(port) == rec["names"]
    assert set(ref) == set(rec["names"])
    assert port["loss"] == pytest.approx(ref["loss"], rel=1e-4)
    assert port["prec1"] == pytest.approx(ref["prec1"], abs=1e-6)
    for k in DISCRETE:
        if k in port:
            assert port[k] == ref[k], k
    n = cfg.num_workers
    if name == "approx":
        assert port["decode_residual_bound"] == pytest.approx(
            ref["decode_residual_bound"], abs=1e-5)
        assert port["decode_residual"] == pytest.approx(
            ref["decode_residual"], rel=1e-2)
        assert 0.0 < port["recovered_fraction"] <= 1.0
        assert port["decode_residual"] <= port["decode_residual_bound"] + 1e-4
        assert int(rec["present"].sum()) == n - 2
        return
    assert port["honest_located"] == n - 2
    adversaries = cfg.num_adversaries
    assert port["det_tp"] == port["det_adv"] == port["located_errors"] \
        == adversaries
    tol = (HEALTH_REL_TOL if cfg.wire_dtype == "f32"
           else numerics.wire_rel_tol(n, 1, cfg.wire_dtype))
    assert port["decode_residual"] < tol and ref["decode_residual"] < tol


def test_update(leg):
    _, rec = leg
    d_port = rec["port_p"] - rec["before"]
    d_jax = rec["jax_p"] - rec["before"]
    assert np.linalg.norm(d_jax) > 0
    tol = 5e-2 if rec["cfg"].wire_dtype == "int8" else 1e-2
    assert np.linalg.norm(d_port - d_jax) <= tol * np.linalg.norm(d_jax)


# --------------------------------------------------------------------------
# configuration
# --------------------------------------------------------------------------

APPROX = dict(COMMON, approach="approx", redundancy="shared", worker_fail=0,
              num_workers=8, straggle_mode="drop", straggle_count=2)
CYCLIC = dict(COMMON, approach="cyclic", num_workers=8)
KRUM = dict(COMMON, approach="baseline", mode="krum", num_workers=5)
VOTE = dict(COMMON, approach="maj_vote", num_workers=9, group_size=3)
LM = dict(network="TransformerLM", dataset="synthetic-text",
          approach="cyclic", num_workers=8, worker_fail=1)


# the vote's narrow wire and stochastic rounding run now: those two cases
# (PORTED) validate and put a wire through the stochastic rounding; the
# approx tree (TREE_PORTED) validates and builds its groups; the LM's wire,
# stragglers, approx code and robust rules over the present rows
# (LM_PORTED) validate and run a step of the LM's loop at a small size;
# the others are still refused
PORTED = ("maj_vote", "stochastic_round")
TREE_PORTED = ("approx_tree",)
LM_PORTED = ("baseline_stragglers", "lm_wire", "lm_stragglers", "lm_approx")
LM_SMALL = dict(batch_size=2, seq_len=16, vocab=32, model_dim=32,
                model_heads=2, model_layers=1, max_steps=2)


@pytest.mark.parametrize("base,override", [
    (dict(CYCLIC, num_workers=9), {"approach": "maj_vote",
                                   "wire_dtype": "bf16"}),
    (CYCLIC, {"shadow_round": "stochastic", "wire_dtype": "int8"}),
    # the CNN baseline takes stragglers, and the LM's
    (dict(LM, approach="baseline", mode="krum"),
     {"straggle_mode": "drop", "straggle_count": 1}),
    (LM, {"wire_dtype": "bf16"}),
    (LM, {"straggle_mode": "drop", "straggle_count": 1,
          "adversary_count": 0}),
    (dict(LM, worker_fail=0), {"approach": "approx", "redundancy": "shared"}),
    # the tree runs now, on shared redundancy only: the simulate lanes
    # have no group shape (the reference's refusal)
    (CYCLIC, {"wire_segments": 2, "topology": "tree"}),
    (APPROX, {"topology": "tree"}),
], ids=["maj_vote", "stochastic_round", "baseline_stragglers", "lm_wire",
        "lm_stragglers", "lm_approx", "wire_segments", "approx_tree"])
def test_still_not_ported(request, base, override):
    TrainConfig(**base).validate()
    if request.node.callspec.id in LM_PORTED:
        from draco_tpu_torch.parallel.sp_step import build_sp_train_setup
        from draco_tpu_torch.parallel.token_loop import TokenLoop

        cfg = TrainConfig(**{**base, **override, **LM_SMALL}).validate()
        loop = TokenLoop(build_sp_train_setup(cfg, "cpu"), cfg, quiet=True)
        rec = loop.step()
        assert np.isfinite(rec["loss"])
        absent = cfg.straggle_count if cfg.straggle_mode == "drop" else 0
        assert rec.get("present", cfg.num_workers) == cfg.num_workers - absent
        return
    if request.node.callspec.id in TREE_PORTED:
        from draco_tpu_torch.parallel.common import build_code_from_cfg

        code = build_code_from_cfg(TrainConfig(**dict(base, **override))
                                   .validate())
        assert (code.family, code.groups, code.fanout) == ("approx", 2, 4)
        return
    if request.node.callspec.id not in PORTED:
        with pytest.raises(ValueError):
            TrainConfig(**dict(base, **override)).validate()
        return
    cfg = TrainConfig(**{**base, **override, "shadow_round": "stochastic"})
    cfg.validate()
    from draco_tpu_torch.obs import numerics

    rows = torch.randn(cfg.num_workers, 1000,
                       generator=torch.Generator().manual_seed(1))
    mode, buf, block = numerics.narrow_wire_single(
        cfg, rows, torch.tensor(2, dtype=torch.int32))
    wide = numerics.widen_wire_rows(buf, mode, block)
    # stochastic rounding moves each value by less than one step of the
    # narrow grid, up or down
    step = (rows.abs() * 2.0 ** -7 if mode == "bf16"
            else numerics.widen_wire_rows(
                {"q": torch.ones_like(buf["q"]), "scale": buf["scale"]},
                mode, block))
    assert ((wide - rows).abs() <= step).all()


@pytest.mark.parametrize("base,override", [
    (APPROX, {"worker_fail": 1}),  # a live adversary under approx
    (APPROX, {"redundancy": "simulate"}),
    (APPROX, {"code_redundancy": 0.5}),
    (APPROX, {"code_redundancy": 9.0}),
    (APPROX, {"straggler_alpha": 1.0}),
    (APPROX, {"assignment_scheme": "clustered"}),  # r=1.5 is fractional
    (APPROX, {"assignment_scheme": "striped"}),
    (APPROX, {"straggle_count": 3}),  # > ceil(0.25·8)
    (APPROX, {"straggle_mode": "slow"}),
    (CYCLIC, {"straggle_mode": "drop", "straggle_count": 1}),  # t+e > s
    (dict(CYCLIC, adversary_count=0), {"straggle_mode": "drop",
                                       "straggle_count": 3}),  # e > 2s
    (CYCLIC, {"wire_dtype": "fp8"}),
    (dict(CYCLIC, num_workers=32, worker_fail=4), {"wire_dtype": "int8"}),
    (dict(CYCLIC, approach="baseline"), {"wire_dtype": "bf16"}),
    (CYCLIC, {"shadow_block": 0}),
    (KRUM, {"num_workers": 3}),  # n < s + 3
    (KRUM, {"mode": "trimmed_mean", "num_workers": 2}),  # n <= 2s
    (KRUM, {"mode": "bulyan", "worker_fail": 3}),  # n < s + 3
    (KRUM, {"straggle_mode": "drop", "straggle_count": 2}),  # n - e < s + 3
    (dict(KRUM, mode="coord_median"), {"straggle_mode": "drop",
                                       "straggle_count": 3}),  # n - e <= 2s
    (dict(KRUM, mode="normal"), {"straggle_mode": "drop",
                                 "straggle_count": 5}),  # e >= n
    (CYCLIC, {"err_mode": "alie"}),
    (CYCLIC, {"err_mode": "ipm"}),
    (VOTE, {"num_workers": 8}),  # n % r
    (VOTE, {"worker_fail": 2}),  # r < 2s + 1
    (VOTE, {"vote_check": "sha256"}),
    (VOTE, {"straggle_mode": "drop", "straggle_count": 3}),  # e >= r
    (dict(VOTE, group_size=5, num_workers=10, worker_fail=2),
     {"straggle_mode": "drop", "straggle_count": 1}),  # r - e <= 2t
], ids=["approx_adversary", "approx_simulate", "r_below_1", "r_above_n",
        "alpha_1", "clustered_fractional_r", "unknown_scheme",
        "approx_budget", "unknown_straggle_mode", "cyclic_joint_budget",
        "cyclic_erasure_budget", "unknown_wire", "no_wire_threshold",
        "baseline_wire", "block_0", "krum_n", "trimmed_n", "bulyan_n",
        "krum_straggler_budget", "median_straggler_budget",
        "baseline_all_absent", "alie_on_cyclic", "ipm_on_cyclic",
        "vote_groups", "vote_r_below_2s_plus_1", "vote_check",
        "vote_silenced_group", "vote_joint_budget"])
def test_reference_checks(base, override):
    """Each override is rejected by the port and by the reference."""
    TrainConfig(**base).validate()
    JaxConfig(**base).validate()
    with pytest.raises(ValueError):
        TrainConfig(**dict(base, **override)).validate()
    with pytest.raises(ValueError):
        JaxConfig(**dict(base, **override)).validate()


def test_accepted_configurations():
    for kw in (APPROX, dict(APPROX, wire_dtype="int8"),
               dict(APPROX, code_redundancy=2.0,
                    assignment_scheme="clustered"),
               dict(CYCLIC, wire_dtype="bf16"),
               dict(CYCLIC, redundancy="shared", wire_dtype="int8",
                    shadow_block=96),
               dict(CYCLIC, adversary_count=0, straggle_mode="drop",
                    straggle_count=2),
               VOTE, dict(VOTE, worker_fail=0), dict(VOTE, vote_check="exact"),
               dict(VOTE, adversary_count=0, straggle_mode="drop",
                    straggle_count=2),
               dict(KRUM, straggle_mode="drop", straggle_count=1),
               dict(KRUM, mode="bulyan", num_workers=7),
               dict(KRUM, mode="trimmed_mean", err_mode="alie"),
               dict(KRUM, mode="multi_krum", err_mode="ipm",
                    straggle_mode="drop", straggle_count=1)):
        TrainConfig(**kw).validate()
        JaxConfig(**kw).validate()
