"""The port's TransformerLM step on the approx code against the JAX
package's (``draco_tpu.parallel.sp_step.build_sp_train_setup``) at sp=1,
in the harness of ``test_torch_lm_step.py``: the reference on a one-device
mesh, the port on the CPU from the reference's parameters, the same
``synthetic_text`` tokens and seeded schedules, two steps a leg, the port
handed the reference's parameters and momentum before step 2.

Legs, at the LM's CI size (``analysis/registry.LM_CI``, n=8, batch 2):
preset approx-resnet18's code on the LM (r=1.5, pairwise, shared, no
adversary) with the seeded straggler schedule dropping two workers a
step; the same on the int8 wire rounded stochastically (the reference's
threefry draws, which the port makes itself); and as a tree, n=8 in two
groups of 4 (each group solved on the host at n=4).

Tolerances (ROADMAP's for the LM legs). The mask words, the presence
count and ``recovered_fraction`` exact; ``decode_residual_bound`` and
``recovered_fraction`` within 1e-6 (a host solve on both sides); the
residual within 1e-2 relative (it measures the gradients, which move by
their f32 noise) and within its bound; the loss 1e-4 relative; the update
(−lr × the decoded gradient, with momentum on step 2) within 1e-2 in
relative L2 norm, 5e-2 on the int8 wire (each framework quantizes its own
rows: a value on a rounding boundary moves by one level, a whole quantum,
``test_torch_approx_step.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from draco_tpu.config import TrainConfig as JaxConfig
from draco_tpu.obs.forensics import mask_metric_names
from draco_tpu.obs.forensics import record_value as jax_value
from draco_tpu.parallel.mesh import make_mesh_2d
from draco_tpu.parallel.sp_step import build_sp_train_setup as jax_setup
from draco_tpu_torch import params as params_mod
from draco_tpu_torch.analysis.registry import APPROX, LM_CI
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.obs.forensics import record_value
from draco_tpu_torch.parallel.sp_step import build_sp_train_setup
from draco_tpu_torch.parallel.token_loop import TokenLoop
from test_torch_lm_step import _flat, _momentum

torch.set_num_threads(1)

SEED = 428
LM = dict(network="TransformerLM", dataset="synthetic-text", lr=0.01,
          momentum=0.9, num_workers=8, worker_fail=1, err_mode="rev_grad",
          batch_size=2, max_steps=3, train_dir="", seed=SEED, **LM_CI)
LEGS = {
    "approx": APPROX,
    "approx_int8_sr": dict(APPROX, wire_dtype="int8",
                           shadow_round="stochastic"),
    "approx_tree": dict(APPROX, topology="tree", tree_fanout=4),
}
HOST = ("decode_residual_bound", "recovered_fraction")


def run_both(kw: dict) -> dict:
    """Steps 1 and 2 of ``kw`` in both packages: each step's metrics, its
    presence row and the flat parameters before and after."""
    jset = jax_setup(JaxConfig(eval_freq=0, log_every=1000,
                               **dict(kw, attn_impl="dense")),
                     make_mesh_2d(1, 1))
    jstate = jset.state
    init, _ = params_mod.from_jax(jax.device_get(jstate.params))
    cfg = TrainConfig(**kw)
    tset = build_sp_train_setup(cfg, device="cpu", init=init)
    # the port's schedules, tokens and presence rows, as its loop reads
    # them
    loop = TokenLoop(tset, cfg, quiet=True)
    tstate, lay = tset.state, tset.layout
    rec = {"cfg": cfg, "steps": [], "names": tset.metric_names,
           "jax_names": tuple(jset.metric_names)}
    before = init
    for step in (1, 2):
        toks, adv, present = loop.inputs(step)
        jargs = (jnp.asarray(toks), jnp.asarray(adv))
        if present is not None:
            jargs += (jnp.asarray(present),)
        jstate, jm = jset.train_step(jstate, *jargs)
        tstate, tm = tset.train_step(tstate, toks, adv, present)
        # the mask columns as their integer words
        st = {"jax": {k: jax_value(k, jm[k]) for k in tset.metric_names},
              "port": {k: record_value(k, v) for k, v in tm.items()},
              "present": present, "before": _flat(before, lay),
              "port_p": _flat(tstate.params, lay)}
        before, _ = params_mod.from_jax(jax.device_get(jstate.params))
        bufs, _ = params_mod.from_jax(
            jax.device_get(_momentum(jstate.opt_state)))
        for k, v in before.items():
            tstate.params[k].copy_(v)
        tstate.opt.bufs = bufs
        st["jax_p"] = _flat(before, lay)
        rec["steps"].append(st)
    return rec


def assert_update(rec) -> None:
    tol = 5e-2 if rec["cfg"].wire_dtype == "int8" else 1e-2
    for st in rec["steps"]:
        d_port, d_jax = st["port_p"] - st["before"], st["jax_p"] - st["before"]
        assert np.linalg.norm(d_jax) > 0
        assert np.linalg.norm(d_port - d_jax) <= tol * np.linalg.norm(d_jax)


def assert_common(rec) -> None:
    """The schema, the loss, the mask words and the presence."""
    cfg = rec["cfg"]
    assert rec["names"] == rec["jax_names"]
    for st in rec["steps"]:
        port, ref = st["port"], st["jax"]
        assert tuple(port)[:len(rec["names"])] == rec["names"]
        assert port["loss"] == pytest.approx(ref["loss"], rel=1e-4)
        if cfg.approach != "baseline":
            for k in mask_metric_names(cfg.num_workers):
                assert port[k] == ref[k], k
            present = st["present"]
            want = (2 ** cfg.num_workers - 1 if present is None
                    else sum(1 << i for i, p in enumerate(present) if p))
            assert port["wmask_present0"] == want


@pytest.fixture(scope="module", params=sorted(LEGS))
def leg(request):
    return request.param, run_both(dict(LM, **LEGS[request.param]))


def test_columns_and_certificate(leg):
    name, rec = leg
    assert_common(rec)
    for st in rec["steps"]:
        port, ref = st["port"], st["jax"]
        assert int(st["present"].sum()) == 6
        for k in HOST:
            assert port[k] == pytest.approx(ref[k], abs=1e-6), k
        assert port["recovered_fraction"] == ref["recovered_fraction"]
        assert 0.0 < port["recovered_fraction"] <= 1.0
        assert port["decode_residual"] == pytest.approx(
            ref["decode_residual"], rel=1e-2)
        assert port["decode_residual"] <= port["decode_residual_bound"] + 1e-5
        # no adversary and no accusation under the approx code
        assert port["wmask_adv0"] == port["wmask_accused0"] == 0


def test_update(leg):
    assert_update(leg[1])
