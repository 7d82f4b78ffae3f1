"""The step guard and the fault plan through the port's trainer against
the JAX package's K=1 trainer (FC on synthetic MNIST, the cyclic code at
n=8, s=1, ``shared``, a rev_grad adversary every step: the reference's
``tests/test_resilience.py`` configuration, on a one-device mesh):

  * guard on against guard off on a clean run: the same parameters and
    optimizer state bit for bit, every guard column zero;
  * ``nan_grad@2`` and ``over_budget@3`` on the f32 wire, ``over_budget@3``
    on the int8 wire: each step's guard columns those of the reference's
    run, the parameters within 1e-4 of their scale of the reference's
    (f32) and within 5e-2 of the run's update in relative L2 (the int8
    wire, whose rounding of the two frameworks' f32 rows differs by an
    ulp here and there); the skipped step's state the step before's bit
    for bit;
  * the port's K=3 chunked run bit for bit its eager run, faults and
    skips included;
  * a ``nan_grad`` run's ``incidents.jsonl`` with the reference's event
    types, steps and workers, its status.json (``guard`` and
    ``incidents`` blocks) through the reference's ``check_status_schema``,
    and the live episodes equal to an offline fold of its metrics.jsonl;
  * one LM step with ``inf_grad`` and the guard against
    ``draco_tpu.parallel.sp_step`` on a one-device mesh (2 layers, dim
    32): the skip and its columns the reference's, the parameters and the
    optimizer state unchanged.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from draco_tpu.config import TrainConfig as JaxConfig
from draco_tpu.data import datasets as jdatasets
from draco_tpu.obs import heartbeat as ref_hb
from draco_tpu.parallel.mesh import make_mesh_2d
from draco_tpu.parallel.sp_step import build_sp_train_setup as jax_lm
from draco_tpu.runtime import make_mesh
from draco_tpu.training.trainer import Trainer as JaxTrainer
from draco_tpu_torch import params as params_mod
from draco_tpu_torch import rng
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.data import datasets
from draco_tpu_torch.obs import incidents, replay
from draco_tpu_torch.parallel.sp_step import build_sp_train_setup
from draco_tpu_torch.parallel.sp_step import synthetic_text
from draco_tpu_torch.training.trainer import Trainer

torch.set_num_threads(1)

FC = dict(network="FC", dataset="synthetic-mnist", batch_size=4, lr=0.05,
          num_workers=8, approach="cyclic", worker_fail=1,
          redundancy="shared", err_mode="rev_grad", max_steps=4,
          eval_freq=0, log_every=1, step_guard="on", seed=428)
GUARD = ("guard_trips", "skipped_steps")


def load(pkg):
    return pkg.load_dataset("synthetic-mnist", synthetic_train=256,
                            synthetic_test=16)


@pytest.fixture(scope="module")
def ds():
    return load(datasets)


def records(d):
    return [r for r in replay.iter_jsonl(os.path.join(d, "metrics.jsonl"))
            if "loss" in r]


def port_run(ds, d="", steps=None, **kw):
    tr = Trainer(TrainConfig(**{**FC, **kw, "train_dir": d}), device="cpu",
                 dataset=ds, quiet=True)
    states = {}
    while tr.state.step <= (steps or tr.cfg.max_steps):
        last = tr.state.step
        tr.run(max_steps=last if tr.cfg.steps_per_call == 1 else None)
        states[last] = {k: v.clone() for k, v in tr.state.tensors().items()}
    tr.close()
    return tr, states


def ref_run(d, **kw):
    tr = JaxTrainer(JaxConfig(**{**FC, **kw, "train_dir": d}),
                    mesh=make_mesh(1), dataset=load(jdatasets), quiet=True)
    try:
        tr.run()
    finally:
        tr.close()
    return tr


def _flat(tree):
    return np.concatenate([np.ravel(x) for x in
                           jax.tree.leaves(jax.device_get(tree))])


def test_guard_is_transparent_on_a_clean_run(ds, tmp_path):
    on, _ = port_run(ds, str(tmp_path))
    off, _ = port_run(ds, step_guard="off")
    for k, v in off.state.tensors().items():
        assert torch.equal(on.state.tensors()[k], v), k
    recs = records(str(tmp_path))
    assert len(recs) == 4
    assert all(r["guard_trips"] == r["skipped_steps"] == 0.0 for r in recs)
    assert tuple(on.setup.metric_names[-2:]) == GUARD
    assert GUARD[0] not in off.setup.metric_names


@pytest.mark.parametrize("spec,wire,bad", (
    ("nan_grad@2", "f32", 2), ("over_budget@3", "f32", 3),
    ("over_budget@3", "int8", 3)))
def test_faults_against_the_reference(ds, tmp_path, spec, wire, bad):
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "ref")
    tr, states = port_run(ds, mine, fault_spec=spec, wire_dtype=wire)
    jtr = ref_run(theirs, fault_spec=spec, wire_dtype=wire)
    got, want = records(mine), records(theirs)
    assert [r["step"] for r in got] == [1, 2, 3, 4]
    for g, w in zip(got, want):
        assert (g["guard_trips"], g["skipped_steps"]) == (
            w["guard_trips"], w["skipped_steps"]), g["step"]
        assert g["skipped_steps"] == float(g["step"] == bad)
    # the skipped step leaves the state as the step before left it
    for k, v in states[bad].items():
        if k != "step":
            assert torch.equal(v, states[bad - 1][k]), k
    assert int(tr.state.opt.count) == 3 and tr.state.step == 5
    lay = tr.setup.layout
    p0 = _flat(JaxTrainer(JaxConfig(**{**FC, "train_dir": ""}),
                          mesh=make_mesh(1), dataset=load(jdatasets),
                          quiet=True).state.params)
    ref_p = _flat(jtr.state.params)
    port_p = params_mod.flatten(tr.state.params, lay).numpy()
    assert np.all(np.isfinite(port_p))
    if wire == "f32":
        np.testing.assert_allclose(port_p, ref_p, rtol=0,
                                   atol=1e-4 * np.abs(ref_p).max())
    else:
        assert np.linalg.norm(port_p - ref_p) <= 5e-2 * np.linalg.norm(
            ref_p - p0)


def test_chunks_are_the_eager_run_bit_for_bit(ds):
    spec = "nan_grad@2,inf_grad@5:w3,over_budget@4"
    eager, _ = port_run(ds, steps=6, fault_spec=spec, max_steps=6)
    chunked, _ = port_run(ds, steps=6, fault_spec=spec, max_steps=6,
                          steps_per_call=3)
    for k, v in eager.state.tensors().items():
        assert torch.equal(chunked.state.tensors()[k], v), k
    assert int(eager.state.opt.count) == 3


def _episodes(path):
    return [(e["event"], e["type"], e["onset_step"], e["workers"])
            for e in replay.iter_jsonl(path)]


def test_nan_grad_incidents_and_status(ds, tmp_path):
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "ref")
    kw = dict(fault_spec="nan_grad@2", incident_watch="on", max_steps=8)
    tr, _ = port_run(ds, mine, **kw)
    ref_run(theirs, **kw)
    got = _episodes(os.path.join(mine, "incidents.jsonl"))
    assert got == _episodes(os.path.join(theirs, "incidents.jsonl"))
    victim = tr.fault_plan.events[0].worker
    assert ("onset", "guard", 2, sorted({victim, *got[0][3]})) in got
    assert victim in got[0][3]
    status = json.load(open(os.path.join(mine, "status.json")))
    ref_hb.check_status_schema(status)
    assert status["guard"] == {"trips": status["guard"]["trips"],
                               "skipped_steps": 1.0}
    assert status["guard"]["trips"] >= 1.0
    assert status["incidents"]["by_type"] == {"guard": 1}
    assert status["state"] == "done"
    # the offline fold of metrics.jsonl gives the live episodes
    eng = incidents.IncidentEngine(num_workers=8)
    for r in replay.train_records(os.path.join(mine, "metrics.jsonl")):
        eng.observe(r)
    live = json.load(open(os.path.join(mine, "status.json")))["incidents"]
    assert eng.status_block() == live


def test_lm_inf_grad_step_against_the_reference():
    kw = dict(network="TransformerLM", dataset="synthetic-text", lr=1e-3,
              num_workers=8, worker_fail=1, err_mode="rev_grad",
              batch_size=2, seq_len=16, vocab=32, model_dim=32,
              model_heads=2, model_layers=2, max_steps=3, train_dir="",
              seed=428, approach="cyclic", redundancy="shared",
              optimizer="adamw", lr_schedule="cosine", warmup_steps=1,
              clip_norm=1.0, step_guard="on", fault_spec="inf_grad@2:w5")
    jset = jax_lm(JaxConfig(eval_freq=0, log_every=1000, **kw),
                  make_mesh_2d(1, 1))
    init, _ = params_mod.from_jax(jax.device_get(jset.state.params))
    tset = build_sp_train_setup(TrainConfig(**kw), device="cpu", init=init)
    adv = rng.adversary_schedule(428, 3, 8, 1)
    jstate = jset.state
    for step in (1, 2):
        toks = synthetic_text(428, step, 8, 2, 16, 32)
        before = {k: v.clone() for k, v in tset.state.tensors().items()}
        jstate, jm = jset.train_step(jstate, jnp.asarray(toks),
                                     jnp.asarray(adv[step]))
        _, m = tset.train_step(tset.state, toks, adv[step])
        for k in GUARD:
            assert float(m[k]) == float(jm[k]), (step, k)
        assert float(m["skipped_steps"]) == float(step == 2)
    for k, v in tset.state.tensors().items():
        assert torch.equal(v, before[k]), k
    assert int(tset.state.opt.count) == 1 and tset.state.step == 3
    ref_p, _ = params_mod.from_jax(jax.device_get(jstate.params))
    lay = tset.layout
    got = params_mod.flatten(tset.state.params, lay).numpy()
    want = params_mod.flatten(ref_p, lay).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
