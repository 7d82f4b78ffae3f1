"""The autopilot's lifecycle on the CNN Trainer, the port's against the JAX
package's (the reference's ``tests/test_autopilot.py`` scenario: FC on
synthetic MNIST, the cyclic code at n=8, s=1, ``shared``, K=4, 32 steps,
an adversary on worker 2 at steps 3-8 and worker 5 straggling at 13-20,
the reference's compressed policy and ``straggle.streak=2``; the
reference on a one-device mesh):

  * the remediation lines of incidents.jsonl equal the reference's in
    every field but the wall-clock ``ts``: quarantine(2) -> readmit ->
    dial_down to approx_r1.5 (``"compiled"``) -> dial_up (``"reused"``);
  * status.json's ``control`` block equal (its last remediation's ``ts``
    aside), ending in cyclic_r3 after 2 swaps;
  * every step's ``wmask_*`` words equal exactly, so every present bit,
    and worker 2 absent exactly from the quarantine's effective_step + K
    to the readmit's effective_step + K - 1 (each schedule write reaches
    the wire one assembled chunk later);
  * the update's columns (loss, prec1, the approx decode's bound and
    recovered fraction) within 1e-5 relative of the reference's, the
    decode residual (float32 noise of an exact solve) within 1e-5, the
    final parameters within 2e-5 of their scale;
  * one step graph a regime: the autopilot caches two setups, each runner
    built one StepGraph (on the CPU a plain loop: no capture), the same
    object before and after the return, and both setups share the
    Trainer's model and state.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from draco_tpu.config import TrainConfig as JaxConfig
from draco_tpu.data import datasets as jdatasets
from draco_tpu.runtime import make_mesh
from draco_tpu.training.trainer import Trainer as JaxTrainer
from draco_tpu_torch import params as params_mod
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.data import datasets
from draco_tpu_torch.obs import replay
from draco_tpu_torch.obs.forensics import MASK_PREFIX, record_masks
from draco_tpu_torch.training.trainer import Trainer

torch.set_num_threads(1)

# the reference's compressed hysteresis (tests/test_autopilot.py)
POLICY = ("dial_down_boundaries=1,clean_boundaries=1,"
          "dial_up_boundaries=2,readmit_boundaries=2,"
          "segments_up_boundaries=99")
THRESHOLDS = "straggle.streak=2"
FC = dict(network="FC", dataset="synthetic-mnist", batch_size=4, lr=0.02,
          momentum=0.9, num_workers=8, eval_freq=4, log_every=1,
          steps_per_call=4, approach="cyclic", worker_fail=1,
          adversary_count=0, err_mode="rev_grad", redundancy="shared",
          step_guard="on", incident_watch="on", autopilot="on",
          incident_thresholds=THRESHOLDS)
LIFECYCLE = dict(FC, max_steps=32, autopilot_policy=POLICY,
                 fault_spec="adversary@3-8:w2,straggle@13-20:w5")
# the update's columns, within RTOL of the reference's
UPDATE_COLS = ("loss", "prec1", "decode_residual_bound",
               "recovered_fraction")
RTOL = 1e-5
NOISE = 1e-5  # an exact decode's residual: float32 noise of its solve


def _data(pkg):
    return pkg.load_dataset("synthetic-mnist", synthetic_train=512,
                            synthetic_test=64)


def run_both(tmp_path, fields):
    """The same configuration through both Trainers; each run's train_dir
    and the port's Trainer (closed)."""
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    jtr = JaxTrainer(JaxConfig(**{**fields, "train_dir": ref_dir}),
                     mesh=make_mesh(1), dataset=_data(jdatasets), quiet=True)
    try:
        jtr.run()
        ref_params = np.concatenate([
            np.ravel(np.asarray(x))
            for x in jax.tree.leaves(jtr.state.params)])
    finally:
        jtr.close()
    tr = Trainer(TrainConfig(**{**fields, "train_dir": port_dir}),
                 device="cpu", dataset=_data(datasets), quiet=True)
    try:
        last = tr.run()
    finally:
        tr.close()
    assert last["step"] == fields["max_steps"] and np.isfinite(last["loss"])
    return ref_dir, port_dir, tr, ref_params


def remediations(d):
    return [e for e in replay.iter_jsonl(os.path.join(d, "incidents.jsonl"))
            if e.get("event") == "remediation"]


def without_ts(e):
    return {k: v for k, v in e.items() if k != "ts"}


def control_block(d):
    with open(os.path.join(d, "status.json")) as f:
        st = json.load(f)
    assert st["state"] == "done" and st["schema"] == 5
    c = dict(st["control"])
    if c.get("last"):
        c["last"] = without_ts(c["last"])
    return c, st


def assert_same_remediations(ref_dir, port_dir):
    ref, port = remediations(ref_dir), remediations(port_dir)
    assert [without_ts(e) for e in port] == [without_ts(e) for e in ref]
    assert control_block(port_dir)[0] == control_block(ref_dir)[0]
    return port


def assert_same_records(ref_dir, port_dir, n):
    """Every step's mask words exactly, the update's columns within
    RTOL."""
    ref = replay.train_records(os.path.join(ref_dir, "metrics.jsonl"))
    port = replay.train_records(os.path.join(port_dir, "metrics.jsonl"))
    assert [r["step"] for r in port] == [r["step"] for r in ref]
    for a, b in zip(port, ref):
        words = sorted(k for k in b if k.startswith(MASK_PREFIX))
        assert words and {k: a[k] for k in words} == {k: b[k]
                                                      for k in words}, a
        assert list(record_masks(a, n)["present"]) == \
            list(record_masks(b, n)["present"])
        for k in UPDATE_COLS:
            if k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=RTOL,
                                           atol=1e-7, err_msg=f"{k} {a}")
        # the residual of an exact decode is float32 noise of the solve
        np.testing.assert_allclose(a["decode_residual"],
                                   b["decode_residual"], rtol=RTOL,
                                   atol=NOISE, err_msg=str(a))
    return port


def assert_one_graph_a_regime(tr, regimes):
    """The autopilot's cache holds ``regimes`` setups, all on the
    Trainer's model and state, each with one StepGraph."""
    pilot = tr._autopilot
    assert sorted(r.tag for r in pilot._setups) == sorted(regimes)
    graphs = []
    for setup in pilot._setups.values():
        assert setup.model is tr.setup.model and setup.state is tr.state
        graph = setup.train_many.graph()
        assert graph is not None and graph.captures == 0  # no card here
        graphs.append(graph)
    assert len({id(g) for g in graphs}) == len(regimes)
    return graphs


@pytest.fixture(scope="module")
def lifecycle(tmp_path_factory):
    return run_both(tmp_path_factory.mktemp("lifecycle"), LIFECYCLE)


def test_the_lifecycle_remediations_are_the_references(lifecycle):
    ref_dir, port_dir, _, _ = lifecycle
    rems = assert_same_remediations(ref_dir, port_dir)
    actions = [e["action"] for e in rems]
    assert actions in (["quarantine", "readmit", "dial_down", "dial_up"],
                       ["quarantine", "dial_down", "readmit", "dial_up"])
    by = {e["action"]: e for e in rems}
    assert by["quarantine"]["worker"] == 2
    assert by["dial_down"]["regime"]["tag"] == "approx_r1.5"
    assert by["dial_down"]["evidence"]["executable"] == "compiled"
    assert by["dial_up"]["evidence"]["executable"] == "reused"
    c, st = control_block(port_dir)
    assert c["regime"]["tag"] == "cyclic_r3" == c["base_regime"]
    assert c["swaps"] == 2 and c["quarantined"] == []
    assert st["guard"]["trips"] == 0.0


def test_the_lifecycle_records_are_the_references(lifecycle):
    ref_dir, port_dir, _, _ = lifecycle
    recs = assert_same_records(ref_dir, port_dir, 8)
    by = {e["action"]: e for e in remediations(port_dir)}
    # each schedule write reaches the wire one assembled chunk after its
    # effective step: worker 2 is out from the quarantine's effective step
    # + K to the readmit's effective step + K - 1
    k = LIFECYCLE["steps_per_call"]
    out = range(by["quarantine"]["effective_step"] + k,
                by["readmit"]["effective_step"] + k)
    assert len(out) == k
    for r in recs:
        present = record_masks(r, 8)["present"]
        assert bool(present[2]) == (r["step"] not in out), r["step"]
        assert r["guard_trips"] == 0.0
    # the approx regime's records carry its certificate, the cyclic ones
    # the locator's count
    down, up = by["dial_down"]["effective_step"], by["dial_up"]["step"]
    for r in recs:
        approx = down <= r["step"] <= up
        assert ("decode_residual_bound" in r) == approx, r["step"]
        assert ("honest_located" in r) == (not approx), r["step"]


def test_the_lifecycle_shares_one_state_and_one_graph_a_regime(lifecycle):
    _, _, tr, ref_params = lifecycle
    assert_one_graph_a_regime(tr, ("cyclic_r3", "approx_r1.5"))
    port = params_mod.flatten(tr.state.params, tr.setup.layout).numpy()
    np.testing.assert_allclose(port, ref_params, rtol=0,
                               atol=2e-5 * float(np.abs(ref_params).max()))
    # the update count advanced every trusted step, across the swaps
    assert int(tr.state.opt.count) == LIFECYCLE["max_steps"]
