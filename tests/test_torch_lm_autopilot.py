"""The autopilot on the LM's chunked token loop (``control/autopilot.py``
through ``TokenChunkClient``), the port's counterparts of the reference's
``test_autopilot_dial_lm_sp`` (``tests/test_autopilot.py``, at its
configuration: the cyclic code at n=8, s=1, ``shared``, K=4, 24 steps, eval
every 4, worker 5 straggling at steps 3-10, the reference's compressed
policy and ``straggle.streak=2``; the reference's ``compile_guard``, which
the port has no counterpart of, aside):

  * sustained straggle dials the cyclic code down to approx r=1.5 (a new
    regime's setup on the loop's live model and state, its executable
    ``"compiled"``), clean evidence dials it back up (``"reused"``), each
    remediation naming its trigger; status.json's ``control`` block ends
    in ``cyclic_r3`` after 2 swaps;
  * the same at K=1 with device tokens (``token_gen="device"``), which
    ``config.validate`` admits under the autopilot as the reference does:
    the loop runs chunks of one step there, so the dial acts;
  * a quarantine and its readmit through the LM's presence table (the
    lifecycle of ``chip_smoke.py``'s phase 9: an adversary on worker 2 at
    steps 3-8, worker 5 straggling at 13-20, 32 steps): worker 2 absent
    from the quarantine's effective step + K to the readmit's effective
    step + K - 1 (each schedule write reaches the wire one assembled chunk
    later), the run ending in cyclic_r3 after 2 swaps, every update
    trusted.

At the reference test's size (dim 32, 2 heads, 1 layer, T=16, vocab 32,
batch 2).
"""

import json
import math
import os

import pytest
import torch

from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.obs import replay
from draco_tpu_torch.obs.forensics import record_masks
from draco_tpu_torch.parallel.sp_step import build_sp_train_setup
from draco_tpu_torch.parallel.token_loop import TokenLoop

torch.set_num_threads(1)

POLICY = ("dial_down_boundaries=1,clean_boundaries=1,"
          "dial_up_boundaries=2,readmit_boundaries=2,"
          "segments_up_boundaries=99")
THRESHOLDS = "straggle.streak=2"
LM = dict(network="TransformerLM", dataset="synthetic-text", batch_size=2,
          num_workers=8, max_steps=24, eval_freq=4, log_every=1,
          steps_per_call=4, approach="cyclic", worker_fail=1,
          adversary_count=0, err_mode="rev_grad", redundancy="shared",
          seq_len=16, vocab=32, model_dim=32, model_heads=2, model_layers=1,
          step_guard="on", incident_watch="on", autopilot="on",
          autopilot_policy=POLICY, incident_thresholds=THRESHOLDS,
          fault_spec="straggle@3-10:w5")
LIFECYCLE = dict(LM, max_steps=32,
                 fault_spec="adversary@3-8:w2,straggle@13-20:w5")
ORDERS = (["quarantine", "readmit", "dial_down", "dial_up"],
          ["quarantine", "dial_down", "readmit", "dial_up"])


def run(d, fields):
    cfg = TrainConfig(**{**fields, "train_dir": d}).validate()
    loop = TokenLoop(build_sp_train_setup(cfg, "cpu"), cfg, quiet=True)
    last = loop.run()
    rems = [e for e in replay.iter_jsonl(os.path.join(d, "incidents.jsonl"))
            if e.get("event") == "remediation"]
    with open(os.path.join(d, "status.json")) as f:
        status = json.load(f)
    return loop, last, rems, status


def assert_dial(loop, last, rems, status):
    assert math.isfinite(last["loss"])
    assert [e["action"] for e in rems] == ["dial_down", "dial_up"]
    assert all(e["trigger"] and e["trigger"]["type"] for e in rems)
    assert rems[0]["regime"]["tag"] == "approx_r1.5"
    assert rems[0]["evidence"]["executable"] == "compiled"
    assert rems[1]["evidence"]["executable"] == "reused"
    assert status["state"] == "done"
    assert status["control"]["regime"]["tag"] == "cyclic_r3"
    assert status["control"]["swaps"] == 2
    # both regimes on the loop's one model and state
    setups = loop._autopilot._setups
    assert len(setups) == 2
    assert all(s.state is loop.state and s.model is loop.setup.model
               for s in setups.values())


@pytest.mark.parametrize("fields", [
    LM, dict(LM, steps_per_call=1, token_gen="device")],
    ids=["k4", "k1_device_tokens"])
def test_autopilot_dial_lm(tmp_path, fields):
    assert_dial(*run(str(tmp_path / "lm"), fields))


def test_quarantine_and_readmit_through_the_lm_table(tmp_path):
    d = str(tmp_path / "lifecycle")
    loop, last, rems, status = run(d, LIFECYCLE)
    assert last["step"] == 32 and math.isfinite(last["loss"])
    actions = [e["action"] for e in rems]
    assert actions in ORDERS, actions
    by = {e["action"]: e for e in rems}
    assert by["quarantine"]["worker"] == 2
    assert by["quarantine"]["trigger"]["type"] == "trust"
    assert by["readmit"]["worker"] == 2
    k = LIFECYCLE["steps_per_call"]
    out = range(by["quarantine"]["effective_step"] + k,
                by["readmit"]["effective_step"] + k)
    recs = replay.train_records(os.path.join(d, "metrics.jsonl"))
    assert [r["step"] for r in recs] == list(range(1, 33))
    for r in recs:
        assert r["guard_trips"] == 0.0, r
        masks = record_masks(r, 8)
        assert masks["present"][2] == (r["step"] not in out), r["step"]
    c = status["control"]
    assert c["regime"]["tag"] == "cyclic_r3" and c["swaps"] == 2
    assert c["quarantined"] == [] and c["remediations"] == 4
    # the readmit gave worker 2 its schedule column back
    assert not loop.straggle_schedule[by["readmit"]["effective_step"]:, 2] \
        .any()
    assert int(loop.state.opt.count) == 32
