"""The port's run heartbeat (``draco_tpu_torch/obs/heartbeat.py``) against
the JAX package's (``draco_tpu/obs/heartbeat.py``), and status.json from
the port's loops on the CPU (LeNet on synthetic MNIST, the cyclic code at
n=5, s=1, a rev_grad adversary every step; the TransformerLM at a few
layers):

  * the same records folded by both heartbeats give the same
    ``decode_health``, ``forensics``, ``numerics`` and ``wire`` blocks and
    the same loss (the records: cyclic, vote and approx columns, packed
    masks with absences, shadow columns with a sentinel step, an eval
    record);
  * a chunked watch run's status.json passes the reference's
    ``check_status_schema`` at schema 5 with its ``forensics``, ``wire``
    and ``numerics`` blocks, ends ``done``, and its forensics block is the
    reference's ledger over the run's records and its wire block the
    reference's ledger of the same configuration; the eager loop and the
    LM loop's too;
  * ``run_id`` survives a resume; an exception writes ``crashed`` with
    its cause; a SIGTERM writes ``preempted`` with ``resumable_step``.

No XLA compile: the reference's heartbeat, ledger and schema check are
host code. Exact equality throughout.
"""

import json
import os
import signal

import numpy as np
import pytest
import torch

from draco_tpu.config import TrainConfig as JaxConfig
from draco_tpu.obs import forensics as ref_forensics
from draco_tpu.obs import heartbeat as ref_hb
from draco_tpu.obs import numerics as ref_numerics
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.data import datasets
from draco_tpu_torch.obs import forensics, heartbeat
from draco_tpu_torch.obs import numerics
from draco_tpu_torch.parallel.sp_step import build_sp_train_setup
from draco_tpu_torch.parallel.token_loop import TokenLoop
from draco_tpu_torch.training.trainer import Trainer

torch.set_num_threads(1)

LENET = dict(network="LeNet", dataset="synthetic-mnist", approach="cyclic",
             redundancy="shared", num_workers=5, worker_fail=1,
             err_mode="rev_grad", batch_size=2, max_steps=6, eval_freq=0,
             log_every=1, test_batch_size=8, seed=428)
LM = dict(network="TransformerLM", dataset="synthetic-text",
          approach="cyclic", redundancy="shared", num_workers=5,
          worker_fail=1, batch_size=1, seq_len=16, vocab=32, model_dim=32,
          model_heads=2, model_layers=1, max_steps=3, eval_freq=0,
          log_every=1, seed=428)
# the fields a beat stamps from the clock or a fresh id
CLOCK = ("updated_at", "steps_per_s", "eta_s", "run_id")


@pytest.fixture(scope="module")
def mnist():
    return datasets.load_dataset("synthetic-mnist", synthetic_train=128,
                                 synthetic_test=12)


def _records(n: int, steps: int) -> list:
    rs = np.random.RandomState(7)
    out = []
    for t in range(1, steps + 1):
        present = rs.rand(n) > 0.2
        adv = np.zeros(n, bool)
        adv[t % n] = True
        accused = adv & present
        rec = {"step": t, "loss": 2.0 / t, "prec1": 0.1 * (t % 3),
               "decode_residual": 1e-7 * t, "located_errors": 1.0,
               "det_tp": float(accused.sum()), "det_adv": 1.0,
               "honest_located": 3.0, "nx_grad_absmax": 1.5 * t,
               "nx_wire_rms": 0.25, "nx_wire_uf_int8": 0.01 * (t % 4),
               "shadow_err": -1.0 if t == 3 else 0.002 * t,
               "shadow_flag_agree": 1.0 - 0.1 * (t % 2)}
        cols = forensics.pack_mask_columns(torch.from_numpy(accused),
                                           torch.from_numpy(present),
                                           torch.from_numpy(adv))
        rec.update({k: forensics.record_value(k, v) for k, v in cols.items()})
        out.append(rec)
    out.insert(2, {"step": 2, "split": "eval", "loss": 0.5})
    out.append({"step": steps + 1, "loss": 0.1, "decode_residual": 0.2,
                "decode_residual_bound": 0.4, "recovered_fraction": 0.75})
    return out


def _strip(payload: dict) -> dict:
    return {k: v for k, v in payload.items() if k not in CLOCK}


def test_the_fold_is_the_references(tmp_path):
    n = 5
    cfg = TrainConfig(**LENET)
    mine = heartbeat.RunHeartbeat(str(tmp_path / "a"), num_workers=n,
                                  job_name="job-1")
    theirs = ref_hb.RunHeartbeat(str(tmp_path / "b"), num_workers=n,
                                 job_name="job-1")
    ledger = numerics.wire_ledger(cfg, 44_426)
    mine.set_wire(ledger)
    theirs.set_wire(ref_numerics.wire_ledger(JaxConfig(**LENET), 44_426))
    for rec in _records(n, 9):
        mine.observe(rec)
        theirs.observe(rec)
    a, b = mine.beat(10, 12), theirs.beat(10, 12)
    assert _strip(a) == _strip(b)
    assert a["forensics"]["accused_total"] > 0
    assert a["numerics"]["shadow_sentinel_steps"] == 1
    ref_hb.check_status_schema(a)
    for state, kw in (("done", {}), ("preempted", {"resumable_step": 9}),
                      ("crashed", {"cause": "ValueError: x"})):
        assert (_strip(mine.terminal(state, **kw))
                == _strip(theirs.terminal(state, **kw)))
    assert heartbeat.STATUS_SCHEMA == ref_hb.STATUS_SCHEMA == 5
    assert heartbeat.STATUS_BLOCKS == ref_hb.STATUS_BLOCKS


def _status(d) -> dict:
    with open(os.path.join(d, "status.json")) as f:
        return json.load(f)


def _metrics(d) -> list:
    with open(os.path.join(d, "metrics.jsonl")) as f:
        return [json.loads(x) for x in f]


def _held(d, fields: dict, dim: int, state: str = "done") -> dict:
    status = ref_hb.check_status_schema(_status(d))
    assert status["schema"] == 5 and status["state"] == state
    ledger = ref_forensics.AccusationLedger(fields["num_workers"])
    for rec in _metrics(d):
        ledger.observe(rec)
    assert status["forensics"] == ledger.summary()
    assert status["forensics"]["accused_total"] == ledger.steps > 0
    assert status["wire"] == ref_numerics.wire_ledger(JaxConfig(**fields),
                                                      dim)
    return status


@pytest.mark.parametrize("K", [1, 2])
def test_a_watch_run_writes_the_reference_status(tmp_path, mnist, K):
    fields = dict(LENET, numerics_watch="on", shadow_wire="bf16",
                  steps_per_call=K, job_name="lenet-watch")
    d = str(tmp_path / "run")
    tr = Trainer(TrainConfig(**fields, train_dir=d), device="cpu",
                 dataset=mnist, quiet=True)
    last = tr.run()
    status = _held(d, fields, tr.setup.dim)
    assert status["step"] == last["step"] == 6
    assert status["job_name"] == "lenet-watch"
    assert status["numerics"]["shadow_flag_agree_min"] == 1.0
    assert status["decode_health"]["precision"] == 1.0
    # every step's record: the adversary accused, all present
    for rec in _metrics(d):
        assert rec["wmask_accused0"] == rec["wmask_adv0"] != 0
        assert rec["wmask_present0"] == 0b11111


def test_the_lm_loop_writes_its_status(tmp_path):
    d = str(tmp_path / "lm")
    cfg = TrainConfig(**LM, train_dir=d)
    loop = TokenLoop(build_sp_train_setup(cfg, "cpu"), cfg, quiet=True)
    loop.run()
    status = _held(d, LM, loop.setup.dim)
    assert status["forensics"]["steps"] == 3


def test_run_id_survives_a_resume(tmp_path, mnist):
    d = str(tmp_path / "run")
    fields = dict(LENET, max_steps=2, eval_freq=2, train_dir=d)
    Trainer(TrainConfig(**fields), device="cpu", dataset=mnist,
            quiet=True).run()
    first = _status(d)
    resumed = Trainer(TrainConfig(**dict(fields, max_steps=4,
                                         checkpoint_step=-1)),
                      device="cpu", dataset=mnist, quiet=True)
    assert resumed.state.step == 3
    resumed.run()
    again = _status(d)
    assert again["run_id"] == first["run_id"] and again["state"] == "done"
    assert again["step"] == 4
    other = str(tmp_path / "other")
    Trainer(TrainConfig(**dict(fields, train_dir=other)), device="cpu",
            dataset=mnist, quiet=True).run()
    assert _status(other)["run_id"] != first["run_id"]


def test_a_crash_writes_crashed(tmp_path, mnist):
    d = str(tmp_path / "run")
    tr = Trainer(TrainConfig(**dict(LENET, train_dir=d)), device="cpu",
                 dataset=mnist, quiet=True)
    step = tr.setup.train_step

    def failing(state, *args, **kw):
        if state.step == 3:
            raise RuntimeError("boom at 3")
        return step(state, *args, **kw)

    tr.setup = tr.setup._replace(train_step=failing)
    with pytest.raises(RuntimeError, match="boom at 3"):
        tr.run()
    status = ref_hb.check_status_schema(_status(d))
    assert status["state"] == "crashed"
    assert status["cause"] == "RuntimeError: boom at 3"


@pytest.mark.parametrize("K", [1, 2])
def test_a_graceful_stop_writes_preempted(tmp_path, mnist, K):
    d = str(tmp_path / "run")
    tr = Trainer(TrainConfig(**dict(LENET, train_dir=d, steps_per_call=K)),
                 device="cpu", dataset=mnist, quiet=True)
    if K == 1:
        step_fn = tr.step

        def wrapped():
            rec = step_fn()
            if rec["step"] == 3:
                tr._stop.deliver_signal(signal.SIGTERM)
            return rec
        tr.step = wrapped
    else:
        make = tr.chunk_client

        def chunk_client(first, last):
            client = make(first, last)
            dispatch = client.dispatch

            def fired(state, chunk):
                out = dispatch(state, chunk)
                if chunk.start <= 3 < chunk.start + chunk.k:
                    tr._stop.deliver_signal(signal.SIGTERM)
                return out
            client.dispatch = fired
            return client
        tr.chunk_client = chunk_client
    tr.run()
    stop = 3 if K == 1 else 4
    assert tr.stopped_step == stop
    status = ref_hb.check_status_schema(_status(d))
    assert status["state"] == "preempted"
    assert status["resumable_step"] == stop
    assert status["cause"] == "graceful stop on SIGTERM"
