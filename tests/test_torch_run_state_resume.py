"""The port's own resume, graceful stop and entry points on the CPU, each
held bit for bit to the uninterrupted run (no JAX):

  * LeNet (the cyclic code, n=5, s=1) eager and at K=2, and ResNet-18 at
    CI size (BatchNorm) at K=2: resumed from step 2's checkpoint, the
    records and every state tensor at the end are the uninterrupted run's;
    ``restore`` on a setup whose chunk already ran keeps every tensor's
    storage (``data_ptr``) and replays to the same end;
  * SIGTERM, eager and at K=2: the run stops at the step or chunk end with
    a checkpoint, and ``checkpoint_step=-1`` resumes it to the
    uninterrupted end; a second signal inside a dispatch checkpoints the
    newest whole state at once, which resumes the same way; −1 on an empty
    train_dir starts fresh, a missing explicit step raises;
  * elasticity: a cyclic n=8 FC checkpoint resumes a geometric-median n=6
    run, a constant-schedule one a cosine run;
  * the LM token loop, eager and at K=2: checkpoints at its eval
    boundaries, ``steps`` more from the resumed step (the reference's LM
    semantics), the last state saved when ``eval_freq`` is 0, and its
    SIGTERM round trip at K=2;
  * ``single_machine.main`` and ``evaluator.main --once``.
"""

import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import signal

import numpy as np
import pytest
import torch

from draco_tpu_torch import single_machine
from draco_tpu_torch.analysis import registry
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.data import datasets
from draco_tpu_torch.parallel.sp_step import build_sp_train_setup
from draco_tpu_torch.parallel.token_loop import TokenLoop, run_token_loop
from draco_tpu_torch.training import evaluator
from draco_tpu_torch.training.trainer import Trainer
from draco_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

LENET = dict(network="LeNet", dataset="synthetic-mnist", approach="cyclic",
             redundancy="shared", num_workers=5, worker_fail=1,
             err_mode="rev_grad", batch_size=2, max_steps=6, eval_freq=2,
             log_every=1, test_batch_size=8, seed=428)


@pytest.fixture(scope="module")
def mnist():
    return datasets.load_dataset("synthetic-mnist", synthetic_train=128,
                                 synthetic_test=12)


def snapshot(state):
    return {k: v.detach().clone() for k, v in state.tensors().items()}


def bits(t):
    """The tensor's bits (NaN payloads and the sign of zero count)."""
    t = t.reshape(-1)
    if t.dtype.is_floating_point:
        t = t.view({2: torch.int16, 4: torch.int32,
                    8: torch.int64}[t.element_size()])
    return t


def assert_same_state(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(bits(a[k]), bits(b[k])), k


def records(d):
    rows = [json.loads(x) for x in open(os.path.join(d, "metrics.jsonl"))]
    return [{k: v for k, v in r.items() if k != "step_ms"} for r in rows]


def trainer(kw, d, ds, **fields):
    return Trainer(TrainConfig(**dict(kw, train_dir=d, **fields)),
                   device="cpu", dataset=ds, quiet=True)


def clean_run(kw, tmp, ds, **fields):
    d = str(tmp / "clean")
    tr = trainer(kw, d, ds, **fields)
    tr.run()
    return d, tr, snapshot(tr.state)


@pytest.mark.parametrize("K", [1, 2])
def test_lenet_resume_is_the_uninterrupted_run(tmp_path, mnist, K):
    d, _, end = clean_run(LENET, tmp_path, mnist, steps_per_call=K)
    assert ckpt.available_steps(d) == [2, 4, 6]
    r = str(tmp_path / "resumed")
    os.makedirs(r)
    for f in ("model_step_2.dcg", "model_step_2.dcg.sha256"):
        shutil.copy(os.path.join(d, f), r)
    tr = trainer(LENET, r, mnist, steps_per_call=K, checkpoint_step=2)
    assert tr.state.step == 3
    tr.run()
    assert_same_state(snapshot(tr.state), end)
    clean = records(d)
    assert records(r) == clean[[r_["step"] for r_ in clean].index(3):]
    assert ckpt.available_steps(r) == [2, 4, 6]


def test_restore_keeps_storage_after_a_chunk_ran(tmp_path):
    """ResNet-18 at CI size (its BN statistics among the state), K=2: a
    restore into the setup whose chunk runner already ran keeps every
    tensor's storage, and the replay from there reaches the same end."""
    ds = datasets.load_dataset("synthetic-cifar10", synthetic_train=64,
                               synthetic_test=4)
    d = str(tmp_path)
    cfg = registry.get("geomedian").config(
        False, max_steps=4, steps_per_call=2, eval_freq=2, train_dir=d,
        num_workers=2, test_batch_size=4)
    tr = Trainer(cfg, device="cpu", dataset=ds, quiet=True)
    tr.run()
    end = snapshot(tr.state)
    assert any(k.startswith("stats/") for k in end)
    ptrs = {k: v.data_ptr() for k, v in tr.state.tensors().items()}
    assert tr.restore(2) == 2 and tr.state.step == 3
    assert {k: v.data_ptr() for k, v in tr.state.tensors().items()} == ptrs
    at2 = ckpt.load(d, 2, tr.state.specs(tr.setup.layout))
    for a, b in zip(tr.state.arrays(tr.setup.layout), at2):
        np.testing.assert_array_equal(a, b)
    assert tr.setup.train_many.graph() is not None  # the chunk ran before
    tr.run()
    assert_same_state(snapshot(tr.state), end)


def _signal_at(tr, step, times):
    """Deliver ``times`` SIGTERMs from inside the dispatch that runs
    ``step`` (eager: the step; chunked: the chunk holding it)."""
    def fire():
        for _ in range(times):
            tr._stop.deliver_signal(signal.SIGTERM)

    if tr.cfg.steps_per_call == 1:
        step_fn = tr.step

        def wrapped():
            rec = step_fn()
            if rec["step"] == step:
                fire()
            return rec
        tr.step = wrapped
        return
    make = tr.chunk_client

    def chunk_client(first, last):
        client = make(first, last)
        dispatch = client.dispatch

        def wrapped(state, chunk):
            out = dispatch(state, chunk)
            if chunk.start <= step < chunk.start + chunk.k:
                fire()
            return out
        client.dispatch = wrapped
        return client
    tr.chunk_client = chunk_client


@pytest.mark.parametrize("K,times,stops_at", [
    (1, 1, 3), (2, 1, 4), (1, 2, 3), (2, 2, 4)],
    ids=["eager", "chunked", "eager-escalated", "chunked-escalated"])
def test_sigterm_round_trip(tmp_path, mnist, K, times, stops_at):
    _, _, end = clean_run(LENET, tmp_path, mnist, steps_per_call=K)
    d = str(tmp_path / "stopped")
    tr = trainer(LENET, d, mnist, steps_per_call=K)
    _signal_at(tr, 3, times)
    last = tr.run()
    assert tr.stopped_step == stops_at and tr.state.step == stops_at + 1
    assert (last == {}) == (times == 2)
    assert ckpt.available_steps(d)[-1] == stops_at
    resumed = trainer(LENET, d, mnist, steps_per_call=K, checkpoint_step=-1)
    assert resumed.state.step == stops_at + 1
    resumed.run()
    assert resumed.stopped_step is None
    assert_same_state(snapshot(resumed.state), end)


def test_minus_one_on_an_empty_dir_starts_fresh(tmp_path, mnist, capsys):
    _, _, end = clean_run(LENET, tmp_path, mnist)
    tr = trainer(LENET, str(tmp_path / "empty"), mnist, checkpoint_step=-1)
    assert "starting fresh" in capsys.readouterr().out
    tr.run()
    assert_same_state(snapshot(tr.state), end)
    with pytest.raises(FileNotFoundError):
        trainer(LENET, str(tmp_path / "e2"), mnist, checkpoint_step=7)


def test_elastic_and_schedule_switch_resume(tmp_path, mnist):
    fc = dict(network="FC", dataset="synthetic-mnist", batch_size=2,
              max_steps=3, eval_freq=2, test_batch_size=12, log_every=1000,
              seed=428)
    d = str(tmp_path)
    trainer(dict(fc, approach="cyclic", redundancy="shared", num_workers=8,
                 worker_fail=1), d, mnist).run()
    for fields in (dict(approach="baseline", mode="geometric_median",
                        num_workers=6, worker_fail=1),
                   dict(approach="cyclic", redundancy="shared",
                        num_workers=8, worker_fail=1, lr_schedule="cosine",
                        warmup_steps=1)):
        tr = trainer(dict(fc, **fields), d, mnist, checkpoint_step=2)
        lay = tr.setup.layout
        want = ckpt.load(d, 2, tr.state.specs(lay))
        for a, b in zip(tr.state.arrays(lay), want):
            np.testing.assert_array_equal(a, b)
        assert int(tr.state.opt.count) == 2 and tr.state.step == 3
        last = tr.run()
        assert last["step"] == 3 and np.isfinite(last["loss"])


LM = dict(registry.LM_FULL, **registry.LM_CI, approach="cyclic",
          redundancy="shared", attn_impl="flash", num_workers=5,
          eval_freq=2, log_every=1)


@pytest.mark.parametrize("K", [1, 2])
def test_lm_resume_is_the_uninterrupted_run(tmp_path, K):
    d = str(tmp_path / "clean")
    cfg = TrainConfig(**dict(LM, max_steps=4, steps_per_call=K,
                             train_dir=d))
    state, last = run_token_loop(build_sp_train_setup(cfg, "cpu"), cfg,
                                 quiet=True)
    end = snapshot(state)
    assert last["step"] == 4 and ckpt.available_steps(d) == [2, 4]
    # resumed from step 2 the loop runs `steps` more: 2 reach step 4
    rcfg = dataclasses.replace(cfg, checkpoint_step=2)
    rstate, rlast = run_token_loop(build_sp_train_setup(rcfg, "cpu"), rcfg,
                                   steps=2, quiet=True)
    assert rlast["step"] == 4 and rlast["loss"] == last["loss"]
    assert_same_state(snapshot(rstate), end)
    evals = [r for r in records(d) if r.get("split") == "eval"]
    assert [r["step"] for r in evals] == [2, 4, 4]  # the resumed run's too


def test_lm_without_eval_saves_its_last_state(tmp_path):
    d = str(tmp_path)
    cfg = TrainConfig(**dict(LM, max_steps=3, eval_freq=0, train_dir=d,
                             compress_ckpt=True))
    loop = TokenLoop(build_sp_train_setup(cfg, "cpu"), cfg, quiet=True)
    loop.run()
    assert ckpt.available_steps(d) == [3]
    ckpt.verify(d, 3)
    arrays = ckpt.load(d, 3, loop.state.specs(loop.setup.layout))
    assert arrays[-1] == 4  # the step leaf: the next step to run


def test_single_machine_and_the_evaluator(tmp_path):
    d = str(tmp_path)
    flags = ["--network", "LeNet", "--dataset", "synthetic-mnist",
             "--train-dir", d, "--device", "cpu", "--test-batch-size", "1000"]
    last = single_machine.main(flags + [
        "--batch-size", "4", "--max-steps", "4", "--eval-freq", "2",
        "--log-every", "1000", "--num-workers", "8", "--worker-fail", "2"])
    assert last["step"] == 4 and np.isfinite(last["loss"])
    assert ckpt.available_steps(d) == [2, 4]
    evals = {r["step"]: r["prec1_test"] for r in records(d)
             if "prec1_test" in r}
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = evaluator.main(flags + ["--num-workers", "1", "--once"])
    steps = re.findall(r"Cur Step:(\d+) Prec@1: ([0-9.]+)", out.getvalue())
    assert [int(s) for s, _ in steps] == [2, 4]
    assert [(s, p1) for s, p1, _ in got] == sorted(evals.items())
    lm = TrainConfig(network="TransformerLM", dataset="synthetic-text",
                     tensor_shards=2)
    with pytest.raises(SystemExit, match="one-device path"):
        single_machine.run(lm, "cpu")


def test_lm_sigterm_round_trip(tmp_path):
    """K=2: a SIGTERM during the chunk of steps 3-4 stops the LM loop at
    4, and -1 resumes it to the uninterrupted end."""
    def loop(d, **fields):
        cfg = TrainConfig(**dict(LM, max_steps=6, steps_per_call=2,
                                 train_dir=d, **fields))
        return TokenLoop(build_sp_train_setup(cfg, "cpu"), cfg, quiet=True)

    clean = loop(str(tmp_path / "clean"))
    clean.run()
    d = str(tmp_path / "stopped")
    stopped = loop(d)
    _signal_at(stopped, 3, 1)
    stopped.run()
    assert stopped.stopped_step == 4 and ckpt.available_steps(d) == [2, 4]
    resumed = loop(d, checkpoint_step=-1)
    assert resumed.state.step == 5
    assert resumed.run()["step"] == 6
    assert_same_state(snapshot(resumed.state), snapshot(clean.state))
