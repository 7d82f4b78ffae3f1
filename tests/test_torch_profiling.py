"""The profiler window (``draco_tpu_torch/obs/profiling.py``) and the run
it observes, on the CPU.

The window's rules: the no-op window, the start and stop snapped to whole
units, the anchor's keys, one window at a time, a drain that raises
swallowed in the stop, and a ``cuda`` run that never profiles its host
only. Then the CLI a user runs for the chunked token loop (a small LM)
with ``--profile-dir --trace-dir --train-dir --compile-guard raise``, K=3
and an ``eval_freq`` of 4 that leaves a remainder chunk, as the
reference's ``tests/test_chunked_token_loop.py`` runs its loop
(``observed_run``, which ``test_torch_profiling_cnn.py`` runs on the
Trainer): the capture and its anchor, status.json's ``device`` block and
compile counters, and records equal to an unprofiled run's bit for bit.

On the CPU no CUDA graph is captured and no kernel library is built, so a
run pays no compile. The chunked runs stand a test double at the capture's
place: each step graph's first chunk reports the ``graph_capture`` the
card's ``StepGraph._capture`` reports there, which the loop's labels and
guard then classify."""

import json
import os

import pytest
import torch

from draco_tpu_torch import cli
from draco_tpu_torch.obs import compile_watch, device_attr, profiling
from draco_tpu_torch.training import chunk_graph

LM = ["--network", "TransformerLM", "--dataset", "synthetic-text",
      "--approach", "cyclic", "--redundancy", "shared",
      "--num-workers", "5", "--worker-fail", "1", "--batch-size", "1",
      "--seq-len", "16", "--vocab", "32", "--model-dim", "32",
      "--model-heads", "2", "--model-layers", "1"]
RUN = ["--max-steps", "8", "--eval-freq", "4", "--log-every", "1",
       "--device", "cpu"]


# --------------------------------------------------------------------------
# the window
# --------------------------------------------------------------------------

def test_the_null_window_is_inert():
    win = profiling.profiler_window(None)
    assert win is profiling.NULL_PROFILER_WINDOW
    assert profiling.profiler_window("", (1, 2)) is win
    assert profiling.profiler_window("/x", enabled=False) is win
    win.maybe_start(5, first_step=1)
    win.maybe_stop(9)
    win.stop()
    assert win.active is False and win.profiled is False


def _work(n: int = 64) -> None:
    from draco_tpu_torch.obs.tracer import phase

    x = torch.ones(n, n)
    with phase("draco_comp"):
        x = x @ x
    with phase("draco_decode"):
        x.sort(dim=0)


def test_the_window_snaps_to_units_and_writes_its_anchor(tmp_path):
    from draco_tpu_torch.obs.tracer import SpanTracer

    tracer = SpanTracer(str(tmp_path / "trace.json"))
    stopped = []
    prof = str(tmp_path / "prof")
    win = profiling.profiler_window(prof, (3, 8), tracer=tracer,
                                    on_stop=stopped.append)
    assert profiling.open_window() is win
    # chunks of 3: (1..3) reaches step 3, so the capture starts at step 1
    for start, end in ((1, 3), (4, 6), (7, 9), (10, 12)):
        win.maybe_start(end, first_step=start)
        assert win.active == (end <= 9)
        with tracer.activate():
            _work()
        win.maybe_stop(end)
    assert win.profiled and not win.active and stopped == [prof]
    assert profiling.open_window() is None
    tracer.close()
    anchor = device_attr.load_anchor(prof)
    assert anchor["steps_profiled"] == 9 and anchor["first_step"] == 1
    assert anchor["last_step"] == 9 and anchor["profile_steps"] == [3, 8]
    for key in ("schema", "started_unix", "started_perf", "tracer_ts_us",
                "drained_unix", "drained_perf", "drained_tracer_ts_us",
                "stopped_unix", "stopped_perf", "device", "trace"):
        assert anchor[key] is not None, key
    assert anchor["started_perf"] <= anchor["drained_perf"] \
        <= anchor["stopped_perf"]
    path = device_attr.find_capture(prof)
    assert path == os.path.join(prof, anchor["trace"])
    assert path.endswith(".trace.json.gz")
    fold = device_attr.fold_capture(prof)
    (led,) = fold["programs"]
    assert led["mode"] == "cpu" and led["total_device_us"] > 0
    rows = led["phases"]
    assert rows["draco_comp"]["time_us"] > 0
    assert rows["draco_decode"]["time_us"] > 0
    assert sum(r["time_us"] for r in rows.values()) == \
        led["total_device_us"]
    # the merge puts the capture on the tracer's clock, at the drain
    host = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    events, _ = device_attr.load_trace(path)
    merged = device_attr.merge_timeline(host, events, anchor)
    assert merged["mergedTimeline"]["anchor_kind"] == "drain"


def test_one_window_at_a_time(tmp_path):
    a = profiling.profiler_window(str(tmp_path / "a"), (1, 3))
    b = profiling.profiler_window(str(tmp_path / "b"), (1, 3))
    a.maybe_start(1)
    try:
        with pytest.raises(RuntimeError, match="only one profiler_window"):
            b.maybe_start(1)
        assert not b.active
    finally:
        a.stop()
    b.maybe_start(2)  # the first one stopped: the second may run
    b.stop()
    assert a.profiled and b.profiled


def test_a_drain_that_raises_does_not_mask_the_run(tmp_path, monkeypatch):
    win = profiling.profiler_window(str(tmp_path / "p"), (1, 4))
    win.maybe_start(1)
    assert win.active

    def poisoned(device=None):
        raise RuntimeError("device error surfaced at the drain")

    # the window drains a card it profiles: stand one in, poisoned
    monkeypatch.setattr(torch.cuda, "synchronize", poisoned)
    win.device = torch.device("cuda")
    win.stop()  # must not raise
    assert win.profiled and not win.active
    assert device_attr.find_capture(str(tmp_path / "p")) is not None


def test_a_cuda_window_never_profiles_the_host_only(tmp_path, monkeypatch):
    import torch.profiler as tp

    monkeypatch.setattr(tp, "supported_activities",
                        lambda: {tp.ProfilerActivity.CPU})
    win = profiling.ProfilerWindow(str(tmp_path / "p"), (1, 2),
                                   device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA activity"):
        win.maybe_start(1)
    assert not win.active
    win.stop()
    # a failed start leaves no session behind
    other = profiling.profiler_window(str(tmp_path / "q"), (1, 2))
    other.maybe_start(1)
    other.stop()
    assert other.profiled


# --------------------------------------------------------------------------
# the runs a user makes
# --------------------------------------------------------------------------

@pytest.fixture
def capture_double(monkeypatch):
    """Each step graph's first chunk reports the graph capture the card
    reports at that point (``StepGraph._capture``)."""
    run = chunk_graph.StepGraph.run

    def reported(self, chunk):
        if not self.captures:
            self.captures += 1
            compile_watch.report("graph_capture", self.name, 0.0, k=self.K)
        return run(self, chunk)

    monkeypatch.setattr(chunk_graph.StepGraph, "run", reported)


def records(d) -> list:
    """metrics.jsonl's rows but their step_ms."""
    rows = [json.loads(x) for x in open(os.path.join(d, "metrics.jsonl"))]
    return [{k: v for k, v in r.items() if k != "step_ms"} for r in rows]


def observed_run(tmp_path, argv, k, profiled, label, twin) -> None:
    """``argv`` through the CLI at K=``k`` with ``--profile-dir --trace-dir
    --train-dir --compile-guard raise``, held to the unprofiled run
    ``twin`` wrote (its train_dir) and to the window's ``profiled`` steps;
    a chunked run's ledger holds its one capture under ``label``."""
    run, prof = str(tmp_path / "run"), str(tmp_path / "prof")
    cli.main(argv + RUN + ["--steps-per-call", str(k), "--train-dir", run,
                           "--trace-dir", run, "--profile-dir", prof,
                           "--compile-guard", "raise"])
    # the observation perturbs nothing
    assert records(run) == records(twin)
    # the capture and its anchor; K=3 snaps the window [3, 8) to chunks
    # (1..3) through (5..7)
    assert device_attr.find_capture(prof) is not None
    anchor = device_attr.load_anchor(prof)
    assert anchor["steps_profiled"] == profiled
    assert anchor["tracer_ts_us"] is not None
    status = json.load(open(os.path.join(run, "status.json")))
    dev = status["device"]
    assert dev["profiled_steps"] == profiled and dev["total_device_us"] > 0
    assert dev["profile_dir"] == prof
    assert sum(dev["phase_fracs"].values()) == pytest.approx(1.0, abs=1e-3)
    assert dev["phase_fracs"]["draco_comp"] > 0
    assert dev["phase_fracs"]["unattributed"] == 0.0
    assert dev["attributed_frac"] == 1.0
    # the sentinel's counters and its ledger beside trace.json
    assert status["steady_recompiles"] == 0
    events = json.load(open(os.path.join(run, "trace.json")))["traceEvents"]
    lane = [e for e in events if e.get("cat") == "compile"]
    assert status["compiles"] == len(lane)
    ledger = os.path.join(run, "compiles.jsonl")
    if k == 1:  # no capture, no build on the CPU: no compile at all
        assert status["compiles"] == 0 and status["compile_s"] == 0.0
        assert not os.path.exists(ledger)
        return
    rows = [json.loads(x) for x in open(ledger)]
    # one capture, in the first chunk's window; the remainder chunks of
    # one step replay the graph of K=3
    assert [(r["program"], r["kind"], r["steady_recompile"])
            for r in rows] == [(label, "graph_capture", False)]
    assert [e["args"]["program"] for e in lane] == [label]
    assert status["compiles"] == 1 and status["compile_s"] == 0.0


def test_the_chunked_token_loop_profiled_and_watched(tmp_path,
                                                     capture_double):
    twin = str(tmp_path / "twin")
    cli.main(LM + RUN + ["--steps-per-call", "3", "--train-dir", twin])
    observed_run(tmp_path, LM, 3, 7, "train_token_many[3]", twin)


@pytest.mark.parametrize("route", [["--tensor-shards", "2"],
                                   ["--pipeline-shards", "2"]],
                         ids=["tp2", "pp2"])
def test_the_model_parallel_routes_profiled_and_watched(tmp_path, route):
    """``--profile-dir`` through ``train_route`` on the tp and pp routes,
    eagerly: the window [3, 8) profiles steps 3-7."""
    argv = [x for x in LM] + route
    # two layers (the pipeline's two stages) and a batch of two (its two
    # microbatches)
    argv[argv.index("--model-layers") + 1] = "2"
    argv[argv.index("--batch-size") + 1] = "2"
    twin = str(tmp_path / "twin")
    cli.main(argv + RUN + ["--steps-per-call", "1", "--train-dir", twin])
    observed_run(tmp_path, argv, 1, 5, None, twin)
