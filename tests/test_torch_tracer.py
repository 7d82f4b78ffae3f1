"""The port's host span tracer (``obs/tracer.py``) and its report
(``obs/trace_report.py``) on the CPU: well-formed Chrome trace events, the
disabled tracer as one shared no-op, the step's phases as spans and
profiler ranges, a torn file read, the CLI writing ``trace.json`` that
the report folds by phase, and ``obs/step_ab.py`` timing two checkouts and
the off tracer at CI size."""

import json

import pytest
import torch

from draco_tpu_torch import cli
from draco_tpu_torch.obs import trace_report, tracer


def _events(path):
    return json.loads(open(path).read())["traceEvents"]


def test_spans_are_well_formed_chrome_events(tmp_path):
    tr = tracer.make_tracer(str(tmp_path))
    assert tr.enabled and tr.path == str(tmp_path / "trace.json")
    with tr.span("dispatch", step=3):
        with tr.span("inner"):
            pass
    tr.close()
    evs = _events(tr.path)
    meta = [e for e in evs if e["ph"] == "M"]
    assert {e["name"] for e in meta} == {"process_name", "thread_name"}
    spans = {e["name"]: e for e in evs if e["ph"] == "X"}
    assert set(spans) == {"dispatch", "inner"}
    for e in spans.values():
        assert {"ts", "dur", "pid", "tid", "cat"} <= set(e)
        assert e["dur"] >= 0
    outer, inner = spans["dispatch"], spans["inner"]
    assert outer["args"] == {"step": 3}
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3


def test_the_buffer_is_bounded(tmp_path):
    tr = tracer.SpanTracer(str(tmp_path / "t.json"), max_events=16)
    for _ in range(40):
        with tr.span("s"):
            pass
    tr.flush()
    payload = json.loads(open(tr.path).read())
    assert payload["droppedEvents"] > 0
    assert len(payload["traceEvents"]) <= 17


def test_the_disabled_tracer_is_one_shared_no_op():
    off = tracer.make_tracer("")
    assert off is tracer.NULL_TRACER and not off.enabled
    a, b = off.span("gather"), off.span("dispatch")
    assert a is b and off.activate() is a
    with a:
        pass
    # no tracer active, no profiler: the phase is the same shared object
    assert tracer.phase("draco_comp") is a
    assert tracer.phase("draco_update") is a


def test_phases_report_to_the_active_tracer(tmp_path):
    tr = tracer.SpanTracer(str(tmp_path / "trace.json"))
    with tr.activate():
        with tracer.phase("draco_encode"):
            pass
    assert tracer.phase("draco_encode") is tracer.phase("x")  # off again
    tr.flush()
    assert [e["name"] for e in _events(tr.path)
            if e["ph"] == "X"] == ["draco_encode"]


def test_phases_are_profiler_ranges_while_it_runs():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.phase("draco_decode"):
            torch.ones(4).sum()
    assert "draco_decode" in {e.name for e in prof.events()}


def _write_trace(path, n):
    tr = tracer.SpanTracer(str(path))
    for i in range(n):
        with tr.span("gather"):
            pass
        with tr.span("dispatch"):
            pass
    tr.flush()


def test_trace_report_folds_phases(tmp_path, capsys):
    _write_trace(tmp_path / "trace.json", 5)
    (tmp_path / "metrics.jsonl").write_text(
        json.dumps({"step": 1, "loss": 2.0, "step_ms": 10.0}) + "\n"
        + json.dumps({"step": 1, "split": "eval", "loss": 1.0}) + "\n"
        + json.dumps({"step": 2, "loss": 1.5, "step_ms": 20.0}) + "\n"
        + '{"step": 3, "lo')  # a torn last line
    assert trace_report.main([str(tmp_path)]) == 0
    text = capsys.readouterr().out
    assert "gather" in text and "dispatch" in text and "TORN" not in text
    rep = trace_report.make_report(str(tmp_path / "trace.json"),
                                   str(tmp_path / "metrics.jsonl"))
    assert rep["phases"]["gather"]["count"] == 5
    assert rep["metrics"]["train_records"] == 2
    assert rep["metrics"]["mean_step_ms"] == 15.0


def test_trace_report_reads_a_torn_file(tmp_path, capsys):
    path = tmp_path / "trace.json"
    _write_trace(path, 6)
    text = path.read_text()
    whole = trace_report.load_trace(str(path))[0]
    path.write_text(text[: len(text) * 2 // 3])  # cut inside the array
    events, dropped, torn = trace_report.load_trace(str(path))
    assert torn and dropped == 0
    assert 0 < len(events) < len(whole)
    assert events == whole[:len(events)]
    trace_report.main([str(path)])
    assert "TORN FILE" in capsys.readouterr().out


def test_fold_device_phases():
    def ann(name, ts, dur, tid=1):
        return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
                "dur": dur, "tid": tid}

    def launch(corr, ts, tid=1):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": ts, "dur": 1, "tid": tid, "args": {"correlation": corr}}

    def kernel(corr, dur, cat="kernel"):
        return {"ph": "X", "cat": cat, "name": "k", "ts": 0, "dur": dur,
                "tid": 7, "args": {"correlation": corr}}

    # launch 5 comes from another thread (autograd's) inside draco_comp
    events = [ann("draco_comp", 0, 100), ann("draco_decode", 50, 10),
              launch(1, 10), launch(2, 55), launch(3, 200), launch(5, 30, 2),
              kernel(1, 1000), kernel(2, 500), kernel(3, 250),
              kernel(4, 125, "gpu_memcpy"), kernel(5, 2000),
              {"ph": "X", "cat": "gpu_user_annotation", "name": "draco_comp",
               "ts": 0, "dur": 9999, "tid": 7}]
    out = trace_report.fold_device_phases(events)
    ph = out["phases_ms"]
    assert ph["draco_comp"] == 3.0 and ph["draco_decode"] == 0.5
    assert ph["other"] == 0.25 and ph["unattributed"] == 0.125
    assert out["busy_ms"] == pytest.approx(3.875)


def test_cli_trace_dir_writes_a_trace_the_report_folds(tmp_path, capsys):
    out = tmp_path / "run"
    cli.main(["--network", "TransformerLM", "--dataset", "synthetic-text",
              "--approach", "cyclic", "--redundancy", "shared",
              "--num-workers", "5", "--worker-fail", "1", "--batch-size", "1",
              "--seq-len", "16", "--vocab", "32", "--model-dim", "32",
              "--model-heads", "2", "--model-layers", "1", "--max-steps", "3",
              "--eval-freq", "2", "--log-every", "1", "--device", "cpu",
              "--train-dir", str(out), "--trace-dir", str(out)])
    rep = trace_report.make_report(str(out / "trace.json"),
                                   str(out / "metrics.jsonl"))
    names = set(rep["phases"])
    assert {"gather", "dispatch", "sync", "flush", "eval", "draco_comp",
            "draco_encode", "draco_decode", "draco_update"} <= names
    assert rep["phases"]["dispatch"]["count"] == 3
    assert rep["metrics"]["train_records"] == 3
    capsys.readouterr()
    trace_report.main([str(out)])
    assert "draco_comp" in capsys.readouterr().out


def test_step_ab_times_two_trees_and_the_off_tracer(tmp_path, capsys):
    """``obs/step_ab.py`` at CI size on the CPU, the repo against itself
    through a second path: one round, a process per tree, each leg's
    ms/step, the spans one step opens and the off tracer's cost."""
    import os

    from draco_tpu_torch.obs import step_ab

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    other = tmp_path / "same_tree"
    other.symlink_to(root)
    out = tmp_path / "ab.json"
    assert step_ab.main(["--trees", root, str(other), "--pairs", "1",
                         "--legs", "lm_shared_flash", "--steps", "1",
                         "--device", "cpu", "--ci", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    row = rec["table"]["lm_shared_flash"]
    assert row["rounds"] == 1
    assert len(rec["runs"]) == 2
    for run in rec["runs"]:
        assert len(run["legs"]["lm_shared_flash"]) == 1
        assert run["spans"]["lm_shared_flash"]["loop_spans"] == 3
        assert run["spans"]["lm_shared_flash"]["phases"] >= 3
        assert run["tracer_off"]["phase_ns"] > 0
    assert "tracer off:" in capsys.readouterr().out
