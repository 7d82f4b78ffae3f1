"""The build and capture sentinel (``draco_tpu_torch/obs/compile_watch.py``)
against the reference's ``draco_tpu.obs.compile_watch.CompileWatch``: one
synthetic sequence of labelled dispatch windows and compile events, fed to
the reference through its ``_on_build`` (a lowering, the reference's
compile event) and to the port through its dispatcher (``report``, a
kernel library load or a graph capture), gives the same ``program``,
``n_for_program`` and ``steady_recompile`` columns and the same
``snapshot()`` counts. Then the guard's modes, the ledger's place, the
trace's ``compile`` lane, the incident engine's ``compile_storm`` on the
beat after a steady recompile, and ``config.validate()``'s messages
against the reference's."""

import json
import time
import warnings

import pytest

from draco_tpu.config import TrainConfig as JaxConfig
from draco_tpu.obs import compile_watch as ref_cw
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.obs import compile_watch as cw
from draco_tpu_torch.obs.incidents import IncidentEngine
from draco_tpu_torch.obs.tracer import SpanTracer

# (window label or None, key, events fired inside: their kinds)
SEQUENCE = [
    ("train_many", 4, ["kernel_build", "kernel_build", "graph_capture"]),
    ("train_many", 4, []),
    ("train_many", 1, ["kernel_build"]),
    (None, None, ["kernel_build"]),  # an eval step: never guarded
    ("train_step", None, ["kernel_build"]),
    ("train_many@approx_r1.5", 4, ["graph_capture"]),  # a regime's own
    ("train_many", 4, ["graph_capture"]),  # a re-capture after warmup
    ("train_step", None, ["kernel_build", "kernel_build"]),
    ("train_many", 1, []),
    ("train_many", 1, ["graph_capture"]),
]


def drive(watch, fire) -> None:
    for label, key, events in SEQUENCE:
        if label is None:
            for kind in events:
                fire(kind)
            continue
        with watch.expect(label, key=key):
            for kind in events:
                fire(kind)


def columns(path) -> list:
    rows = [json.loads(x) for x in open(path)]
    return [(r["program"], r["n_for_program"], r["steady_recompile"])
            for r in rows]


@pytest.mark.parametrize("warmup", [0, 1, 2])
def test_the_ledger_and_counts_equal_the_reference(tmp_path, warmup):
    ref = ref_cw.CompileWatch(str(tmp_path / "ref"), warmup=warmup,
                              guard="off")
    drive(ref, lambda kind: ref._on_build(0.25))
    ref.stop()  # flushes the rows a backend event never attached to
    port = cw.CompileWatch(str(tmp_path / "port"), warmup=warmup,
                           guard="off").start()
    drive(port, lambda kind: cw.report(kind, "lib", 0.25))
    port.stop()
    got = columns(tmp_path / "port" / "compiles.jsonl")
    assert got == columns(tmp_path / "ref" / "compiles.jsonl")
    assert port.snapshot() == ref.snapshot()
    assert port.snapshot()["compiles"] == 11
    steady = {1: 4, 0: 10, 2: 0}[warmup]
    assert port.snapshot()["steady_recompiles"] == steady
    assert [p for p, _, _ in got].count(None) == 1
    rows = [json.loads(x) for x in open(tmp_path / "port" / "compiles.jsonl")]
    assert {r["kind"] for r in rows} == set(cw.KINDS)
    assert all(r["seconds"] == 0.25 and "time" in r for r in rows)


def test_guard_raise_writes_its_row_first(tmp_path):
    watch = cw.CompileWatch(str(tmp_path), warmup=1, guard="raise").start()
    try:
        with watch.expect("train_many", key=4):
            cw.report("graph_capture", "train_many", 0.5, k=4)
        with pytest.raises(cw.RetraceError, match="train_many\\[4\\]"):
            with watch.expect("train_many", key=4):
                cw.report("graph_capture", "train_many", 0.5, k=4)
    finally:
        watch.stop()
    rows = [json.loads(x) for x in open(tmp_path / "compiles.jsonl")]
    assert [r["steady_recompile"] for r in rows] == [False, True]
    assert rows[1]["k"] == 4 and rows[1]["kind"] == "graph_capture"
    assert watch.snapshot()["steady_recompiles"] == 1


def test_guard_warn_warns_and_off_records(tmp_path):
    for guard in ("warn", "off"):
        watch = cw.CompileWatch(guard=guard).start()
        try:
            with warnings.catch_warnings(record=True) as got:
                warnings.simplefilter("always")
                for _ in range(2):
                    with watch.expect("train_step"):
                        cw.report("kernel_build", "coded", 0.1)
        finally:
            watch.stop()
        assert [w.category for w in got] == (
            [cw.RetraceWarning] if guard == "warn" else [])
        assert watch.snapshot()["steady_recompiles"] == 1
    with pytest.raises(ValueError, match="guard must be one of"):
        cw.CompileWatch(guard="loud")
    with pytest.raises(ValueError, match="kind must be one of"):
        cw.report("jit", "x", 0.1)


def test_a_stopped_watch_hears_nothing_and_the_totals_count_all():
    before = cw.global_stats()
    watch = cw.CompileWatch(guard="raise")
    cw.report("kernel_build", "coded", 0.5, nvcc_s=0.4)
    watch.start()
    watch.stop()
    cw.report("graph_capture", "train_many", 0.25)
    assert watch.snapshot() == {"compiles": 0, "compile_s": 0.0,
                                "steady_recompiles": 0}
    after = cw.global_stats()
    assert after["builds"] - before["builds"] == 2
    assert after["kernel_builds"] - before["kernel_builds"] == 1
    assert after["graph_captures"] - before["graph_captures"] == 1
    assert after["nvcc_s"] - before["nvcc_s"] == pytest.approx(0.4)


def test_make_compile_watch_places_the_ledger(tmp_path):
    cases = [(dict(trace_dir=str(tmp_path / "t"),
                   train_dir=str(tmp_path / "r")), tmp_path / "t"),
             (dict(train_dir=str(tmp_path / "r")), tmp_path / "r")]
    for fields, where in cases:
        cfg = TrainConfig(**fields, compile_guard="off", compile_warmup=2)
        watch = cw.make_compile_watch(cfg)
        try:
            assert watch.guard == "off" and watch.warmup == 2
            cw.report("kernel_build", "coded", 0.1)
        finally:
            watch.stop()
        assert (where / "compiles.jsonl").exists()
    quiet = cw.make_compile_watch(TrainConfig(train_dir=str(tmp_path)),
                                  is_main=False)
    quiet.stop()
    assert quiet.path is None


def test_a_compile_event_is_a_lane_of_the_trace(tmp_path):
    tracer = SpanTracer(str(tmp_path / "trace.json"))
    watch = cw.CompileWatch(str(tmp_path), tracer=tracer).start()
    try:
        with tracer.span("dispatch"), watch.expect("train_many", key=4):
            time.sleep(0.003)  # the capture's 2 ms lie inside the dispatch
            cw.report("graph_capture", "train_many", 0.002, k=4)
    finally:
        watch.stop()
        tracer.close()
    events = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    comp = [e for e in events if e.get("cat") == "compile"]
    (ev,) = comp
    assert ev["args"]["program"] == "train_many[4]"
    assert ev["args"]["kind"] == "graph_capture"
    assert ev["dur"] == pytest.approx(2000.0)
    disp = next(e for e in events if e.get("name") == "dispatch")
    # the compile nests inside the dispatch that paid it, on its lane
    assert disp["tid"] == ev["tid"]
    assert disp["ts"] <= ev["ts"] + 1 and \
        ev["ts"] + ev["dur"] <= disp["ts"] + disp["dur"] + 1


def test_a_steady_recompile_opens_a_compile_storm_on_the_next_beat():
    watch = cw.CompileWatch(guard="warn").start()
    engine = IncidentEngine(num_workers=5)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", cw.RetraceWarning)
            for step in range(1, 5):
                with watch.expect("train_many", key=4):
                    if step in (1, 3):
                        cw.report("graph_capture", "train_many", 0.3)
                engine.observe_beat(4 * step, watch.snapshot())
                opened = [e["type"] for e in engine.status_block()["open"]]
                # open from the beat after the recompile; a storm closes
                # only after quiet beats
                assert ("compile_storm" in opened) == (step >= 3), step
    finally:
        watch.stop()
    assert engine.status_block()["by_type"] == {"compile_storm": 1}


@pytest.mark.parametrize("fields", [{"compile_guard": "loud"},
                                    {"compile_warmup": -1}])
def test_validate_refuses_as_the_reference(fields):
    with pytest.raises(ValueError) as ours:
        TrainConfig(**fields).validate()
    with pytest.raises(ValueError) as ref:
        JaxConfig(**fields).validate()
    assert str(ours.value) == str(ref.value)
    TrainConfig(compile_guard="raise", compile_warmup=0).validate()
