"""The device fold (``draco_tpu_torch/obs/device_attr.py``) on synthetic
Chrome-trace fixtures in the shape ``torch.profiler`` exports: an eager
step's ``draco_*`` ranges with its runtime calls and kernels, and a CUDA
graph's replay (one ``cudaGraphLaunch`` for all its kernels) placed by the
graph's map. Every fixture is held to the "provably sums" rule: the phase
rows plus ``other`` plus ``unattributed`` equal the window's device time
exactly. ``device_status_block`` is held to the reference's
(``draco_tpu.obs.device_attr``) on the same fold dict; the merged timeline,
the capture's loading (none, torn), the heartbeat's ``device`` block and
the trace report's device table are held to stated rules."""

import gzip
import json
import os

import pytest

from draco_tpu.obs import device_attr as ref_da
from draco_tpu_torch.obs import device_attr as da
from draco_tpu_torch.obs import replay_attr
from draco_tpu_torch.obs import trace_report
from draco_tpu_torch.obs.heartbeat import RunHeartbeat

ROWS = da.PHASES + da.RESIDUAL_ROWS


def ann(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "pid": 1, "tid": tid}


def call(corr, ts, tid=1, name="cudaLaunchKernel"):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts,
            "dur": 1, "pid": 1, "tid": tid, "args": {"correlation": corr}}


def kern(corr, ts, dur, name="k", cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 7, "args": {"correlation": corr}}


def eager_fixture():
    """One eager step: launches inside each phase (one from autograd's
    thread inside draco_comp), one outside every phase, and a copy whose
    runtime call the trace lacks. Returns (events, the expected rows)."""
    events = [ann("draco_comp", 0, 100), ann("draco_encode", 100, 20),
              ann("draco_decode", 120, 30), ann("draco_update", 150, 10),
              call(1, 10), call(2, 30, tid=2), call(3, 105), call(4, 125),
              call(5, 155), call(6, 300),
              kern(1, 1000, 40.0, "gemm"), kern(2, 1040, 60.0, "conv"),
              kern(3, 1100, 25.0, "complex_matmul"),
              kern(4, 1125, 12.5, "cyclic_locator"),
              kern(5, 1140, 7.5, "sgd"), kern(6, 1150, 3.0, "eval"),
              kern(99, 1160, 2.0, "Memcpy HtoD", cat="gpu_memcpy"),
              # a device-side range repeats its kernels' time: not counted
              {"ph": "X", "cat": "gpu_user_annotation", "name": "draco_comp",
               "ts": 1000, "dur": 100, "pid": 0, "tid": 7}]
    want = {"draco_comp": 100.0, "draco_encode": 25.0, "draco_decode": 12.5,
            "draco_update": 7.5, "other": 3.0, "unattributed": 2.0}
    return events, want


GRAPH_MAP = [["gemm", "draco_comp"], ["complex_matmul", "draco_encode"],
             ["gemm", "draco_decode"], ["sgd", "draco_update"]]


def replay_fixture(t0=2000.0, corr=50, extra=False):
    """One replay of the graph ``train_many``: its kernels in device order
    correlate to one cudaGraphLaunch inside its replay range. ``extra``
    adds a kernel the map does not hold."""
    events = [ann(da.REPLAY_RANGE + "train_many", t0, 10),
              call(corr, t0 + 2, name="cudaGraphLaunch"),
              kern(corr, t0 + 100, 30.0, "gemm"),
              kern(corr, t0 + 130, 20.0, "complex_matmul"),
              kern(corr, t0 + 150, 10.0, "gemm"),
              kern(corr, t0 + 160, 5.0, "sgd")]
    if extra:
        events.append(kern(corr, t0 + 170, 4.0, "stray"))
    return events


def rows_us(ledger: dict) -> dict:
    return {k: v["time_us"] for k, v in ledger["phases"].items()}


# --------------------------------------------------------------------------
# the fold
# --------------------------------------------------------------------------

def test_eager_step_sums_to_the_window():
    events, want = eager_fixture()
    led = da.fold_events(events)
    assert led["mode"] == "device"
    assert rows_us(led) == want
    assert led["total_device_us"] == 150.0 == sum(want.values())
    assert led["replays"] == 0 and led["matched_events"] == 7
    assert led["busy_us"] == 150.0 and led["wall_us"] == 162.0
    assert sum(r["frac"] for r in led["phases"].values()) == \
        pytest.approx(1.0)
    # the eager rule in milliseconds, as trace_report re-exports it
    ms = trace_report.fold_device_phases(events)
    assert ms["phases_ms"] == {k: v / 1e3 for k, v in want.items()}
    assert ms["busy_ms"] == 0.15


def test_a_replay_is_placed_by_ordinal_from_its_map():
    events = replay_fixture()
    led = da.fold_events(events, {"train_many": GRAPH_MAP})
    # gemm #1 -> comp, gemm #2 -> decode: the name's ordinal decides
    assert rows_us(led) == {"draco_comp": 30.0, "draco_encode": 20.0,
                            "draco_decode": 10.0, "draco_update": 5.0,
                            "other": 0.0, "unattributed": 0.0}
    assert led["replays"] == 1 and led["replays_mapped"] == 1
    assert sum(rows_us(led).values()) == led["total_device_us"] == 65.0


def test_streams_that_overlap_sum_past_the_busy_time():
    """Kernels on two streams at once: the rows hold each kernel's time,
    ``busy_us`` the time at least one ran."""
    events = [ann("draco_comp", 0, 100), call(1, 10), call(2, 20),
              call(3, 30), kern(1, 1000, 50.0, "a"),
              dict(kern(2, 1020, 50.0, "b"), tid=8),
              dict(kern(3, 1200, 10.0, "c"), tid=9)]
    led = da.fold_events(events)
    assert rows_us(led)["draco_comp"] == led["total_device_us"] == 110.0
    assert led["busy_us"] == 80.0


def test_a_replay_without_its_map_is_unattributed():
    led = da.fold_events(replay_fixture())
    assert rows_us(led)["unattributed"] == led["total_device_us"] == 65.0
    assert led["replays"] == 1 and led["replays_mapped"] == 0
    fold = {"programs": [led], "anchor": {"steps_profiled": 4}}
    block = da.device_status_block(fold)
    assert block["attributed_frac"] == 0.0
    assert block["phase_fracs"]["unattributed"] == 1.0


def test_a_name_whose_count_differs_goes_unattributed():
    """A kernel the map does not hold is never guessed into a phase; the
    names whose counts agree keep their places."""
    led = da.fold_events(replay_fixture(extra=True),
                         {"train_many": GRAPH_MAP})
    got = rows_us(led)
    assert got["unattributed"] == 4.0
    assert got["draco_comp"] == 30.0 and got["draco_update"] == 5.0
    assert sum(got.values()) == led["total_device_us"] == 69.0
    # gemm runs in two phases: a replay that lost one of its two gemms
    # cannot tell which one is left
    events = [e for e in replay_fixture() if e.get("ts") != 2150.0]
    led = da.fold_events(events, {"train_many": GRAPH_MAP})
    assert rows_us(led) == {"draco_comp": 0.0, "draco_encode": 20.0,
                            "draco_decode": 0.0, "draco_update": 5.0,
                            "other": 0.0, "unattributed": 30.0}


def test_a_name_of_one_phase_keeps_it_when_records_are_lost():
    """The profiler at times loses some of a replay's kernel records: a
    name the map gives one phase is that phase's whatever its count, and
    the replay is counted short against its program's fullest."""
    lost = [e for e in replay_fixture(t0=3000.0, corr=51)
            if e.get("name") != "complex_matmul"]
    twice = lost + [kern(51, 3170.0, 20.0, "complex_matmul"),
                    kern(51, 3190.0, 20.0, "complex_matmul")]
    for events, enc in ((lost, 20.0), (twice, 60.0)):
        led = da.fold_events(replay_fixture() + events,
                             {"train_many": GRAPH_MAP})
        assert rows_us(led) == {"draco_comp": 60.0, "draco_encode": enc,
                                "draco_decode": 20.0, "draco_update": 10.0,
                                "other": 0.0, "unattributed": 0.0}
        assert led["replays"] == led["replays_mapped"] == 2
        # the replay with fewer device events than the other
        assert led["replays_short"] == 1


def test_the_replay_census_names_the_lost_records():
    """``obs/replay_attr.census``: each replay's device events and the
    names whose count differs from the map's, in launch order."""
    lost = [e for e in replay_fixture(t0=3000.0, corr=51)
            if e.get("ts") != 3150.0]
    got = replay_attr.census(replay_fixture() + lost,
                             {"train_many": GRAPH_MAP})
    assert got == {"replays": [
        {"program": "train_many", "events": 4, "differ": []},
        {"program": "train_many", "events": 3,
         "differ": [["gemm", 2, 1, 30.0,
                     {"draco_comp": 1, "draco_decode": 1}]]}]}


def test_the_map_of_a_warm_up_inside_the_window():
    """A graph captured while the window runs: its warm-up step's range in
    the capture gives the map of the replays that follow; the state's
    snapshot before it and restore after it are not in the map."""
    step = [ann(da.WARMUP_RANGE + "train_many", 0, 200),
            ann("draco_comp", 0, 100), ann("draco_encode", 100, 20),
            ann("draco_decode", 120, 30), ann("draco_update", 150, 10),
            call(11, 10), call(12, 105), call(13, 125), call(14, 155),
            kern(11, 500, 30.0, "gemm"), kern(12, 530, 20.0,
                                             "complex_matmul"),
            kern(13, 550, 10.0, "gemm"), kern(14, 560, 5.0, "sgd")]
    assert da.graph_map(step) == GRAPH_MAP
    copy = "Memcpy DtoD (Device -> Device)"
    warm = step + [call(10, -20, name="cudaMemcpyAsync"),
                   call(15, 230, name="cudaMemcpyAsync"),
                   kern(10, 480, 2.0, copy, cat="gpu_memcpy"),
                   kern(15, 570, 2.0, copy, cat="gpu_memcpy")]
    assert da.warmup_maps(warm) == {"train_many": GRAPH_MAP}
    led = da.fold_events(warm + replay_fixture())
    got = rows_us(led)
    # the warm-up's own kernels fold by their ranges, the replay's by map
    assert got == {"draco_comp": 60.0, "draco_encode": 40.0,
                   "draco_decode": 20.0, "draco_update": 10.0,
                   "other": 4.0, "unattributed": 0.0}
    assert led["replays_mapped"] == 1


def op(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts,
            "dur": dur, "pid": 1, "tid": tid}


def cpu_fixture():
    return [ann("draco_comp", 0, 100), ann("draco_decode", 60, 30),
            op("aten::linear", 5, 50), op("aten::mm", 10, 40),
            op("aten::sort", 65, 20), op("aten::add", 95, 5),
            op("aten::copy_", 200, 8), op("aten::mul", 70, 3, tid=2)]


def test_cpu_capture_folds_op_self_times():
    """On the CPU the ops are the device stream: nested ops pay out their
    children, each charged to the innermost range on its own thread."""
    led = da.fold_events(cpu_fixture())
    assert led["mode"] == "cpu"
    assert rows_us(led) == {"draco_comp": 55.0, "draco_encode": 0.0,
                            "draco_decode": 20.0, "draco_update": 0.0,
                            "other": 11.0, "unattributed": 0.0}
    assert led["total_device_us"] == 86.0


def test_self_times_match_the_reference():
    events = [{"ph": "X", "tid": 1, "ts": 0.0, "dur": 100.0, "name": "a"},
              {"ph": "X", "tid": 1, "ts": 10.0, "dur": 30.0, "name": "b"},
              {"ph": "X", "tid": 1, "ts": 50.0, "dur": 40.0, "name": "c"},
              {"ph": "X", "tid": 1, "ts": 55.0, "dur": 5.0, "name": "d"},
              {"ph": "X", "tid": 2, "ts": 20.0, "dur": 60.0, "name": "e"}]
    got = {ev["name"]: us for ev, us in da.self_times(events)}
    want = {ev["name"]: us for ev, us in ref_da.self_times(events)}
    assert got == want == {"a": 30.0, "b": 30.0, "c": 35.0, "d": 5.0,
                           "e": 60.0}


# --------------------------------------------------------------------------
# the status block, against the reference's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("flops", [None, 2.0e9])
def test_device_status_block_equals_the_reference(flops):
    events, _ = eager_fixture()
    led = da.fold_events(events + replay_fixture(),
                         {"train_many": GRAPH_MAP})
    led["module"], led["collectives"] = "window", {}
    if flops is not None:
        led["flops_per_step"] = flops
    fold = {"programs": [led], "anchor": {"steps_profiled": 8}}
    got = da.device_status_block(fold)
    assert got == ref_da.device_status_block(fold)
    assert set(got) == {"profiled_steps", "total_device_us", "phase_fracs",
                        "decode_share", "attributed_frac",
                        "achieved_flops_per_s", "achieved_flops_frac"}
    assert got["profiled_steps"] == 8
    assert got["attributed_frac"] == round(1 - 2.0 / 215.0, 4)
    assert da.device_status_block({}) is None
    assert ref_da.device_status_block({}) is None


# --------------------------------------------------------------------------
# the capture on disk
# --------------------------------------------------------------------------

def write_capture(root, events, anchor=None, maps=None, gz=True):
    d = os.path.join(root, "plugins", "profile", "2026_01_01_00_00_00")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "host.trace.json" + (".gz" if gz else ""))
    opener = gzip.open if gz else open
    with opener(path, "wt") as fh:
        json.dump({"traceEvents": events}, fh)
    if anchor is not None:
        with open(os.path.join(root, da.ANCHOR_FILE), "w") as fh:
            json.dump(anchor, fh)
    for prog, entries in (maps or {}).items():
        da.save_graph_map(root, prog, entries)
    return path


def test_fold_capture_reads_the_layout(tmp_path):
    events, want = eager_fixture()
    path = write_capture(str(tmp_path), events + replay_fixture(),
                         {"steps_profiled": 8, "tracer_ts_us": 5.0},
                         {"train_many": GRAPH_MAP})
    assert da.find_capture(str(tmp_path)) == path
    fold = da.fold_capture(str(tmp_path))
    (prog,) = fold["programs"]
    assert prog["collectives"] == {}  # one card: no collective runs
    assert fold["anchor"]["steps_profiled"] == 8
    assert rows_us(prog)["draco_comp"] == want["draco_comp"] + 30.0
    assert sum(rows_us(prog).values()) == prog["total_device_us"] == 215.0
    assert da.load_graph_maps(str(tmp_path)) == {"train_many": GRAPH_MAP}


def test_no_capture_and_a_torn_one(tmp_path):
    assert da.find_capture(str(tmp_path)) is None
    assert da.fold_capture(str(tmp_path)) is None
    d = tmp_path / "plugins" / "profile" / "0001"
    d.mkdir(parents=True)
    (d / "torn.trace.json").write_text('{"traceEvents": [{"ph": "X"')
    assert da.fold_capture(str(tmp_path)) is None
    with pytest.raises(ValueError):
        da.fold_capture(str(tmp_path), strict=True)
    hb = RunHeartbeat(str(tmp_path / "run"), num_workers=5)
    hb.observe_device(str(tmp_path))  # folds nothing, never raises
    assert "device" not in hb.beat(1, 2)


def test_a_cuda_capture_without_device_events_folds_nothing(tmp_path):
    """A cuda run's capture that lost its kernel events holds host ops
    only: they are not device time, so nothing folds (a CPU run's capture
    of the same events folds its ops)."""
    cuda, cpu = str(tmp_path / "cuda"), str(tmp_path / "cpu")
    write_capture(cuda, cpu_fixture(), {"steps_profiled": 3,
                                        "device": "cuda:0"})
    write_capture(cpu, cpu_fixture(), {"steps_profiled": 3,
                                       "device": "cpu"})
    assert da.fold_capture(cuda) is None
    with pytest.raises(ValueError, match="no device event"):
        da.fold_capture(cuda, strict=True)
    hb = RunHeartbeat(str(tmp_path / "run"), num_workers=5)
    hb.observe_device(cuda)
    assert "device" not in hb.beat(1, 2)
    hb.observe_device(cpu)
    dev = hb.beat(2, 2)["device"]
    assert dev["mode"] == "cpu" and dev["total_device_us"] == 86.0
    # a cuda capture with its kernel events folds as ever
    events, _ = eager_fixture()
    write_capture(cuda, events, {"steps_profiled": 3, "device": "cuda:0"})
    assert da.fold_capture(cuda)["programs"][0]["mode"] == "device"


def test_heartbeat_carries_the_device_block(tmp_path):
    events, _ = eager_fixture()
    prof = str(tmp_path / "prof")
    write_capture(prof, events, {"steps_profiled": 5})
    hb = RunHeartbeat(str(tmp_path / "run"), num_workers=5)
    assert "device" not in hb.beat(1, 4)
    hb.observe_device(prof)
    dev = hb.beat(2, 4)["device"]
    assert dev["profiled_steps"] == 5 and dev["total_device_us"] == 150.0
    assert dev["profile_dir"] == prof and dev["mode"] == "device"
    assert dev["decode_share"] == round(12.5 / 150.0, 4)
    # the terminal write carries it too
    hb.terminal("done")
    on_disk = json.loads((tmp_path / "run" / "status.json").read_text())
    assert on_disk["device"] == dev and on_disk["schema"] == 5


def test_trace_report_appends_the_device_table(tmp_path, capsys):
    events, _ = eager_fixture()
    run = tmp_path / "run"
    run.mkdir()
    (run / "trace.json").write_text(json.dumps({"traceEvents": [
        {"name": "dispatch", "ph": "X", "ts": 0, "dur": 5, "pid": 1,
         "tid": 1, "cat": "host"}]}))
    prof = str(tmp_path / "prof")
    write_capture(prof, events + replay_fixture(),
                  {"steps_profiled": 8}, {"train_many": GRAPH_MAP})
    report = trace_report.make_report(str(run / "trace.json"),
                                      profile_dir=prof)
    (prog,) = report["device"]["programs"]
    assert prog["phases"]["draco_comp"]["time_us"] == 130.0
    assert report["device"]["steps_profiled"] == 8
    assert trace_report.main([str(run), "--profile-dir", prof]) == 0
    out = capsys.readouterr().out
    assert "device program window (device)" in out
    assert "1 of 1 graph replays mapped" in out and "draco_decode" in out
    # a run dir with no capture folds the host half only
    assert "device" not in trace_report.make_report(str(run / "trace.json"))


def test_trace_report_writes_the_merged_timeline(tmp_path, capsys):
    events, _ = eager_fixture()
    run = tmp_path / "run"
    run.mkdir()
    host = {"name": "dispatch", "ph": "X", "ts": 4000, "dur": 5, "pid": 1,
            "tid": 1, "cat": "host"}
    (run / "trace.json").write_text(json.dumps({"traceEvents": [host]}))
    prof = str(tmp_path / "prof")
    write_capture(prof, events, {"steps_profiled": 8,
                                 "tracer_ts_us": 3000.0,
                                 "drained_tracer_ts_us": 9000.0})
    out = str(tmp_path / "merged.json")
    assert trace_report.main([str(run), "--profile-dir", prof, "--merged",
                              out]) == 0
    assert "merged timeline" in capsys.readouterr().out
    merged = json.load(open(out))
    assert merged == da.merge_timeline(
        [host], events, da.load_anchor(prof),
        max_device_events=trace_report.MERGED_DEVICE_EVENTS)
    mt = merged["mergedTimeline"]
    assert mt["anchor_kind"] == "drain" and mt["droppedDeviceEvents"] == 0
    assert merged["traceEvents"][0] == host
    # no capture: nothing to merge, said so
    assert trace_report.main([str(run), "--profile-dir",
                              str(tmp_path / "none"), "--merged",
                              str(tmp_path / "m2.json")]) == 1
    assert not os.path.exists(tmp_path / "m2.json")


# --------------------------------------------------------------------------
# the merged timeline
# --------------------------------------------------------------------------

def test_merge_timeline_on_the_host_clock():
    events, _ = eager_fixture()
    host = [{"name": "dispatch", "ph": "X", "ts": 4000.0, "dur": 50.0,
             "pid": 3, "tid": 1, "cat": "host"}]
    # the device went idle at the drain: the capture's last end (1162)
    # lands on the tracer's drain stamp
    anchor = {"tracer_ts_us": 3000.0, "drained_tracer_ts_us": 9000.0}
    merged = da.merge_timeline(host, events, anchor)
    mt = merged["mergedTimeline"]
    assert mt["anchored"] and mt["anchor_kind"] == "drain"
    assert mt["device_offset_us"] == 9000.0 - 1162.0
    evs = merged["traceEvents"]
    assert evs[0] == host[0]  # the host lanes are unchanged
    gemm = next(e for e in evs if e.get("name") == "gemm")
    assert gemm["ts"] == 1000.0 + 9000.0 - 1162.0
    assert gemm["pid"] == da.DEVICE_PID_BASE and \
        gemm["args"]["lane"] == "device"
    assert max(e["ts"] + e.get("dur", 0) for e in evs
               if e.get("pid", 0) >= da.DEVICE_PID_BASE
               and e.get("ph") == "X") == 9000.0
    # without the drain stamp the first event meets the start stamp
    start = da.merge_timeline([], events, {"tracer_ts_us": 3000.0})
    assert start["mergedTimeline"]["anchor_kind"] == "start_stamp"
    assert start["mergedTimeline"]["device_offset_us"] == 3000.0 - 0.0
    # no anchor: the capture keeps its own origin at 0
    un = da.merge_timeline([], events, None)
    assert un["mergedTimeline"]["anchored"] is False
    assert da.device_time_origin(events) == 0.0


def test_merge_timeline_caps_its_events_loudly():
    events = [{"ph": "X", "pid": 1, "tid": 1, "ts": float(i),
               "dur": float(i % 7 + 1), "name": f"k{i}", "cat": "kernel"}
              for i in range(50)]
    merged = da.merge_timeline([], events, None, max_device_events=10)
    xs = [e for e in merged["traceEvents"] if e.get("ph") == "X"]
    assert len(xs) == 10
    assert merged["mergedTimeline"]["droppedDeviceEvents"] == 40
    assert min(e["dur"] for e in xs) == 6.0  # the longest survive
