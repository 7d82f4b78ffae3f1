"""The port's incident engine and replay (``draco_tpu_torch/obs/incidents.py``,
``obs/replay.py``) against the JAX package's (``draco_tpu/obs``), no model:

  * ``detector_table()`` (its one-line docs aside) and ``parse_thresholds``
    (and its errors) equal the reference's;
  * the synthesized record and beat streams of ``tests/test_incidents.py``
    — trust collapse, a guard burn with non-finite ingest, the approx
    residual drifting to its bound and past it, the narrow wire's slack,
    the exponent histogram's shift, a throughput regression on an
    injected clock, a compile storm and prefetch starvation, sustained
    straggles — folded by both engines write the same ``incidents.jsonl``
    lines and the same ``status_block()``, wall-clock fields aside;
  * ``make_engine`` takes the reference's thresholds from a
    configuration; the port's replay reads the reference's stream and the
    reference's replay the port's, a torn tail included.
"""

import json
import os

import pytest

from draco_tpu.obs import incidents as ref_inc
from draco_tpu.obs import replay as ref_replay
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.obs import incidents as inc
from draco_tpu_torch.obs import replay
from test_incidents import rec


def _stream():
    """(kind, payload) events: ("rec", record) or ("beat", (step, extra,
    dt))."""
    out = []
    # trust collapse of worker 2, a guard burn with a NaN ingest on 3
    for s in range(1, 30):
        cols = {}
        if s in (12, 13):
            cols = dict(guard_trips=2.0, skipped_steps=1.0,
                        nx_grad_nonfinite=0.01, nx_wire_nonfinite=0.0)
        elif s > 5:
            cols = dict(guard_trips=0.0, skipped_steps=0.0,
                        nx_grad_nonfinite=0.0, nx_wire_nonfinite=0.0)
        accused = 0b0100 if 4 <= s <= 10 else 0
        if s in (12, 13):
            accused |= 0b1000
        present = 0b11111111 if not 16 <= s <= 24 else 0b11011111
        hist = {f"nx_wire_exp{i}": 0.0 for i in range(6)}
        hist["nx_wire_exp0" if not 19 <= s <= 23 else "nx_wire_exp5"] = 1.0
        out.append(("rec", rec(s, accused=accused, present=present,
                               decode_residual=(float("nan") if s == 13
                                                else 1e-6), **cols,
                               nx_wire_uf_bf16=0.0, nx_wire_of_bf16=0.0,
                               **hist)))
        if s % 4 == 0:
            out.append(("beat", (s, {"prefetch_depth": 0 if 12 <= s <= 20
                                     else 1, "prefetch_restarts":
                                     1 if s >= 16 else 0,
                                     "steady_recompiles": 2 if s >= 24
                                     else 0}, 1.0 if s < 16 else 9.0)))
    # the approx certificate: healthy, drifting, then violated
    for s in range(30, 60):
        res = 0.6 if s < 40 else (0.99 if s < 52 else 1.5)
        out.append(("rec", {"step": s, "loss": 1.0, "decode_residual": res,
                            "decode_residual_bound": 1.0}))
    return out


def _fold(module, stream, out_path, **kw):
    t = [0.0]
    eng = module.IncidentEngine(out_path=out_path, clock=lambda: t[0], **kw)
    for kind, payload in stream:
        if kind == "rec":
            eng.observe(payload)
        else:
            step, extra, dt = payload
            t[0] += dt
            eng.observe_beat(step, extra)
    block = eng.status_block()
    eng.finalize()
    return eng, block


def _lines(path):
    out = []
    for line in open(path):
        d = json.loads(line)
        d.pop("ts")
        out.append(d)
    return out


def test_registry_and_thresholds_equal_the_references():
    # each detector's one-line doc is its own (the reference's names the
    # issue that added it)
    def table(mod):
        return [{k: v for k, v in row.items() if k != "doc"}
                for row in mod.detector_table()]

    assert table(inc) == table(ref_inc)
    assert all(row["doc"] for row in inc.detector_table())
    spec = "trust.floor=0.4, guard.off_count=2,decode_residual.slack=0.1"
    assert inc.parse_thresholds(spec) == ref_inc.parse_thresholds(spec)
    for bad in ("bogus.floor=1", "trust.bogus=1", "trust.floor",
                "trust.floor=x"):
        with pytest.raises(ValueError) as theirs:
            ref_inc.parse_thresholds(bad)
        with pytest.raises(ValueError) as mine:
            inc.parse_thresholds(bad)
        assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("thresholds", (
    {}, {"decode_residual.slack": 0.1, "trust.floor": 0.6,
         "throughput.warmup_beats": 0.0, "straggle.streak": 2.0}))
@pytest.mark.parametrize("n", (8, None))
def test_streams_fold_as_the_references(tmp_path, n, thresholds):
    stream = _stream()
    a, block_a = _fold(inc, stream, str(tmp_path / "port.jsonl"),
                       num_workers=n, thresholds=thresholds)
    b, block_b = _fold(ref_inc, stream, str(tmp_path / "ref.jsonl"),
                       num_workers=n, thresholds=thresholds)
    assert block_a == block_b
    assert a.total_onsets == b.total_onsets > 3
    assert _lines(tmp_path / "port.jsonl") == _lines(tmp_path / "ref.jsonl")
    assert {e["type"] for e in a.all_episodes()} >= (
        {"guard", "nonfinite", "decode_residual", "numerics_drift",
         "throughput", "starvation", "compile_storm"}
        | ({"trust", "straggle"} if n else set()))


@pytest.mark.parametrize("wire", ("f32", "int8"))
def test_make_engine_takes_the_references_thresholds(tmp_path, wire):
    from draco_tpu.config import TrainConfig as JaxConfig

    kw = dict(approach="cyclic", redundancy="shared", num_workers=8,
              worker_fail=1, wire_dtype=wire, incident_watch="on",
              guard_residual_tol=2e-3, incident_thresholds="trust.floor=0.4",
              train_dir=str(tmp_path))
    mine = inc.make_engine(TrainConfig(**kw).validate())
    theirs = ref_inc.make_engine(JaxConfig(**kw))
    assert mine.overrides == theirs.overrides
    assert mine.status_block() == theirs.status_block()
    assert mine._out_path == os.path.join(str(tmp_path), "incidents.jsonl")
    assert inc.make_engine(TrainConfig(**{**kw, "incident_watch": "off"})) \
        is None
    assert inc.make_engine(TrainConfig(**{**kw, "train_dir": ""})) is None


def test_replays_read_each_others_streams(tmp_path):
    stream = _stream()
    _fold(inc, stream, str(tmp_path / "port.jsonl"), num_workers=8)
    _fold(ref_inc, stream, str(tmp_path / "ref.jsonl"), num_workers=8)
    for path in (tmp_path / "port.jsonl", tmp_path / "ref.jsonl"):
        with open(path, "a") as fh:
            fh.write('{"v": 1, "event": "ons')  # torn tail
        assert list(replay.iter_jsonl(str(path))) == list(
            ref_replay.iter_jsonl(str(path)))
    strip = [[{k: v for k, v in e.items() if k != "ts"}
              for e in mod.iter_jsonl(str(tmp_path / name))]
             for mod, name in ((replay, "port.jsonl"),
                               (ref_replay, "ref.jsonl"))]
    assert strip[0] == strip[1] and strip[0]
    d = tmp_path / "run"
    d.mkdir()
    recs = [payload for kind, payload in stream if kind == "rec"]
    with open(d / "metrics.jsonl", "w") as fh:
        fh.write("\n".join(json.dumps(r) for r in recs)
                 + '\n{"step": 99, "split": "eval"}\n\n{"step": 3')
    for mod in (replay, ref_replay):
        # (as JSON: a NaN residual is not equal to itself)
        assert json.dumps(mod.train_records(str(d / "metrics.jsonl"))) == \
            json.dumps(recs)
        assert mod.record_at_step(str(d), 7) is None
        assert mod.record_at_step(mod.metrics_path(str(d)), 7) == recs[6]
    assert replay.find_run_files(str(d)) == tuple(
        ref_replay.find_run_files(str(d)))
    assert replay.infer_num_workers(recs, str(d / "status.json")) == \
        ref_replay.infer_num_workers(recs, str(d / "status.json")) == 8
    assert list(replay.iter_jsonl(str(tmp_path / "missing.jsonl"))) == []
