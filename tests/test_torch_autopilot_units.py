"""The autopilot's parts against the JAX package's (``draco_tpu.control``,
which imports no JAX), and the port's own rules around it:

  * ``parse_policy`` on the same specs: the same overrides or the same
    error;
  * ``base_regime`` and ``Regime.tag`` / ``as_dict``, and ``regime_cfg``
    field by field (every port field), on the reference's
    ``test_regime_cfg_algebra`` configuration, a tree configuration and an
    int8 segmented one, for the dial's targets at 0 and 1 quarantined;
  * ``validate()``'s refusals with the reference's messages, and the
    port's refusal of the LM, naming Queue A item 9.1;
  * the reference's wire-dial stub scenario (``tests/test_wire.py``)
    through both packages' ``Autopilot``: the remediations equal but for
    ``ts``, the same regime labels switched;
  * ``_fanout_ok`` and ``_dial_down_allowed`` on the same inputs;
  * ``SegmentPipeline``'s two rails: the same results and the same events
    in the same order as the reference's;
  * the pending chunk: a swap and a quarantine at one boundary; the chunk
    already assembled is re-made by the new setup from its host pieces
    (no second prefetch) and keeps the presence rows it was assembled
    with, so the quarantine reaches the wire one chunk later;
  * ``reapply_quarantines``: a ``run(max_steps=)`` past the schedules
    regenerates them with the quarantined worker still out;
  * the CPU program lint of the autopilot's chunk
    (``registry.AUTOPILOT_CHUNKS``): no would-be sync in a chunk, one
    fetch a flush with the autopilot's decisions in it.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from draco_tpu.config import TrainConfig as JaxConfig
from draco_tpu.control import autopilot as ref_ap
from draco_tpu.control import engine as ref_engine
from draco_tpu.obs.tracer import NullTracer as RefNullTracer
from draco_tpu_torch.analysis import program_lint, registry
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.control import autopilot as ap
from draco_tpu_torch.control import engine
from draco_tpu_torch.data import datasets
from draco_tpu_torch.obs import replay
from draco_tpu_torch.obs.forensics import record_masks
from draco_tpu_torch.obs.tracer import NULL_TRACER
from draco_tpu_torch.training.trainer import Trainer

torch.set_num_threads(1)

BASE = dict(approach="cyclic", num_workers=8, redundancy="shared",
            steps_per_call=4, incident_watch="on", autopilot="on",
            train_dir="/tmp/x")
# the reference's test_regime_cfg_algebra configuration, a tree and an
# int8 segmented wire
CONFIGS = {
    "algebra": dict(BASE, worker_fail=1, adversary_count=0, fault_spec=(
        "adversary@5-20:w2,nan_grad@7:w3,straggle@26-40:w5")),
    "tree": dict(BASE, worker_fail=0, adversary_count=0, topology="tree",
                 tree_fanout=4),
    "int8_seg": dict(BASE, worker_fail=1, wire_dtype="int8",
                     wire_segments=2),
}
# the dial's targets beside each base regime, as Regime arguments
TARGETS = {
    "algebra": [("approx", 1.5, "off"), ("approx", 1.2, "off"),
                ("cyclic", 3.0, "off", "f32", 2)],
    "tree": [("cyclic", 1.0, "off", "f32", 1, 2),
             ("approx", 1.5, "off", "f32", 1, 4),
             ("cyclic", 1.0, "off", "f32", 2, 4)],
    "int8_seg": [("cyclic", 3.0, "off", "bf16", 2),
                 ("cyclic", 3.0, "off", "int8", 4),
                 ("approx", 1.5, "off", "int8"),
                 ("cyclic", 3.0, "int8", "f32", 1)],
}


def both(name, **extra):
    fields = {**CONFIGS[name], **extra}
    return TrainConfig(**fields).validate(), JaxConfig(**fields).validate()


def error(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as e:
        return ("raises", str(e))


@pytest.mark.parametrize("spec", [
    "r_low=1.2, clean_boundaries=3", "", "bogus=1", "r_low",
    "segments_max=2,fanout_min=4,max_swaps=1", "r_low=x"])
def test_parse_policy_is_the_references(spec):
    assert error(ap.parse_policy, spec) == error(ref_ap.parse_policy, spec)
    assert ap.DEFAULT_POLICY == ref_ap.DEFAULT_POLICY


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_regimes_and_their_configs_are_the_references(name):
    cfg, jcfg = both(name)
    assert ap.base_regime(cfg).as_dict() == ref_ap.base_regime(jcfg).as_dict()
    for args in TARGETS[name]:
        t, jt = ap.Regime(*args), ref_ap.Regime(*args)
        assert t.tag == jt.tag and t.as_dict() == jt.as_dict()
        for q in (0, 1):
            mine = ap.regime_cfg(cfg, t, q)
            ref = ref_ap.regime_cfg(jcfg, jt, q)
            for f in dataclasses.fields(mine):
                assert getattr(mine, f.name) == getattr(ref, f.name), \
                    (args, q, f.name)
            assert error(mine.validate)[0] == error(ref.validate)[0], args


REFUSALS = [
    dict(approach="cyclic", worker_fail=1, num_workers=8, autopilot="on",
         steps_per_call=4, train_dir="/tmp/x"),
    dict(approach="cyclic", worker_fail=1, num_workers=8, autopilot="on",
         incident_watch="on", steps_per_call=4, train_dir=""),
    dict(approach="cyclic", worker_fail=1, num_workers=8, autopilot="on",
         incident_watch="on", steps_per_call=1, train_dir="/tmp/x"),
    dict(approach="baseline", autopilot="on", incident_watch="on",
         steps_per_call=4, train_dir="/tmp/x"),
    dict(autopilot_policy="nope=1"),
    dict(autopilot="maybe"),
]


@pytest.mark.parametrize("i", range(len(REFUSALS)))
def test_validate_refuses_as_the_reference(i):
    fields = REFUSALS[i]
    mine = error(TrainConfig(**fields).validate)
    ref = error(JaxConfig(**fields).validate)
    assert mine[0] == ref[0] == "raises" and mine[1] == ref[1]


def test_validate_refuses_the_lm_naming_item_9_1():
    """The LM's autopilot (Queue A item 9.1's LM half, once refused here)
    validates as the reference's does, at K=4 and at K=1 with device
    tokens, and both refuse it at K=1 with host tokens, with the same
    message."""
    fields = dict(network="TransformerLM", dataset="synthetic-text",
                  approach="cyclic", worker_fail=1, num_workers=8,
                  redundancy="shared", autopilot="on", incident_watch="on",
                  steps_per_call=4, train_dir="/tmp/x")
    for extra in ({}, {"steps_per_call": 1, "token_gen": "device"}):
        JaxConfig(**{**fields, **extra}).validate()  # the reference runs it
        TrainConfig(**{**fields, **extra}).validate()
    k1 = dict(fields, steps_per_call=1)
    mine, ref = error(TrainConfig(**k1).validate), error(
        JaxConfig(**k1).validate)
    assert mine[0] == ref[0] == "raises" and mine[1] == ref[1]


# ---- the wire-dial stub scenario (the reference's tests/test_wire.py) ----
class _Incidents:
    def __init__(self):
        self._open, self.episodes, self.ledger = [], [], None
        self.current_masks, self.quarantined = None, set()
        self.remediations = []

    def open_episodes(self):
        return list(self._open)

    def remediation(self, rem):
        self.remediations.append(rem)


class _Heartbeat:
    def __init__(self):
        self.incidents, self.wire, self.control = _Incidents(), None, None

    def set_control(self, block):
        self.control = block

    def set_wire(self, ledger):
        self.wire = ledger


class _Client:
    BASE_LABEL = "train_many"
    can_swap = True

    def __init__(self):
        self.setup, self.switched = None, []

    def build_setup(self, cfg):
        return ("setup", cfg.approach, cfg.wire_dtype)

    def switch_regime(self, setup, label):
        self.switched.append((setup, label))


WIRE_SCENARIO = [  # (boundary, open episodes)
    (8, [{"type": "numerics_drift", "severity": "warn", "onset_step": 5,
          "workers": []}]),
    (12, [{"type": "decode_residual", "severity": "warn", "onset_step": 9,
           "workers": []}]),
] + [(s, []) for s in range(16, 40, 4)]


def _drive_wire_dial(mod, cfg):
    hb, client = _Heartbeat(), _Client()
    pilot = mod.Autopilot(cfg, hb, policy={"wire_narrow_boundaries": 2.0})
    eng = type("E", (), {"client": client})()
    dtypes = []
    for step, eps in WIRE_SCENARIO:
        hb.incidents._open = eps
        pilot.act(step, eng)
        dtypes.append(pilot.regime.wire_dtype)
    rems = [{k: v for k, v in r.items() if k != "ts"}
            for r in pilot.remediations]
    return rems, client.switched, dtypes, hb.control


def test_the_wire_dial_stub_scenario_is_the_references():
    fields = dict(network="FC", dataset="synthetic-mnist", approach="cyclic",
                  worker_fail=1, num_workers=8, redundancy="shared",
                  steps_per_call=4, wire_dtype="int8", incident_watch="on",
                  autopilot="on", train_dir="/tmp/x")
    mine = _drive_wire_dial(ap, TrainConfig(**fields).validate())
    ref = _drive_wire_dial(ref_ap, JaxConfig(**fields).validate())
    assert mine[0] == ref[0] and mine[1] == ref[1] and mine[2] == ref[2]
    assert [r["action"] for r in mine[0]] == [
        "wire_widen", "wire_widen", "wire_narrow", "wire_narrow"]
    assert mine[2][-1] == "int8"
    assert {k: v for k, v in mine[3].items() if k != "last"} == \
        {k: v for k, v in ref[3].items() if k != "last"}


def _guards(mod, cfg, regime=None):
    pilot = mod.Autopilot(cfg, _Heartbeat())
    if regime is not None:
        pilot.regime = mod.Regime(*regime)
    return ([pilot._fanout_ok(g) for g in (1, 2, 3, 4, 8, 16)],
            [pilot._dial_down_allowed(s) for s in (1, 4, 19, 20, 21, 40)])


@pytest.mark.parametrize("name,extra,regime", [
    ("algebra", {}, None),
    ("tree", {}, None),
    ("tree", {}, ("approx", 1.5, "off", "f32", 1, 4)),
    ("tree", dict(num_workers=16, worker_fail=1, adversary_count=1,
                  tree_fanout=8), None),
    ("int8_seg", {}, None),
])
def test_fanout_and_dial_down_guards_are_the_references(name, extra, regime):
    cfg, jcfg = both(name, **extra)
    assert _guards(ap, cfg, regime) == _guards(ref_ap, jcfg, regime)


def test_segment_pipeline_rails_are_the_references():
    def run(mod, tracer, pipelined, segments):
        calls = []
        p = mod.SegmentPipeline(
            tracer,
            put=lambda j, h: calls.append(("put", j)) or h * 10,
            decode=lambda j, dev: calls.append(("decode", j)) or dev + j,
            drain=lambda out: calls.append(("drain", out)),
            pipelined=pipelined)
        res = p.run(segments)
        return res, calls, [(e["name"], e["segment"]) for e in p.events], p

    for pipelined in (True, False):
        for segments in ([1, 2, 3], [5], []):
            mine = run(engine, NULL_TRACER, pipelined, segments)
            ref = run(ref_engine, RefNullTracer(), pipelined, segments)
            assert mine[:3] == ref[:3]
            over, inflight = mine[3].overlap_us()
            assert inflight >= over >= 0.0
            if not pipelined:
                assert over == 0.0


# ---- the port's Trainer around the autopilot -----------------------------
FC = dict(network="FC", dataset="synthetic-mnist", batch_size=4, lr=0.02,
          num_workers=8, eval_freq=4, log_every=1, steps_per_call=4,
          approach="cyclic", worker_fail=1, adversary_count=0,
          redundancy="shared", incident_watch="on", autopilot="on")


def _trainer(d, **kw):
    ds = datasets.load_dataset("synthetic-mnist", synthetic_train=256,
                               synthetic_test=16)
    return Trainer(TrainConfig(**{**FC, "train_dir": d, **kw}),
                   device="cpu", dataset=ds, quiet=True)


class _SwapAndQuarantine:
    """At boundary ``at``: quarantine worker 2 and swap to the approx code,
    both effective from ``at + 1``."""

    def __init__(self, cfg, at):
        self.cfg, self.at, self.quarantined = cfg, at, {}

    def attach(self, client):
        pass

    def act(self, end, eng):
        if end != self.at:
            return
        client = eng.client
        client.quarantine(2, from_step=end + 1)
        setup = client.build_setup(ap.regime_cfg(
            self.cfg, ap.Regime("approx", 1.5, "off"), 1))
        client.switch_regime(setup, "train_many@approx_r1.5")

    def reapply_quarantines(self, schedule):
        pass


def test_a_swap_remakes_the_pending_chunk_from_its_pieces(tmp_path):
    d = str(tmp_path)
    tr = _trainer(d, max_steps=12)
    tr._autopilot = _SwapAndQuarantine(tr.cfg, at=4)
    gets = []
    make = tr.chunk_client

    def chunk_client(first, last):
        client = make(first, last)
        get = client.prefetch.get
        client.prefetch.get = lambda *a: gets.append(a[0]) or get(*a)
        return client
    tr.chunk_client = chunk_client
    tr.run()
    tr.close()
    assert [tuple(g) for g in gets] == [(1, 4), (5, 4), (9, 4)]
    recs = replay.train_records(os.path.join(d, "metrics.jsonl"))
    assert [r["step"] for r in recs] == list(range(1, 13))
    for r in recs:
        # the chunk of steps 5-8 was assembled before the boundary: the
        # approx setup re-made it, with worker 2 still present
        assert ("decode_residual_bound" in r) == (r["step"] > 4), r
        assert bool(record_masks(r, 8)["present"][2]) == (r["step"] <= 8), r
    assert tr.straggle_schedule[5:, 2].all()
    assert not tr.straggle_schedule[:5, 2].any()


def test_a_regenerated_schedule_keeps_the_quarantine(tmp_path):
    d = str(tmp_path)
    tr = _trainer(d, max_steps=4)
    tr.run()
    pilot = tr._autopilot
    assert tr.straggle_schedule.shape == (5, 8) \
        and not tr.straggle_schedule.any()
    pilot.quarantined[3] = {"step": 4, "boundaries": 0, "trigger": None}
    last = tr.run(max_steps=8)
    tr.close()
    assert last["step"] == 8 and tr.straggle_schedule.shape == (9, 8)
    assert tr.straggle_schedule[:, 3].all()
    assert not tr.straggle_schedule[:, [0, 1, 2, 4, 5, 6, 7]].any()
    recs = replay.train_records(os.path.join(d, "metrics.jsonl"))
    assert [bool(record_masks(r, 8)["present"][3]) for r in recs] == \
        [True] * 4 + [False] * 4


def test_the_autopilot_chunk_is_green_on_the_cpu_rules():
    name = "chunk_shared_autopilot"
    assert [c.name for c in registry.collect_autopilot()] == [name]
    prog = registry.get(name)
    cfg = prog.config()
    assert cfg.autopilot == "on" and cfg.incident_watch == "on"
    k, n = cfg.steps_per_call, cfg.num_workers
    twin = registry.get("chunk_simulate")
    assert prog.manifest(cfg, True).h2d_bytes == \
        twin.manifest(twin.config(), True).h2d_bytes + k * n
    torch.manual_seed(0)
    row = program_lint.lint_leg(prog.build("cpu"))
    assert row["ok"], row["failed_rules"]
    flush = row["rules"]["host_traffic"]["flush"]
    assert flush["fetches"] == 1 and flush["syncs"] == 0
    assert row["rules"]["host_traffic"]["syncs"] == 0
    assert np.isfinite(row["ops"])
