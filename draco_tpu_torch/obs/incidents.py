"""The incident engine (draco_tpu/obs/incidents.py): run-health episodes
over the telemetry the port already streams.

The engine folds the per-step column families — decode health, the packed
forensics masks, the numerics observatory, the step guard's columns — and
the heartbeat's beat extras into typed, attributed, stateful incidents:
onset / offset episodes with a severity, the evidence that fired and, where
forensics can name one, the implicated workers. It rides the heartbeat's
observer hook (``obs/heartbeat.RunHeartbeat``): host arithmetic on records
the loops materialise anyway, no device fetch, no synchronisation, no
change to the step.

Detectors register declaratively (:func:`register_detector`) with their
thresholds, so the set is enumerable (``detector_table()``), overridable a
run (``--incident-thresholds "trust.floor=0.4,..."``) and testable on
synthesized streams. Two sources:

  ``record``  :meth:`IncidentEngine.observe`, once a materialised train
              record. The detectors see only record columns, so an offline
              fold of metrics.jsonl (``obs/replay.py``) gives the live
              episodes whenever every step was logged (``log_every=1``).
  ``beat``    :meth:`IncidentEngine.observe_beat`, once a heartbeat beat,
              fed the beat extras the loops assemble (prefetch depth and
              restarts) and the wall clock; not recomputable offline.

Hysteresis: a detector must fire ``on_count`` observations running to open
an incident and stay quiet ``off_count`` running to close it, so a single
noisy step neither opens nor closes one. Hard signals (a non-finite ingest
row, a guard trip, a steady-state recompile) run at ``on_count=1``.

Incidents stream to ``train_dir/incidents.jsonl`` (append-only, one JSON
line an onset or offset, a torn tail tolerated by every reader) and fold
into status.json's ``incidents`` block (status schema 4), which the
terminal ``crashed`` / ``preempted`` write carries too.

The compile-storm detector reads the ``steady_recompiles`` beat extra that
the loops merge from their compile sentinel (``obs/compile_watch.py``):
a steady-state kernel library load or CUDA graph capture between two beats
opens a ``compile_storm`` episode on the next beat. ``quarantined`` and
:meth:`IncidentEngine.remediation` are the autopilot's
(``control/autopilot.py``): it adds the workers it quarantines to
``quarantined``, whose absence the straggle detector then reads as
policy, and writes each decision to the stream as a ``remediation``
line.

Host only: the standard library and the port's forensics.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

from draco_tpu_torch.obs.forensics import AccusationLedger, record_masks

INCIDENT_SCHEMA = 1

# severity ladder: "warn" = degraded but inside every budget (operator
# attention), "critical" = a budget/certificate breach (autopilot action)
SEVERITIES = ("warn", "critical")
SOURCES = ("record", "beat")


@dataclasses.dataclass(frozen=True)
class DetectorSpec:
    """One registered detector: its identity, severity, source stream, and
    declarative threshold defaults (every key overridable via
    ``parse_thresholds`` strings)."""

    name: str
    severity: str
    source: str  # "record" | "beat"
    thresholds: Dict[str, float]
    doc: str
    factory: Any


DETECTORS: Dict[str, DetectorSpec] = {}


def register_detector(name: str, severity: str, source: str,
                      thresholds: Dict[str, float]):
    """Class decorator declaring a detector into the enumerable registry.
    ``thresholds`` MUST include the hysteresis pair ``on_count`` /
    ``off_count`` — the engine owns the state machine, the detector only
    votes fire/quiet per observation."""
    assert severity in SEVERITIES and source in SOURCES
    assert "on_count" in thresholds and "off_count" in thresholds

    def deco(cls):
        DETECTORS[name] = DetectorSpec(
            name=name, severity=severity, source=source,
            thresholds=dict(thresholds),
            doc=(cls.__doc__ or "").strip().splitlines()[0],
            factory=cls)
        return cls

    return deco


def detector_table() -> List[dict]:
    """The enumerable detector set: name,
    severity, source, and the declared threshold defaults."""
    return [{"name": s.name, "severity": s.severity, "source": s.source,
             "thresholds": dict(s.thresholds), "doc": s.doc}
            for s in DETECTORS.values()]


def parse_thresholds(spec: str) -> Dict[str, float]:
    """``"trust.floor=0.4,guard.off_count=2"`` -> override dict. Unknown
    detector or threshold keys are config-time errors (the registry is the
    contract), values must parse as floats."""
    out: Dict[str, float] = {}
    for item in (spec or "").split(","):
        item = item.strip()
        if not item:
            continue
        try:
            key, val = item.split("=", 1)
            det, th = key.strip().split(".", 1)
            fval = float(val)
        except ValueError:
            raise ValueError(
                f"incident threshold {item!r} is not "
                f"'<detector>.<key>=<float>'")
        if det not in DETECTORS:
            raise ValueError(
                f"unknown incident detector {det!r} (registered: "
                f"{', '.join(sorted(DETECTORS))})")
        if th not in DETECTORS[det].thresholds:
            raise ValueError(
                f"detector {det!r} has no threshold {th!r} (declared: "
                f"{', '.join(sorted(DETECTORS[det].thresholds))})")
        out[f"{det}.{th}"] = fval
    return out


# --------------------------------------------------------------------------
# detectors
# --------------------------------------------------------------------------


class _Detector:
    """Base: holds merged thresholds; ``update`` (record source) or
    ``update_beat`` (beat source) returns None when the stream carries no
    signal for it (hysteresis holds), else (firing, evidence, workers)."""

    def __init__(self, th: Dict[str, float], num_workers: Optional[int]):
        self.th = th
        self.n = num_workers

    def update(self, record: dict, ctx: "IncidentEngine"):
        raise NotImplementedError

    def update_beat(self, step: int, extra: dict, ctx: "IncidentEngine"):
        raise NotImplementedError


def _accused_workers(ctx: "IncidentEngine") -> Optional[Tuple[int, ...]]:
    """The current record's accused worker set — the attribution every
    record-source detector reuses where the step can name one (None when
    the record carries no masks). Reads the engine's per-record mask cache
    (``ctx.current_masks``): the bit-twiddling unpack runs ONCE per
    observed record, not once per consuming detector."""
    masks = ctx.current_masks
    if masks is None:
        return None
    return tuple(i for i, b in enumerate(masks["accused"]) if b) or None


@register_detector(
    "nonfinite", severity="critical", source="record",
    thresholds={"frac_max": 0.0, "on_count": 1, "off_count": 2})
class NonfiniteDetector(_Detector):
    """Non-finite ingest: the numerics observatory's nonfinite fractions
    (nx_grad_nonfinite / nx_wire_nonfinite) above ``frac_max``.
    A NaN/Inf gradient row is never noise — on_count=1 — and the forensics
    ingest check names the victim worker, so the incident is attributed."""

    def update(self, record, ctx):
        vals = [record.get("nx_grad_nonfinite"),
                record.get("nx_wire_nonfinite")]
        vals = [float(v) for v in vals if isinstance(v, (int, float))]
        if not vals:
            return None
        worst = max(vals)
        firing = worst > self.th["frac_max"]
        return (firing, {"nonfinite_frac": worst},
                _accused_workers(ctx) if firing else None)


@register_detector(
    "guard", severity="critical", source="record",
    thresholds={"on_count": 1, "off_count": 4})
class GuardDetector(_Detector):
    """Guard-trip / skipped-step budget burn: the in-graph step guard
    (resilience/guards.py) skipped an update this record. Every trip means
    a training step was paid for and thrown away — on_count=1, and the
    episode's length IS the burn. Attributed via the step's accused set."""

    def update(self, record, ctx):
        trips = record.get("guard_trips")
        if not isinstance(trips, (int, float)):
            return None
        firing = float(trips) > 0.0
        ev = {"guard_trips": float(trips),
              "skipped_steps": float(record.get("skipped_steps", 0.0))}
        return (firing, ev, _accused_workers(ctx) if firing else None)


@register_detector(
    "trust", severity="critical", source="record",
    thresholds={"floor": 0.5, "on_count": 1, "off_count": 4})
class TrustDetector(_Detector):
    """Trust collapse: a present worker's EW trust (obs/forensics
    AccusationLedger, alpha=0.2) under ``floor``. The EW itself is the
    hysteresis — ~4 consecutive accusations to cross 0.5 from fresh, so a
    single false accusation cannot open an episode — and the collapsed
    workers are the attribution."""

    def update(self, record, ctx):
        ledger = ctx.ledger
        if ledger is None or ctx.current_masks is None:
            return None
        floor = self.th["floor"]
        # a QUARANTINED worker's trust is frozen at its collapse (absent
        # workers earn no evidence either way) — excluding it lets the
        # episode close once the remediation lands, so the autopilot's
        # clean-evidence window can actually accumulate
        low = tuple(w for w in range(ledger.n)
                    if ledger.trust[w] < floor
                    and w not in ctx.quarantined)
        return (bool(low),
                {"min_trust": round(min(ledger.trust), 4)},
                low or None)


@register_detector(
    "decode_residual", severity="critical", source="record",
    thresholds={"cyclic_tol": 1e-3, "bound_frac": 0.95, "alpha": 0.25,
                "slack": 0.0, "on_count": 2, "off_count": 3})
class ResidualDetector(_Detector):
    """Decode-residual drift. Exact families (cyclic): the fitted-codeword
    residual crossing ``cyclic_tol`` (clean decodes sit at f32 solve noise
    ~1e-6; NaN — the beyond-budget signature — counts as a crossing).
    Approx family: the EW of measured-residual / analytic-bound
    (arXiv:2006.09638) exceeding ``bound_frac`` — the decode drifting
    toward its worst case (within-budget drops sit at 0.5–0.85 of the
    bound, straggler_study.json) — or any outright bound violation."""

    def __init__(self, th, num_workers):
        super().__init__(th, num_workers)
        self._ew: Optional[float] = None

    def update(self, record, ctx):
        res = record.get("decode_residual")
        if not isinstance(res, (int, float)):
            return None
        res = float(res)
        bound = record.get("decode_residual_bound")
        if isinstance(bound, (int, float)):  # approx family
            bound = float(bound)
            # narrow-wire slack (make_engine): on a bf16/int8
            # wire the measured residual carries the end-to-end
            # quantization error on TOP of the analytic bound (which
            # prices drops only) — the dtype's slack is the family's
            # normal state, same widening guards.assess applies. 0 on f32.
            qres = max(res - self.th["slack"], 0.0) if res == res else res
            # full-participation steps: both sit at f32 noise — ratio is
            # meaningless there, and a healthy 0 must drain the EW
            ratio = qres / bound if bound > 1e-6 else 0.0
            if not (ratio == ratio):  # NaN residual: poisoned decode
                ratio = 2.0
            a = self.th["alpha"]
            self._ew = ratio if self._ew is None else \
                a * ratio + (1.0 - a) * self._ew
            violated = not (qres <= bound + 1e-5)
            firing = violated or self._ew > self.th["bound_frac"]
            return (firing, {"residual": res, "bound": bound,
                             "ew_ratio": round(self._ew, 4)}, None)
        # exact families: a rel-tol crossing, NaN-safe (not <= , so a NaN
        # residual — the mislocated beyond-budget decode — fires)
        firing = not (res <= self.th["cyclic_tol"])
        return (firing, {"residual": res},
                _accused_workers(ctx) if firing else None)


@register_detector(
    "numerics_drift", severity="warn", source="record",
    thresholds={"uf_bf16_max": 0.5, "of_bf16_max": 1e-3,
                "hist_shift_max": 0.6, "warmup": 4,
                "on_count": 3, "off_count": 3})
class NumericsDriftDetector(_Detector):
    """Numerics drift on the coded wire (the observatory's columns): the bf16
    underflow fraction past ``uf_bf16_max``, any overflow fraction past
    ``of_bf16_max``, or the 6-bin exponent histogram shifting more than
    ``hist_shift_max`` total-variation distance from its own warm baseline
    (mean of the first ``warmup`` watched records). Soft signal —
    on_count=3, so a single noisy step never opens an episode."""

    def __init__(self, th, num_workers):
        super().__init__(th, num_workers)
        self._warm: List[List[float]] = []
        self._baseline: Optional[List[float]] = None

    def update(self, record, ctx):
        uf = record.get("nx_wire_uf_bf16")
        if not isinstance(uf, (int, float)):
            return None
        of = float(record.get("nx_wire_of_bf16", 0.0))
        hist = []
        i = 0
        while f"nx_wire_exp{i}" in record:
            hist.append(float(record[f"nx_wire_exp{i}"]))
            i += 1
        shift = 0.0
        if hist:
            if self._baseline is None:
                self._warm.append(hist)
                if len(self._warm) >= int(self.th["warmup"]):
                    m = len(self._warm)
                    self._baseline = [sum(col) / m
                                      for col in zip(*self._warm)]
                return (False, {"warmup": len(self._warm)}, None)
            shift = 0.5 * sum(abs(a - b)
                              for a, b in zip(hist, self._baseline))
        firing = (float(uf) > self.th["uf_bf16_max"]
                  or of > self.th["of_bf16_max"]
                  or shift > self.th["hist_shift_max"])
        return (firing, {"uf_bf16": float(uf), "of_bf16": of,
                         "hist_shift": round(shift, 4)}, None)


@register_detector(
    "straggle", severity="warn", source="record",
    thresholds={"streak": 4, "on_count": 1, "off_count": 2})
class StraggleDetector(_Detector):
    """Sustained per-worker absence: some worker's present bit has been
    off for ``streak`` consecutive observed records — the churn /
    preempted-worker / feasibility-pressure signal (the regime the
    committed straggler study prices, and the evidence the autopilot's
    redundancy dial acts on). Scheduled one-off drops rotate workers and
    never build a streak, so a clean straggle_mode="drop" run stays
    silent; a spot-instance drop or a churn episode fires within
    ``streak`` steps, attributed to the absent worker(s). Workers the
    autopilot QUARANTINED are excluded — their absence is policy, not
    telemetry (``IncidentEngine.quarantined``)."""

    def __init__(self, th, num_workers):
        super().__init__(th, num_workers)
        self._streaks: Optional[list] = None

    def update(self, record, ctx):
        masks = ctx.current_masks
        if masks is None:
            return None
        present = masks["present"]
        n = len(present)
        if self._streaks is None or len(self._streaks) != n:
            self._streaks = [0] * n
        for w in range(n):
            if w in ctx.quarantined or present[w]:
                self._streaks[w] = 0
            else:
                self._streaks[w] += 1
        k = int(self.th["streak"])
        hot = tuple(w for w in range(n) if self._streaks[w] >= k)
        return (bool(hot),
                {"max_absent_streak": max(self._streaks, default=0)},
                hot or None)


@register_detector(
    "throughput", severity="warn", source="beat",
    thresholds={"warmup_beats": 3, "alpha": 0.3, "drop_frac": 0.4,
                "on_count": 2, "off_count": 2})
class ThroughputDetector(_Detector):
    """Throughput regression: the EW steps/s between heartbeat flush
    boundaries falling more than ``drop_frac`` below its own warm baseline
    (the EW frozen after ``warmup_beats`` inter-beat rates). Host
    wall-clock driven — beat source, carried through (not recomputed) by
    the offline replay."""

    def __init__(self, th, num_workers):
        super().__init__(th, num_workers)
        self._prev: Optional[Tuple[int, float]] = None
        self._ew: Optional[float] = None
        self._rates = 0
        self._baseline: Optional[float] = None

    def update_beat(self, step, extra, ctx):
        now = ctx.clock()
        prev, self._prev = self._prev, (step, now)
        if prev is None:
            return None
        dsteps, dt = step - prev[0], now - prev[1]
        if dsteps <= 0 or dt <= 0:
            return None
        rate = dsteps / dt
        a = self.th["alpha"]
        self._ew = rate if self._ew is None else \
            a * rate + (1.0 - a) * self._ew
        self._rates += 1
        ev = {"steps_per_s": round(rate, 4),
              "ew_steps_per_s": round(self._ew, 4)}
        if self._rates <= int(self.th["warmup_beats"]) \
                or self._baseline is None:
            # warm baseline: the EW at end of warmup — and ALWAYS at least
            # the first rate (warmup_beats=0 is a legal override; firing
            # against no baseline would crash the loop)
            self._baseline = self._ew
            return (False, ev, None)
        ev["baseline_steps_per_s"] = round(self._baseline, 4)
        firing = self._ew < (1.0 - self.th["drop_frac"]) * self._baseline
        return (firing, ev, None)


@register_detector(
    "compile_storm", severity="critical", source="beat",
    thresholds={"on_count": 1, "off_count": 2})
class CompileStormDetector(_Detector):
    """Compile storm: the compile sentinel's steady-state recompile
    counter (obs/compile_watch.py — builds after a program's warmup
    window) advancing between beats. Every steady recompile silently
    re-pays the multi-second compile the scan-chunk design amortizes;
    one is an anomaly, a stream of them is a storm (the episode)."""

    def __init__(self, th, num_workers):
        super().__init__(th, num_workers)
        self._prev = 0

    def update_beat(self, step, extra, ctx):
        steady = extra.get("steady_recompiles")
        if not isinstance(steady, (int, float)):
            return None
        delta = float(steady) - self._prev
        self._prev = float(steady)
        return (delta > 0, {"steady_recompiles": float(steady),
                            "new_recompiles": delta}, None)


@register_detector(
    "starvation", severity="warn", source="beat",
    thresholds={"depth_beats": 3, "on_count": 1, "off_count": 1})
class StarvationDetector(_Detector):
    """Prefetch starvation: a supervised prefetcher restart since the last
    beat (a worker crashed/stalled and was rebuilt —
    resilience/supervisor.py), or the queue-depth signal the tracer
    counters track (the heartbeat's prefetch_depth extra) pinned at zero
    for ``depth_beats`` consecutive beats mid-run (the device outrunning
    the host: nothing in flight when a chunk was due)."""

    def __init__(self, th, num_workers):
        super().__init__(th, num_workers)
        self._prev_restarts = 0.0
        self._zero_streak = 0

    def update_beat(self, step, extra, ctx):
        depth = extra.get("prefetch_depth")
        restarts = extra.get("prefetch_restarts")
        if depth is None and restarts is None:
            return None
        delta = 0.0
        if isinstance(restarts, (int, float)):
            delta = float(restarts) - self._prev_restarts
            self._prev_restarts = float(restarts)
        if isinstance(depth, (int, float)) and depth <= 0:
            self._zero_streak += 1
        else:
            self._zero_streak = 0
        firing = delta > 0 or self._zero_streak >= int(self.th["depth_beats"])
        return (firing, {"prefetch_depth": depth,
                         "restarts": self._prev_restarts,
                         "zero_depth_beats": self._zero_streak}, None)


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------


class _Hyst:
    """Per-detector hysteresis state + the open episode, if any."""

    __slots__ = ("hot", "quiet", "first_hot", "open")

    def __init__(self):
        self.hot = 0
        self.quiet = 0
        self.first_hot: Optional[int] = None
        self.open: Optional[dict] = None


class IncidentEngine:
    """Folds observed records/beats into incident episodes.

    ``out_path``: incidents.jsonl (lazily opened on the first event — a
    clean run writes nothing). ``thresholds``: ``"det.key" -> value``
    overrides (parse_thresholds). ``clock``: injectable monotonic clock
    for the beat detectors' wall-rate math (tests).
    """

    def __init__(self, num_workers: Optional[int] = None,
                 out_path: Optional[str] = None,
                 thresholds: Optional[Dict[str, float]] = None,
                 clock=time.monotonic):
        overrides = dict(thresholds or {})
        self.clock = clock
        self.num_workers = num_workers
        # the engine's OWN ledger (trust detector input): self-contained,
        # so the offline replay needs nothing but the record stream
        self.ledger = (AccusationLedger(num_workers)
                       if num_workers else None)
        self.detectors: Dict[str, _Detector] = {}
        self._hyst: Dict[str, _Hyst] = {}
        for name, spec in DETECTORS.items():
            th = dict(spec.thresholds)
            for key, val in overrides.items():
                det, tkey = key.split(".", 1)
                if det == name:
                    th[tkey] = val
            self.detectors[name] = spec.factory(th, num_workers)
            self._hyst[name] = _Hyst()
        # the NON-DEFAULT overrides actually in effect — stamped into the
        # status block so an offline replay
        # rebuilds with the run's own thresholds (make_engine's implicit
        # cyclic_tol <- guard_residual_tol included), not the registry
        # defaults
        self.overrides = {
            k: v for k, v in overrides.items()
            if DETECTORS.get(k.split(".", 1)[0]) is not None
            and DETECTORS[k.split(".", 1)[0]].thresholds.get(
                k.split(".", 1)[1]) != v}
        self.episodes: List[dict] = []  # closed, in closure order
        self.total_onsets = 0
        self._out_path = out_path
        self._fh = None
        self._seq = 0
        self._last_step: Optional[int] = None
        # per-record unpacked forensics masks (observe() refreshes)
        self.current_masks: Optional[dict] = None
        # workers the autopilot (control/autopilot.py) has excluded via
        # the present-mask schedule: their absence is POLICY, so the
        # straggle detector must not read it as telemetry
        self.quarantined: set = set()

    # ---- folding ---------------------------------------------------------
    def observe(self, record: dict) -> None:
        """One materialized train record — the heartbeat observer hook."""
        # unpack the packed forensics masks ONCE per record; the engine's
        # ledger fold and every consuming detector (+ _accused_workers)
        # read this cache
        self.current_masks = (record_masks(record, self.num_workers)
                              if self.num_workers else None)
        if self.ledger is not None:
            self.ledger.observe(record, masks=self.current_masks)
        step = int(record.get("step", (self._last_step or 0) + 1))
        self._last_step = step
        for name, det in self.detectors.items():
            if DETECTORS[name].source != "record":
                continue
            sig = det.update(record, self)
            if sig is not None:
                self._advance(name, step, sig)

    def observe_beat(self, step: int, extra: Optional[dict] = None) -> None:
        """One heartbeat flush boundary, fed the beat extras the loops
        already assemble (prefetch depth/restarts, compile counters)."""
        self._last_step = int(step)
        extra = extra or {}
        for name, det in self.detectors.items():
            if DETECTORS[name].source != "beat":
                continue
            sig = det.update_beat(int(step), extra, self)
            if sig is not None:
                self._advance(name, int(step), sig)

    def _advance(self, name: str, step: int, sig) -> None:
        firing, evidence, workers = sig
        st = self._hyst[name]
        spec = DETECTORS[name]
        if firing:
            st.quiet = 0
            st.hot += 1
            if st.first_hot is None:
                st.first_hot = step
            if st.open is not None:
                ep = st.open
                ep["last_step"] = step
                ep["steps"] += 1
                ep["evidence"] = evidence
                if workers:
                    ep["workers"] = sorted(set(ep["workers"] or ())
                                           | set(workers))
            elif st.hot >= int(self.detectors[name].th["on_count"]):
                st.open = {
                    "type": name, "severity": spec.severity,
                    "source": spec.source, "onset_step": st.first_hot,
                    "last_step": step, "steps": st.hot,
                    "workers": sorted(workers) if workers else None,
                    "evidence": evidence,
                }
                self.total_onsets += 1
                self._emit("onset", st.open)
        else:
            st.hot = 0
            st.first_hot = None
            if st.open is not None:
                st.quiet += 1
                if st.quiet >= int(self.detectors[name].th["off_count"]):
                    ep = st.open
                    st.open = None
                    st.quiet = 0
                    ep["offset_step"] = step
                    self.episodes.append(ep)
                    self._emit("offset", ep)

    # ---- emission --------------------------------------------------------
    def _line(self, event: str) -> Optional[dict]:
        """Start an event line on the (lazily opened) stream, or None when
        the engine has no out_path."""
        if self._out_path is None:
            return None
        if self._fh is None:
            os.makedirs(os.path.dirname(self._out_path) or ".",
                        exist_ok=True)
            self._fh = open(self._out_path, "a")
        # wall-clock stamp: onset→remediation latency (MTTR)
        # is only computable offline if every event carries real time —
        # step indices alone cannot price a stalled run's response lag
        line = {"v": INCIDENT_SCHEMA, "event": event, "seq": self._seq,
                "ts": time.time()}
        self._seq += 1
        return line

    def _emit(self, event: str, ep: dict) -> None:
        line = self._line(event)
        if line is None:
            return
        line.update({k: ep[k] for k in
                     ("type", "severity", "source", "onset_step",
                      "last_step", "steps", "workers", "evidence")})
        if event == "offset":
            line["offset_step"] = ep["offset_step"]
        # one fsync-free write+flush per event: incidents are rare, and a
        # torn tail (killed mid-write) is tolerated by every reader
        self._fh.write(json.dumps(line) + "\n")
        self._fh.flush()

    def remediation(self, rem: dict) -> None:
        """Append an autopilot remediation (control/autopilot.py) to the
        SAME event stream, same seq counter: every runtime-control
        decision is an attributed line in the run's incident ledger,
        interleaved in decision order with the episodes that triggered
        it. Offline consumers carry these
        through — runtime control state is not recomputable from metric
        columns alone."""
        line = self._line("remediation")
        if line is None:
            return
        line.update(rem)
        self._fh.write(json.dumps(line) + "\n")
        self._fh.flush()

    def open_episodes(self) -> List[dict]:
        return [self._hyst[n].open for n in sorted(self._hyst)
                if self._hyst[n].open is not None]

    def all_episodes(self) -> List[dict]:
        """Closed episodes (closure order) + still-open tails."""
        return ([dict(e, open=False) for e in self.episodes]
                + [dict(e, open=True) for e in self.open_episodes()])

    def status_block(self) -> dict:
        """The ``incidents`` status.json block (STATUS_SCHEMA 4): open
        episodes, per-type totals, last onset."""
        counts: Dict[str, int] = {}
        eps = self.all_episodes()
        for ep in eps:
            counts[ep["type"]] = counts.get(ep["type"], 0) + 1
        last = max(eps, key=lambda e: e["onset_step"]) if eps else None
        return {
            "total": self.total_onsets,
            "open": [{"type": e["type"], "severity": e["severity"],
                      "onset_step": e["onset_step"],
                      "last_step": e["last_step"],
                      "workers": e["workers"]}
                     for e in self.open_episodes()],
            "by_type": counts,
            "thresholds": dict(self.overrides),
            "last": ({"type": last["type"], "severity": last["severity"],
                      "onset_step": last["onset_step"],
                      "workers": last["workers"],
                      "open": last.get("open", True)}
                     if last else None),
        }

    def finalize(self) -> None:
        """Flush + close the event stream (the terminal heartbeat write
        calls this). Open episodes stay open — an incident whose condition
        never cleared must not fabricate an offset."""
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def make_engine(cfg, is_main: bool = True) -> Optional[IncidentEngine]:
    """The one construction rule both production loops share: an engine
    only when ``cfg.incident_watch == "on"``, there is a train_dir to
    stream into, and this is the metrics-emitting process; threshold
    overrides from ``cfg.incident_thresholds``, with the cyclic residual
    tolerance defaulting to the step guard's ``cfg.guard_residual_tol``
    (one loudness definition across guard and detector) plus the narrow
    wire's residual slack (the same widening guards.assess applies:
    quantization noise on a bf16/int8 wire is the dtype's normal state,
    not residual drift; 0 on the f32 wire)."""
    if getattr(cfg, "incident_watch", "off") != "on" or not cfg.train_dir \
            or not is_main:
        return None
    from draco_tpu_torch.obs.numerics import wire_residual_slack

    slack = wire_residual_slack(getattr(cfg, "wire_dtype", "f32"))
    thresholds = {"decode_residual.cyclic_tol":
                  cfg.guard_residual_tol + slack,
                  "decode_residual.slack": slack}
    thresholds.update(parse_thresholds(
        getattr(cfg, "incident_thresholds", "")))
    return IncidentEngine(
        num_workers=cfg.num_workers,
        out_path=os.path.join(cfg.train_dir, "incidents.jsonl"),
        thresholds=thresholds)
