"""The adaptive coding autopilot (draco_tpu/control/autopilot.py): runtime
control of a chunked run — the CNN Trainer's or the LM token loop's —
from its incident stream.

At every flush of the chunked loop (``control/engine.py``), after the
heartbeat's beat, :meth:`Autopilot.act` reads the incident engine
(``obs/incidents.py``: its open episodes and accusation ledger) and
emits **remediations** through the engine's client
(``control/clients.py``):

  quarantine     a trust-collapsed worker leaves the presence schedule:
                 its rows become erasures at a known position, which the
                 decode budget absorbs, and the budget left is reported
  readmit        after a clean window the worker's schedule column comes
                 back and its ledger trust resets to ``parole_trust``
  dial_down      sustained ``straggle`` / ``starvation`` with the
                 adversary signals quiet: exact cyclic r = 2s+1 swaps to
                 the approx code at ``r_low`` (its residual bound refereed
                 each step by the decode_residual_bound column)
  dial_up        the straggle evidence stays clear: back to the exact code
  shadow_off     a ``numerics_drift`` episode drops the shadow dtype
  wire_widen /   drift or residual evidence widens the wire one step
  wire_narrow    f32-ward; clean evidence narrows it back toward the
                 configured dtype, never past it
  segments_up /  the straggler ladder's first rung: the wire's segment
  segments_down  count doubles (up to ``segments_max``) and halves back
  fanout_down /  its second rung under ``topology="tree"``: the fan-in
  fanout_up      halves (down to ``fanout_min``) and doubles back

Every dial counts consecutive boundaries of evidence (hysteresis both
ways) and ``max_swaps`` caps the swaps of a run.

A regime change is a warm swap between captured CUDA graphs: each regime's
setup is built once (``client.build_setup``) around the live model and
``TrainState`` (``training/step.build_train_setup(live=)``, the LM's
``parallel/sp_step.build_sp_train_setup(live=)``), so every
regime's graph reads and updates the same parameter, momentum, statistics
and count tensors, and a swap copies no weights. The first chunk in a new
regime captures its graph (``"executable": "compiled"`` in the
remediation's evidence, the reference's word); a return to a regime
replays the graph it captured before (``"reused"``). Quarantine and
readmit write only the host's presence schedule.

Every decision is a ``remediation`` line in the run's incidents.jsonl (the
engine's stream and sequence, naming the episode that triggered it) and
status.json's ``control`` block (``obs/heartbeat.RunHeartbeat
.set_control``). The remediation dicts are the reference's key for key.

Host only: the port's fault plan, topology, wire constants and forensics.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Optional

from draco_tpu_torch.coding.topology import group_worker_fail, tree_plan
from draco_tpu_torch.obs import numerics as numerics_mod
from draco_tpu_torch.resilience.faults import INGRAPH_KINDS, plan_from_cfg

# the boundary-hysteresis policy; every key can be overridden a run by
# ``cfg.autopilot_policy`` ("key=value,...", parse_policy)
DEFAULT_POLICY: Dict[str, float] = {
    # quarantine: a present worker whose trust (obs/forensics) is under the
    # floor while a trust episode names it
    "trust_floor": 0.5,
    # most workers quarantined at once; -1 derives it from the code's
    # erasure budget (_quarantine_budget)
    "quarantine_budget": -1.0,
    # boundaries a quarantined worker waits before parole, and the trust
    # its ledger row resets to then
    "readmit_boundaries": 8.0,
    "parole_trust": 0.75,
    # dial_down: boundaries running with a straggle/starvation episode
    # open, and boundaries running with the adversary signals quiet
    "dial_down_boundaries": 2.0,
    "clean_boundaries": 2.0,
    # dial_up: boundaries running with the straggle evidence clear
    "dial_up_boundaries": 3.0,
    # the approx redundancy dial_down swaps to
    "r_low": 1.5,
    # most regime swaps a run
    "max_swaps": 8.0,
    # boundaries of numerics_drift before the shadow dtype is dropped
    "shadow_off_boundaries": 1.0,
    # the wire dial: boundaries of drift / residual evidence before a
    # widening step, and of clean evidence before a narrowing one
    "wire_widen_boundaries": 1.0,
    "wire_narrow_boundaries": 4.0,
    # the segment dial: boundaries of straggle evidence before the segment
    # count doubles (at most segments_max), of quiet before it halves
    "segments_up_boundaries": 1.0,
    "segments_down_boundaries": 4.0,
    "segments_max": 4.0,
    # the fanout dial (topology="tree"): boundaries of straggle evidence
    # before the fan-in halves (at least fanout_min), of quiet before it
    # doubles back toward the configured fanout
    "fanout_down_boundaries": 2.0,
    "fanout_up_boundaries": 4.0,
    "fanout_min": 2.0,
}

# incident types that count as adversary evidence: one open (or a new
# accusation in the ledger) vetoes a dial_down and resets the clean window
_ADVERSARY_TYPES = ("trust", "guard", "nonfinite", "decode_residual")
_STRAGGLE_TYPES = ("straggle", "starvation")


def parse_policy(spec: str) -> Dict[str, float]:
    """``"r_low=1.2,clean_boundaries=3"`` -> the overrides; an unknown key
    or a malformed item raises ValueError."""
    out: Dict[str, float] = {}
    for item in (spec or "").split(","):
        item = item.strip()
        if not item:
            continue
        try:
            key, val = item.split("=", 1)
            key = key.strip()
            fval = float(val)
        except ValueError:
            raise ValueError(
                f"autopilot policy {item!r} is not '<key>=<float>'")
        if key not in DEFAULT_POLICY:
            raise ValueError(
                f"unknown autopilot policy key {key!r} (known: "
                f"{', '.join(sorted(DEFAULT_POLICY))})")
        out[key] = fval
    return out


@dataclasses.dataclass(frozen=True)
class Regime:
    """One point of the dial: the code family, its redundancy (cyclic: the
    load r = 2s+1; approx: the fractional code_redundancy), the shadow
    dtype, the wire's dtype and segments, and the tree's fan-in (0 =
    flat)."""

    approach: str
    redundancy: float
    shadow_wire: str
    wire_dtype: str = "f32"
    wire_segments: int = 1
    tree_fanout: int = 0

    @property
    def tag(self) -> str:
        t = f"{self.approach}_r{self.redundancy:g}"
        if self.shadow_wire != "off":
            t += f"_{self.shadow_wire}"
        if self.wire_dtype != "f32":
            t += f"_wire{self.wire_dtype}"
        if self.wire_segments != 1:
            t += f"_seg{self.wire_segments}"
        if self.tree_fanout:
            t += f"_g{self.tree_fanout}"
        return t

    def as_dict(self) -> dict:
        return {"approach": self.approach, "redundancy": self.redundancy,
                "shadow_wire": self.shadow_wire,
                "wire_dtype": self.wire_dtype,
                "wire_segments": self.wire_segments,
                "tree_fanout": self.tree_fanout, "tag": self.tag}


def base_regime(cfg) -> Regime:
    r = (2 * cfg.worker_fail + 1 if cfg.approach == "cyclic"
         else float(cfg.code_redundancy))
    fanout = int(cfg.tree_fanout) if cfg.topology == "tree" else 0
    return Regime(cfg.approach, float(r), cfg.shadow_wire, cfg.wire_dtype,
                  int(cfg.wire_segments), fanout)


def regime_cfg(base_cfg, regime: Regime, quarantined: int = 0):
    """The TrainConfig of a regime's setup. The fault plan keeps its
    in-step kinds only (the schedule and host kinds were applied to the
    host's tables at launch); a tree fanout dialled off the launch value
    re-derives its depth; the approx regime drops the Byzantine fields and
    sizes its straggler design point for ``quarantined`` workers, the
    configured stragglers and one more."""
    kw = {"approach": regime.approach, "shadow_wire": regime.shadow_wire,
          "wire_dtype": regime.wire_dtype,
          "wire_segments": regime.wire_segments}
    if regime.tree_fanout:
        kw["topology"] = "tree"
        kw["tree_fanout"] = regime.tree_fanout
        if regime.tree_fanout != int(base_cfg.tree_fanout):
            kw["tree_levels"] = 0
    else:
        kw["topology"] = "flat"
    plan = plan_from_cfg(base_cfg)
    if plan is not None:
        kw["fault_spec"] = ",".join(ev.spec() for ev in plan.events
                                    if ev.kind in INGRAPH_KINDS)
    if regime.approach == "approx":
        n = base_cfg.num_workers
        alpha = max(
            base_cfg.straggler_alpha,
            min(0.9, (quarantined + base_cfg.straggle_count + 1) / n),
        )
        kw.update(worker_fail=0, adversary_count=0, redundancy="shared",
                  code_redundancy=float(regime.redundancy),
                  assignment_scheme="pairwise", straggler_alpha=alpha)
    elif regime.approach == "cyclic":
        kw.update(worker_fail=base_cfg.worker_fail,
                  adversary_count=base_cfg.adversary_count,
                  redundancy=base_cfg.redundancy)
    return dataclasses.replace(base_cfg, **kw)


class Autopilot:
    """The policy: :meth:`act` at every flush of the chunked loop, reading
    the incident engine the heartbeat feeds and actuating through the
    engine's client."""

    def __init__(self, cfg, heartbeat, policy: Optional[dict] = None,
                 dim: Optional[int] = None):
        self.cfg = cfg
        self.heartbeat = heartbeat
        self.incidents = heartbeat.incidents  # the IncidentEngine
        self.policy = dict(DEFAULT_POLICY)
        self.policy.update(policy or {})
        self.base = base_regime(cfg)
        self.regime = self.base
        self.dim = dim
        self._setups: dict = {}  # Regime -> its setup (the warm swaps)
        # worker -> {"step", "boundaries", "trigger"} while quarantined
        self.quarantined: Dict[int, dict] = {}
        # readmitted workers not yet seen present in a record (the pending
        # chunk was assembled before the readmit): they stay out of the
        # straggle detector until then
        self._paroled: Dict[int, int] = {}
        self.remediations: list = []
        self.swaps = 0
        self._adv_quiet = 0
        self._strag_hot = 0
        self._strag_quiet = 0
        self._drift_hot = 0
        self._wire_hot = 0
        self._wire_quiet = 0
        self._prev_accused = 0.0

    def attach(self, client) -> None:
        """The engine's construction hook: cache the loop's base setup, and
        put a fresh client (a later ``run()``) on the current regime."""
        setup = getattr(client, "setup", None)
        if setup is not None:
            self._setups.setdefault(self.base, setup)
        if self.regime != self.base and self.regime in self._setups:
            client.switch_regime(
                self._setups[self.regime],
                f"{client.BASE_LABEL}@{self.regime.tag}")

    # ---- evidence --------------------------------------------------------
    def _quarantine_budget(self) -> int:
        b = self.policy["quarantine_budget"]
        if b >= 0:
            return int(b)
        cfg = self.cfg
        if self.base.approach == "cyclic":
            # the erasure budget 2s, less the configured stragglers and one
            # unit of headroom
            return max(0, 2 * cfg.worker_fail - cfg.straggle_count - 1)
        return max(0, math.ceil(cfg.straggler_alpha * cfg.num_workers)
                   - cfg.straggle_count - 1)

    def _open(self) -> Dict[str, dict]:
        return {e["type"]: e for e in self.incidents.open_episodes()}

    # ---- actuation -------------------------------------------------------
    def act(self, step: int, engine) -> None:
        """One boundary's decisions; ``engine.client`` actuates them. Reads
        only what the flush has already folded: no fetch, no
        synchronisation."""
        client = engine.client
        # parole ends when a record shows the readmitted worker present
        masks = self.incidents.current_masks
        for w in list(self._paroled):
            if masks is not None and masks["present"][w]:
                self.incidents.quarantined.discard(w)
                del self._paroled[w]
        open_eps = self._open()
        ledger = self.incidents.ledger

        # adversary-quiet: no adversary-class episode open and no new
        # accusation since the last boundary
        accused = float(sum(ledger.accused)) if ledger is not None else 0.0
        adversary_evidence = (
            any(t in open_eps for t in _ADVERSARY_TYPES)
            or accused > self._prev_accused)
        self._prev_accused = accused
        self._adv_quiet = 0 if adversary_evidence else self._adv_quiet + 1

        straggle_evidence = any(t in open_eps for t in _STRAGGLE_TYPES)
        self._strag_hot = self._strag_hot + 1 if straggle_evidence else 0
        self._strag_quiet = 0 if straggle_evidence else self._strag_quiet + 1
        self._drift_hot = (self._drift_hot + 1
                           if "numerics_drift" in open_eps else 0)
        # the wire's evidence: drift on the wire columns or the decode
        # residual's
        wire_evidence = ("numerics_drift" in open_eps
                         or "decode_residual" in open_eps)
        self._wire_hot = self._wire_hot + 1 if wire_evidence else 0
        self._wire_quiet = 0 if wire_evidence else self._wire_quiet + 1

        self._maybe_quarantine(step, client, open_eps, ledger)
        self._maybe_readmit(step, client, ledger)
        if getattr(client, "can_swap", True) \
                and self.swaps < self.policy["max_swaps"]:
            self._maybe_swap(step, client, open_eps)
        self.heartbeat.set_control(self.status_block())

    def _maybe_swap(self, step, client, open_eps) -> None:
        """At most one regime swap a boundary, the first rule that holds."""
        regime, base, policy = self.regime, self.base, self.policy
        straggle = open_eps.get("straggle") or open_eps.get("starvation")
        if regime.wire_dtype != "f32" \
                and self._wire_hot >= policy["wire_widen_boundaries"]:
            target = dataclasses.replace(
                regime, wire_dtype=numerics_mod.WIRE_WIDEN[regime.wire_dtype])
            self._swap(step, client, target, "wire_widen",
                       open_eps.get("numerics_drift")
                       or open_eps.get("decode_residual"), {
                           "wire_evidence_boundaries": self._wire_hot,
                           "wire_dtype_before": regime.wire_dtype,
                           "wire_dtype_after": target.wire_dtype,
                       })
        elif (regime.wire_dtype != base.wire_dtype
              and self._wire_quiet >= policy["wire_narrow_boundaries"]
              and numerics_mod.narrow_toward(regime.wire_dtype,
                                             base.wire_dtype)
              != regime.wire_dtype):
            target = dataclasses.replace(
                regime, wire_dtype=numerics_mod.narrow_toward(
                    regime.wire_dtype, base.wire_dtype))
            self._swap(step, client, target, "wire_narrow",
                       self._last_cleared(("numerics_drift",
                                           "decode_residual")), {
                           "wire_quiet_boundaries": self._wire_quiet,
                           "wire_dtype_before": regime.wire_dtype,
                           "wire_dtype_after": target.wire_dtype,
                       })
        elif self._drift_hot >= policy["shadow_off_boundaries"] \
                and regime.shadow_wire != "off":
            self._swap(step, client,
                       dataclasses.replace(regime, shadow_wire="off"),
                       "shadow_off", open_eps.get("numerics_drift"),
                       {"drift_boundaries": self._drift_hot})
        elif (regime.approach in ("cyclic", "approx")
              and self._strag_hot >= policy["segments_up_boundaries"]
              and regime.wire_segments < int(policy["segments_max"])):
            # the straggler ladder's first rung keeps the family and its
            # certificate: the aggregator decodes segments as they arrive
            target = dataclasses.replace(
                regime, wire_segments=min(max(2 * regime.wire_segments, 2),
                                          int(policy["segments_max"])))
            self._swap(step, client, target, "segments_up", straggle, {
                "straggle_boundaries": self._strag_hot,
                "wire_segments_before": regime.wire_segments,
                "wire_segments_after": target.wire_segments,
            })
        elif (regime.tree_fanout
              and self._strag_hot >= policy["fanout_down_boundaries"]
              and regime.tree_fanout % 2 == 0
              and regime.tree_fanout // 2 >= int(policy["fanout_min"])
              and self._fanout_ok(regime.tree_fanout // 2)):
            # the second rung: half the fan-in, so one slow child stalls a
            # smaller subtree
            target = dataclasses.replace(regime,
                                         tree_fanout=regime.tree_fanout // 2)
            self._swap(step, client, target, "fanout_down", straggle, {
                "straggle_boundaries": self._strag_hot,
                "tree_fanout_before": regime.tree_fanout,
                "tree_fanout_after": target.tree_fanout,
            })
        elif (regime.approach == "cyclic"
              and self._strag_hot >= policy["dial_down_boundaries"]
              and self._adv_quiet >= policy["clean_boundaries"]
              and self._dial_down_allowed(step)):
            target = Regime("approx", float(policy["r_low"]),
                            regime.shadow_wire, regime.wire_dtype,
                            tree_fanout=regime.tree_fanout)
            self._swap(step, client, target, "dial_down", straggle, {
                "straggle_boundaries": self._strag_hot,
                "adversary_quiet_boundaries": self._adv_quiet,
                "fleet_load_before": regime.redundancy,
                "fleet_load_after": target.redundancy,
                "accepted_bound": "optimal-decoding residual bound "
                                  "(arXiv:2006.09638), per-step column "
                                  "decode_residual_bound",
            })
        elif (regime.approach == "approx" and base.approach == "cyclic"
              and self._strag_quiet >= policy["dial_up_boundaries"]):
            self._swap(step, client,
                       dataclasses.replace(
                           base, shadow_wire=regime.shadow_wire,
                           wire_dtype=regime.wire_dtype,
                           wire_segments=regime.wire_segments),
                       "dial_up", self._last_cleared(_STRAGGLE_TYPES), {
                           "straggle_quiet_boundaries": self._strag_quiet,
                           "restores": "exact decode + Byzantine "
                                       "certificate",
                       })
        elif (regime.tree_fanout and base.tree_fanout
              and regime.tree_fanout < base.tree_fanout
              and self._strag_quiet >= policy["fanout_up_boundaries"]):
            target = dataclasses.replace(
                regime, tree_fanout=min(2 * regime.tree_fanout,
                                        base.tree_fanout))
            self._swap(step, client, target, "fanout_up",
                       self._last_cleared(_STRAGGLE_TYPES), {
                           "straggle_quiet_boundaries": self._strag_quiet,
                           "tree_fanout_before": regime.tree_fanout,
                           "tree_fanout_after": target.tree_fanout,
                       })
        elif (regime.wire_segments > base.wire_segments
              and self._strag_quiet >= policy["segments_down_boundaries"]):
            target = dataclasses.replace(
                regime, wire_segments=max(regime.wire_segments // 2,
                                          base.wire_segments))
            self._swap(step, client, target, "segments_down",
                       self._last_cleared(_STRAGGLE_TYPES), {
                           "straggle_quiet_boundaries": self._strag_quiet,
                           "wire_segments_before": regime.wire_segments,
                           "wire_segments_after": target.wire_segments,
                       })

    def _fanout_ok(self, fanout: int) -> bool:
        """A dialled fanout keeps a buildable tree and, on the cyclic code,
        a per-group budget s_g that covers the declared adversaries (all of
        them in one group at worst, as config.validate rules)."""
        try:
            tree_plan(self.cfg.num_workers, fanout)
        except ValueError:
            return False
        if self.regime.approach == "cyclic":
            s_g = group_worker_fail(fanout, self.cfg.worker_fail)
            if self.cfg.num_adversaries > s_g:
                return False
        return True

    def _dial_down_allowed(self, step: int) -> bool:
        """The approx code injects no adversary (config.validate refuses
        the adversary and over_budget kinds under it): a run whose
        declared adversaries or fault-plan adversary events reach past
        ``step`` may not dial into it."""
        if self.cfg.num_adversaries > 0:
            return False
        plan = plan_from_cfg(self.cfg)
        if plan is not None:
            for ev in plan.of_kind("adversary", "over_budget"):
                if ev.last_step > step:
                    return False
        return True

    def _maybe_quarantine(self, step, client, open_eps, ledger) -> None:
        if ledger is None:
            return
        trigger = open_eps.get("trust")
        if trigger is None:
            return  # a decision names the episode it answers
        floor = self.policy["trust_floor"]
        candidates = sorted(
            (w for w in range(ledger.n)
             if ledger.trust[w] < floor and w not in self.quarantined),
            key=lambda w: ledger.trust[w])
        if not candidates:
            return
        if len(self.quarantined) >= self._quarantine_budget():
            return  # no erasure budget left: the guard keeps the run safe
        w = candidates[0]
        client.quarantine(w, from_step=step + 1)
        self.incidents.quarantined.add(w)
        self.quarantined[w] = {"step": step, "boundaries": 0,
                               "trigger": trigger}
        self._remediate("quarantine", step, trigger, worker=w, evidence={
            "trust": round(ledger.trust[w], 4), "trust_floor": floor,
            # the worker is an erasure now: the budget the decode keeps
            "quarantined_total": len(self.quarantined),
            "erasure_budget": self._quarantine_budget(),
            # the next chunk was assembled before this boundary: the wire
            # sees the schedule write one chunk after effective_step
            "wire_lag": "one assembled chunk",
        })

    def reapply_quarantines(self, schedule) -> None:
        """Stamp every active quarantine onto a regenerated presence
        schedule (``training/run_state.LoopRunState.straggle_table``): a
        new table must not readmit a worker the policy still holds out."""
        for w in self.quarantined:
            schedule[:, w] = True

    def _maybe_readmit(self, step, client, ledger) -> None:
        for w in list(self.quarantined):
            info = self.quarantined[w]
            info["boundaries"] += 1
            if info["boundaries"] < self.policy["readmit_boundaries"] \
                    or self._adv_quiet < self.policy["clean_boundaries"]:
                continue
            client.readmit(w, from_step=step + 1)
            # out of the straggle detector until a record shows it present
            self._paroled[w] = step
            if ledger is not None:
                ledger.forgive(w, self.policy["parole_trust"])
            del self.quarantined[w]
            self._remediate("readmit", step, info["trigger"], worker=w,
                            evidence={
                                "quarantined_boundaries": info["boundaries"],
                                "adversary_quiet_boundaries":
                                    self._adv_quiet,
                                "parole_trust": self.policy["parole_trust"],
                            })

    def _swap(self, step, client, target: Regime, action, trigger,
              evidence) -> None:
        setup = self._setups.get(target)
        warm = setup is not None
        if setup is None:
            # built for the largest quarantine the policy can reach: the
            # setup is cached, and a later entry with more workers out must
            # stay inside the approx design point it was built for
            setup = client.build_setup(
                regime_cfg(self.cfg, target, self._quarantine_budget()))
            self._setups[target] = setup
        label = (client.BASE_LABEL if target == self.base
                 else f"{client.BASE_LABEL}@{target.tag}")
        client.switch_regime(setup, label)
        client.wire_segments = target.wire_segments
        prev, self.regime = self.regime, target
        self.swaps += 1
        # the new regime earns its own evidence windows
        self._strag_hot = self._strag_quiet = self._drift_hot = 0
        self._wire_hot = self._wire_quiet = 0
        # the wire ledger is the family's: re-stamp the status block
        dim = getattr(setup, "dim", None) or self.dim
        if dim:
            self.heartbeat.set_wire(numerics_mod.wire_ledger(
                regime_cfg(self.cfg, target, len(self.quarantined)), dim))
        ev = dict(evidence or {})
        ev["executable"] = "reused" if warm else "compiled"
        self._remediate(action, step, trigger, regime=target, evidence=ev,
                        regime_from=prev)

    def _last_cleared(self, types) -> Optional[dict]:
        """The newest closed episode of ``types``: a recovery decision's
        attribution."""
        for ep in reversed(self.incidents.episodes):
            if ep["type"] in types:
                return dict(ep, cleared=True)
        return None

    # ---- reporting -------------------------------------------------------
    def _remediate(self, action, step, trigger, worker=None, regime=None,
                   evidence=None, regime_from=None) -> None:
        rem = {
            "action": action, "step": int(step),
            # wall clock, so that the control block's ``last`` carries it
            # (the stream stamps its own copy a line)
            "ts": time.time(),
            "effective_step": int(step) + 1,
            "worker": worker,
            "regime": regime.as_dict() if regime is not None else None,
            "regime_from": (regime_from.as_dict()
                            if regime_from is not None else None),
            "trigger": ({
                "type": trigger.get("type"),
                "severity": trigger.get("severity"),
                "onset_step": trigger.get("onset_step"),
                "workers": trigger.get("workers"),
                "cleared": bool(trigger.get("cleared", False)),
            } if trigger else None),
            "evidence": dict(evidence or {}),
        }
        self.remediations.append(rem)
        self.incidents.remediation(rem)
        self.heartbeat.set_control(self.status_block())

    def status_block(self) -> dict:
        """status.json's ``control`` block."""
        return {
            "autopilot": "on",
            "regime": self.regime.as_dict(),
            "base_regime": self.base.tag,
            "swaps": self.swaps,
            "quarantined": sorted(self.quarantined),
            "remediations": len(self.remediations),
            "last": (self.remediations[-1] if self.remediations else None),
        }


def make_autopilot(cfg, heartbeat, dim: Optional[int] = None
                   ) -> Optional[Autopilot]:
    """An autopilot when ``cfg.autopilot == "on"`` and the heartbeat feeds
    an incident engine (its sensing layer), else None."""
    if cfg.autopilot != "on" or heartbeat.incidents is None:
        return None
    return Autopilot(cfg, heartbeat, policy=parse_policy(cfg.autopilot_policy),
                     dim=dim)
