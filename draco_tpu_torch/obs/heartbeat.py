"""The run heartbeat: ``train_dir/status.json``, rewritten at every flush
boundary (draco_tpu/obs/heartbeat.py, status schema 5).

One small JSON file, replaced atomically (a temporary file, then a
rename), holds what a dashboard or a watchdog needs: the step, the
total, steps a second and the time left; the last record's loss (and
prec1); the decode health — detection precision and recall against the
seeded schedule, summed over the records, and the newest residual / vote
agreement; the ``forensics`` block (``obs/forensics.AccusationLedger``:
top suspects, trust, episodes); the ``wire`` block (the run's
``obs/numerics.wire_ledger``, stamped once); on observatory runs the
``numerics`` block (the newest range statistics, the worst danger
fractions and shadow errors, the lowest shadow flag agreement and the
steps whose shadow comparison was poisoned); the ``guard`` block (the
step guard's ``trips`` and ``skipped_steps`` summed over the records,
written once a record carried the guard's columns); the ``incidents``
block (``obs/incidents.IncidentEngine.status_block``: open episodes,
totals by type, the last onset) when the loop hands the heartbeat an
engine (``incident_watch="on"``); the run's ``run_id`` (kept
across a resume: re-read from the directory's status.json) and its
``job_name``; ``updated_at``.

:meth:`RunHeartbeat.observe` takes the records the loops materialise
anyway — the chunked loops' flushes (``utils/metrics
.DeferredMetricWriter``'s observer), the eager loops' records — so the
heartbeat adds no device fetch and no synchronisation. :meth:`beat`
writes the file; :meth:`terminal` ends its life as ``done``,
``preempted`` (with ``resumable_step`` when a checkpoint was snapped) or
``crashed`` (with a one-line ``cause``). The engine observes every
record the heartbeat observes and every beat (with the beat's extras, the
prefetcher's depth and restarts); the terminal write carries the final
incidents block too and closes the engine's stream.

With the autopilot on (``control/autopilot.py``), :meth:`set_control`
stamps its ``control`` block (the regime, the swaps, the quarantined
workers, the last remediation) at every decision pass; the block rides
every later beat and the terminal write, so the run's last word names the
regime it ended in. :meth:`observe_device` folds the capture a profiler
window just stopped (``obs/profiling.py``, its ``on_stop``) into the
``device`` block (``obs/device_attr.device_status_block``: the profiled
steps, the device time, the phase fractions, the decode share, the
attributed share, beside the fold's ``mode`` and the ``profile_dir``):
best-effort, a torn capture folds nothing, nor does a cuda run's capture
that lost its kernel events, and the fold never takes the run down; the
block rides every later beat and the terminal write. The loops merge
their compile watch's ``snapshot()`` (``obs/compile_watch.py``:
``compiles``, ``compile_s``, ``steady_recompiles``) into every beat's
extras.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import Optional

from draco_tpu_torch.obs.forensics import AccusationLedger

# the payload's schema version (the reference's): 2 added ``schema``,
# ``forensics``, ``num_workers`` and ``device``; 3 the ``wire`` and
# ``numerics`` blocks; 4 ``incidents``; 5 ``run_id`` and ``job_name``
STATUS_SCHEMA = 5

# optional block -> the schema that introduced it
STATUS_BLOCKS = {
    "decode_health": 2, "guard": 2, "forensics": 2, "device": 2,
    "wire": 3, "numerics": 3,
    "incidents": 4,
    "control": 4,
    "run_id": 5, "job_name": 5,
}
KNOWN_STATUS_SCHEMAS = tuple(range(2, STATUS_SCHEMA + 1))


def check_status_schema(status: dict, path: str = "status.json",
                        tool: str = "this tool") -> dict:
    """Hold a loaded status.json to the schema: a ``schema`` field, when
    present, is a known version, and no block appears under a schema older
    than the one that introduced it. Raises SystemExit naming the
    mismatch; returns ``status``."""
    if not isinstance(status, dict):
        return status
    schema = status.get("schema")
    if schema is not None and schema not in KNOWN_STATUS_SCHEMAS:
        raise SystemExit(
            f"{path}: status.json schema {schema!r} not in known "
            f"{KNOWN_STATUS_SCHEMAS} — update {tool} alongside "
            f"obs/heartbeat.STATUS_SCHEMA")
    if schema is not None:
        for block, introduced in STATUS_BLOCKS.items():
            if block in status and schema < introduced:
                raise SystemExit(
                    f"{path}: block {block!r} requires status schema >= "
                    f"{introduced}, payload claims {schema} — a writer and "
                    f"obs/heartbeat.STATUS_BLOCKS disagree")
    return status


# the detection counts: tp = flagged ∧ adversarial ∧ present, adv =
# adversarial ∧ present, flagged = located_errors | det_flagged
_TP_KEY = "det_tp"
_ADV_KEY = "det_adv"
_FLAGGED_KEYS = ("located_errors", "det_flagged")
# health values copied from the newest record that carries them
_LAST_KEYS = ("decode_residual", "vote_agree", "flagged_groups",
              "honest_located", "decode_residual_bound",
              "recovered_fraction")
# the numerics block: the newest range statistics, the running maxima of
# the danger fractions and shadow errors, the running minimum of the
# shadow flag agreement
_NX_LAST = ("nx_grad_absmax", "nx_grad_rms", "nx_wire_absmax",
            "nx_wire_rms", "nx_agg_absmax", "nx_agg_rms")
_NX_MAX = ("nx_wire_uf_bf16", "nx_wire_uf_int8", "nx_wire_of_bf16",
           "nx_grad_nonfinite", "nx_wire_nonfinite", "shadow_err",
           "shadow_residual")
_NX_MIN = ("shadow_flag_agree",)


class RunHeartbeat:
    """Folds records (:meth:`observe`) and rewrites ``status.json``
    (:meth:`beat`). With no ``train_dir`` every method returns at once."""

    def __init__(self, train_dir: Optional[str],
                 num_workers: Optional[int] = None,
                 job_name: Optional[str] = None, incidents=None):
        self.path = (os.path.join(train_dir, "status.json") if train_dir
                     else None)
        if self.path:
            os.makedirs(train_dir, exist_ok=True)
        self.run_id = self._load_or_mint_run_id() if self.path else None
        self.job_name = str(job_name) if job_name else None
        self._t0 = time.perf_counter()
        self._first_step: Optional[int] = None
        self._tp = 0.0
        self._adv = 0.0
        self._flagged = 0.0
        self._guard_trips = 0.0
        self._skipped_steps = 0.0
        self._guard_seen = False  # a record carried the guard's columns
        self._last: dict = {}
        self._nx: dict = {}
        self._wire: Optional[dict] = None
        self._control: Optional[dict] = None  # the autopilot's block
        self._device: Optional[dict] = None  # the profiled window's block
        # the newest record that carried health columns
        self._last_health_rec: dict = {}
        self._last_payload: dict = {}
        self.ledger = (AccusationLedger(num_workers)
                       if (self.path and num_workers) else None)
        # the incident engine (obs/incidents.py), or None
        self.incidents = incidents if self.path else None

    def _load_or_mint_run_id(self) -> str:
        """The directory's run_id (a resume keeps it), else a new one; a
        torn or missing file never stops the run."""
        try:
            with open(self.path) as fh:
                prior = json.load(fh)
            rid = prior.get("run_id") if isinstance(prior, dict) else None
            if isinstance(rid, str) and rid:
                return rid
        except (OSError, ValueError):
            pass
        return uuid.uuid4().hex[:12]

    def observe(self, record: dict) -> None:
        """Fold one materialised train record; each column family is
        optional (the baseline's records carry none, eval records none)."""
        if self.path is None:
            return
        step = record.get("step")
        if step is not None and self._first_step is None:
            self._first_step = int(step)
        if _TP_KEY in record:
            self._tp += float(record[_TP_KEY])
            self._adv += float(record.get(_ADV_KEY, 0.0))
            for k in _FLAGGED_KEYS:
                if k in record:
                    self._flagged += float(record[k])
                    break
            self._last_health_rec = record
        elif "decode_residual_bound" in record:
            # the approx code: no detection columns, its certificate
            self._last_health_rec = record
        if "guard_trips" in record:
            self._guard_trips += float(record["guard_trips"])
            self._skipped_steps += float(record.get("skipped_steps", 0.0))
            self._guard_seen = True
        for k in _NX_LAST:
            if k in record:
                self._nx[k] = float(record[k])
        # a shadow column at the sentinel marks a poisoned comparison:
        # counted, and kept out of the extremes
        if any(k in record and float(record[k]) < 0.0
               for k in _NX_MAX + _NX_MIN if k.startswith("shadow_")):
            self._nx["shadow_sentinel_steps"] = \
                self._nx.get("shadow_sentinel_steps", 0) + 1
        for k in _NX_MAX:
            if k in record:
                v = float(record[k])
                if k.startswith("shadow_") and v < 0.0:
                    continue
                key = f"{k}_max"
                self._nx[key] = max(self._nx.get(key, float("-inf")), v)
        for k in _NX_MIN:
            if k in record:
                v = float(record[k])
                if v < 0.0:
                    continue
                key = f"{k}_min"
                self._nx[key] = min(self._nx.get(key, float("inf")), v)
        # the engine first: it unpacks the record's masks once, and the
        # ledger reuses them
        if self.incidents is not None:
            self.incidents.observe(record)
        if self.ledger is not None:
            masks = (self.incidents.current_masks
                     if self.incidents is not None
                     and self.incidents.num_workers == self.ledger.n
                     else None)
            self.ledger.observe(record, masks=masks)
        self._last = record

    def set_wire(self, ledger: Optional[dict]) -> None:
        """Stamp the run's wire ledger (``obs/numerics.wire_ledger``), the
        ``wire`` block; None is a no-op."""
        if self.path is None or ledger is None:
            return
        self._wire = dict(ledger)

    def set_control(self, block: Optional[dict]) -> None:
        """Stamp the autopilot's ``control`` block
        (``Autopilot.status_block``); None is a no-op."""
        if self.path is None or block is None:
            return
        self._control = dict(block)

    def observe_device(self, profile_dir: str) -> None:
        """Fold the capture just stopped under ``profile_dir`` into the
        ``device`` block (the profiler window's ``on_stop``)."""
        if self.path is None:
            return
        try:
            from draco_tpu_torch.obs import device_attr

            fold = device_attr.fold_capture(profile_dir)
            block = device_attr.device_status_block(fold) if fold else None
        except Exception:
            return
        if block is not None:
            # the fold's mode: "device" (kernel events) or "cpu" (a CPU
            # run's op self-times)
            block["mode"] = fold["programs"][0]["mode"]
            block["profile_dir"] = profile_dir
            self._device = block

    def decode_health(self) -> Optional[dict]:
        """Detection precision / recall over the records (1.0 on an empty
        denominator) and the newest health values."""
        if not self._last_health_rec:
            return None
        health = {
            "precision": (self._tp / self._flagged) if self._flagged else 1.0,
            "recall": (self._tp / self._adv) if self._adv else 1.0,
            "flagged_total": self._flagged,
            "adv_total": self._adv,
        }
        for k in _LAST_KEYS:
            if k in self._last_health_rec:
                health[k] = float(self._last_health_rec[k])
        return health

    def beat(self, step: int, total_steps: Optional[int] = None,
             extra: Optional[dict] = None) -> Optional[dict]:
        """Rewrite status.json; ``extra`` merges verbatim. Returns the
        payload (None when disabled)."""
        if self.path is None:
            return None
        now = time.perf_counter()
        done = step - (self._first_step or step) + 1
        rate = done / max(now - self._t0, 1e-9)
        payload = {
            "schema": STATUS_SCHEMA,
            "state": "running",
            "run_id": self.run_id,
            "step": int(step),
            "total_steps": int(total_steps) if total_steps else None,
            "steps_per_s": round(rate, 4),
            "eta_s": (round(max(total_steps - step, 0) / rate, 1)
                      if (total_steps and rate > 0) else None),
            "updated_at": time.time(),
        }
        if self.job_name:
            payload["job_name"] = self.job_name
        for k in ("loss", "prec1"):
            if k in self._last:
                payload[k] = float(self._last[k])
        health = self.decode_health()
        if health is not None:
            payload["decode_health"] = health
        if self._guard_seen:
            payload["guard"] = {"trips": self._guard_trips,
                                "skipped_steps": self._skipped_steps}
        if self.ledger is not None and self.ledger.active:
            payload["forensics"] = self.ledger.summary()
        if self._wire is not None:
            payload["wire"] = self._wire
        if self._nx:
            payload["numerics"] = dict(self._nx)
        if self._device is not None:
            payload["device"] = self._device
        if self._control is not None:
            payload["control"] = self._control
        if self.incidents is not None:
            # the beat is the engine's beat observation
            self.incidents.observe_beat(step, extra)
            payload["incidents"] = self.incidents.status_block()
        if extra:
            payload.update(extra)
        self._write(payload)
        return payload

    def terminal(self, state: str, cause: Optional[str] = None,
                 resumable_step: Optional[int] = None) -> Optional[dict]:
        """The run's final status.json: ``done`` | ``preempted`` |
        ``crashed``, on the last beat's payload (a previous terminal's
        ``cause`` and ``resumable_step`` dropped)."""
        if self.path is None:
            return None
        payload = {k: v for k, v in self._last_payload.items()
                   if k not in ("state", "cause", "resumable_step")}
        payload["schema"] = STATUS_SCHEMA
        payload["state"] = state
        payload["run_id"] = self.run_id
        if self.job_name:
            payload["job_name"] = self.job_name
        payload["updated_at"] = time.time()
        if self._device is not None:
            # a window that stops on the run's last unit has no later beat
            payload["device"] = self._device
        if self._control is not None:
            # the regime the run ended in, a remediation after the last
            # beat included
            payload["control"] = self._control
        if self.incidents is not None:
            # an incident opened after the last beat (the crash step, a
            # guard trip at the stop) rides the run's last word
            payload["incidents"] = self.incidents.status_block()
            self.incidents.finalize()
        if cause is not None:
            payload["cause"] = str(cause)[:500]
        if resumable_step is not None:
            payload["resumable_step"] = int(resumable_step)
        self._write(payload)
        return payload

    def _write(self, payload: dict) -> None:
        self._last_payload = payload
        tmp = self.path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(payload, fh)
        os.replace(tmp, self.path)
