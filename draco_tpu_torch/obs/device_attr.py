"""Device-time attribution: fold a ``torch.profiler`` capture into the step's
phases (draco_tpu/obs/device_attr.py), and merge it with the host span
trace on one clock.

Pure artifact folding: this module imports neither torch nor the rest of the
package, so a capture copied off the machine that ran it folds anywhere
(``python -m draco_tpu_torch.obs.trace_report DIR --profile-dir P``).

Capture layout
--------------

``obs/profiling.ProfilerWindow`` writes, under its ``profile_dir``:

  plugins/profile/<YYYY_MM_DD_HH_MM_SS>/<host>.trace.json.gz
                          the window's Chrome trace (torch.profiler's
                          ``export_chrome_trace``), newest wins
  host_anchor.json        the wall-clock anchor (``load_anchor``)
  device_graph_map.json   the captured graphs' kernel maps, written by
                          ``training/chunk_graph.StepGraph`` when it
                          captured outside the window (``load_graph_maps``)

Event shapes
------------

* **On the card** the device stream is the ``kernel``, ``gpu_memcpy`` and
  ``gpu_memset`` events. Each carries ``args.correlation``, the id of the
  runtime call (``cat`` ``cuda_runtime`` / ``cuda_driver``) that queued it.
  An eager step's device event is charged to the innermost ``draco_*``
  range (``cat`` ``user_annotation``, ``obs/tracer.phase``) open when that
  call was made, on any thread: autograd's device thread launches the
  backward while the step's thread waits inside ``draco_comp``.
* **A replayed CUDA graph** has no ranges: every kernel of one replay
  correlates to one ``cudaGraphLaunch``. Its phases come from the graph's
  **map**, the ordered (kernel name, phase) list of one eager step of the
  same program: the step of the warm-up that ``StepGraph`` runs just
  before it captures, profiled under its ``phase()`` ranges inside a
  ``draco_graph_warmup::<name>`` range (the warm-up's state snapshot and
  restore run outside it). The replay launches that step's kernels, the
  ones of a name in the step's order. A replay's kernel is placed by its
  name: a name the map gives one phase goes to that phase
  whatever its count, since the profiler at times loses some of a
  replay's kernel records (``replays_short`` counts such replays); a name
  the map gives several phases goes by its ordinal within the name when
  the replay holds as many as the map, else every event of it to
  ``unattributed``; so does a name the map lacks, and a replay with no
  map. The replay's program is the ``draco_graph_replay::<name>`` range
  around the launch; a map is read from ``device_graph_map.json`` or,
  when the warm-up ran inside the window, from the trace itself.
* **On the CPU** (the tests, ``device="cpu"``) there is no kernel event:
  the fold reads the profiler's CPU op events (``cat`` ``cpu_op``, nested,
  by self time) as the device stream, as the reference folds XLA:CPU op
  events on the CPU, and charges each to the innermost ``draco_*`` range
  open on its own thread.

Accounting rule (the "provably sums" contract): every device event's time
(a CPU op's self time) lands in exactly one row, a phase, ``other``
(queued outside every phase) or ``unattributed`` (its runtime call
missing from the trace, or a replay's kernel the map cannot place), so the
rows sum to the window's device time exactly. Nothing unmatched goes into
a phase. That device time is the kernels' summed time: a step's lanes run
on several streams at once, so it can exceed the window's wall; the
ledger's ``busy_us`` is the time at least one device event ran.

The reference's collective ledger and its cross-check against the lint's
manifest have no counterpart here: on one card every shard axis is a tensor
axis and no collective runs, so a program's ``collectives`` is empty.
"""

from __future__ import annotations

import bisect
import collections
import glob
import gzip
import json
import os
from typing import Optional

# the step's phases (obs/tracer.PHASES), ledger row order
PHASES = ("draco_comp", "draco_encode", "draco_decode", "draco_update")
RESIDUAL_ROWS = ("other", "unattributed")
ANCHOR_FILE = "host_anchor.json"
GRAPH_MAP_FILE = "device_graph_map.json"
# the ranges StepGraph opens around its profiled warm-up and its replays
WARMUP_RANGE = "draco_graph_warmup::"
REPLAY_RANGE = "draco_graph_replay::"

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
_CPU_CAT = "cpu_op"


# --------------------------------------------------------------------------
# capture loading
# --------------------------------------------------------------------------

def find_capture(profile_dir: str) -> Optional[str]:
    """The newest ``*.trace.json.gz`` (or ``.trace.json``) under
    ``profile_dir/plugins/profile/<ts>/``; None when there is none."""
    pats = (os.path.join(profile_dir, "plugins", "profile", "*",
                         "*.trace.json.gz"),
            os.path.join(profile_dir, "plugins", "profile", "*",
                         "*.trace.json"))
    hits = [p for pat in pats for p in glob.glob(pat)]
    return max(hits, key=os.path.getmtime) if hits else None


def load_trace(path: str) -> "tuple[list, dict]":
    """(events, top-level payload) of a Chrome trace (.gz or plain; the
    bare event-array form too)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        payload = json.load(fh)
    if isinstance(payload, list):
        return payload, {}
    return payload.get("traceEvents", []) or [], payload


def load_json(path: str) -> Optional[dict]:
    try:
        with open(path) as fh:
            out = json.load(fh)
        return out if isinstance(out, dict) else None
    except (OSError, ValueError):
        return None


def load_anchor(profile_dir: str) -> Optional[dict]:
    """``host_anchor.json`` (obs/profiling.ProfilerWindow), or None."""
    return load_json(os.path.join(profile_dir, ANCHOR_FILE))


def load_graph_maps(profile_dir: str) -> dict:
    """program -> [[kernel name, phase], ...] from
    ``device_graph_map.json`` ({} when absent)."""
    got = load_json(os.path.join(profile_dir, GRAPH_MAP_FILE)) or {}
    progs = got.get("programs")
    return dict(progs) if isinstance(progs, dict) else {}


def save_graph_map(profile_dir: str, program: str, entries: list) -> None:
    """Add (or replace) one program's map in ``device_graph_map.json``
    (tmp + rename)."""
    maps = load_graph_maps(profile_dir)
    maps[program] = [list(e) for e in entries]
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, GRAPH_MAP_FILE)
    with open(path + ".tmp", "w") as fh:
        json.dump({"schema": 1, "programs": maps}, fh)
    os.replace(path + ".tmp", path)


# --------------------------------------------------------------------------
# per-thread self time
# --------------------------------------------------------------------------

def self_times(events: list) -> "list[tuple[dict, float]]":
    """[(event, self µs)]: each complete event's duration minus the
    durations of the events nested inside it on the same thread (a CPU op
    wraps the ops it calls). Partial overlaps stay independent."""
    out = []
    by_tid: dict = collections.defaultdict(list)
    for ev in events:
        if ev.get("ph") == "X":
            by_tid[(ev.get("pid", 0), ev.get("tid", 0))].append(ev)
    for evs in by_tid.values():
        evs.sort(key=lambda e: (float(e.get("ts", 0.0)),
                                -float(e.get("dur", 0.0))))
        stack: list = []  # [ev, end_ts, child_dur]
        for ev in evs:
            ts = float(ev.get("ts", 0.0))
            dur = float(ev.get("dur", 0.0))
            while stack and stack[-1][1] <= ts + 1e-9:
                top = stack.pop()
                out.append((top[0], max(float(top[0].get("dur", 0.0))
                                        - top[2], 0.0)))
            if stack and ts + dur <= stack[-1][1] + 1e-6:
                stack[-1][2] += dur  # nested: the parent pays the child's
            stack.append([ev, ts + dur, 0.0])
        while stack:
            top = stack.pop()
            out.append((top[0], max(float(top[0].get("dur", 0.0))
                                    - top[2], 0.0)))
    return out


# --------------------------------------------------------------------------
# ranges
# --------------------------------------------------------------------------

class _Ranges:
    """Named ``user_annotation`` ranges; :meth:`innermost` answers, for a
    time (and optionally a thread), the latest-opened range holding it."""

    def __init__(self, events: list, keep):
        rs = []
        for ev in events:
            if ev.get("ph") == "X" and ev.get("cat") == "user_annotation":
                name = ev.get("name", "")
                if keep(name):
                    ts = float(ev.get("ts", 0.0))
                    rs.append((ts, ts + float(ev.get("dur", 0.0)), name,
                               (ev.get("pid", 0), ev.get("tid", 0))))
        rs.sort()
        self._rs = rs
        self._starts = [r[0] for r in rs]
        # the longest range, to bound the backward scan
        self._longest = max((r[1] - r[0] for r in rs), default=0.0)

    def innermost(self, ts: float, thread=None) -> Optional[str]:
        i = bisect.bisect_right(self._starts, ts)
        best = None
        while i > 0:
            i -= 1
            r = self._rs[i]
            if ts - r[0] > self._longest:
                break
            if r[1] >= ts and (thread is None or r[3] == thread):
                if best is None or r[0] > best[0]:
                    best = r
        return best[2] if best is not None else None


def _is_phase(name: str) -> bool:
    return name in PHASES


def _device_mode(events: list) -> bool:
    """True when the capture holds the card's events."""
    return any(ev.get("cat") in _DEVICE_CATS for ev in events)


def _is_graph_launch(name: str) -> bool:
    return "GraphLaunch" in name


def _launches(events: list) -> dict:
    """correlation -> (ts, name, thread) of the runtime calls."""
    out = {}
    for ev in events:
        args = ev.get("args") or {}
        if ev.get("cat") in _RUNTIME_CATS and "correlation" in args:
            out[args["correlation"]] = (float(ev.get("ts", 0.0)),
                                        ev.get("name", ""),
                                        (ev.get("pid", 0), ev.get("tid", 0)))
    return out


# --------------------------------------------------------------------------
# graph maps
# --------------------------------------------------------------------------

def graph_map(events: list, span: Optional[tuple] = None) -> list:
    """The ordered [[kernel name, phase], ...] of an eager step's capture
    (the warm-up StepGraph profiles): its device events in device order,
    each with the phase the eager rule gives it ("" outside every phase or
    with no runtime call); with ``span`` (lo, hi) only the events whose
    runtime call was made inside it, on any thread."""
    phases = _Ranges(events, _is_phase)
    launches = _launches(events)
    devs = []
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in _DEVICE_CATS:
            continue
        launch = launches.get((ev.get("args") or {}).get("correlation"))
        if span is not None and (launch is None
                                 or not span[0] <= launch[0] <= span[1]):
            continue
        devs.append((float(ev.get("ts", 0.0)), ev, launch))
    devs.sort(key=lambda t: t[0])
    return [[ev.get("name", ""),
             (phases.innermost(launch[0]) if launch is not None else None)
             or ""] for _, ev, launch in devs]


def warmup_maps(events: list) -> dict:
    """program -> map, from the kernels launched inside each
    ``draco_graph_warmup::<program>`` range of the capture (the warm-up's
    step alone: its state snapshot and restore run outside the range)."""
    out = {}
    for w in events:
        if (w.get("ph") == "X" and w.get("cat") == "user_annotation"
                and str(w.get("name", "")).startswith(WARMUP_RANGE)):
            lo = float(w.get("ts", 0.0))
            out[w["name"][len(WARMUP_RANGE):]] = graph_map(
                events, (lo, lo + float(w.get("dur", 0.0))))
    return out


def _place_replay(group: list, entries: Optional[list]) -> list:
    """The row of each (event, µs) of one replay, in ``group``'s order, by
    its kernel's name in ``entries``: a name the map gives one phase is
    that phase's, whatever its count in the replay (the profiler at times
    loses some of a replay's kernel records); a name of several phases is
    placed by its ordinal within the name when its counts agree, else
    ``unattributed``; so is a name the map lacks, and a replay with no
    map."""
    if not entries:
        return ["unattributed"] * len(group)
    want = collections.defaultdict(list)
    for name, ph in entries:
        want[name].append(ph or "other")
    have = collections.Counter(ev.get("name", "") for ev, _ in group)
    seen: dict = collections.Counter()
    rows = []
    for ev, _ in sorted(group, key=lambda p: float(p[0].get("ts", 0.0))):
        name = ev.get("name", "")
        phs = want.get(name, ())
        if phs and len(set(phs)) == 1:
            ph = phs[0]
        elif phs and have[name] == len(phs):
            ph = phs[seen[name]]
            seen[name] += 1
        else:
            ph = "unattributed"
        rows.append((id(ev), ph))
    by_id = dict(rows)
    return [by_id[id(ev)] for ev, _ in group]


# --------------------------------------------------------------------------
# the fold
# --------------------------------------------------------------------------

def _empty_rows() -> dict:
    return {k: {"time_us": 0.0, "events": 0} for k in PHASES + RESIDUAL_ROWS}


def fold_events(events: list, graph_maps: Optional[dict] = None) -> dict:
    """Fold one capture's events into the per-phase ledger (module
    docstring): ``{"mode": "device"|"cpu", "phases": {row: {time_us,
    events, frac}}, "total_device_us", "busy_us", "wall_us",
    "matched_events", "replays", "replays_mapped", "replays_short"}``:
    ``total_device_us`` the events' summed time (the rows' total),
    ``busy_us`` the time at least one ran, ``wall_us`` from the first
    event's start to the last one's end, ``replays_short`` the replays
    with fewer device events than their program's fullest (records the
    profiler lost)."""
    device = _device_mode(events)
    rows = _empty_rows()
    maps = dict(graph_maps or {})
    replays = mapped = short = 0
    if device:
        for prog, entries in warmup_maps(events).items():
            maps.setdefault(prog, entries)
        # a stream runs its kernels one after another: a device event's
        # duration is its own time (no nesting to subtract)
        pairs = [(ev, float(ev.get("dur", 0.0))) for ev in events
                 if ev.get("ph") == "X" and ev.get("cat") in _DEVICE_CATS]
        phases = _Ranges(events, _is_phase)
        programs = _Ranges(events, lambda n: n.startswith(REPLAY_RANGE))
        launches = _launches(events)
        groups: dict = collections.defaultdict(list)
        for ev, us in pairs:
            corr = (ev.get("args") or {}).get("correlation")
            launch = launches.get(corr)
            if launch is None:
                key = "unattributed"
            elif _is_graph_launch(launch[1]):
                groups[corr].append((ev, us))
                continue
            else:
                key = phases.innermost(launch[0]) or "other"
            rows[key]["time_us"] += us
            rows[key]["events"] += 1
        sizes: dict = collections.defaultdict(list)
        for corr, group in groups.items():
            ts, _, thread = launches[corr]
            prog = programs.innermost(ts, thread)
            entries = (maps.get(prog[len(REPLAY_RANGE):])
                       if prog is not None else None)
            replays += 1
            mapped += bool(entries)
            sizes[prog].append(len(group))
            for (ev, us), key in zip(group, _place_replay(group, entries)):
                rows[key]["time_us"] += us
                rows[key]["events"] += 1
        # replays of one graph launch the same kernels: one with fewer
        # device events than its program's fullest lost records
        short = sum(n < max(ns) for ns in sizes.values() for n in ns)
    else:
        pairs = self_times([ev for ev in events if ev.get("ph") == "X"
                            and ev.get("cat") == _CPU_CAT])
        phases = _Ranges(events, _is_phase)
        for ev, us in pairs:
            key = phases.innermost(float(ev.get("ts", 0.0)),
                                   (ev.get("pid", 0), ev.get("tid", 0)))
            key = key or "other"
            rows[key]["time_us"] += us
            rows[key]["events"] += 1
    total = sum(r["time_us"] for r in rows.values())
    for r in rows.values():
        r["frac"] = (r["time_us"] / total) if total else 0.0
    spans = sorted((float(ev.get("ts", 0.0)),
                    float(ev.get("ts", 0.0)) + float(ev.get("dur", 0.0)))
                   for ev, _ in pairs)
    lo = spans[0][0] if spans else 0.0
    hi = max((b for _, b in spans), default=0.0)
    return {"mode": "device" if device else "cpu", "phases": rows,
            "total_device_us": total, "busy_us": _union_us(spans),
            "wall_us": max(hi - lo, 0.0), "matched_events": len(pairs),
            "replays": replays, "replays_mapped": mapped,
            "replays_short": short}


def _union_us(spans: list) -> float:
    """The time covered by at least one of the sorted (start, end)
    intervals."""
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def fold_device_phases(events: list) -> dict:
    """The eager rule's fold in milliseconds: ``{"phases_ms": {phase: ms,
    "other": ms, "unattributed": ms}, "busy_ms": total}`` (the ranges'
    rule only: a graph replay's kernels land in ``unattributed`` without
    a map)."""
    fold = fold_events(events)
    return {"phases_ms": {k: r["time_us"] / 1e3
                          for k, r in fold["phases"].items()},
            "busy_ms": fold["total_device_us"] / 1e3}


def fold_capture(profile_dir: str, strict: bool = False) -> Optional[dict]:
    """Fold a profile dir (capture, anchor, graph maps) into the device
    report: ``{"trace", "anchor", "programs": [ledger]}`` with one ledger
    (``fold_events``) and an empty ``collectives``. None when there is no
    capture, when the capture is torn (a run killed mid-write), or when
    the anchor names a ``cuda`` device and the capture holds no device
    event (the kernels' records were lost: its host ops are not device
    time); with ``strict`` the last two raise ``ValueError``."""
    path = find_capture(profile_dir)
    if path is None:
        return None
    try:
        events, _ = load_trace(path)
    except (OSError, ValueError, EOFError):
        if strict:
            raise
        return None
    anchor = load_anchor(profile_dir)
    row = fold_events(events, load_graph_maps(profile_dir))
    if (str((anchor or {}).get("device", "")).startswith("cuda")
            and row["mode"] != "device"):
        if strict:
            raise ValueError(f"{path}: a cuda run's capture holds no "
                             f"device event")
        return None
    row["module"] = "window"
    row["collectives"] = {}
    return {"trace": path, "anchor": anchor, "programs": [row]}


def device_status_block(fold: dict) -> Optional[dict]:
    """The heartbeat's ``device`` block of a folded capture (the
    reference's keys): the window's phase fractions, decode share, the
    attributed share and the achieved FLOP rate, None unless a program
    carries its ``flops_per_step``."""
    programs = (fold or {}).get("programs") or []
    if not programs:
        return None
    totals = {k: 0.0 for k in PHASES + RESIDUAL_ROWS}
    total_us = 0.0
    flops = 0.0
    for row in programs:
        for k, r in row.get("phases", {}).items():
            totals[k] = totals.get(k, 0.0) + float(r.get("time_us", 0.0))
        total_us += float(row.get("total_device_us", 0.0))
        if isinstance(row.get("flops_per_step"), (int, float)):
            flops += float(row["flops_per_step"])
    anchor = fold.get("anchor") or {}
    steps = anchor.get("steps_profiled")
    block = {
        "profiled_steps": steps,
        "total_device_us": round(total_us, 1),
        "phase_fracs": {k: (round(v / total_us, 4) if total_us else 0.0)
                        for k, v in totals.items()},
        "decode_share": (round(totals["draco_decode"] / total_us, 4)
                         if total_us else 0.0),
        "attributed_frac": (round(1.0 - totals["unattributed"] / total_us, 4)
                            if total_us else 0.0),
        "achieved_flops_per_s": None,
        "achieved_flops_frac": None,
    }
    if flops and steps and total_us > 0:
        block["achieved_flops_per_s"] = flops * steps / (total_us / 1e6)
    return block


# --------------------------------------------------------------------------
# merged host + device timeline
# --------------------------------------------------------------------------

# pid offset of the re-emitted device lanes (the host tracer keeps its pid)
DEVICE_PID_BASE = 1 << 20


def _event_span(events: list) -> "tuple[Optional[float], Optional[float]]":
    lo, hi = None, None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        ts = float(ev.get("ts", 0.0))
        end = ts + float(ev.get("dur", 0.0))
        lo = ts if lo is None else min(lo, ts)
        hi = end if hi is None else max(hi, end)
    return lo, hi


def device_time_origin(events: list) -> float:
    """The capture's time origin (µs): its earliest complete event (a
    torch.profiler trace has no ``start_trace`` frame to anchor on)."""
    lo, _ = _event_span(events)
    return lo if lo is not None else 0.0


def merge_timeline(host_events: list, device_events: list,
                   anchor: Optional[dict] = None,
                   max_device_events: int = 0) -> dict:
    """One Perfetto-loadable payload: the host tracer's lanes plus the
    capture's lanes on the host tracer's clock.

    The shift pairs the capture's last event end with the anchor's
    ``drained_tracer_ts_us`` (the device was idle at the drain, so its
    last event ended then), else its first event with ``tracer_ts_us``
    (early by at most the lead-in before the first dispatch); with no
    anchor the capture keeps its own origin at 0. Capture events move to
    ``pid + DEVICE_PID_BASE`` with ``cat`` kept and ``args.lane =
    "device"``. ``max_device_events`` > 0 keeps the longest that many
    complete events, and the count dropped is carried in
    ``mergedTimeline`` (never a silent cap)."""
    tracer_ts = (anchor or {}).get("tracer_ts_us")
    drained_ts = (anchor or {}).get("drained_tracer_ts_us")
    _, hi = _event_span(device_events)
    if drained_ts is not None and hi is not None:
        kind, offset = "drain", drained_ts - hi
    elif tracer_ts is not None:
        kind = "start_stamp"
        offset = tracer_ts - device_time_origin(device_events)
    else:
        kind, offset = None, -device_time_origin(device_events)
    dropped = 0
    if max_device_events > 0:
        xs = [ev for ev in device_events if ev.get("ph") == "X"]
        if len(xs) > max_device_events:
            xs.sort(key=lambda e: -float(e.get("dur", 0.0)))
            keep = set(map(id, xs[:max_device_events]))
            dropped = len(xs) - max_device_events
            device_events = [ev for ev in device_events
                             if ev.get("ph") != "X" or id(ev) in keep]
    merged = list(host_events)
    pids = set()
    for ev in device_events:
        ph = ev.get("ph")
        if ph not in ("X", "M", "C", "i"):
            continue
        out = dict(ev)
        try:
            pid = int(ev.get("pid", 0)) + DEVICE_PID_BASE
        except (TypeError, ValueError):
            pid = DEVICE_PID_BASE
        out["pid"] = pid
        if ph != "M":
            out["ts"] = round(float(ev.get("ts", 0.0)) + offset, 3)
            out["args"] = dict(ev.get("args") or {}, lane="device")
        elif ev.get("name") == "process_name":
            out["args"] = {"name": "device: "
                           + str((ev.get("args") or {}).get("name", ""))}
        merged.append(out)
        pids.add(pid)
    for pid in sorted(pids):
        merged.append({"name": "process_sort_index", "ph": "M", "pid": pid,
                       "args": {"sort_index": pid}})
    return {"traceEvents": merged, "displayTimeUnit": "ms",
            "mergedTimeline": {"device_offset_us": round(offset, 3),
                               "anchored": kind is not None,
                               "anchor_kind": kind,
                               "droppedDeviceEvents": dropped}}
