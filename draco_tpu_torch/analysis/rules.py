"""The rules run against one step of every registered program
(draco_tpu/analysis/rules.py, the rules that mean something on one device).

:func:`inspect_step` runs one step of a :class:`~.registry.Program` —
without the loop's metric reads — and records what it did: every aten op
the dispatcher saw (a ``TorchDispatchMode``; the ``ctypes`` kernels are
outside the dispatcher and queue no host work of their own), the storage of
each state tensor before and after, and on the card the synchronising calls
(``torch.cuda.set_sync_debug_mode("warn")``), the host-to-device copies
(the profiler's HtoD memcpy events) and the peak allocated memory. The
rules read that record against the program's manifest:

  dtype           no float64 or complex128 anywhere; every op's tensors of
                  the manifest's types; on the bf16 route every bf16 -> f32
                  promotion at a whitelisted op; a narrow leg's wire type
                  present
  host_traffic    the step's synchronising calls equal the manifest's count
                  (on the card the sync-debug warnings; on the CPU the ops
                  that would synchronise on a card: a scalar read, nonzero,
                  a boolean mask's selection, unique, equal); a chunked
                  program's flush makes the manifest's device-to-host
                  fetches (the flush's own count, and on the card the
                  device-to-host copies the dispatcher saw)
  in_place        every state tensor keeps its storage (the counterpart of
                  the reference's donation rule)
  collectives     calls into torch.distributed by kind equal the manifest
  constant_bloat  (card) host-to-device bytes at most the manifest's: the
                  larger of the profiler's HtoD memcpy events and the
                  host-to-device copies the dispatcher saw
  memory_budget   (card) the memory the step allocates above what was live
                  when it began (``max_memory_allocated`` after a reset,
                  less ``memory_allocated`` at the start), with a chunked
                  program's graph pool, at most the manifest's; the row
                  also carries the absolute peak (the per-leg memory
                  ledger) and the peak in the sizes the step requested,
                  before the allocator rounds them to its blocks

The sharding rules of the reference (sharding_contract, collective_axes,
replication_leaks) wait for the port's sequence and tensor parallel routes.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
import warnings

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

RULE_NAMES = ("dtype", "host_traffic", "in_place", "collectives",
              "constant_bloat", "memory_budget")
_WIDE = (torch.float64, torch.complex128)
# ops whose result the host must wait for on a card
_SYNC_OPS = frozenset({"_local_scalar_dense", "nonzero", "masked_select",
                       "equal", "is_nonzero", "unique", "_unique",
                       "_unique2", "unique_consecutive", "unique_dim"})
# torch.distributed's ops in the dispatcher -> the manifest's kinds
_C10D = {"allreduce_": "all_reduce", "allreduce_coalesced_": "all_reduce",
         "all_reduce": "all_reduce", "allgather_": "all_gather",
         "_allgather_base_": "all_gather", "all_gather_into_tensor":
             "all_gather", "alltoall_": "all_to_all",
         "alltoall_base_": "all_to_all", "all_to_all_single": "all_to_all",
         "broadcast_": "broadcast", "broadcast": "broadcast",
         "reduce_scatter_": "reduce_scatter",
         "_reduce_scatter_base_": "reduce_scatter",
         "reduce_scatter_tensor": "reduce_scatter", "send": "send",
         "recv_": "recv", "barrier": "barrier"}


class _Recorder(TorchDispatchMode):
    """Records each op's name, its tensors' types, bf16 -> f32 promotion
    sites, would-be syncs and collectives."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.dtypes = collections.Counter()
        self.promotions = collections.Counter()
        self.syncs = collections.Counter()
        self.collectives = collections.Counter()
        self.h2d_bytes = self.h2d_copies = self.d2h_copies = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ns = func.namespace
        name = func.__name__.split(".")[0]
        self.ops += 1
        if ns in ("c10d", "_c10d_functional"):
            self.collectives[_C10D.get(name, name)] += 1
        ins = [a for a in tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        outs = [a for a in tree_leaves(out) if isinstance(a, torch.Tensor)]
        in_dt = {a.dtype for a in ins}
        out_dt = {a.dtype for a in outs}
        for dt in in_dt | out_dt:
            self.dtypes[dt] += 1
        if torch.bfloat16 in in_dt and torch.float32 in out_dt:
            self.promotions[name] += 1
        if name in ("_to_copy", "copy_") and ins and outs:
            src = ins[-1 if name == "copy_" else 0]
            way = (src.device.type, outs[0].device.type)
            if way == ("cpu", "cuda"):
                self.h2d_bytes += src.numel() * src.element_size()
                self.h2d_copies += 1
            elif way == ("cuda", "cpu"):
                self.d2h_copies += 1
        if name in _SYNC_OPS or (
                name in ("index", "index_put", "index_put_")
                and any(a.dtype == torch.bool for a in ins[1:])):
            self.syncs[name] += 1
        return out


def _h2d(trace: dict) -> tuple:
    """(bytes, copies) of the host-to-device memcpy events of a profiler
    trace (Chrome format, as ``export_chrome_trace`` writes it)."""
    total = count = 0
    for ev in trace.get("traceEvents", []):
        if ev.get("cat") == "gpu_memcpy" and "HtoD" in ev.get("name", ""):
            total += int(ev.get("args", {}).get("bytes", 0))
            count += 1
    return total, count


def export_trace(prof) -> dict:
    """The profiler's Chrome trace as a dict (through a temporary file in
    the build directory)."""
    from draco_tpu_torch import _build

    scratch = _build.BUILD_DIR / "audit"
    scratch.mkdir(parents=True, exist_ok=True)
    fd, path = tempfile.mkstemp(suffix=".json", dir=scratch)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            return json.load(fh)
    finally:
        os.unlink(path)


def inspect_step(program) -> dict:
    """Run one step of ``program`` under the recorders; returns the record
    the rules read."""
    dev = program.device
    before = {k: v.untyped_storage().data_ptr()
              for k, v in program.state().items()}
    rec = _Recorder()
    out = {"device": str(dev)}
    if dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        asked = torch.cuda.memory_stats(dev)["requested_bytes.all.current"]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    with rec:
                        program.step()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize(dev)
        # the step's own peak: what it held above the memory live when it
        # began (the state, and whatever else the process keeps), beside
        # the absolute peak
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        out["step_peak_bytes"] = out["peak_bytes"] - base
        # the same peak in the sizes the step asked for, before the
        # allocator rounds them to its blocks
        out["step_requested_peak_bytes"] = torch.cuda.memory_stats(dev)[
            "requested_bytes.all.peak"] - asked
        # torch's sync-debug warning; its one-time notice that the mode is
        # a prototype is not a sync
        sync_msgs = [str(w.message) for w in caught
                     if "called a synchronizing" in str(w.message)]
        out["syncs"] = len(sync_msgs)
        out["sync_sites"] = sync_msgs[:4]
        out["trace"] = export_trace(prof)
        # the copies the dispatcher saw and the memcpys the profiler saw:
        # the larger of each (the profiler can miss a session's first
        # copies; the dispatcher does not see a copy made outside it)
        prof_bytes, prof_copies = _h2d(out["trace"])
        out["h2d_profiler"] = {"bytes": prof_bytes, "copies": prof_copies}
        out["h2d_dispatcher"] = {"bytes": rec.h2d_bytes,
                                 "copies": rec.h2d_copies}
        out["h2d_bytes"] = max(prof_bytes, rec.h2d_bytes)
        out["h2d_copies"] = max(prof_copies, rec.h2d_copies)
    else:
        with rec:
            program.step()
        out["syncs"] = sum(rec.syncs.values())
        out["sync_sites"] = sorted(rec.syncs)
    after = {k: v.untyped_storage().data_ptr()
             for k, v in program.state().items()}
    if program.pool_bytes is not None and dev.type == "cuda":
        out["pool_bytes"] = program.pool_bytes()
        out["step_peak_bytes"] += out["pool_bytes"]
        out["step_requested_peak_bytes"] += out["pool_bytes"]
    if program.flush is not None:
        out["flush"] = inspect_flush(program)
    out["ops"] = rec.ops
    out["dtypes"] = rec.dtypes
    out["promotions"] = rec.promotions
    out["would_sync_ops"] = dict(rec.syncs)
    out["collectives"] = dict(rec.collectives)
    out["state"] = {"tensors": len(before),
                    "moved": sorted(k for k in before
                                    if after.get(k) != before[k]),
                    "added": sorted(set(after) - set(before))}
    return out


def inspect_flush(program) -> dict:
    """A chunked program's flush under the recorder (and on the card the
    sync-debug mode): its fetches, syncs and device-to-host copies."""
    rec = _Recorder()
    if program.device.type != "cuda":
        with rec:
            fetches = program.flush()
        return {"fetches": fetches, "syncs": sum(rec.syncs.values()),
                "d2h_copies": rec.d2h_copies}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with rec:
                fetches = program.flush()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return {"fetches": fetches, "d2h_copies": rec.d2h_copies,
            "syncs": sum("called a synchronizing" in str(w.message)
                         for w in caught)}


def _names(dtypes) -> list:
    return sorted(str(d).replace("torch.", "") for d in dtypes)


def rule_dtype(rec, m) -> dict:
    seen = set(rec["dtypes"])
    res = {"dtypes": _names(seen)}
    wide = seen & set(_WIDE)
    if wide:
        return {"ok": False, **res,
                "error": f"{_names(wide)} in the step: double precision has "
                         f"no place on the card's path"}
    extra = seen - m.allowed_dtypes
    if extra:
        return {"ok": False, **res,
                "error": f"types {_names(extra)} outside the manifest's "
                         f"{_names(m.allowed_dtypes)}"}
    promos = dict(rec["promotions"])
    res["bf16_promotions"] = promos
    rogue = set(promos) - set(m.bf16_promotions)
    if rogue:
        return {"ok": False, **res,
                "error": f"bf16 -> f32 promotion at {sorted(rogue)}; only "
                         f"{list(m.bf16_promotions)} may promote"}
    missing = m.required_dtypes - seen
    if missing:
        return {"ok": False, **res,
                "error": f"the manifest's wire type {_names(missing)} never "
                         f"appears: a narrow leg whose payload stayed wide"}
    return {"ok": True, **res}


def rule_host_traffic(rec, m) -> dict:
    res = {"syncs": rec["syncs"], "expected": m.host_syncs,
           "sites": rec["sync_sites"]}
    if rec["syncs"] != m.host_syncs:
        return {"ok": False, **res,
                "error": f"{rec['syncs']} synchronising calls in one step, "
                         f"the manifest says {m.host_syncs}: the host waits "
                         f"for the card inside the step"}
    if m.flush_fetches is not None:
        fl = rec.get("flush", {})
        res["flush"] = fl
        d2h = (fl.get("d2h_copies") if rec["device"].startswith("cuda")
               else fl.get("fetches"))
        if fl.get("fetches") != m.flush_fetches or d2h != m.flush_fetches:
            return {"ok": False, **res,
                    "error": f"the flush fetched {fl.get('fetches')} times "
                             f"({d2h} device-to-host copies), the manifest "
                             f"says {m.flush_fetches}"}
    return {"ok": True, **res}


def rule_in_place(rec, m) -> dict:
    st = rec["state"]
    res = {"state_tensors": st["tensors"], "moved": st["moved"][:8]}
    if not m.in_place:
        return {"ok": True, "skipped": True,
                "reason": "manifest.in_place is False"}
    if st["moved"] or st["added"]:
        return {"ok": False, **res, "added": st["added"][:8],
                "error": f"{len(st['moved'])} state tensors changed storage "
                         f"and {len(st['added'])} appeared in one step: the "
                         f"carry is rebuilt, not updated in place"}
    return {"ok": True, **res}


def rule_collectives(rec, m) -> dict:
    if m.collectives is None:
        return {"ok": True, "skipped": True,
                "reason": "manifest.collectives is None"}
    seen = rec["collectives"]
    kinds = set(seen) | set(m.collectives)
    diff = {k: (m.collectives.get(k, 0), seen.get(k, 0)) for k in kinds
            if m.collectives.get(k, 0) != seen.get(k, 0)}
    if diff:
        return {"ok": False, "observed": seen,
                "error": f"collectives (kind: expected, observed) {diff}"}
    return {"ok": True, "observed": seen}


def _card_only(rec):
    if rec["device"].startswith("cuda"):
        return None
    return {"ok": True, "skipped": True, "reason": "a card-side rule"}


def rule_constant_bloat(rec, m) -> dict:
    skip = _card_only(rec)
    if skip:
        return skip
    res = {"h2d_bytes": rec["h2d_bytes"], "h2d_copies": rec["h2d_copies"],
           "profiler": rec["h2d_profiler"],
           "dispatcher": rec["h2d_dispatcher"],
           "budget": m.h2d_bytes}
    if rec["h2d_bytes"] > m.h2d_bytes:
        return {"ok": False, **res,
                "error": f"{rec['h2d_bytes']} bytes copied to the card in one "
                         f"step, over the manifest's {m.h2d_bytes} "
                         f"({m.uploads}): a host constant shipped every step"}
    return {"ok": True, **res}


def rule_memory_budget(rec, m) -> dict:
    skip = _card_only(rec)
    if skip:
        return skip
    res = {"step_peak_bytes": rec["step_peak_bytes"],
           "step_requested_peak_bytes": rec.get("step_requested_peak_bytes"),
           "peak_bytes": rec["peak_bytes"], "budget": m.max_peak_bytes}
    if m.max_peak_bytes is None:
        return {"ok": True, "skipped": True,
                "reason": "manifest.max_peak_bytes is None", **res}
    if rec["step_peak_bytes"] > m.max_peak_bytes:
        return {"ok": False, **res,
                "error": f"the step allocated up to {rec['step_peak_bytes']} "
                         f"bytes above its starting memory, over the "
                         f"manifest's {m.max_peak_bytes}"}
    return {"ok": True, **res}


_RULES = {"dtype": rule_dtype, "host_traffic": rule_host_traffic,
          "in_place": rule_in_place, "collectives": rule_collectives,
          "constant_bloat": rule_constant_bloat,
          "memory_budget": rule_memory_budget}


def lint_record(rec, manifest) -> dict:
    """The rules on one step's record: the report row."""
    rules = {name: _RULES[name](rec, manifest) for name in RULE_NAMES}
    failed = [n for n in RULE_NAMES if not rules[n]["ok"]]
    return {"ok": not failed, "failed_rules": failed, "rules": rules,
            "device": rec["device"], "ops": rec["ops"]}


def twin_failures(row: dict, twin: dict, extra_h2d: int = 0) -> list:
    """What a guarded leg's lint row does beyond its twin's (the same leg
    without the guard and the fault plan): more synchronising calls, more
    device-to-host fetches a flush, or other host-to-device bytes than the
    twin's plus ``extra_h2d`` (the approx certificate's staged bound; the
    plan's own tensors go to the card at setup). [] when none."""
    out = []
    a, b = row["rules"], twin["rules"]
    if a["host_traffic"]["syncs"] > b["host_traffic"]["syncs"]:
        out.append(f"syncs {a['host_traffic']['syncs']} > the twin's "
                   f"{b['host_traffic']['syncs']}")
    fa = a["host_traffic"].get("flush", {}).get("fetches")
    fb = b["host_traffic"].get("flush", {}).get("fetches")
    if fa is not None and fb is not None and fa > fb:
        out.append(f"flush fetches {fa} > the twin's {fb}")
    ha = a["constant_bloat"].get("h2d_bytes")
    hb = b["constant_bloat"].get("h2d_bytes")
    if ha is not None and hb is not None and ha != hb + extra_h2d:
        out.append(f"h2d bytes {ha} != the twin's {hb} + {extra_h2d}")
    return out


def lint_program(program) -> "tuple[dict, dict]":
    """One inspected step of a built program: (row, record)."""
    rec = inspect_step(program)
    return lint_record(rec, program.manifest), rec
