"""Host-side span tracer emitting Chrome trace events
(draco_tpu/obs/tracer.py), and the steps' phase annotations.

The eager loops (``training/trainer.py``, ``parallel/token_loop.py``) time
their host phases — ``gather`` (the batch on the host), ``dispatch`` (the
step's work queued on the device), ``sync`` (the metric reads, which wait
for the device), ``flush`` (metrics.jsonl), ``eval`` — as spans written to
``trace_dir/trace.json`` in the Chrome trace event format (loadable in
``chrome://tracing`` or Perfetto); ``obs/trace_report.py`` folds them.

Inside a step, :func:`phase` marks the reference's device phases
(``draco_comp``, ``draco_encode``, ``draco_decode``, ``draco_update``, its
``jax.named_scope`` names): a host span on the active tracer and a
``torch.profiler.record_function`` range when the profiler is on, so a
profile can fold device time by phase. With no tracer active and no
profiler, :func:`phase` returns one shared no-op context manager.

* **No device fetches.** Spans read ``time.perf_counter`` only; nothing
  here touches a tensor.
* **Zero cost when disabled.** ``NULL_TRACER`` hands out one shared no-op
  context manager: no allocation, no clock read. Loops hold a tracer
  unconditionally and never test ``enabled``.
* **Thread-safe.** Events append under a lock with the emitting thread's
  id, one lane per thread.

Event kinds: ph="X" complete event (``ts``/``dur`` in microseconds), ph="M"
metadata (process/thread names).
"""

from __future__ import annotations

import contextvars
import json
import os
import threading
import time
from typing import Optional

import torch

PHASES = ("draco_comp", "draco_encode", "draco_decode", "draco_update")


class _NullSpan:
    """The shared no-op context manager of the disabled paths."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()

# the tracer a step's phases report to: set by SpanTracer.activate() for
# the length of one step, None otherwise
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "draco_tpu_torch_tracer", default=None)


class NullTracer:
    """Disabled tracer: every call is a no-op, ``span`` and ``activate``
    return one shared context manager (no allocation, no clock read)."""

    __slots__ = ()
    enabled = False

    def span(self, name: str, **args) -> _NullSpan:
        return _NULL_SPAN

    def activate(self) -> _NullSpan:
        return _NULL_SPAN

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


NULL_TRACER = NullTracer()


class _Span:
    """One live span: records ts on __enter__, appends the complete event
    on __exit__ (nesting falls out of wall-clock containment)."""

    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer: "SpanTracer", name: str, args: Optional[dict]):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        tr = self._tracer
        t1 = time.perf_counter()
        ev = {"name": self._name, "ph": "X",
              "ts": round((self._t0 - tr._t0) * 1e6, 3),
              "dur": round((t1 - self._t0) * 1e6, 3),
              "pid": tr._pid, "tid": threading.get_ident(), "cat": "host"}
        if self._args:
            ev["args"] = self._args
        tr._append(ev)
        return False


class _Activation:
    """Makes a tracer the one :func:`phase` reports to, for one step."""

    __slots__ = ("_tracer", "_token")

    def __init__(self, tracer: "SpanTracer"):
        self._tracer = tracer

    def __enter__(self):
        self._token = _ACTIVE.set(self._tracer)
        return self

    def __exit__(self, *exc):
        _ACTIVE.reset(self._token)
        return False


class SpanTracer:
    """Collects Chrome trace events in memory; ``flush()`` rewrites the
    JSON file atomically (a crash keeps the last flushed window),
    ``close()`` flushes.

    The buffer is bounded: past ``max_events`` the oldest half of the
    non-metadata events is dropped (the lane labels are kept) and the
    written payload carries a top-level ``droppedEvents`` count."""

    enabled = True

    def __init__(self, path: str, process_name: str = "draco_tpu_torch host",
                 max_events: int = 100_000):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._pid = os.getpid()
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._max_events = max(int(max_events), 16)
        self._dropped = 0
        self._events: list = [
            {"name": "process_name", "ph": "M", "pid": self._pid, "tid": 0,
             "args": {"name": process_name}},
        ]
        self.name_thread("main")

    def _append(self, ev: dict) -> None:
        with self._lock:
            self._events.append(ev)
            if len(self._events) > self._max_events:
                meta = [e for e in self._events if e.get("ph") == "M"]
                rest = [e for e in self._events if e.get("ph") != "M"]
                keep = len(rest) // 2
                self._dropped += len(rest) - keep
                self._events = meta + rest[-keep:]

    def span(self, name: str, **args) -> _Span:
        """Context manager timing one host phase on the calling thread."""
        return _Span(self, name, args or None)

    def activate(self) -> _Activation:
        """Context manager under which :func:`phase` reports to this
        tracer (a loop wraps each step's dispatch in it)."""
        return _Activation(self)

    def name_thread(self, label: str) -> None:
        """Label the calling thread's lane."""
        self._append({"name": "thread_name", "ph": "M", "pid": self._pid,
                      "tid": threading.get_ident(), "args": {"name": label}})

    def flush(self) -> None:
        """Rewrite ``path`` with everything collected so far (tmp + rename,
        so a reader never sees a half-written file)."""
        with self._lock:
            events = list(self._events)
            dropped = self._dropped
        payload = {"traceEvents": events, "displayTimeUnit": "ms"}
        if dropped:
            payload["droppedEvents"] = dropped
        tmp = self.path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(payload, fh)
        os.replace(tmp, self.path)

    def close(self) -> None:
        self.flush()


def make_tracer(trace_dir: Optional[str]):
    """A real tracer iff ``trace_dir`` is set, else the shared no-op
    singleton (callers never branch)."""
    if trace_dir:
        return SpanTracer(os.path.join(trace_dir, "trace.json"))
    return NULL_TRACER


class _Phase:
    """A device phase: a host span on the active tracer and/or a profiler
    range."""

    __slots__ = ("_span", "_range")

    def __init__(self, name: str, tracer, profiling: bool):
        self._span = tracer.span(name) if tracer is not None else None
        self._range = (torch.profiler.record_function(name) if profiling
                       else None)

    def __enter__(self):
        if self._span is not None:
            self._span.__enter__()
        if self._range is not None:
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
        if self._span is not None:
            self._span.__exit__(*exc)
        return False


def phase(name: str):
    """The step's phase ``name`` (one of :data:`PHASES`): a span on the
    tracer the loop activated and a profiler range while the profiler runs;
    otherwise the shared no-op context manager, so the default step pays
    one context-variable read and one flag read."""
    tracer = _ACTIVE.get()
    profiling = torch.autograd._profiler_enabled()
    if tracer is None and not profiling:
        return _NULL_SPAN
    return _Phase(name, tracer, profiling)
