"""The build and capture sentinel (draco_tpu/obs/compile_watch.py): every
compile of a run becomes an observable event, and one in steady state a
warning or an error.

On the port a compile is one of two events, each reported to this module's
dispatcher (:func:`report`) by the code that pays it, with its seconds:

* ``kernel_build``: a kernel library loaded into the process
  (``_build.library``), once a library a process, with ``nvcc_s`` when
  ``nvcc`` ran for it (``cached``: false) and 0 when its library was on disk
  already: the counterpart of the reference's lowering, which runs on every
  executable-cache miss, with the backend compile attached when it ran;
* ``graph_capture``: a CUDA graph captured by
  ``training/chunk_graph.StepGraph`` (its warm-up step and the capture),
  once a graph. A graph stages K steps; a remainder chunk of fewer steps
  replays it fewer times and captures nothing.

* **Ledger**: each event is one JSON line in ``<dir>/compiles.jsonl``
  (``time``, ``program``, ``n_for_program``, ``kind``, ``name``,
  ``seconds``, ``steady_recompile`` and the event's own fields) and a
  ``compile``-category event in ``trace.json`` (``obs/tracer.py``), on the
  lane of the dispatch that paid it.
* **Steady-state guard**: the loops label their dispatch windows
  (``with watch.expect("train_many", key=k): ...``, a thread-local label
  stack); an event inside a window belongs to that label. Each label may
  compile in ``warmup`` windows (default 1: the first dispatch of a
  program builds its kernels and captures its graph); an event after that
  is a steady recompile. ``guard="warn"`` warns (:class:`RetraceWarning`),
  ``guard="raise"`` raises :class:`RetraceError` at the dispatch site,
  after its ledger row is written. Events outside any window (an eval
  step, a setup) are recorded with ``program: null`` and never guarded.
  An autopilot regime dispatches under its own label
  (``train_many@<regime>``), so its first capture is its warm-up; a return
  to a regime replays the graph it captured then and compiles nothing.

The dispatcher is installed once for the process and fans each event out
to the watches started at that moment; it also keeps process totals
(:func:`global_stats`). Reporting reads no device and synchronises
nothing. At module level this imports the standard library only.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import warnings
import weakref
from typing import Optional

GUARD_MODES = ("off", "warn", "raise")
KINDS = ("kernel_build", "graph_capture")


class RetraceError(RuntimeError):
    """A labelled program compiled in steady state under guard="raise"."""


class RetraceWarning(UserWarning):
    """A labelled program compiled in steady state under guard="warn"."""


# ---------------------------------------------------------------------------
# the process's dispatcher
# ---------------------------------------------------------------------------

_LOCK = threading.RLock()
# the watches receiving events, held weakly: a loop dropped without its
# close() stops receiving when it is collected
_ACTIVE: "weakref.WeakSet[CompileWatch]" = weakref.WeakSet()
_GLOBAL = {"builds": 0, "kernel_builds": 0, "graph_captures": 0,
           "compile_s": 0.0, "nvcc_s": 0.0}


def report(kind: str, name: str, seconds: float, **info) -> None:
    """One compile event (``kind`` in :data:`KINDS`) of ``name`` that took
    ``seconds``; ``info`` rides its ledger row (``nvcc_s``, ``cached``).
    Raises :class:`RetraceError` when a started watch's guard says so."""
    if kind not in KINDS:
        raise ValueError(f"compile event kind must be one of {KINDS}, "
                         f"got {kind!r}")
    with _LOCK:
        _GLOBAL["builds"] += 1
        _GLOBAL[f"{kind}s"] += 1
        _GLOBAL["compile_s"] += float(seconds)
        _GLOBAL["nvcc_s"] += float(info.get("nvcc_s", 0.0) or 0.0)
        active = list(_ACTIVE)
    for w in active:
        w._on_build(kind, name, float(seconds), info)


def global_stats() -> dict:
    """The process's totals: ``builds`` (events), ``kernel_builds``,
    ``graph_captures``, ``compile_s`` and ``nvcc_s``."""
    with _LOCK:
        return dict(_GLOBAL)


# ---------------------------------------------------------------------------
# the run's watch
# ---------------------------------------------------------------------------

class CompileWatch:
    """One run's compile ledger and steady-state guard (module docstring).
    ``start()`` / ``stop()`` (or the context manager) bound the events it
    receives; an unstarted watch is inert."""

    def __init__(self, ledger_dir: Optional[str] = None, tracer=None,
                 warmup: int = 1, guard: str = "warn"):
        if guard not in GUARD_MODES:
            raise ValueError(f"guard must be one of {GUARD_MODES}, "
                             f"got {guard!r}")
        from draco_tpu_torch.obs.tracer import NULL_TRACER

        self.path = (os.path.join(ledger_dir, "compiles.jsonl")
                     if ledger_dir else None)
        self._tracer = tracer if tracer is not None else NULL_TRACER
        self.warmup = max(int(warmup), 0)
        self.guard = guard
        self.builds = 0
        self.compile_s = 0.0
        self.steady_recompiles = 0
        self.builds_by_program: dict = {}  # events per label
        self._compiled_windows: dict = {}  # label -> windows that compiled
        self._tls = threading.local()
        self._fh = None
        self._lock = threading.Lock()

    # ---- lifecycle -------------------------------------------------------
    def start(self) -> "CompileWatch":
        with _LOCK:
            _ACTIVE.add(self)
        return self

    def stop(self) -> None:
        with _LOCK:
            _ACTIVE.discard(self)
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self) -> "CompileWatch":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # ---- labelling -------------------------------------------------------
    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    @contextlib.contextmanager
    def expect(self, name: str, key=None):
        """Label this thread's dispatch window: events inside belong to
        ``name`` (``name[key]`` for a shape variant, the chunk's k)."""
        label = f"{name}[{key}]" if key is not None else name
        stack = self._stack()
        entry = [label, False]  # set when an event fires inside
        stack.append(entry)
        try:
            yield self
        finally:
            stack.pop()
            if entry[1]:
                with self._lock:
                    self._compiled_windows[label] = (
                        self._compiled_windows.get(label, 0) + 1)

    # ---- the dispatcher's sink -------------------------------------------
    def _on_build(self, kind: str, name: str, seconds: float,
                  info: dict) -> None:
        stack = self._stack()
        entry = stack[-1] if stack else None
        label = entry[0] if entry is not None else None
        with self._lock:
            self.builds += 1
            self.compile_s += seconds
            n = self.builds_by_program.get(label, 0) + 1
            if label is not None:
                self.builds_by_program[label] = n
            # steady iff `warmup` earlier windows of this label compiled:
            # this window's own earlier events (a first dispatch builds
            # several libraries, then captures) do not count
            steady = (label is not None
                      and self._compiled_windows.get(label, 0) >= self.warmup)
            if steady:
                self.steady_recompiles += 1
        if entry is not None:
            entry[1] = True
        row = {"time": time.time(), "program": label,
               "n_for_program": n if label is not None else None,
               "kind": kind, "name": name, "seconds": round(seconds, 6),
               "steady_recompile": steady, **info}
        self._emit(row)
        if not steady:
            return
        msg = (f"steady-state {kind} of labelled program {label!r} ({name}, "
               f"event #{n}, after {self._compiled_windows.get(label, 0)} "
               f"compiling dispatch windows, warmup={self.warmup}): the "
               f"program re-paid a compile mid-run, which the chunked loop "
               f"exists to pay once (obs/compile_watch.py)")
        if self.guard == "raise":
            raise RetraceError(msg)
        if self.guard == "warn":
            warnings.warn(msg, RetraceWarning, stacklevel=3)

    def _emit(self, row: dict) -> None:
        self._tracer.complete("compile", row["seconds"], "compile",
                              program=row["program"], kind=row["kind"],
                              name=row["name"],
                              steady_recompile=row["steady_recompile"])
        if self.path is None:
            return
        with self._lock:
            if self._fh is None:
                os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
                self._fh = open(self.path, "a")
            self._fh.write(json.dumps(row) + "\n")
            self._fh.flush()  # rare events: keep the ledger live

    # ---- surface ---------------------------------------------------------
    def snapshot(self) -> dict:
        """The heartbeat's extras: the run's compile events, their seconds
        and the steady recompiles (which must stay 0)."""
        with self._lock:
            return {"compiles": self.builds,
                    "compile_s": round(self.compile_s, 3),
                    "steady_recompiles": self.steady_recompiles}


def make_compile_watch(cfg, tracer=None, is_main: bool = True
                       ) -> CompileWatch:
    """The loops' watch, started: its ledger beside ``trace.json`` when
    tracing, else beside ``metrics.jsonl`` (none off the main process);
    guard and warmup from ``cfg``."""
    ledger_dir = (cfg.trace_dir or cfg.train_dir or None) if is_main else None
    return CompileWatch(ledger_dir=ledger_dir, tracer=tracer,
                        warmup=cfg.compile_warmup,
                        guard=cfg.compile_guard).start()
