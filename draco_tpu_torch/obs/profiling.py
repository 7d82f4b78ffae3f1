"""The profiler window the training loops share
(draco_tpu/obs/profiling.py): one ``torch.profiler`` capture over steps
[profile_steps[0], profile_steps[1]), snapped outward to whole work units,
with the wall-clock anchor the merged host + device timeline needs.

* ``maybe_start(step_end, first_step)`` before a unit (a step, or a chunk
  whose steps are [first_step, step_end]) starts the capture at the first
  unit reaching ``profile_steps[0]``, once a run, after a drain: the
  capture holds no tail of an earlier unit, whose runtime calls it would
  lack.
* ``maybe_stop(step_end)`` after the unit stops it once ``step_end >=
  profile_steps[1] - 1``, after a drain: ``torch.cuda.synchronize`` on the
  card, so the capture holds the device's execution of every profiled step
  and not the dispatch tail. A drain that raises (a device error) is
  swallowed: the loops call ``stop()`` from their exit paths, where raising
  would mask the run's own exception; a truncated capture is then the
  honest result.
* ``stop()`` in the loop's exit path: the stop of a run that ended inside
  the window.

The capture is ``torch.profiler.profile`` with the CPU activity and, on a
``cuda`` device, the CUDA activity (a card whose profiler offers no CUDA
activity raises: a cuda run never profiles its host only), started and
stopped by hand, with ``record_shapes``, ``with_stack`` and
``profile_memory`` off: the host half of the timeline is the span tracer's
(``obs/tracer.py``), as the reference turns its Python tracer off. The
step's ``phase()`` ranges are recorded while the profiler runs.

What lands under ``profile_dir`` (read by ``obs/device_attr.py``):

  plugins/profile/<YYYY_MM_DD_HH_MM_SS>/<host>.trace.json.gz
                          the Chrome trace (``export_chrome_trace``)
  host_anchor.json        schema, profile_steps, first_step,
                          started_unix / started_perf / tracer_ts_us (after
                          the profiler started), drained_unix /
                          drained_perf / drained_tracer_ts_us (the device
                          idle, before the profiler stops),
                          stopped_unix / stopped_perf, last_step,
                          steps_profiled, device, trace, export_s (the
                          seconds the trace took to write)
  device_graph_map.json   the kernel maps of graphs captured while the
                          window was open but not running
                          (``training/chunk_graph.py``)

After a stop the window calls ``on_stop(profile_dir)`` (the loops pass the
heartbeat's ``observe_device``, which folds the capture into status.json's
``device`` block); what it raises is swallowed. Only one window runs at a
time in a process: starting a second, or starting one while another
profiler session runs, raises. While a window is open (made and not yet
stopped), :func:`open_window` returns it: ``StepGraph`` then profiles its
warm-up step to map its graph's kernels to phases.

The disabled path is the shared no-op ``NULL_PROFILER_WINDOW``: loops hold
a window unconditionally and never branch.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import Optional

from draco_tpu_torch.obs.device_attr import ANCHOR_FILE
from draco_tpu_torch.obs.tracer import NULL_TRACER

__all__ = ["ANCHOR_FILE", "NULL_PROFILER_WINDOW", "NullProfilerWindow",
           "ProfilerWindow", "open_window", "profiler_window"]

_LOCK = threading.Lock()
_OPEN: Optional["ProfilerWindow"] = None  # made and not yet stopped
_RUNNING: Optional["ProfilerWindow"] = None  # capturing now


def open_window() -> Optional["ProfilerWindow"]:
    """The window made and not yet stopped in this process, or None."""
    return _OPEN


class NullProfilerWindow:
    """The disabled window: every call is a no-op."""

    __slots__ = ()
    active = False
    profiled = False

    def maybe_start(self, step_end: int, first_step=None) -> None:
        pass

    def maybe_stop(self, step_end: int) -> None:
        pass

    def stop(self) -> None:
        pass


NULL_PROFILER_WINDOW = NullProfilerWindow()


class ProfilerWindow:
    """One capture over steps [profile_steps[0], profile_steps[1]), snapped
    outward to whole units by the caller's ``step_end`` (module
    docstring)."""

    def __init__(self, profile_dir: str, profile_steps: tuple = (3, 8),
                 tracer=NULL_TRACER, on_stop=None, device=None):
        global _OPEN
        import torch

        self.dir = profile_dir
        self.steps = tuple(int(s) for s in profile_steps)
        self.tracer = tracer
        self.device = torch.device(device if device is not None else "cpu")
        self.active = False
        self.profiled = False
        self.trace_path: Optional[str] = None
        self._prof = None
        self._anchor: dict = {}
        self._first: Optional[int] = None
        self._last_end: Optional[int] = None
        self._on_stop = on_stop
        with _LOCK:
            if _OPEN is None:
                _OPEN = self

    def _activities(self) -> list:
        from torch.profiler import ProfilerActivity, supported_activities

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            if ProfilerActivity.CUDA not in supported_activities():
                raise RuntimeError(
                    "profiler_window: this torch's profiler offers no CUDA "
                    "activity, so a cuda run's window cannot capture the "
                    "card")
            acts.append(ProfilerActivity.CUDA)
        return acts

    def maybe_start(self, step_end: int, first_step=None) -> None:
        """``first_step``: the unit's first step (a chunk's start): the
        capture snaps outward to whole chunks, so the profiled steps are
        [first_step, the last unit's end]."""
        global _RUNNING
        if self.active or self.profiled or step_end < self.steps[0]:
            return
        import torch
        from torch.profiler import profile

        with _LOCK:
            if _RUNNING is not None or torch.autograd._profiler_enabled():
                raise RuntimeError(
                    "profiler session already active: only one "
                    "profiler_window may run at a time")
            _RUNNING = self
        try:
            os.makedirs(self.dir, exist_ok=True)
            # the card idle first: no tail of an earlier unit's kernels,
            # whose runtime calls precede the capture, lands in it
            self._drain()
            self._prof = profile(activities=self._activities(),
                                 record_shapes=False, with_stack=False,
                                 profile_memory=False)
            self._prof.start()
        except BaseException:
            with _LOCK:
                _RUNNING = None
            self._prof = None
            raise
        self._first = int(first_step if first_step is not None else step_end)
        self._anchor = {
            "schema": 1,
            "profile_steps": list(self.steps),
            "first_step": self._first,
            "device": str(self.device),
            "started_unix": time.time(),
            "started_perf": time.perf_counter(),
            "tracer_ts_us": self.tracer.now_us(),
        }
        self.active = True

    def maybe_stop(self, step_end: int) -> None:
        if not self.active:
            return
        self._last_end = int(step_end)  # the newest unit inside the window
        if step_end >= self.steps[1] - 1:
            self.stop()

    def _drain(self) -> None:
        if self.device.type != "cuda":
            return
        import torch

        try:
            torch.cuda.synchronize(self.device)
        except Exception:
            pass  # a device error must not mask the run's own exception

    def stop(self) -> None:
        """Drain, stop the capture, write the trace and the anchor, then
        ``on_stop``; closes the window (a no-op when it never started)."""
        global _OPEN, _RUNNING
        with _LOCK:
            if _OPEN is self:
                _OPEN = None
        if not self.active:
            return
        self._drain()
        # the device went idle here: the capture's last device event ends
        # at this host instant (the merge's anchor, device_attr)
        self._anchor.update(drained_unix=time.time(),
                            drained_perf=time.perf_counter(),
                            drained_tracer_ts_us=self.tracer.now_us())
        try:
            self._prof.stop()
        finally:
            self.active = False
            self.profiled = True
            with _LOCK:
                _RUNNING = None
        self._anchor.update(stopped_unix=time.time(),
                            stopped_perf=time.perf_counter(),
                            last_step=self._last_end)
        if self._last_end is not None and self._first is not None:
            self._anchor["steps_profiled"] = self._last_end - self._first + 1
        stamp = time.strftime("%Y_%m_%d_%H_%M_%S",
                              time.gmtime(self._anchor["started_unix"]))
        out_dir = os.path.join(self.dir, "plugins", "profile", stamp)
        os.makedirs(out_dir, exist_ok=True)
        self.trace_path = os.path.join(
            out_dir, f"{socket.gethostname()}.trace.json.gz")
        t0 = time.perf_counter()
        self._prof.export_chrome_trace(self.trace_path)
        self._anchor["export_s"] = time.perf_counter() - t0
        self._prof = None
        self._anchor["trace"] = os.path.relpath(self.trace_path, self.dir)
        tmp = os.path.join(self.dir, ANCHOR_FILE + ".tmp")
        try:
            with open(tmp, "w") as fh:
                json.dump(self._anchor, fh)
            os.replace(tmp, os.path.join(self.dir, ANCHOR_FILE))
        except OSError:
            pass  # the anchor is best-effort; the capture landed
        if self._on_stop is not None:
            try:
                self._on_stop(self.dir)
            except Exception:
                pass  # observation never takes the run down


def profiler_window(profile_dir: Optional[str], profile_steps: tuple = (3, 8),
                    enabled: bool = True, tracer=NULL_TRACER, on_stop=None,
                    device=None):
    """A window iff ``profile_dir`` is set (and ``enabled``), else the shared
    no-op singleton."""
    if profile_dir and enabled:
        return ProfilerWindow(profile_dir, profile_steps, tracer, on_stop,
                              device)
    return NULL_PROFILER_WINDOW
