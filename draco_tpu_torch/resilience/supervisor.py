"""Prefetch supervision, the checkpoint walk-back and the graceful stop
(draco_tpu/resilience/supervisor.py).

  SupervisedPrefetcher    a prefetcher whose ``get`` fails (an exception in
                          its worker, a stall) is abandoned and rebuilt,
                          after an exponentially growing backoff, and the
                          same request retried: the data sources are
                          deterministic, so a masked fault leaves the run
                          bit for bit as it was. After ``restarts``
                          rebuilds the original error propagates.
  restore_with_walkback   load the checkpoint at a step, or the newest with
                          −1, walking back past corrupt ones
                          (``CheckpointCorruptError``); structural errors
                          propagate. Retain-last-N GC keeps the newest N by
                          step, not by integrity: run ``keep_checkpoints``
                          ≥ 2 (or 0) where a torn newest checkpoint is a
                          live concern.
  GracefulStop            SIGTERM / SIGINT ask for a stop, which the loops
                          honour at the next step or chunk end with a
                          checkpoint there; a second signal raises
                          :class:`ImmediateStopError`, and the loops
                          checkpoint the newest state at once.

The port's state is updated in place (``training/step.py``), so a step or
a chunk interrupted half-way would leave parameters ahead of their step
counter. The loops dispatch inside :meth:`GracefulStop.shield`, which
holds a second signal's error until the dispatch has returned: the newest
dispatched state is then always a whole step's.

The fault plan's host events (``resilience/faults.HostFaultInjector``)
come in here: :func:`stop_requested` delivers every due ``sigterm`` event
through the real handler, and a ``prefetch_crash`` raised by a data
function that the injector wraps is retried by the
:class:`SupervisedPrefetcher` around it — the chunked loops' prefetchers,
and the eager loops' :class:`DirectSource` when a plan has host events.
"""

from __future__ import annotations

import contextlib
import signal
import threading
import time
from typing import Any, Callable, Optional

from draco_tpu_torch.obs.tracer import NULL_TRACER


class SupervisedPrefetcher:
    """A prefetcher (``get`` / ``depth`` / ``close``) built by ``factory``,
    rebuilt on failure up to ``restarts`` times a request (module
    docstring). ``restarts=0`` passes through."""

    def __init__(self, factory: Callable[[], Any], restarts: int = 2,
                 backoff_s: float = 0.05, tracer=NULL_TRACER):
        self._factory = factory
        self._restarts = max(int(restarts), 0)
        self._backoff_s = backoff_s
        self._tracer = tracer
        self._p = factory()
        self.restarts_used = 0

    @property
    def depth(self) -> int:
        return self._p.depth if self._p is not None else 0

    def get(self, *args, **kwargs):
        if self._p is None:  # rebuilt lazily after an exhausted retry
            self._p = self._factory()
        delay = self._backoff_s
        for attempt in range(self._restarts + 1):
            try:
                return self._p.get(*args, **kwargs)
            except Exception as e:
                # the failing instance is abandoned, on the last attempt
                # too: close() never joins a worker known to be broken
                self._abandon()
                if attempt == self._restarts:
                    raise
                with self._tracer.span(
                        "prefetch.restart", attempt=attempt + 1,
                        error=f"{type(e).__name__}: {e}"[:200]):
                    pass
                time.sleep(delay)
                delay *= 2
                self._p = self._factory()
                self.restarts_used += 1

    def stats(self) -> dict:
        """How many times a prefetcher was abandoned and rebuilt."""
        return {"prefetch_restarts": self.restarts_used}

    def _abandon(self) -> None:
        """Drop the broken instance without blocking on it."""
        p, self._p = self._p, None
        try:
            if hasattr(p, "abandon"):
                p.abandon()
            else:
                p.close()
        except Exception:
            pass

    def close(self) -> None:
        if self._p is not None:
            try:
                self._p.close()
            except Exception:
                pass


class DirectSource:
    """A synchronous data function with a prefetcher's surface (``get``,
    ``depth``, ``close``): what an eager loop reads its steps through when
    the fault plan's injector wraps it, so a :class:`SupervisedPrefetcher`
    retries an injected crash."""

    depth = 0

    def __init__(self, fn: Callable):
        self._fn = fn

    def get(self, *args):
        return self._fn(*args)

    def close(self) -> None:
        pass


# ---- checkpoint walk-back --------------------------------------------------


def restore_with_walkback(train_dir: str, step: int, specs, loader=None):
    """Load the checkpoint at ``step`` (the newest with −1), walking back
    past corrupt ones. Returns ``(leaves, loaded_step, skipped)``,
    ``skipped`` the ``(step, error)`` of each corrupt checkpoint passed
    (each printed). Raises the last corruption error when nothing loads,
    FileNotFoundError when ``train_dir`` holds no checkpoint, and any other
    load error at once."""
    from draco_tpu_torch.utils import checkpoint as ckpt

    load = loader or ckpt.load
    steps = ckpt.available_steps(train_dir)
    if step == -1:
        candidates = sorted(steps, reverse=True)
    else:
        candidates = [step] + sorted((s for s in steps if s < step),
                                     reverse=True)
    if not candidates:
        raise FileNotFoundError(
            f"no checkpoints in {train_dir!r} to restore from")
    skipped = []
    last_err: Optional[Exception] = None
    for s in candidates:
        try:
            return load(train_dir, s, specs), s, skipped
        except ckpt.CheckpointCorruptError as e:
            print(f"checkpoint walk-back: skipped corrupt step {s} ({e})",
                  flush=True)
            skipped.append((s, str(e)))
            last_err = e
    raise last_err


# ---- preemption-safe stop --------------------------------------------------


class ImmediateStopError(Exception):
    """A second SIGTERM / SIGINT while a graceful stop was pending: the
    loops checkpoint the newest dispatched state and end. The previous
    handlers are back in place when it is raised, so a third signal kills
    the ordinary way."""


class GracefulStop:
    """SIGTERM / SIGINT as a stop request the loops poll at step and chunk
    ends. Installs its handlers on ``__enter__`` in the main thread (in any
    other thread it is an inert flag holder) and restores the previous ones
    on ``__exit__``. A second signal escalates (:class:`ImmediateStopError`),
    inside :meth:`shield` only once the shielded block has ended."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = signals
        self._previous: dict = {}
        self._shielded = 0
        self._held: Optional[ImmediateStopError] = None
        self.requested = False
        self.escalated = False
        self.signame: Optional[str] = None
        self.stopped_step: Optional[int] = None  # where the loop stopped

    def _escalate(self, signum) -> None:
        self.escalated = True
        err = ImmediateStopError(
            f"second {signal.Signals(signum).name} while a graceful stop "
            f"was pending — immediate checkpoint requested")
        if self._shielded:
            self._held = err
            return
        raise err

    def _handler(self, signum, frame):
        if self.requested:
            for sig, prev in self._previous.items():
                signal.signal(sig, prev)
            self._previous = {}
            self._escalate(signum)
            return
        self.requested = True
        self.signame = signal.Signals(signum).name

    @property
    def installed(self) -> bool:
        """True when this instance's handlers are live."""
        return bool(self._previous)

    def deliver_signal(self, sig=signal.SIGTERM) -> None:
        """``sig`` through the real handler when installed, else straight
        to the stop request (same escalation)."""
        if self.installed:
            signal.raise_signal(sig)
        elif self.requested:
            self._escalate(sig)
        else:
            self.requested = True
            self.signame = signal.Signals(sig).name

    @contextlib.contextmanager
    def shield(self):
        """Hold an escalation raised inside the block until it ends."""
        self._shielded += 1
        try:
            yield
        finally:
            self._shielded -= 1
        if not self._shielded and self._held is not None:
            err, self._held = self._held, None
            raise err

    def __enter__(self) -> "GracefulStop":
        if threading.current_thread() is threading.main_thread():
            for sig in self._signals:
                self._previous[sig] = signal.signal(sig, self._handler)
        return self

    def __exit__(self, *exc):
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous = {}
        return False


def stop_requested(stop: Optional[GracefulStop], injector,
                   step: int) -> bool:
    """The stop poll both loops share: fire every sigterm event of the
    fault plan due by ``step`` (``injector``; None: no plan), then report
    whether a graceful stop is pending (``stop`` may be None)."""
    while injector is not None and injector.sigterm_due(step):
        if stop is None:
            break
        stop.deliver_signal(signal.SIGTERM)
    return stop is not None and stop.requested


def shielded(stop: Optional[GracefulStop]):
    """``stop.shield()``, or nothing to shield without a stop."""
    return stop.shield() if stop is not None else contextlib.nullcontext()
