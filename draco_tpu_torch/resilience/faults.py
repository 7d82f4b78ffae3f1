"""The seeded fault plan (draco_tpu/resilience/faults.py): the chaos
counterpart of ``attacks.py``'s adversary schedules.

A :class:`FaultPlan` is parsed from ``cfg.fault_spec``, a comma-separated
list of events, so the same plan replays bit for bit across runs, eager
and chunked, and processes::

    kind@step[-end][:w<worker>][:d<seconds>][:every<k>]

    nan_grad@5          a worker (seeded draw) emits a NaN gradient at
                        step 5; inf_grad@5:w2 worker 2 an Inf one
    drift_grad@5-12     every worker's gradient scaled by 2^-20 in the
                        window (a finite numerics drift)
    over_budget@7       step 7's adversary row pushed to s+1 live
                        adversaries, past the locator's budget
    adversary@5-40:w2   worker 2 a live adversary over the window, within
                        the budget (the step's err_mode attack fires)
    straggle@5:w3[:d4]  worker 3 absent from step 5 to the run's end (or
                        for 4 steps); @a-b absent in the window;
                        :d4:every10 a 4-step drop at every 10th step
    prefetch_crash@5    the data fn raises InjectedFaultError the first
                        time step 5's data is asked for; prefetch_hang@5:d6
                        sleeps 6 s instead
    sigterm@5           SIGTERM raised in-process once step 5 is done (a
                        second due sigterm while the stop is pending
                        escalates: supervisor.ImmediateStopError)
    ckpt_corrupt@8      (and ckpt_truncate) parsed for a chaos harness,
                        which the port does not have yet

``@a-b`` makes an event recur at every step of the window, ``:every<k>``
at every k-th; each occurrence behaves as a point event of its kind. The
grammar, the seeded draws of the victim worker (``seed ^ 0x4641554C``)
and of the over-budget rows (``seed ^ 0x0B0D6E7``) and the host overlays
are the reference's numpy code, so both packages pick the same workers bit
for bit.

The in-step kinds (``nan_grad``, ``inf_grad``, ``drift_grad``) run on the
device inside the step: :func:`plan_tensors` uploads the events' start,
end, stride, worker and payload once at setup, and :func:`corrupt_grads`
compares them with the step's staged int32 step number, branch-free, so a
chunk captured in a CUDA graph replays each step's own events. With no
in-step event the plan's tensors are None and :func:`corrupt_grads`
returns the gradients untouched: no op is added to the step. The schedule
kinds overlay the host's seeded schedules (:func:`apply_over_budget`,
:func:`apply_adversary`, :func:`apply_straggle`); the host kinds fire once
per occurrence through :class:`HostFaultInjector`, so a supervised retry
(``resilience/supervisor.py``) runs clean, as a transient fault would.
"""

from __future__ import annotations

import dataclasses
import functools
import re
from typing import Optional, Tuple

import numpy as np
import torch

# in-graph kinds corrupt the step's compiled inputs; schedule kinds mutate
# the seeded host schedules before upload (over_budget → adversary rows,
# straggle → straggler/present rows); host kinds fire in the host loop /
# prefetcher; ckpt kinds are consumed by a chaos harness (the
# reference's tools/chaos_run.py; not ported)
INGRAPH_KINDS = ("nan_grad", "inf_grad", "drift_grad")

# drift_grad's multiplicative payload: 2^-20 moves gradient-scale values
# (~1e-2) down ~6 decades — more than one full exponent-histogram band
# (obs/numerics.EXP_EDGES are 8-16 bins wide), so the numerics_drift
# detector's TV-shift signal goes loud, while every derived quantity
# (int8 per-block scales, squared energies in the decode health) stays in
# the f32 normal range: the injection perturbs NUMERICS, never
# finiteness or decode exactness
DRIFT_GRAD_SCALE = 2.0 ** -20
SCHEDULE_KINDS = ("over_budget", "straggle", "adversary")
HOST_KINDS = ("prefetch_crash", "prefetch_hang", "sigterm")
CKPT_KINDS = ("ckpt_corrupt", "ckpt_truncate")
FAULT_KINDS = INGRAPH_KINDS + SCHEDULE_KINDS + HOST_KINDS + CKPT_KINDS

# kinds whose :d payload is an integer STEP count (dwell), not seconds
_STEP_DWELL_KINDS = ("straggle", "adversary")
# kinds whose target worker is drawn from the seeded stream when no :w
# (drift_grad is fleet-wide — no victim to draw)
_DRAWN_WORKER_KINDS = ("nan_grad", "inf_grad", "straggle", "adversary")

_EVENT_RE = re.compile(r"^(?P<kind>[a-z_]+)@(?P<step>\d+)"
                       r"(?:-(?P<hi>\d+))?"
                       r"(?::w(?P<worker>\d+))?(?::d(?P<dur>[\d.]+))?"
                       r"(?::every(?P<every>\d+))?$")


class InjectedFaultError(RuntimeError):
    """The named error a ``prefetch_crash`` event raises — distinguishable
    from any organic failure, so chaos tests can assert the supervision
    path masked exactly the injected fault and nothing else."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    kind: str
    step: int  # 1-based training step the event (window) starts at
    worker: Optional[int] = None  # in-graph/straggle/adversary target row
    # ``:d<n>`` payload. prefetch_hang: seconds the worker thread sleeps
    # (None → 30 s). straggle/adversary: dwell in STEPS per occurrence
    # (None → sustained to the end of the run / a single step).
    duration_s: Optional[float] = None
    # window end (``@a-b``; None = the point event a) and recurrence
    # stride within it (``:every<k>``; 1 = every step of the window)
    step_hi: Optional[int] = None
    every: int = 1
    # position in the parsed spec — keys the one-shot host firing and the
    # seeded worker draw; excluded from equality so a round-tripped spec
    # (with blanks dropped) still compares equal
    index: int = dataclasses.field(default=0, compare=False)

    @property
    def last_step(self) -> int:
        return self.step if self.step_hi is None else self.step_hi

    def occurrences(self, lo: int, hi: int):
        """Occurrence steps within [lo, hi] — a, a+every, ..., <= b."""
        first = self.step
        if lo > first:
            # first occurrence at or after lo on the event's stride grid
            first += ((lo - self.step + self.every - 1)
                      // self.every) * self.every
        return range(first, min(self.last_step, hi) + 1, self.every)

    def occurs_at(self, step: int) -> bool:
        return (self.step <= step <= self.last_step
                and (step - self.step) % self.every == 0)

    def spec(self) -> str:
        """The event's canonical spec token — ``FaultPlan.parse`` of it
        reproduces this event (worker resolved, so the seeded draw is
        pinned explicit on the way out)."""
        tok = f"{self.kind}@{self.step}"
        if self.step_hi is not None:
            tok += f"-{self.step_hi}"
        if self.worker is not None:
            tok += f":w{self.worker}"
        if self.duration_s is not None:
            d = self.duration_s
            tok += f":d{int(d) if float(d).is_integer() else d}"
        if self.every != 1:
            tok += f":every{self.every}"
        return tok


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable, seed-deterministic set of fault events."""

    events: Tuple[FaultEvent, ...]
    seed: int
    num_workers: int

    @classmethod
    def parse(cls, spec: str, seed: int, num_workers: int) -> "FaultPlan":
        events = []
        for i, tok in enumerate(t.strip() for t in spec.split(",")):
            if not tok:
                continue
            m = _EVENT_RE.match(tok)
            if not m:
                raise ValueError(
                    f"fault_spec event {tok!r} does not match "
                    f"'kind@step[-end][:w<worker>][:d<seconds>]"
                    f"[:every<k>]'"
                )
            kind, step = m.group("kind"), int(m.group("step"))
            if kind not in FAULT_KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r}; known: "
                    f"{'|'.join(FAULT_KINDS)}"
                )
            if step < 1:
                raise ValueError(f"fault step must be >= 1 in {tok!r}")
            hi = m.group("hi")
            if hi is not None:
                hi = int(hi)
                if hi < step:
                    raise ValueError(
                        f"fault window end {hi} precedes start {step} in "
                        f"{tok!r}"
                    )
                if kind in CKPT_KINDS:
                    raise ValueError(
                        f"{kind} targets one checkpoint; a window makes "
                        f"no sense in {tok!r}"
                    )
            every = m.group("every")
            if every is not None:
                every = int(every)
                if every < 1:
                    raise ValueError(f"every must be >= 1 in {tok!r}")
                if hi is None:
                    raise ValueError(
                        f"':every' without a step window 'a-b' is inert "
                        f"in {tok!r} — recurrence needs a window to recur "
                        f"over"
                    )
            worker = m.group("worker")
            if worker is not None:
                worker = int(worker)
                if worker >= num_workers:
                    raise ValueError(
                        f"fault worker {worker} out of range "
                        f"(num_workers={num_workers}) in {tok!r}"
                    )
            elif kind in _DRAWN_WORKER_KINDS:
                # seeded per-event draw — the same "every participant can
                # recompute it" property as rng.adversary_schedule
                r = np.random.RandomState((seed ^ 0x4641554C) + 7919 * i)
                worker = int(r.randint(num_workers))
            dur = m.group("dur")
            if dur is not None and kind in _STEP_DWELL_KINDS \
                    and float(dur) != int(float(dur)):
                # :d is float SECONDS for host kinds but integer STEPS for
                # straggle/adversary — reject rather than silently floor
                raise ValueError(
                    f"{kind} dwell is a whole number of steps, got "
                    f"d{dur} in {tok!r}"
                )
            events.append(FaultEvent(
                kind=kind, step=step, worker=worker,
                duration_s=float(dur) if dur is not None else None,
                step_hi=hi, every=every or 1, index=i,
            ))
        return cls(events=tuple(events), seed=seed, num_workers=num_workers)

    def spec(self) -> str:
        """Canonical round-trippable spec: ``FaultPlan.parse(plan.spec(),
        seed, n) == plan`` (workers pinned explicit, blanks dropped)."""
        return ",".join(ev.spec() for ev in self.events)

    def of_kind(self, *kinds: str) -> Tuple[FaultEvent, ...]:
        return tuple(e for e in self.events if e.kind in kinds)

    @property
    def ingraph_events(self) -> Tuple[FaultEvent, ...]:
        return self.of_kind(*INGRAPH_KINDS)


@functools.lru_cache(maxsize=64)
def _cached_plan(spec: str, seed: int, num_workers: int) -> FaultPlan:
    return FaultPlan.parse(spec, seed, num_workers)


def plan_from_cfg(cfg) -> Optional[FaultPlan]:
    """The cfg's parsed plan, or None when no faults are configured (the
    common case — every consumer below is an exact no-op then)."""
    if not getattr(cfg, "fault_spec", ""):
        return None
    return _cached_plan(cfg.fault_spec, cfg.seed, cfg.num_workers)


# ---- in-step injection ---------------------------------------------------


class PlanTensors:
    """The in-step events of a plan on one device, in the plan's order:
    (E,) int32 ``start``, ``end`` (the window's last step) and ``every``,
    (E,) int64 ``worker`` (−1 for the fleet-wide drift) and (E,) f32
    ``payload`` (NaN, Inf or the drift's scale); ``kinds`` the events'
    kinds, which pick each event's arithmetic on the host."""

    def __init__(self, events, device):
        def vec(vals, dtype):
            return torch.tensor(vals, dtype=dtype).to(device)

        self.kinds = tuple(ev.kind for ev in events)
        self.start = vec([ev.step for ev in events], torch.int32)
        self.end = vec([ev.last_step for ev in events], torch.int32)
        self.every = vec([ev.every for ev in events], torch.int32)
        self.worker = vec([-1 if ev.worker is None or ev.kind == "drift_grad"
                           else ev.worker for ev in events], torch.int64)
        self.payload = vec([_PAYLOAD[ev.kind] for ev in events],
                           torch.float32)


_PAYLOAD = {"nan_grad": float("nan"), "inf_grad": float("inf"),
            "drift_grad": DRIFT_GRAD_SCALE}


def plan_tensors(plan: Optional[FaultPlan], device) -> Optional[PlanTensors]:
    """The plan's in-step events as :class:`PlanTensors` on ``device``, or
    None when it has none. Built once at setup, never inside a capture
    (an upload under capture raises)."""
    if plan is None or not plan.ingraph_events:
        return None
    return PlanTensors(plan.ingraph_events, torch.device(device))


def corrupt_grads(grads: torch.Tensor, plan: Optional[PlanTensors],
                  step) -> torch.Tensor:
    """NaN / Inf / drift injection into the (n, ...) per-worker gradients
    at the plan's in-step events, branch-free: an event occurs at ``step``
    (the step's int32 device tensor, 1-based) iff start ≤ step ≤ end and
    (step − start) mod every = 0. The drift events scale every row, in the
    plan's order; then each victim row takes the payload of the last of
    its events that occurs, by one ``torch.where`` over the gradients (the
    reference's masked ``jnp.where``). ``plan`` None: ``grads`` itself."""
    if plan is None or step is None:
        return grads
    n = grads.shape[0]
    s = step.to(torch.int32).reshape(())
    hit = ((s >= plan.start) & (s <= plan.end)
           & (torch.remainder(s - plan.start, plan.every) == 0))
    rows = torch.arange(n, device=grads.device)
    mask = payload = None
    for e, kind in enumerate(plan.kinds):
        if kind == "drift_grad":
            grads = grads * torch.where(hit[e], plan.payload[e],
                                        torch.ones_like(plan.payload[e]))
            continue
        at = hit[e] & (rows == plan.worker[e])
        mask = at if mask is None else mask | at
        payload = (torch.where(at, plan.payload[e], torch.zeros_like(
            plan.payload[e])) if payload is None
            else torch.where(at, plan.payload[e], payload))
    if mask is None:
        return grads
    shape = (n,) + (1,) * (grads.dim() - 1)
    return torch.where(mask.view(shape), payload.to(grads.dtype).view(shape),
                       grads)


def apply_over_budget(adv_schedule: np.ndarray, plan: Optional[FaultPlan],
                      worker_fail: int) -> np.ndarray:
    """Host-side schedule mutation for ``over_budget`` events: the targeted
    steps' adversary rows gain seeded extra workers until s+1 are live —
    one corruption past the code's locator budget, the regime where exact
    recovery is impossible and the guard (resilience/guards.py) is the only
    thing standing between a silently poisoned update and a skipped one.
    Returns the (possibly copied) schedule; the input is never mutated."""
    if plan is None:
        return adv_schedule
    events = plan.of_kind("over_budget")
    if not events:
        return adv_schedule
    adv = np.array(adv_schedule, copy=True)
    n = adv.shape[1]
    want = min(worker_fail + 1, n)
    for ev in events:
        for o in ev.occurrences(1, adv.shape[0] - 1):
            row = adv[o]
            r = np.random.RandomState((plan.seed ^ 0x0B0D6E7) + o)
            order = r.permutation(n)
            for w in order:
                if row.sum() >= want:
                    break
                row[w] = True
            adv[o] = row
    return adv


def apply_adversary(adv_schedule: np.ndarray,
                    plan: Optional[FaultPlan]) -> np.ndarray:
    """Host-side schedule mutation for ``adversary`` events: the targeted
    worker's row goes live-adversarial at every occurrence (for ``:d``
    dwell steps each — default 1), WITHIN the code budget: this is the
    declarative time-varying-adversary knob (an attack EPISODE a fleet
    actually sees), not the beyond-budget ``over_budget`` stressor. The
    step's cfg.err_mode attack then fires through the exact same masked
    injection path as the seeded schedule. Returns the (possibly copied)
    schedule; the input is never mutated."""
    if plan is None:
        return adv_schedule
    events = plan.of_kind("adversary")
    if not events:
        return adv_schedule
    adv = np.array(adv_schedule, copy=True)
    for ev in events:
        dwell = 1 if ev.duration_s is None else int(ev.duration_s)
        for o in ev.occurrences(1, adv.shape[0] - 1):
            adv[o:min(o + dwell, adv.shape[0]), ev.worker] = True
    return adv


def apply_straggle(straggle_schedule: Optional[np.ndarray],
                   plan: Optional[FaultPlan], num_workers: int,
                   n_steps: int) -> Optional[np.ndarray]:
    """Host-side schedule mutation for ``straggle`` events: a SUSTAINED
    per-worker drop — the targeted worker's rows stop arriving from the
    event step until recovery (``:d<dwell>`` steps later; without it, the
    end of the run — the spot/preemptible-instance shape). Unlike the
    one-shot crash kinds this rides the existing seeded straggler/present
    machinery: the drop is an *erasure at a known position* every step it
    lasts, which is exactly the fault surface the approx code family
    (coding/approx.py) decodes around with a bounded residual,
    and a scheduled straggler is never an accused worker (obs/forensics).

    ``straggle_schedule``: the seeded (rows, n) drop mask (True = absent)
    or None when cfg configured no stragglers — the mutation materializes
    a fresh all-False table then, sized ``n_steps + 1`` rows like
    rng.straggler_schedule. Passthrough (input returned untouched) when
    the plan has no straggle events."""
    if plan is None:
        return straggle_schedule
    events = plan.of_kind("straggle")
    if not events:
        return straggle_schedule
    if straggle_schedule is None:
        out = np.zeros((n_steps + 1, num_workers), dtype=bool)
    else:
        out = np.array(straggle_schedule, copy=True)
    for ev in events:
        for o in ev.occurrences(1, out.shape[0] - 1):
            if ev.duration_s is not None:
                hi = min(out.shape[0], o + int(ev.duration_s))
            elif ev.step_hi is not None:
                # windowed form without :d — absent exactly DURING the
                # window (each occurrence covers its own step), recovering
                # at window end; only the point form means "to the end of
                # the run" (the spot-instance shape)
                hi = o + 1
            else:
                hi = out.shape[0]
            out[o:hi, ev.worker] = True
    return out


# ---- host-side one-shot triggering ----------------------------------------


class HostFaultInjector:
    """Fires each host fault event exactly once, however many times the
    surrounding request is retried — so a supervised restart
    (resilience/supervisor.py) observes a clean re-execution, the way a
    transient real fault would behave. Inert (every method a cheap no-op)
    when built with ``plan=None``."""

    def __init__(self, plan: Optional[FaultPlan]):
        self._plan = plan
        self._fired: set = set()

    @property
    def active(self) -> bool:
        return self._plan is not None and bool(self._plan.events)

    def _fire(self, kinds, lo: int, hi: Optional[int] = None):
        """First unfired OCCURRENCE of an event of ``kinds`` within
        [lo, hi] (hi defaults to lo), marked fired. Keyed by (event index,
        occurrence step): recurring events fire once per occurrence, and
        two identical point events (e.g. ``sigterm@5,sigterm@5`` — the
        pinned escalation sequence) each fire."""
        if self._plan is None:
            return None
        hi = lo if hi is None else hi
        for ev in self._plan.of_kind(*kinds):
            for o in ev.occurrences(lo, hi):
                key = (ev.index, o)
                if key not in self._fired:
                    self._fired.add(key)
                    return ev
        return None

    def wrap_step_fn(self, fn):
        """Wrap a per-step host data fn (``fn(step) -> x``) so prefetch
        fault events fire when their step's data is first requested."""
        if not self.active:
            return fn

        def wrapped(step):
            self._maybe_prefetch_fault(step, step)
            return fn(step)

        return wrapped

    def wrap_range_fn(self, fn):
        """Wrap a chunk-range host data fn (``fn(start, k) -> x``) so
        prefetch fault events fire when the chunk containing their step is
        first requested."""
        if not self.active:
            return fn

        def wrapped(start, k):
            self._maybe_prefetch_fault(start, start + k - 1)
            return fn(start, k)

        return wrapped

    def _maybe_prefetch_fault(self, lo: int, hi: int) -> None:
        ev = self._fire(("prefetch_crash", "prefetch_hang"), lo, hi)
        if ev is None:
            return
        if ev.kind == "prefetch_crash":
            raise InjectedFaultError(
                f"injected prefetch_crash at step {ev.step} "
                f"(fault plan event)"
            )
        import time

        time.sleep(30.0 if ev.duration_s is None else ev.duration_s)

    def sigterm_due(self, end_step: int) -> bool:
        """True once, when a sigterm event's step has been reached — the
        loop then raises the real signal in-process so the registered
        GracefulStop handler (resilience/supervisor.py) runs the genuine
        preemption path."""
        return self._fire(("sigterm",), 1, end_step) is not None


NULL_INJECTOR = HostFaultInjector(None)
