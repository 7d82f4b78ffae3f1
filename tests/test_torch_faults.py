"""The port's seeded fault plan (``draco_tpu_torch/resilience/faults.py``)
against the JAX package's (``draco_tpu/resilience/faults.py``), no model:

  * ``FaultPlan.parse`` gives the reference's events — points, windows,
    ``:every``, ``:d``, drawn and pinned workers — and the same
    ``ValueError`` on each bad spec of the reference's tests; ``spec()``
    round-trips;
  * the three overlays give the reference's arrays exactly;
  * ``corrupt_grads`` on (n, d) and (n, 3, d) gradients equals the
    reference's (JAX on the CPU) at steps inside, outside and on the
    stride of each in-step kind, the drift included, bit for bit;
  * the host injector fires once an occurrence under a supervised retry,
    and two sigterm events at one step escalate.
"""

import signal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from draco_tpu.resilience import faults as ref
from draco_tpu_torch.resilience import faults
from draco_tpu_torch.resilience.supervisor import (
    DirectSource,
    GracefulStop,
    ImmediateStopError,
    SupervisedPrefetcher,
    stop_requested,
)

SPECS = (
    "nan_grad@5,inf_grad@6:w3,prefetch_hang@2:d7,sigterm@9",
    "straggle@20-60:w3:d4:every10,adversary@5-40:w2,nan_grad@8-10:w1",
    "straggle@5-9", "over_budget@4,over_budget@7-9:every2",
    "drift_grad@3-6,nan_grad@4:w0,inf_grad@4:w0,straggle@2:w6:d3",
    "prefetch_crash@2,sigterm@5,sigterm@5,ckpt_corrupt@8",
    " nan_grad@2 , ,inf_grad@3",
)
BAD = ("what@3", "nan_grad@0", "nan_grad@2:w9", "nan_grad", "nan_grad@9-5",
       "sigterm@5:every2", "ckpt_corrupt@5-9", "straggle@5-9:d1.5",
       "adversary@5:d0.5", "straggle@5-9:every0", "straggle@3:w8")


def _events(plan):
    return [(e.kind, e.step, e.worker, e.duration_s, e.step_hi, e.every,
             e.index) for e in plan.events]


@pytest.mark.parametrize("seed", (428, 1, 7))
@pytest.mark.parametrize("spec", SPECS)
def test_parse_equals_the_reference(spec, seed):
    mine, theirs = (faults.FaultPlan.parse(spec, seed, 8),
                    ref.FaultPlan.parse(spec, seed, 8))
    assert _events(mine) == _events(theirs)
    assert mine.spec() == theirs.spec()
    assert faults.FaultPlan.parse(mine.spec(), seed, 8) == mine
    for e, r in zip(mine.events, theirs.events):
        assert [e.occurs_at(t) for t in range(80)] == [
            r.occurs_at(t) for t in range(80)]
        assert list(e.occurrences(7, 70)) == list(r.occurrences(7, 70))


@pytest.mark.parametrize("spec", BAD)
def test_bad_specs_raise_the_references_errors(spec):
    with pytest.raises(ValueError) as theirs:
        ref.FaultPlan.parse(spec, 428, 8)
    with pytest.raises(ValueError) as mine:
        faults.FaultPlan.parse(spec, 428, 8)
    assert str(mine.value) == str(theirs.value)


def test_overlays_equal_the_references():
    spec = ("over_budget@4,over_budget@7-9:every2,adversary@5-8:w2,"
            "straggle@10-13:w4,straggle@20-28:w5:d2:every4,straggle@30:w6,"
            "straggle@3:w1:d2")
    mine, theirs = (faults.FaultPlan.parse(spec, 428, 8),
                    ref.FaultPlan.parse(spec, 428, 8))
    rng = np.random.RandomState(3)
    adv = rng.rand(35, 8) < 0.1
    adv[:, 0] = True
    for s in (1, 2):
        a = faults.apply_over_budget(adv, mine, s)
        np.testing.assert_array_equal(a, ref.apply_over_budget(adv, theirs,
                                                               s))
        np.testing.assert_array_equal(
            faults.apply_adversary(a, mine), ref.apply_adversary(a, theirs))
    base = rng.rand(35, 8) < 0.1
    for sched in (None, base):
        np.testing.assert_array_equal(
            faults.apply_straggle(sched, mine, 8, 34),
            ref.apply_straggle(sched, theirs, 8, 34))
    # no plan, or no event of the kind: the input itself
    assert faults.apply_over_budget(adv, None, 1) is adv
    plain = faults.FaultPlan.parse("nan_grad@2", 428, 8)
    assert faults.apply_straggle(base, plain, 8, 34) is base
    assert faults.apply_adversary(adv, plain) is adv


class _Cfg:
    def __init__(self, spec, seed=428, n=8):
        self.fault_spec, self.seed, self.num_workers = spec, seed, n


CORRUPT_SPECS = ("nan_grad@3", "inf_grad@4:w2", "nan_grad@2-8:w5:every3",
                 "drift_grad@3-6", "drift_grad@2-9:every2,nan_grad@4:w0,"
                 "inf_grad@4:w0,nan_grad@6:w7")


@pytest.mark.parametrize("shape", ((8, 37), (8, 3, 11)))
@pytest.mark.parametrize("spec", CORRUPT_SPECS)
def test_corrupt_grads_equals_the_references(spec, shape):
    g = np.random.RandomState(5).randn(*shape).astype(np.float32) * 1e-2
    plan = faults.plan_tensors(faults.FaultPlan.parse(spec, 428, 8), "cpu")
    for step in range(1, 11):
        want = np.asarray(ref.corrupt_grads(jnp.asarray(g), _Cfg(spec),
                                            jnp.asarray(step, jnp.int32)))
        got = faults.corrupt_grads(torch.from_numpy(g), plan,
                                   torch.tensor(step, dtype=torch.int32))
        np.testing.assert_array_equal(got.numpy(), want)


def test_no_in_step_event_adds_nothing():
    g = torch.randn(8, 5)
    for spec in ("", "sigterm@3,straggle@2:w1,over_budget@4"):
        plan = (faults.plan_tensors(faults.FaultPlan.parse(spec, 428, 8),
                                    "cpu") if spec else None)
        assert plan is None
        assert faults.corrupt_grads(g, plan, torch.tensor(3)) is g


def test_injector_fires_once_under_retry_and_escalates():
    plan = faults.FaultPlan.parse("prefetch_crash@2,prefetch_crash@4-6:every2",
                                  428, 8)
    inj = faults.HostFaultInjector(plan)
    calls = []
    src = SupervisedPrefetcher(
        lambda: DirectSource(inj.wrap_step_fn(lambda s: calls.append(s)
                                              or s)),
        restarts=2, backoff_s=0.0)
    assert [src.get(s) for s in range(1, 8)] == list(range(1, 8))
    assert src.restarts_used == 3  # steps 2, 4 and 6, each retried clean
    assert calls == list(range(1, 8))
    # a range fn fires each occurrence inside its chunk once: steps 2, 4
    inj = faults.HostFaultInjector(plan)
    fn = inj.wrap_range_fn(lambda start, k: (start, k))
    for _ in range(2):
        with pytest.raises(faults.InjectedFaultError):
            fn(1, 4)
    assert fn(1, 4) == (1, 4)
    assert not faults.NULL_INJECTOR.active
    # one sigterm: a graceful stop; two at one step: the escalation
    stop = GracefulStop()
    one = faults.HostFaultInjector(faults.FaultPlan.parse("sigterm@5", 428,
                                                          8))
    assert not stop_requested(stop, one, 4)
    assert stop_requested(stop, one, 5) and not stop.escalated
    two = faults.HostFaultInjector(faults.FaultPlan.parse(
        "sigterm@5,sigterm@5", 428, 8))
    with GracefulStop((signal.SIGTERM,)) as live:
        with pytest.raises(ImmediateStopError):
            stop_requested(live, two, 6)
        assert live.requested and live.escalated
