"""The port's step guard (``draco_tpu_torch/resilience/guards.py``) and
the gated update (``optim.Optimizer.step_flat(ok=)``) against the JAX
package's (``draco_tpu/resilience/guards.py``), no model:

  * ``assess`` gives the reference's verdict and trip count on synthesized
    health: NaN / Inf aggregates, a NaN residual, a residual against tol
    and against bound + tol, located > s with and without ``present``, at
    each wire dtype's slack;
  * the gated SGD (momentum, nesterov, dampening), Adam and AdamW under the
    cosine schedule and the clip: with ``ok`` True the update is the
    ungated one bit for bit, with ``ok`` False the parameters, the buffers
    and the update count stay bit for bit, over a sequence of trusted and
    skipped steps; against the reference's optimizer under
    ``guards.select_state`` to 1e-6 (its float32 arithmetic, as
    test_torch_optim.py holds it) and its counts exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from draco_tpu.resilience import guards as ref_guards
from draco_tpu.training.step import TrainState as JaxState
from draco_tpu_torch.resilience import guards
from test_torch_optim import LAYOUT, RULES, _port, _reference, _tree

NAN, INF = float("nan"), float("inf")


class _Cfg:
    def __init__(self, wire_dtype="f32", s=1, tol=1e-3):
        self.wire_dtype, self.worker_fail = wire_dtype, s
        self.guard_residual_tol, self.step_guard = tol, "on"


def _agg(kind):
    a = np.random.RandomState(2).randn(300).astype(np.float32)
    if kind == "nan":
        a[17] = NAN
    elif kind == "inf":
        a[299] = -INF
    return a


FLAGGED = (0b00000001, 0b00000011, 0b10000011)
# (residual, bound or None); the bound marks the approx certificate
RESIDUALS = ((2e-7, None), (5e-4, None), (1.5e-3, None), (NAN, None),
             (0.3, 0.35), (0.3355, 0.3), (0.36, 0.3), (NAN, 0.3),
             (0.1, NAN), (2e-2, None), (0.12, None))


def _bits(word, n=8):
    return np.array([(word >> i) & 1 for i in range(n)], bool)


@pytest.mark.parametrize("wire", ("f32", "bf16", "int8"))
@pytest.mark.parametrize("agg", ("finite", "nan", "inf"))
def test_assess_equals_the_reference(agg, wire):
    cfg = _Cfg(wire)
    a = _agg(agg)
    cases = [None]
    for res, bound in RESIDUALS:
        h = {"residual": res}
        if bound is not None:
            h["bound"] = bound
        cases.append(h)
        for word in FLAGGED:
            cases.append(dict(h, flagged=_bits(word)))
    for present in (None, _bits(0b01111110)):
        for h in cases:
            want = ref_guards.assess(
                cfg, jnp.asarray(a),
                None if h is None else {
                    k: jnp.asarray(v, jnp.float32 if k != "flagged"
                                   else bool) for k, v in h.items()},
                None if present is None else jnp.asarray(present))
            got = guards.assess(
                cfg, torch.from_numpy(a),
                None if h is None else {
                    k: torch.tensor(v, dtype=torch.float32 if k != "flagged"
                                    else torch.bool) for k, v in h.items()},
                None if present is None else torch.from_numpy(present))
            assert (bool(got.ok), int(got.trips)) == (
                bool(want.ok), int(want.trips)), (h, present)
            cols = guards.metric_columns(got)
            assert int(cols["skipped_steps"]) == int(not bool(want.ok))
    assert guards.guard_update(type("C", (), {"step_guard": "off"})(),
                               torch.zeros(3)) == (None, {})


# the trust pattern of the gated run: the skipped steps carry NaN
OK = (True, False, True, True, False, False, True, True)


def _grads():
    r = np.random.RandomState(11)
    out = []
    for t, ok in enumerate(OK):
        g = (r.normal(size=17) * (2.0 if t % 2 else 0.05)).astype(np.float32)
        if not ok:
            g[3] = NAN
        out.append(g)
    return out


@pytest.mark.parametrize("clip", [0.0, 1.0], ids=["noclip", "clip1"])
@pytest.mark.parametrize("rule", sorted(RULES))
def test_gated_update_is_exact_both_ways(rule, clip, monkeypatch):
    p0 = np.random.RandomState(5).normal(size=17).astype(np.float32)
    gated, plain = _port(rule, "cosine", clip), _port(rule, "cosine", clip)
    pg = {k: torch.from_numpy(v.copy()) for k, v in _tree(p0).items()}
    pp = {k: torch.from_numpy(v.copy()) for k, v in _tree(p0).items()}
    gated.init(pg)
    plain.init(pp)
    ref = _reference(rule, "cosine", clip, monkeypatch)
    jp = {k: jnp.asarray(v) for k, v in _tree(p0).items()}
    js = JaxState(params=jp, opt_state=ref.init(jp), batch_stats=None,
                  step=jnp.asarray(1, jnp.int32))
    for t, (ok, g) in enumerate(zip(OK, _grads())):
        before = {k: v.clone() for k, v in
                  {**pg, **gated.tensors()}.items()}
        gated.step_flat(pg, torch.from_numpy(g), LAYOUT,
                        ok=torch.tensor(ok))
        if ok:  # the ungated update on the trusted steps alone
            plain.step_flat(pp, torch.from_numpy(g), LAYOUT)
            for k, v in {**pp, **plain.tensors()}.items():
                assert torch.equal({**pg, **gated.tensors()}[k], v), (t, k)
        else:
            for k, v in {**pg, **gated.tensors()}.items():
                assert torch.equal(v, before[k]), (t, k)
        upd, new_opt = ref.update(
            {k: jnp.asarray(v) for k, v in _tree(g).items()},
            js.opt_state, js.params)
        new = js._replace(params={k: js.params[k] + upd[k] for k in jp},
                          opt_state=new_opt, step=js.step + 1)
        js = ref_guards.select_state(jnp.asarray(ok), new, js)
        for k in pg:
            np.testing.assert_allclose(pg[k].numpy(),
                                       np.asarray(js.params[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"step {t} {k}")
    counts = {int(x) for x in jax.tree.leaves(js.opt_state)
              if np.ndim(x) == 0 and np.asarray(x).dtype == np.int32}
    assert counts == {sum(OK)} and int(gated.count) == sum(OK)
    assert int(js.step) == len(OK) + 1
