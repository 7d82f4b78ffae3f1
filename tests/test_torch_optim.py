"""The port's optimizers (``draco_tpu_torch.optim``) against the
reference's (``draco_tpu.optim.build_optimizer``): the same random flat
gradients for 12 steps, from the same parameters, under every rule, both
schedules and the clip on and off.

Both sides run the same float32 operations in the same order (the rule at
lr = 1, scaled by the schedule; Adam's bias corrections from the update
count), apart from the summation order of the clip's global norm and the
exactness of XLA's and torch's pow, sqrt and cos: held to 1e-6 relative
(measured: a few ulps). SGD under a constant schedule is held bit for bit
to the SGD the port had before the schedules (below, ``_SGDBefore``), and
a chunk of K=3 steps of a training setup under AdamW, the cosine schedule
and the clip bit for bit to its three eager steps: the update count, the
schedule and the bias corrections replay from the state's tensors.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from draco_tpu import optim as joptim
from draco_tpu_torch import optim
from draco_tpu_torch import params as params_mod
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.data import datasets
from draco_tpu_torch.training.trainer import Trainer

torch.set_num_threads(1)

SHAPES = {"a": (4, 3), "b": (5,)}
LAYOUT = params_mod.Layout(
    names=("a", "b"), kinds=(params_mod.SAME, params_mod.SAME),
    jax_shapes=((4, 3), (5,)), offsets=np.array([0, 12, 17]))
STEPS, LR, WARMUP = 12, 0.05, 3
# (optimizer name, the reference sgd_modified's extra arguments)
RULES = {"sgd": ("sgd", {}), "sgd_nesterov": ("sgd", {"nesterov": True}),
         "sgd_dampening": ("sgd", {"dampening": 0.5}),
         "adam": ("adam", {}), "adamw": ("adamw", {})}


def _grads():
    """12 flat gradients; every other one small, so the clip at 1 both
    acts and does not."""
    r = np.random.RandomState(11)
    return [(r.normal(size=17) * (2.0 if t % 2 else 0.05)).astype(np.float32)
            for t in range(STEPS)]


def _tree(flat):
    return {"a": flat[:12].reshape(4, 3), "b": flat[12:]}


def _reference(rule, schedule, clip, monkeypatch):
    name, extra = RULES[rule]
    if extra:  # build_optimizer's own composition, on the extended rule
        monkeypatch.setattr(joptim, "sgd_modified", functools.partial(
            joptim.sgd_modified, **extra))
    return joptim.build_optimizer(name, LR, momentum=0.9, weight_decay=0.1,
                                  schedule=schedule, warmup_steps=WARMUP
                                  if schedule == "cosine" else 0,
                                  total_steps=STEPS, clip_norm=clip)


def _port(rule, schedule, clip):
    name, extra = RULES[rule]
    warm = WARMUP if schedule == "cosine" else 0
    if not extra:
        return optim.build_optimizer(name, LR, momentum=0.9, weight_decay=0.1,
                                     schedule=schedule, warmup_steps=warm,
                                     total_steps=STEPS, clip_norm=clip)
    return optim.Optimizer(optim.sgd_modified(0.9, **extra),
                           optim.lr_schedule(schedule, LR, warm, STEPS), clip)


@pytest.mark.parametrize("clip", [0.0, 1.0], ids=["noclip", "clip1"])
@pytest.mark.parametrize("schedule", ["constant", "cosine"])
@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_matches_the_reference(rule, schedule, clip, monkeypatch):
    p0 = np.random.RandomState(5).normal(size=17).astype(np.float32)
    ref = _reference(rule, schedule, clip, monkeypatch)
    jp = {k: jnp.asarray(v) for k, v in _tree(p0).items()}
    js = ref.init(jp)
    opt = _port(rule, schedule, clip)
    tp = {k: torch.from_numpy(v.copy()) for k, v in _tree(p0).items()}
    for t, g in enumerate(_grads()):
        upd, js = ref.update({k: jnp.asarray(v) for k, v in _tree(g).items()},
                             js, jp)
        jp = {k: jp[k] + upd[k] for k in jp}
        opt.step_flat(tp, torch.from_numpy(g), LAYOUT)
        for k in jp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {t}, leaf {k}")
    assert int(opt.count) == STEPS and opt.count.dtype == torch.int32
    # the buffers, where the rule keeps them, to 1e-6 of their largest
    # entry (an FMA in XLA's fusion moves an entry by an ulp)
    leaves = [np.asarray(x) for x in jax.tree.leaves(js) if np.ndim(x) > 0]
    ours = [v.numpy() for v in opt.tensors().values() if v.dim() > 0]
    assert len(leaves) == len(ours)
    for a in ours:
        assert any(a.shape == b.shape and np.allclose(
            a, b, rtol=1e-6, atol=1e-6 * np.abs(b).max()) for b in leaves)


def test_dict_step_clips_like_the_flat_step():
    """``step`` on a dict of leaves takes the global norm over the leaves,
    as ``step_flat`` over the flat vector."""
    p0 = np.random.RandomState(5).normal(size=17).astype(np.float32)
    a, b = (optim.build_optimizer("adamw", LR, clip_norm=1.0,
                                  schedule="cosine", warmup_steps=2,
                                  total_steps=STEPS) for _ in range(2))
    pa = {k: torch.from_numpy(v.copy()) for k, v in _tree(p0).items()}
    pb = {k: torch.from_numpy(v.copy()) for k, v in _tree(p0).items()}
    for g in _grads():
        a.step_flat(pa, torch.from_numpy(g), LAYOUT)
        b.step(pb, {k: torch.from_numpy(v) for k, v in _tree(g).items()})
    for k in pa:
        np.testing.assert_allclose(pa[k].numpy(), pb[k].numpy(), rtol=1e-6)


@pytest.mark.parametrize("warmup", [0, 1, 3])
def test_schedule_values(warmup):
    """The schedule at t = 0..15 (past total_steps: the 10% floor) against
    ``lr_schedule``; t an int32 tensor, as the update count."""
    total = 12
    ref = joptim.lr_schedule("cosine", LR, warmup, total)
    ours = optim.lr_schedule("cosine", LR, warmup, total)
    for t in range(16):
        v = ours(torch.tensor(t, dtype=torch.int32))
        assert v.dtype == torch.float32
        np.testing.assert_allclose(float(v), float(ref(t)), rtol=1e-6)
    assert optim.lr_schedule("constant", LR)(torch.tensor(3)) == LR
    if warmup:  # step warmup-1 is at the peak
        assert float(ours(torch.tensor(warmup - 1))) == pytest.approx(LR)


def test_schedule_and_optimizer_refusals():
    with pytest.raises(ValueError, match="unknown lr schedule"):
        optim.lr_schedule("linear", LR)
    with pytest.raises(ValueError, match="needs total_steps > 0"):
        optim.build_optimizer("adam", LR, schedule="cosine", total_steps=0)
    with pytest.raises(ValueError, match="unknown optimizer"):
        optim.build_optimizer("lamb", LR)


class _SGDBefore:
    """The port's SGD before the schedules: buf = μ·buf + g, p −= lr·buf."""

    def __init__(self, lr, momentum):
        self.lr, self.momentum, self.bufs = lr, momentum, None

    def zero_bufs(self, params):
        if self.momentum != 0.0 and self.bufs is None:
            self.bufs = {k: torch.zeros_like(p) for k, p in params.items()}

    def step(self, params, grads):
        if self.momentum != 0.0:
            for k, g in grads.items():
                self.bufs[k].mul_(self.momentum).add_(g)
            d_p = self.bufs
        else:
            d_p = grads
        for k, p in params.items():
            p.sub_(self.lr * d_p[k])


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_constant_sgd_is_the_earlier_sgd_bit_for_bit(momentum):
    p0 = np.random.RandomState(5).normal(size=17).astype(np.float32)
    old, new = _SGDBefore(LR, momentum), optim.SGD(LR, momentum)
    po = {k: torch.from_numpy(v.copy()) for k, v in _tree(p0).items()}
    pn = {k: torch.from_numpy(v.copy()) for k, v in _tree(p0).items()}
    old.zero_bufs(po)
    new.init(pn)
    for g in _grads():
        grads = {k: torch.from_numpy(v) for k, v in _tree(g).items()}
        old.step(po, grads)
        new.step_flat(pn, torch.from_numpy(g), LAYOUT)
        for k in po:
            assert torch.equal(po[k], pn[k])
            if momentum:
                assert torch.equal(old.bufs[k], new.bufs[k])


def _state(tr):
    return {k: v.clone() for k, v in tr.state.tensors().items()}


def test_chunk_replays_count_and_schedule_bit_for_bit():
    """AdamW, cosine with warmup 2, clip 1, on a LeNet baseline setup: a
    K=3 chunk gives its three eager steps' metrics and state bit for bit,
    the update count and both moments included."""
    cfg = TrainConfig(network="LeNet", dataset="synthetic-mnist",
                      approach="baseline", num_workers=2, batch_size=2,
                      optimizer="adamw", lr=1e-3, lr_schedule="cosine",
                      warmup_steps=2, clip_norm=1.0, max_steps=6,
                      steps_per_call=3, train_dir="", seed=428)
    ds = datasets.load_dataset("synthetic-mnist", synthetic_train=64,
                               synthetic_test=8)
    eager, chunked = (Trainer(cfg, device="cpu", dataset=ds, quiet=True)
                      for _ in range(2))
    recs = [eager.step() for _ in range(3)]
    xs, ys, masks = zip(*[eager.inputs(s)[:3] for s in (1, 2, 3)])
    chunk = chunked.setup.make_chunk(1, np.stack(xs), np.stack(ys),
                                     np.stack(masks))
    _, block = chunked.setup.train_many(chunked.state, chunk)
    names = chunked.setup.block_names
    for r, row in zip(recs, block.tolist()):
        assert [r[k] for k in names] == row
    a, b = _state(eager), _state(chunked)
    assert set(a) == set(b) and "opt/count" in a
    assert int(a["opt/count"]) == 3
    for k in a:
        assert torch.equal(a[k], b[k]), k
