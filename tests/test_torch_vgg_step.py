"""The port's coded steps on VGG-11 and LeNet against the JAX package's
``train_step`` on a one-device mesh (ROADMAP Queue C: at batch 1 on a
multi-device mesh the reference computes some workers' gradients wrongly),
at batch 2 per worker:

  vgg_shared      preset cyclic-vgg11's code (n=9, s=2, a constant attack
                  on two workers a step) at redundancy="shared"
  lenet_simulate  the same code under "simulate" (45 LeNet lanes; LeNet's
                  d = 431,080 keeps it cheap)
  vgg_simulate    VGG-11 under "simulate" at n=5, s=1
  single_lenet    preset single-lenet (n=1, the mean) at batch 2

This file runs ``vgg_shared`` and the chunk; ``test_torch_vgg_simulate_step
.py`` the other three (the reference's compiles keep each file near a
minute on one core).

Both packages start from the same weights (``params.from_jax``) and take
the same batches; the port draws the reference's own augmentation draws,
random projection and dropout masks itself. The masks are held bit for
bit to the reference's: for batch row k of step t, the masks its
``nn.Dropout`` draws under the key the step folds for (seed + 3, t, k),
drawn by a method interceptor as ``nn.Dropout.__call__`` draws them. Two
steps a leg, the port starting each from the reference's state
(parameters, momentum).

Tolerances, as ``test_torch_step.py``'s: the discrete decode columns
equal; loss rtol 1e-4; the parameter update (−lr × the decoded gradient,
with momentum on step 2) within 1e-2 relative L2 (a unit within rounding
of a ReLU kink lands on either side in the two frameworks at batch 2).
A K=2 chunk of ``vgg_shared`` (its dropout masks drawn on the device from
the staged step) is held bit for bit to its two eager steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from test_torch_step import _flat_params, _resync

from draco_tpu import rng as jrng
from draco_tpu.config import TrainConfig as JaxConfig
from draco_tpu.models import build_model as jax_build_model
from draco_tpu.runtime import make_mesh
from draco_tpu.training.step import build_train_setup as jax_setup
from draco_tpu_torch import params as params_mod
from draco_tpu_torch import rng
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.data import batching, datasets
from draco_tpu_torch.ops import draws
from draco_tpu_torch.training.step import build_train_setup

torch.set_num_threads(1)

SEED = 428
B = 2
CODE9 = dict(approach="cyclic", num_workers=9, worker_fail=2,
             err_mode="constant")
LEGS = {
    "vgg_shared": dict(CODE9, network="VGG11", dataset="synthetic-cifar10",
                       redundancy="shared"),
    "lenet_simulate": dict(CODE9, network="LeNet", dataset="synthetic-mnist",
                           redundancy="simulate"),
    "vgg_simulate": dict(network="VGG11", dataset="synthetic-cifar10",
                         approach="cyclic", redundancy="simulate",
                         num_workers=5, worker_fail=1, err_mode="constant"),
    "single_lenet": dict(network="LeNet", dataset="synthetic-mnist",
                         approach="baseline", mode="normal", num_workers=1,
                         worker_fail=0),
}
COMMON = dict(batch_size=B, lr=0.01, momentum=0.9, max_steps=3,
              train_dir="", seed=SEED)


@pytest.fixture(scope="module")
def data():
    return {name: datasets.load_dataset(name, synthetic_train=256,
                                        synthetic_test=8)
            for name in ("synthetic-cifar10", "synthetic-mnist")}


def jax_dropout_masks(network, step, rows):
    """(rows, 2, B, 512) bool: the masks the reference's VGG draws for
    batch row k of ``step`` (its key folded from (seed + 3, step, k)).
    The masks depend on the key and the shapes alone: the model runs on
    zero weights, jitted, and XLA keeps only the draws."""
    jm = jax_build_model(network)
    x = jnp.zeros((B, 32, 32, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, x,
        train=True))
    variables = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype), shapes)

    @jax.jit
    def masks_of(k):
        masks = []

        def icpt(next_fun, args, kwargs, context):
            # in place of nn.Dropout.__call__: its draw, recorded traced
            # (test_torch_models_cnn.dropout_interceptor's)
            mod = context.module
            if not isinstance(mod, nn.Dropout) or context.method_name != \
                    "__call__":
                return next_fun(*args, **kwargs)
            keep = jax.random.bernoulli(mod.make_rng(mod.rng_collection),
                                        p=1.0 - mod.rate, shape=args[0].shape)
            masks.append(keep)
            return jax.lax.select(keep, args[0] / (1.0 - mod.rate),
                                  jnp.zeros_like(args[0]))

        with nn.intercept_methods(icpt):
            jm.apply(variables, x, train=True, rngs={"dropout": jrng.fold(
                jax.random.key(SEED + 3), jnp.int32(step), k)})
        return jnp.stack(masks)

    return torch.from_numpy(np.stack([np.asarray(masks_of(jnp.int32(k)))
                                      for k in range(rows)]))


@pytest.fixture(scope="module", params=["vgg_shared"])
def leg(request, data):
    return run_leg(request.param, data)


def run_leg(name, data):
    """Two steps of leg ``name`` in both packages, each from the
    reference's state: per step the metrics and the flat parameters
    before and after (the reference's layout)."""
    kw = dict(COMMON, **LEGS[name])
    ds = data[kw["dataset"]]
    n = kw["num_workers"]
    cfg = TrainConfig(**kw)
    jset = jax_setup(JaxConfig(eval_freq=0, log_every=1000,
                               decode_impl="pallas", **kw), make_mesh(1))
    jstate = jset.state
    stats = (None if jstate.batch_stats is None
             else jax.device_get(jstate.batch_stats))
    init = params_mod.from_jax(jax.device_get(jstate.params), stats)
    tset = build_train_setup(cfg, device="cpu", dataset_name=ds.name,
                             init=init)
    tstate, lay = tset.state, tset.layout
    assert tset.dim == jset.dim
    adv = rng.adversary_schedule(SEED, kw["max_steps"], n,
                                 cfg.num_adversaries)
    pick = (batching.indices_baseline if cfg.approach == "baseline"
            else batching.indices_cyclic)
    vgg = kw["network"].startswith("VGG")
    rec = {"steps": [], "cfg": cfg, "names": tset.metric_names}
    before = init[0]
    for step in (1, 2):
        x, y = batching.gather(ds, pick(len(ds), step - 1, n, B, SEED), n,
                               B)
        jstate, jm = jset.train_step(jstate, jnp.asarray(x), jnp.asarray(y),
                                     jnp.asarray(adv[step]))
        tstate, tm = tset.train_step(tstate, x, y, adv[step])
        if vgg:
            # the masks the port's step drew are the reference's
            keep = draws.dropout_keep(
                torch.tensor(step, dtype=torch.int32),
                SEED + draws.DROPOUT_SALT, n, 2, B, 512)
            assert torch.equal(keep, jax_dropout_masks(kw["network"], step,
                                                       n))
        rec["steps"].append({
            "jax": {k: float(v) for k, v in jm.items()
                    if k in tset.metric_names},
            "port": {k: float(v) for k, v in tm.items()},
            "before": _flat_params(before, lay),
            "port_p": _flat_params(tstate.params, lay)})
        before = _resync(tstate, jstate)
        rec["steps"][-1]["jax_p"] = _flat_params(before, lay)
    return name, rec


def test_metric_columns(leg):
    name, rec = leg
    cfg = rec["cfg"]
    for st in rec["steps"]:
        assert tuple(st["port"]) == rec["names"]
        assert set(st["jax"]) == set(rec["names"])
        assert st["port"]["loss"] == pytest.approx(st["jax"]["loss"],
                                                   rel=1e-4)
        if cfg.approach != "cyclic":
            continue
        for k in ("honest_located", "located_errors", "det_tp", "det_adv"):
            assert st["port"][k] == st["jax"][k], k
        assert st["port"]["honest_located"] == cfg.num_workers - 2 * \
            cfg.worker_fail
        assert st["port"]["located_errors"] == st["port"]["det_tp"] == \
            st["port"]["det_adv"] == cfg.num_adversaries


def test_updates_and_params(leg):
    _, rec = leg
    for st in rec["steps"]:
        d_port, d_jax = st["port_p"] - st["before"], st["jax_p"] - st["before"]
        assert np.linalg.norm(d_jax) > 0
        assert np.linalg.norm(d_port - d_jax) <= 1e-2 * np.linalg.norm(d_jax)


def test_vgg_chunk_is_its_eager_steps(data):
    """K=2: the chunk stages the step numbers and no masks (each step
    draws its dropout masks on the device from (seed + 3, step, row)) and
    gives the two eager steps' metrics and state bit for bit."""
    kw = dict(COMMON, **LEGS["vgg_shared"], steps_per_call=2)
    ds = data["synthetic-cifar10"]
    cfg = TrainConfig(**kw)
    a, b = (build_train_setup(cfg, device="cpu", dataset_name=ds.name)
            for _ in range(2))
    n = cfg.num_workers
    adv = rng.adversary_schedule(SEED, kw["max_steps"], n, 2)
    xs, ys = zip(*[batching.gather(ds, batching.indices_cyclic(
        len(ds), s - 1, n, B, SEED), n, B) for s in (1, 2)])
    recs, state = [], a.state
    for i in range(2):
        state, m = a.train_step(state, xs[i], ys[i], adv[1 + i])
        recs.append([float(m[k]) for k in a.block_names])
    chunk = b.make_chunk(1, np.stack(xs), np.stack(ys), adv[1:3])
    assert "dropout" not in chunk.tensors
    assert chunk.tensors["step"].tolist() == [1, 2]
    _, block = b.train_many(b.state, chunk)
    assert block.tolist() == recs
    sa, sb = a.state.tensors(), b.state.tensors()
    assert set(sa) == set(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
