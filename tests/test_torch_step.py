"""The port's training step against the JAX package's, and the pieces that
must match the reference bit for bit.

Step parity: ``draco_tpu.training.step.build_train_setup`` on the virtual
CPU mesh and ``draco_tpu_torch.training.step.build_train_setup`` on the
CPU start from the same weights (``params.from_jax``), take the same
batches and the reference's own augmentation draws and random projection,
and run two steps of each leg, the port starting each step from the
reference's state (parameters, momentum, BN stats): the cyclic step on
ResNet-18 with a rev_grad adversary each step, ``shared`` at n=8 and
``simulate`` at n=5 (the JAX side decodes with ``decode_impl="pallas"``,
the fused locator on the CPU), and the geometric-median baseline at n=4.
The batch is 2 per worker: at batch 1 the reference's step on a
multi-device CPU mesh computes some workers' gradients wrongly (an honest
row fails the codeword fit; on one device it does not), see ROADMAP.md
Queue C.

Tolerances. The discrete decode columns (honest_located, located_errors,
det_tp, det_adv) must be equal. Loss and the per-worker BN running stats
are forward quantities: rtol 1e-4. The parameter update (−lr × the
decoded gradient, with momentum on step 2) agrees to 1e-2 in relative L2
norm (measured 0.12–0.36%): in f32 a pre-activation within rounding of a
ReLU kink can land on the other side of it in one framework, and at batch
2 one such unit moves the gradient by ~0.5% (test_torch_resnet compares
the gradient itself in f64, where it agrees to 1e-6). The parameters then
agree to 1e-4 of their scale coordinate by coordinate (measured up to
3.2e-5: a flipped unit's coordinates move by up to ~1% of the largest
gradient, times lr). The decode residual is f32 noise of an
11M-term projection on both sides: below 1e-4 on both, not equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from draco_tpu import aggregation as jagg
from draco_tpu import attacks as jattacks
from draco_tpu import optim as joptim
from draco_tpu import rng as jrng
from draco_tpu.config import TrainConfig as JaxConfig
from draco_tpu.data import augment as jaug
from draco_tpu.data import batching as jbatching
from draco_tpu.data import datasets as jdatasets
from draco_tpu.runtime import make_mesh
from draco_tpu.training.step import build_train_setup as jax_setup
from draco_tpu_torch import aggregation, attacks, optim, rng
from draco_tpu_torch import params as params_mod
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.data import augment, batching, datasets
from draco_tpu_torch.training.step import build_train_setup

torch.set_num_threads(1)

SEED = 428
T = torch.from_numpy


# --------------------------------------------------------------------------
# bit-for-bit pieces
# --------------------------------------------------------------------------

def test_schedules_bit_for_bit():
    for args in ((SEED, 20, 8, 1), (7, 5, 5, 2), (SEED, 3, 8, 0)):
        np.testing.assert_array_equal(rng.adversary_schedule(*args),
                                      jrng.adversary_schedule(*args))
        np.testing.assert_array_equal(rng.straggler_schedule(*args),
                                      jrng.straggler_schedule(*args))
    np.testing.assert_array_equal(rng.group_seeds(SEED, 5),
                                  jrng.group_seeds(SEED, 5))
    np.testing.assert_array_equal(rng.epoch_permutation(SEED, 3, 100),
                                  jrng.epoch_permutation(SEED, 3, 100))


def test_batching_and_data_bit_for_bit():
    ds_t = datasets.load_dataset("synthetic-cifar10", synthetic_train=200,
                                 synthetic_test=8)
    ds_j = jdatasets.load_dataset("synthetic-cifar10", synthetic_train=200,
                                  synthetic_test=8)
    np.testing.assert_array_equal(ds_t.train_x, ds_j.train_x)
    np.testing.assert_array_equal(ds_t.train_y, ds_j.train_y)
    for step in (0, 1, 7, 30):
        for a, b in ((batching.indices_cyclic, jbatching.indices_cyclic),
                     (batching.indices_baseline, jbatching.indices_baseline)):
            np.testing.assert_array_equal(a(200, step, 8, 4, SEED),
                                          b(200, step, 8, 4, SEED))
    idx = batching.indices_cyclic(200, 3, 8, 4, SEED)
    for a, b in zip(batching.gather(ds_t, idx, 8, 4),
                    jbatching.gather(ds_j, idx, 8, 4)):
        np.testing.assert_array_equal(a, b)


def jax_aug_draws(seed, step, rows, batch):
    """The reference's per-sample (top, left, flip) draws of augment_batch
    under the key its step folds for (step, row)."""
    def one(key):
        kh, kw, kf = jax.random.split(key, 3)
        return (jax.random.randint(kh, (), 0, 9),
                jax.random.randint(kw, (), 0, 9), jax.random.bernoulli(kf))

    out = [jax.vmap(one)(jax.random.split(
        jrng.fold(jax.random.key(seed + 2), jnp.int32(step), jnp.int32(k)),
        batch)) for k in range(rows)]
    return tuple(T(np.stack([np.asarray(o[i]) for o in out]).astype(np.int64))
                 for i in range(3))


def test_augment_with_the_references_draws():
    x = np.random.RandomState(0).normal(size=(3, 4, 32, 32, 3)).astype(
        np.float32)
    draws = jax_aug_draws(SEED, 5, 3, 4)
    ref = np.stack([np.asarray(jaug.augment_batch(
        jnp.asarray(x[k]),
        jrng.fold(jax.random.key(SEED + 2), jnp.int32(5), jnp.int32(k))))
        for k in range(3)])
    np.testing.assert_array_equal(augment.augment(T(x), *draws).numpy(), ref)


@pytest.mark.parametrize("mode", ["rev_grad", "constant", "random"])
def test_attacks_exact(mode):
    rng_np = np.random.RandomState(1)
    g = rng_np.normal(size=(6, 50)).astype(np.float32)
    gi = rng_np.normal(size=(6, 50)).astype(np.float32)
    mask = np.array([0, 1, 0, 0, 1, 0], bool)
    key = jattacks.random_key(SEED, 3)
    noise_p = noise_c = None
    if mode == "random":
        noise_p = T(np.array(jax.random.normal(key, g.shape)))
        kr, ki = jax.random.split(key)
        noise_c = (T(np.array(jax.random.normal(kr, g.shape))),
                   T(np.array(jax.random.normal(ki, g.shape))))
    ref = jattacks.inject_plain(jnp.asarray(g), jnp.asarray(mask), mode,
                                step=3, seed=SEED)
    out = attacks.inject_plain(T(g), T(mask), mode, noise=noise_p)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    ref = jattacks.inject_cyclic(jnp.asarray(g), jnp.asarray(gi),
                                 jnp.asarray(mask), mode, step=3, seed=SEED)
    out = attacks.inject_cyclic(T(g), T(gi), T(mask), mode, noise=noise_c)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_random_attack_needs_noise_or_generator():
    with pytest.raises(ValueError, match="generator"):
        attacks.inject_plain(torch.zeros(2, 3), torch.ones(2, dtype=bool),
                             "random")
    g = attacks.random_generator(SEED, 1)
    out = attacks.inject_plain(torch.zeros(2, 3), torch.tensor([True, False]),
                               "random", generator=g)
    assert out[0].abs().sum() > 0 and out[1].abs().sum() == 0


def test_sgd_momentum_matches():
    """torch SGD semantics: buf = g, then μ·buf + g; p −= lr·buf. The same
    f32 operations in the same order: rtol 1e-6."""
    rng_np = np.random.RandomState(2)
    p = {"w": rng_np.normal(size=(4, 3)).astype(np.float32)}
    gs = [{"w": rng_np.normal(size=(4, 3)).astype(np.float32)}
          for _ in range(3)]
    opt = joptim.sgd_modified(0.05, momentum=0.9)
    jp, js = {"w": jnp.asarray(p["w"])}, None
    js = opt.init(jp)
    tp = {"w": T(p["w"].copy())}
    topt = optim.SGD(0.05, 0.9)
    for g in gs:
        upd, js = opt.update({"w": jnp.asarray(g["w"])}, js, jp)
        jp = {"w": jp["w"] + upd["w"]}
        topt.step(tp, {"w": T(g["w"])})
        np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                                   rtol=1e-6)


def test_aggregation_matches():
    """Mean, and 80 Weiszfeld iterations from the mean: f32 reductions in
    another order, rtol 1e-5."""
    g = np.random.RandomState(3).normal(size=(7, 40)).astype(np.float32)
    g[2] *= -100.0
    np.testing.assert_allclose(aggregation.mean(T(g)).numpy(),
                               np.asarray(jagg.mean(jnp.asarray(g))),
                               rtol=1e-6)
    np.testing.assert_allclose(
        aggregation.geometric_median(T(g)).numpy(),
        np.asarray(jagg.geometric_median(jnp.asarray(g))), rtol=1e-5,
        atol=1e-6)


# --------------------------------------------------------------------------
# the step
# --------------------------------------------------------------------------

COMMON = dict(network="ResNet18", dataset="synthetic-cifar10", lr=0.01,
              momentum=0.9, worker_fail=1, err_mode="rev_grad", max_steps=3,
              train_dir="", seed=SEED)
LEGS = {
    "shared": dict(approach="cyclic", redundancy="shared", num_workers=8,
                   batch_size=2),
    "simulate": dict(approach="cyclic", redundancy="simulate", num_workers=5,
                     batch_size=2),
    "geomedian": dict(approach="baseline", mode="geometric_median",
                      num_workers=4, batch_size=2, geomedian_iters=8),
}


@pytest.fixture(scope="module")
def ds():
    return datasets.load_dataset("synthetic-cifar10", synthetic_train=256,
                                 synthetic_test=8)


def _flat_params(params, lay):
    return params_mod.flatten(params, lay).numpy()


def _momentum(opt_state):
    """The reference's SGD momentum buffers, wherever optax nests them."""
    if isinstance(opt_state, joptim.SGDState):
        return opt_state.momentum_buf
    for part in opt_state:
        found = _momentum(part)
        if found is not None:
            return found
    return None


def _resync(tstate, jstate):
    """Hand the port the reference's state (params, momentum, BN stats), so
    the next step is compared from one state and f32 differences do not
    compound across steps."""
    params, stats = params_mod.from_jax(jax.device_get(jstate.params),
                                        jax.device_get(jstate.batch_stats))
    bufs, _ = params_mod.from_jax(jax.device_get(_momentum(jstate.opt_state)))
    for k, v in params.items():
        tstate.params[k].copy_(v)
    tstate.opt.bufs = bufs
    tstate.stats = stats
    return params


@pytest.fixture(scope="module", params=sorted(LEGS))
def leg(request, ds):
    """Two steps of one leg in both packages, each step from the
    reference's state; per step the metrics, the flat parameters before
    and after (the reference's layout) and the per-worker BN stats."""
    kw = dict(COMMON, **LEGS[request.param])
    n, b = kw["num_workers"], kw["batch_size"]
    jcfg = JaxConfig(eval_freq=0, log_every=1000, decode_impl="pallas", **kw)
    jset = jax_setup(jcfg, make_mesh(n))
    jstate = jset.state
    init = params_mod.from_jax(jax.device_get(jstate.params),
                               jax.device_get(jstate.batch_stats))
    tset = build_train_setup(TrainConfig(**kw), device="cpu",
                             dataset_name=ds.name, init=init)
    tstate = tset.state
    lay = tset.layout
    adv = rng.adversary_schedule(SEED, kw["max_steps"], n, 1)
    rf = np.array(jrng.random_projection_factors_in_graph(SEED, tset.dim))
    pick = (batching.indices_baseline if kw["approach"] == "baseline"
            else batching.indices_cyclic)
    rec = {"steps": [], "n": n, "names": tset.metric_names}
    before = init[0]
    for step in (1, 2):
        x, y = batching.gather(ds, pick(len(ds), step - 1, n, b, SEED), n, b)
        jstate, jm = jset.train_step(jstate, jnp.asarray(x), jnp.asarray(y),
                                     jnp.asarray(adv[step]))
        tstate, tm = tset.train_step(tstate, x, y, adv[step],
                                     aug_draws=jax_aug_draws(SEED, step, n, b),
                                     rand_factor=rf)
        rec["steps"].append({
            "jax": {k: float(v) for k, v in jm.items()
                    if k in tset.metric_names},
            "port": {k: float(v) for k, v in tm.items()},
            "before": _flat_params(before, lay),
            "port_p": _flat_params(tstate.params, lay),
            "port_stats": {k: v.numpy().copy()
                           for k, v in tstate.stats.items()},
        })
        before = _resync(tstate, jstate)
        rec["steps"][-1]["jax_p"] = _flat_params(before, lay)
        rec["steps"][-1]["jax_stats"] = {k: v.numpy()
                                         for k, v in tstate.stats.items()}
    return request.param, rec


def test_metric_columns(leg):
    name, rec = leg
    for st in rec["steps"]:
        assert tuple(st["port"]) == rec["names"]
        assert set(st["jax"]) == set(rec["names"])
        assert st["port"]["loss"] == pytest.approx(st["jax"]["loss"],
                                                   rel=1e-4)
        assert st["port"]["prec1"] == pytest.approx(st["jax"]["prec1"],
                                                    abs=1e-6)
        if name == "geomedian":
            continue
        for k in ("honest_located", "located_errors", "det_tp", "det_adv"):
            assert st["port"][k] == st["jax"][k], k
        assert st["port"]["honest_located"] == rec["n"] - 2
        assert st["port"]["det_tp"] == st["port"]["det_adv"] == 1
        # f32 noise of an 11M-term projection on both sides, not equal
        assert st["port"]["decode_residual"] < 1e-4
        assert st["jax"]["decode_residual"] < 1e-4


def test_updates_and_params(leg):
    _, rec = leg
    for st in rec["steps"]:
        d_port, d_jax = st["port_p"] - st["before"], st["jax_p"] - st["before"]
        assert np.linalg.norm(d_jax) > 0
        assert np.linalg.norm(d_port - d_jax) <= 1e-2 * np.linalg.norm(d_jax)
        np.testing.assert_allclose(st["port_p"], st["jax_p"], rtol=0,
                                   atol=1e-4 * np.abs(st["jax_p"]).max())


def test_per_worker_batchnorm_stats(leg):
    _, rec = leg
    for st in rec["steps"]:
        assert set(st["port_stats"]) == set(st["jax_stats"])
        for k, v in st["jax_stats"].items():
            assert st["port_stats"][k].shape == v.shape == (rec["n"],
                                                            v.shape[1])
            np.testing.assert_allclose(st["port_stats"][k], v, rtol=1e-4,
                                       atol=1e-5 * max(np.abs(v).max(), 1))


# --------------------------------------------------------------------------
# configuration and device rules
# --------------------------------------------------------------------------

@pytest.mark.parametrize("override", [
    {"wire_dtype": "bf16"}, {"wire_segments": 2}, {"topology": "tree"},
    {"decode_granularity": "layer"}, {"decode_impl": "xla"},
    {"network": "LeNet"}, {"approach": "baseline", "mode": "krum"},
    {"err_mode": "alie"}, {"approach": "maj_vote"}, {"adversary_count": 2}],
    ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_config_rejects_what_is_not_ported(override):
    base = dict(COMMON, approach="cyclic", num_workers=8)
    TrainConfig(**base).validate()
    with pytest.raises(ValueError):
        TrainConfig(**dict(base, **override)).validate()


def test_presets_match_the_reference():
    from draco_tpu import presets as jpresets
    from draco_tpu_torch import presets

    for name in ("cyclic-resnet18", "geomedian-resnet18"):
        port = presets.get_preset(name, num_workers=8)
        ref = jpresets.get_preset(name, num_workers=8)
        for field in ("network", "dataset", "approach", "mode",
                      "num_workers", "worker_fail", "err_mode", "batch_size",
                      "lr", "momentum", "redundancy", "decode_granularity",
                      "decode_impl", "seed", "geomedian_iters"):
            assert getattr(port, field) == getattr(ref, field), field


def test_cuda_without_a_card_raises():
    from draco_tpu_torch.ops.decode_kernels import resolve_decode_impl
    from draco_tpu_torch.runtime import resolve_device

    assert resolve_decode_impl("auto", "cpu") == "plain"
    assert resolve_decode_impl("pallas", "cuda") == "cuda"
    with pytest.raises(ValueError):
        resolve_decode_impl("xla", "cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="cuda"):
        build_train_setup(TrainConfig(**dict(COMMON, approach="cyclic")))
