"""The port's ResNet-18 (``draco_tpu_torch.models``) against the JAX
package's Flax model: the same weights carried over by ``params.from_jax``,
one lane's forward and value-and-grad at batch 2, the flat gradient in the
reference's leaf order and layout, and the new BatchNorm running stats.

Logits, loss and running stats are compared in f32, the port's working
type: both sides sum the convolutions in other orders, so they agree to
rtol 1e-4 (absolute floor 1e-5 of the largest magnitude). The gradient is
compared in f64: in f32, pre-activations within ~1e-6 of a ReLU kink (they
occur at batch 2; measured down to 1.5e-7) can land on the other side of
it in one of the two frameworks, and one flipped unit moves the whole
upstream gradient by ~0.5% — chaos, not a difference of formula. In f64
no unit sits that close; the reference casts the pooled features to f32
before its classifier, so the gradients agree only to the f32 rounding of
that one cast: held to 1e-6 relative (measured 4e-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call, grad_and_value

from draco_tpu.models import build_model as jax_build_model
from draco_tpu_torch import params as params_mod
from draco_tpu_torch.models import build_model

torch.set_num_threads(1)

B = 2
Y = np.array([3, 7], np.int32)


def _ce_jax(logits, y):
    logp = jax.nn.log_softmax(logits)
    return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1))


def _walk(tree, path=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _walk(tree[k], path + (k,))
        else:
            yield path + (k,), np.asarray(tree[k])


def run_pair(dtype):
    """One lane through both models in ``dtype`` ("float32" | "float64")."""
    rng = np.random.RandomState(3)
    x = rng.normal(size=(B, 32, 32, 3)).astype(dtype)
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    with jax.enable_x64(dtype == "float64"):
        jm = jax_build_model("ResNet18", dtype=jdt)
        variables = jax.jit(lambda k, xx: jm.init({"params": k}, xx,
                                                  train=True))(
            jax.random.key(5), jnp.asarray(x))
        params = jax.tree.map(lambda a: a.astype(jdt), variables["params"])
        # perturbed running stats, so the update is not a function of zeros
        stats = jax.tree.map(
            lambda s: (s + 0.1 * rng.normal(size=s.shape)).astype(jdt),
            variables["batch_stats"])

        def loss_fn(p, st):
            logits, mut = jm.apply({"params": p, "batch_stats": st},
                                   jnp.asarray(x), train=True,
                                   mutable=["batch_stats"])
            return _ce_jax(logits, jnp.asarray(Y)), (logits,
                                                     mut["batch_stats"])

        if dtype == "float64":  # the gradient (module docstring)
            (loss, (logits, new_stats)), g = jax.jit(jax.value_and_grad(
                loss_fn, has_aux=True))(params, stats)
            flat_grad = np.concatenate([np.ravel(v)
                                        for v in jax.tree.leaves(g)])
        else:  # forward only: the compile of the backward is the slow part
            loss, (logits, new_stats) = jax.jit(loss_fn)(params, stats)
            flat_grad = None
        ref = {"params": jax.device_get(params),
               "loss": float(loss), "logits": np.asarray(logits),
               "new_stats": {"/".join(k): v for k, v in
                             _walk(jax.device_get(new_stats))},
               "flat_grad": flat_grad}
        stats_np = jax.device_get(stats)

    tdt = getattr(torch, dtype)
    model = build_model("ResNet18", "synthetic-cifar10").to(tdt)
    p, st = params_mod.from_jax(ref["params"], stats_np)
    p = {k: v.to(tdt) for k, v in p.items()}
    st = {k: v.to(tdt) for k, v in st.items()}

    def tloss(pp, xx, yy):
        logits, new_st = functional_call(model, (pp,), (xx, st))
        loss = -torch.log_softmax(logits, -1).gather(1, yy[:, None]).mean()
        return loss, (logits, new_st)

    g_t, (loss_t, (logits_t, new_st_t)) = grad_and_value(
        tloss, has_aux=True)(p, torch.from_numpy(x),
                             torch.from_numpy(Y).long())
    lay = params_mod.layout(model)
    port = {"loss": float(loss_t), "logits": logits_t.detach().numpy(),
            "new_stats": {k: v.numpy() for k, v in new_st_t.items()},
            "flat_grad": params_mod.flatten(g_t, lay).numpy(),
            "layout": lay, "params": p}
    return ref, port


@pytest.fixture(scope="module")
def f32():
    return run_pair("float32")


@pytest.fixture(scope="module")
def f64():
    return run_pair("float64")


def test_layout_is_the_references(f32):
    ref, port = f32
    lay = port["layout"]
    assert len(lay.names) == 62
    assert lay.dim == 11_173_962 == port["flat_grad"].size
    leaves = jax.tree.leaves(ref["params"])
    assert [tuple(v.shape) for v in leaves] == list(lay.jax_shapes)


def test_params_round_trip_through_the_flat_layout(f32):
    ref, port = f32
    lay = port["layout"]
    flat = params_mod.flatten(port["params"], lay)
    np.testing.assert_array_equal(
        flat.numpy(), np.concatenate([np.ravel(v) for v in
                                      jax.tree.leaves(ref["params"])]))
    back = params_mod.unflatten(flat, lay)
    for k, v in port["params"].items():
        assert torch.equal(back[k], v)


def test_logits_and_loss(f32):
    ref, port = f32
    scale = np.abs(ref["logits"]).max()
    np.testing.assert_allclose(port["logits"], ref["logits"], rtol=1e-4,
                               atol=1e-5 * scale)
    assert port["loss"] == pytest.approx(ref["loss"], rel=1e-4)


def test_batchnorm_running_stats(f32):
    """Flax's momentum 0.9 and the biased batch variance."""
    ref, port = f32
    assert set(ref["new_stats"]) == set(port["new_stats"])
    for path, v in ref["new_stats"].items():
        np.testing.assert_allclose(port["new_stats"][path], v, rtol=1e-4,
                                   atol=1e-5 * max(np.abs(v).max(), 1.0))


def test_flat_gradient_in_reference_order(f64):
    ref, port = f64
    g_ref, g = ref["flat_grad"], port["flat_grad"]
    assert g.dtype == np.float64 and g.shape == g_ref.shape
    np.testing.assert_allclose(g, g_ref, rtol=0,
                               atol=1e-6 * np.abs(g_ref).max())
    assert np.linalg.norm(g - g_ref) <= 1e-6 * np.linalg.norm(g_ref)
    assert port["loss"] == pytest.approx(ref["loss"], rel=1e-6)
