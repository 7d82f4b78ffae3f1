"""The port's LeNet, FC, VGG-11 and VGG-11-BN (``draco_tpu_torch.models``)
against the JAX package's Flax models: the same weights carried over by
``params.from_jax``, one lane's forward and value-and-grad at batch 2, the
flat gradient in the reference's leaf order and layout, the new BatchNorm
running statistics, and the same dropout masks.

The dropout masks are the reference's own: a method interceptor
(``flax.linen.intercept_methods``) runs in place of ``nn.Dropout.__call__``
what that method runs — ``make_rng("dropout")``, ``random.bernoulli`` at
keep 0.5, a select of x / 0.5 — and records the mask, which the port takes
as its ``dropout`` input. The interceptor's forward is held bit for bit to
Flax's own.

Tolerances, and why:
  * float32 logits, loss and running statistics: rtol 1e-4 (absolute floor
    1e-5 of the largest magnitude): both sides sum the convolutions in
    other orders.
  * the gradient in float64 (the f32 gradient is chaotic at ReLU kinks at
    batch 2, ``test_torch_resnet.py``): 1e-6 relative, the one f32 cast the
    reference makes before its classifier.
  * bfloat16 compute: each convolution and Dense layer rounds its output to
    8 significant bits after summing in float32 in another order than
    XLA's; an output one ulp (2^-8 relative) apart moves the layers after
    it, and at batch 2 it flips units at ReLU kinks. On LeNet and FC the
    two packages' bf16 gradients agree to 1e-3 relative L2; through VGG's
    eight convolutions the rounding compounds, and the two bf16 gradients
    lie as far apart as bf16 lies from float32. So: logits within 3e-2 of
    the largest (measured ≤ 8e-3), and the port's bf16 gradient no
    further from the reference's bf16 gradient than that one is from the
    reference's float32 gradient (measured: 0.03×, 0.00×, 0.54× and 0.70×
    of it on LeNet, FC, VGG11, VGG11_bn); the gradient is float32 on both
    sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from torch.func import functional_call, grad_and_value

from draco_tpu.models import build_model as jax_build_model
from draco_tpu_torch import params as params_mod
from draco_tpu_torch.models import build_model, input_shape

torch.set_num_threads(1)

B = 2
Y = np.array([3, 7], np.int32)
MODELS = {"LeNet": "synthetic-mnist", "FC": "synthetic-mnist",
          "VGG11": "synthetic-cifar10", "VGG11_bn": "synthetic-cifar10"}
DIMS = {"LeNet": 431_080, "FC": 1_033_510, "VGG11": 9_750_922,
        "VGG11_bn": 9_756_426}
LEAVES = {"LeNet": 8, "FC": 6, "VGG11": 22, "VGG11_bn": 38}


def _ce_jax(logits, y):
    logp = jax.nn.log_softmax(logits)
    return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1))


def _walk(tree, path=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _walk(tree[k], path + (k,))
        else:
            yield path + (k,), np.asarray(tree[k])


def dropout_interceptor(record=None, masks=None):
    """In place of ``nn.Dropout.__call__``: draw the mask as the method
    does and record it, or apply ``masks`` (in call order)."""
    calls = []

    def icpt(next_fun, args, kwargs, context):
        mod = context.module
        if not isinstance(mod, nn.Dropout) or context.method_name != \
                "__call__":
            return next_fun(*args, **kwargs)
        x = args[0]
        keep_prob = 1.0 - mod.rate
        if masks is None:
            keep = jax.random.bernoulli(mod.make_rng(mod.rng_collection),
                                        p=keep_prob, shape=x.shape)
            record.append(np.asarray(keep))
        else:
            keep = jnp.asarray(masks[len(calls)])
        calls.append(1)
        return jax.lax.select(keep, x / keep_prob, jnp.zeros_like(x))

    return icpt


def reference(name, jdt, x, masks):
    """The Flax model at ``jdt``: params, stats, the loss, logits, new
    stats and the flat gradient (``jax.tree.leaves`` order)."""
    jm = jax_build_model(name, dtype=jdt)
    k = jax.random.key(5)
    variables = jm.init({"params": k, "dropout": k}, jnp.asarray(x),
                        train=True)
    pdt = jnp.float64 if jdt == jnp.float64 else jnp.float32
    params = jax.tree.map(lambda a: a.astype(pdt), variables["params"])
    rng = np.random.RandomState(4)
    stats = jax.tree.map(
        lambda s: (s + 0.1 * rng.normal(size=s.shape)).astype(pdt),
        variables.get("batch_stats", {}))
    bn = bool(stats)

    def loss_fn(p):
        vs = {"params": p, **({"batch_stats": stats} if bn else {})}
        with nn.intercept_methods(dropout_interceptor(masks=masks)):
            out = jm.apply(vs, jnp.asarray(x), train=True,
                           mutable=["batch_stats"] if bn else False,
                           rngs={"dropout": jax.random.key(9)})
        logits, mut = out if bn else (out, {})
        return _ce_jax(logits, jnp.asarray(Y)), (logits,
                                                 mut.get("batch_stats", {}))

    (loss, (logits, new_stats)), g = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    return {"params": jax.device_get(params),
            "stats": jax.device_get(stats), "loss": float(loss),
            "logits": np.asarray(logits, np.float64),
            "new_stats": {"/".join(p): v for p, v in
                          _walk(jax.device_get(new_stats))},
            "flat_grad": np.concatenate([np.ravel(np.asarray(v))
                                         for v in jax.tree.leaves(g)])}


def port(name, ref, x, masks, tdt, compute=None):
    model = build_model(name, MODELS[name], dtype=compute).to(tdt)
    p, st = params_mod.from_jax(ref["params"], ref["stats"])
    p = {k: v.to(tdt) for k, v in p.items()}
    st = {k: v.to(tdt) for k, v in st.items()}
    keep = (torch.from_numpy(np.stack(masks)) if masks else None)

    def tloss(pp, xx, yy):
        logits, new_st = functional_call(model, (pp,), (xx, st, keep))
        loss = -torch.log_softmax(logits, -1).gather(1, yy[:, None]).mean()
        return loss, (logits, new_st)

    g, (loss, (logits, new_st)) = grad_and_value(tloss, has_aux=True)(
        p, torch.from_numpy(x).to(tdt), torch.from_numpy(Y).long())
    lay = params_mod.layout(model)
    return {"loss": float(loss), "logits": logits.detach().double().numpy(),
            "new_stats": {k: v.numpy() for k, v in new_st.items()},
            "flat_grad": params_mod.flatten(g, lay).numpy(), "layout": lay,
            "grad_dtype": g[lay.names[0]].dtype}


@pytest.fixture(scope="module", params=sorted(MODELS))
def pair(request):
    """One model in both packages at float32, float64 and bf16 compute."""
    name = request.param
    x = np.random.RandomState(3).normal(
        size=(B,) + input_shape(MODELS[name])).astype(np.float32)
    # the reference's masks, drawn by its own rng path in a forward pass
    jm = jax_build_model(name)
    k = jax.random.key(5)
    variables = jm.init({"params": k, "dropout": k}, jnp.asarray(x),
                        train=True)
    masks = []
    kw = dict(train=True, rngs={"dropout": jax.random.key(9)},
              mutable=["batch_stats"])
    with nn.intercept_methods(dropout_interceptor(record=masks)):
        seen = jm.apply(variables, jnp.asarray(x), **kw)
    flax_own = jm.apply(variables, jnp.asarray(x), **kw)
    out = {"name": name, "masks": masks,
           "interceptor_is_flax": bool(np.array_equal(
               np.asarray(seen[0]), np.asarray(flax_own[0])))}
    ref32 = reference(name, jnp.float32, x, masks)
    out["f32"] = (ref32, port(name, ref32, x, masks, torch.float32))
    with jax.enable_x64(True):
        ref64 = reference(name, jnp.float64, x.astype(np.float64), masks)
    out["f64"] = (ref64, port(name, ref64, x.astype(np.float64), masks,
                              torch.float64))
    ref16 = reference(name, jnp.bfloat16, x, masks)
    out["bf16"] = (ref16, port(name, ref16, x, masks, torch.float32,
                               compute="bfloat16"))
    return out


def test_layout_is_the_references(pair):
    name = pair["name"]
    ref, prt = pair["f32"]
    lay = prt["layout"]
    assert len(lay.names) == LEAVES[name]
    assert lay.dim == DIMS[name] == prt["flat_grad"].size
    leaves = jax.tree.leaves(ref["params"])
    assert [tuple(v.shape) for v in leaves] == list(lay.jax_shapes)


def test_dropout_masks_are_the_references(pair):
    """VGG's two (B, 512) masks from Flax's own rng path; none elsewhere."""
    masks = pair["masks"]
    if pair["name"].startswith("VGG"):
        assert [m.shape for m in masks] == [(B, 512), (B, 512)]
        assert 0.3 < np.mean(masks) < 0.7
    else:
        assert masks == []
    assert pair["interceptor_is_flax"]


def test_logits_loss_and_stats_f32(pair):
    ref, prt = pair["f32"]
    scale = np.abs(ref["logits"]).max()
    np.testing.assert_allclose(prt["logits"], ref["logits"], rtol=1e-4,
                               atol=1e-5 * scale)
    assert prt["loss"] == pytest.approx(ref["loss"], rel=1e-4)
    assert set(ref["new_stats"]) == set(prt["new_stats"])
    for path, v in ref["new_stats"].items():
        np.testing.assert_allclose(prt["new_stats"][path], v, rtol=1e-4,
                                   atol=1e-5 * max(np.abs(v).max(), 1.0))


def test_flat_gradient_in_reference_order_f64(pair):
    ref, prt = pair["f64"]
    g_ref, g = ref["flat_grad"], prt["flat_grad"]
    assert g.dtype == np.float64 and g.shape == g_ref.shape
    np.testing.assert_allclose(g, g_ref, rtol=0,
                               atol=1e-6 * np.abs(g_ref).max())
    assert np.linalg.norm(g - g_ref) <= 1e-6 * np.linalg.norm(g_ref)
    assert prt["loss"] == pytest.approx(ref["loss"], rel=1e-6)


def test_bf16_compute(pair):
    """Logits and the float32 flat gradient at bf16 compute (module
    docstring)."""
    ref, prt = pair["bf16"]
    assert prt["grad_dtype"] == torch.float32
    assert ref["flat_grad"].dtype == np.float32
    scale = np.abs(ref["logits"]).max()
    np.testing.assert_allclose(prt["logits"], ref["logits"], rtol=0,
                               atol=3e-2 * scale)
    g_ref, g = ref["flat_grad"], prt["flat_grad"]
    bf16_own = np.linalg.norm(g_ref - pair["f32"][0]["flat_grad"])
    assert np.linalg.norm(g - g_ref) <= bf16_own
    for path, v in ref["new_stats"].items():  # float32 statistics
        assert prt["new_stats"][path].dtype == np.float32
        np.testing.assert_allclose(prt["new_stats"][path], v, rtol=3e-2,
                                   atol=3e-2 * max(np.abs(v).max(), 1.0))
