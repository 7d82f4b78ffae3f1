"""The TransformerLM's ``scan_layers`` and ``remat`` against the JAX
package's (draco_tpu/models/transformer.py).

* The scanned initial parameters: the port draws the stacked tree itself
  (``models.layers.init_params``, ``rng.scan_param_key``) and is held to
  Flax's ``model.init(scan_layers=True)`` at ``key(seed)`` leaf for leaf,
  within 1e-6·σ (σ the initialiser's scale, as in
  ``test_torch_stream_init.py``); scales and biases exact.
* The scanned logits against the reference's scanned model on the same
  parameters: 1e-5 absolute.
* ``params.flatten`` of the stacked tree: the reference's
  ``_flatten_tree`` order, bit for bit.
* ``remat``: the gradients of the lanes' loss under the step's
  ``torch.func.vmap(grad_and_value(...))`` bit for bit the non-remat
  gradients in float32, unrolled and scanned, dense and flash; and
  against the reference's ``nn.remat`` gradients, 1e-5 of the gradient's
  scale.
* A ``.dcg`` of a scanned LM state read across the packages leaf for leaf
  bit for bit, and a resume across the two layer layouts refused.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call, grad_and_value, vmap

from draco_tpu import rng as jrng
from draco_tpu.config import TrainConfig as JaxConfig
from draco_tpu.models.transformer import TransformerLM as JaxLM
from draco_tpu.parallel.mesh import make_mesh_2d
from draco_tpu.parallel.sp_step import build_sp_train_setup as jax_lm
from draco_tpu.parallel.sp_step import synthetic_text
from draco_tpu.training.step import _flatten_tree
from draco_tpu.utils import checkpoint as jckpt
from draco_tpu_torch import params as params_mod
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.models import transformer as tmod
from draco_tpu_torch.models.layers import init_params
from draco_tpu_torch.models.transformer import TransformerLM
from draco_tpu_torch.ops.flash_attention import flash_attention
from draco_tpu_torch.parallel.sp_step import build_sp_train_setup, train_sp
from draco_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

SEED = 428
ARCH = dict(vocab=64, dim=32, heads=2, layers=3)


def _scale(name: str, leaf: np.ndarray, stacked: bool) -> float:
    """The leaf's initialiser scale σ (Flax layout; a stacked leaf's
    fan-in is its layer's)."""
    if name.endswith("embedding"):
        return float(np.sqrt(1.0 / leaf.shape[-1]))
    fan = leaf.shape[1:-1] if stacked else leaf.shape[:-1]
    return float(np.sqrt(1.0 / np.prod(fan)) / 0.87962566103423978)


def _jax_init(scan: bool, layers: int = 3):
    jm = JaxLM(**dict(ARCH, layers=layers), scan_layers=scan)
    ref = jax.jit(jm.init)({"params": jax.random.key(SEED)},
                           jnp.zeros((1, 8), jnp.int32))
    return jm, jax.device_get(ref["params"])


def _port(scan: bool, remat: bool = False, attn=None, layers: int = 3,
          params=None):
    tm = TransformerLM(**dict(ARCH, layers=layers), scan_layers=scan,
                       remat=remat, attn_fn=attn)
    if params is None:
        init_params(tm, SEED)
    else:
        with torch.no_grad():
            for n, p in tm.named_parameters():
                p.copy_(params[n])
    return tm


@pytest.mark.parametrize("layers", [1, 3])
def test_scanned_initial_parameters_are_flax_init(layers):
    _, ref = _jax_init(True, layers)
    want, _ = params_mod.from_jax(ref)
    tm = _port(True, layers=layers)
    lay = params_mod.layout(tm)
    assert set(want) == set(lay.names)
    got = dict(tm.named_parameters())
    for (path, leaf), name in zip(
            jax.tree_util.tree_flatten_with_path(ref)[0], lay.names):
        flax_name = "/".join(k.key for k in path)
        g, w = got[name].detach(), want[name]
        assert g.shape == w.shape, name
        assert g.shape[0] == layers or not name.startswith("blocks")
        if flax_name.endswith(("kernel", "embedding")):
            sigma = _scale(flax_name, np.asarray(leaf),
                           name.startswith("blocks"))
            assert float((g - w).abs().max()) <= 1e-6 * sigma, name
        else:
            assert torch.equal(g, w), name
    # each layer its own draw: the scanned tree is not the unrolled one
    # restacked
    _, unrolled = _jax_init(False, layers)
    if layers > 1:
        assert not np.allclose(ref["blocks"]["qkv"]["kernel"][0],
                               unrolled["block0"]["qkv"]["kernel"])
    np.testing.assert_array_equal(ref["embed"]["embedding"],
                                  unrolled["embed"]["embedding"])


def test_scanned_logits_and_flatten_match_reference():
    jm, ref = _jax_init(True)
    want, _ = params_mod.from_jax(ref)
    tm = _port(True, params=want)
    toks = np.random.RandomState(1).randint(0, ARCH["vocab"], (2, 16))
    j_logits = np.asarray(jax.jit(jm.apply)({"params": ref},
                                            jnp.asarray(toks)))
    t_logits = tm(torch.as_tensor(toks)).detach().numpy()
    np.testing.assert_allclose(t_logits, j_logits, rtol=0, atol=1e-5)
    lay = params_mod.layout(tm)
    assert lay.names[:2] == ("blocks.LayerNorm_0.weight",
                             "blocks.LayerNorm_1.weight")
    assert lay.names[-2:] == ("embed.weight", "final_ln.weight")
    flat = params_mod.flatten({n: p.detach() for n, p in
                               tm.named_parameters()}, lay)
    np.testing.assert_array_equal(flat.numpy(),
                                  np.asarray(_flatten_tree(ref)))
    back = params_mod.unflatten(flat, lay)
    for n, p in tm.named_parameters():
        assert torch.equal(back[n], p.detach()), n


TOKS = np.random.RandomState(2).randint(0, ARCH["vocab"], (3, 2, 16))


def _port_grads(tm):
    """(lanes, d) flat gradients of each lane's mean squared logit, as the
    step takes them: vmap(grad_and_value) over the lanes."""
    def obj(p, t):
        return (functional_call(tm, (p,), (t,)) ** 2).mean()

    p = {k: v.detach() for k, v in tm.named_parameters()}
    g, loss = vmap(grad_and_value(obj), in_dims=(None, 0))(
        p, torch.as_tensor(TOKS))
    return params_mod.flatten(g, params_mod.layout(tm), lead=1), loss


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("flash", [False, True])
def test_remat_gradients_bit_for_bit(scan, flash, monkeypatch):
    attn = flash_attention if flash else None
    base = _port(scan, attn=attn)
    want = {n: p.detach() for n, p in base.named_parameters()}
    recomputed = []
    bwd = tmod._Remat.backward

    def counting(ctx, gy):
        recomputed.append(1)
        return bwd(ctx, gy)
    monkeypatch.setattr(tmod._Remat, "backward", staticmethod(counting))
    g0, l0 = _port_grads(base)
    assert not recomputed
    g1, l1 = _port_grads(_port(scan, remat=True, attn=attn, params=want))
    assert len(recomputed) == ARCH["layers"]  # once a block, all lanes
    assert torch.equal(l0, l1)
    assert torch.equal(g0, g1)


@pytest.mark.parametrize("scan", [False, True])
def test_remat_gradients_match_reference(scan):
    jm_plain, ref = _jax_init(scan)
    jm = dataclasses.replace(jm_plain, remat=True)
    want, _ = params_mod.from_jax(ref)

    def loss(p, t):
        return jnp.mean(jm.apply({"params": p}, t) ** 2)

    jg = jax.jit(jax.vmap(jax.grad(loss), in_axes=(None, 0)))(
        ref, jnp.asarray(TOKS))
    j_flat = np.asarray(jax.vmap(_flatten_tree)(jg))
    g, _ = _port_grads(_port(scan, remat=True, params=want))
    g = g.numpy()
    scale = np.abs(j_flat).max()
    np.testing.assert_allclose(g, j_flat, rtol=0, atol=1e-5 * scale)


LM = dict(network="TransformerLM", dataset="synthetic-text",
          approach="cyclic", redundancy="shared", num_workers=5,
          worker_fail=1, err_mode="rev_grad", batch_size=2, seq_len=16,
          vocab=32, model_dim=32, model_heads=2, model_layers=2,
          max_steps=3, train_dir="", seed=SEED, scan_layers=True)


def _ref_leaves(state):
    return [np.asarray(x) for x in jax.tree.leaves(jax.device_get(state))]


def test_scanned_checkpoint_reads_in_both_packages(tmp_path):
    jset = jax_lm(JaxConfig(eval_freq=0, **LM), make_mesh_2d(1, 1))
    adv = jrng.adversary_schedule(SEED, 3, 5, 1)
    jstate, _ = jset.train_step(jset.state, jnp.asarray(
        synthetic_text(SEED, 1, 5, 2, 16, 32)), jnp.asarray(adv[1]))
    ref = _ref_leaves(jstate)
    d = str(tmp_path / "ref")
    jckpt.save(d, 1, jstate, compress=True)
    tset = build_sp_train_setup(TrainConfig(**LM), device="cpu")
    lay = tset.layout
    assert tset.model.blocks.qkv.weight.shape == (2, 96, 32)
    tset.state.load(ckpt.load(d, 1, tset.state.specs(lay)), lay)
    ours = tset.state.arrays(lay)
    assert len(ours) == len(ref) and tset.state.step == 2
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    ckpt.save(str(tmp_path / "port"), 1, ours)
    abstract = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                            jstate)
    for a, b in zip(_ref_leaves(jckpt.load(str(tmp_path / "port"), 1,
                                           abstract)), ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("saved_scan", [False, True])
def test_resume_across_layer_layouts_is_refused(tmp_path, saved_scan):
    d = str(tmp_path)
    saved = TrainConfig(**dict(LM, scan_layers=saved_scan, train_dir=d,
                               eval_freq=1, max_steps=1))
    train_sp(saved, device="cpu", quiet=True)
    assert ckpt.exists(d, 1)
    other = TrainConfig(**dict(LM, scan_layers=not saved_scan, train_dir=d,
                               checkpoint_step=1, max_steps=2))
    with pytest.raises(ValueError, match="not interchangeable"):
        train_sp(other, device="cpu", quiet=True)
    # the same layout resumes at step 2 and runs max_steps = 2 more
    same = dataclasses.replace(other, scan_layers=saved_scan)
    state, _ = train_sp(same, device="cpu", quiet=True)
    assert state.step == 4


@pytest.mark.parametrize("change", [{"model_dim": 64},
                                    {"optimizer": "adam"}])
def test_other_mismatches_get_no_layout_hint(tmp_path, change):
    # a same-layout checkpoint of another width (a shape mismatch) or of
    # another optimizer (a count that is not the other layout's) is
    # refused by the load's own error, without the layer-layout hint
    d = str(tmp_path)
    train_sp(TrainConfig(**dict(LM, train_dir=d, eval_freq=1, max_steps=1)),
             device="cpu", quiet=True)
    other = TrainConfig(**dict(LM, **change, train_dir=d, checkpoint_step=1,
                               max_steps=2))
    with pytest.raises(ValueError) as info:
        train_sp(other, device="cpu", quiet=True)
    assert "not interchangeable" not in str(info.value)
