"""The port's TransformerLM against the JAX package's Flax model, and the
flat layout of its parameters.

The port's model gets the reference's initial parameters through
``params.from_jax``; both see the same numpy token draws. Tolerances:

  * float32 logits: 2e-5 absolute on logits of O(1) — the same float32
    operations in another summation order;
  * float32 parameter gradients of the masked next-token loss, flattened
    in the reference's leaf order: 1e-4 of the largest gradient
    coordinate, coordinate by coordinate (no ReLU kinks here: GELU is
    smooth, so float32 noise stays at rounding level);
  * bfloat16 compute: 5e-2 absolute on the logits — bfloat16 keeps 8
    significant bits, and the two frameworks round at other places (torch
    computes GELU of a bfloat16 input in float32 and rounds once).

The layout tests hold ``params.flatten`` of ``from_jax`` to
``jnp.concatenate`` of ``jax.tree.leaves`` bit for bit at 11 layers, where
string order puts ``block10`` before ``block2``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from draco_tpu.models.transformer import TransformerLM as JaxLM
from draco_tpu.ops.flash_attention import flash_attention as j_flash
from draco_tpu_torch import params as params_mod
from draco_tpu_torch.models.transformer import TransformerLM, init_params
from draco_tpu_torch.ops.flash_attention import flash_attention

torch.set_num_threads(1)

VOCAB, DIM, HEADS, LAYERS, T, B = 64, 64, 4, 2, 32, 2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _models(layers=LAYERS, dim=DIM, dtype="float32", flash=False):
    jd, td = DTYPES[dtype]
    jattn = None
    if flash:
        jattn = lambda q, k, v: j_flash(q, k, v, block_q=8,  # noqa: E731
                                        block_k=16, force=True,
                                        interpret=True)
    jm = JaxLM(vocab=VOCAB, dim=dim, heads=HEADS, layers=layers,
               attn_fn=jattn, dtype=jd)
    jp = JaxLM(vocab=VOCAB, dim=dim, heads=HEADS, layers=layers).init(
        {"params": jax.random.key(3)}, jnp.zeros((1, 8), jnp.int32))["params"]
    tm = TransformerLM(vocab=VOCAB, dim=dim, heads=HEADS, layers=layers,
                       attn_fn=flash_attention if flash else None, dtype=td)
    p, _ = params_mod.from_jax(jax.device_get(jp))
    tm.load_state_dict(p)
    return jm, jp, tm


def _tokens(seed=0):
    return np.random.RandomState(seed).randint(0, VOCAB, size=(B, T))


def _loss_jax(jm):
    def loss(p, toks):
        logits = jm.apply({"params": p}, toks)
        logp = jax.nn.log_softmax(logits)
        nll = -jnp.take_along_axis(logp[:, :-1], toks[:, 1:, None], -1)
        return jnp.mean(nll)
    return loss


def _loss_torch(tm, toks):
    logp = torch.log_softmax(tm(toks), dim=-1)
    return -logp[:, :-1].gather(-1, toks[:, 1:, None]).mean()


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_logits_and_gradients_match_flax(flash):
    jm, jp, tm = _models(flash=flash)
    toks = _tokens()
    ref = np.asarray(jm.apply({"params": jp}, jnp.asarray(toks)))
    tt = torch.from_numpy(toks).long()
    out = tm(tt)
    assert out.dtype == torch.float32 and out.shape == (B, T, VOCAB)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=2e-5)

    jg = jax.grad(_loss_jax(jm))(jp, jnp.asarray(toks))
    ref_flat = np.concatenate([np.ravel(x) for x in jax.tree.leaves(jg)])
    loss = _loss_torch(tm, tt)
    grads = torch.autograd.grad(loss, list(tm.parameters()))
    names = [n for n, _ in tm.named_parameters()]
    flat = params_mod.flatten(dict(zip(names, grads)),
                              params_mod.layout(tm)).numpy()
    assert flat.shape == ref_flat.shape
    np.testing.assert_allclose(flat, ref_flat, rtol=0,
                               atol=1e-4 * np.abs(ref_flat).max())


def test_bfloat16_compute_matches_flax():
    """Dense layers and the block LayerNorms in bfloat16 on float32
    parameters; attention, the final LayerNorm and the logits in float32."""
    jm, jp, tm = _models(dtype="bfloat16")
    toks = _tokens(1)
    ref = np.asarray(jm.apply({"params": jp}, jnp.asarray(toks)))
    out = tm(torch.from_numpy(toks).long())
    assert out.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=5e-2)


@pytest.fixture(scope="module")
def deep():
    """A narrow 11-layer model: the reference's tree and the port's."""
    jp = JaxLM(vocab=VOCAB, dim=16, heads=2, layers=11).init(
        {"params": jax.random.key(5)}, jnp.zeros((1, 8), jnp.int32))["params"]
    tm = TransformerLM(vocab=VOCAB, dim=16, heads=2, layers=11)
    return jax.device_get(jp), tm


def test_flatten_of_from_jax_is_the_references_leaf_order(deep):
    jp, tm = deep
    params, _ = params_mod.from_jax(jp)
    lay = params_mod.layout(tm)
    assert len(lay.names) == len(jax.tree.leaves(jp)) == 11 * 8 + 2
    assert lay.names.index("block10.qkv.weight") < lay.names.index(
        "block2.qkv.weight")
    flat = params_mod.flatten(params, lay).numpy()
    ref = np.asarray(jnp.concatenate([x.ravel() for x in jax.tree.leaves(jp)]))
    np.testing.assert_array_equal(flat, ref)
    # embedding (vocab, dim) kept as it is, Dense kernels (out, in)
    assert params["embed.weight"].shape == (VOCAB, 16)
    np.testing.assert_array_equal(params["embed.weight"].numpy(),
                                  jp["embed"]["embedding"])
    assert params["block3.mlp_in.weight"].shape == (64, 16)
    assert params["block3.LayerNorm_1.weight"].shape == (16,)


def test_unflatten_inverts_flatten(deep):
    jp, tm = deep
    params, _ = params_mod.from_jax(jp)
    lay = params_mod.layout(tm)
    back = params_mod.unflatten(params_mod.flatten(params, lay), lay)
    assert set(back) == set(params)
    for k, v in params.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy())
    tm.load_state_dict(back)  # torch layouts: every shape fits the module


def test_init_follows_flax_distributions():
    """Flax's initialisers' distributions (the numbers themselves are the
    reference's, test_torch_stream_draws.py): LeCun normal kernels
    truncated at 2σ, the untruncated Embed normal, unit scales, zero
    biases."""
    tm = TransformerLM(vocab=512, dim=256, heads=4, layers=1)
    init_params(tm, 0)
    emb = tm.embed.weight.detach()
    qkv = tm.block0.qkv.weight.detach()
    assert abs(emb.std().item() * 16 - 1) < 0.02
    assert abs(qkv.std().item() * 16 - 1) < 0.02
    assert qkv.abs().max().item() * 16 <= 2.0 / 0.87962566103423978 + 1e-4
    assert emb.abs().max().item() * 16 > 2.5  # not truncated
    assert bool((tm.block0.mlp_in.bias == 0).all())
    assert bool((tm.final_ln.weight == 1).all())
