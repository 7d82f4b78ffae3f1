"""The port's flash attention on the CPU (the kernels' plain versions
behind the same autograd and vmap rules the card runs) against the JAX
package's Pallas kernels in interpret mode.

``draco_tpu.ops.flash_attention.flash_attention(..., force=True,
interpret=True)`` and ``flash_attention_with_lse`` run the TPU kernels'
bodies on the CPU, as ``tests/test_flash_attention.py`` does, with blocks
bq ≠ bk so the reference's causal block skipping is exercised. Inputs are
numpy draws at T = 32 and T = 40, Dh = 16.

Tolerances: forward 1e-5 (absolute, the outputs are O(1)): float32 sums of
at most T terms in another order. Gradients 1e-4 absolute on gradients of
O(1–10): the backward recomputes p from lse and sums T products twice.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from draco_tpu.ops import flash_attention as jfa
from draco_tpu.parallel.ring_attention import dense_attention_lse as j_dense
from draco_tpu_torch.ops import flash_attention as fa
from draco_tpu_torch.parallel import ring_attention as ra

torch.set_num_threads(1)

T_ = torch.from_numpy
# (T, block_q, block_k) of the reference's kernels: bq != bk in both cases
SHAPES = [(32, 8, 16), (40, 8, 40)]


def _inputs(t, seed, b=2, h=3, dh=16):
    rng = np.random.RandomState(seed)
    shape = (b, t, h, dh)
    q, k, v, w = (rng.normal(size=shape).astype(np.float32) for _ in range(4))
    wl = rng.normal(size=(b, t, h)).astype(np.float32)
    return q, k, v, w, wl


def _jax_flash(bq, bk, with_lse):
    if with_lse:
        return lambda q, k, v: jfa.flash_attention_with_lse(
            q, k, v, block_q=bq, block_k=bk, force=True, interpret=True)
    return lambda q, k, v: jfa.flash_attention(
        q, k, v, block_q=bq, block_k=bk, force=True, interpret=True)


@pytest.mark.parametrize("t,bq,bk", SHAPES)
def test_forward_and_lse_match_the_pallas_kernel(t, bq, bk):
    q, k, v, _, _ = _inputs(t, 1)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    ref_o = np.asarray(_jax_flash(bq, bk, False)(jq, jk, jv))
    ref_o2, ref_lse = (np.asarray(x) for x in
                       _jax_flash(bq, bk, True)(jq, jk, jv))
    out = fa.flash_attention(T_(q), T_(k), T_(v)).numpy()
    out2, lse = (x.numpy() for x in
                 fa.flash_attention_with_lse(T_(q), T_(k), T_(v)))
    assert out.shape == (2, t, 3, 16) and lse.shape == (2, t, 3)
    np.testing.assert_allclose(out, ref_o, rtol=0, atol=1e-5)
    np.testing.assert_allclose(out2, ref_o2, rtol=0, atol=1e-5)
    np.testing.assert_allclose(lse, ref_lse, rtol=0, atol=1e-5)


@pytest.mark.parametrize("with_lse", [False, True], ids=["o", "o+lse"])
@pytest.mark.parametrize("t,bq,bk", SHAPES)
def test_gradients_match_the_pallas_vjp(t, bq, bk, with_lse):
    """dq, dk, dv through the reference's custom VJP (its dq and dk/dv
    kernels, with the lse cotangent stream when lse is used) against the
    port's backward (the dq and dk/dv wrappers' plain versions)."""
    q, k, v, w, wl = _inputs(t, 2)
    jflash = _jax_flash(bq, bk, with_lse)

    def jloss(q, k, v):
        if with_lse:
            o, lse = jflash(q, k, v)
            return jnp.sum(o * w) + jnp.sum(jnp.sin(lse) * wl)
        return jnp.sum(jflash(q, k, v) * w)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                               for x in (q, k, v)))
    tq, tk, tv = (T_(x).requires_grad_() for x in (q, k, v))
    if with_lse:
        o, lse = fa.flash_attention_with_lse(tq, tk, tv)
        loss = (o * T_(w)).sum() + (torch.sin(lse) * T_(wl)).sum()
    else:
        loss = (fa.flash_attention(tq, tk, tv) * T_(w)).sum()
    out = torch.autograd.grad(loss, (tq, tk, tv))
    for name, a, b in zip("qkv", out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4, err_msg=f"d{name}")


def test_dense_attention_matches_the_reference():
    """The port's streaming dense attention (the LM's attn_impl="dense" and
    the flash forward's plain version) with and without the causal mask
    and with a position offset: 1e-5."""
    q, k, v, _, _ = _inputs(40, 3)
    for kw in ({}, {"causal": False}, {"q_offset": 7, "k_offset": 7}):
        ref_o, ref_l = j_dense(
            *(jnp.asarray(x) for x in (q, k, v)), **kw)
        o, lse = ra.dense_attention_lse(T_(q), T_(k), T_(v), **kw)
        np.testing.assert_allclose(o.numpy(), np.asarray(ref_o), atol=1e-5)
        np.testing.assert_allclose(lse.numpy(), np.asarray(ref_l), atol=1e-5)


@pytest.mark.parametrize("shared_k", [False, True], ids=["all", "k-shared"])
def test_vmap_rule_equals_a_loop_over_lanes(shared_k):
    """torch.func.vmap(grad(...)) over 4 lanes folds the lanes into G (the
    kernels' batch axis): the same gradients as one call per lane, exactly
    (the plain versions batch over G with no cross-head arithmetic), also
    with an operand shared by every lane (in_dims None)."""
    rng = np.random.RandomState(4)
    qs, ks, vs = (T_(rng.normal(size=(4, 2, 24, 3, 16)).astype(np.float32))
                  for _ in range(3))

    def loss(q, k, v):
        o, lse = fa.flash_attention_with_lse(q, k, v)
        return (o ** 2).sum() + torch.sin(lse).sum()

    g = grad(loss, argnums=(0, 1, 2))
    in_dims = (0, None, 0) if shared_k else (0, 0, 0)
    kk = ks[0] if shared_k else ks
    batched = vmap(g, in_dims=in_dims)(qs, kk, vs)
    loop = [g(qs[i], kk if shared_k else ks[i], vs[i]) for i in range(4)]
    for j in range(3):
        np.testing.assert_array_equal(
            batched[j].numpy(), torch.stack([x[j] for x in loop]).numpy())


def test_backward_wrappers_without_dlse_and_ragged_t():
    """The dq and dk/dv wrappers on (G, T, Dh) at a T that is not a
    multiple of any block, with and without dlse, against autograd
    through the streaming dense attention: 1e-4."""
    rng = np.random.RandomState(5)
    q, k, v, do = (T_(rng.normal(size=(5, 37, 16)).astype(np.float32))
                   for _ in range(4))
    dl = T_(rng.normal(size=(5, 37)).astype(np.float32))
    o, lse = fa.flash_fwd(q, k, v)
    dcap = (do * o).sum(-1)
    for dlse in (None, dl):
        qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
        ro, rl = ra.dense_attention_lse(qq[:, :, None], kk[:, :, None],
                                        vv[:, :, None])
        loss = (ro[:, :, 0] * do).sum()
        if dlse is not None:
            loss = loss + (rl[:, :, 0] * dlse).sum()
        ref = torch.autograd.grad(loss, (qq, kk, vv))
        dq = fa.flash_dq(q, k, v, do, lse, dcap, dlse)
        dk, dv = fa.flash_dkv(q, k, v, do, lse, dcap, dlse)
        for a, b in zip((dq, dk, dv), ref):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4)


def test_shapes_the_kernels_cannot_take_raise():
    x = torch.zeros(1, 8, 2, 130)
    with pytest.raises(ValueError, match="Dh"):
        fa.flash_attention(x, x, x)
    y = torch.zeros(1, 8, 2, 16, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        fa.flash_attention(y, y, y)
    with pytest.raises(ValueError):
        fa.flash_fwd(torch.zeros(2, 8, 16), torch.zeros(2, 9, 16),
                     torch.zeros(2, 8, 16))
