"""The port's one-card sequence-parallel attention against the JAX
package's: ``ring_attention``, ``ring_flash_attention`` and
``a2a_attention`` (draco_tpu/parallel/ring_attention.py,
a2a_attention.py).

The reference runs under ``shard_map`` on an sp-device CPU mesh, one
sequence shard a device; the port on the full (B, T, H, Dh) tensors with
the shard axis as a tensor axis, on the CPU through the flash kernels'
plain versions (the reference's flash takes its dense fallback off-TPU).
Both at sp ∈ {2, 4}, causal and not: the outputs, and the gradients of
q, k and v of sum(sin(o)), which on the flash ring run through the
log-sum-exp merge into the kernels' dlse. Tolerance: 1e-5 absolute and
1e-4 relative (the reference's own ring tests' tolerance; the reduction
orders differ). And the configuration's sp checks: the port refuses what
the reference refuses, with its message.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from draco_tpu.config import TrainConfig as JaxConfig
from draco_tpu.ops.flash_attention import flash_attention as j_flash
from draco_tpu.parallel.a2a_attention import a2a_attention as j_a2a
from draco_tpu.parallel.ring_attention import (
    ring_attention as j_ring, ring_flash_attention as j_ring_flash)
from draco_tpu.runtime import shard_map
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.ops.flash_attention import flash_attention
from draco_tpu_torch.parallel.a2a_attention import a2a_attention
from draco_tpu_torch.parallel.ring_attention import (
    dense_attention, ring_attention, ring_flash_attention)

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _qkv(seed, b=2, t=32, h=4, dh=8):
    r = np.random.RandomState(seed)
    return tuple(r.normal(size=(b, t, h, dh)).astype(np.float32)
                 for _ in range(3))


def _jax_route(fn, sp):
    mesh = Mesh(np.asarray(jax.devices()[:sp]), ("sp",))
    return shard_map(functools.partial(fn, axis_name="sp"), mesh=mesh,
                     in_specs=(P(None, "sp"),) * 3, out_specs=P(None, "sp"),
                     check_vma=False)


ROUTES = {
    "ring": (lambda causal: functools.partial(j_ring, causal=causal),
             lambda sp, causal: functools.partial(ring_attention, shards=sp,
                                                  causal=causal)),
    "ring_flash": (
        lambda causal: functools.partial(j_ring_flash, causal=causal),
        lambda sp, causal: functools.partial(ring_flash_attention,
                                             shards=sp, causal=causal)),
    "a2a": (lambda causal: functools.partial(j_a2a, causal=causal),
            lambda sp, causal: functools.partial(a2a_attention, shards=sp,
                                                 causal=causal)),
}
CASES = [(route, sp, causal) for route in ROUTES for sp in (2, 4)
         for causal in (True, False)]
# the flash inner of a2a is causal (the reference's (q, k, v) -> o contract)
CASES += [("a2a_flash", 2, True), ("a2a_flash", 4, True)]


def _pair(route, sp, causal):
    if route == "a2a_flash":
        return (functools.partial(j_a2a, inner=j_flash),
                functools.partial(a2a_attention, shards=sp,
                                  inner=flash_attention))
    j, t = ROUTES[route]
    return j(causal), t(sp, causal)


@pytest.mark.parametrize("route,sp,causal", CASES,
                         ids=lambda x: str(x))
def test_output_and_grads_match_reference(route, sp, causal):
    q, k, v = _qkv(sp + 10 * causal)
    j_fn, t_fn = _pair(route, sp, causal)
    j_ring_fn = _jax_route(j_fn, sp)

    def j_scalar(q, k, v):
        o = j_ring_fn(q, k, v)
        return jnp.sum(jnp.sin(o)), o

    # one compile for the output and the gradients
    (_, j_out), j_grads = jax.jit(jax.value_and_grad(
        j_scalar, argnums=(0, 1, 2), has_aux=True))(
            *map(jnp.asarray, (q, k, v)))

    tq = tuple(torch.tensor(x, requires_grad=True) for x in (q, k, v))
    t_out = t_fn(*tq)
    torch.sin(t_out).sum().backward()
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out),
                               rtol=RTOL, atol=ATOL)
    for name, t, g in zip("qkv", tq, j_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=RTOL,
                                   atol=ATOL, err_msg=f"d{name}")


@pytest.mark.parametrize("sp", [2, 4])
def test_shards_equal_single_shard_attention(sp):
    """Every route is exact attention: the same as the single-shard dense
    attention of the whole sequence."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(3))
    want = dense_attention(q, k, v)
    for got in (ring_attention(q, k, v, sp), ring_flash_attention(q, k, v,
                                                                   sp),
                a2a_attention(q, k, v, sp),
                a2a_attention(q, k, v, sp, inner=flash_attention)):
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_a2a_refuses_heads_not_divisible():
    q = torch.zeros((1, 8, 3, 4))
    with pytest.raises(ValueError, match="heads 3 not divisible by sp=2"):
        a2a_attention(q, q, q, 2)
    lm = dict(network="TransformerLM", dataset="synthetic-text",
              model_dim=24, model_heads=3, seq_len=32, seq_shards=2)
    TrainConfig(**lm).validate()  # the ring takes any head count
    with pytest.raises(ValueError, match="model_heads % seq_shards"):
        TrainConfig(**lm, sp_attn="a2a").validate()


LM_CFG = dict(network="TransformerLM", dataset="synthetic-text",
              model_dim=32, model_heads=4, seq_len=32)
# (fields, the reference's validate() raises); the messages are the
# reference's own
SP_CASES = [
    (dict(seq_shards=4), False),
    (dict(seq_shards=4, sp_attn="a2a"), False),
    (dict(seq_shards=3), True),  # 32 % 3
    (dict(seq_shards=2, sp_attn="ulysses"), True),
    (dict(seq_shards=8, sp_attn="a2a"), True),  # 4 heads % 8
    (dict(seq_shards=2, moe_experts=4), True),
    (dict(seq_shards=2, remat=True, scan_layers=True, attn_impl="flash"),
     False),
    (dict(network="ResNet18", dataset="synthetic-cifar10", seq_shards=2),
     True),
]


@pytest.mark.parametrize("fields,raises", SP_CASES,
                         ids=lambda v: "-".join(f"{k}={x}" for k, x in
                                                v.items())
                         if isinstance(v, dict) else str(v))
def test_sp_checks_match_the_reference(fields, raises):
    def outcome(cls):
        try:
            cls(**{**LM_CFG, **fields}).validate()
        except ValueError as e:
            return str(e)
        return None

    port, ref = outcome(TrainConfig), outcome(JaxConfig)
    assert (ref is not None) == raises, ref
    assert port == ref
