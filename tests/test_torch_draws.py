"""The port's counter-based draws (``draco_tpu_torch.rng``'s threefry stream
and the plain versions of ``ops/draws.py``) against ``jax.random`` and the
JAX package's users of it.

Tolerances. Everything is bit for bit but the normal: ``key``,
``fold_in``, ``split``, ``bits``, ``uniform`` and ``randint`` are integer
arithmetic (the uniform a bit pattern minus 1, exact), and so are the
stochastic rounding's draws and the device tokens. The normal maps the
uniform through the reference's erfinv polynomial, whose ``log1p`` is
torch's in the port and XLA's in the reference: within 3e-5·max(1, |z|)
(measured 2.4e-7 over 100,000 draws at each seed). The 64-bit counter's
high word, which no shape here reaches, is checked against an
independent numpy model of threefry2x32 at counters past 2**32.

The CPU program lint (``analysis/rules.py``) of the heaviest of the device
draws' legs (``vgg11_random``, ``shared_int8_sr``) is held here as
``test_torch_audit.py`` holds the other legs: in a file of many tests, which
xdist's loadfile schedules early (it orders files by their count of tests).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from draco_tpu import attacks as jattacks
from draco_tpu.config import TrainConfig as JaxConfig
from draco_tpu.obs import numerics as jnx
from draco_tpu.parallel.sp_step import synthetic_text_in_graph as j_text
from draco_tpu_torch import attacks, rng
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.obs import numerics as tnx
from draco_tpu_torch.ops import draws
from draco_tpu_torch.parallel.sp_step import synthetic_text_in_graph
from test_torch_audit import DRAW_LEGS, assert_green, lint_rows_of

torch.set_num_threads(1)

SEEDS = (0, 428, 435, 445, 2**32 - 1)
STEPS = (0, 1, 7, 4097, 2**31 - 1)
NORMAL_TOL = 3e-5


def kd(k) -> tuple:
    """A JAX key's two uint32 words."""
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


def tk(k) -> tuple:
    return tuple(int(v) for v in k)


def i32(v):
    return torch.tensor(v, dtype=torch.int32)


# --------------------------------------------------------------------------
# the stream
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_and_split(seed):
    jk, k = jax.random.key(seed), rng.key(seed)
    assert kd(jk) == tk(k)
    for step in STEPS:
        ref = kd(jax.random.fold_in(jk, jnp.int32(step)))
        assert tk(rng.fold_in(k, step)) == ref
        # a step on the device: the same key, as 0-d tensors
        assert tk(rng.fold_in(k, i32(step))) == ref
    for num in (2, 3, 5):
        for a, b in zip(jax.random.split(jk, num), rng.split(k, num)):
            assert kd(a) == tk(b)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (2, 3, 4), (1000,)])
def test_bits_and_uniform(seed, shape):
    k = rng.fold_in(rng.key(seed), 3)
    jk = jax.random.fold_in(jax.random.key(seed), jnp.int32(3))
    ref = np.asarray(jax.random.bits(jk, shape)).astype(np.int64)
    np.testing.assert_array_equal(rng.bits(k, shape).numpy(), ref)
    ref = np.asarray(jax.random.uniform(jk, shape))
    out = rng.uniform(k, shape).numpy()
    np.testing.assert_array_equal(out.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("lo,hi", [(0, 2), (0, 1000), (0, 8191), (0, 8192),
                                   (0, 50257), (1, 3), (5, 70000),
                                   (-3, 11)])
def test_randint(lo, hi):
    for seed in (0, 428):
        jk, k = jax.random.key(seed), rng.key(seed)
        ref = np.asarray(jax.random.randint(jk, (4, 33), lo, hi))
        np.testing.assert_array_equal(
            rng.randint(k, (4, 33), lo, hi).numpy(), ref)


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_tolerance(seed):
    jk, k = jax.random.key(seed), rng.key(seed)
    ref = np.asarray(jax.random.normal(jk, (100_000,)))
    out = rng.normal(k, (100_000,)).numpy()
    err = np.abs(out - ref) / np.maximum(1.0, np.abs(ref))
    assert err.max() < NORMAL_TOL, err.max()
    assert (out == ref).mean() > 0.9  # most draws are equal outright


def _threefry_np(k0, k1, x0, x1):
    """An independent numpy model of threefry2x32 (uint32 arithmetic)."""
    with np.errstate(over="ignore"):
        u = np.uint32
        ks = [u(k0), u(k1), u(k0) ^ u(k1) ^ u(0x1BD11BDA)]
        x = [x0.astype(np.uint32) + ks[0], x1.astype(np.uint32) + ks[1]]
        rots = [(13, 15, 26, 6), (17, 29, 16, 24)]
        for i in range(5):
            for r in rots[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = ((x[1] << u(r)) | (x[1] >> u(32 - r))) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + u(i + 1)
        return x


def test_the_counters_high_word():
    """Counters past 2**32 (an (n, d) draw of more than 4.3e9 elements)
    take their high word into the counter pair."""
    k = rng.fold_in(rng.key(428), 5)
    for offset in (2**32 - 300, 2**32, 3 * 2**32 + 17, 2**40 + 5):
        out = rng.bits(k, 600, offset=offset).numpy()
        c = offset + np.arange(600, dtype=np.uint64)
        a, b = _threefry_np(k[0], k[1], (c >> np.uint64(32)),
                            c & np.uint64(0xFFFFFFFF))
        np.testing.assert_array_equal(out, (a ^ b).astype(np.int64))
    # below 2**32 the model agrees with the reference's own bits
    c = np.arange(50, dtype=np.uint64)
    a, b = _threefry_np(k[0], k[1], c >> np.uint64(32), c)
    jk = jax.random.fold_in(jax.random.key(428), jnp.int32(5))
    np.testing.assert_array_equal(
        (a ^ b), np.asarray(jax.random.bits(jk, (50,))))


# --------------------------------------------------------------------------
# the random attack
# --------------------------------------------------------------------------

@pytest.mark.parametrize("step", [1, 6])
def test_random_attack_against_the_reference(step):
    """inject_plain and inject_cyclic without noise= on the rows the mask
    sets: the reference's normals of random_key(seed, step) (the cyclic
    pair: its split) within the tolerance, the other rows unchanged."""
    rs = np.random.RandomState(step)
    g, gi = (rs.normal(size=(6, 301)).astype(np.float32) for _ in range(2))
    mask = np.array([0, 1, 0, 0, 1, 0], bool)
    s = i32(step)
    for n_mal in (None, 2, 3):
        out = attacks.inject_plain(torch.from_numpy(g.copy()),
                                   torch.from_numpy(mask), "random",
                                   step=s, seed=428, n_mal=n_mal or 6)
        ref = np.asarray(jattacks.inject_plain(
            jnp.asarray(g), jnp.asarray(mask), "random", step=step,
            seed=428))
        np.testing.assert_array_equal(out.numpy()[~mask], g[~mask])
        np.testing.assert_allclose(out.numpy(), ref, rtol=NORMAL_TOL,
                                   atol=0)
        re_, im_ = attacks.inject_cyclic(
            torch.from_numpy(g.copy()), torch.from_numpy(gi.copy()),
            torch.from_numpy(mask), "random", step=s, seed=428,
            n_mal=n_mal)
        jre, jim = jattacks.inject_cyclic(
            jnp.asarray(g), jnp.asarray(gi), jnp.asarray(mask), "random",
            step=step, seed=428)
        for o, r, x in ((re_, jre, g), (im_, jim, gi)):
            np.testing.assert_array_equal(o.numpy()[~mask], x[~mask])
            # magnitude 100 on |z| <= 5: within 3e-5 of the noise's scale
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                       atol=100 * NORMAL_TOL * 5)
    assert tk(attacks.random_key(428, step)) == kd(
        jattacks.random_key(428, step))


def test_random_attack_mask_beyond_max_rows_fails_the_check():
    """max_rows is a promise about the mask: within it the plain version
    writes what the unbounded draw writes, and a mask that sets more rows
    fails the device-side check instead of leaving rows unattacked."""
    mask = torch.tensor([1, 0, 1, 0, 0], dtype=torch.bool)
    outs = []
    for max_rows in (None, 2, 3):
        x = torch.zeros(5, 64)
        draws.random_inject(x, mask, i32(2), 435, -100.0, max_rows=max_rows)
        outs.append(x)
    assert outs[0][[0, 2]].ne(0).all() and not outs[0][[1, 3, 4]].any()
    for x in outs[1:]:
        assert torch.equal(x, outs[0])
    with pytest.raises(RuntimeError, match="more than max_rows=2"):
        draws.random_inject(torch.zeros(5, 64),
                            torch.tensor([1, 0, 1, 1, 0], dtype=torch.bool),
                            i32(2), 435, -100.0, max_rows=2)


def test_the_draw_wrappers_refuse_other_devices():
    meta = torch.zeros(2, 3, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        draws.random_inject(meta, torch.ones(2, dtype=torch.bool), 1, 1,
                            -100.0)
    with pytest.raises(ValueError, match="mode bf16|int8"):
        draws.round_draw(i32(1), 445, 10, "f32")
    # the same inputs on both devices: a step tensor, contiguous rows
    with pytest.raises(ValueError, match="int32 tensor of one element"):
        draws.round_draw(1, 445, 10, "bf16")
    with pytest.raises(ValueError, match="int32 tensor of one element"):
        draws.synthetic_text(1, 428, 2, 1, 4, 16)
    with pytest.raises(ValueError, match="contiguous"):
        draws.random_inject(torch.zeros(3, 2).t(),
                            torch.ones(2, dtype=torch.bool), i32(1), 1,
                            -100.0)


# --------------------------------------------------------------------------
# stochastic rounding
# --------------------------------------------------------------------------

N, D = 8, 3 * 1024 + 77


def _rows(seed: int = 0) -> np.ndarray:
    rs = np.random.RandomState(seed)
    x = (rs.randn(N, D) * np.exp(2.0 * rs.randn(N, D))).astype(np.float32)
    x[1, 5], x[2, 7], x[3, 9] = np.nan, np.inf, -np.inf
    x[6, 11] = -np.nan
    x[6, 12] = np.array([0x7F800001], np.uint32).view(np.float32)[0]
    x[4, :256] = 0.0
    x[5, 300], x[5, 301] = 3.0e38, -3.39e38
    return x


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        a = a.numpy()
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        a = a.view(np.int16)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def _cfgs(mode, block):
    kw = dict(approach="cyclic", num_workers=8, worker_fail=1,
              wire_dtype=mode, shadow_block=block, shadow_round="stochastic")
    return JaxConfig(**kw), TrainConfig(**kw).validate()


def test_round_step_keys():
    jc, tc = _cfgs("int8", 256)
    for step in (1, 9):
        assert tk(tnx.wire_step_key(tc, step)) == kd(
            jnx.wire_step_key(jc, jnp.int32(step)))
        assert tk(tnx.shadow_step_key(tc, step)) == kd(
            jnx.shadow_step_key(jc, jnp.int32(step)))
    assert tnx.wire_step_key(dataclasses.replace(
        tc, shadow_round="nearest"), 1) is None


@pytest.mark.parametrize("mode,block", [("bf16", 256), ("int8", 256),
                                        ("int8", 96)])
@pytest.mark.parametrize("step", [1, 12])
def test_stochastic_wire_pair_bit_for_bit(mode, block, step):
    jc, tc = _cfgs(mode, block)
    x = _rows(step)
    xi = x[::-1].copy()
    jre, jim, jw = jnx.narrow_wire_pair(jc, jnp.asarray(x), jnp.asarray(xi),
                                        step=jnp.int32(step))
    tre, tim, tw = tnx.narrow_wire_pair(tc, torch.from_numpy(x),
                                        torch.from_numpy(xi), i32(step))
    assert tw[0] == jw[0] and tw[3] == jw[3]
    for a, b in ((tw[1], jw[1]), (tw[2], jw[2])):
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(_bits(a[k]), _bits(b[k]), k)
    np.testing.assert_array_equal(_bits(tre), _bits(jre))
    np.testing.assert_array_equal(_bits(tim), _bits(jim))


@pytest.mark.parametrize("mode,block", [("bf16", 256), ("int8", 256),
                                        ("int8", 24)])
def test_stochastic_wire_single_bit_for_bit(mode, block):
    """One draw shared by the rows: equal rows stay equal on the wire (the
    vote's soundness condition)."""
    jc, tc = _cfgs(mode, block)
    x = _rows(3)
    x[7] = x[6]
    jrows, jw = jnx.narrow_wire_single(jc, jnp.asarray(x),
                                       step=jnp.int32(5))
    tw = tnx.narrow_wire_single(tc, torch.from_numpy(x), i32(5))
    for k in jw[1]:
        np.testing.assert_array_equal(_bits(tw[1][k]), _bits(jw[1][k]), k)
    wide = tnx.widen_wire_rows(tw[1], mode, block)
    np.testing.assert_array_equal(_bits(wide), _bits(jrows))
    assert torch.equal(tw[1]["q"][6].view(torch.uint8)
                       if mode == "int8" else tw[1]["q"][6].view(torch.int16),
                       tw[1]["q"][7].view(torch.uint8)
                       if mode == "int8" else tw[1]["q"][7].view(torch.int16))


def test_round_draw_plain_is_the_references_draw():
    k = jnx.wire_step_key(_cfgs("bf16", 256)[0], jnp.int32(4))
    want = (np.asarray(jax.random.bits(k, (D,))) & 0xFFFF).astype(np.int32)
    got = draws.round_draw(i32(4), 428 + draws.WIRE_SALT, D, "bf16", 2)
    np.testing.assert_array_equal(got[0].numpy(), want)
    k1 = jax.random.fold_in(k, 1)
    want = np.asarray(jax.random.uniform(k1, (D,)))
    got = draws.round_draw(i32(4), 428 + draws.WIRE_SALT, D, "int8", 2)
    np.testing.assert_array_equal(_bits(got[1]), _bits(want))


# --------------------------------------------------------------------------
# the device tokens
# --------------------------------------------------------------------------

@pytest.mark.parametrize("args", [(428, 1, 8, 2, 32, 64),
                                  (428, 7, 8, 2, 512, 8192),
                                  (7, 30, 3, 4, 17, 50257),
                                  (0, 0, 1, 1, 5, 3)])
def test_device_tokens_bit_for_bit(args):
    seed, step, n, b, t, vocab = args
    ref = np.asarray(j_text(seed, jnp.int32(step), n, b, t, vocab))
    out = synthetic_text_in_graph(seed, i32(step), n, b, t, vocab)
    assert out.dtype == torch.int32 and tuple(out.shape) == (n, b, t)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(
        draws.synthetic_text(i32(step), seed, n, b, t, vocab).numpy(), ref)


# --------------------------------------------------------------------------
# the CPU program lint of these legs (test_torch_audit.py's rule)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lint_rows():
    return lint_rows_of(DRAW_LEGS)


@pytest.mark.parametrize("leg", DRAW_LEGS)
def test_every_leg_green_on_the_cpu_rules(lint_rows, leg):
    assert_green(lint_rows[leg], leg)
