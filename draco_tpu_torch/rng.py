"""Deterministic randomness discipline (draco_tpu/rng.py).

The numpy schedules are copied verbatim from the reference, so both packages
derive the same adversary, straggler and shuffle streams bit for bit.

The reference's in-graph draws come from the JAX PRNG: threefry2x32, keys
split and folded without a sequential state (``jax_threefry_partitionable``).
This module holds that stream as plain torch functions, bit for bit the
reference's: ``threefry2x32``, ``key``, ``fold_in``, ``split``, ``bits``,
``uniform``, ``randint`` and ``normal`` (the last within a few f32 ulps: its
``erfinv`` is the reference's polynomial, its ``log1p`` torch's). A key is a
pair ``(k0, k1)`` of uint32 values, each a Python int or an int64 tensor
holding one; a tensor key (folded from a step that lives on the device)
keeps every draw on the device, so a captured CUDA graph can replay it.
torch has little uint32 arithmetic: every value is int64 masked to 32 bits.
The kernels of ``csrc/draws.cu`` (``ops/draws.py``) compute the same stream;
these functions are their plain versions' core.

Every draw of the reference's training step is on this stream: the
initial parameters (:func:`init_leaf`, Flax's per-parameter keys by
:func:`fold_in_static`), the decode's random projection
(:func:`projection_factors`), and in the step the augmentation, dropout
and vote-salt draws (``ops/draws.py``), each folded from the staged step.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

M32 = 0xFFFFFFFF
# threefry2x32's rotations, the two groups of four that alternate
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KS_PARITY = 0x1BD11BDA
# normal(): the reference's lower bound of the uniform it maps, the f32
# just above -1, and the scale (1 - lo) as f32 arithmetic rounds it
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
NORMAL_SPAN = float(np.float32(1.0) - np.float32(NORMAL_LO))
SQRT2 = float(np.float32(np.sqrt(2.0)))
# the reference's single-precision erfinv (M. Giles, "Approximating the
# erfinv function"): a degree-8 polynomial in w - 2.5 for w = -log1p(-x²) <
# 5, else in sqrt(w) - 3
ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                -4.39150654e-06, 0.00021858087, -0.00125372503,
                -0.00417768164, 0.246640727, 1.50140941)
ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)
# truncated_normal(key, -2, 2) in float32: the uniform between XLA's f32
# erf(∓2/√2) (their difference as f32 rounds it), the result clamped to
# the open interval (nextafter(-2, ∞), nextafter(2, -∞))
TN_A = float(np.float32(-0.9544997))
TN_SPAN = float(np.float32(0.9544997) - np.float32(-0.9544997))
TN_HI = float(np.nextafter(np.float32(2.0), np.float32(0.0)))
# the standard deviation of a standard normal truncated to (-2, 2), which
# Flax's variance_scaling divides out
TN_STD = np.float32(0.87962566103423978)
# the decode projection's salt: fold_in(key(seed), 7919)
PROJECTION_SALT = 7919
# elements a pass of a large draw (an initial leaf, the projection): its
# int64 temporaries stay near 100 MB on the card
PIECE = 1 << 22


def adversary_schedule(seed: int, max_steps: int, num_workers: int, num_fail: int) -> np.ndarray:
    """Boolean mask (max_steps + 1, num_workers): True iff logical worker i
    behaves Byzantine at step t. Exactly ``num_fail`` workers per step."""
    mask = np.zeros((max_steps + 1, num_workers), dtype=bool)
    if num_fail == 0:
        return mask
    rng = np.random.RandomState(seed)
    for t in range(max_steps + 1):
        idx = rng.choice(num_workers, size=num_fail, replace=False)
        mask[t, idx] = True
    return mask


def straggler_schedule(seed: int, max_steps: int, num_workers: int,
                       num_straggle: int) -> np.ndarray:
    """Boolean mask (max_steps + 1, num_workers): True = the worker's row
    never arrives at that step. Salted apart from the adversary stream."""
    mask = np.zeros((max_steps + 1, num_workers), dtype=bool)
    if num_straggle == 0:
        return mask
    rng = np.random.RandomState(seed ^ 0x5A5A5A)
    for t in range(max_steps + 1):
        idx = rng.choice(num_workers, size=num_straggle, replace=False)
        mask[t, idx] = True
    return mask


def group_seeds(seed: int, num_groups: int) -> np.ndarray:
    """Per-group shuffle seeds, identical on every participant."""
    rng = np.random.RandomState(seed)
    return rng.randint(0, 20000, size=num_groups)


def epoch_permutation(seed: int, epoch: int, n: int) -> np.ndarray:
    """Shuffle of ``n`` sample indices for a given epoch from a shared seed."""
    rng = np.random.RandomState((seed * 100003 + epoch * 23) % (2**31 - 1))
    return rng.permutation(n)


# --------------------------------------------------------------------------
# the reference's counter-based stream (jax.random, threefry2x32)
# --------------------------------------------------------------------------

def _u32(v):
    """An int or a tensor as a uint32 value in int64."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64) & M32
    return int(v) & M32


def _u32_on(v, dev) -> torch.Tensor:
    """An int or a tensor as a uint32 value in an int64 tensor on ``dev``:
    an int by a fill on the device, not a host copy, so a CUDA graph can
    capture the plain stream."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64) & M32
    return torch.full((), int(v) & M32, dtype=torch.int64, device=dev)


# elements a pass of the plain stream works on: its int64 temporaries stay
# in the CPU's cache, an order of magnitude faster than whole-row passes
CHUNK = 1 << 16


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds of the key (k0, k1) on the counter pair
    (x0, x1), as uint32 values in int64 (ints or tensors; tensors
    broadcast). Returns the output pair as int64 tensors."""
    ks = (_u32(k0), _u32(k1), _u32(k0) ^ _u32(k1) ^ KS_PARITY)
    # in place on fresh int64 tensors: the counters' passes dominate
    dev = next((v.device for v in (x0, x1, *ks)
                if isinstance(v, torch.Tensor)), torch.device("cpu"))
    x0 = (_u32_on(x0, dev) + ks[0]) & M32
    x1 = (_u32_on(x1, dev) + ks[1]) & M32
    x0, x1 = torch.broadcast_tensors(x0, x1)
    x0, x1 = x0.clone(), x1.clone()
    tmp = torch.empty_like(x1)
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(M32)
            torch.bitwise_left_shift(x1, r, out=tmp)
            x1.bitwise_right_shift_(32 - r).bitwise_or_(tmp)
            x1.bitwise_and_(M32).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(M32)
        x1.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(M32)
    return x0, x1


def _chunked(fn, x: torch.Tensor, dtype) -> torch.Tensor:
    """``fn`` over the flat ``x`` CHUNK elements at a time on the CPU, in
    one pass elsewhere."""
    if x.device.type != "cpu":
        return fn(x)
    flat = x.reshape(-1)
    out = torch.empty(flat.shape, dtype=dtype, device=x.device)
    for a in range(0, flat.numel(), CHUNK):
        out[a:a + CHUNK] = fn(flat[a:a + CHUNK])
    return out.view(x.shape)


def key(seed) -> tuple:
    """``jax.random.key(seed)`` for 0 <= seed < 2**32: the pair (0, seed)."""
    return (0, _u32(seed))


def fold_in(k: tuple, data) -> tuple:
    """``jax.random.fold_in(k, data)``: the key's threefry of (0, data).
    ``data`` may be a 0-d tensor on the device (the staged step)."""
    return threefry2x32(k[0], k[1], 0, data)


def split(k: tuple, num: int = 2) -> list:
    """``jax.random.split(k, num)``: key i is the key's threefry of (0, i)."""
    return [threefry2x32(k[0], k[1], 0, i) for i in range(num)]


def _device_of(k: tuple, device):
    """``device``, or else the key's (a key folded from a device step)."""
    if device is not None:
        return torch.device(device)
    return next((v.device for v in k if isinstance(v, torch.Tensor)),
                torch.device("cpu"))


def bits(k: tuple, shape, offset: int = 0, device=None) -> torch.Tensor:
    """``jax.random.bits(k, shape)`` (uint32) as int64: element i, at the
    flat C-order counter ``offset + i`` (64 bits: its high word and low word
    the counter pair), is the xor of the key's threefry of the pair.
    ``offset`` draws a slice of a larger shape's stream."""
    shape = tuple(shape) if not isinstance(shape, int) else (shape,)
    c = offset + torch.arange(int(np.prod(shape, dtype=np.int64)),
                              dtype=torch.int64,
                              device=_device_of(k, device))
    return bits_at(k, c).view(shape)


def bits_at(k: tuple, counters: torch.Tensor) -> torch.Tensor:
    """The draws of ``bits`` at the given counters (int64)."""
    def one(c):
        a, b = threefry2x32(k[0], k[1], c >> 32, c & M32)
        return a ^ b
    return _chunked(one, counters, torch.int64)


def uniform_from_bits(b: torch.Tensor) -> torch.Tensor:
    """uint32 draws -> ``jax.random.uniform`` in [0, 1): the top 23 bits as
    the mantissa of a float in [1, 2), minus 1."""
    return ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniform(k: tuple, shape, offset: int = 0, device=None) -> torch.Tensor:
    """``jax.random.uniform(k, shape)``: float32 in [0, 1)."""
    return uniform_from_bits(bits(k, shape, offset, device))


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """The reference's float32 erfinv (ERFINV_SMALL / ERFINV_LARGE)."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(small, ERFINV_SMALL[0], ERFINV_LARGE[0])
    for cs, cl in zip(ERFINV_SMALL[1:], ERFINV_LARGE[1:]):
        p = torch.where(small, cs, cl) + p * w
    return p * x


def normal_from_bits(b: torch.Tensor) -> torch.Tensor:
    """uint32 draws -> ``jax.random.normal``: the uniform mapped onto
    (lo, 1), then sqrt(2)·erfinv, in float32."""
    def one(c):
        u = torch.clamp_min(uniform_from_bits(c) * NORMAL_SPAN + NORMAL_LO,
                            NORMAL_LO)
        return SQRT2 * erfinv(u)
    return _chunked(one, b, torch.float32)


def normal(k: tuple, shape, offset: int = 0, device=None) -> torch.Tensor:
    """``jax.random.normal(k, shape)``: float32."""
    return normal_from_bits(bits(k, shape, offset, device))


def randint(k: tuple, shape, lo: int, hi: int, device=None) -> torch.Tensor:
    """``jax.random.randint(k, shape, lo, hi)`` (int32 values) as int64:
    two draws of bits from the key's split, each reduced mod the span,
    combined with the multiplier 2**32 mod span in uint32 arithmetic."""
    k1, k2 = split(k, 2)
    span = max(int(hi) - int(lo), 1)
    mult = ((2 ** 16 % span) ** 2 & M32) % span
    high, low = bits(k1, shape, 0, device), bits(k2, shape, 0, device)
    off = (((high % span) * mult + low % span) & M32) % span
    return int(lo) + off


def draw_flat(from_bits, k: tuple, numel: int, device=None) -> torch.Tensor:
    """``from_bits`` of the key's flat stream of ``numel`` float32 elements
    (counters 0 .. numel - 1), drawn PIECE elements at a time."""
    dev = _device_of(k, device)
    out = torch.empty((int(numel),), dtype=torch.float32, device=dev)
    for a in range(0, int(numel), PIECE):
        b = min(int(numel), a + PIECE)
        out[a:b] = from_bits(bits(k, b - a, offset=a, device=dev))
    return out


def truncated_normal_from_bits(b: torch.Tensor) -> torch.Tensor:
    """uint32 draws -> ``jax.random.truncated_normal(key, -2, 2)``: the
    uniform mapped onto (erf(-√2), erf(√2)), then √2·erfinv, clamped to the
    open interval, in float32. XLA fuses the uniform's affine map into one
    fused multiply-add: here in float64, rounded once."""
    def one(c):
        u = (uniform_from_bits(c).double() * TN_SPAN + TN_A).float()
        u = torch.clamp_min(u, TN_A)
        return torch.clamp(SQRT2 * erfinv(u), -TN_HI, TN_HI)
    return _chunked(one, b, torch.float32)


def fold_in_static(k: tuple, *data) -> tuple:
    """Flax's ``_fold_in_static``: the SHA-1 of the strings and ints of
    ``data`` (a module path and the rng counter), its first 4 bytes read
    big-endian, folded into ``k``."""
    if not data:
        return k
    return fold_in(k, static_hash(*data))


def static_hash(*data) -> int:
    """The uint32 that :func:`fold_in_static` folds in for ``data``: Flax
    0.12.3 hashes the items with no separator byte between them."""
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            x = int(x)
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
    return int.from_bytes(m.digest()[:4], byteorder="big")


def param_key(root: tuple, path, count: int = 1) -> tuple:
    """The key Flax's ``init({"params": root})`` draws a parameter of the
    module at ``path`` with: the module's scope folds its path and its rng
    counter, which every ``self.param`` of the scope advances, a zero
    initialiser's too (``count`` 1 for the first, the kernel or embedding
    table of a Dense or Embed; 3 for a Switch MoE's ``w2``, after ``w1``
    and ``b1``). ``root`` is ``key(seed)`` for ``model.init``, or the key a
    tree's part is initialised from (the pipeline's
    ``split(key(seed), 3)``)."""
    return fold_in_static(root, *path, count)


def scan_param_key(root: tuple, layers: int, layer: int, path,
                   count: int) -> tuple:
    """The key of layer ``layer``'s parameter ``count`` of the module at
    ``path`` inside an ``nn.scan`` over ``layers`` with
    ``split_rngs={"params": True}`` (the scanned LM's ``blocks``, the
    pipeline's ``loop``). Flax's lifted scan splits the raw ``root`` key
    (not its path-folded form) into ``layers`` keys, keeps the scope's path
    suffix and folds it on each layer's key; and its ``init`` traces the
    scan body twice on one rng counter, so the parameters come from the
    second trace: ``count`` is the module's parameter count plus the
    parameter's own 1-based place."""
    k = split(root, layers)[layer]
    return fold_in_static((int(k[0]), int(k[1])), *path, count)


def init_leaf(seed: int, path, shape, kind: str, fan_in: int,
              device=None, k=None) -> torch.Tensor:
    """One initial parameter of the reference's ``model.init`` in its JAX
    layout ``shape``, float32: ``kind`` "lecun" is Flax's default kernel
    initialiser (variance_scaling(1, "fan_in", "truncated_normal"): the
    truncated normal times √(1/fan_in) / TN_STD), "embed" the ``Embed``
    default (an untruncated normal of variance 1/fan_in). ``k``: the draw's
    key where it is not ``param_key(key(seed), path)``."""
    numel = int(np.prod(shape, dtype=np.int64))
    k = param_key(key(seed), path) if k is None else k
    sd = np.sqrt(np.float32(1.0 / fan_in))
    if kind == "lecun":
        z = draw_flat(truncated_normal_from_bits, k, numel, device)
        sd = sd / TN_STD
    elif kind == "embed":
        z = draw_flat(normal_from_bits, k, numel, device)
    else:
        raise ValueError(f"unknown initialiser {kind!r}")
    return (z * float(np.float32(sd))).view(tuple(shape))


def projection_factors(seed: int, dim: int, device="cpu") -> torch.Tensor:
    """The decode's random projection, the reference's
    ``random_projection_factors_in_graph``: ``1 + normal(fold_in(key(seed),
    7919), (dim,))`` in float32 on ``device``, drawn in pieces. The same
    vector at every step: drawn once a setup."""
    return draw_flat(normal_from_bits, fold_in(key(seed), PROJECTION_SALT),
                     dim, torch.device(device)) + 1.0
