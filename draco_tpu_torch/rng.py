"""Deterministic randomness discipline (draco_tpu/rng.py).

The numpy schedules are copied verbatim from the reference, so both packages
derive the same adversary, straggler and shuffle streams bit for bit. The
reference's in-graph JAX draws become explicit ``torch.Generator`` s seeded
from the experiment seed: the same distributions, other numbers.
"""

from __future__ import annotations

import numpy as np
import torch


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


def fold(seed: int, *data: int) -> int:
    """Fold a sequence of ints (step ids, row ids) into one 63-bit seed for
    a ``torch.Generator`` — the counterpart of the reference's
    ``jax.random.fold_in`` chain (a splitmix64 step per item)."""
    mask = (1 << 64) - 1
    x = seed & mask
    for d in data:
        x = (x ^ ((int(d) + 0x9E3779B97F4A7C15) & mask)) & mask
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & mask
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & mask
        x ^= x >> 31
    return x & ((1 << 63) - 1)


def generator(seed: int, *data: int, device="cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from (seed, *data)."""
    g = torch.Generator(device=device)
    g.manual_seed(fold(seed, *data))
    return g


def random_projection_factors(seed: int, dim: int) -> torch.Tensor:
    """The decode-side random projection vector: normal with loc=1,
    deterministic in ``seed`` (reference:
    ``random_projection_factors_in_graph``, the same distribution from a
    different generator), drawn on the host so every device gets the same
    vector. Decode is exact for any draw."""
    g = generator(seed, 7919)
    return 1.0 + torch.randn(dim, generator=g, dtype=torch.float32)
