"""Deterministic batch construction (draco_tpu/data/batching.py, copied).

  * baseline: each worker draws an independent shuffle.
  * cyclic: every worker addresses one deterministic *global* batch of n·B
    consecutive post-shuffle samples per step and computes the ŝ=2s+1
    sub-batches its row of the support mask selects.

All return numpy arrays with a leading worker axis.
"""

from __future__ import annotations

import numpy as np

from draco_tpu_torch import rng as drng
from draco_tpu_torch.data.datasets import Dataset


def get_batch(ds: Dataset, indices: np.ndarray):
    """Fetch an explicit index set as one batch."""
    return ds.train_x[indices], ds.train_y[indices]


def _epoch_and_offset(step: int, batches_per_epoch: int):
    return step // batches_per_epoch, step % batches_per_epoch


def _perm_slice(perm: np.ndarray, off: int, batch_size: int, n_samples: int):
    idx = perm[(off * batch_size) % n_samples :][:batch_size]
    if len(idx) < batch_size:  # wrap
        idx = np.concatenate([idx, perm[: batch_size - len(idx)]])
    return idx


def indices_baseline(n_samples: int, step: int, num_workers: int, batch_size: int,
                     seed: int) -> np.ndarray:
    """(n·B,) flat sample indices — each worker has its own shuffle stream."""
    bpe = max(n_samples // batch_size, 1)
    epoch, off = _epoch_and_offset(step, bpe)
    return np.concatenate([
        _perm_slice(drng.epoch_permutation(seed + 31 * (w + 1), epoch, n_samples),
                    off, batch_size, n_samples)
        for w in range(num_workers)
    ])


def indices_cyclic(n_samples: int, step: int, num_workers: int, batch_size: int,
                   seed: int) -> np.ndarray:
    """(n·B,) flat indices of the step's deterministic global batch."""
    global_bs = num_workers * batch_size
    bpe = max(n_samples // global_bs, 1)
    epoch, off = _epoch_and_offset(step, bpe)
    perm = drng.epoch_permutation(seed, epoch, n_samples)
    start = off * global_bs
    idx = perm[start : start + global_bs]
    if len(idx) < global_bs:
        idx = np.concatenate([idx, perm[: global_bs - len(idx)]])
    return idx


def gather(ds: Dataset, idx: np.ndarray, num_workers: int, batch_size: int):
    """Indices -> (n, B, ...) batches + (n, B) labels."""
    x, y = get_batch(ds, idx)
    return (
        x.reshape((num_workers, batch_size) + x.shape[1:]),
        y.reshape(num_workers, batch_size),
    )
