"""Deterministic batch construction (draco_tpu/data/batching.py, copied),
and the chunked loops' step ranges.

  * baseline: each worker draws an independent shuffle.
  * maj_vote: the members of a repetition group share their group's
    shuffle (``rng.group_seeds``), so they compute identical batches.
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


def indices_grouped(n_samples: int, step: int, num_workers: int, group_size: int,
                    batch_size: int, seeds: np.ndarray) -> np.ndarray:
    """(n·B,) flat indices where group members share the shuffle (identical
    batches within a group). ``seeds`` from rng.group_seeds."""
    bpe = max(n_samples // batch_size, 1)
    epoch, off = _epoch_and_offset(step, bpe)
    return np.concatenate([
        _perm_slice(drng.epoch_permutation(int(seeds[w // group_size]), epoch, n_samples),
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


# ---- step ranges: the chunked loops' index path ----------------------------
#
# The chunked loops (``steps_per_call`` K > 1) feed K steps a dispatch, so
# they want all K steps' indices at once. Each *_range function returns a
# (k, n·B) block whose row i equals the per-step function at step0 + i bit
# for bit; one permutation a (stream, epoch) instead of one a step.


def _perm_rows(perm_for_epoch, epochs: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Gather ``perm_for_epoch(e)[cols[i]]`` for each step row i (epochs[i]=e),
    fetching each epoch's permutation once."""
    out = np.empty(cols.shape, dtype=np.int64)
    for e in np.unique(epochs):
        rows = epochs == e
        out[rows] = perm_for_epoch(int(e))[cols[rows]]
    return out


def _range_cols(offs: np.ndarray, width: int, n_samples: int) -> np.ndarray:
    """(k, width) positions of each step's slice, wrap folded in: identical to
    ``_perm_slice``'s take-then-wrap for every width <= n_samples."""
    starts = (offs * width) % n_samples
    return (starts[:, None] + np.arange(width)[None, :]) % n_samples


def indices_baseline_range(n_samples: int, step0: int, k: int, num_workers: int,
                           batch_size: int, seed: int) -> np.ndarray:
    """(k, n·B) stacked flat indices; row i == indices_baseline(step0 + i)."""
    bpe = max(n_samples // batch_size, 1)
    steps = np.arange(step0, step0 + k)
    epochs, offs = steps // bpe, steps % bpe
    cols = _range_cols(offs, batch_size, n_samples)
    out = np.empty((k, num_workers * batch_size), dtype=np.int64)
    for w in range(num_workers):
        out[:, w * batch_size : (w + 1) * batch_size] = _perm_rows(
            lambda e, w=w: drng.epoch_permutation(seed + 31 * (w + 1), e, n_samples),
            epochs, cols,
        )
    return out


def indices_grouped_range(n_samples: int, step0: int, k: int, num_workers: int,
                          group_size: int, batch_size: int,
                          seeds: np.ndarray) -> np.ndarray:
    """(k, n·B) stacked flat indices; row i == indices_grouped(step0 + i)."""
    bpe = max(n_samples // batch_size, 1)
    steps = np.arange(step0, step0 + k)
    epochs, offs = steps // bpe, steps % bpe
    cols = _range_cols(offs, batch_size, n_samples)
    out = np.empty((k, num_workers * batch_size), dtype=np.int64)
    for w in range(num_workers):
        out[:, w * batch_size : (w + 1) * batch_size] = _perm_rows(
            lambda e, w=w: drng.epoch_permutation(
                int(seeds[w // group_size]), e, n_samples),
            epochs, cols,
        )
    return out


def indices_cyclic_range(n_samples: int, step0: int, k: int, num_workers: int,
                         batch_size: int, seed: int) -> np.ndarray:
    """(k, n·B) stacked flat indices; row i == indices_cyclic(step0 + i)."""
    global_bs = num_workers * batch_size
    bpe = max(n_samples // global_bs, 1)
    steps = np.arange(step0, step0 + k)
    epochs, offs = steps // bpe, steps % bpe
    cols = _range_cols(offs, global_bs, n_samples)
    return _perm_rows(
        lambda e: drng.epoch_permutation(seed, e, n_samples), epochs, cols
    )


def chunk_ranges(start: int, last: int, steps_per_call: int,
                 eval_freq: int) -> list:
    """[(start, k), ...] covering 1-based steps [start, last]: chunks of up
    to ``steps_per_call`` steps, snapped so every ``eval_freq`` multiple (and
    the final step) ends a chunk. The one chunk-boundary rule of both
    chunked loops (the CNN Trainer and the LM token loop)."""
    K = max(steps_per_call, 1)
    out = []
    s = start
    while s <= last:
        e = min(s + K - 1, last)
        if eval_freq:
            e = min(e, ((s - 1) // eval_freq + 1) * eval_freq)
        out.append((s, e - s + 1))
        s = e + 1
    return out
