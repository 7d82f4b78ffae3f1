"""Batch-to-worker assignments of the approximate code
(draco_tpu/coding/assignment.py, copied: pure numpy, every participant
rebuilds the same matrices from (n, r)).

  * ``pairwise`` — worker i covers the cyclic window of d_i consecutive
    batches starting at batch i, d_i = ⌊r⌋ + 1 for the first
    ``⌊(r − ⌊r⌋)·n + ½⌋`` workers and ⌊r⌋ for the rest.
  * ``clustered`` — fractional repetition: integer r = c dividing n;
    every member of cluster j computes the c batches of group j.

Encode weights W = A / column sums, so Σ_i W[i, k] = 1 and the decode
vector v = 1 recovers the exact sum when every worker arrives.
"""

from __future__ import annotations

import numpy as np

SCHEMES = ("pairwise", "clustered")


def loads_for(n: int, redundancy: float) -> np.ndarray:
    """(n,) int per-worker batch counts for the pairwise scheme: ⌊r⌋ or
    ⌊r⌋+1, summing to ⌊r·n + ½⌋ (half-up, NOT Python's banker's rounding —
    half-integer products like n=9, r=1.5 must round toward the advertised
    redundancy, never below it)."""
    base = int(np.floor(redundancy))
    extra = int(np.floor((redundancy - base) * n + 0.5))
    return np.asarray([base + (1 if i < extra else 0) for i in range(n)],
                      np.int64)


def pairwise_assignment(n: int, redundancy: float) -> np.ndarray:
    """(n, n) 0/1 pair-wise balanced cyclic-window assignment (module
    docstring). A[i, k] = 1 iff worker i computes batch k."""
    _validate(n, redundancy)
    loads = loads_for(n, redundancy)
    a = np.zeros((n, n), np.float64)
    for i in range(n):
        a[i, (i + np.arange(loads[i])) % n] = 1.0
    return a


def clustered_assignment(n: int, redundancy: float) -> np.ndarray:
    """(n, n) 0/1 fractional-repetition assignment: integer c = r dividing
    n; worker i computes the batches of group i // c (module docstring)."""
    _validate(n, redundancy)
    c = int(round(redundancy))
    if abs(redundancy - c) > 1e-9:
        raise ValueError(
            f"clustered (fractional-repetition) assignment needs integer "
            f"redundancy, got r={redundancy} (use scheme='pairwise' for "
            f"fractional r)"
        )
    if n % c != 0:
        raise ValueError(
            f"clustered assignment needs redundancy {c} to divide "
            f"num_workers {n}"
        )
    a = np.zeros((n, n), np.float64)
    for i in range(n):
        j = i // c
        a[i, j * c : (j + 1) * c] = 1.0
    return a


def build_assignment(n: int, redundancy: float, scheme: str) -> np.ndarray:
    """The (n, n) 0/1 assignment for ``scheme`` ∈ SCHEMES."""
    if scheme == "pairwise":
        return pairwise_assignment(n, redundancy)
    if scheme == "clustered":
        return clustered_assignment(n, redundancy)
    raise ValueError(
        f"unknown assignment scheme {scheme!r}; known: {'|'.join(SCHEMES)}"
    )


def encode_weights(assign: np.ndarray) -> np.ndarray:
    """Replication-normalised encode weights W = A / column-sums(A):
    Σ_i W[i, k] = 1 for every covered batch k, so v = 1 decodes the exact
    sum at full participation (module docstring). A batch nobody computes
    (possible only for degenerate hand-built assignments) keeps weight 0."""
    counts = assign.sum(axis=0)
    if (counts < 1).any():
        raise ValueError(
            f"assignment leaves batches {np.where(counts < 1)[0].tolist()} "
            f"uncovered — every batch needs at least one worker"
        )
    return assign / counts[None, :]


def _validate(n: int, redundancy: float) -> None:
    if n < 1:
        raise ValueError(f"num_workers must be >= 1, got {n}")
    if not (1.0 <= redundancy <= n):
        raise ValueError(
            f"code redundancy must lie in [1, num_workers], got "
            f"r={redundancy} at n={n}"
        )
