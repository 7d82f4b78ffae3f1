"""Chunk assembly on a worker thread for the chunked loops
(draco_tpu/data/prefetch.py).

``get((start, k), next_range)`` returns the chunk of steps [start,
start + k) and at once submits ``next_range``'s assembly to one worker
thread, so the host builds chunk i+1 while the card runs chunk i:

  ``ChunkPrefetcher``       the CNN Trainer's (k, n, B, ...) images and
                            (k, n, B) labels, gathered from the dataset by
                            a (k, n·B) index block
                            (``batching.indices_*_range``)
  ``TokenChunkPrefetcher``  the LM loop's (k, n, B, T) tokens, generated
                            step by step (``sp_step.synthetic_text``)

Every wait on the worker is bounded by ``timeout_s`` (0 = unbounded; the
chunked loops pass ``cfg.prefetch_timeout_s``): a dead or hung worker
raises :class:`PrefetchStallError` instead of wedging the loop; an
exception in the worker propagates as itself. With ``cfg.prefetch_restarts``
> 0 the loops wrap their prefetcher in ``resilience/supervisor.py``'s
``SupervisedPrefetcher``, which rebuilds a failed one (``abandon`` drops it
without joining its worker) and retries the request. The reference's native
row-gather pool is not ported: the gather here is numpy on the worker
thread.
"""

from __future__ import annotations

import concurrent.futures
from typing import Callable, Optional

import numpy as np

from draco_tpu_torch.obs.tracer import NULL_TRACER


class PrefetchStallError(RuntimeError):
    """A wait on the prefetch worker exceeded its bound: the worker thread
    is dead or hung."""

    def __init__(self, request, timeout_s: float):
        super().__init__(
            f"prefetch wait for request {request!r} exceeded {timeout_s:g}s "
            f"(worker thread dead or hung)")
        self.request = request
        self.timeout_s = timeout_s


class _ChunkPrefetcher:
    """The double-buffer contract both prefetchers share; subclasses say
    what one chunk is (``_assemble``)."""

    name = "chunk-prefetch"

    def __init__(self, tracer, timeout_s: float):
        self._tracer = tracer
        self._timeout_s = float(timeout_s)
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=self.name)
        self._inflight: Optional[tuple] = None  # (range, future)
        self._stalled = False  # a stall was seen: never join this pool

    @property
    def depth(self) -> int:
        """In-flight background assemblies (0 or 1)."""
        return int(self._inflight is not None)

    def _assemble(self, rng: tuple):
        raise NotImplementedError

    def _timed_assemble(self, rng: tuple):
        with self._tracer.span("prefetch.assemble", chunk_start=rng[0],
                               k=rng[1]):
            return self._assemble(rng)

    def _wait(self, rng: tuple, future):
        try:
            return future.result(self._timeout_s or None)
        except concurrent.futures.TimeoutError:
            self._stalled = True
            raise PrefetchStallError(rng, self._timeout_s) from None

    def get(self, rng: tuple, next_range: Optional[tuple] = None):
        rng = tuple(rng)
        if self._inflight is not None and self._inflight[0] == rng:
            with self._tracer.span("prefetch.wait"):
                inflight, self._inflight = self._inflight, None
                out = self._wait(rng, inflight[1])
        else:  # cold start, or a request out of sequence
            if self._inflight is not None:
                inflight, self._inflight = self._inflight, None
                self._wait(inflight[0], inflight[1])
            # on the worker too, under the bounded wait: a hung source
            # must not hang the main thread
            out = self._wait(rng, self._pool.submit(self._timed_assemble,
                                                    rng))
        if next_range is not None:
            nxt = tuple(next_range)
            self._inflight = (nxt, self._pool.submit(self._timed_assemble,
                                                     nxt))
        return out

    def abandon(self) -> None:
        """Drop the in-flight request and the worker without waiting for
        it (the supervisor's restart path: the worker may be hung)."""
        self._inflight = None
        self._pool.shutdown(wait=False, cancel_futures=True)

    def close(self) -> None:
        if not self._stalled and self._inflight is not None:
            inflight, self._inflight = self._inflight, None
            try:
                self._wait(inflight[0], inflight[1])
            except Exception:
                pass  # closing: a failed or stalled tail fetch is dropped
        self._inflight = None
        # a hung worker is abandoned, not joined
        self._pool.shutdown(wait=not self._stalled, cancel_futures=True)


class ChunkPrefetcher(_ChunkPrefetcher):
    """(k, n, B, ...) images and (k, n, B) labels of steps [start,
    start + k). ``range_indices_fn``: (start, k) -> (k, n·B) sample
    indices."""

    name = "chunk-prefetch"

    def __init__(self, ds, range_indices_fn: Callable, num_workers: int,
                 batch_size: int, *, timeout_s: float, tracer=NULL_TRACER):
        super().__init__(tracer, timeout_s)
        self.ds = ds
        self.range_indices_fn = range_indices_fn
        self.num_workers = num_workers
        self.batch_size = batch_size

    def _assemble(self, rng: tuple):
        k = rng[1]
        idx = self.range_indices_fn(*rng).reshape(-1)
        x = self.ds.train_x[idx]
        shape = (k, self.num_workers, self.batch_size)
        return (x.reshape(shape + x.shape[1:]),
                self.ds.train_y[idx].reshape(shape))


class TokenChunkPrefetcher(_ChunkPrefetcher):
    """(k, n, B, T) int32 tokens of steps [start, start + k).
    ``gen_fn``: step -> (n, B, T) tokens."""

    name = "token-chunk-prefetch"

    def __init__(self, gen_fn: Callable[[int], np.ndarray],
                 *, timeout_s: float, tracer=NULL_TRACER):
        super().__init__(tracer, timeout_s)
        self._gen = gen_fn

    def _assemble(self, rng: tuple) -> np.ndarray:
        start, k = rng
        return np.stack([self._gen(step) for step in range(start, start + k)])
