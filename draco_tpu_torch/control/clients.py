"""``ChunkedEngine`` clients — the loop-specific halves of the chunked host
loop (draco_tpu/control/clients.py), one a loop: what a chunk is, how it
is dispatched, which records are written and what a boundary does. The
reference's regime switch and quarantine (its autopilot's actuation
surface) are not ported.

Both clients are made by their loop's ``chunk_client(first, last)`` and
expose the same names: ``ranges``, the chunks of steps [first, last]
(``batching.chunk_ranges``, snapped to ``eval_freq``), and ``many``, the
setup's chunk runner (``train_many`` or ``train_token_many``). At an
``eval_freq`` boundary each runs its loop's ``boundary`` (the eval, then
the checkpoint, ``training/run_state.py``), and a stop snaps its loop's
checkpoint (``snap_stop``).
"""

from __future__ import annotations

from draco_tpu_torch.data.batching import chunk_ranges


class _Client:
    """What both clients share: the ranges, the runner and the prefetcher."""

    def __init__(self, loop, prefetch, many, first: int, last: int):
        cfg = loop.cfg
        self.prefetch, self.many = prefetch, many
        self.first, self.last = first, last
        self.ranges = chunk_ranges(first, last, cfg.steps_per_call,
                                   cfg.eval_freq)
        self.block_names = loop.setup.block_names
        self.wire_segments = int(cfg.wire_segments)
        # a record leads with the step and the step's schema
        self.order = ("step",) + loop.setup.metric_names

    def beat_extras(self) -> dict:
        """The heartbeat's prefetch fields: the requests in flight and the
        prefetcher's rebuilds."""
        if self.prefetch is None:
            return {}
        out = {"prefetch_depth": self.prefetch.depth}
        stats = getattr(self.prefetch, "stats", None)
        if stats is not None:
            out.update(stats())
        return out

    def dispatch(self, state, chunk):
        return self.many(state, chunk)

    def boundary(self, end, state):
        self.loop.boundary(end)

    def snap_stop(self, end, already_saved):
        self.loop.stop_after(end, already_saved)

    def cleanup(self):
        if self.prefetch is not None:
            self.prefetch.close()


class TrainerChunkClient(_Client):
    """The CNN Trainer (training/trainer.py): a chunk is the stacked
    batches, labels, augmentation draws and masks of k steps."""

    keep = None  # a record keeps every column, as the eager loop writes

    def __init__(self, tr, prefetch, first: int, last: int):
        super().__init__(tr, prefetch, tr.setup.train_many, first, last)
        self.tr = self.loop = tr
        self.setup = tr.setup

    def assemble(self, i, ranges):
        start, k = ranges[i]
        tr = self.tr
        with tr.tracer.span("gather", chunk_start=start, k=k):
            xs, ys = self.prefetch.get(
                ranges[i], ranges[i + 1] if i + 1 < len(ranges) else None)
            presents = (None if tr.straggle_schedule is None
                        else ~tr.straggle_schedule[start:start + k])
            return self.setup.make_chunk(start, xs, ys,
                                         tr.adv_schedule[start:start + k],
                                         presents)

    def extras(self, chunk):
        out = dict(chunk.host)
        if self.tr.straggle_schedule is not None:
            out["present"] = chunk.tensors["present"].sum(1).tolist()
        return out

    def should_log(self, step):
        return step % self.tr.cfg.log_every == 0 or step == 1


class TokenChunkClient(_Client):
    """The LM token loop (parallel/token_loop.py): a chunk is the stacked
    tokens (none when the device makes them, ``token_gen="device"``: then
    no prefetcher either), the adversary masks and the step numbers of k
    steps; an ``eval_freq`` boundary runs the held-out loss, then the
    checkpoint."""

    def __init__(self, loop, prefetch, first: int, last: int):
        super().__init__(loop, prefetch, loop.setup.train_token_many, first,
                         last)
        self.loop, self.setup = loop, loop.setup
        self.keep = ("step",) + loop.setup.metric_names + ("step_ms",)

    def assemble(self, i, ranges):
        start, k = ranges[i]
        with self.loop.tracer.span("gather", chunk_start=start, k=k):
            toks = None if self.prefetch is None else self.prefetch.get(
                ranges[i], ranges[i + 1] if i + 1 < len(ranges) else None)
            return self.setup.make_chunk(
                start, toks, self.loop.adv_schedule[start:start + k])

    def extras(self, chunk):
        return {}

    def should_log(self, step):
        return (step % self.loop.cfg.log_every == 0
                or step in (self.first, self.last))
