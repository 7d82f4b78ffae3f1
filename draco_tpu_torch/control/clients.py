"""``ChunkedEngine`` clients — the loop-specific halves of the chunked host
loop (draco_tpu/control/clients.py), one a loop: what a chunk is, how it
is dispatched, which records are written and what a boundary does.

Both clients are made by their loop's ``chunk_client(first, last)`` and
expose the same names: ``ranges``, the chunks of steps [first, last]
(``batching.chunk_ranges``, snapped to ``eval_freq``), and ``many``, the
setup's chunk runner (``train_many`` or ``train_token_many``). At an
``eval_freq`` boundary each runs its loop's ``boundary`` (the eval, then
the checkpoint, ``training/run_state.py``), and a stop snaps its loop's
checkpoint (``snap_stop``).

The CNN client is also the autopilot's actuation surface
(``control/autopilot.py``): ``build_setup`` builds a regime's setup
around the Trainer's live model and state (``build_train_setup(live=)``),
``switch_regime`` points the client at it (its runner, columns and record
order), ``quarantine`` / ``readmit`` write the Trainer's presence
schedule, and ``remake`` rebuilds the chunk the engine assembled before
a swap with the new setup, from the host pieces it was assembled from:
no second prefetch, and the schedule as it was read then, so a quarantine
decided at the same boundary reaches the wire one assembled chunk later,
as the reference's ``wire_lag`` says.
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
        self.wire_segments = int(cfg.wire_segments)
        self._columns(loop.setup)

    def _columns(self, setup) -> None:
        self.block_names = setup.block_names
        # a record leads with the step and the step's schema
        self.order = ("step",) + setup.metric_names

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
    BASE_LABEL = "train_many"

    def __init__(self, tr, prefetch, first: int, last: int):
        super().__init__(tr, prefetch, tr.setup.train_many, first, last)
        self.tr = self.loop = tr
        self.setup = tr.setup
        self.label = self.BASE_LABEL
        self._pre_quarantine = {}  # worker -> its schedule column before

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

    def dispatch(self, state, chunk):
        """The chunk through the current regime's runner; a failure (a new
        regime's capture among them) names the regime's label."""
        try:
            return self.many(state, chunk)
        except RuntimeError as e:
            raise RuntimeError(f"{self.label}: {e}") from e

    def extras(self, chunk):
        out = dict(chunk.host)
        if self.tr.straggle_schedule is not None:
            out["present"] = chunk.tensors["present"].sum(1).tolist()
        return out

    def should_log(self, step):
        return step % self.tr.cfg.log_every == 0 or step == 1

    # ---- the autopilot's actuation (control/autopilot.py) ---------------
    def build_setup(self, cfg):
        """A regime's setup on the Trainer's live model and state."""
        from draco_tpu_torch.training.step import build_train_setup

        tr = self.tr
        return build_train_setup(cfg, tr.setup.device,
                                 dataset_name=tr.ds.name, live=tr.setup)

    def switch_regime(self, setup, label):
        """Dispatch ``setup``'s chunks from now on: its runner, its columns
        and its record order."""
        self.setup, self.label, self.many = setup, label, setup.train_many
        self._columns(setup)

    def remake(self, chunk):
        """``chunk`` made anew by the current setup from the host pieces it
        was assembled from."""
        return self.setup.make_chunk(*chunk.pieces)

    def quarantine(self, worker, from_step):
        """The worker's rows stop arriving from ``from_step`` on: erasures
        at a known position, decoded around as a scheduled straggler's."""
        sched = self.tr.straggle_schedule
        self._pre_quarantine[worker] = sched[:, worker].copy()
        sched[from_step:, worker] = True

    def readmit(self, worker, from_step):
        """The worker's schedule column before its quarantine, from
        ``from_step`` on (the drops it would have had stay)."""
        saved = self._pre_quarantine.pop(worker, None)
        sched = self.tr.straggle_schedule
        if saved is None:
            sched[from_step:, worker] = False
        else:
            sched[from_step:, worker] = saved[from_step:len(sched)]


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
