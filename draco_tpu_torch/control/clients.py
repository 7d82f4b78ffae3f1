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

Both clients are also the autopilot's actuation surface
(``control/autopilot.py``): ``build_setup`` builds a regime's setup
around the loop's live model and state (``build_train_setup(live=)``;
the token setup's ``rebuild``, ``build_sp_train_setup(live=)`` on the
sp route and none on tp, pp and ep), ``switch_regime`` points the client at
it (its runner, columns and record order), ``quarantine`` / ``readmit``
write the loop's presence schedule, and ``remake`` rebuilds the chunk the
engine assembled before a swap with the new setup, from the host pieces
it was assembled from: no second prefetch, and the schedule as it was
read then, so a quarantine decided at the same boundary reaches the wire
one assembled chunk later, as the reference's ``wire_lag`` says. A
chunk's records carry its host columns (``extras``): the approx decode's
bound and recovered fraction, and with a presence table each step's
arrived rows (``present``; the LM's written record keeps only its
schema's columns, as the reference's).
"""

from __future__ import annotations

from draco_tpu_torch.data.batching import chunk_ranges


class _Client:
    """What both clients share: the ranges, the runner, the prefetcher,
    the records' host columns and the autopilot's actuation; a client
    names its loop ``loop`` and its running setup ``setup``."""

    def __init__(self, loop, prefetch, first: int, last: int):
        cfg = loop.cfg
        self.loop, self.setup, self.label = loop, loop.setup, self.BASE_LABEL
        self.prefetch, self.many = prefetch, self._runner(loop.setup)
        self.first, self.last = first, last
        self._pre_quarantine = {}  # worker -> its schedule column before
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

    def boundary(self, end, state):
        self.loop.boundary(end)

    def snap_stop(self, end, already_saved):
        self.loop.stop_after(end, already_saved)

    def cleanup(self):
        if self.prefetch is not None:
            self.prefetch.close()

    # ---- the autopilot's actuation (control/autopilot.py): the loop's
    # ``straggle_schedule`` is the presence table the autopilot writes ----
    def dispatch(self, state, chunk):
        """The chunk through the current regime's runner; a failure (a new
        regime's capture among them) names the regime's label."""
        try:
            return self.many(state, chunk)
        except RuntimeError as e:
            raise RuntimeError(f"{self.label}: {e}") from e

    def switch_regime(self, setup, label):
        """Dispatch ``setup``'s chunks from now on: its runner, its columns
        and its record order."""
        self.setup, self.label = setup, label
        self.many = self._runner(setup)
        self._columns(setup)

    def remake(self, chunk):
        """``chunk`` made anew by the current setup from the host pieces it
        was assembled from."""
        return self.setup.make_chunk(*chunk.pieces)

    def quarantine(self, worker, from_step):
        """The worker's rows stop arriving from ``from_step`` on: erasures
        at a known position, decoded around as a scheduled straggler's."""
        sched = self.loop.straggle_schedule
        self._pre_quarantine[worker] = sched[:, worker].copy()
        sched[from_step:, worker] = True

    def readmit(self, worker, from_step):
        """The worker's schedule column before its quarantine, from
        ``from_step`` on (the drops it would have had stay)."""
        saved = self._pre_quarantine.pop(worker, None)
        sched = self.loop.straggle_schedule
        if saved is None:
            sched[from_step:, worker] = False
        else:
            sched[from_step:, worker] = saved[from_step:len(sched)]

    def presents(self, start, k):
        """The chunk's presence rows as the schedule reads now (None when
        every row arrives)."""
        sched = self.loop.straggle_schedule
        return None if sched is None else ~sched[start:start + k]

    def extras(self, chunk):
        """The chunk's host columns (the approx decode's bound and
        recovered fraction) and, with a presence table, each step's
        arrived rows."""
        out = dict(chunk.host)
        if self.loop.straggle_schedule is not None:
            out["present"] = chunk.tensors["present"].sum(1).tolist()
        return out


class TrainerChunkClient(_Client):
    """The CNN Trainer (training/trainer.py): a chunk is the stacked
    batches, labels, augmentation draws and masks of k steps."""

    keep = None  # a record keeps every column, as the eager loop writes
    BASE_LABEL = "train_many"

    def __init__(self, tr, prefetch, first: int, last: int):
        super().__init__(tr, prefetch, first, last)
        self.tr = tr

    @staticmethod
    def _runner(setup):
        return setup.train_many

    def assemble(self, i, ranges):
        start, k = ranges[i]
        tr = self.tr
        with tr.tracer.span("gather", chunk_start=start, k=k):
            xs, ys = self.prefetch.get(
                ranges[i], ranges[i + 1] if i + 1 < len(ranges) else None)
            return self.setup.make_chunk(start, xs, ys,
                                         tr.adv_schedule[start:start + k],
                                         self.presents(start, k))

    def should_log(self, step):
        return step % self.tr.cfg.log_every == 0 or step == 1

    # ---- the autopilot's actuation (control/autopilot.py) ---------------
    def build_setup(self, cfg):
        """A regime's setup on the Trainer's live model and state."""
        from draco_tpu_torch.training.step import build_train_setup

        tr = self.tr
        return build_train_setup(cfg, tr.setup.device,
                                 dataset_name=tr.ds.name, live=tr.setup)


class TokenChunkClient(_Client):
    """The LM token loop (parallel/token_loop.py): a chunk is the stacked
    tokens (none when the device makes them, ``token_gen="device"``: then
    no prefetcher either), the adversary and presence masks and the step
    numbers of k steps (and on the approx code the host solve's weights);
    an ``eval_freq`` boundary runs the held-out loss, then the
    checkpoint."""

    BASE_LABEL = "train_token_many"

    @staticmethod
    def _runner(setup):
        return setup.train_token_many

    def _columns(self, setup) -> None:
        super()._columns(setup)
        # a written record keeps the LM schema's columns, as the eager
        # loop writes them
        self.keep = ("step",) + setup.metric_names + ("step_ms",)

    def assemble(self, i, ranges):
        start, k = ranges[i]
        with self.loop.tracer.span("gather", chunk_start=start, k=k):
            toks = None if self.prefetch is None else self.prefetch.get(
                ranges[i], ranges[i + 1] if i + 1 < len(ranges) else None)
            return self.setup.make_chunk(
                start, toks, self.loop.adv_schedule[start:start + k],
                self.presents(start, k))

    def should_log(self, step):
        return (step % self.loop.cfg.log_every == 0
                or step in (self.first, self.last))

    # ---- the autopilot's actuation (control/autopilot.py) ---------------
    @property
    def can_swap(self) -> bool:
        return self.loop.setup.rebuild is not None

    def build_setup(self, cfg):
        """A regime's setup on the loop's live model and state (the setup's
        ``rebuild``: the sp route's; tp, pp and ep have none, as in the
        reference)."""
        rebuild = self.loop.setup.rebuild
        if rebuild is None:
            raise RuntimeError(
                "token route launched without a setup rebuild hook — "
                "autopilot family swaps unavailable on this route")
        return rebuild(cfg)
