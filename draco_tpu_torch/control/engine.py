"""The chunked host loop — ``ChunkedEngine`` (draco_tpu/control/engine.py),
one implementation for the CNN Trainer and the LM token loop.

Per chunk i of ``ranges`` (``batching.chunk_ranges``): dispatch it (the
client's ``train_many``: on the card k replays of the captured step, which
return at once), defer its (k, m) metrics block, then assemble chunk i+1
on the host while the card runs chunk i. At a flush boundary — an
``eval_freq`` multiple, the last chunk, or 4 blocks pending — the host
fetches every pending block in one copy (the loop's one synchronisation)
and writes the records; at an ``eval_freq`` boundary the client then runs
its eval and checkpoint, which read the state after that fetch, on the
stream the chunk replayed on. After every chunk the engine asks whether a
stop was requested (``stop``, the loop's ``GracefulStop``): if so it
fetches and writes what is pending and the client snaps the loop's
checkpoint at the chunk's end. Each dispatch runs shielded: a second
signal's error waits until the chunk's replays are all queued, so the
state the loop then saves is a whole chunk's. A chunked record's
``step_ms`` is the flush window's wall time (host clock, from the
window's first dispatch to its fetch) divided by its steps, as the
reference's chunked ``t_comp`` is.

The run heartbeat (``obs/heartbeat.py``, the loop's ``heartbeat``)
observes every record a flush makes — the records the flush materialises
anyway, as the deferred writer's observer — and beats once a flush,
after the records are written: no fetch and no synchronisation of its
own.

Host spans (``obs/tracer.py``), the reference engine's names: ``gather``
(the client's assembly) and ``dispatch`` once a chunk with ``chunk_start``
and ``k`` (and ``segments`` on a segmented wire, S > 1), ``sync`` (the
fetch) and ``flush`` (the records) once a flush with ``at_step``. The step's draco_* phases run inside ``dispatch``: on
the card only in the capture, on the CPU in every step.

Client protocol (``control/clients.py``):

  ranges                      the chunks of the client's steps
  many                        the setup's chunk runner (its ``graph()``)
  block_names                 the columns of the chunk's metrics block
  wire_segments               the wire's segments (cfg.wire_segments)
  keep                        the columns a written record keeps, or None
  order                       the columns that lead a record, or None
  assemble(i, ranges)         chunk i on the host (a ``Chunk``)
  dispatch(state, chunk)      -> (state, block)
  extras(chunk)               host columns of the chunk's records, or {}
  should_log(step)            the loop's metrics.jsonl cadence
  beat_extras()               the heartbeat's extra fields (prefetch)
  boundary(end, state)        the eval and checkpoint at an eval_freq
                              boundary
  snap_stop(end, saved)       the stop's checkpoint at ``end`` (unless the
                              boundary just saved it)
  cleanup()                   always runs on exit (close the prefetcher)

The stop poll delivers the fault plan's due ``sigterm`` events first
(``injector``, the loop's ``resilience/faults.HostFaultInjector``).

Not ported: the reference engine's compile watch, profiler window and
its autopilot hook.
"""

from __future__ import annotations

import time

from draco_tpu_torch.resilience.supervisor import shielded, stop_requested
from draco_tpu_torch.utils.metrics import DeferredMetricWriter

MAX_PENDING = 4  # blocks deferred before a flush is forced


class ChunkedEngine:
    def __init__(self, client, *, eval_freq: int, tracer, writer,
                 heartbeat, total_end: int, stop=None, injector=None):
        self.client = client
        self.eval_freq = eval_freq
        self.tracer = tracer
        self.heartbeat = heartbeat  # the loop's RunHeartbeat
        self.total_end = total_end  # the run's last step (the ETA's)
        self.deferred = DeferredMetricWriter(writer,
                                             observer=heartbeat.observe)
        self.stop = stop  # the loop's GracefulStop, or None
        self.injector = injector  # the fault plan's host events, or None

    def run(self, state, ranges):
        """Drive chunks over ``ranges``; returns (state, last record)."""
        client, deferred, tracer = self.client, self.deferred, self.tracer
        if not ranges:
            return state, {}
        window_t0, window_steps = time.perf_counter(), 0

        def drain(end):
            """Every pending block in one fetch, then its records."""
            with tracer.span("sync", at_step=end):
                deferred.fetch()
            step_ms = ((time.perf_counter() - window_t0) * 1e3
                       / max(window_steps, 1))
            with tracer.span("flush", at_step=end):
                deferred.flush(client.should_log, {"step_ms": step_ms},
                               client.keep, client.order)
                self.heartbeat.beat(end, self.total_end,
                                    extra=client.beat_extras())
                tracer.flush()

        try:
            chunk = client.assemble(0, ranges)
            window_t0 = time.perf_counter()
            for i, (start, k) in enumerate(ranges):
                end = start + k - 1
                # tagged with the segment count only when the wire is cut:
                # an S = 1 trace stays as it was
                span_kw = {"chunk_start": start, "k": k}
                if client.wire_segments > 1:
                    span_kw["segments"] = client.wire_segments
                with tracer.span("dispatch", **span_kw), \
                        tracer.activate(), shielded(self.stop):
                    state, block = client.dispatch(state, chunk)
                deferred.defer(range(start, end + 1), client.block_names,
                               block, client.extras(chunk))
                window_steps += k
                if i + 1 < len(ranges):  # overlap: assemble i+1 during i
                    chunk = client.assemble(i + 1, ranges)
                boundary = bool(self.eval_freq) and end % self.eval_freq == 0
                if boundary or i + 1 == len(ranges) \
                        or deferred.depth >= MAX_PENDING:
                    drain(end)
                    if boundary:
                        client.boundary(end, state)
                    window_t0, window_steps = time.perf_counter(), 0
                if stop_requested(self.stop, self.injector, end):
                    # a chunk's end is a legal stop point mid-window: the
                    # pending records first, then the checkpoint
                    drain(end)
                    client.snap_stop(end, boundary)
                    break
        finally:
            client.cleanup()
        return state, deferred.last
