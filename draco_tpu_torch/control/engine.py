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

The autopilot hook (``autopilot``, ``control/autopilot.py``, or None):
the engine calls ``autopilot.attach(client)`` when it is built (a later
``run()`` resumes the regime the last one ended in) and
``autopilot.act(end, engine)`` after each flush's beat, before the
boundary's eval and checkpoint, when the heartbeat and its incident engine
have folded every record up to ``end``. ``act`` reads only what the flush
materialised: it adds no fetch and no synchronisation. When it swapped the
client's setup, the chunk already assembled for the next dispatch is
re-made by the new setup (``client.remake``) from its host pieces. The
engine exposes the newest dispatched ``state`` and its ``last_end``.

``SegmentPipeline`` is the reference's decode-on-arrival loop over a
segmented wire: a measurement harness of the host-to-device seam a
segment crosses, not a part of the training step, which decodes its
segments inside the step.

The loop's compile sentinel (``compile_watch``, ``obs/compile_watch.py``)
labels each dispatch with the client's ``label`` (the regime's under the
autopilot) and the chunk's k, and its ``snapshot()`` rides every beat. The
loop's profiler window (``window``, ``obs/profiling.py``) starts before
the first chunk that reaches its first step, with that chunk's start as
its first step, and stops at the flush of the chunk that reaches its last:
whole chunks, drained before the stop.
"""

from __future__ import annotations

import time

from draco_tpu_torch.obs.compile_watch import CompileWatch
from draco_tpu_torch.obs.profiling import NULL_PROFILER_WINDOW
from draco_tpu_torch.resilience.supervisor import shielded, stop_requested
from draco_tpu_torch.utils.metrics import DeferredMetricWriter

MAX_PENDING = 4  # blocks deferred before a flush is forced


class ChunkedEngine:
    def __init__(self, client, *, eval_freq: int, tracer, writer,
                 heartbeat, total_end: int, stop=None, injector=None,
                 autopilot=None, compile_watch=None,
                 window=NULL_PROFILER_WINDOW):
        self.client = client
        # the loop's compile sentinel (an inert one without) and profiler
        # window (the no-op one without a profile dir)
        self.compile_watch = (compile_watch if compile_watch is not None
                              else CompileWatch(guard="off"))
        self.window = window
        self.eval_freq = eval_freq
        self.tracer = tracer
        self.heartbeat = heartbeat  # the loop's RunHeartbeat
        self.total_end = total_end  # the run's last step (the ETA's)
        self.deferred = DeferredMetricWriter(writer,
                                             observer=heartbeat.observe)
        self.stop = stop  # the loop's GracefulStop, or None
        self.injector = injector  # the fault plan's host events, or None
        self.autopilot = autopilot
        if autopilot is not None:
            autopilot.attach(client)
        self.state = None  # the newest dispatched state
        self.last_end = None  # and the step its chunk ended at

    def run(self, state, ranges):
        """Drive chunks over ``ranges``; returns (state, last record)."""
        client, deferred, tracer = self.client, self.deferred, self.tracer
        watch, window = self.compile_watch, self.window
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
                                    extra={**client.beat_extras(),
                                           **watch.snapshot()})
                tracer.flush()

        try:
            chunk = client.assemble(0, ranges)
            window_t0 = time.perf_counter()
            for i, (start, k) in enumerate(ranges):
                end = start + k - 1
                # the capture snaps to whole chunks
                window.maybe_start(end, first_step=start)
                # tagged with the segment count only when the wire is cut:
                # an S = 1 trace stays as it was
                span_kw = {"chunk_start": start, "k": k}
                if client.wire_segments > 1:
                    span_kw["segments"] = client.wire_segments
                with tracer.span("dispatch", **span_kw), \
                        tracer.activate(), shielded(self.stop), \
                        watch.expect(client.label, key=k):
                    state, block = client.dispatch(state, chunk)
                self.state, self.last_end = state, end
                deferred.defer(range(start, end + 1), client.block_names,
                               block, client.extras(chunk))
                window_steps += k
                pending = i + 1 < len(ranges)
                if pending:  # overlap: assemble i+1 during i
                    chunk = client.assemble(i + 1, ranges)
                boundary = bool(self.eval_freq) and end % self.eval_freq == 0
                flush = (boundary or i + 1 == len(ranges)
                         or deferred.depth >= MAX_PENDING)
                if flush:
                    drain(end)
                    if self.autopilot is not None:
                        setup = client.setup
                        self.autopilot.act(end, self)
                        if pending and client.setup is not setup:
                            chunk = client.remake(chunk)
                # before the boundary: the eval is not profiled
                window.maybe_stop(end)
                if flush:
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


class SegmentPipeline:
    """Decode-on-arrival over a segmented wire
    (draco_tpu/control/engine.py): the host-to-device transfer of each
    segment's narrow codewords and its decode, pipelined or serial.

    Hooks:

      put(j, host_segment) -> device buffer   the segment's transfer
      decode(j, device buffer) -> result      the decode's launch; must not
                                              wait for the card
      drain(result) -> None                   waits until that decode ended

    ``pipelined``: each turn launches segment j's decode, then puts segment
    j + 1 while that decode runs, then drains j, so the transfer hides
    under the decode. The serial rail (``pipelined=False``) drains before
    the next transfer: no overlap. On the card the hooks decide whether
    the overlap is real: a pageable source or a copy on the compute stream
    serialises it (``chip_smoke.py`` puts pinned segments on a copy stream
    and makes the decode wait on the copy's event).

    Each hook call runs in a tracer span (``segment_xfer``,
    ``segment_decode``, ``segment_drain``, tagged ``segment=j``) and is
    recorded in ``events`` with its host wall stamps; ``overlap_us``
    folds them."""

    def __init__(self, tracer, put, decode, drain=None, *,
                 pipelined: bool = True):
        self.tracer = tracer
        self.put = put
        self.decode = decode
        self.drain = drain
        self.pipelined = pipelined
        self.events = []  # [{name, segment, t0_s, t1_s}] host wall stamps

    def _timed(self, name, j, fn):
        t0 = time.perf_counter()
        with self.tracer.span(name, segment=j):
            out = fn()
        self.events.append({"name": name, "segment": j,
                            "t0_s": t0, "t1_s": time.perf_counter()})
        return out

    def run(self, host_segments):
        """Every segment through the hooks; the decodes' results (drained
        when there is a ``drain`` hook)."""
        n = len(host_segments)
        results = []
        if n == 0:
            return results
        dev = self._timed("segment_xfer", 0,
                          lambda: self.put(0, host_segments[0]))
        for j in range(n):
            out = self._timed("segment_decode", j,
                              lambda j=j, dev=dev: self.decode(j, dev))
            if self.pipelined:
                # the next transfer under this decode, then its drain
                if j + 1 < n:
                    dev = self._timed(
                        "segment_xfer", j + 1,
                        lambda j=j: self.put(j + 1, host_segments[j + 1]))
                if self.drain is not None:
                    self._timed("segment_drain", j,
                                lambda out=out: self.drain(out))
            else:
                # the serial rail: drain first, so nothing overlaps
                if self.drain is not None:
                    self._timed("segment_drain", j,
                                lambda out=out: self.drain(out))
                if j + 1 < n:
                    dev = self._timed(
                        "segment_xfer", j + 1,
                        lambda j=j: self.put(j + 1, host_segments[j + 1]))
            results.append(out)
        return results

    def overlap_us(self):
        """(overlapped transfer µs, decode in-flight µs): a turn's in-flight
        window runs from the end of decode j's launch to the end of its
        drain; the part of transfer j + 1 inside it was hidden. The serial
        rail's overlap is 0 by construction."""
        by_seg = {}
        for ev in self.events:
            by_seg.setdefault(ev["segment"], {})[ev["name"]] = ev
        total_inflight = 0.0
        overlapped = 0.0
        for j, evs in sorted(by_seg.items()):
            dec, drn = evs.get("segment_decode"), evs.get("segment_drain")
            if dec is None or drn is None:
                continue
            lo, hi = dec["t1_s"], drn["t1_s"]
            total_inflight += max(hi - lo, 0.0)
            nxt = by_seg.get(j + 1, {}).get("segment_xfer")
            if nxt is not None:
                overlapped += max(min(nxt["t1_s"], hi)
                                  - max(nxt["t0_s"], lo), 0.0)
        return overlapped * 1e6, total_inflight * 1e6
