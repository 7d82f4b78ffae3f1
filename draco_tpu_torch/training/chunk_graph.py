"""The K-fused chunk: one training step captured as a CUDA graph once and
replayed k ≤ K times a chunk — the port's counterpart of the reference's
``jax.jit(many_body)`` over ``lax.scan`` (draco_tpu/training/step.py:
713-728), which fuses K coded steps into one device program.

A :class:`StepGraph` holds, on the step's device,

  staging   one (K, ...) buffer per per-step host input (the batch, labels,
            augmentation draws, adversary and presence masks, the approx
            decode's v/n and presence, the vote's two fingerprint salts,
            the (K,) int32 step numbers), filled once per chunk; row
            ``cursor`` of the steps is the step whose draws the replay
            makes on the device (``ops/draws.py``)
  cursor    an int64 0-d tensor: the step of the chunk being run
  block     the (K, m) float32 metrics block, row ``cursor`` per step

and its step reads row ``cursor`` of each staging buffer (``index_select``),
runs the step body, writes its metrics into row ``cursor`` of the block
(``index_copy_``) and advances the cursor. A chunk fills the staging
buffers, zeroes the cursor (``fill_``) and runs that step k times; the
remainder chunks that ``batching.chunk_ranges`` makes at ``eval_freq`` run
it fewer times. The run returns a copy of the block's first k rows, not yet
read by the host.

On the card the step is captured once per :class:`StepGraph` and every
step of every chunk is a replay: the host makes no synchronising call
inside a chunk. Before the capture one warm-up step runs on a side stream
(the lazy kernel loads, the cuDNN and cuBLAS handles, the allocator's
growth); it trains, so the state is snapshotted first and restored after
in place (:class:`StateSnapshot`), keeping every captured address valid.
The staging buffers are filled from two pinned host slots taken in turn,
each guarded by an event, so filling chunk i+1's slot never overwrites the
source of a copy still queued; the copy itself is queued on the step's
stream, behind chunk i's replays. A failed capture or replay raises with
the failing operation named; nothing falls back to the eager loop.

Several setups may share one state: the autopilot's regimes
(``control/autopilot.py``, ``training/step.build_train_setup(live=)``)
each hold their own StepGraph over the same parameter, momentum,
statistics and count tensors. A regime's graph is captured at its first
chunk, mid-run: its warm-up restores the shared state in place, so the
new graph's first replay reads the state the previous graph left, bit for
bit; a return to a regime replays the graph it captured then
(``captures`` stays 1). The capture keeps ``torch.cuda.graph``'s default
``capture_error_mode`` ("global": a CUDA call from another thread that is
illegal during a capture fails it) while the chunked loop's prefetch
thread runs. That thread makes no CUDA call: it gathers numpy arrays from
the dataset and writes host tracer spans (``data/prefetch.py``); every
pinned-buffer fill, copy to the card and event of a chunk is made on the
main thread, at dispatch (``_load``), before the capture begins. Python's
garbage collection, which could free another graph's CUDA objects from
any thread, is off for the whole process during the capture.

The capture is a compile event (``obs/compile_watch.report``: a
``graph_capture`` of the graph's name with the warm-up's and the capture's
wall seconds), which the loops' compile sentinel labels and guards. While a
profiler window is open (``obs/profiling.py``), the warm-up step maps the
graph's kernels to the step's phases (``_warm_up``) and each replay runs in
a ``draco_graph_replay::<name>`` range, so the device fold can attribute a
replay's kernels, which carry no ranges of their own
(``obs/device_attr.py``).

On the CPU the same cursor-indexed step runs k times from a Python loop:
no graph, the chunk's plain version, which the CPU tests hold bit for bit
to k eager steps.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from draco_tpu_torch.obs import compile_watch, device_attr, profiling
from draco_tpu_torch.obs.device_attr import REPLAY_RANGE, WARMUP_RANGE


@dataclasses.dataclass
class Chunk:
    """One chunk of steps [start, start + k), assembled on the host.

    ``tensors``: input name -> (k, ...) host tensor, staged on the device.
    Every per-step host value the step reads is staged here; every draw
    is made on the device from the staged step number (augmentation,
    dropout, the vote's salts, the random attack, stochastic rounding, the
    LM's device tokens): the captured step never seeds a host
    generator.
    ``host``: column name -> k host values, known at assembly (the approx
    decode's bound and recovered fraction, the presence count): they go
    into the records at the flush, not through the device.
    ``pieces``: the host arguments the chunk was made from (``make_chunk``'s
    start, batches, labels, adversary and presence rows as read at
    assembly), from which another setup re-makes it after a regime swap
    (``control/clients.py``)."""

    start: int
    k: int
    tensors: dict
    host: dict = dataclasses.field(default_factory=dict)
    pieces: tuple = ()


class StateSnapshot:
    """Copies of a set of state tensors; :meth:`restore` writes them back
    in place, so each tensor keeps its storage."""

    def __init__(self, tensors: dict):
        self._live = tensors
        with torch.no_grad():
            self.saved = {k: v.detach().clone() for k, v in tensors.items()}

    @torch.no_grad()
    def restore(self) -> None:
        for k, v in self._live.items():
            v.copy_(self.saved[k])


def warm_up(step: Callable[[], object], tensors: dict) -> None:
    """Run ``step`` once and leave ``tensors`` (the parameters, momentum
    buffers and statistics it updates) as they were, in place."""
    snap = StateSnapshot(tensors)
    step()
    snap.restore()


class _LastOp(TorchDispatchMode):
    """The last operator dispatched, to name a failing capture's."""

    def __init__(self):
        super().__init__()
        self.last = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.last = str(func)
        return func(*args, **(kwargs or {}))


class StepGraph:
    """One step of a training setup, run k ≤ K times a chunk (module
    docstring). ``body(inputs) -> row``: the step on one step's inputs
    (name -> device tensor), its ``columns`` metrics as a (m,) tensor;
    ``state_tensors()``: the tensors the step updates in place."""

    def __init__(self, name: str, device: torch.device, K: int,
                 columns: tuple, body: Callable[[dict], torch.Tensor],
                 state_tensors: Callable[[], dict]):
        if K < 1:
            raise ValueError(f"K must be >= 1, got {K}")
        self.name, self.device, self.K = name, device, K
        self.columns = tuple(columns)
        self._body = body
        self._state_tensors = state_tensors
        self.cursor = torch.zeros((), dtype=torch.int64, device=device)
        self.block = torch.zeros((K, len(self.columns)), dtype=torch.float32,
                                 device=device)
        self.stage: Optional[dict] = None
        self.graph = None
        self.pool_bytes = 0  # what the capture allocated in its pool
        self.captures = 0  # captures of the step (at most one a graph)
        self.slot_waits = 0  # chunk loads that found their slot still busy
        self._slots: list = []
        self._events: list = []
        self._turn = 0

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def step(self) -> None:
        """The cursor-indexed step: inputs of row ``cursor``, metrics into
        row ``cursor``, cursor + 1."""
        idx = self.cursor.view(1)
        row = self._body({name: buf.index_select(0, idx)[0]
                          for name, buf in self.stage.items()})
        self.block.index_copy_(0, idx, row.to(torch.float32)[None])
        self.cursor.add_(1)

    def run(self, chunk: Chunk) -> torch.Tensor:
        """The chunk's k steps; returns their (k, m) metrics rows on the
        device (the host has not waited for them)."""
        k = chunk.k
        if not 1 <= k <= self.K:
            raise ValueError(f"{self.name}: a chunk of {k} steps, the graph "
                             f"stages K={self.K}")
        self._load(chunk)
        self.cursor.fill_(0)
        if not self.on_card:
            for _ in range(k):
                self.step()
            return self.block[:k].clone()
        if self.graph is None:
            self._capture()
            self.cursor.fill_(0)  # the warm-up step advanced it
        for i in range(k):
            try:
                if torch.autograd._profiler_enabled():
                    # names the replay's program for the device fold
                    with torch.profiler.record_function(
                            REPLAY_RANGE + self.name):
                        self.graph.replay()
                else:
                    self.graph.replay()
            except RuntimeError as e:
                raise RuntimeError(f"{self.name}: replay {i + 1} of {k} of "
                                   f"the captured step failed: {e}") from e
        return self.block[:k].clone()

    # ---- staging ---------------------------------------------------------
    def _allocate(self, chunk: Chunk) -> None:
        def buf(t, **kw):
            return torch.empty((self.K,) + tuple(t.shape[1:]), dtype=t.dtype,
                               **kw)

        self.stage = {n: buf(t, device=self.device)
                      for n, t in chunk.tensors.items()}
        if self.on_card:
            self._slots = [{n: buf(t, pin_memory=True)
                            for n, t in chunk.tensors.items()}
                           for _ in range(2)]
            self._events = [None, None]

    def _load(self, chunk: Chunk) -> None:
        if self.stage is None:
            self._allocate(chunk)
        if set(chunk.tensors) != set(self.stage):
            raise ValueError(f"{self.name}: chunk inputs {sorted(chunk.tensors)}"
                             f", staged {sorted(self.stage)}")
        k = chunk.k
        for name, t in chunk.tensors.items():
            if t.shape[0] != k or t.shape[1:] != self.stage[name].shape[1:] \
                    or t.dtype != self.stage[name].dtype:
                raise ValueError(
                    f"{self.name}: input {name} {t.dtype} {tuple(t.shape)}, "
                    f"staged {self.stage[name].dtype} "
                    f"{tuple(self.stage[name].shape)} for k={k}")
        if not self.on_card:
            for name, t in chunk.tensors.items():
                self.stage[name][:k].copy_(t)
            return
        turn, self._turn = self._turn, self._turn ^ 1
        slot, event = self._slots[turn], self._events[turn]
        if event is not None and not event.query():
            # the copy from this slot two chunks ago is still queued
            self.slot_waits += 1
            event.synchronize()
        for name, t in chunk.tensors.items():
            slot[name][:k].copy_(t)
            self.stage[name][:k].copy_(slot[name][:k], non_blocking=True)
        if event is None:
            event = self._events[turn] = torch.cuda.Event()
        event.record()

    # ---- capture ---------------------------------------------------------
    def _warm_up(self) -> None:
        """The warm-up step. While a profiler window is open
        (``obs/profiling.open_window``) its kernels are mapped to the
        step's phases for the device fold (``obs/device_attr.py``) by a
        ``draco_graph_warmup::<name>`` range around the step (not the
        state's snapshot and restore): inside a running window the fold
        reads the map from the window's own capture; otherwise the step
        runs under a profiler of its own and its map is written to the
        window's ``device_graph_map.json``."""
        window = profiling.open_window()
        if window is None:
            warm_up(self.step, self._state_tensors())
            return

        def step():
            with torch.profiler.record_function(WARMUP_RANGE + self.name):
                self.step()

        if torch.autograd._profiler_enabled():
            warm_up(step, self._state_tensors())
            return
        from torch.profiler import ProfilerActivity, profile

        from draco_tpu_torch.analysis.rules import export_trace

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            warm_up(step, self._state_tensors())
            torch.cuda.synchronize(self.device)
        events = export_trace(prof)["traceEvents"]
        device_attr.save_graph_map(
            window.dir, self.name,
            device_attr.warmup_maps(events).get(self.name, []))

    def _capture(self) -> None:
        """Warm-up step on a side stream with the state restored in place
        after it, then the capture of one step; the two are reported to the
        compile sentinel as one ``graph_capture`` with their wall seconds
        (``obs/compile_watch.py``)."""
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self._warm_up()
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        watch = _LastOp()
        torch.cuda.synchronize(self.device)
        torch.cuda.reset_peak_memory_stats(self.device)
        base = torch.cuda.memory_allocated(self.device)
        # no garbage collection inside the capture: a pass there could
        # destroy an earlier setup's graph or events, whose CUDA calls
        # invalidate the capture (torch.cuda.graph collects before it
        # begins)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                with watch:
                    self.step()
        except Exception as e:
            raise RuntimeError(
                f"{self.name}: CUDA graph capture of the step failed after "
                f"{watch.last or 'no operator'}: {e}") from e
        finally:
            if collecting:
                gc.enable()
        self.pool_bytes = torch.cuda.max_memory_allocated(self.device) - base
        self.graph = graph
        self.captures += 1
        compile_watch.report("graph_capture", self.name,
                             time.perf_counter() - t0, k=self.K,
                             pool_bytes=self.pool_bytes)
