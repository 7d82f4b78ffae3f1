"""The LM training loop (draco_tpu/parallel/token_loop.py): one step a
call, or K-step chunks at ``steps_per_call`` K > 1.

Step t (1-based) trains on ``synthetic_text(seed, t, ...)`` with row t of
the seeded adversary schedule and, under ``straggle_mode="drop"`` (or the
fault plan's ``straggle`` events), the negation of row t of the straggler
schedule as its presence mask (``LoopRunState.straggle_table``, the
Trainer's table). The first, the last and every
``log_every``-th record go to ``<train_dir>/metrics.jsonl`` under the
reference's column names, and every ``eval_freq``-th step adds the
held-out loss on ``synthetic_text(seed + 1, 0, ...)`` as ``{"step",
"split": "eval", "loss"}``, then, with a ``train_dir``, a checkpoint
(``model_step_k.dcg``); with ``eval_freq`` 0 the last step's state is
saved instead, as the reference does. ``cfg.checkpoint_step`` resumes
(k, or −1 for the newest loadable checkpoint, through the walk-back), and
the LM then runs ``steps`` more steps from the resumed one, the
reference's LM semantics (the CNN Trainer runs to ``max_steps``). SIGTERM
stops at the next step or chunk end with a checkpoint
(``training/run_state.py``).

The eager loop (K = 1) synchronises each step's metrics to the host. The
chunked loop (K > 1, or any K under the autopilot; ``_run_chunked``, the
reference's ``_run_chunked`` at sp=1) runs chunks of up to K steps
(``batching.chunk_ranges``, snapped so every ``eval_freq`` multiple ends
a chunk) through ``setup.train_token_many`` — on the card one captured
CUDA graph replayed — driven by ``control.engine.ChunkedEngine``: the next
chunk's tokens are generated on a worker thread (``data/prefetch.py``)
while the card runs the current one, the metrics reach the host once a
flush, and the eval runs at the ``eval_freq`` boundaries, after the
flush; a chunked record's ``step_ms`` is its flush window's wall time over
its steps. With ``cfg.token_gen="device"`` the step makes its tokens on
the device from the staged step number (``sp_step
.synthetic_text_in_graph``): the eager step uploads no tokens, and a chunk
stages its K step numbers and masks with no token block and no prefetch
thread. (The reference runs its chunked loop even at K = 1 in that
mode; the port's eager step gives the same tokens and state.) The
held-out loss reads the host stream in both modes, as the reference's
does. With ``cfg.trace_dir`` set, the host phases (gather, dispatch,
sync, flush, eval) and the step's draco_* phases go to
``trace_dir/trace.json`` (``obs/tracer.py``). With a ``train_dir`` the
run heartbeat (``obs/heartbeat.py``) keeps ``status.json``: it observes
the records the loop writes (the eager loop's logged steps, as the
reference's; every record of a chunked flush), beats at each flush, at
an ``eval_freq`` boundary and at the last step, carries the run's wire
ledger and ends ``done``, ``preempted`` or ``crashed``. Mask columns come
to the host as their exact integer words (``obs/forensics.record_value``).
With ``incident_watch="on"`` the heartbeat feeds the incident engine
(``obs/incidents.make_engine``: ``incidents.jsonl``, the status.json
incidents block). The seeded fault plan (``resilience/faults.py``): its
over_budget and adversary events overlay the adversary schedule and its
straggle events the straggler schedule (each time they are made, past
``max_steps`` on a resume too), its host events wrap the host token
function (retried by the supervised prefetcher, or the eager loop's
supervised direct source) and come with the stop polls.

With ``cfg.autopilot="on"`` (``control/autopilot.py``, through
``control/clients.TokenChunkClient``) the loop runs chunked, at K = 1 in
chunks of one step (the reference runs its chunked driver there with
device tokens, which ``config.validate`` then admits), and its straggler
table exists from the start, all present when the configuration drops
none: the autopilot quarantines by writing it. The autopilot is built
once (``_make_autopilot``) and kept across ``run()`` calls; a longer
table gets its active quarantines stamped on again.
"""

from __future__ import annotations

import time
from typing import Optional

from draco_tpu_torch import rng as drng
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.obs import incidents, numerics
from draco_tpu_torch.obs.forensics import record_value
from draco_tpu_torch.obs.heartbeat import RunHeartbeat
from draco_tpu_torch.obs.tracer import make_tracer
from draco_tpu_torch.resilience.supervisor import shielded
from draco_tpu_torch.training.run_state import LoopRunState
from draco_tpu_torch.utils.metrics import MetricWriter


class TokenLoop(LoopRunState):
    """``tag`` names the route in error messages. The autopilot's swaps
    build a regime's setup with the setup's ``rebuild`` (the sp route's;
    None on tp, pp and ep, which refuse a swap)."""

    def __init__(self, setup, cfg: TrainConfig, quiet: bool = False,
                 tag: str = "mp"):
        from draco_tpu_torch.parallel.sp_step import synthetic_text

        self.setup, self.cfg, self.quiet = setup, cfg, quiet
        self.tag = tag
        self.state = setup.state
        self.text = lambda seed, step: synthetic_text(
            seed, step, cfg.num_workers, cfg.batch_size, cfg.seq_len,
            cfg.vocab)
        self.init_resilience()
        self._sched_steps = -1
        self._ensure_schedule(cfg.max_steps)
        self.writer = MetricWriter(cfg.train_dir, quiet)
        self.tracer = make_tracer(cfg.trace_dir)
        self.heartbeat = RunHeartbeat(cfg.train_dir or None,
                                      num_workers=cfg.num_workers,
                                      job_name=cfg.job_name or None,
                                      incidents=incidents.make_engine(cfg))
        self.heartbeat.set_wire(numerics.wire_ledger(cfg, setup.dim))
        self._eager_tokens = self.eager_source(self.train_tokens)
        if cfg.checkpoint_step:
            self.restore(cfg.checkpoint_step)

    def _ensure_schedule(self, n_steps: int) -> None:
        """The adversary and straggler tables through step ``n_steps`` (a
        resumed run goes past ``max_steps``; the rows already used stay as
        they were)."""
        if n_steps > self._sched_steps:
            cfg = self.cfg
            self.adv_schedule = self.overlay_adversaries(
                drng.adversary_schedule(cfg.seed, n_steps, cfg.num_workers,
                                        cfg.num_adversaries))
            self.straggle_schedule = self.straggle_table(n_steps)
            self._sched_steps = n_steps

    def train_tokens(self, step: int):
        """The host tokens of training step ``step``."""
        return self.text(self.cfg.seed, step)

    @property
    def device_tokens(self) -> bool:
        return self.cfg.token_gen == "device"

    def inputs(self, step: int) -> tuple:
        """The host inputs of 1-based ``step``: ``(tokens, adv_mask,
        present)`` as ``setup.train_step`` takes them; no tokens (None)
        when the device makes them, no presence mask (None) when every row
        arrives."""
        toks = None if self.device_tokens else self._eager_tokens(step)
        present = (None if self.straggle_schedule is None
                   else ~self.straggle_schedule[step])
        return toks, self.adv_schedule[step], present

    def step(self) -> dict:
        """Run the next step eagerly; returns its metrics as floats, with
        the wall time of the step (host clock, device synchronised) as
        ``step_ms``."""
        step = self.state.step
        if step > self._sched_steps:
            raise ValueError(f"{self.tag} route: step {step} is past the "
                             f"schedule's {self._sched_steps} steps "
                             f"(max_steps)")
        tracer = self.tracer
        with tracer.span("gather"):
            toks, adv_mask, present = self.inputs(step)
        t0 = time.perf_counter()
        with tracer.span("dispatch"), tracer.activate():
            self.state, metrics = self.setup.train_step(self.state, toks,
                                                        adv_mask, present)
        # .item() waits for the device: the step's work is all on one stream
        with tracer.span("sync"):
            out = {k: record_value(k, v) for k, v in metrics.items()}
        if present is not None:
            # the arrived rows (not a column of the LM's written record)
            out["present"] = float(present.sum())
        out["step_ms"] = (time.perf_counter() - t0) * 1e3
        return {"step": step, **out}

    def eval_loss(self) -> float:
        return float(self.setup.eval_step(self.state.params,
                                          self.text(self.cfg.seed + 1, 0)))

    def evaluate(self, step: int) -> None:
        """The held-out loss after ``step``, as its eval record."""
        with self.tracer.span("eval"):
            loss = self.eval_loss()
        with self.tracer.span("flush"):
            self.writer.write({"step": step, "split": "eval", "loss": loss})

    def chunk_client(self, first: int, last: int):
        """The engine's client for steps [first, last] over a fresh,
        supervised token prefetcher (none when the device makes the
        tokens)."""
        from draco_tpu_torch.control.clients import TokenChunkClient
        from draco_tpu_torch.data import prefetch as pf

        self._ensure_schedule(last)
        prefetch = None if self.device_tokens else self.supervised(
            lambda: pf.TokenChunkPrefetcher(
                self.injector.wrap_step_fn(self.train_tokens),
                timeout_s=self.cfg.prefetch_timeout_s, tracer=self.tracer))
        return TokenChunkClient(self, prefetch, first, last)

    def _run_chunked(self, last_step: int) -> dict:
        from draco_tpu_torch.control.engine import ChunkedEngine

        client = self.chunk_client(self.state.step, last_step)
        engine = ChunkedEngine(client, eval_freq=self.cfg.eval_freq,
                               tracer=self.tracer, writer=self.writer,
                               stop=self._stop, heartbeat=self.heartbeat,
                               total_end=last_step, injector=self.injector,
                               autopilot=self._make_autopilot())
        self.state, last = engine.run(self.state, client.ranges)
        return last

    def _run_eager(self, last_step: int) -> dict:
        cfg = self.cfg
        first, last = self.state.step, {}
        names = ("step",) + self.setup.metric_names + ("step_ms",)
        while self.state.step <= last_step:
            with shielded(self._stop):
                last = self.step()
            step = last["step"]
            if step % cfg.log_every == 0 or step in (first, last_step):
                rec = {k: last[k] for k in names}
                self.heartbeat.observe(rec)
                with self.tracer.span("flush"):
                    self.writer.write(rec)
            boundary = bool(cfg.eval_freq) and step % cfg.eval_freq == 0
            if boundary or step == last_step:
                self.heartbeat.beat(step, last_step)
            if boundary:
                self.boundary(step)
            if self.stop_after(step, already_saved=boundary):
                break
        return last

    def run(self, max_steps: Optional[int] = None) -> dict:
        """Steps up to ``max_steps`` (default cfg.max_steps), eagerly or in
        chunks by ``cfg.steps_per_call``, from the state's next step;
        returns the last step's record ({} after an escalated stop)."""
        cfg = self.cfg
        last_step = cfg.max_steps if max_steps is None else max_steps
        self._ensure_schedule(last_step)

        # under the autopilot at K=1 too (device tokens, which validate()
        # admits there): a chunk boundary is its only actuation point
        chunked = cfg.steps_per_call > 1 or cfg.autopilot == "on"

        def body():
            last = (self._run_chunked(last_step) if chunked
                    else self._run_eager(last_step))
            if not cfg.eval_freq and self.stopped_step is None:
                # no boundary saved anything: save the last state
                self.checkpoint(last_step)
            return last

        return self.guarded(body)


def run_token_loop(setup, cfg: TrainConfig, steps: Optional[int] = None,
                   quiet: bool = False, tag: str = "mp"):
    """Train ``steps or cfg.max_steps`` steps from the state's next step
    (after ``cfg.checkpoint_step``'s resume); returns (state, the last
    step's record). ``tag`` as :class:`TokenLoop` takes it."""
    loop = TokenLoop(setup, cfg, quiet, tag=tag)
    last = loop.run(loop.state.step - 1 + (steps or cfg.max_steps))
    return loop.state, last
