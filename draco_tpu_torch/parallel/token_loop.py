"""The eager LM training loop (draco_tpu/parallel/token_loop.py, one step
per call).

Step t (1-based) trains on ``synthetic_text(seed, t, ...)`` with row t of
the seeded adversary schedule. Each step's metrics are synchronised to the
host; the first, the last and every ``log_every``-th go to
``<train_dir>/metrics.jsonl`` under the reference's column names, and every
``eval_freq``-th step adds the held-out loss on ``synthetic_text(seed + 1,
0, ...)`` as ``{"step", "split": "eval", "loss"}``. With ``cfg.trace_dir``
set, the host phases of each step (gather, dispatch, sync, flush, eval)
and the step's draco_* phases go to ``trace_dir/trace.json``
(``obs/tracer.py``). Checkpoints and the heartbeat are not ported yet.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from draco_tpu_torch import rng as drng
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.obs.tracer import make_tracer


class TokenLoop:
    def __init__(self, setup, cfg: TrainConfig, quiet: bool = False):
        from draco_tpu_torch.parallel.sp_step import synthetic_text

        self.setup, self.cfg, self.quiet = setup, cfg, quiet
        self.state = setup.state
        self.text = lambda seed, step: synthetic_text(
            seed, step, cfg.num_workers, cfg.batch_size, cfg.seq_len,
            cfg.vocab)
        self.adv_schedule = drng.adversary_schedule(
            cfg.seed, cfg.max_steps, cfg.num_workers, cfg.num_adversaries)
        self.path = (os.path.join(cfg.train_dir, "metrics.jsonl")
                     if cfg.train_dir else None)
        self.tracer = make_tracer(cfg.trace_dir)

    def inputs(self, step: int) -> tuple:
        """The host inputs of 1-based ``step``: ``(tokens, adv_mask)`` as
        ``setup.train_step`` takes them."""
        return self.text(self.cfg.seed, step), self.adv_schedule[step]

    def step(self) -> dict:
        """Run the next step; returns its metrics as floats, with the wall
        time of the step (host clock, device synchronised) as ``step_ms``."""
        step = self.state.step
        if step > self.cfg.max_steps:
            raise ValueError(f"step {step} is past max_steps="
                             f"{self.cfg.max_steps}")
        tracer = self.tracer
        with tracer.span("gather"):
            toks, adv_mask = self.inputs(step)
        t0 = time.perf_counter()
        with tracer.span("dispatch"), tracer.activate():
            self.state, metrics = self.setup.train_step(self.state, toks,
                                                        adv_mask)
        # .item() waits for the device: the step's work is all on one stream
        with tracer.span("sync"):
            out = {k: float(v.item()) for k, v in metrics.items()}
        out["step_ms"] = (time.perf_counter() - t0) * 1e3
        return {"step": step, **out}

    def eval_loss(self) -> float:
        return float(self.setup.eval_step(self.state.params,
                                          self.text(self.cfg.seed + 1, 0)))

    def _write(self, record: dict) -> None:
        with self.tracer.span("flush"):
            if self.path:
                with open(self.path, "a") as f:
                    f.write(json.dumps(record) + "\n")
            if not self.quiet:
                print(" ".join(f"{k}={v:.6g}" if isinstance(v, float)
                               else f"{k}={v}" for k, v in record.items()),
                      flush=True)

    def run(self, max_steps: Optional[int] = None) -> dict:
        """Steps up to ``max_steps`` (default cfg.max_steps); returns the
        last step's record."""
        cfg = self.cfg
        last_step = cfg.max_steps if max_steps is None else max_steps
        if self.path:
            os.makedirs(cfg.train_dir, exist_ok=True)
        first, last = self.state.step, {}
        names = ("step",) + self.setup.metric_names + ("step_ms",)
        while self.state.step <= last_step:
            last = self.step()
            step = last["step"]
            if step % cfg.log_every == 0 or step in (first, last_step):
                self._write({k: last[k] for k in names})
            if cfg.eval_freq and step % cfg.eval_freq == 0:
                with self.tracer.span("eval"):
                    loss = self.eval_loss()
                self._write({"step": step, "split": "eval", "loss": loss})
        self.tracer.close()
        return last


def run_token_loop(setup, cfg: TrainConfig, steps: Optional[int] = None,
                   quiet: bool = False):
    """Train ``steps or cfg.max_steps`` steps; returns (state, the last
    step's record)."""
    loop = TokenLoop(setup, cfg, quiet)
    last = loop.run(loop.state.step - 1 + (steps or cfg.max_steps))
    return loop.state, last
