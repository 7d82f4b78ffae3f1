"""Metric records of the loops (draco_tpu/utils/metrics.py).

:class:`MetricWriter` appends records to ``<train_dir>/metrics.jsonl`` and
prints each as one ``key=value`` line, as both eager loops write them.
:class:`DeferredMetricWriter` is the chunked loops' half: each chunk's
(k, m) metrics block is queued as it was dispatched, with no device fetch;
:meth:`DeferredMetricWriter.fetch` brings every queued block to the host
in one device-to-host copy (the flush boundary's one synchronisation) and
:meth:`DeferredMetricWriter.flush` turns the rows into per-step records.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch


def format_record(record: dict) -> str:
    return " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in record.items())


class MetricWriter:
    """JSONL records under ``train_dir`` (none when it is empty) and a
    printed line each (none when ``quiet``)."""

    def __init__(self, train_dir: Optional[str], quiet: bool = False):
        self.path = (os.path.join(train_dir, "metrics.jsonl")
                     if train_dir else None)
        self.quiet = quiet
        if self.path:
            os.makedirs(train_dir, exist_ok=True)

    def write(self, *records: dict) -> None:
        if self.path and records:
            with open(self.path, "a") as f:
                f.write("".join(json.dumps(r) + "\n" for r in records))
        if not self.quiet:
            for r in records:
                print(format_record(r), flush=True)


class DeferredMetricWriter:
    """Per-step records from deferred (k, m) blocks.

    ``defer(steps, names, block, extras)``: ``block[i, j]`` is column
    ``names[j]`` of ``steps[i]`` (a tensor on any device, not read yet);
    ``extras`` maps a column to its k host values (columns the host knows
    at assembly). A record is ``{"step", *names, *extras, *common}`` in that
    order."""

    def __init__(self, writer: MetricWriter):
        self._writer = writer
        self._pending: list = []  # (steps, names, block, extras)
        self._host: Optional[list] = None  # fetched rows of the pending
        self.fetches = 0  # device-to-host fetches made
        self.last: dict = {}  # the newest record, logged or not

    @property
    def depth(self) -> int:
        return len(self._pending)

    def defer(self, steps, names, block: torch.Tensor,
              extras: Optional[dict] = None) -> None:
        self._pending.append((list(steps), tuple(names), block,
                              extras or {}))
        self._host = None

    def fetch(self) -> None:
        """Every pending block to the host in one copy; waits for the
        chunks that compute them. No-op when nothing is pending."""
        if not self._pending or self._host is not None:
            return
        blocks = [b for _, _, b, _ in self._pending]
        self._host = torch.cat(blocks).to("cpu").tolist()
        self.fetches += 1

    def flush(self, should_log=None, common: Optional[dict] = None,
              keep: Optional[tuple] = None) -> dict:
        """Records of every pending step (fetching first if needed); writes
        those where ``should_log(step)`` (default all), with only the
        ``keep`` columns when given. Returns the newest record."""
        self.fetch()
        rows = iter(self._host or ())
        out = []
        for steps, names, _, extras in self._pending:
            for i, step in enumerate(steps):
                rec = {"step": step, **dict(zip(names, next(rows)))}
                rec.update({k: float(v[i]) for k, v in extras.items()})
                rec.update(common or {})
                self.last = rec
                if should_log is None or should_log(step):
                    out.append(rec if keep is None
                               else {k: rec[k] for k in keep})
        self._pending, self._host = [], None
        self._writer.write(*out)
        return self.last
