"""Metric records of the loops (draco_tpu/utils/metrics.py).

:class:`MetricWriter` appends records to ``<train_dir>/metrics.jsonl`` and
prints each as one ``key=value`` line, as both eager loops write them.
:class:`DeferredMetricWriter` is the chunked loops' half: each chunk's
(k, m) metrics block is queued as it was dispatched, with no device fetch;
:meth:`DeferredMetricWriter.fetch` brings every queued block to the host
in one device-to-host copy (the flush boundary's one synchronisation) and
:meth:`DeferredMetricWriter.flush` turns the rows into per-step records.

The packed forensics columns (``obs/forensics.py``) are 32-bit words in
float32 clothing: the rows go to the host as float32 and those columns are
read as the int32 view of their bits (:func:`host_rows`), never through a
float, which would quiet a word that is a signalling NaN.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from draco_tpu_torch.obs.forensics import is_mask_column


def host_rows(block: torch.Tensor, names) -> list:
    """A (k, m) metrics block as k host rows in ``names`` order: floats,
    the mask columns (``obs/forensics.py``) as the exact integer words of
    their float32 bits, read through an int32 view."""
    host = block.to(device="cpu", dtype=torch.float32)
    rows = host.tolist()
    for j, name in enumerate(names):
        if is_mask_column(name):
            words = host[:, j].contiguous().view(torch.int32).tolist()
            for row, w in zip(rows, words):
                row[j] = w & 0xFFFFFFFF
    return rows


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
    order. ``observer``: called with every record a flush makes, logged
    or not (the run heartbeat's ``observe``)."""

    def __init__(self, writer: MetricWriter, observer=None):
        self._writer = writer
        self._observer = observer
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
        host = torch.cat(blocks).to("cpu")  # the flush's one fetch
        self.fetches += 1
        rows, at = [], 0
        for steps, names, _, _ in self._pending:
            rows += host_rows(host[at:at + len(steps)], names)
            at += len(steps)
        self._host = rows

    def flush(self, should_log=None, common: Optional[dict] = None,
              keep: Optional[tuple] = None,
              order: Optional[tuple] = None) -> dict:
        """Records of every pending step (fetching first if needed); writes
        those where ``should_log(step)`` (default all), with only the
        ``keep`` columns when given. ``order``: the columns that lead each
        record, in that order (the step's schema, where host columns sit
        among the device ones). Returns the newest record."""
        self.fetch()
        rows = iter(self._host or ())
        out = []
        for steps, names, _, extras in self._pending:
            for i, step in enumerate(steps):
                rec = {"step": step, **dict(zip(names, next(rows)))}
                rec.update({k: float(v[i]) for k, v in extras.items()})
                rec.update(common or {})
                if order is not None:
                    rec = {**{k: rec[k] for k in order if k in rec}, **rec}
                if self._observer is not None:
                    self._observer(rec)
                self.last = rec
                if should_log is None or should_log(step):
                    out.append(rec if keep is None
                               else {k: rec[k] for k in keep})
        self._pending, self._host = [], None
        self._writer.write(*out)
        return self.last
