"""The torn-tail-tolerant JSONL reader (draco_tpu/obs/replay.py), the one
reader every offline fold of a run's ``metrics.jsonl`` and
``incidents.jsonl`` goes through. A run killed mid-write leaves a missing
file, an empty file or a torn last line, and none of them may stop a
report:

  * missing / unreadable file  -> yields nothing
  * blank lines                -> skipped
  * torn (non-JSON) tail line  -> skipped
  * non-dict JSON line         -> skipped

Host only, standard library and the port's forensics and heartbeat: an
offline fold of the incident engine (``obs/incidents.py``) over
``train_records`` gives the live run's episodes whenever every step was
logged (``log_every=1``).
"""

from __future__ import annotations

import json
import os
from typing import Iterator, List, NamedTuple, Optional


def iter_jsonl(path: str) -> Iterator[dict]:
    """Yield every dict record of a JSONL file, tolerating the partial
    states a killed run leaves behind (module docstring)."""
    try:
        fh = open(path)
    except OSError:
        return
    with fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # torn tail line of an interrupted run
            if isinstance(rec, dict):
                yield rec


def train_records(path: str, require_loss: bool = True) -> List[dict]:
    """The run's TRAIN records from metrics.jsonl: eval records dropped,
    and (by default) records without a ``loss`` — the same stream the
    heartbeat's observer hook sees live, so a host ledger replayed over
    these records reproduces the live fold whenever every step was logged
    (``log_every=1``, the chaos/report discipline)."""
    out = []
    for rec in iter_jsonl(path):
        if rec.get("split") == "eval":
            continue
        if require_loss and "loss" not in rec:
            continue
        out.append(rec)
    return out


def record_at_step(path: str, step: int) -> Optional[dict]:
    """The LAST train record at ``step`` (re-runs in a shared train_dir
    append; the newest wins), or None."""
    rec = None
    for r in train_records(path, require_loss=True):
        if r.get("step") == step:
            rec = r
    return rec


def metrics_path(path: str) -> str:
    """Resolve a train_dir (or a direct file path) to its metrics.jsonl."""
    if os.path.isdir(path):
        return os.path.join(path, "metrics.jsonl")
    return path


class RunFiles(NamedTuple):
    """The one run-dir layout contract: every
    offline consumer that folds a run directory resolves its artifact
    paths through :func:`find_run_files` instead of re-deriving the
    joins inline — incident_report, forensics_report and the fleet
    registry all read the same three files by construction. Any path
    may point at a file that does not exist; existence is the READER's
    concern (iter_jsonl tolerates absence)."""

    root: str
    status: str
    metrics: str
    incidents: str


def find_run_files(path: str) -> RunFiles:
    """Resolve a train_dir (or a direct metrics.jsonl path — the
    historical CLI contract of the replay tools) to the run's artifact
    paths. Never touches the filesystem beyond one ``isdir``."""
    metrics = metrics_path(path)
    root = path if os.path.isdir(path) else (os.path.dirname(path) or ".")
    return RunFiles(root=root,
                    status=os.path.join(root, "status.json"),
                    metrics=metrics,
                    incidents=os.path.join(root, "incidents.jsonl"))


def infer_num_workers(records: List[dict], status_path: str,
                      tool: str = "obs/replay.py") -> int:
    """The worker-count fallback chain the per-worker replay tools share
    (forensics_report / incident_report): the run's status.json forensics
    block (schema-validated against the central contract table), else the
    highest worker ever marked present in the packed masks + 1 — the
    inference only under-counts workers that never sent a single row,
    which contribute nothing to any counter."""
    import json

    from draco_tpu_torch.obs.forensics import MASK_PREFIX, unpack_bits
    from draco_tpu_torch.obs.heartbeat import check_status_schema

    try:
        with open(status_path) as fh:
            status = json.load(fh)
        if isinstance(status, dict):
            check_status_schema(status, status_path, tool)
            n = (status.get("forensics") or {}).get("num_workers")
            if n:
                return int(n)
    except (OSError, ValueError):
        pass
    hi = 0
    for rec in records:
        words = []
        w = 0
        while f"{MASK_PREFIX}present{w}" in rec:
            words.append(int(rec[f"{MASK_PREFIX}present{w}"]))
            w += 1
        if words:
            bits = unpack_bits(words, len(words) * 32)
            if any(bits):
                hi = max(hi, max(i for i, b in enumerate(bits) if b) + 1)
    return max(hi, 1)
