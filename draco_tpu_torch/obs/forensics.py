"""Per-worker forensics: packed accusation masks and the host ledger
(draco_tpu/obs/forensics.py).

On the device, :func:`pack_mask_columns` packs a step's three (n,) bool
masks — the accusation set, the present set and the seeded adversary
schedule — into ``ceil(n/32)`` 32-bit words each, bit-cast to float32, so
they ride the step's float32 metric row: one column a word for n ≤ 32, two
for n ≤ 64, an error beyond (``MAX_WORKERS``). Bit j of word w is worker
32·w + j.

Nothing between the pack and the host fetch does arithmetic on the row
(``training/step.metrics_row`` stacks, the chunk graph copies), so the
words keep their bits to the host. A Python ``float()`` does not: a word
whose bits 23–30 are set is a float32 NaN, and when bit 22 is clear a
signalling one, which the f32 → f64 conversion quiets by setting bit 22 —
it would accuse worker 22. Every place that turns a row into host values
therefore reads mask columns through :func:`record_value`, the tensor
re-viewed as int32, and the records carry the exact integer words.

:class:`AccusationLedger` folds the per-step masks of the materialised
records into per-worker counters (accused, present, true / false positive
and false negative against the schedule), an exponentially weighted trust
(α = 0.2) and attack episodes: maximal runs of consecutive accusations of a
worker. An absent worker is an erasure: neither accused nor exonerated, its
trust and episodes hold. The heartbeat (``obs/heartbeat.py``) feeds it the
records its loop materialises anyway.

:func:`nonfinite_rows` is the ingest check the aggregator runs on the raw
per-worker gradients before the encode (the shared encode smears a NaN
over every codeword): a kernel on the card (``ops/numerics.py``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

MASK_WORD_BITS = 32
MAX_WORKERS = 64

# a step's forensics columns are f"{MASK_PREFIX}{kind}{word}"
MASK_PREFIX = "wmask_"
MASK_KINDS = ("accused", "present", "adv")

# the trust step: trust <- (1 - α)·trust + α·(not accused), on the steps a
# worker is present
TRUST_ALPHA = 0.2

_M32 = 0xFFFFFFFF


def num_mask_words(num_workers: int) -> int:
    """ceil(n/32) packed words a mask kind; bounded by MAX_WORKERS."""
    if num_workers < 1:
        raise ValueError(f"num_workers must be >= 1, got {num_workers}")
    if num_workers > MAX_WORKERS:
        raise ValueError(
            f"forensics mask columns support num_workers <= {MAX_WORKERS} "
            f"(got {num_workers}); grow MAX_WORKERS and the column family "
            f"together")
    return (num_workers + MASK_WORD_BITS - 1) // MASK_WORD_BITS


def mask_metric_names(num_workers: int) -> tuple:
    """The forensics columns of an n-worker configuration, in order."""
    words = num_mask_words(num_workers)
    return tuple(f"{MASK_PREFIX}{kind}{w}"
                 for kind in MASK_KINDS for w in range(words))


def is_mask_column(name: str) -> bool:
    """True for the packed mask columns (float32-carried 32-bit words)."""
    return name.startswith(MASK_PREFIX)


# --------------------------------------------------------------------------
# on the device
# --------------------------------------------------------------------------


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """(n,) bool -> (num_mask_words(n),) float32 carrying the 32-bit words
    (bit j of word w: worker 32·w + j). The words are summed in int64 and
    written as int32 whose bits the float32 view carries."""
    n = int(mask.shape[0])
    words = num_mask_words(n)
    j = torch.arange(n, device=mask.device)
    vals = mask.to(torch.int64) << (j % MASK_WORD_BITS)
    pad = words * MASK_WORD_BITS - n
    if pad:
        vals = torch.cat([vals, vals.new_zeros(pad)])
    w = vals.view(words, MASK_WORD_BITS).sum(dim=1)
    w = torch.where(w >= 1 << 31, w - (1 << 32), w)
    return w.to(torch.int32).view(torch.float32)


def pack_mask_columns(accused: torch.Tensor,
                      present: Optional[torch.Tensor],
                      adv_mask: torch.Tensor) -> dict:
    """The step's packed forensics columns (``mask_metric_names`` order):
    ``accused`` gated by ``present`` (an absent worker is never accused),
    ``present`` (None: all present) and the adversary schedule row."""
    accused = accused.to(torch.bool)
    n = int(accused.shape[0])
    pres = (torch.ones((n,), dtype=torch.bool, device=accused.device)
            if present is None else present.to(torch.bool))
    cols = {}
    for kind, mask in (("accused", accused & pres), ("present", pres),
                       ("adv", adv_mask.to(torch.bool))):
        packed = pack_bits(mask)
        for w in range(packed.shape[0]):
            cols[f"{MASK_PREFIX}{kind}{w}"] = packed[w]
    return cols


def nonfinite_rows(grads: torch.Tensor) -> torch.Tensor:
    """(n, ...) per-worker gradients -> (n,) bool: the rows holding a
    non-finite value (the ``nonfinite_rows`` kernel on the card)."""
    from draco_tpu_torch.ops import numerics as numerics_ops

    return numerics_ops.nonfinite_rows(grads)


# --------------------------------------------------------------------------
# on the host
# --------------------------------------------------------------------------


def record_value(name: str, value):
    """One metric value for a host record: a mask column's exact integer
    word (a float32 tensor's bits re-viewed, never through a float; an
    integer word as it is), anything else a float."""
    if not is_mask_column(name):
        return float(value)
    if isinstance(value, torch.Tensor):
        v = value.detach().reshape(()).to(torch.float32)
        return int(v.view(torch.int32).item()) & _M32
    return int(value) & _M32


def unpack_bits(words: Sequence[int], num_workers: int) -> Tuple[bool, ...]:
    """Integer words -> (num_workers,) bools."""
    out = []
    for i in range(num_workers):
        w, j = divmod(i, MASK_WORD_BITS)
        word = int(words[w]) if w < len(words) else 0
        out.append(bool((word >> j) & 1))
    return tuple(out)


def record_masks(record: dict,
                 num_workers: int) -> Optional[Dict[str, tuple]]:
    """kind -> (n,) bool tuples of one record, or None when the record
    carries no forensics columns (the baseline, eval records)."""
    if f"{MASK_PREFIX}accused0" not in record:
        return None
    words = num_mask_words(num_workers)
    out = {}
    for kind in MASK_KINDS:
        vals = [int(record.get(f"{MASK_PREFIX}{kind}{w}", 0))
                for w in range(words)]
        out[kind] = unpack_bits(vals, num_workers)
    return out


class AccusationLedger:
    """Per-worker forensics folded from one materialised record at a time
    (:meth:`observe`); records without forensics columns are ignored."""

    def __init__(self, num_workers: int, trust_alpha: float = TRUST_ALPHA):
        self.n = int(num_workers)
        num_mask_words(self.n)  # the bound, checked early
        self.alpha = float(trust_alpha)
        self.steps = 0
        self.accused = [0] * self.n
        self.present = [0] * self.n
        self.tp = [0] * self.n  # accused ∧ adversarial (∧ present)
        self.fp = [0] * self.n  # accused ∧ honest (∧ present)
        self.fn = [0] * self.n  # adversarial ∧ present ∧ not accused
        self.trust = [1.0] * self.n
        self.episodes: List[dict] = []  # closed, in closure order
        self._open: Dict[int, dict] = {}  # worker -> open episode

    def observe(self, record: dict, masks: Optional[dict] = None) -> bool:
        """Fold one record; True iff it carried forensics columns.
        ``masks``: the record's unpacked masks, when the caller has them."""
        if masks is None:
            masks = record_masks(record, self.n)
        if masks is None:
            return False
        step = int(record.get("step", self.steps + 1))
        accused, present, adv = (masks["accused"], masks["present"],
                                 masks["adv"])
        self.steps += 1
        for w in range(self.n):
            if not present[w]:
                continue  # an erasure: trust and episodes hold
            self.present[w] += 1
            if accused[w]:
                self.accused[w] += 1
                if adv[w]:
                    self.tp[w] += 1
                else:
                    self.fp[w] += 1
                ep = self._open.get(w)
                if ep is None:
                    self._open[w] = {"worker": w, "start": step, "end": step,
                                     "steps": 1}
                else:
                    ep["end"] = step
                    ep["steps"] += 1
            else:
                if adv[w]:
                    self.fn[w] += 1
                ep = self._open.pop(w, None)
                if ep is not None:
                    self.episodes.append(ep)
            self.trust[w] = ((1.0 - self.alpha) * self.trust[w]
                             + self.alpha * (0.0 if accused[w] else 1.0))
        return True

    @property
    def active(self) -> bool:
        return self.steps > 0

    def open_episodes(self) -> List[dict]:
        """The episodes running at the last observed step, by worker."""
        return [dict(self._open[w], open=True) for w in sorted(self._open)]

    def all_episodes(self) -> List[dict]:
        """Closed episodes (closure order), then the open ones."""
        return [dict(e, open=False) for e in self.episodes] \
            + self.open_episodes()

    def worker_rows(self) -> List[dict]:
        """A row a worker: counters, precision / recall against the
        schedule (1.0 on an empty denominator), trust, episodes."""
        rows = []
        n_eps = [0] * self.n
        for ep in self.all_episodes():
            n_eps[ep["worker"]] += 1
        for w in range(self.n):
            adv_seen = self.tp[w] + self.fn[w]
            rows.append({
                "worker": w,
                "present": self.present[w],
                "accused": self.accused[w],
                "tp": self.tp[w],
                "fp": self.fp[w],
                "fn": self.fn[w],
                "precision": (self.tp[w] / self.accused[w]
                              if self.accused[w] else 1.0),
                "recall": (self.tp[w] / adv_seen) if adv_seen else 1.0,
                "trust": round(self.trust[w], 4),
                "episodes": n_eps[w],
            })
        return rows

    def forgive(self, worker: int, trust: float = 0.75) -> None:
        """Reset a readmitted worker's trust to ``trust``; its counters
        stay."""
        self.trust[worker] = float(trust)

    def summary(self, top: int = 3) -> dict:
        """status.json's ``forensics`` block: the top suspects by
        accusations (ties toward lower trust), the trust vector and the
        episode counts."""
        order = sorted(range(self.n),
                       key=lambda w: (-self.accused[w], self.trust[w], w))
        suspects = [{"worker": w, "accused": self.accused[w],
                     "trust": round(self.trust[w], 4)}
                    for w in order[:top] if self.accused[w] > 0]
        return {
            "num_workers": self.n,
            "steps": self.steps,
            "top_suspects": suspects,
            "trust": [round(t, 4) for t in self.trust],
            "accused_total": sum(self.accused),
            "open_episodes": len(self._open),
            "episodes_total": len(self.episodes) + len(self._open),
        }

    def to_dict(self) -> dict:
        """The whole fold."""
        return {
            "num_workers": self.n,
            "steps": self.steps,
            "workers": self.worker_rows(),
            "episodes": self.all_episodes(),
            "summary": self.summary(),
        }
