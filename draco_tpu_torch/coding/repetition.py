"""Repetition code ("maj_vote") — grouping and the majority vote
(draco_tpu/coding/repetition.py).

Workers form groups of r; the members of a group compute the same batch
(``batching.indices_grouped``, the same augmentation draws), so honest
members produce bit-identical gradient rows and a corrupted row differs.
Per group the vote takes the row that most present members agree with
bit for bit, then averages the group winners.

Equality is tested on two salted 32-bit fingerprints of each row's raw
bits (``method="fingerprint"``, one O(d) pass a row: the
``row_fingerprints`` kernel, ``ops/vote.py``), or on the rows' bits
themselves (``method="exact"``, O(r²·d), plain torch). A fingerprint
compares bits, not values: -0.0 and +0.0 disagree, and a NaN row agrees
with its bit-identical copies. The per-position construction
``Σ_j mix(mix(bits_j ^ s) + posmix_j)`` and its threat model are the
reference's (its module docstring): with salts a participant cannot
predict, no salt-oblivious forgery is known; an adversary who knows the
salts can forge one, and ``exact`` has no collision surface at all.

The salts are an explicit (2,) int32 input (``ops.vote.salts_tensor``):
the training step draws the reference's, ``bits(fold(key(seed + 4),
step), (2,))``, on the device from the staged step
(``ops/draws.vote_salts``); None takes the reference's public constants.
The plain version here computes in int64 masked to 32 bits after every
step (PyTorch has no uint32 shift, add or sum).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from draco_tpu_torch.ops import vote as vote_ops

MASK32 = vote_ops.MASK32
# columns of the plain version's blocks: small enough that its int64
# temporaries stay in the CPU's caches; on the card a few large blocks
_BLOCK = {"cpu": 1 << 15, "cuda": 1 << 22}


def _mul32(z: torch.Tensor, c: int) -> torch.Tensor:
    """(z · c) mod 2^32 for int64 z in [0, 2^32) and a 32-bit constant c,
    from 16-bit halves so no int64 product overflows."""
    lo, hi = z & 0xFFFF, z >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & MASK32


def _splitmix32(z: torch.Tensor) -> torch.Tensor:
    """The splitmix32 finaliser on int64 holding uint32 values."""
    z = _mul32(z ^ (z >> 16), 0x85EBCA6B)
    z = _mul32(z ^ (z >> 13), 0xC2B2AE35)
    return z ^ (z >> 16)


def _row_int_view(rows: torch.Tensor) -> torch.Tensor:
    """The rows' raw bits as int16 / int32 — the vote's bit-compare domain
    (2- and 4-byte elements)."""
    size = rows.element_size()
    if size not in (2, 4) or not rows.is_floating_point():
        raise ValueError(f"majority_vote supports 2/4-byte float rows "
                         f"(bf16/f32 — what the gradient stack holds), got "
                         f"{rows.dtype}")
    return rows.contiguous().view({2: torch.int16, 4: torch.int32}[size])


def _row_fingerprints(rows: torch.Tensor,
                      salts: torch.Tensor) -> torch.Tensor:
    """(n, d) rows -> (n, 2) int64: two uint32 mix-then-sum hashes of each
    row's bits (the kernel's plain version; module docstring). ``salts``:
    (2,) int32 holding the uint32 salts' bits. Runs over column blocks
    (``_BLOCK``) so its int64 temporaries stay small."""
    width = 8 * rows.element_size()
    ints = _row_int_view(rows)
    s = salts.to(device=rows.device, dtype=torch.int64) & MASK32
    salt1, salt2 = s[0], s[1] ^ 0x7F4A7C15
    d = ints.shape[-1]
    h = torch.zeros((ints.shape[0], 2), dtype=torch.int64, device=rows.device)
    block = _BLOCK.get(rows.device.type, _BLOCK["cpu"])
    for j0 in range(0, d, block):
        bits = ints[:, j0:j0 + block].to(torch.int64) & ((1 << width) - 1)
        j = torch.arange(j0, j0 + bits.shape[-1], dtype=torch.int64,
                         device=rows.device)
        posmix = _splitmix32((_mul32(j, 2654435761) + 0x9E3779B9) & MASK32)
        for col, salt in ((0, salt1), (1, salt2)):
            mixed = _splitmix32((_splitmix32(bits ^ salt) + posmix) & MASK32)
            h[:, col] += mixed.sum(-1)
    return h & MASK32


@dataclasses.dataclass(frozen=True)
class RepetitionCode:
    n: int
    r: int  # group size

    @property
    def num_groups(self) -> int:
        return self.n // self.r

    def group_of(self, worker: int) -> int:
        return worker // self.r


def build_repetition_code(n: int, r: int) -> RepetitionCode:
    """Byzantine tolerance is (r-1)//2 a group (config.validate enforces
    r >= 2s+1 whenever worker_fail > 0)."""
    if n % r != 0:
        raise ValueError(f"num_workers {n} must be divisible by group_size {r}")
    return RepetitionCode(n=n, r=r)


def majority_vote(code: RepetitionCode, grads: torch.Tensor,
                  present: Optional[torch.Tensor] = None,
                  salts: Optional[torch.Tensor] = None,
                  method: str = "fingerprint", with_health: bool = False):
    """grads: (n, d) -> (d,) mean over groups of each group's majority row.

    ``present``: optional (n,) bool — absent members neither vote nor win;
    a group with no present member contributes nothing and the group mean
    renormalises. ``salts``: the fingerprints' (2,) int32 salts (None: the
    public ones). ``method``: ``"fingerprint"`` or ``"exact"``. Ties go to
    the first member with the most agreement (``argmax``).

    ``with_health=True`` returns ``(voted, health)``: ``vote_agree``, the
    fraction of present members whose row matches their group's winner;
    ``flagged_groups``, the groups with a dissenting present member;
    ``flagged``, (n,) bool — the present members out-voted by their
    group."""
    g, r = code.num_groups, code.r
    d = grads.shape[-1]
    if method == "exact":
        bits = _row_int_view(grads).view(g, r, d)
        eq = (bits[:, :, None, :] == bits[:, None, :, :]).all(-1)
    elif method == "fingerprint":
        fp = vote_ops.row_fingerprints(grads, salts).view(g, r, 2)
        eq = (fp[:, :, None, :] == fp[:, None, :, :]).all(-1)
    else:
        raise ValueError(
            f"method must be 'fingerprint' or 'exact', got {method!r}")
    if present is None:
        pres = torch.ones((g, r), dtype=torch.bool, device=grads.device)
        agree = eq.sum(-1)
    else:
        pres = present.to(device=grads.device, dtype=torch.bool).view(g, r)
        agree = (eq & pres[:, None, :]).sum(-1)  # only present members vote
        agree = torch.where(pres, agree, -1)  # absent members cannot win
    winner = agree.argmax(-1)  # (G,), the first maximum
    picked = grads.index_select(
        0, torch.arange(g, device=grads.device) * r + winner)
    if present is None:
        voted = picked.mean(0)
    else:
        alive = pres.any(1).to(grads.dtype)
        voted = (alive @ picked) / torch.clamp_min(alive.sum(), 1.0)
    if not with_health:
        return voted
    # member i agrees with its group's winner iff eq[g, i, winner_g]
    winner_agree = eq.gather(2, winner[:, None, None].expand(g, r, 1))[..., 0]
    flagged = pres & ~winner_agree
    n_pres = torch.clamp_min(pres.to(torch.float32).sum(), 1.0)
    health = {
        "vote_agree": (winner_agree & pres).to(torch.float32).sum() / n_pres,
        "flagged_groups": flagged.any(1).sum(),
        "flagged": flagged.reshape(code.n),
    }
    return voted, health
