"""Approximate gradient code — partial-recovery decode with a measured
residual-vs-bound certificate (draco_tpu/coding/approx.py).

n workers, n batches, assignment A at redundancy r (coding/assignment.py),
encode weights W = A / column sums. Worker i ships the partial sum
row_i = Σ_k W[i,k]·g_k (``encode_shared``: one (n, n) × (n, d) matmul).
With arrival set S (``present``) the decode solves the optimal-decoding
least squares v* = argmin ‖W_Sᵀ v − 1‖₂ (``decode_weights``) and returns
Σ_{i∈S} v*_i·row_i / n. With u = W_Sᵀ v*:

  residual            ‖ĝ/n − ḡ‖₂ / (‖G‖_F / n), measured against the true
                      batch gradients (the fleet is simulated in one step)
  bound               ‖u − 1‖₂; residual ≤ bound is algebra (f32 noise
                      aside), and every worker present gives u = 1, exact
  recovered_fraction  fraction of batches computed by a present worker

``decode_weights`` is an O(n³) solve that depends only on the code and the
host's presence mask, so it runs on the host in float32 (``host_solve``,
which the chunked loops run for each step of a chunk at assembly); the
step reads v/n with the presence as one (2, n) tensor (2n floats, one
asynchronous copy, or a row of the chunk's staging buffer) and the O(n·d)
tail runs through ``ops.decode_kernels.approx_decode``
(``decode_device``): the kernel on the card, its plain version on the CPU.
No Byzantine certificate: ``config.validate`` rejects live adversaries
under this code.

The segmented wire (``decode_segments``): the weight solve depends on the
presence alone, so it runs once and every segment [a, b) combines with the
same v/n; each segment is one launch of the decode's offset entry on the
whole buffers (``ops.decode_kernels.approx_decode_segment``), and the two
squared norms are added across segments before the one square root, so
the certificate stays one a step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from draco_tpu_torch.coding import assignment as assign_mod
from draco_tpu_torch.coding import linalg as linalg_mod
from draco_tpu_torch.ops import decode_kernels
from draco_tpu_torch.runtime import upload

# relative singular-value cutoff of the optimal-decoding least squares:
# whole-cluster absences make W_Sᵀ rank-deficient
DECODE_RCOND = 1e-5


@dataclasses.dataclass(frozen=True)
class ApproxCode:
    """Constants of one (n, r, scheme) approximate code, as host arrays."""

    n: int
    redundancy: float
    scheme: str
    assign: np.ndarray  # (n, n) 0/1 support
    weights: np.ndarray  # (n, n) f32 encode weights, unit column sums

    def weights_on(self, device) -> torch.Tensor:
        """W as an f32 tensor on ``device`` (cached per device)."""
        cache = self.__dict__.setdefault("_weights", {})
        key = str(device)
        if key not in cache:
            cache[key] = torch.as_tensor(self.weights).to(device)
        return cache[key]


def build_approx_code(n: int, redundancy: float,
                      scheme: str = "pairwise") -> ApproxCode:
    """The code's support and encode weights. (The reference also keeps
    per-worker batch lists for a simulate encode; approx runs shared only,
    ``config.validate``.)"""
    a = assign_mod.build_assignment(n, redundancy, scheme)
    return ApproxCode(
        n=n, redundancy=float(redundancy), scheme=scheme,
        assign=np.ascontiguousarray(a, np.float32),
        weights=np.ascontiguousarray(assign_mod.encode_weights(a),
                                     np.float32))


def encode_shared(code: ApproxCode, batch_grads: torch.Tensor) -> torch.Tensor:
    """(n, d) one-copy batch gradients -> (n, d) per-worker partial sums
    W @ G: a plain matrix product, as the reference leaves it to XLA."""
    return code.weights_on(batch_grads.device) @ batch_grads


def presence(code: ApproxCode, present=None) -> torch.Tensor:
    """The host's (n,) f32 presence vector (1 = arrived)."""
    if present is None:
        return torch.ones((code.n,), dtype=torch.float32)
    return torch.as_tensor(present).cpu().to(torch.float32).reshape(code.n)


def decode_weights(code: ApproxCode, present=None):
    """Optimal-decoding weights for an arrival set, on the host:
    ``(v, u, bound)``. ``v`` (n,) = argmin ‖W_Sᵀ v − 1‖₂ with the absent
    workers' rows of W zeroed (and v masked to 0 on them), ``u`` = W_Sᵀ v,
    ``bound`` = ‖u − 1‖₂ (0-d)."""
    pres = presence(code, present)
    wp = torch.as_tensor(code.weights) * pres[:, None]
    ones = torch.ones((code.n,), dtype=torch.float32)
    v = linalg_mod.truncated_lstsq(wp.T, ones, DECODE_RCOND) * pres
    u = wp.T @ v
    return v, u, torch.sqrt(((u - ones) ** 2).sum())


def recovered_fraction(code: ApproxCode, present=None) -> torch.Tensor:
    """Fraction of batches whose support meets the arrival set (0-d, host):
    1 iff no batch gradient was wholly lost."""
    covered = torch.as_tensor(code.assign).T @ presence(code, present) > 0
    return covered.to(torch.float32).mean()


def host_solve(code: ApproxCode, present=None):
    """The decode's host half for one arrival set: ``(v, vn_pres,
    host)``. ``v`` (n,) the decode weights, ``vn_pres`` (2, n) f32 = [v/n,
    presence] as the device half reads them, ``host`` the health columns
    known on the host: ``bound`` and ``recovered_fraction`` (0-d)."""
    v, _, bound = decode_weights(code, present)
    vn_pres = torch.stack([v / code.n, presence(code, present)])
    return v, vn_pres, {"bound": bound,
                        "recovered_fraction": recovered_fraction(code,
                                                                 present)}


def decode_device(code: ApproxCode, rows: Optional[torch.Tensor],
                  batch_grads: torch.Tensor, vn_pres: torch.Tensor,
                  wire=None):
    """The decode's device half: ``(decoded (d,), residual (0-d))`` from
    ``vn_pres`` (2, n) on the step's device (:func:`host_solve`)."""
    decoded, sq_diff, sq_g = decode_kernels.approx_decode(
        rows, batch_grads, vn_pres[0], vn_pres[1], wire)
    scale = torch.clamp_min(torch.sqrt(sq_g) / code.n, 1e-30)
    return decoded, torch.sqrt(sq_diff) / scale


def decode(code: ApproxCode, rows: Optional[torch.Tensor],
           batch_grads: torch.Tensor, present=None, wire=None):
    """Partial-recovery decode with its health: ``(decoded (d,), v (n,),
    health)``. ``rows`` (n, d) f32 on the step's device, or None with
    ``wire = (mode, buf, block)`` of ``obs.numerics.narrow_wire_single``;
    ``batch_grads`` (n, d) the pre-mask batch gradients; ``present`` the
    host's mask. Absent rows are zero-filled by where-select inside the
    decode (a NaN payload must not survive). ``decoded`` is the mean
    gradient Σ v_i·row_i / n; ``health`` holds ``residual``, ``bound``
    and ``recovered_fraction`` as 0-d tensors (the last two on the host)."""
    v, vn_pres, host = host_solve(code, present)
    decoded, residual = decode_device(
        code, rows, batch_grads, upload(vn_pres, batch_grads.device), wire)
    return decoded, v, {"residual": residual, **host}


def decode_segments_device(code: ApproxCode, rows: Optional[torch.Tensor],
                           batch_grads: torch.Tensor, vn_pres: torch.Tensor,
                           bounds, wire=None):
    """The device half over column segments ``bounds`` (S + 1 cuts):
    ``(decoded (d,), residual (0-d))``, each segment decoded in place into
    one output with the same ``vn_pres``, both squared norms summed over
    the segments before the square root."""
    d = batch_grads.shape[1]
    out = torch.empty((d,), dtype=torch.float32, device=batch_grads.device)
    sq_diff = sq_g = None
    for a, b in zip(bounds[:-1], bounds[1:]):
        _, sd, sg = decode_kernels.approx_decode_segment(
            rows, batch_grads, vn_pres[0], vn_pres[1], a, b, wire, out)
        sq_diff = sd if sq_diff is None else sq_diff + sd
        sq_g = sg if sq_g is None else sq_g + sg
    scale = torch.clamp_min(torch.sqrt(sq_g) / code.n, 1e-30)
    return out, torch.sqrt(sq_diff) / scale


def decode_segments(code: ApproxCode, rows: Optional[torch.Tensor],
                    batch_grads: torch.Tensor, bounds, present=None,
                    wire=None):
    """:func:`decode` over the segmented wire's cuts ``bounds``: the same
    contract, ``(decoded (d,), v (n,), health)``."""
    v, vn_pres, host = host_solve(code, present)
    decoded, residual = decode_segments_device(
        code, rows, batch_grads, upload(vn_pres, batch_grads.device),
        [int(c) for c in bounds], wire)
    return decoded, v, {"residual": residual, **host}
