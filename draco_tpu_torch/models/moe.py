"""Switch-style mixture-of-experts MLP (draco_tpu/models/moe.py).

Top-1 token routing with a fixed capacity an expert: the router runs in
float32, then the softmax, then the argmax (ties to the lower index);
each expert takes at most ``max(int(capacity_factor · N / E), 1)`` tokens
of the lane's flattened B·T stream, in arrival order (a float32 cumsum);
a token past its expert's capacity returns 0 and the caller's residual
carries it. Dispatch and combine are dense one-hot einsums, so the layer
has fixed shapes; the expert FFN runs in the compute dtype with GELU (the
tanh form) and the top-1 gate is applied straight through, so the router
trains.

The one-hot rows are built by comparison against ``arange``:
``jax.nn.one_hot`` maps an out-of-range index (the position −1 of a token
that went elsewhere, or one ≥ C past capacity) to a zero row, where
``torch.nn.functional.one_hot`` would raise, and has no batching rule
under ``torch.func.vmap``.

The expert stacks keep the reference's names and layout (``w1`` (E, dim,
4·dim), ``b1`` (E, 1, 4·dim), ``w2`` (E, 4·dim, dim), ``b2`` (E, 1, dim),
the same in both packages) and the router is a Dense (``router.kernel``,
(dim, E) in Flax's layout). Flax draws them in the ``moe`` scope's order,
``w1``, ``b1``, ``w2``, ``b2``, one rng count each, zeros included
(``PARAM_DRAWS``, read by ``models.layers.init_params``).

Expert parallelism (``parallel/ep_step.py``) runs this module as it is:
routing is top-1 and one-hot, so a token's dispatch row has one nonzero
entry, and a combine split into per-group partials over E would add
exact zeros to it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class MoeMlp(nn.Module):
    # the moe scope's parameters in Flax's creation order: the rng count
    # each is drawn at, and whether it is a LeCun-normal stack (fan_in its
    # in axis) or zeros
    PARAM_DRAWS = {"w1": (1, True), "b1": (2, False), "w2": (3, True),
                   "b2": (4, False)}

    def __init__(self, dim: int, experts: int, mlp_ratio: int = 4,
                 capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        from draco_tpu_torch.models.transformer import Dense

        hidden = mlp_ratio * dim
        self.experts, self.capacity_factor = experts, capacity_factor
        self.dtype = dtype
        self.router = Dense(dim, experts, False, torch.float32)
        self.w1 = nn.Parameter(torch.zeros(experts, dim, hidden))
        self.b1 = nn.Parameter(torch.zeros(experts, 1, hidden))
        self.w2 = nn.Parameter(torch.zeros(experts, hidden, dim))
        self.b2 = nn.Parameter(torch.zeros(experts, 1, dim))

    def capacity(self, n_tok: int) -> int:
        return max(int(self.capacity_factor * n_tok / self.experts), 1)

    def route(self, xf: torch.Tensor) -> tuple:
        """(N, dim) tokens -> the dispatch (N, E, C) float32 one-hot, the
        top-1 gate (N,) and the expert index (N,)."""
        e = self.experts
        cap = self.capacity(xf.shape[0])
        probs = torch.softmax(self.router(xf.to(torch.float32)), dim=-1)
        # torch.argmax returns the first maximal index, as jnp.argmax
        eidx = torch.argmax(probs, dim=-1)
        gate = probs.gather(-1, eidx[:, None])[:, 0]
        onehot = (eidx[:, None] == torch.arange(e, device=xf.device)).to(
            torch.float32)
        # the arrival-order position of each token in its expert's buffer
        pos = torch.cumsum(onehot, dim=0) - 1.0
        keep = (pos < cap).to(torch.float32) * onehot
        slots = (pos.to(torch.int64)[..., None]
                 == torch.arange(cap, device=xf.device)).to(torch.float32)
        return keep[:, :, None] * slots, gate, eidx

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, T, dim) -> (B, T, dim); a dropped token returns 0."""
        b, t, d = x.shape
        xf = x.reshape(b * t, d)
        dispatch, gate, _ = self.route(xf)
        cd = self.dtype
        xe = torch.einsum("nd,nec->ecd", xf.to(torch.float32), dispatch)
        h = torch.einsum("ecd,edh->ech", xe.to(cd), self.w1.to(cd)) \
            + self.b1.to(cd)
        h = F.gelu(h, approximate="tanh")
        ye = (torch.einsum("ech,ehd->ecd", h, self.w2.to(cd))
              + self.b2.to(cd)).to(torch.float32)
        yf = torch.einsum("ecd,nec->nd", ye, dispatch)
        yf = yf * gate[:, None]  # the straight-through top-1 gate
        return yf.reshape(b, t, d).to(x.dtype)
