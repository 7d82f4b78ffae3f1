"""Blockwise causal flash attention (draco_tpu/ops/flash_attention.py).

Three kernels of ``csrc/flash_attention.cu`` on G = B·H folded heads of
(G, T, Dh) float32 rows, each behind a wrapper that launches it on a CUDA
tensor and computes its plain version on a CPU tensor (any other device
raises), and counts its launches in ``<wrapper>.launches``:

  * ``flash_fwd``  o and the per-row log-sum-exp lse (G, T)
  * ``flash_dq``   dq, recomputing p from lse
  * ``flash_dkv``  dk and dv, recomputing p from lse

``flash_dq`` and ``flash_dkv`` take the optional lse cotangent ``dlse``
(``None`` on the LM path, where lse is not an output of the model). All
three kernels run their products on the tensor cores in split TF32 (three
TF32 products for each float32 one), float32 in and out, with no atomics,
so a head's result does not depend on its place in G.

The public functions follow the reference's (B, T, H, Dh) contract:
:func:`flash_attention` (causal self-attention, o only) and
:func:`flash_attention_with_lse` (o and a differentiable lse (B, T, H)).
Both run through one ``torch.autograd.Function`` whose backward launches
the dq and dk/dv kernels and whose ``vmap`` rule folds a vmapped axis into
G, so ``torch.func.vmap(grad(...))`` over worker lanes launches each kernel
once for all lanes. (A ``torch.library.custom_op`` with ``register_autograd``
would not do: its generated autograd.Function has no ``setup_context``, and
``torch.func.grad`` refuses it.) A shape the kernels cannot take (Dh >
``MAX_DH`` = 128, a type other than float32) raises; there is no dense
fallback, and ``config.validate()`` refuses ``attn_impl="flash"`` for a
model whose head dim is past ``MAX_DH``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import Tensor

from draco_tpu_torch import _build

NEG_INF = -1e30
MAX_DH = 128


def _on_cuda(*tensors: Tensor) -> bool:
    """True for CUDA inputs (checked for the kernels), False for CPU ones."""
    dev = tensors[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu tensors, got "
                         f"{dev}")
    for t in tensors:
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                "flash kernels take contiguous float32 tensors on one device; "
                f"got {t.dtype} {tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
    return True


def _check_qkv(q: Tensor, k: Tensor, v: Tensor) -> tuple:
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash attention takes (G, T, Dh) q, k, v of one "
                         f"shape; got {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    g, t, dh = q.shape
    if not 1 <= dh <= MAX_DH or t < 1 or g < 1:
        raise ValueError(f"flash attention: G={g}, T={t}, Dh={dh} (the "
                         f"kernels take 1 <= Dh <= {MAX_DH})")
    return g, t, dh


def _ptr(t: Optional[Tensor]):
    return None if t is None else t.data_ptr()


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def flash_fwd_plain(q, k, v, causal: bool = True):
    """The streaming dense attention on (G, T, Dh): (o, lse (G, T))."""
    from draco_tpu_torch.parallel.ring_attention import dense_attention_lse

    o, lse = dense_attention_lse(q[:, :, None], k[:, :, None], v[:, :, None],
                                 causal=causal)
    return o[:, :, 0], lse[:, :, 0]


def flash_fwd(q, k, v, causal: bool = True):
    """(G, T, Dh) q, k, v -> (o (G, T, Dh), lse (G, T))."""
    g, t, dh = _check_qkv(q, k, v)
    if not _on_cuda(q, k, v):
        return flash_fwd_plain(q, k, v, causal)
    o = torch.empty_like(q)
    lse = torch.empty((g, t), dtype=torch.float32, device=q.device)
    flash_fwd_launch(q, k, v, o, lse, causal)
    flash_fwd.launches += 1
    return o, lse


def flash_fwd_launch(q, k, v, o, lse, causal: bool = True) -> None:
    """The forward kernel into ``o`` (G, T, Dh) and ``lse`` (G, T). (Each
    ``*_launch`` writes into outputs the caller allocated: the kernel audit
    hands them guarded buffers.)"""
    g, t, dh = q.shape
    err = _build.library("flash_attention").draco_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), g, t, dh, 1.0 / math.sqrt(dh), int(causal),
        _stream())
    _build.check(err, "flash_fwd")


flash_fwd.launches = 0


# --------------------------------------------------------------------------
# backward
# --------------------------------------------------------------------------

def _p_dsum(q, k, v, do, lse, dcap, dlse, causal):
    """The recomputed probabilities p (G, T, T) and p·(dp − D + dlse)."""
    t, dh = q.shape[1], q.shape[2]
    s = torch.einsum("gqd,gkd->gqk", q, k) * (1.0 / math.sqrt(dh))
    if causal:
        pos = torch.arange(t, device=q.device)
        s = torch.where(pos[:, None] >= pos[None, :], s, NEG_INF)
    p = torch.exp(s - lse[..., None])
    dsum = torch.einsum("gqd,gkd->gqk", do, v) - dcap[..., None]
    if dlse is not None:
        dsum = dsum + dlse[..., None]
    return p, p * dsum


def flash_dq_plain(q, k, v, do, lse, dcap, dlse=None, causal: bool = True):
    _, ds = _p_dsum(q, k, v, do, lse, dcap, dlse, causal)
    return torch.einsum("gqk,gkd->gqd", ds, k) * (1.0 / math.sqrt(q.shape[2]))


def flash_dkv_plain(q, k, v, do, lse, dcap, dlse=None, causal: bool = True):
    p, ds = _p_dsum(q, k, v, do, lse, dcap, dlse, causal)
    dk = torch.einsum("gqk,gqd->gkd", ds, q) * (1.0 / math.sqrt(q.shape[2]))
    return dk, torch.einsum("gqk,gqd->gkd", p, do)


def _bwd_args(q, k, v, do, lse, dcap, dlse):
    g, t, dh = _check_qkv(q, k, v)
    stats = (lse, dcap) + (() if dlse is None else (dlse,))
    if do.shape != q.shape or any(x.shape != (g, t) for x in stats):
        raise ValueError(f"flash backward: do {tuple(do.shape)}, row "
                         f"statistics {[tuple(x.shape) for x in stats]} for "
                         f"q {tuple(q.shape)}")
    return g, t, dh, _on_cuda(q, k, v, do, *stats)


def flash_dq(q, k, v, do, lse, dcap, dlse=None, causal: bool = True):
    """dq (G, T, Dh) from the forward's inputs, its lse, the output
    cotangent do, D = rowsum(do∘o) (``dcap``) and the optional dlse."""
    g, t, dh, cuda = _bwd_args(q, k, v, do, lse, dcap, dlse)
    if not cuda:
        return flash_dq_plain(q, k, v, do, lse, dcap, dlse, causal)
    dq = torch.empty_like(q)
    flash_dq_launch(q, k, v, do, lse, dcap, dlse, dq, causal)
    flash_dq.launches += 1
    return dq


def flash_dq_launch(q, k, v, do, lse, dcap, dlse, dq,
                    causal: bool = True) -> None:
    """The dq kernel into ``dq`` (G, T, Dh)."""
    g, t, dh = q.shape
    err = _build.library("flash_attention").draco_flash_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dcap.data_ptr(), _ptr(dlse), dq.data_ptr(), g, t, dh,
        1.0 / math.sqrt(dh), int(causal), _stream())
    _build.check(err, "flash_dq")


flash_dq.launches = 0


def flash_dkv(q, k, v, do, lse, dcap, dlse=None, causal: bool = True):
    """(dk, dv), each (G, T, Dh); arguments as :func:`flash_dq`."""
    g, t, dh, cuda = _bwd_args(q, k, v, do, lse, dcap, dlse)
    if not cuda:
        return flash_dkv_plain(q, k, v, do, lse, dcap, dlse, causal)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    flash_dkv_launch(q, k, v, do, lse, dcap, dlse, dk, dv, causal)
    flash_dkv.launches += 1
    return dk, dv


def flash_dkv_launch(q, k, v, do, lse, dcap, dlse, dk, dv,
                     causal: bool = True) -> None:
    """The dk/dv kernel into ``dk``, ``dv`` (G, T, Dh)."""
    g, t, dh = q.shape
    err = _build.library("flash_attention").draco_flash_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dcap.data_ptr(), _ptr(dlse), dk.data_ptr(),
        dv.data_ptr(), g, t, dh, 1.0 / math.sqrt(dh), int(causal), _stream())
    _build.check(err, "flash_dkv")


flash_dkv.launches = 0


# --------------------------------------------------------------------------
# autograd through the backward kernels, vmap folded into G
# --------------------------------------------------------------------------

def _fold(x: Optional[Tensor], bdim: Optional[int], size: int):
    """A vmapped (G, ...) operand -> (size·G, ...) contiguous."""
    if x is None:
        return None
    x = x.expand(size, *x.shape) if bdim is None else x.movedim(bdim, 0)
    return x.reshape(size * x.shape[1], *x.shape[2:]).contiguous()


def _unfold(x: Tensor, size: int) -> Tensor:
    return x.reshape(size, x.shape[0] // size, *x.shape[1:])


class _FlashAttn(torch.autograd.Function):
    """(o, lse) of (G, T, Dh) inputs; backward = the dq and dk/dv kernels.
    ``lse_grad``: the caller may use lse, so its cotangent reaches the
    backward as dlse (else it is dropped there). Under ``torch.func.vmap``
    the ``vmap`` rule folds the vmapped axis into G and calls the kernel
    once for all lanes."""

    @staticmethod
    def forward(q, k, v, causal, lse_grad):
        return flash_fwd(q, k, v, causal)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, lse_grad = inputs
        ctx.save_for_backward(q, k, v, *output)
        ctx.causal, ctx.lse_grad = causal, lse_grad

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _FlashAttnBwd.apply(q, k, v, o, lse, do,
                                         dlse if ctx.lse_grad else None,
                                         ctx.causal)
        return dq, dk, dv, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, lse_grad):
        n = info.batch_size
        q, k, v = (_fold(x, d, n) for x, d in zip((q, k, v), in_dims))
        o, lse = _FlashAttn.apply(q, k, v, causal, lse_grad)
        return (_unfold(o, n), _unfold(lse, n)), (0, 0)


class _FlashAttnBwd(torch.autograd.Function):
    """(dq, dk, dv) from the saved forward; not differentiable again."""

    @staticmethod
    def forward(q, k, v, o, lse, do, dlse, causal):
        do = do.contiguous()
        # D = rowsum(do∘o) outside the kernels, as the reference computes it
        dcap = (do * o).sum(dim=-1)
        dq = flash_dq(q, k, v, do, lse, dcap, dlse, causal)
        dk, dv = flash_dkv(q, k, v, do, lse, dcap, dlse, causal)
        return dq, dk, dv

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass  # torch.func needs it; no backward of the backward

    @staticmethod
    def vmap(info, in_dims, q, k, v, o, lse, do, dlse, causal):
        n = info.batch_size
        args = [_fold(x, d, n) for x, d in
                zip((q, k, v, o, lse, do, dlse), in_dims)]
        dq, dk, dv = _FlashAttnBwd.apply(*args, causal)
        return (_unfold(dq, n), _unfold(dk, n), _unfold(dv, n)), (0, 0, 0)


# --------------------------------------------------------------------------
# public entry points: the (B, T, H, Dh) contract of models/transformer.Block
# --------------------------------------------------------------------------

def _run_folded(q, k, v, causal: bool, want_lse: bool):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash attention takes (B, T, H, Dh) q, k, v of one "
                         f"shape; got {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    if any(x.dtype != torch.float32 for x in (q, k, v)):
        raise ValueError("flash attention computes in float32 (the LM casts "
                         "q, k, v to float32 before rope)")
    b, t, h, dh = q.shape

    def fold(x):  # (B, T, H, Dh) -> (B·H, T, Dh)
        return x.transpose(1, 2).reshape(b * h, t, dh).contiguous()

    o, lse = _FlashAttn.apply(fold(q), fold(k), fold(v), causal,
                              want_lse)
    o = o.reshape(b, h, t, dh).transpose(1, 2)
    if not want_lse:
        return o
    return o, lse.reshape(b, h, t).transpose(1, 2)  # (B, T, H)


def flash_attention(q, k, v):
    """Causal self-attention of (B, T, H, Dh) float32 q, k, v."""
    return _run_folded(q, k, v, causal=True, want_lse=False)


def flash_attention_with_lse(q, k, v, *, causal: bool = True):
    """(o, lse): lse is the per-row log-sum-exp (B, T, H), differentiable
    (its cotangent reaches the dq and dk/dv kernels as dlse)."""
    return _run_folded(q, k, v, causal=causal, want_lse=True)


def attn_impl_fn(cfg):
    """cfg.attn_impl -> the attention function of the LM (None = the
    Block's dense default)."""
    return flash_attention if cfg.attn_impl == "flash" else None
