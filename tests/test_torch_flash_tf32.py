"""The split-TF32 arithmetic of the flash kernels, emulated on the CPU
(``draco_tpu_torch/csrc/flash_attention.cu``: ``flash_fwd_kernel``,
``flash_dq_kernel``, ``flash_dkv_kernel``).

The kernels run every product on the tensor cores in TF32 (10 mantissa
bits). Each float32 operand x is split as its fragment is loaded: big = x
rounded as ``cvt.rna.tf32.f32`` rounds (add 0x1000 to the float's bits, then
clear the low 13), small = x − big, whose low 13 bits the tensor core ignores
(cleared here). A product a·b is a_small·b_big + a_big·b_small + a_big·b_big.
The emulation sums those products in float64 and keeps what the kernels hold
in float32 (the inputs, P, dS) in float32, so it isolates the splitting.

It is held to the tolerance ``chip_smoke.py`` holds the kernels to on the
card, 1e-5 of each output's largest entry, against the plain versions in
float64, at G=4, T=520 (ragged against the kernels' 64- and 32-row tiles),
Dh=64, causal, the backward with and without the lse cotangent. The forward
is emulated in the kernel's order: 32-key passes, each S summed from zero
over 16 head-dim entries and added to a float32 total, the online softmax in
base 2 in float32, each pass's P·V added to the rescaled float32 acc. One
TF32 pass (a_big·b_big alone) misses that tolerance, which is why the
kernels take three. Inputs are numpy draws from a seed.
"""

import math

import numpy as np
import pytest
import torch

from draco_tpu_torch.ops import flash_attention as fa

G, T, DH = 4, 520, 64
TOL = 1e-5  # chip_smoke.py's flash tolerance, of the output's largest entry


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value, ties away from zero (finite x)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def trunc_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 by dropping the low 13 bits (the tensor core's read)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple:
    big = rna_tf32(x)
    return big, trunc_tf32(x - big)


def tf32_einsum(spec: str, a: torch.Tensor, b: torch.Tensor,
                passes: int) -> torch.Tensor:
    """einsum of two float32 operands as the kernels multiply them (3
    passes: the split products; 1 pass: big·big), summed in float64."""
    (ab, as_), (bb, bs) = split(a), split(b)
    f = lambda x, y: torch.einsum(spec, x.double(), y.double())  # noqa: E731
    if passes == 1:
        return f(ab, bb)
    return f(as_, bb) + f(ab, bs) + f(ab, bb)


def emulated_backward(q, k, v, do, lse, dcap, dlse, passes: int):
    """dq, dk, dv of the kernels' arithmetic (causal), float64 out."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = tf32_einsum("gqd,gkd->gqk", q, k, passes) * scale
    pos = torch.arange(q.shape[1])
    causal = pos[:, None] >= pos[None, :]
    p = torch.where(causal, torch.exp(s - lse.double()[..., None]), 0.0)
    dsum = (tf32_einsum("gqd,gkd->gqk", do, v, passes)
            - dcap.double()[..., None])
    if dlse is not None:
        dsum = dsum + dlse.double()[..., None]
    p32, ds32 = p.float(), (p * dsum).float()
    dq = tf32_einsum("gqk,gkd->gqd", ds32, k, passes) * scale
    dk = tf32_einsum("gqk,gqd->gkd", ds32, q, passes) * scale
    dv = tf32_einsum("gqk,gqd->gkd", p32, do, passes)
    return dq, dk, dv


def _inputs(with_dlse: bool, seed: int = 5):
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(G, T, DH))
                                    .astype(np.float32)) for _ in range(4))
    dlse = (torch.from_numpy(rng.normal(size=(G, T)).astype(np.float32))
            if with_dlse else None)
    o, lse = fa.flash_fwd_plain(q, k, v)
    dcap = (do * o).sum(-1)
    return q, k, v, do, lse, dcap, dlse


def _errors(with_dlse: bool, passes: int) -> dict:
    """Each output's max |emulated − plain float64| / (TOL · max|plain|)."""
    args = _inputs(with_dlse)
    wide = [None if x is None else x.double() for x in args]
    plain = (fa.flash_dq_plain(*wide),) + fa.flash_dkv_plain(*wide)
    emu = emulated_backward(*args, passes)
    return {name: ((e - p).abs().max() / (TOL * p.abs().max())).item()
            for name, e, p in zip(("dq", "dk", "dv"), emu, plain)}


def test_rna_rounds_to_nearest_ties_away_from_zero():
    one = 1.0 + 2.0 ** -11  # exactly half a TF32 ulp above 1
    x = torch.tensor([one, -one, 1.0 + 2.0 ** -12, 3.0, 1e-3, -7.25e5],
                     dtype=torch.float32)
    big = rna_tf32(x)
    assert big[0].item() == 1.0 + 2.0 ** -10 and big[1].item() == -big[0]
    assert big[2].item() == 1.0 and big[3].item() == 3.0
    assert (big.view(torch.int32) & 0x1FFF).eq(0).all()
    rng = np.random.RandomState(0)
    r = torch.from_numpy(rng.normal(scale=50, size=4096).astype(np.float32))
    ulp = 2.0 ** (torch.floor(torch.log2(r.abs().double())) - 10)
    assert ((rna_tf32(r).double() - r.double()).abs() <= ulp / 2).all()
    big, small = split(r)
    assert ((big.double() + small.double() - r.double()).abs()
            <= 2.0 ** -21 * r.abs().double()).all()


@pytest.mark.parametrize("with_dlse", [False, True], ids=["", "dlse"])
def test_three_tf32_passes_meet_the_kernels_tolerance(with_dlse):
    err = _errors(with_dlse, passes=3)
    assert max(err.values()) <= 1.0, err


@pytest.mark.parametrize("with_dlse", [False, True], ids=["", "dlse"])
def test_one_tf32_pass_misses_the_tolerance(with_dlse):
    """The case for three passes: a_big·b_big alone misses the tolerance
    by more than an order of magnitude."""
    err = _errors(with_dlse, passes=1)
    assert min(err.values()) > 1.0, err


# --------------------------------------------------------------------------
# the forward (flash_fwd_kernel): the same split, in the kernel's order
# --------------------------------------------------------------------------

KEYS = 32  # keys a pass of the kernel (Dh 64)
DH_STEP = 16  # head-dim entries an S partial sums from zero


def emulated_forward(q, k, v, passes: int):
    """o, lse of the kernel's arithmetic (causal): 32-key passes, S summed
    from zero over 16 head-dim entries and each partial added to a float32
    total, the online softmax in base 2 in float32, each pass's P·V summed
    from zero and added to the float32 acc after its rescaling."""
    g, t, dh = q.shape
    scale_log2 = (np.float32(1.0 / math.sqrt(dh))
                  * np.float32(math.log2(math.e)))
    pos = torch.arange(t)
    m = torch.full((g, t), -1e30, dtype=torch.float32)
    l = torch.zeros((g, t), dtype=torch.float32)
    acc = torch.zeros((g, t, dh), dtype=torch.float32)
    for k0 in range(0, t, KEYS):
        kt, vt = k[:, k0:k0 + KEYS], v[:, k0:k0 + KEYS]
        s = torch.zeros((g, t, kt.shape[1]), dtype=torch.float32)
        for d0 in range(0, dh, DH_STEP):
            s = s + tf32_einsum("gqd,gkd->gqk", q[..., d0:d0 + DH_STEP],
                                kt[..., d0:d0 + DH_STEP], passes).float()
        kpos = pos[k0:k0 + KEYS]
        ok = pos[:, None] >= kpos[None, :]
        s = torch.where(ok, s * scale_log2, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.max(-1).values)
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + tf32_einsum("gqk,gkd->gqd", p, vt,
                                                  passes).float()
        m = m_new
    lc = torch.clamp(l, min=1e-30)
    return (acc / lc[..., None]).double(), \
        (m * np.float32(math.log(2.0)) + torch.log(lc)).double()


def _forward_errors(passes: int) -> dict:
    """o's and lse's max |emulated − plain float64| / (TOL · max|plain|)."""
    rng = np.random.RandomState(7)
    q, k, v = (torch.from_numpy(rng.normal(size=(G, T, DH))
                                .astype(np.float32)) for _ in range(3))
    plain = fa.flash_fwd_plain(q.double(), k.double(), v.double())
    emu = emulated_forward(q, k, v, passes)
    return {name: ((e - p).abs().max() / (TOL * p.abs().max())).item()
            for name, e, p in zip(("o", "lse"), emu, plain)}


def test_forward_three_tf32_passes_meet_the_kernels_tolerance():
    err = _forward_errors(passes=3)
    assert max(err.values()) <= 1.0, err


def test_forward_one_tf32_pass_misses_the_tolerance():
    """o and lse both miss the tolerance with big·big alone."""
    err = _forward_errors(passes=1)
    assert min(err.values()) > 1.0, err
