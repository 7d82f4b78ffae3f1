"""Counter-based device draws: the reference's threefry stream on the card.

Three entry points over the stream of ``rng.py`` (the reference's
``jax.random``, bit for bit), each a kernel of ``csrc/draws.cu`` on a CUDA
tensor, its plain version on a CPU tensor, and a raise on any other device;
each counts its launches in ``<wrapper>.launches``:

  random_inject   the random attack, in place on the rows whose mask is
                  set: the cyclic pair adds ``magnitude · normal`` of
                  ``split(key)`` to its real and imaginary rows, the plain
                  form writes ``magnitude · normal(key)``; row i, column j
                  draws at counter i·d + j, as the reference's full (n, d)
                  draw does, so the attacked rows alone are drawn
  round_draw      the (d,) draw stochastic rounding shares across the wire
                  rows (``obs/numerics.py``): ``bits & 0xFFFF`` (int32) for
                  bf16, ``uniform`` (float32) for int8; ``parts=2`` adds the
                  imaginary part's, drawn from ``fold_in(key, 1)``
  synthetic_text  the LM's device token stream
                  (``parallel/sp_step.synthetic_text_in_graph``)

Every key is ``fold_in(key(seed), step)``, ``seed`` the caller's with its
salt added (the attack's + 7, the wire's + 17; the tokens' none) and
``step`` an int32 tensor of one element on the rows' device: the step's
staged input, which the kernel reads from device memory, so a captured CUDA
graph draws each replay's own step's numbers. The wrappers check their
inputs alike on both devices; the plain versions also take the step as an
int.
"""

from __future__ import annotations

import torch

from draco_tpu_torch import _build
from draco_tpu_torch import rng as drng

# the reference's salts: the random attack's (attacks.py), the real wire's
# stochastic rounding and the shadow quantizer's (obs/numerics.py)
RANDOM_SALT = 7
WIRE_SALT = 17
SHADOW_SALT = 11
# 32-bit integer operations a draw, as csrc/draws.cu computes it: threefry's
# 20 rounds (an add, a funnel shift and a xor each), its 5 key injections
# (three adds each) and first two adds, then the xor of the pair
OPS_PER_DRAW = 20 * 3 + 5 * 3 + 2 + 1
# threefry calls a token sequence: the step's key, its split, each part's
# split, and the two draws of each randint
THREEFRY_PER_SEQUENCE = 1 + 2 + 4 + 4


def _check_step(step, dev, what: str) -> None:
    if not isinstance(step, torch.Tensor) or step.device != dev \
            or step.dtype != torch.int32 or step.numel() != 1:
        raise ValueError(f"{what}: the step must be an int32 tensor of one "
                         f"element on {dev or 'the device'}, got "
                         f"{getattr(step, 'dtype', type(step))} "
                         f"{tuple(getattr(step, 'shape', ()))} on "
                         f"{getattr(step, 'device', 'the host')}")


def _on(dev, what: str) -> bool:
    """True for the kernel (cuda), False for the plain version (cpu)."""
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, got {dev}")
    return True


def step_key(seed: int, step) -> tuple:
    """The entry points' key: ``fold_in(key(seed), step)``."""
    return drng.fold_in(drng.key(seed), step)


# --------------------------------------------------------------------------
# random_inject
# --------------------------------------------------------------------------

def random_inject(rows: torch.Tensor, mask: torch.Tensor, step, seed: int,
                  magnitude: float, imag=None, max_rows=None) -> None:
    """The random attack in place on the rows of (n, d) f32 ``rows`` (and
    ``imag``, the cyclic pair's imaginary part) whose (n,) bool ``mask`` is
    set. ``seed``: with the attack's salt added. ``max_rows``: the mask
    sets at most this many rows (the configuration's adversaries; None:
    any), so the plain version draws only that many."""
    on = _on(rows.device, "random_inject")
    dev = rows.device
    for t in (rows,) if imag is None else (rows, imag):
        if t.dim() != 2 or t.dtype != torch.float32 or t.device != dev \
                or not t.is_contiguous() or t.shape != rows.shape:
            raise ValueError(f"random_inject takes contiguous (n, d) float32 "
                             f"rows on {dev}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    if mask.device != dev or mask.dtype != torch.bool \
            or mask.shape != rows.shape[:1] or not mask.is_contiguous():
        raise ValueError(f"random_inject: the mask must be ({rows.shape[0]},) "
                         f"bool on {dev}, got {mask.dtype} "
                         f"{tuple(mask.shape)} on {mask.device}")
    _check_step(step, dev, "random_inject")
    if not on:
        random_inject_plain(rows, mask, step, seed, magnitude, imag,
                            max_rows)
        return
    random_inject_launch(rows, mask, step, seed, magnitude, imag)
    random_inject.launches += 1


def random_inject_launch(rows, mask, step, seed, magnitude, imag=None) -> None:
    n, d = rows.shape
    err = _build.library("draws").draco_random_inject(
        rows.data_ptr(), None if imag is None else imag.data_ptr(),
        mask.data_ptr(), step.data_ptr(), int(seed) & drng.M32,
        float(magnitude), n, d, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "random_inject")


def random_inject_plain(rows, mask, step, seed, magnitude, imag=None,
                        max_rows=None) -> None:
    """``random_inject`` in torch, from ``rng``'s stream: the first
    ``max_rows`` rows in the order set-rows-first are drawn and written
    where the mask is set (a stable sort, no host read of the mask). A mask
    that sets more rows than ``max_rows`` fails a check on the device."""
    n, d = rows.shape
    t = n if max_rows is None else min(int(max_rows), n)
    mask = mask.to(torch.bool)
    if t < n:
        torch._assert_async(mask.sum() <= t,
                            f"random_inject: the mask sets more than "
                            f"max_rows={t} rows")
    if t <= 0:
        return
    idx = torch.argsort((~mask).to(torch.int32), stable=True)[:t]
    hit = mask[idx][:, None]
    key = step_key(seed, step)
    c = (idx[:, None] * d + torch.arange(d, device=rows.device)).reshape(-1)

    def z(k):
        return drng.normal_from_bits(drng.bits_at(k, c)).view(t, d)

    if imag is None:
        rows[idx] = torch.where(hit, z(key) * magnitude, rows[idx])
        return
    kr, ki = drng.split(key)
    rows[idx] = torch.where(hit, rows[idx] + z(kr) * magnitude, rows[idx])
    imag[idx] = torch.where(hit, imag[idx] + z(ki) * magnitude, imag[idx])


# --------------------------------------------------------------------------
# round_draw
# --------------------------------------------------------------------------

def round_draw(step: torch.Tensor, seed: int, d: int, mode: str,
               parts: int = 1) -> torch.Tensor:
    """The stochastic-rounding draw of ``mode`` ("bf16": int32 ``bits &
    0xFFFF``; "int8": float32 ``uniform``), (parts, d): part 0 from the
    step's key, part 1 from ``fold_in(key, 1)``. ``seed``: with the wire's
    salt added. On the step's device."""
    if mode not in ("bf16", "int8") or parts not in (1, 2):
        raise ValueError(f"round_draw: mode bf16|int8 and 1 or 2 parts, got "
                         f"{mode!r}, {parts}")
    dev = getattr(step, "device", None)
    _check_step(step, dev, "round_draw")
    if not _on(dev, "round_draw"):
        return round_draw_plain(step, seed, d, mode, parts, dev)
    out = torch.empty((parts, d), dtype=torch.int32, device=dev)
    round_draw_launch(step, seed, mode, out)
    round_draw.launches += 1
    return out if mode == "bf16" else out.view(torch.float32)


def round_draw_launch(step, seed, mode, out) -> None:
    """The kernel into ``out`` ((parts, d) int32 storage)."""
    parts, d = out.shape
    err = _build.library("draws").draco_round_draw(
        out.data_ptr(), step.data_ptr(), int(seed) & drng.M32, parts, d,
        int(mode == "int8"), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "round_draw")


def round_draw_plain(step, seed, d, mode, parts=1, device=None):
    key = step_key(seed, step)
    keys = [key, drng.fold_in(key, 1)][:parts]
    if mode == "bf16":
        return torch.stack([(drng.bits(k, d, device=device) & 0xFFFF)
                            .to(torch.int32) for k in keys])
    return torch.stack([drng.uniform(k, d, device=device) for k in keys])


# --------------------------------------------------------------------------
# synthetic_text
# --------------------------------------------------------------------------

def synthetic_text(step: torch.Tensor, seed: int, n: int, batch: int,
                   seq_len: int, vocab: int) -> torch.Tensor:
    """(n, batch, seq_len) int32 tokens of step ``step`` on its device: the
    reference's ``synthetic_text_in_graph``, ramps (start + stride · t) %
    vocab."""
    dev = getattr(step, "device", None)
    _check_step(step, dev, "synthetic_text")
    if not _on(dev, "synthetic_text"):
        return synthetic_text_plain(step, seed, n, batch, seq_len, vocab, dev)
    out = torch.empty((n, batch, seq_len), dtype=torch.int32, device=dev)
    synthetic_text_launch(step, seed, vocab, out)
    synthetic_text.launches += 1
    return out


def synthetic_text_launch(step, seed, vocab, out) -> None:
    n, b, t = out.shape
    err = _build.library("draws").draco_synthetic_text(
        out.data_ptr(), step.data_ptr(), int(seed) & drng.M32, n * b, t,
        int(vocab), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "synthetic_text")


def synthetic_text_plain(step, seed, n, batch, seq_len, vocab,
                         device=None) -> torch.Tensor:
    k_start, k_stride = drng.split(step_key(seed, step))
    start = drng.randint(k_start, (n, batch, 1), 0, vocab, device)
    stride = drng.randint(k_stride, (n, batch, 1), 1, 3, device)
    idx = torch.arange(seq_len, device=start.device)[None, None, :]
    return ((start + stride * idx) % vocab).to(torch.int32)


# --------------------------------------------------------------------------
# bounds
# --------------------------------------------------------------------------

def draw_ops(draws: int) -> int:
    """32-bit integer operations of ``draws`` draws (the normal's erfinv
    runs on the FMA pipe beside them)."""
    return OPS_PER_DRAW * int(draws)


def text_ops(sequences: int) -> int:
    """32-bit integer operations of the token kernel's draws."""
    return OPS_PER_DRAW * THREEFRY_PER_SEQUENCE * int(sequences)


random_inject.launches = 0
round_draw.launches = 0
synthetic_text.launches = 0
