"""Counter-based device draws: the reference's threefry stream on the card.

Six entry points over the stream of ``rng.py`` (the reference's
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
  augment_draws   the CNN step's augmentation draws (``data/augment.py``):
                  the reference's ``augment_batch`` under the key of
                  (seed + 2, step, row), (3, rows, B) int32 top, left, flip
  dropout_keep    the keep-masks of the model's ``nn.Dropout`` layers under
                  the key of (seed + 3, step, row), each layer's key folded
                  with its Flax path (``Dropout_m``) as ``make_rng`` does,
                  (rows, layers, B, width) bool
  vote_salts      the vote's two fingerprint salts, ``bits(key, (2,))``
                  under (seed + 4, step), (2,) int32

Every key is ``fold_in(key(seed), step)``, ``seed`` the caller's with its
salt added (the attack's + 7, the wire's + 17, the augmentation's + 2,
dropout's + 3, the vote's + 4; the tokens' none) and
``step`` an int32 tensor of one element on the rows' device: the step's
staged input, which the kernel reads from device memory, so a captured CUDA
graph draws each replay's own step's numbers. The wrappers check their
inputs alike on both devices; the plain versions also take the step as an
int.
"""

from __future__ import annotations

import functools

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
# the training step's salts (draco_tpu/training/step.py): augmentation,
# dropout, the vote's fingerprint salts
AUG_SALT = 2
DROPOUT_SALT = 3
VOTE_SALT = 4
AUG_PAD = 4  # the reference's reflect padding: top, left in [0, 2·pad]
DROPOUT_KEEP = 0.5  # the reference's nn.Dropout(0.5)
# threefry calls a sample's augmentation draws: its key, its three parts',
# two randints of a split and two draws, the flip's draw (the step's key
# and each row's come once a launch: sample_ops)
THREEFRY_PER_SAMPLE = 1 + 3 + 2 * 4 + 1


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
# the training step's draws: augmentation, dropout, the vote's salts
# --------------------------------------------------------------------------

def _row_keys(seed: int, step, rows: int, div: int, device) -> tuple:
    """The per-row keys ``fold_in(fold_in(key(seed), step), r // div)`` of
    rows 0 .. rows - 1 as a pair of (rows,) int64 tensors."""
    k = step_key(seed, step)
    r = torch.arange(rows, device=device) // div
    return drng.threefry2x32(k[0], k[1], 0, r)


def _split_last(k: tuple, num: int, device) -> tuple:
    """``split`` of a stack of keys into ``num``: a new trailing axis."""
    return drng.threefry2x32(k[0][..., None], k[1][..., None], 0,
                             torch.arange(num, device=device))


def _bits0(k: tuple) -> torch.Tensor:
    """``bits(k, ())`` of a stack of keys: each key's draw at counter 0."""
    a, b = drng.threefry2x32(k[0], k[1], 0, 0)
    return a ^ b


def _check_rows(rows: int, div: int, batch: int, what: str) -> None:
    if rows < 1 or div < 1 or batch < 1:
        raise ValueError(f"{what}: rows, div and batch must be >= 1, got "
                         f"{rows}, {div}, {batch}")


def augment_draws(step: torch.Tensor, seed: int, rows: int, batch: int,
                  div: int = 1) -> torch.Tensor:
    """(3, rows, batch) int32 (top, left, flip) of the reference's
    ``augment_batch`` for each row's key ``fold(key(seed), step, r //
    div)``: ``div`` is the vote's group size (a group's members see the
    same pixels), else 1. ``seed``: with AUG_SALT added."""
    dev = getattr(step, "device", None)
    _check_step(step, dev, "augment_draws")
    _check_rows(rows, div, batch, "augment_draws")
    if not _on(dev, "augment_draws"):
        return augment_draws_plain(step, seed, rows, batch, div, dev)
    out = torch.empty((3, rows, batch), dtype=torch.int32, device=dev)
    augment_draws_launch(step, seed, div, out)
    augment_draws.launches += 1
    return out


def augment_draws_launch(step, seed, div, out) -> None:
    _, rows, batch = out.shape
    err = _build.library("draws").draco_augment_draws(
        out.data_ptr(), step.data_ptr(), int(seed) & drng.M32, rows, div,
        batch, 2 * AUG_PAD + 1, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "augment_draws")


def augment_draws_plain(step, seed, rows, batch, div=1,
                        device=None) -> torch.Tensor:
    """``augment_draws`` in torch: split the row key into ``batch`` sample
    keys, each into three; two ``randint(0, 2·pad + 1)`` and a bernoulli."""
    kb = _split_last(_row_keys(seed, step, rows, div, device), batch,
                     device)  # (rows, batch)
    k3 = _split_last(kb, 3, device)  # (rows, batch, 3)
    # randint: each of the first two parts split in two, a draw of each
    hl = _bits0(_split_last((k3[0][..., :2], k3[1][..., :2]), 2, device))
    span = 2 * AUG_PAD + 1
    mult = ((2 ** 16 % span) ** 2 & drng.M32) % span
    off = (((hl[..., 0] % span) * mult + hl[..., 1] % span)
           & drng.M32) % span  # (rows, batch, 2)
    flip = drng.uniform_from_bits(_bits0((k3[0][..., 2], k3[1][..., 2])))
    return torch.stack([off[..., 0], off[..., 1],
                        (flip < 0.5).to(torch.int64)]).to(torch.int32)


@functools.lru_cache(maxsize=None)
def dropout_hashes(count: int) -> tuple:
    """The uint32 Flax folds into a row's dropout key for its ``count``
    layers: the static fold of ("Dropout_m", 1), the scope path of the
    m-th ``nn.Dropout`` and its first ``make_rng``."""
    return tuple(drng.static_hash(f"Dropout_{m}", 1) for m in range(count))


def dropout_keep(step: torch.Tensor, seed: int, rows: int, count: int,
                 batch: int, width: int, div: int = 1) -> torch.Tensor:
    """(rows, count, batch, width) bool keep-masks of ``count`` dropout
    layers of (batch, width) units: ``uniform < DROPOUT_KEEP`` under each
    layer's key (``dropout_hashes``) of each row's ``fold(key(seed), step,
    r // div)``. ``seed``: with DROPOUT_SALT added."""
    dev = getattr(step, "device", None)
    _check_step(step, dev, "dropout_keep")
    _check_rows(rows, div, batch, "dropout_keep")
    if count not in (1, 2):
        raise ValueError(f"dropout_keep: 1 or 2 layers, got {count}")
    if not _on(dev, "dropout_keep"):
        return dropout_keep_plain(step, seed, rows, count, batch, width, div,
                                  dev)
    # the kernel writes one byte, 0 or 1, a unit: bool storage
    out = torch.empty((rows, count, batch, width), dtype=torch.bool,
                      device=dev)
    dropout_keep_launch(step, seed, div, out)
    dropout_keep.launches += 1
    return out


def dropout_keep_launch(step, seed, div, out) -> None:
    rows, count, batch, width = out.shape
    h = list(dropout_hashes(count)) + [0]
    err = _build.library("draws").draco_dropout_keep(
        out.data_ptr(), step.data_ptr(), int(seed) & drng.M32, rows, div,
        count, h[0], h[1], batch * width, DROPOUT_KEEP,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "dropout_keep")


def dropout_keep_plain(step, seed, rows, count, batch, width, div=1,
                       device=None) -> torch.Tensor:
    kr = _row_keys(seed, step, rows, div, device)
    c = torch.arange(batch * width, device=kr[0].device)
    keep = []
    for h in dropout_hashes(count):  # no host tensor: a graph captures it
        kl = drng.threefry2x32(kr[0], kr[1], 0, h)
        a, b = drng.threefry2x32(kl[0][:, None], kl[1][:, None], 0, c)
        keep.append(drng.uniform_from_bits(a ^ b) < DROPOUT_KEEP)
    return torch.stack(keep, dim=1).view(rows, count, batch, width)


def vote_salts(step: torch.Tensor, seed: int) -> torch.Tensor:
    """The vote's (2,) int32 fingerprint salts of the step: ``bits(fold_in(
    key(seed), step), (2,))``. ``seed``: with VOTE_SALT added."""
    dev = getattr(step, "device", None)
    _check_step(step, dev, "vote_salts")
    if not _on(dev, "vote_salts"):
        return vote_salts_plain(step, seed, dev)
    out = torch.empty((2,), dtype=torch.int32, device=dev)
    vote_salts_launch(step, seed, out)
    vote_salts.launches += 1
    return out


def vote_salts_launch(step, seed, out) -> None:
    err = _build.library("draws").draco_vote_salts(
        out.data_ptr(), step.data_ptr(), int(seed) & drng.M32,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "vote_salts")


def vote_salts_plain(step, seed, device=None) -> torch.Tensor:
    b = drng.bits(step_key(seed, step), (2,), device=device)
    return torch.where(b >= 1 << 31, b - (1 << 32), b).to(torch.int32)


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


def sample_ops(rows: int, batch: int, div: int = 1) -> int:
    """32-bit integer operations of the augmentation draws of ``rows`` rows
    of ``batch`` samples, a key every ``div`` rows: the step's key, the
    keys of the rows, and each sample's draws."""
    keys = -(-int(rows) // int(div))
    return OPS_PER_DRAW * (1 + keys + THREEFRY_PER_SAMPLE * keys * int(batch))


random_inject.launches = 0
round_draw.launches = 0
synthetic_text.launches = 0
augment_draws.launches = 0
dropout_keep.launches = 0
vote_salts.launches = 0
