"""Byzantine attack simulation (draco_tpu/attacks.py), ADVERSARY = CONST = -100.

  * plain paths (baseline): rev_grad g -> -100·g; constant g -> -100·1;
    random g -> -100·N(0, 1)
  * cyclic path, additive on the honest encoded value: rev_grad
    g -> g + (-100·g); constant adds -100 to the real part only; random adds
    -100·noise to each part (independent draws)

``random`` draws its noise from an explicit ``torch.Generator`` — or takes
the noise itself (``noise=``), so a test can hand both packages the same
numbers.
"""

from __future__ import annotations

from typing import Optional

import torch

ADVERSARY = -100.0
CONST = -100.0
# the random attack's generator salt (seed + _RANDOM_SALT), as in the
# reference
_RANDOM_SALT = 7


def random_generator(seed: int, step: int, device="cpu") -> torch.Generator:
    """The random attack's per-step generator, folded from (seed, step)."""
    from draco_tpu_torch import rng as drng

    return drng.generator(seed + _RANDOM_SALT, step, device=device)


def _noise(like: torch.Tensor, generator: Optional[torch.Generator]):
    if generator is None:
        raise ValueError(
            "err_mode='random' needs its noise or a generator (attacks."
            "random_generator(seed, step)); a keyless call has no stream")
    return torch.randn(like.shape, generator=generator, device=like.device,
                       dtype=like.dtype)


def attack_plain(grads, err_mode: str, magnitude: float = ADVERSARY,
                 noise=None, generator=None):
    """Adversarial transform of raw per-worker gradients, shape (n, d)."""
    if err_mode == "rev_grad":
        return magnitude * grads
    if err_mode == "constant":
        return torch.full_like(grads, magnitude)
    if err_mode == "random":
        if noise is None:
            noise = _noise(grads, generator)
        return magnitude * noise
    raise ValueError(f"unknown err_mode: {err_mode}")


def attack_cyclic(enc_re, enc_im, err_mode: str, magnitude: float = ADVERSARY,
                  noise=None, generator=None):
    """Adversarial transform of encoded rows, real/imag parts, (n, d).
    ``noise`` for ``random`` is the pair (noise_re, noise_im)."""
    if err_mode == "rev_grad":
        return enc_re + magnitude * enc_re, enc_im + magnitude * enc_im
    if err_mode == "constant":
        return enc_re + magnitude, enc_im
    if err_mode == "random":
        if noise is None:
            noise = (_noise(enc_re, generator), _noise(enc_im, generator))
        return enc_re + magnitude * noise[0], enc_im + magnitude * noise[1]
    raise ValueError(f"unknown err_mode: {err_mode}")


def inject_plain(grads, mask, err_mode: str, magnitude: float = ADVERSARY,
                 noise=None, generator=None):
    """grads: (n, d); mask: (n,) bool — True rows are Byzantine."""
    bad = attack_plain(grads, err_mode, magnitude, noise, generator)
    return torch.where(mask.to(grads.device)[:, None], bad, grads)


def inject_cyclic(enc_re, enc_im, mask, err_mode: str,
                  magnitude: float = ADVERSARY, noise=None, generator=None):
    bad_re, bad_im = attack_cyclic(enc_re, enc_im, err_mode, magnitude,
                                   noise, generator)
    m = mask.to(enc_re.device)[:, None]
    return torch.where(m, bad_re, enc_re), torch.where(m, bad_im, enc_im)
