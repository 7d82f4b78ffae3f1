"""Byzantine attack simulation (draco_tpu/attacks.py), ADVERSARY = CONST = -100.

  * plain paths (baseline, repetition): rev_grad g -> -100·g; constant
    g -> -100·1; random g -> -100·N(0, 1); and two colluding attacks on
    approximate robust rules: alie (mu - z·sigma of the honest rows, z the
    evasion quantile of Baruch et al. 2019) and ipm (-0.5·mu, Xie et al.
    2020), both scaled by |magnitude| / 100
  * cyclic path, additive on the honest encoded value: rev_grad
    g -> g + (-100·g); constant adds -100 to the real part only; random adds
    -100·noise to each part (independent draws)

``random`` draws its noise from an explicit ``torch.Generator`` — or takes
the noise itself (``noise=``), so a test can hand both packages the same
numbers.
"""

from __future__ import annotations

import math
import statistics
import warnings
from typing import Optional

import torch

ADVERSARY = -100.0
CONST = -100.0
# the random attack's generator salt (seed + _RANDOM_SALT), as in the
# reference
_RANDOM_SALT = 7
_ALIE_INERT_WARNED = set()  # one warning per inert (n, n_mal) pair


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


def _honest_stats(grads, mask):
    """Mean and std over the honest rows only: what colluding adversaries
    that observe their peers would estimate."""
    w = (~mask).to(grads.dtype)[:, None]
    cnt = torch.clamp_min(w.sum(), 1.0)
    mu = (grads * w).sum(0) / cnt
    var = ((grads - mu) ** 2 * w).sum(0) / cnt
    return mu, torch.sqrt(var)


def _alie_z(n: int, n_mal: int) -> float:
    """ALIE's evasion quantile: the largest z at which the perturbed value
    still looks like a non-outlier to a median-like rule over n workers
    with n_mal colluders, z = Phi^-1((n - n_mal - s) / (n - n_mal)),
    s = floor(n/2 + 1) - n_mal."""
    s = math.floor(n / 2 + 1) - n_mal
    p = max(min((n - n_mal - s) / max(n - n_mal, 1), 1.0 - 1e-6), 1e-6)
    return statistics.NormalDist().inv_cdf(p)


def inject_plain(grads, mask, err_mode: str, magnitude: float = ADVERSARY,
                 noise=None, generator=None, n_mal: int = 1):
    """grads: (n, d); mask: (n,) bool — True rows are Byzantine.

    ``alie`` / ``ipm``: every Byzantine row takes the same payload from the
    honest rows' statistics; ``n_mal`` is the static colluder count
    (cfg.num_adversaries). They scale with |magnitude| / 100 and ignore its
    sign: they fix their own direction."""
    mask = mask.to(grads.device)
    if err_mode in ("alie", "ipm"):
        n = grads.shape[0]
        scale = abs(magnitude) / abs(ADVERSARY)
        mu, sigma = _honest_stats(grads, mask)
        if err_mode == "alie":
            z = _alie_z(n, max(n_mal, 1))
            if z <= 0 and (n, n_mal) not in _ALIE_INERT_WARNED:
                _ALIE_INERT_WARNED.add((n, n_mal))
                warnings.warn(
                    f"alie is inert at n={n}, n_mal={n_mal}: the evasion "
                    f"quantile z={z:.3f} <= 0, so the payload is (at most) "
                    f"the honest mean — the attack needs more workers or "
                    f"more colluders to have any z to hide behind",
                    stacklevel=2)
            bad = mu - scale * z * sigma
        else:
            bad = -0.5 * scale * mu
        return torch.where(mask[:, None], bad[None, :], grads)
    bad = attack_plain(grads, err_mode, magnitude, noise, generator)
    return torch.where(mask[:, None], bad, grads)


def inject_cyclic(enc_re, enc_im, mask, err_mode: str,
                  magnitude: float = ADVERSARY, noise=None, generator=None):
    bad_re, bad_im = attack_cyclic(enc_re, enc_im, err_mode, magnitude,
                                   noise, generator)
    m = mask.to(enc_re.device)[:, None]
    return torch.where(m, bad_re, enc_re), torch.where(m, bad_im, enc_im)
