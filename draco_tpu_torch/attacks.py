"""Byzantine attack simulation (draco_tpu/attacks.py), ADVERSARY = CONST = -100.

  * plain paths (baseline, repetition): rev_grad g -> -100·g; constant
    g -> -100·1; random g -> -100·N(0, 1); and two colluding attacks on
    approximate robust rules: alie (mu - z·sigma of the honest rows, z the
    evasion quantile of Baruch et al. 2019) and ipm (-0.5·mu, Xie et al.
    2020), both scaled by |magnitude| / 100
  * cyclic path, additive on the honest encoded value: rev_grad
    g -> g + (-100·g); constant adds -100 to the real part only; random adds
    -100·noise to each part (independent draws)

``random`` draws the reference's own numbers: ``normal(random_key(seed,
step))`` over the (n, d) rows (the cyclic pair: the key's split, one half
a part), on the card by the ``random_inject`` kernel (``ops/draws.py``),
which reads the step from the device and draws the attacked rows only, in
place on the rows given. A test can hand both packages explicit numbers
instead (``noise=``).
"""

from __future__ import annotations

import math
import statistics
import warnings
from typing import Optional

import torch

from draco_tpu_torch.ops import draws

ADVERSARY = -100.0
CONST = -100.0
# the random attack's key salt (seed + _RANDOM_SALT), as in the reference
_RANDOM_SALT = draws.RANDOM_SALT
_ALIE_INERT_WARNED = set()  # one warning per inert (n, n_mal) pair


def random_key(seed: int, step) -> tuple:
    """The random attack's per-step key, ``fold_in(key(seed + 7), step)``;
    ``step`` an int or a device tensor."""
    return draws.step_key(seed + _RANDOM_SALT, step)


_KEYLESS = ("err_mode='random' needs its noise or the step and the seed (the "
            "key is random_key(seed, step)); a keyless call has no stream")


def attack_plain(grads, err_mode: str, magnitude: float = ADVERSARY,
                 noise=None):
    """Adversarial transform of raw per-worker gradients, shape (n, d).
    ``random`` here takes its ``noise``; ``inject_plain`` draws it."""
    if err_mode == "rev_grad":
        return magnitude * grads
    if err_mode == "constant":
        return torch.full_like(grads, magnitude)
    if err_mode == "random":
        if noise is None:
            raise ValueError(_KEYLESS)
        return magnitude * noise
    raise ValueError(f"unknown err_mode: {err_mode}")


def attack_cyclic(enc_re, enc_im, err_mode: str, magnitude: float = ADVERSARY,
                  noise=None):
    """Adversarial transform of encoded rows, real/imag parts, (n, d).
    ``noise`` for ``random`` is the pair (noise_re, noise_im)."""
    if err_mode == "rev_grad":
        return enc_re + magnitude * enc_re, enc_im + magnitude * enc_im
    if err_mode == "constant":
        return enc_re + magnitude, enc_im
    if err_mode == "random":
        if noise is None:
            raise ValueError(_KEYLESS)
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
                 noise=None, step=None, seed: Optional[int] = None,
                 n_mal: int = 1):
    """grads: (n, d); mask: (n,) bool — True rows are Byzantine.

    ``random`` without ``noise`` writes the draws of ``random_key(seed,
    step)`` into the Byzantine rows of ``grads`` in place (the kernel on the
    card; ``step`` an int32 device tensor there) and returns ``grads``.

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
    if err_mode == "random" and noise is None:
        if step is None or seed is None:
            raise ValueError(_KEYLESS)
        draws.random_inject(grads, mask, step, seed + _RANDOM_SALT, magnitude,
                            max_rows=n_mal)
        return grads
    bad = attack_plain(grads, err_mode, magnitude, noise)
    return torch.where(mask[:, None], bad, grads)


def inject_cyclic(enc_re, enc_im, mask, err_mode: str,
                  magnitude: float = ADVERSARY, noise=None, step=None,
                  seed: Optional[int] = None, n_mal: Optional[int] = None):
    """The attack on the Byzantine rows of a cyclic codeword pair. ``random``
    without ``noise`` adds the draws of ``split(random_key(seed, step))``
    to both parts in place and returns them; ``n_mal``: at most this many
    rows are Byzantine (None: any)."""
    m = mask.to(enc_re.device)
    if err_mode == "random" and noise is None:
        if step is None or seed is None:
            raise ValueError(_KEYLESS)
        draws.random_inject(enc_re, m, step, seed + _RANDOM_SALT, magnitude,
                            imag=enc_im, max_rows=n_mal)
        return enc_re, enc_im
    bad_re, bad_im = attack_cyclic(enc_re, enc_im, err_mode, magnitude, noise)
    m = m[:, None]
    return torch.where(m, bad_re, enc_re), torch.where(m, bad_im, enc_im)
