"""The port's coded products (``draco_tpu_torch.ops.coded``) against the JAX
package's ``ops/coded``, both its default XLA path and its Pallas kernels
in interpret mode.

On the CPU each wrapper computes its plain version, so this pins the
arithmetic the CUDA kernels are held to on the card (``chip_smoke.py``).
d is not a multiple of the Pallas kernels' TILE_D, so their ragged edge is
covered. Tolerance: rtol 1e-5, with an absolute floor of 1e-5 times the
sum of the terms' magnitudes — the same f32 sums taken in another order
(XLA's dot, the interpreter's 128-lane partials, torch's matmul) differ by
a few ulps of that scale, and an entry that cancels to near zero has no
relative accuracy to compare.
"""

import numpy as np
import pytest
import torch

from draco_tpu.ops import coded as jcoded
from draco_tpu_torch import ops as tops
from draco_tpu_torch.ops import coded as tcoded

torch.set_num_threads(1)

N, D = 8, 2 * 4096 + 1234
PALLAS = [pytest.param({}, id="xla"),
          pytest.param({"force": True, "interpret": True}, id="pallas")]


@pytest.fixture(scope="module")
def mats():
    rng = np.random.RandomState(11)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {"wr": f32(N, N), "wi": f32(N, N), "g": f32(N, D),
            "rr": f32(N, D), "ri": f32(N, D), "f": 1 + f32(D),
            "vr": f32(N), "vi": f32(N)}


def close(port, ref, scale):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5 * float(np.max(scale)))


T = torch.from_numpy


@pytest.mark.parametrize("kw", PALLAS)
def test_complex_matmul(mats, kw):
    m = mats
    j_re, j_im = jcoded.complex_matmul(m["wr"], m["wi"], m["g"], **kw)
    t_re, t_im = tcoded.complex_matmul(T(m["wr"]), T(m["wi"]), T(m["g"]))
    close(t_re, j_re, np.abs(m["wr"]) @ np.abs(m["g"]))
    close(t_im, j_im, np.abs(m["wi"]) @ np.abs(m["g"]))


@pytest.mark.parametrize("kw", PALLAS)
def test_complex_project(mats, kw):
    m = mats
    j_re, j_im = jcoded.complex_project(m["rr"], m["ri"], m["f"], **kw)
    t_re, t_im = tcoded.complex_project(T(m["rr"]), T(m["ri"]), T(m["f"]))
    close(t_re, j_re, np.abs(m["rr"]) @ np.abs(m["f"]))
    close(t_im, j_im, np.abs(m["ri"]) @ np.abs(m["f"]))


@pytest.mark.parametrize("kw", PALLAS)
def test_complex_recombine(mats, kw):
    m = mats
    j = jcoded.complex_recombine(m["vr"], m["vi"], m["rr"], m["ri"], **kw)
    t = tcoded.complex_recombine(T(m["vr"]), T(m["vi"]), T(m["rr"]),
                                 T(m["ri"]))
    close(t, j, np.abs(m["vr"]) @ np.abs(m["rr"])
          + np.abs(m["vi"]) @ np.abs(m["ri"]))


def test_cpu_tensors_take_the_plain_version(mats):
    """A CPU tensor never reaches a kernel: the launch counters stay put
    and the result is the plain version's, bit for bit."""
    m = {k: T(v) for k, v in mats.items()}
    before = tops.launch_counts()
    out = tcoded.complex_matmul(m["wr"], m["wi"], m["g"])
    plain = tcoded.complex_matmul_plain(m["wr"], m["wi"], m["g"])
    assert all(torch.equal(a, b) for a, b in zip(out, plain))
    assert torch.equal(tcoded.complex_recombine(m["vr"], m["vi"], m["rr"],
                                                m["ri"]),
                       tcoded.complex_recombine_plain(m["vr"], m["vi"],
                                                      m["rr"], m["ri"]))
    tcoded.complex_project(m["rr"], m["ri"], m["f"])
    assert tops.launch_counts() == before


def test_other_devices_raise():
    """Neither the CPU nor CUDA: no silent path."""
    meta = torch.empty((N, D), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tcoded.complex_project(meta, meta, torch.empty(D, device="meta"))


def test_launch_counters_reset():
    tcoded.complex_matmul.launches = 3
    tops.reset_launch_counts()
    assert set(tops.launch_counts().values()) == {0}
    assert set(tops.KERNELS) == {"complex_matmul", "complex_project",
                                 "complex_recombine", "cyclic_locator"}
