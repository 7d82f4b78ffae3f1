"""The port's narrow wire (``draco_tpu_torch.obs.numerics``) against the
JAX package's ``draco_tpu.obs.numerics``.

Inputs come from a numpy seed at a ragged d (not a multiple of any scale
block), with NaN, +Inf, -Inf, values past bf16's range and an all-zero
block. Tolerance: none. The narrow buffers (bf16 ``q``; int8 ``q`` and
``scale``) and the widened rows must equal the reference's bit for bit —
both sides round to nearest even and divide by the same f32 scale, so any
difference is a fault. The thresholds and λs are the reference's
constants and must be equal.

The narrow wire as a chunk on the CPU: cyclic ``shared`` ResNet-18 on the
int8 wire (block 256; n=5, s=1, a rev_grad adversary every step, batch 1,
``registry.CNN_CI``), ``train_many`` over the chunks (1, 3) and (4, 1)
against four eager steps, bit for bit (``test_torch_chunk.py``'s
harness), here in a file of many tests, which xdist's loadfile schedules
early.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from draco_tpu.config import TrainConfig as JaxConfig
from draco_tpu.obs import numerics as jnx
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.obs import numerics as tnx

torch.set_num_threads(1)

N, D = 8, 3 * 1024 + 77


def _rows(seed: int = 0) -> np.ndarray:
    rs = np.random.RandomState(seed)
    x = (rs.randn(N, D) * np.exp(2.0 * rs.randn(N, D))).astype(np.float32)
    x[1, 5], x[2, 7], x[3, 9] = np.nan, np.inf, -np.inf
    x[4, :256] = 0.0  # an all-zero block (scale 1)
    x[5, 300], x[5, 301] = 3.0e38, -3.39e38  # past bf16's largest finite
    x[6, 10] = 1.5  # exactly halfway between int8 levels at some scales
    return x


def _bits(a) -> np.ndarray:
    """The raw bits of an array (NaN payloads included)."""
    a = np.asarray(a.view(torch.int16) if isinstance(a, torch.Tensor)
                   and a.dtype == torch.bfloat16 else a)
    if a.dtype == jnp.bfloat16:
        a = a.view(np.int16)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


@pytest.mark.parametrize("mode,block", [("bf16", 256), ("int8", 256),
                                        ("int8", 96), ("int8", 1),
                                        ("int8", 4096)])
def test_narrow_buffers_bit_for_bit(mode, block):
    x = _rows()
    ref = jnx.narrow_wire_rows(jnp.asarray(x), mode, block)
    out = tnx.narrow_wire_rows(torch.from_numpy(x), mode, block)
    assert set(out) == set(ref)
    for k in ref:
        assert tuple(out[k].shape) == tuple(ref[k].shape), k
        np.testing.assert_array_equal(_bits(out[k]), _bits(ref[k]), err_msg=k)
    wide_ref = jnx.widen_wire_rows(ref, mode, block)
    wide = tnx.widen_wire_rows(out, mode, block)
    np.testing.assert_array_equal(_bits(wide.numpy()), _bits(wide_ref))


def test_int8_levels_and_scales_by_hand():
    """The int8 rule on one row: scale = absmax/127 per block (1 for an
    all-zero block), levels round half to even, non-finite -> 0."""
    x = torch.tensor([[127.0, -63.5, 0.5, float("nan"), 0.0, 0.0, 254.0,
                       float("inf")]])
    buf = tnx.narrow_wire_rows(x, "int8", 4)
    assert buf["scale"].tolist() == [[1.0, 2.0]]
    assert buf["q"].tolist() == [[127, -64, 0, 0, 0, 0, 127, 0]]


def test_narrow_wire_pair_and_single():
    """The pair helper returns the widened rows and the buffers; the single
    helper the buffers only; both the identity on the f32 wire."""
    rs = np.random.RandomState(1)
    re, im = (torch.from_numpy(rs.randn(N, D).astype(np.float32))
              for _ in range(2))
    cfg = TrainConfig(approach="cyclic", worker_fail=1, wire_dtype="int8",
                      shadow_block=96)
    w_re, w_im, wire = tnx.narrow_wire_pair(cfg, re, im)
    jcfg = JaxConfig(approach="cyclic", worker_fail=1, wire_dtype="int8",
                     shadow_block=96)
    j_re, j_im, jwire = jnx.narrow_wire_pair(jcfg, jnp.asarray(re.numpy()),
                                             jnp.asarray(im.numpy()))
    np.testing.assert_array_equal(w_re.numpy(), np.asarray(j_re))
    np.testing.assert_array_equal(w_im.numpy(), np.asarray(j_im))
    assert wire[0] == jwire[0] == "int8" and wire[3] == jwire[3] == 96
    for ours, ref in ((wire[1], jwire[1]), (wire[2], jwire[2])):
        for k in ref:
            np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]))
    mode, buf, block = tnx.narrow_wire_single(cfg, re)
    assert (mode, block) == ("int8", 96)
    np.testing.assert_array_equal(buf["q"].numpy(), wire[1]["q"].numpy())
    f32 = dataclasses.replace(cfg, wire_dtype="f32")
    assert tnx.narrow_wire_pair(f32, re, im)[2] is None
    assert tnx.narrow_wire_single(f32, re) is None


@pytest.mark.parametrize("n,s", [(8, 1), (9, 1), (32, 3), (16, 2), (20, 4)])
def test_thresholds_equal(n, s):
    for dtype in ("bf16", "int8"):
        assert tnx.wire_rel_tol(n, s, dtype) == jnx.wire_rel_tol(n, s, dtype)
    for dtype in ("f32", "bf16", "int8"):
        assert tnx.wire_locator_lambda(dtype) == jnx.wire_locator_lambda(dtype)
        assert tnx.wire_residual_slack(dtype) == jnx.wire_residual_slack(dtype)
        kw = dict(approach="cyclic", num_workers=n, worker_fail=s,
                  wire_dtype=dtype)
        assert tnx.wire_decode_params(TrainConfig(**kw)) == \
            jnx.wire_decode_params(JaxConfig(**kw))
    assert tnx.INT8_LEVELS == jnx.INT8_LEVELS
    assert tnx.DEFAULT_BLOCK == jnx.DEFAULT_BLOCK
    assert tnx.WIRE_REL_TOL_TABLE == jnx.WIRE_REL_TOL_TABLE
    assert tnx.SHADOW_REL_TOL == jnx.SHADOW_REL_TOL


def test_train_many_equals_eager_steps():
    from draco_tpu_torch.data import datasets
    from test_torch_chunk import assert_chunk_equals_eager, cnn_build
    from test_torch_chunk import cnn_chunk

    ds = datasets.load_dataset("synthetic-cifar10", synthetic_train=256,
                               synthetic_test=16)
    assert_chunk_equals_eager(cnn_build("shared_int8", ds), cnn_chunk)
