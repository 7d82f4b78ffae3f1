"""The segmented wire and the per-layer decode of the port
(``obs/numerics.wire_segment_bounds``, ``parallel/common
.segment_decode_bounds``, ``ops/coded.segment_plan``, ``coding/cyclic
.decode_segments`` / ``decode_layers``, ``coding/approx.decode_segments``)
against the JAX package's, on the CPU (the kernels' plain versions).

* The cuts: the port's equal the reference's for every d, S and int8 block
  below, and the layer refinement with ResNet-18's and the LM's leaf
  offsets (62 and 66 leaves; the LM's 69 segments at S = 4).
* The plan table: every column in exactly one tile, no tile past
  SEGMENT_TILE columns or across a cut, at any cut.
* The decodes on numpy-seeded rows (n = 8, d = 50,000) with a rev_grad row
  or an absent row, on the f32, bf16 and int8 wires, at S = 1, 2, 3 and on a
  leaf-like partition with a 10-column segment and int8 cuts inside a
  scale block, against the reference's ``impl="fused"`` (its CPU path,
  which recombines the widened rows): the honest, flagged and loud sets
  equal, every segment n − 2s honest rows, the decoded mean within rtol
  2e-4, atol 1e-6 (the reference's own bound for segmented against
  unsegmented, tests/test_segments.py), the cyclic residual within rtol
  2e-4, atol 1e-5 (an exact decode's residual is f32 rounding, ~1e-6, in
  either order); the approx code's decode and its residual within rtol
  2e-4, atol 1e-6, with two absent rows.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from draco_tpu.coding import approx as japprox
from draco_tpu.coding import cyclic as jcyclic
from draco_tpu.obs import numerics as jnx
from draco_tpu.ops import decode_kernels as jdk
from draco_tpu.parallel import common as jcommon
from draco_tpu_torch import params
from draco_tpu_torch.coding import approx, cyclic
from draco_tpu_torch.models import build_model
from draco_tpu_torch.models.transformer import TransformerLM
from draco_tpu_torch.obs import numerics
from draco_tpu_torch.ops import coded, decode_kernels
from draco_tpu_torch.parallel import common

torch.set_num_threads(1)

N, S_FAIL, D = 8, 1, 50_000
RTOL, ATOL = 2e-4, 1e-6
RESID_ATOL = 1e-5
RESNET_D, LM_D = 11_173_962, 62_958_336
# a leaf-like partition: a 10-column segment, cuts inside int8 blocks of
# 256 and 24, a cut on a quantum
LEAFLIKE = (0, 10, 1000, 4096, 4103, 9000, 20_000, 33_333, D)
WIRES = {"f32": (None, 0.0), "bf16": (5e-2, 2.0 ** -8),
         "int8": (1.5e-1, 2.0 ** -6)}


@pytest.fixture(scope="module")
def layouts():
    """ResNet-18's and the full-width LM's leaf offsets (no weights)."""
    with torch.device("meta"):
        resnet = build_model("ResNet18", "synthetic-cifar10")
        lm = TransformerLM(vocab=8192, dim=768, heads=12, layers=8)
    return {"resnet": params.layout(resnet).offsets,
            "lm": params.layout(lm).offsets}


# --------------------------------------------------------------------------
# the cuts
# --------------------------------------------------------------------------

@pytest.mark.parametrize("d", [1, 4095, 4096, 4097, RESNET_D, LM_D])
def test_wire_segment_bounds_equal_the_reference(d):
    for segments in (1, 2, 3, 4, 8):
        for block in (1, 24, 256):
            ours = numerics.wire_segment_bounds(d, segments, block)
            assert ours == jnx.wire_segment_bounds(d, segments, block), (
                d, segments, block)
            assert ours[0] == 0 and ours[-1] == d
            assert all(c % block == 0 for c in ours[1:-1])
    assert numerics.SEGMENT_QUANTUM == jnx.SEGMENT_QUANTUM
    assert numerics.wire_segment_bounds(0, 2) == (0, 0)


@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
def test_cfg_and_layer_bounds_equal_the_reference(layouts, wire):
    for name, offsets in layouts.items():
        dim = int(offsets[-1])
        for segments in (1, 2, 4):
            cfg = SimpleNamespace(wire_segments=segments, wire_dtype=wire,
                                  shadow_block=256)
            assert numerics.cfg_segment_bounds(cfg, dim) == \
                jnx.cfg_segment_bounds(cfg, dim)
            for leaf in (None, offsets):
                assert common.segment_decode_bounds(cfg, dim, leaf) == \
                    jcommon.segment_decode_bounds(cfg, dim, leaf), (
                        name, segments, leaf is None)
    # the legs' partitions: 62 ResNet-18 leaves; the LM's 66 leaves refined
    # by 4 segments into 69
    assert len(layouts["resnet"]) - 1 == 62 and len(layouts["lm"]) - 1 == 66
    lm4 = SimpleNamespace(wire_segments=4, wire_dtype="f32", shadow_block=256)
    assert len(common.segment_decode_bounds(lm4, LM_D, layouts["lm"])) == 70


def test_decode_bounds_dispatch(layouts):
    off = layouts["resnet"]

    def cfg(**kw):
        return SimpleNamespace(**{"wire_segments": 1, "wire_dtype": "f32",
                                  "shadow_block": 256,
                                  "decode_granularity": "global", **kw})

    assert common.decode_bounds(cfg(), RESNET_D, off) is None
    assert common.decode_bounds(cfg(decode_granularity="layer"), RESNET_D,
                                off) == [int(o) for o in off]
    assert common.decode_bounds(cfg(wire_segments=4), RESNET_D, off) == list(
        numerics.wire_segment_bounds(RESNET_D, 4))
    c = cfg(decode_granularity="layer", wire_segments=4, wire_dtype="int8")
    assert common.decode_bounds(c, RESNET_D, off) == \
        common.segment_decode_bounds(c, RESNET_D, off)
    with pytest.raises(ValueError, match="leaf offsets"):
        common.decode_bounds(cfg(decode_granularity="layer"), RESNET_D)


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------

def _check_table(bounds):
    table = coded.plan_table(bounds)
    segs = len(bounds) - 1
    tiles = (len(table) - segs - 1) // 3
    seg, lo, hi = table[:tiles], table[tiles:2 * tiles], table[2 * tiles:
                                                                3 * tiles]
    first = table[3 * tiles:]
    assert table.dtype == np.int32 and len(first) == segs + 1
    assert first[0] == 0 and first[-1] == tiles
    assert np.all(hi > lo) and np.all(hi - lo <= coded.SEGMENT_TILE)
    b = np.asarray(bounds)
    assert np.all(lo >= b[seg]) and np.all(hi <= b[seg + 1])
    for j in range(segs):
        assert np.all(seg[first[j]:first[j + 1]] == j)
    cover = np.zeros(bounds[-1] - bounds[0], np.int64)
    for a, e in zip(lo, hi):
        cover[a - bounds[0]:e - bounds[0]] += 1
    assert np.all(cover == 1), "a column in no tile or in two"
    return tiles


def test_plan_covers_every_column_once():
    rng = np.random.RandomState(3)
    for bounds in [(0, 1), (0, 2048), (0, 2049), (0, 10, 5003),
                   (7, 4096, 9000), LEAFLIKE,
                   tuple(numerics.wire_segment_bounds(RESNET_D, 4))]:
        _check_table(bounds)
    for _ in range(20):
        cuts = np.unique(rng.randint(1, 30_000, size=rng.randint(1, 40)))
        _check_table((0, *cuts.tolist(), 30_000))
    assert _check_table((0, 2048, 4097)) == 3
    for bad in [(0,), (0, 0), (5, 3), (-1, 4), (0, 2 ** 31)]:
        with pytest.raises(ValueError):
            coded.plan_table(bad)


def test_plan_is_cached_per_cuts_and_device():
    p = coded.segment_plan(LEAFLIKE, "cpu")
    assert coded.segment_plan(list(LEAFLIKE), torch.device("cpu")) is p
    assert p.segments == len(LEAFLIKE) - 1
    assert p.table.dtype == torch.int32 and p.table.device.type == "cpu"


# --------------------------------------------------------------------------
# the decodes against the reference
# --------------------------------------------------------------------------

def _partitions(wire):
    block = 256 if wire == "int8" else 1
    out = {f"S={k}": numerics.wire_segment_bounds(D, k, block)
           for k in (1, 2, 3)}
    out["leaflike"] = LEAFLIKE
    cfg = SimpleNamespace(wire_segments=3, wire_dtype=wire, shadow_block=256)
    out["leaflike+S=3"] = tuple(common.segment_decode_bounds(cfg, D,
                                                             LEAFLIKE))
    return out


def _cyclic_rows(fault):
    rng = np.random.RandomState(11)
    bg = rng.normal(size=(N, D)).astype(np.float32)
    code = cyclic.build_cyclic_code(N, S_FAIL)
    er, ei = cyclic.encode_shared(code, torch.from_numpy(bg))
    present = None
    if fault == "rev_grad":
        er[5], ei[5] = -100.0 * er[5], -100.0 * ei[5]
    else:  # row 2 never arrives: zero-filled, an erasure
        er[2], ei[2] = 0.0, 0.0
        present = torch.ones(N, dtype=torch.bool)
        present[2] = False
    f = rng.uniform(size=D).astype(np.float32)
    return code, bg, er, ei, torch.from_numpy(f), present


@pytest.mark.parametrize("fault", ["rev_grad", "absent"])
@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
def test_cyclic_segmented_decodes_match_the_reference(wire, fault):
    code, bg, er, ei, f, present = _cyclic_rows(fault)
    jcode = jcyclic.build_cyclic_code(N, S_FAIL)
    tol, lam = WIRES[wire]
    rel_tol = cyclic.HEALTH_REL_TOL if tol is None else tol
    w = None
    if wire != "f32":
        w = (wire, numerics.narrow_wire_rows(er, wire),
             numerics.narrow_wire_rows(ei, wire), 256)
        er, ei = (numerics.widen_wire_rows(w[1], wire),
                  numerics.widen_wire_rows(w[2], wire))
    jargs = (jnp.asarray(er.numpy()), jnp.asarray(ei.numpy()),
             jnp.asarray(f.numpy()))
    jpres = None if present is None else jnp.asarray(present.numpy())
    mean = bg.mean(0)
    for label, bounds in _partitions(wire).items():
        # decode_layers is decode_segments on the leaf boundaries without
        # the narrow wire: held on the leaf-like partition
        for fn in ("decode_segments",) + (
                ("decode_layers",) if label == "leaflike" else ()):
            dec, hon, health = getattr(cyclic, fn)(
                code, er, ei, f, bounds, present=present, with_health=True,
                rel_tol=rel_tol, lam=lam, wire=w)
            jdec, jhon, jhealth = getattr(jcyclic, fn)(
                jcode, *jargs, bounds, present=jpres, with_health=True,
                rel_tol=rel_tol, impl="fused", lam=lam)
            what = f"{fn} {wire} {fault} {label}"
            np.testing.assert_array_equal(hon.numpy(), np.asarray(jhon),
                                          err_msg=what)
            for k in ("flagged", "loud"):
                np.testing.assert_array_equal(
                    health[k].numpy(), np.asarray(jhealth[k]),
                    err_msg=f"{what} {k}")
            assert hon.shape == (len(bounds) - 1, N)
            assert bool((hon.sum(1) == N - 2 * S_FAIL).all()), what
            np.testing.assert_allclose(dec.numpy(), np.asarray(jdec),
                                       rtol=RTOL, atol=ATOL, err_msg=what)
            # the residual of an exact decode is f32 rounding (~1e-6 of
            # the energy) in either summation order
            np.testing.assert_allclose(float(health["residual"]),
                                       float(jhealth["residual"]),
                                       rtol=RTOL, atol=RESID_ATOL,
                                       err_msg=what)
            if wire == "f32":  # the exact decode: the true mean
                np.testing.assert_allclose(dec.numpy(), mean, rtol=RTOL,
                                           atol=1e-5, err_msg=what)
            if fault == "rev_grad":
                assert health["flagged"].nonzero().flatten().tolist() == [5]


@pytest.mark.parametrize("wire,block", [("f32", 1), ("bf16", 256),
                                        ("int8", 256), ("int8", 24)])
def test_approx_segmented_decode_matches_the_reference(wire, block):
    rng = np.random.RandomState(12)
    bg = torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32))
    code = approx.build_approx_code(N, 1.5)
    jcode = japprox.build_approx_code(N, 1.5)
    present = torch.ones(N, dtype=torch.bool)
    present[[2, 5]] = False
    rows = approx.encode_shared(code, bg)
    rows[~present] = 0.0
    rows[2] = float("nan")  # an absent row's payload never reaches the sum
    w, wide = None, rows
    if wire != "f32":
        w = (wire, numerics.narrow_wire_rows(rows, wire, block), block)
        wide = numerics.widen_wire_rows(w[1], wire, block)
    parts = {f"S={k}": numerics.wire_segment_bounds(D, k, block)
             for k in (1, 2, 3)}
    parts["leaflike"] = LEAFLIKE  # the offset entry takes any cut
    for label, bounds in parts.items():
        dec, v, health = approx.decode_segments(
            code, rows if w is None else None, bg, bounds, present, wire=w)
        jdec, jv, jhealth = japprox.decode_segments(
            jcode, jnp.asarray(wide.numpy()), bounds,
            present=jnp.asarray(present.numpy()), with_health=True,
            batch_grads=jnp.asarray(bg.numpy()), impl="fused")
        what = f"approx {wire}@{block} {label}"
        assert bool(torch.isfinite(dec).all()), what
        np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), rtol=RTOL,
                                   atol=ATOL, err_msg=what)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-5)
        np.testing.assert_allclose(float(health["residual"]),
                                   float(jhealth["residual"]), rtol=RTOL,
                                   atol=ATOL, err_msg=what)
        np.testing.assert_allclose(float(health["bound"]),
                                   float(jhealth["bound"]), atol=1e-5)
        # the unsegmented decode, on the same rows
        whole, _, hw = approx.decode(code, rows if w is None else None, bg,
                                     present, wire=w)
        np.testing.assert_allclose(dec.numpy(), whole.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=what)
        np.testing.assert_allclose(float(health["residual"]),
                                   float(hw["residual"]), rtol=RTOL)


# --------------------------------------------------------------------------
# the segment entries and views
# --------------------------------------------------------------------------

def test_encode_segment_is_the_encode_of_the_columns():
    rng = np.random.RandomState(4)
    bg = rng.normal(size=(N, 5003)).astype(np.float32)
    code = cyclic.build_cyclic_code(N, S_FAIL)
    full = cyclic.encode_shared(code, torch.from_numpy(bg))
    ref = jcyclic.encode_segment(jcyclic.build_cyclic_code(N, S_FAIL),
                                 jnp.asarray(bg), 10, 4107)
    seg = cyclic.encode_segment(code, torch.from_numpy(bg), 10, 4107)
    for ours, whole, theirs in zip(seg, full, ref):
        assert ours.shape == (N, 4097)
        np.testing.assert_allclose(ours.numpy(), whole[:, 10:4107].numpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   rtol=1e-5, atol=1e-5)


def test_wire_views_equal_the_reference():
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.normal(size=(N, 5003)).astype(np.float32))
    for mode, block in (("bf16", 256), ("int8", 256), ("int8", 24)):
        buf = numerics.narrow_wire_rows(x, mode, block)
        jbuf = {k: jnp.asarray(v.float().numpy() if v.dtype == torch.bfloat16
                               else v.numpy()) for k, v in buf.items()}
        for a, b in ((0, 5003), (block * 3, 4000), (block, 5003)):
            ours = decode_kernels.wire_slice_pair((mode, buf, buf, block), a,
                                                  b)
            theirs = jdk.wire_slice_pair((mode, jbuf, jbuf, block), a, b)
            for k in buf:
                np.testing.assert_array_equal(ours[1][k].float().numpy(),
                                              np.asarray(theirs[1][k]))
            single = decode_kernels.wire_slice_single((mode, buf, block), a, b)
            assert torch.equal(single[1]["q"], buf["q"][:, a:b])
            # the widened columns of any cut, the whole rows' slice
            np.testing.assert_array_equal(
                numerics.widen_wire_cols(buf, mode, block, a + 7, b).numpy(),
                numerics.widen_wire_rows(buf, mode, block)[:, a + 7:b]
                .numpy())
        if mode == "int8":
            with pytest.raises(ValueError, match="not aligned"):
                decode_kernels.wire_slice_pair((mode, buf, buf, block), 7,
                                               100)
    assert decode_kernels.wire_slice_pair(None, 0, 1) is None


def test_segment_entries_are_slices_of_the_whole():
    """The plain segment entries, bit for bit the slices of the whole-row
    plain versions on the CPU: the narrow recombination of one segment and
    the approx decode's offset entry (its decoded columns; its sums those
    of the slice)."""
    rng = np.random.RandomState(6)
    d = 5003
    r = torch.from_numpy(rng.normal(size=(2, N, d)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, N)).astype(np.float32))
    bg = torch.from_numpy(rng.normal(size=(N, d)).astype(np.float32))
    pres = torch.ones(N)
    pres[3] = 0.0
    for mode, block in (("bf16", 256), ("int8", 256), ("int8", 24)):
        wire = (mode, numerics.narrow_wire_rows(r[0], mode, block),
                numerics.narrow_wire_rows(r[1], mode, block), block)
        whole = decode_kernels.cyclic_narrow_recombine_plain(v[0], v[1], wire)
        for a, b in ((0, d), (10, 4107), (4107, d)):
            seg = decode_kernels.cyclic_narrow_recombine_segment(
                v[0], v[1], wire, a, b)
            np.testing.assert_allclose(seg.numpy(), whole[a:b].numpy(),
                                       rtol=1e-6, atol=1e-6)
        single = (mode, wire[1], block)
        out = torch.full((d,), float("nan"))
        for a, b in ((0, 10), (10, 4107), (4107, d)):
            dec, sd, sg = decode_kernels.approx_decode_segment(
                None, bg, v[0], pres, a, b, single, out)
            ref = decode_kernels.approx_decode_plain(
                numerics.widen_wire_rows(wire[1], mode, block)[:, a:b],
                bg[:, a:b], v[0], pres)
            assert torch.equal(dec, ref[0])
            np.testing.assert_allclose([float(sd), float(sg)],
                                       [float(ref[1]), float(ref[2])],
                                       rtol=1e-6)
        assert bool(torch.isfinite(out).all())
