"""The port's numerics observatory (``draco_tpu_torch/obs/numerics.py``,
``ops/numerics.py``) against the JAX package's (``draco_tpu/obs/
numerics.py``), inputs from numpy seeds:

  * ``stage_columns`` (the ``stage_stats`` plain version) on rows holding
    zeros, subnormals, values near and past bfloat16's largest, ±Inf, NaN
    and values at and just under each exponent edge, one and two parts, at
    blocks 1, 7, 256 and past d. Two rules of XLA on the CPU shape the
    comparison. It treats f32 subnormals as zero (denormals-are-zero), so
    the reference is held to the port on the same rows with the
    subnormals zeroed, and the port's own subnormal counts to an exact
    numpy oracle; and its f32 ``log2`` can round a value a few ulps under
    2^k up to k, so an exponent bin may differ from the reference's by at
    most the elements within 4 ulps under an edge (the port bins by the
    exponent bits). Every other count column is exact; rms within 1e-6 of
    the reference's f32 sum and of an f64 oracle;
  * ``wire_ledger`` equal to the reference's dict for the flat, segmented
    and tree wires of every family;
  * ``quantize_rows`` bit for bit the reference's, bf16 and int8, rounded
    to nearest and stochastically (the shadow's draws at seed + 11 from
    ``round_draw``, the imaginary half's from ``fold_in(key, 1)``);
  * ``shadow_columns`` as the reference's (err and agreement to 1e-6, the
    detection counts exact, a NaN comparison at the sentinel);
  * the metric schema (``metric_family_names``, the LM's
    ``token_metric_names``) the reference's, and the config rules of
    ``numerics_watch`` / ``shadow_wire`` refusing what it refuses.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from draco_tpu.config import TrainConfig as JaxConfig
from draco_tpu.obs import numerics as ref
from draco_tpu.parallel import common as ref_common
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.obs import numerics as port
from draco_tpu_torch.ops import draws
from draco_tpu_torch.parallel import common as port_common

SEED = 428
EDGES = (-32, -16, -8, 0, 8)
BINS = tuple(f"exp{i}" for i in range(6))


def planted(rows: int, d: int, seed: int, huge: bool = False) -> np.ndarray:
    """Normal values over 2^-150 .. 2^20 with the edge cases planted."""
    rs = np.random.RandomState(seed)
    x = (rs.randn(rows, d) * np.exp2(rs.randint(-150, 21, (rows, d)))
         ).astype(np.float32)
    picks = [0.0, -0.0, 2.0 ** -140, -(2.0 ** -134), 2.0 ** -130,
             2.0 ** -126]
    if huge:  # values whose square overflows f32: Σ x² is inf
        picks += [3.3e38, 3.3895313892515355e38, 3.4e38, -3.4e38]
    for k in EDGES:
        e = np.float32(2.0 ** k)
        picks += [e, np.nextafter(e, np.float32(0)),
                  -np.nextafter(e, np.float32(0))]
    for r in range(rows):
        at = rs.choice(d, len(picks) + 2, replace=False)
        x[r, at[:len(picks)]] = picks
        if r % 3 == 1:
            x[r, at[-2]] = np.nan
        if r % 3 == 2:
            x[r, at[-1]] = np.inf if r % 2 else -np.inf
    return x


def flushed(x: np.ndarray) -> np.ndarray:
    """``x`` with its subnormals zeroed, as XLA's CPU arithmetic sees it."""
    y = x.copy()
    y[(np.abs(y) < 2.0 ** -126) & (y != 0)] = 0.0
    return y


def near_edge(parts) -> int:
    """Elements within 4 ulps under an exponent edge."""
    n = 0
    for x in parts:
        a = np.abs(x[np.isfinite(x)]).astype(np.float64)
        for k in EDGES:
            e = 2.0 ** k
            n += int(((a < e) & (a >= e * (1 - 4 * 2.0 ** -24))).sum())
    return n


def oracle(parts, block: int) -> dict:
    """The twelve columns from numpy, counts exact, Σ x² in f64."""
    total = sum(x.size for x in parts)
    c = dict.fromkeys(("fin", "uf_bf16", "of_bf16", "uf_int8") + BINS, 0)
    s, m, over = 0.0, 0.0, False
    for x in parts:
        x = x.reshape(-1, x.shape[-1])
        a = np.abs(x.astype(np.float64))
        fin = np.isfinite(x)
        af = np.where(fin, a, 0.0)
        nz = fin & (af > 0)
        c["fin"] += int(fin.sum())
        # an f32 square past f32's range makes the f32 Σ x² inf
        with np.errstate(over="ignore"):
            over |= bool(np.isinf(np.square(x[fin])).any())
        s += float((np.where(fin, x.astype(np.float64), 0) ** 2).sum())
        m = max(m, float(af.max()))
        c["uf_bf16"] += int((nz & (af < 2.0 ** -133)).sum())
        c["of_bf16"] += int((fin & (af > 3.3895313892515355e38)).sum())
        d = x.shape[-1]
        for lo in range(0, d, block):
            blk = af[:, lo:lo + block]
            thr = (blk.max(axis=1, keepdims=True).astype(np.float32)
                   / np.float32(254.0))
            c["uf_int8"] += int(((blk > 0) & (blk < thr)).sum())
        e = np.floor(np.log2(np.where(nz, af, 1.0)))
        b = np.searchsorted(EDGES, e, side="right")
        for i in range(6):
            c[f"exp{i}"] += int((nz & (b == i)).sum())
    cols = {"absmax": m,
            "rms": np.inf if over else np.sqrt(s / max(c["fin"], 1)),
            "nonfinite": (total - c["fin"]) / total}
    for k in ("uf_bf16", "of_bf16", "uf_int8") + BINS:
        cols[k] = c[k] / total
    return cols


def columns(stage_cols: dict) -> dict:
    return {k.split("_", 2)[2]: float(v) for k, v in stage_cols.items()}


CASES = [(parts, block) for parts in (1, 2) for block in (1, 7, 256, 5000)]


@pytest.mark.parametrize("parts,block", CASES)
def test_stage_columns_against_the_reference(parts, block):
    xs = [planted(3, 600, SEED + 10 * parts + i, huge=block == 7)
          for i in range(parts)]
    mine = columns(port.stage_columns(
        "wire", [torch.from_numpy(flushed(x)) for x in xs], block))
    theirs = columns(ref.stage_columns(
        "wire", [jnp.asarray(x) for x in xs], block))
    assert list(mine) == list(theirs) == list(port.STAT_NAMES)
    total = sum(x.size for x in xs)
    edge = near_edge(xs)
    assert edge > 0  # the planted edge values are there
    diffs = [round(abs(mine[b] - theirs[b]) * total) for b in BINS]
    assert all(d <= edge for d in diffs) and sum(diffs) <= 2 * edge, diffs
    for k in ("absmax", "uf_bf16", "uf_int8", "of_bf16", "nonfinite"):
        assert mine[k] == theirs[k], k
    assert mine["rms"] == pytest.approx(theirs["rms"], rel=1e-6)


@pytest.mark.parametrize("parts,block", CASES)
def test_stage_columns_against_the_oracle(parts, block):
    xs = [planted(3, 600, SEED + 20 * parts + i, huge=block == 256)
          for i in range(parts)]
    mine = columns(port.stage_columns(
        "grad", [torch.from_numpy(x) for x in xs], block))
    want = oracle(xs, block)
    assert mine["uf_bf16"] > 0  # the subnormals below 2^-133 counted
    for k in port.STAT_NAMES:
        if k == "rms":
            assert mine[k] == pytest.approx(want[k], rel=1e-6)
            assert np.isinf(want[k]) == (block == 256)
        elif k in ("absmax",):
            assert mine[k] == np.float32(want[k])
        else:
            assert mine[k] == np.float32(want[k]), k


def test_stage_columns_overflowing_squares_and_empty_finite():
    # a square past f32's range: Σ x² and rms are inf in both packages
    x = planted(2, 300, SEED, huge=True)
    mine = columns(port.stage_columns("agg", [torch.from_numpy(flushed(x))],
                                      64))
    theirs = columns(ref.stage_columns("agg", [jnp.asarray(x)], 64))
    assert np.isinf(mine["rms"]) and np.isinf(theirs["rms"])
    assert mine["of_bf16"] == theirs["of_bf16"] > 0
    # no finite element: absmax 0, rms 0, nonfinite 1
    y = np.full((2, 5), np.nan, np.float32)
    mine = columns(port.stage_columns("agg", [torch.from_numpy(y)], 4))
    theirs = columns(ref.stage_columns("agg", [jnp.asarray(y)], 4))
    assert mine == theirs
    assert mine["nonfinite"] == 1.0 and mine["absmax"] == 0.0


def test_numerics_columns_order():
    cfg = TrainConfig(approach="cyclic", numerics_watch="on", shadow_block=7)
    g = torch.randn(4, 50)
    cols = port.numerics_columns(cfg, [g], [g, -g], g[0])
    assert tuple(cols) == port.numerics_metric_names()
    assert tuple(cols) == ref.numerics_metric_names()


LEDGERS = [
    dict(approach="cyclic", num_workers=8, worker_fail=1),
    dict(approach="cyclic", num_workers=8, worker_fail=1, wire_dtype="bf16"),
    dict(approach="cyclic", num_workers=8, worker_fail=1, wire_dtype="int8",
         wire_segments=4),
    dict(approach="approx", num_workers=8, wire_dtype="int8", shadow_block=7,
         wire_segments=3),
    dict(approach="maj_vote", num_workers=9, group_size=3,
         shadow_wire="int8"),
    dict(approach="cyclic", redundancy="shared", num_workers=16,
         worker_fail=1, topology="tree", tree_fanout=8),
    dict(approach="approx", redundancy="shared", num_workers=9,
         topology="tree", tree_fanout=3, wire_dtype="int8"),
]


@pytest.mark.parametrize("fields", LEDGERS)
def test_wire_ledger_as_the_reference(fields):
    for dim in (11_173_962, 5003):
        mine = port.wire_ledger(TrainConfig(**fields), dim)
        theirs = ref.wire_ledger(JaxConfig(**fields), dim)
        assert mine == theirs


def _ref_key(cfg_fields: dict, step: int):
    return ref.shadow_step_key(JaxConfig(**cfg_fields), jnp.int32(step))


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
def test_quantize_rows_bit_for_bit(mode, rounding):
    rs = np.random.RandomState(SEED)
    x = (rs.randn(5, 777) * np.exp2(rs.randint(-20, 20, (5, 777)))
         ).astype(np.float32)
    x[1, 3] = np.nan
    x[2, 9] = np.inf
    fields = dict(approach="cyclic", shadow_wire=mode, shadow_round=rounding,
                  seed=SEED)
    step = 6
    block = 7 if mode == "int8" else 256
    cfg = TrainConfig(**fields)
    r = port.shadow_draws(cfg, torch.tensor(step, dtype=torch.int32),
                          x.shape[-1], 2)
    key = _ref_key(fields, step)
    for part in (0, 1):
        k = None if key is None else (key if part == 0
                                      else jax.random.fold_in(key, 1))
        mine = port.quantize_rows(torch.from_numpy(x), mode, block,
                                  None if r is None else r[part]).numpy()
        theirs = np.asarray(ref.quantize_rows(jnp.asarray(x), mode, block,
                                              k))
        fin = ~np.isnan(theirs)
        assert np.array_equal(np.isnan(mine), ~fin)
        assert np.array_equal(mine[fin].view(np.uint32),
                              theirs[fin].view(np.uint32))


def test_shadow_columns_as_the_reference():
    rs = np.random.RandomState(SEED)
    n, d = 9, 400
    agg = rs.randn(d).astype(np.float32)
    sagg = (agg + 1e-3 * rs.randn(d)).astype(np.float32)
    flags, sflags, adv, present = (rs.rand(4, n) < 0.4)
    for pres in (present, None):
        for shadow, resid in ((sagg, 0.02), (np.full(d, np.nan, np.float32),
                                             np.nan)):
            mine = port.shadow_columns(
                torch.from_numpy(agg), torch.from_numpy(shadow),
                torch.tensor(resid, dtype=torch.float32),
                torch.from_numpy(flags), torch.from_numpy(sflags),
                torch.from_numpy(adv),
                None if pres is None else torch.from_numpy(pres))
            theirs = ref.shadow_columns(
                jnp.asarray(agg), jnp.asarray(shadow), jnp.float32(resid),
                jnp.asarray(flags), jnp.asarray(sflags), jnp.asarray(adv),
                None if pres is None else jnp.asarray(pres))
            assert list(mine) == list(theirs) == list(port.SHADOW_NAMES)
            for k in port.SHADOW_NAMES:
                assert float(mine[k]) == pytest.approx(float(theirs[k]),
                                                       rel=1e-6), k
            if np.isnan(resid):
                assert float(mine["shadow_err"]) == port.SHADOW_SENTINEL
                assert float(mine["shadow_residual"]) == port.SHADOW_SENTINEL


SCHEMAS = [
    dict(approach="baseline"),
    dict(approach="cyclic", num_workers=8, worker_fail=1),
    dict(approach="cyclic", num_workers=40, worker_fail=1,
         numerics_watch="on"),
    dict(approach="cyclic", num_workers=8, worker_fail=1,
         numerics_watch="on", shadow_wire="bf16"),
    dict(approach="approx", redundancy="shared", num_workers=8,
         shadow_wire="int8"),
    dict(approach="maj_vote", num_workers=9, group_size=3,
         numerics_watch="on", shadow_wire="int8"),
]


@pytest.mark.parametrize("fields", SCHEMAS)
def test_metric_schema_as_the_reference(fields):
    mine, theirs = TrainConfig(**fields), JaxConfig(**fields)
    assert (port_common.metric_family_names(mine)
            == ref_common.metric_family_names(theirs))
    assert (port_common.token_metric_names(mine)
            == ref_common.token_metric_names(theirs))
    assert port.watch_metric_names(mine) == ref.watch_metric_names(theirs)
    assert port.watch_enabled(mine) == ref.watch_enabled(theirs)


RULES = [
    (dict(numerics_watch="yes", approach="cyclic"), True),
    (dict(shadow_wire="fp8", approach="cyclic"), True),
    (dict(shadow_wire="bf16", approach="cyclic", wire_dtype="int8"), True),
    (dict(numerics_watch="on", approach="baseline"), True),
    (dict(shadow_wire="int8", approach="baseline"), True),
    (dict(shadow_wire="bf16", approach="cyclic", redundancy="shared",
          num_workers=16, topology="tree", tree_fanout=8), True),
    (dict(numerics_watch="on", approach="cyclic", redundancy="shared",
          num_workers=16, topology="tree", tree_fanout=8), False),
    (dict(numerics_watch="on", shadow_wire="int8", approach="cyclic",
          shadow_round="stochastic"), False),
    (dict(numerics_watch="on", approach="cyclic", wire_dtype="bf16"), False),
    (dict(shadow_wire="int8", approach="maj_vote", num_workers=9,
          group_size=3), False),
    (dict(shadow_wire="bf16", approach="approx", redundancy="shared",
          worker_fail=0), False),
    (dict(job_name="nightly-7", approach="cyclic"), False),
]


@pytest.mark.parametrize("fields,raises", RULES)
def test_watch_rules_match_the_reference(fields, raises):
    def outcome(cls):
        try:
            cls(**{"num_workers": 8, "worker_fail": 1, **fields}).validate()
        except ValueError as e:
            return str(e)
        return None

    assert (outcome(JaxConfig) is not None) == raises
    assert (outcome(TrainConfig) is not None) == raises


def test_the_shadow_draws_are_the_shadows_stream():
    """The shadow draws at seed + 11, the real wire at seed + 17: two
    streams."""
    cfg = TrainConfig(approach="cyclic", shadow_wire="bf16",
                      shadow_round="stochastic", seed=SEED)
    step = torch.tensor(3, dtype=torch.int32)
    mine = port.shadow_draws(cfg, step, 64, 1)
    assert torch.equal(mine, draws.round_draw(step, SEED + 11, 64, "bf16"))
    assert not torch.equal(mine, draws.round_draw(step, SEED + 17, 64,
                                                  "bf16"))
    assert port.shadow_draws(dataclasses.replace(
        cfg, shadow_round="nearest"), step, 64, 1) is None
