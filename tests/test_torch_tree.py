"""The tree topology (``topology="tree"``, ``coding/topology.py``) against
the JAX package's (``draco_tpu/coding/topology.py``).

  * the plan algebra and the ledger block equal the reference's, and so do
    their refusals;
  * ``TrainConfig.validate`` accepts and refuses the same tree
    configurations as the reference's;
  * ``encode_tree`` at n=16 in two groups of 8 (s_g = 1): the codewords
    within 1e-6 relative of the reference's (a block-diagonal product
    against its product a group); ``decode_tree_cyclic`` on the
    reference's codewords, with a rev_grad adversary on row 11 and one on
    row 3, with rows 9 and 1 dropped as stragglers, with an adversary on
    row 3 and row 9 dropped, and the two adversaries on the int8 wire and
    on 2 wire segments — a fault in each group: a clean group's locator
    excludes two rows that f32 noise picks, in either package — the
    flagged rows and the honest set exactly equal, the aggregate within
    2e-4 relative (atol 1e-6 of its scale) — the reference's per-group
    decode (its fused locator formulation, ``impl="fused"``, whose body
    the port's plain version is) and the port's one launch a stage sum in
    other orders;
  * the approx tree's decode as the step runs it (``common.host_solve``,
    then ``common.approx_aggregate``) against the reference's
    ``decode_tree_approx`` at n=9 in three groups of 3 with rows 2 and 7
    absent: the decoded mean within 2e-4, the residual within 1e-3
    relative, the bound and the recovered fraction within 1e-5 (host
    solves on both sides);
  * the CNN and LM tree steps against the reference's:
    ``test_torch_tree_step.py``;
  * the tree's K=3 and K=1 chunks bit for bit its eager steps (LeNet).

The CPU program lint (``analysis/rules.py``) of the int8 tree and the vote
on the stochastic bf16 wire (``shared_int8_tree_g8``, ``majvote_bf16_sr``)
is held here as ``test_torch_audit.py`` holds the other legs: in a file of
many tests, which xdist's loadfile schedules early (it orders files by their
count of tests).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_chunk import assert_chunk_equals_eager

from draco_tpu import attacks as jattacks
from draco_tpu import rng as jrng
from draco_tpu.coding import topology as jtopo
from draco_tpu.config import TrainConfig as JaxConfig
from draco_tpu.obs import numerics as jnumerics
from draco_tpu_torch.coding import topology
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.data import datasets
from draco_tpu_torch.obs import numerics
from draco_tpu_torch.parallel import common
from draco_tpu_torch.training.trainer import Trainer
from test_torch_audit import TREE_LEGS, assert_green, lint_rows_of

torch.set_num_threads(1)

SEED = 428
T = torch.from_numpy
BASE = dict(network="LeNet", dataset="synthetic-mnist", lr=0.01,
            momentum=0.9, err_mode="rev_grad", batch_size=2, max_steps=3,
            train_dir="", seed=SEED)
TREE = dict(BASE, approach="cyclic", redundancy="shared", num_workers=16,
            worker_fail=1, topology="tree", tree_fanout=8)
APPROX_TREE = dict(BASE, approach="approx", redundancy="shared",
                   num_workers=9, worker_fail=0, code_redundancy=1.5,
                   assignment_scheme="pairwise", straggle_mode="drop",
                   straggle_count=2, topology="tree", tree_fanout=3)


# --------------------------------------------------------------------------
# plan algebra, ledger, validate
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,g,levels", [
    (8, 4, 0), (32, 4, 0), (32, 4, 4), (32, 2, 2), (10, 4, 0), (8, 8, 0),
    (8, 1, 0), (16, 8, 0), (9, 3, 0), (27, 3, 0), (64, 4, 3), (64, 4, 1)])
def test_plan_and_ledger_are_the_references(n, g, levels):
    try:
        want = jtopo.tree_plan(n, g, levels)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split("(")[0][:30]):
            topology.tree_plan(n, g, levels)
        return
    got = topology.tree_plan(n, g, levels)
    assert dataclass_fields(got) == dataclass_fields(want)
    assert got.level_widths == want.level_widths
    assert topology.auto_levels(n, g) == jtopo.auto_levels(n, g)
    assert topology.tree_ledger_block(n, g, levels, 1003, 12) == \
        jtopo.tree_ledger_block(n, g, levels, 1003, 12)
    for s in range(4):
        assert topology.group_worker_fail(g, s) == \
            jtopo.group_worker_fail(g, s)
    parts = np.random.RandomState(n).normal(size=(got.num_groups, 7)).astype(
        np.float32)
    np.testing.assert_allclose(
        topology.combine_partials(got, T(parts)).numpy(),
        np.asarray(jtopo.combine_partials(want, jnp.asarray(parts))),
        rtol=1e-6, atol=1e-7)


def dataclass_fields(p):
    return (p.n, p.fanout, p.levels, p.num_groups, p.level_fanouts,
            p.group_slices)


@pytest.mark.parametrize("override", [
    {}, {"tree_fanout": 4}, {"tree_fanout": 4, "adversary_count": 0},
    {"num_workers": 10, "tree_fanout": 4}, {"tree_fanout": 16},
    {"tree_fanout": 1}, {"redundancy": "simulate"},
    {"decode_granularity": "layer"}, {"approach": "baseline"},
    {"approach": "maj_vote", "group_size": 4}, {"topology": "ring"},
    {"num_workers": 32, "tree_fanout": 2, "tree_levels": 2,
     "adversary_count": 0},
    {"num_workers": 32, "tree_fanout": 8, "tree_levels": 3},
    {"wire_dtype": "int8"}, {"wire_dtype": "bf16", "wire_segments": 2},
    {"straggle_mode": "drop", "straggle_count": 1},
    {"straggle_mode": "drop", "straggle_count": 2, "adversary_count": 0},
    {"straggle_mode": "drop", "straggle_count": 3, "adversary_count": 0},
    {"worker_fail": 2, "adversary_count": 2},
    dict(APPROX_TREE, network="LeNet"),
    dict(APPROX_TREE, tree_fanout=4),
    dict(APPROX_TREE, worker_fail=1),
])
def test_validate_accepts_and_refuses_as_the_reference(override):
    kw = dict(TREE, **override)
    try:
        JaxConfig(**kw).validate()
        refused = None
    except ValueError as e:
        refused = str(e)
    if refused is None:
        cfg = TrainConfig(**kw).validate()
        assert cfg.tree_group_fail == JaxConfig(**kw).tree_group_fail
    else:
        with pytest.raises(ValueError):
            TrainConfig(**kw).validate()


# --------------------------------------------------------------------------
# the codes
# --------------------------------------------------------------------------

D = 4099


def _grads(n, seed=3):
    return np.random.RandomState(seed).normal(size=(n, D)).astype(
        np.float32) * 0.1


@pytest.mark.parametrize("case", ["adversary", "straggler", "both", "int8",
                                  "segments"])
def test_cyclic_tree_against_the_reference(case):
    over = {"int8": {"wire_dtype": "int8"},
            "segments": {"wire_segments": 2, "shadow_block": 64}}.get(case,
                                                                     {})
    kw = dict(TREE, **over)
    jcfg, cfg = JaxConfig(**kw), TrainConfig(**kw)
    jt, pt = jtopo.build_tree_code(jcfg), topology.build_tree_code(cfg)
    grads = _grads(16)
    jre, jim = jtopo.encode_tree(jt, jnp.asarray(grads))
    pre, pim = topology.encode_tree(pt, T(grads))
    for a, b in ((pre, jre), (pim, jim)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    adv = {"straggler": (), "both": (3,)}.get(case, (3, 11))
    absent = {"straggler": (1, 9), "both": (9,)}.get(case, ())
    mask = np.zeros(16, bool)
    mask[list(adv)] = True
    jre, jim = jattacks.inject_cyclic(jre, jim, jnp.asarray(mask),
                                      "rev_grad")
    present = None
    if absent:
        present = np.ones(16, bool)
        present[list(absent)] = False
        jre, jim = (jre * jnp.asarray(present)[:, None],
                    jim * jnp.asarray(present)[:, None])
    f = np.asarray(jrng.random_projection_factors_in_graph(SEED, D))
    jwire, pwire = None, None
    re_, im_ = np.asarray(jre), np.asarray(jim)
    if case == "int8":
        jre, jim, jwire = jnumerics.narrow_wire_pair(jcfg, jre, jim)
        pre_w, pim_w, pwire = numerics.narrow_wire_pair(cfg, T(re_),
                                                        T(im_))
        re_, im_ = pre_w.numpy(), pim_w.numpy()
    jtol, jlam = jnumerics.wire_decode_params(jcfg, n=8, s=1)
    rel_tol, lam = common.cyclic_wire_params(cfg, pt)
    assert lam == jlam
    jbounds = (jnumerics.cfg_segment_bounds(jcfg, D)
               if case == "segments" else None)
    bounds = (list(numerics.cfg_segment_bounds(cfg, D))
              if case == "segments" else None)
    assert bounds == (None if jbounds is None else list(jbounds))
    # the reference's fused locator formulation, the port's plain version
    # (a clean group's honest set is decided by f32 noise)
    # (jitted: the reference's step runs it so, and op by op it compiles
    # for seconds on the CPU)
    jdec, jhon, jh = jax.jit(lambda a, b, c: jtopo.decode_tree_cyclic(
        jt, a, b, c,
        present=None if present is None else jnp.asarray(present),
        rel_tol=jtol, impl="fused", lam=jlam, wire=jwire,
        bounds=jbounds))(jre, jim, jnp.asarray(f))
    dec, hon, h = topology.decode_tree_cyclic(
        pt, T(re_), T(im_), T(f),
        present=None if present is None else T(present), rel_tol=rel_tol,
        lam=lam, wire=pwire, bounds=bounds)
    np.testing.assert_array_equal(hon.numpy(), np.asarray(jhon))
    np.testing.assert_array_equal(h["flagged"].numpy(),
                                  np.asarray(jh["flagged"]))
    np.testing.assert_array_equal(h["loud"].numpy(), np.asarray(jh["loud"]))
    jdec = np.asarray(jdec)
    np.testing.assert_allclose(dec.numpy(), jdec, rtol=2e-4,
                               atol=1e-6 * np.abs(jdec).max())
    assert h["flagged"].nonzero().flatten().tolist() == list(adv)
    for row in absent:
        assert not h["flagged"][row] and not hon[row]


def test_approx_tree_against_the_reference():
    jcfg, cfg = JaxConfig(**APPROX_TREE), TrainConfig(**APPROX_TREE)
    jt, pt = jtopo.build_tree_code(jcfg), topology.build_tree_code(cfg)
    grads = _grads(9, seed=4)
    jrows = jtopo.encode_tree(jt, jnp.asarray(grads))
    rows = topology.encode_tree(pt, T(grads))
    np.testing.assert_allclose(rows.numpy(), np.asarray(jrows), rtol=1e-6,
                               atol=1e-7)
    present = np.ones(9, bool)
    present[[2, 7]] = False
    jrows = jnp.where(jnp.asarray(present)[:, None], jrows, 0.0)
    jdec, jv, jh = jtopo.decode_tree_approx(
        jt, jrows, present=jnp.asarray(present), batch_grads=jnp.asarray(
            grads))
    # the step's own decode: the host solve, then the device aggregation
    v, vn_pres, h = common.host_solve(pt, T(present))
    dec, ah = common.approx_aggregate(pt, T(grads), vn_pres, masked=True)
    h["residual"] = ah["residual"]
    np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), rtol=2e-4,
                               atol=1e-6 * np.abs(np.asarray(jdec)).max())
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-6)
    assert float(h["residual"]) == pytest.approx(float(jh["residual"]),
                                                 rel=1e-3)
    assert float(h["bound"]) == pytest.approx(float(jh["bound"]), rel=1e-5)
    assert float(h["recovered_fraction"]) == pytest.approx(
        float(jh["recovered_fraction"]), rel=1e-5)
    assert float(h["residual"]) <= float(h["bound"]) + 1e-6


# --------------------------------------------------------------------------
# the chunks
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mnist():
    return datasets.load_dataset("synthetic-mnist", synthetic_train=256,
                                 synthetic_test=8)


@pytest.mark.parametrize("kw", [dict(TREE, wire_dtype="int8"), APPROX_TREE],
                         ids=["cyclic_int8", "approx"])
def test_tree_chunks_are_the_eager_steps(mnist, kw):
    def build():
        cfg = TrainConfig(**dict(kw, max_steps=7, steps_per_call=3))
        tr = Trainer(cfg, device="cpu", dataset=mnist, quiet=True)
        return tr.setup, tr

    def chunk_of(tr, rng_):
        client = tr.chunk_client(rng_[0], rng_[0] + rng_[1] - 1)
        try:
            return client.assemble(0, [rng_])
        finally:
            client.cleanup()

    assert_chunk_equals_eager(build, chunk_of)


# --------------------------------------------------------------------------
# the CPU program lint of these legs (test_torch_audit.py's rule)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lint_rows():
    return lint_rows_of(TREE_LEGS)


@pytest.mark.parametrize("leg", TREE_LEGS)
def test_every_leg_green_on_the_cpu_rules(lint_rows, leg):
    assert_green(lint_rows[leg], leg)
