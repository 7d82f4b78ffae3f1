"""The port's GPipe pipeline step (``parallel/pp_step.py``, the stage axis
a tensor axis) against the JAX package's (``draco_tpu.parallel.pp_step``)
on ``make_mesh_wpp(4, 2)`` (n=8 worker lanes, two stages, batch 2 per
worker) and ``make_mesh_wpp(2, 4)`` (four stages), and against the port's
own sequential stack.

* The pipeline tree's initial parameters (``embed``, ``blocks.loop.b.*``,
  ``final_ln``, drawn from ``split(key(seed), 3)`` through the scan named
  ``loop``): the port's own draw against
  ``build_pp_train_setup(...).state.params``, leaf for leaf within
  1e-6·σ (σ the initialiser's scale), scales exact.
* ``per_worker_loss`` and ``per_worker_grads`` at S=2, M ∈ {1, 2} and at
  S=4 against the reference's: losses to 1e-5 relative, gradients to 1e-5
  of their scale (the schedule only reorders float32 sums); against the
  port's own scanned LM on the same parameters (renamed ``blocks.loop.b.*``
  -> ``blocks.*``, the reference's own oracle, tests/test_parallel_pp.py)
  to the same bounds; M=1 and M=2 to the same bounds (microbatch
  invariance); ``remat`` under the stage vmap (the flash kernels' plain
  versions and ``_Remat``'s generated vmap rule nested in the lanes'
  vmap) bit for bit the gradients without it.
* Two eager steps against the reference's on cyclic ``shared`` and on the
  approx code (the LM step's tolerances: the decode columns equal, the
  loss to 1e-4 relative, the update to 1e-2 in relative L2, the
  parameters to 1e-4 of their scale), the port from the reference's
  parameters and, before step 2, its momentum.
* ``redundancy="simulate"`` warns as the reference does and runs
  ``shared``.
* A resume through a ``.dcg``: the port's own checkpoint resumes bit for
  bit its uninterrupted run; a checkpoint either package wrote reads in
  the other leaf for leaf bit for bit; a pipeline checkpoint and a
  scanned LM's are refused across each other.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from draco_tpu.config import TrainConfig as JaxConfig
from draco_tpu.parallel.mesh import make_mesh_wpp
from draco_tpu.parallel.pp_step import build_pp_train_setup as jax_pp
from draco_tpu.utils import checkpoint as jckpt
from draco_tpu_torch import params as params_mod
from draco_tpu_torch import rng
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.parallel import pp_step
from draco_tpu_torch.parallel.sp_step import (build_sp_train_setup,
                                              synthetic_text, train_sp)
from draco_tpu_torch.utils import checkpoint as ckpt
from test_torch_tp_step import LM, SEED, held, two_steps

torch.set_num_threads(1)

PP = dict(LM, pipeline_shards=2, pp_microbatches=2)
APPROX = dict(approach="approx", redundancy="shared", worker_fail=0,
              code_redundancy=1.5, assignment_scheme="pairwise")
PREFIX = "blocks.loop.b."


def _scale(name: str, leaf: np.ndarray) -> float:
    """The initialiser's scale of a leaf in the Flax layout (stacked leaves
    per layer)."""
    if name.endswith("embedding"):
        return float(np.sqrt(1.0 / leaf.shape[-1]))
    fan = leaf.shape[1:-1] if name.startswith("blocks") else leaf.shape[:-1]
    return float(np.sqrt(1.0 / np.prod(fan)) / 0.87962566103423978)


def _walk(tree, path=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield "/".join(path + (k,)), np.asarray(v)


def _toks(kw, step=1):
    return synthetic_text(SEED, step, kw["num_workers"], kw["batch_size"],
                          kw["seq_len"], kw["vocab"])


def _pair(kw, mesh):
    """The reference's pp setup on ``mesh`` and the port's from its
    parameters."""
    jset = jax_pp(JaxConfig(eval_freq=0, **kw), mesh)
    init, _ = params_mod.from_jax(jax.device_get(jset.state.params))
    return jset, pp_step.build_pp_train_setup(TrainConfig(**kw), "cpu",
                                              init=init)


def _grads(setup, toks):
    g, loss = setup.per_worker_grads(setup.state.params,
                                     torch.as_tensor(toks).long())
    return g.numpy(), loss.numpy()


def _close(a, b, scale_of=None):
    scale = np.abs(b if scale_of is None else scale_of).max()
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * scale)


def test_pipeline_draws_are_the_references():
    kw = dict(PP, model_layers=4)
    jset = jax_pp(JaxConfig(eval_freq=0, **kw), make_mesh_wpp(4, 2))
    want = dict(_walk(jax.device_get(jset.state.params)))
    setup = pp_step.build_pp_train_setup(TrainConfig(**kw), "cpu")
    got = [x.read() for x in params_mod.tensor_leaves(setup.state.params,
                                                      setup.layout)]
    assert len(got) == len(want) == 10
    for (name, w), g in zip(want.items(), got):
        assert g.shape == w.shape, name
        if name.endswith(("scale", "bias")):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-6 * _scale(name, w))


@pytest.mark.parametrize("micro", [1, 2])
def test_per_worker_loss_and_grads(micro):
    """At S=2, M microbatches, against the reference's and the port's own
    sequential (scanned LM) run on the same parameters."""
    kw = dict(PP, pp_microbatches=micro)
    jset, tset = _pair(kw, make_mesh_wpp(4, 2))
    toks = _toks(kw)
    jl = np.asarray(jset.per_worker_loss(jset.state.params,
                                         jnp.asarray(toks)))
    tl = tset.per_worker_loss(tset.state.params,
                              torch.as_tensor(toks).long()).numpy()
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    jg, jgl = jset.per_worker_grads(jset.state.params, jnp.asarray(toks))
    tg, tgl = _grads(tset, toks)
    assert tg.shape == (8, tset.dim) == np.asarray(jg).shape
    np.testing.assert_allclose(tgl, np.asarray(jgl), rtol=1e-5)
    _close(tg, np.asarray(jg))
    # the sequential oracle: the scanned LM on the renamed parameters
    seq = build_sp_train_setup(
        TrainConfig(**dict(LM, scan_layers=True)), "cpu",
        init={("blocks." + k[len(PREFIX):] if k.startswith(PREFIX) else k):
              v for k, v in tset.state.params.items()})
    sg, sl = seq.lane_grads(seq.state.params, torch.as_tensor(toks).long())
    assert seq.layout.jax_shapes == tset.layout.jax_shapes
    np.testing.assert_allclose(tgl, sl.numpy(), rtol=1e-5)
    _close(tg, sg.numpy())


def test_microbatch_invariance():
    out = {}
    for micro in (1, 2):
        setup = pp_step.build_pp_train_setup(
            TrainConfig(**dict(PP, pp_microbatches=micro)), "cpu")
        out[micro] = _grads(setup, _toks(PP))
    _close(out[2][0], out[1][0])
    np.testing.assert_allclose(out[2][1], out[1][1], rtol=1e-5)


def test_four_stages():
    kw = dict(PP, num_workers=2, worker_fail=0, approach="baseline",
              mode="normal", pipeline_shards=4, pp_microbatches=2,
              model_layers=4)
    jset, tset = _pair(kw, make_mesh_wpp(2, 4))
    toks = _toks(kw)
    jg, jl = jset.per_worker_grads(jset.state.params, jnp.asarray(toks))
    tg, tl = _grads(tset, toks)
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-5)
    _close(tg, np.asarray(jg))


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_remat_under_the_stage_vmap(attn):
    """remat recomputes each block under the stage vmap nested in the
    lanes' vmap: the same gradients bit for bit."""
    out = {}
    for remat in (False, True):
        setup = pp_step.build_pp_train_setup(
            TrainConfig(**dict(PP, remat=remat, attn_impl=attn)), "cpu")
        out[remat] = _grads(setup, _toks(PP))
    np.testing.assert_array_equal(out[True][0], out[False][0])
    np.testing.assert_array_equal(out[True][1], out[False][1])


@pytest.mark.parametrize("code", ["shared", "approx"])
def test_pp_step_against_the_reference(code):
    kw = dict(PP, **(APPROX if code == "approx" else {}))
    held(two_steps(kw, jax_pp, make_mesh_wpp(4, 2),
                   pp_step.build_pp_train_setup))


def test_simulate_warns_and_runs_shared():
    kw = dict(PP, redundancy="simulate")
    with pytest.warns(UserWarning) as got:
        sim = pp_step.build_pp_train_setup(TrainConfig(**kw), "cpu")
    assert str(got[0].message) == pp_step.SIMULATE_WARNING
    with pytest.warns(UserWarning, match="not implemented") as ref:
        jax_pp(JaxConfig(eval_freq=0, **kw), make_mesh_wpp(4, 2))
    assert str(ref[0].message) == pp_step.SIMULATE_WARNING
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        shared = pp_step.build_pp_train_setup(TrainConfig(**PP), "cpu")
    adv = rng.adversary_schedule(SEED, 3, 8, 1)
    for setup in (sim, shared):
        setup.train_step(setup.state, _toks(PP), adv[1])
    np.testing.assert_array_equal(
        params_mod.flatten(sim.state.params, sim.layout).numpy(),
        params_mod.flatten(shared.state.params, shared.layout).numpy())


def _ref_leaves(state):
    return [np.asarray(x) for x in jax.tree.leaves(jax.device_get(state))]


def test_resume_is_exact(tmp_path):
    """4 steps against 2, a checkpoint and 2 more: bit for bit."""
    kw = dict(PP, max_steps=4, eval_freq=2, train_dir=str(tmp_path))
    full, _ = pp_step.train_pp(TrainConfig(**kw), "cpu", quiet=True)
    resumed, _ = pp_step.train_pp(
        TrainConfig(**dict(kw, checkpoint_step=2, max_steps=2)), "cpu",
        quiet=True)
    assert resumed.step == full.step == 5
    for k, v in full.params.items():
        assert torch.equal(v, resumed.params[k]), k


def test_checkpoint_reads_in_both_packages(tmp_path):
    jset = jax_pp(JaxConfig(eval_freq=0, **PP), make_mesh_wpp(4, 2))
    adv = rng.adversary_schedule(SEED, 3, 8, 1)
    jstate, _ = jset.train_step(jset.state, jnp.asarray(_toks(PP)),
                                jnp.asarray(adv[1]))
    ref = _ref_leaves(jstate)
    jckpt.save(str(tmp_path / "ref"), 1, jstate, compress=True)
    tset = pp_step.build_pp_train_setup(TrainConfig(**PP), "cpu")
    lay = tset.layout
    tset.state.load(ckpt.load(str(tmp_path / "ref"), 1,
                              tset.state.specs(lay)), lay)
    ours = tset.state.arrays(lay)
    assert len(ours) == len(ref) and tset.state.step == 2
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    ckpt.save(str(tmp_path / "port"), 1, ours)
    abstract = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                            jstate)
    for a, b in zip(_ref_leaves(jckpt.load(str(tmp_path / "port"), 1,
                                           abstract)), ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("saved", ["pp", "scan"])
def test_resume_across_pipeline_and_lm_is_refused(tmp_path, saved):
    """The pipeline's tree and the scanned LM's hold the same leaves under
    other names: a resume across them is refused, by name."""
    d = str(tmp_path)
    scan = dict(LM, scan_layers=True)
    runs = {"pp": (pp_step.train_pp, PP), "scan": (train_sp, scan)}
    train, kw = runs[saved]
    train(TrainConfig(**dict(kw, train_dir=d, eval_freq=1, max_steps=1)),
          "cpu", quiet=True)
    other_train, other = runs["scan" if saved == "pp" else "pp"]
    with pytest.raises(ValueError, match="not interchangeable"):
        other_train(TrainConfig(**dict(other, train_dir=d, checkpoint_step=1,
                                       max_steps=1)), "cpu", quiet=True)
    state, _ = train(TrainConfig(**dict(kw, train_dir=d, checkpoint_step=1,
                                        max_steps=1)), "cpu", quiet=True)
    assert state.step == 3
