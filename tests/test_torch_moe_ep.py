"""The port's Switch mixture of experts (``models/moe.py``) and its
expert-parallel route (``parallel/ep_step.py``, the shard axis a tensor
axis) against the JAX package's (``draco_tpu.models.moe``,
``draco_tpu.parallel.sp_step`` with experts, ``draco_tpu.parallel
.ep_step`` on ``make_mesh_wep(4, 2)``).

* The MoE LM's initial parameters, unrolled and scanned: the port's own
  draw (the ``moe`` scope's rng counts: ``w1`` the first, ``w2`` the
  third, after ``b1``; under the scan the module's parameter count
  more) against Flax's ``model.init`` leaf for leaf within 1e-6·σ (σ the
  initialiser's scale: fan_in ``dim`` for ``w1`` and the router, 4·dim
  for ``w2``), the biases exact.
* ``MoeMlp`` against the reference's on the same parameters: the outputs
  to 1e-5 absolute and the gradients to 1e-5 of their scale on random
  tokens, on a router that sends every token to one expert (the tokens
  past its capacity dropped, exactly 0; three experts with no tokens; its
  logits tied, so the tie goes to the lower index in both) and on a single
  token (capacity 1).
* Routing: discrete, so it is held exactly wherever the data decide it.
  The f32 noise bound: the router's logits are ``dim``-term float32 dot
  products, so two implementations' probabilities differ by a few 1e-7
  at these widths (dim ≤ 64); a token whose top two probabilities lie
  within ``ROUTE_NOISE`` = 1e-5 of each other can route differently in
  the two packages. Outside the bound the expert indices are equal; the
  step tests assert that no token of their input lies inside it, and fail
  by name if one does.
* The MoE step on the default route against the reference's
  ``build_sp_train_setup`` with experts, and the ep=2 step against
  ``build_ep_train_setup``: two eager steps, the LM step's tolerances
  (the decode columns equal, the loss to 1e-4 relative, the update to
  1e-2 in relative L2, the parameters to 1e-4 of their scale), the port
  from its own draw on the default route.
* The ep=2 step bit for bit the default route's MoE step: the ep route
  on one card runs that MoE as it is (``parallel/ep_step.py``).
* A ``.dcg`` of an MoE state read across the packages, leaf for leaf bit
  for bit.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from draco_tpu.config import TrainConfig as JaxConfig
from draco_tpu.models.moe import MoeMlp as JaxMoe
from draco_tpu.models.transformer import TransformerLM as JaxLM
from draco_tpu.parallel.ep_step import build_ep_train_setup as jax_ep
from draco_tpu.parallel.mesh import make_mesh_2d, make_mesh_wep
from draco_tpu.parallel.sp_step import build_sp_train_setup as jax_sp
from draco_tpu.utils import checkpoint as jckpt
from draco_tpu_torch import params as params_mod
from draco_tpu_torch import rng
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.models.layers import init_params
from draco_tpu_torch.models.moe import MoeMlp
from draco_tpu_torch.models.transformer import TransformerLM
from draco_tpu_torch.parallel import ep_step
from draco_tpu_torch.parallel.sp_step import (build_sp_train_setup,
                                              synthetic_text)
from draco_tpu_torch.utils import checkpoint as ckpt
from test_torch_tp_step import LM, SEED, held, two_steps

torch.set_num_threads(1)

MOE = dict(LM, moe_experts=4)
EP = dict(MOE, expert_shards=2)
ROUTE_NOISE = 1e-5
DIM, E = 32, 4


def _walk(tree, path=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _scale(path, leaf, stacked: bool) -> float:
    shape = leaf.shape[1:] if stacked else leaf.shape
    if path[-1] == "embedding":
        return float(np.sqrt(1.0 / shape[-1]))
    fan = shape[-2] if path[-1] in ("w1", "w2") else np.prod(shape[:-1])
    return float(np.sqrt(1.0 / fan) / 0.87962566103423978)


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scanned"])
def test_moe_draws_are_flax_init(scan):
    jm = JaxLM(vocab=64, dim=DIM, heads=2, layers=3, experts=E,
               scan_layers=scan)
    want = dict(_walk(jax.device_get(jax.jit(jm.init)(
        {"params": jax.random.key(SEED)},
        jnp.zeros((1, 8), jnp.int32))["params"])))
    tm = TransformerLM(vocab=64, dim=DIM, heads=2, layers=3, experts=E,
                       scan_layers=scan)
    init_params(tm, SEED)
    lay = params_mod.layout(tm)
    got = [x.read() for x in params_mod.tensor_leaves(
        dict(tm.named_parameters()), lay)]
    assert len(got) == len(want)
    assert ("block0", "moe", "w2") in want or ("blocks", "moe", "w2") in want
    for (path, w), g in zip(want.items(), got):
        assert g.shape == w.shape, path
        if path[-1] in ("scale", "bias", "b1", "b2"):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(
                g, w, rtol=0, atol=1e-6 * _scale(path, w, scan))


def _pair(tokens: int, router=None):
    """The reference's MoeMlp and the port's on the same parameters (the
    reference's draw; ``router`` replaces its kernel, (dim, E))."""
    jm = JaxMoe(DIM, E)
    x = np.random.RandomState(3).normal(size=(1, tokens, DIM)).astype(
        np.float32)
    p = jax.device_get(jm.init(jax.random.key(SEED), jnp.asarray(x)))
    p = jax.tree.map(np.asarray, fnn.meta.unbox(p))["params"]
    if router is not None:
        p["router"]["kernel"] = router.astype(np.float32)
    tm = MoeMlp(DIM, E)
    with torch.no_grad():
        for name, t in tm.named_parameters():
            v = p["router"]["kernel"].T if name == "router.weight" else p[name]
            t.copy_(torch.from_numpy(np.array(v)))
    return jm, p, tm, x


def _outputs_and_grads(jm, p, tm, x):
    def jloss(params, x):
        return jnp.sum(jm.apply({"params": params}, x) ** 2)

    jy = np.asarray(jm.apply({"params": p}, jnp.asarray(x)))
    jg = jax.grad(jloss)(p, jnp.asarray(x))
    xt = torch.from_numpy(x)
    ty = tm(xt)
    (ty ** 2).sum().backward()
    tg = {"w1": tm.w1.grad, "w2": tm.w2.grad, "b1": tm.b1.grad,
          "b2": tm.b2.grad, "router": tm.router.weight.grad.T}
    jg = {k: np.asarray(jg[k]["kernel"] if k == "router" else jg[k])
          for k in tg}
    return jy, ty.detach().numpy(), jg, {k: v.numpy() for k, v in tg.items()}


@pytest.mark.parametrize("case", ["random", "one_expert", "one_token"])
def test_moe_mlp_against_the_reference(case):
    tokens = 1 if case == "one_token" else 40
    router = None
    if case == "one_expert":
        # every token's logits tie: argmax takes the lowest index, expert 0
        router = np.zeros((DIM, E))
    jm, p, tm, x = _pair(tokens, router)
    dispatch, _, eidx = tm.route(torch.from_numpy(x[0]))
    cap = tm.capacity(tokens)
    assert dispatch.shape == (tokens, E, cap)
    assert cap == max(int(1.25 * tokens / E), 1)
    jy, ty, jg, tg = _outputs_and_grads(jm, p, tm, x)
    assert ty.shape == jy.shape == (1, tokens, DIM)
    np.testing.assert_allclose(ty, jy, rtol=0, atol=1e-5)
    for k in tg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=0,
                                   atol=1e-5 * max(np.abs(jg[k]).max(), 1e-6))
    kept = dispatch.sum(dim=(1, 2))
    if case == "one_expert":
        assert bool((eidx == 0).all())
        # the first cap tokens kept in arrival order, the others dropped:
        # exactly 0 in both packages; experts 1-3 receive nothing
        assert kept.tolist() == [1.0] * cap + [0.0] * (tokens - cap)
        assert not np.any(ty[0, cap:]) and not np.any(jy[0, cap:])
        assert float(dispatch[:, 1:].sum()) == 0.0
        np.testing.assert_array_equal(tg["w1"][1:], 0.0)
    else:
        assert float(kept.min()) >= 0.0 and kept.sum() <= tokens


def _probs_port(tm, x):
    return torch.softmax(tm.router(torch.from_numpy(x[0])), -1).detach()


def test_routing_outside_the_noise_bound_is_the_references():
    jm, p, tm, x = _pair(200)
    jp = np.asarray(jax.nn.softmax(jnp.asarray(x[0]) @ p["router"]["kernel"],
                                   axis=-1))
    tp = _probs_port(tm, x).numpy()
    assert np.abs(tp - jp).max() < ROUTE_NOISE / 10
    top2 = np.sort(jp, axis=-1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > ROUTE_NOISE
    assert decided.sum() >= 190
    np.testing.assert_array_equal(tp.argmax(-1)[decided],
                                  jp.argmax(-1)[decided])


def routing_decided(setup, toks) -> None:
    """No token of the step's input routes inside the f32 noise bound, in
    any block of any lane (the port's forward, hooked at each MoE)."""
    gaps = []

    def hook(mod, inp, _):
        h = inp[0].reshape(-1, inp[0].shape[-1])
        probs = torch.softmax(mod.router(h.to(torch.float32)), -1)
        top2 = probs.topk(2, dim=-1).values
        gaps.append(top2[:, 0] - top2[:, 1])

    hooks = [m.register_forward_hook(hook) for m in setup.model.modules()
             if isinstance(m, MoeMlp)]
    try:
        with torch.no_grad():
            for lane in torch.as_tensor(toks).long():
                setup.model(lane)
    finally:
        for h in hooks:
            h.remove()
    gaps = torch.stack(gaps)
    worst = float(gaps.min())
    assert worst > ROUTE_NOISE, (
        f"a token routes inside the f32 noise bound ({worst:.3e} <= "
        f"{ROUTE_NOISE:g}) at (lane·block, token) "
        f"{divmod(int(gaps.argmin()), gaps.shape[1])}")


def test_moe_step_on_the_default_route():
    """From the port's own draw (Flax's model.init within 1e-6σ)."""
    held(two_steps(MOE, jax_sp, make_mesh_2d(1, 1), build_sp_train_setup,
                   own_init=True, before_step=routing_decided),
         own_init=True)


def test_ep2_step_against_the_reference():
    held(two_steps(EP, jax_ep, make_mesh_wep(4, 2),
                   ep_step.build_ep_train_setup,
                   before_step=routing_decided))


def test_ep2_step_is_the_default_routes_bit_for_bit():
    """The ep route on one card runs the default route's MoE as it is
    (``parallel/ep_step.py``: top-1 one-hot routing, so per-group partial
    combines would add exact zeros): three steps from one draw, every
    metric and every parameter bit for bit."""
    out = {}
    for name, kw, build in (("ep", EP, ep_step.build_ep_train_setup),
                            ("sp", MOE, build_sp_train_setup)):
        setup = build(TrainConfig(**kw), device="cpu")
        adv = rng.adversary_schedule(SEED, 3, 8, 1)
        state, recs = setup.state, []
        for step in (1, 2, 3):
            state, m = setup.train_step(
                state, synthetic_text(SEED, step, 8, 2, 16, 64), adv[step])
            recs.append({k: float(v) for k, v in m.items()})
        out[name] = (recs, params_mod.flatten(state.params, setup.layout))
    assert out["ep"][0] == out["sp"][0]
    assert torch.equal(out["ep"][1], out["sp"][1])


def test_ep_partition_spec_is_the_references():
    from draco_tpu.parallel.ep_step import ep_partition_spec as jax_spec
    from jax.sharding import PartitionSpec as P

    for scan in (False, True):
        tm = TransformerLM(vocab=64, dim=DIM, heads=2, layers=2, experts=E,
                           scan_layers=scan)
        lay = params_mod.layout(tm)
        for name, kind in zip(lay.names, lay.kinds):
            parent, _, leaf = name.rpartition(".")
            flax_leaf, _ = params_mod.leaf_role(tm.get_submodule(parent),
                                                leaf)
            path = tuple(parent.split(".")) + (flax_leaf,)
            keys = [jax.tree_util.DictKey(k) for k in path]
            spec = ep_step.ep_partition_spec(path)
            assert P(*spec) == jax_spec(keys), path
            assert bool(spec) == (flax_leaf in ep_step.EXPERT_PARAMS)


def _ref_leaves(state):
    return [np.asarray(x) for x in jax.tree.leaves(jax.device_get(state))]


def test_moe_checkpoint_reads_in_both_packages(tmp_path):
    jset = jax_ep(JaxConfig(eval_freq=0, **EP), make_mesh_wep(4, 2))
    adv = rng.adversary_schedule(SEED, 3, 8, 1)
    jstate, _ = jset.train_step(
        jset.state, jnp.asarray(synthetic_text(SEED, 1, 8, 2, 16, 64)),
        jnp.asarray(adv[1]))
    ref = _ref_leaves(jstate)
    jckpt.save(str(tmp_path / "ref"), 1, jstate, compress=True)
    tset = ep_step.build_ep_train_setup(TrainConfig(**EP), "cpu")
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
