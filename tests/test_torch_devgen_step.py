"""The port's device draws inside its steps: the LM with device tokens
(``token_gen="device"``) against the reference's chunked loop, and each
new option's K-step chunk against its eager steps.

The LM: ``draco_tpu.parallel.sp_step``'s ``train_token_many`` on a
one-device mesh, which in this mode takes the (K,) step vector and makes
each step's tokens in-graph, against the port's eager step, which makes
them from the staged step on the device (``synthetic_text_in_graph``),
with the random attack (both draw ``normal(random_key(seed, step))``).
Step t of both loops is 1-based and folds t into both keys: two steps from
step 1 pin the two loops' step numbers together (a step off by one draws
other tokens and another loss). Tolerances are ``test_torch_lm_step``'s:
the discrete decode columns equal, the loss to 1e-4 relative, the update
to 1e-2 in relative L2 norm.

The chunks: ``steps_per_call`` K = 3 over ranges (1, 3), (4, 1) against
four eager steps of a fresh setup, bit for bit (parameters, momentum, BN
statistics, every metric): the LM with device tokens and the random
attack, the LM with the random attack on host tokens, and LeNet (small,
so each runs in seconds) with the random attack on the cyclic code and
on the geometric median, stochastic rounding on the cyclic int8 wire, on
the approx code's int8 wire and on the vote's bf16 wire. Each chunk
stages the step numbers, the draws read them on the device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from draco_tpu.config import TrainConfig as JaxConfig
from draco_tpu.parallel.mesh import make_mesh_2d
from draco_tpu.parallel.sp_step import build_sp_train_setup as jax_setup
from draco_tpu_torch import params as params_mod
from draco_tpu_torch import rng
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.data import datasets
from draco_tpu_torch.parallel.sp_step import build_sp_train_setup
from draco_tpu_torch.parallel.token_loop import TokenLoop
from draco_tpu_torch.training.trainer import Trainer
from test_torch_chunk import assert_chunk_equals_eager, lm_build, lm_chunk
from test_torch_chunk import cnn_chunk
from test_torch_lm_step import LM, SEED, _flat

torch.set_num_threads(1)

DEVGEN = dict(LM, approach="cyclic", redundancy="shared", token_gen="device",
              err_mode="random")


def test_lm_device_tokens_against_the_references_chunked_loop():
    jset = jax_setup(JaxConfig(eval_freq=0, log_every=1000, **DEVGEN),
                     make_mesh_2d(1, 1))
    init, _ = params_mod.from_jax(jax.device_get(jset.state.params))
    tset = build_sp_train_setup(TrainConfig(**DEVGEN), device="cpu",
                                init=init)
    adv = rng.adversary_schedule(SEED, DEVGEN["max_steps"], 8, 1)
    steps = np.arange(1, 3, dtype=np.int32)
    jstate, jblock = jset.train_token_many(
        jset.state, jnp.asarray(steps), jnp.asarray(adv[1:3]), None)
    jblock = np.asarray(jblock)
    col = {k: i for i, k in enumerate(jset.metric_names)}
    tstate = tset.state
    for i, step in enumerate(steps):
        assert tstate.step == step
        tstate, m = tset.train_step(tstate, None, adv[step])
        ref = jblock[i]
        assert float(m["loss"]) == pytest.approx(ref[col["loss"]], rel=1e-4)
        for k in ("located_errors", "det_tp", "det_adv"):
            assert float(m[k]) == ref[col[k]], k
        assert float(m["located_errors"]) == 1.0
        assert float(m["honest_located"]) == 6.0
    lay = tset.layout
    before = _flat(init, lay)
    ref, _ = params_mod.from_jax(jax.device_get(jstate.params))
    d_jax = _flat(ref, lay) - before
    d_port = _flat(tstate.params, lay) - before
    assert np.linalg.norm(d_jax) > 0
    assert np.linalg.norm(d_port - d_jax) <= 1e-2 * np.linalg.norm(d_jax)


def test_lm_device_tokens_stage_no_tokens():
    """The eager loop uploads no tokens, a chunk stages the step numbers
    and the masks only, and the loop needs no token prefetch."""
    cfg = TrainConfig(**dict(DEVGEN, steps_per_call=2, max_steps=4))
    loop = TokenLoop(build_sp_train_setup(cfg, device="cpu"), cfg,
                     quiet=True)
    assert loop.inputs(3)[0] is None
    client = loop.chunk_client(3, 4)
    assert client.prefetch is None
    chunk = client.assemble(0, client.ranges)
    client.cleanup()
    assert set(chunk.tensors) == {"step", "adv"}
    assert chunk.tensors["step"].tolist() == [3, 4]
    assert chunk.tensors["step"].dtype == torch.int32
    last = loop.run()
    assert last["step"] == 4 and np.isfinite(last["loss"])


LM_OPTIONS = {
    "devgen_random": dict(DEVGEN, steps_per_call=3, max_steps=7),
    "random": dict(LM, approach="cyclic", redundancy="shared",
                   err_mode="random", steps_per_call=3, max_steps=7),
}


@pytest.mark.parametrize("name", sorted(LM_OPTIONS))
def test_lm_chunk_equals_eager_steps(name):
    assert_chunk_equals_eager(lm_build(LM_OPTIONS[name]), lm_chunk)


LENET = dict(network="LeNet", dataset="synthetic-mnist", lr=0.01,
             momentum=0.9, batch_size=2, max_steps=7, steps_per_call=3,
             train_dir="", seed=SEED)
CYCLIC = dict(LENET, approach="cyclic", redundancy="shared", num_workers=5,
              worker_fail=1)
CNN_OPTIONS = {
    "cyclic_random": dict(CYCLIC, err_mode="random"),
    "simulate_random": dict(CYCLIC, redundancy="simulate",
                            err_mode="random"),
    "geomedian_random": dict(LENET, approach="baseline",
                             mode="geometric_median", num_workers=4,
                             worker_fail=1, err_mode="random",
                             geomedian_iters=8),
    "cyclic_int8_sr": dict(CYCLIC, wire_dtype="int8",
                           shadow_round="stochastic"),
    "approx_int8_sr": dict(LENET, approach="approx", redundancy="shared",
                           num_workers=8, worker_fail=0,
                           straggle_mode="drop", straggle_count=2,
                           wire_dtype="int8", shadow_round="stochastic"),
    "majvote_bf16_sr": dict(LENET, approach="maj_vote", num_workers=3,
                            group_size=3, worker_fail=1, wire_dtype="bf16",
                            shadow_round="stochastic", err_mode="random"),
}


@pytest.fixture(scope="module")
def mnist():
    return datasets.load_dataset("synthetic-mnist", synthetic_train=256,
                                 synthetic_test=8)


@pytest.mark.parametrize("name", sorted(CNN_OPTIONS))
def test_cnn_chunk_equals_eager_steps(mnist, name):
    def build():
        cfg = TrainConfig(**CNN_OPTIONS[name])
        tr = Trainer(cfg, device="cpu", dataset=mnist, quiet=True)
        return tr.setup, tr
    assert_chunk_equals_eager(build, cnn_chunk)
