"""The port's coded TransformerLM step against the JAX package's
(``draco_tpu.parallel.sp_step.build_sp_train_setup``) at sp=1.

The reference runs on a one-device mesh (``make_mesh_2d(1, 1)``, the n
worker lanes vmapped on it, batch 2 per worker: at batch 1 its step on a
multi-device mesh computes some workers' gradients wrongly, ROADMAP Queue
C). The port runs on the CPU through the kernels' plain versions, from the
reference's initial parameters (``params.from_jax``), on the same
``synthetic_text`` tokens and adversary schedule, with the reference's
in-graph random projection, which the port draws itself. Two steps per
leg, the port starting each from the reference's parameters and momentum:
cyclic ``shared`` and ``simulate`` (n=8, s=1, a rev_grad adversary each
step) and the geometric-median baseline.

Tolerances (the PR 1 step tolerances). The discrete decode columns are
equal. The loss agrees to 1e-4 relative. The update (−lr × the decoded
gradient, with momentum on step 2) agrees to 1e-2 in relative L2 norm and
the parameters to 1e-4 of their scale coordinate by coordinate. The decode
residual is float32 noise of the projection on both sides: below 1e-4 on
both, not equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from draco_tpu import optim as joptim
from draco_tpu.config import TrainConfig as JaxConfig
from draco_tpu.obs.forensics import mask_metric_names
from draco_tpu.parallel.mesh import make_mesh_2d
from draco_tpu.parallel.sp_step import build_sp_train_setup as jax_setup
from draco_tpu.parallel.sp_step import synthetic_text as j_text
from draco_tpu_torch import params as params_mod
from draco_tpu_torch import rng
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.parallel import build_route_setup
from draco_tpu_torch.parallel.sp_step import build_sp_train_setup
from draco_tpu_torch.parallel.sp_step import synthetic_text

torch.set_num_threads(1)

SEED = 428
LM = dict(network="TransformerLM", dataset="synthetic-text", lr=0.01,
          momentum=0.9, num_workers=8, worker_fail=1, err_mode="rev_grad",
          batch_size=2, seq_len=32, vocab=64, model_dim=64, model_heads=4,
          model_layers=2, max_steps=3, train_dir="", seed=SEED)
LEGS = {
    "shared": dict(approach="cyclic", redundancy="shared"),
    "simulate": dict(approach="cyclic", redundancy="simulate",
                     attn_impl="flash"),
    "geomedian": dict(approach="baseline", mode="geometric_median",
                      geomedian_iters=8),
}


def test_synthetic_text_bit_for_bit():
    for args in ((SEED, 1, 8, 2, 32, 64), (7, 30, 3, 4, 17, 8192)):
        np.testing.assert_array_equal(synthetic_text(*args), j_text(*args))


def _momentum(opt_state):
    if isinstance(opt_state, joptim.SGDState):
        return opt_state.momentum_buf
    for part in opt_state:
        found = _momentum(part)
        if found is not None:
            return found
    return None


def _flat(params, lay):
    return params_mod.flatten(params, lay).numpy()


@pytest.fixture(scope="module", params=sorted(LEGS))
def leg(request):
    kw = dict(LM, **LEGS[request.param])
    # the reference's flash on its CPU mesh takes its dense fallback; the
    # port's flash leg runs the flash wrappers' plain versions
    jkw = dict(kw, attn_impl="dense")
    jset = jax_setup(JaxConfig(eval_freq=0, log_every=1000, **jkw),
                     make_mesh_2d(1, 1))
    jstate = jset.state
    init, _ = params_mod.from_jax(jax.device_get(jstate.params))
    tset = build_sp_train_setup(TrainConfig(**kw), device="cpu", init=init)
    tstate = tset.state
    lay = tset.layout
    assert tset.dim == jset.dim
    adv = rng.adversary_schedule(SEED, kw["max_steps"], 8, 1)
    rec = {"steps": [], "names": tset.metric_names, "jax_names":
           jset.metric_names}
    before = init
    for step in (1, 2):
        toks = synthetic_text(SEED, step, 8, 2, 32, 64)
        jstate, jm = jset.train_step(jstate, jnp.asarray(toks),
                                     jnp.asarray(adv[step]))
        tstate, tm = tset.train_step(tstate, toks, adv[step])
        st = {"jax": {k: float(jm[k]) for k in tset.metric_names},
              "port": {k: float(v) for k, v in tm.items()},
              "before": _flat(before, lay),
              "port_p": _flat(tstate.params, lay)}
        # hand the port the reference's state for the next step
        before, _ = params_mod.from_jax(jax.device_get(jstate.params))
        bufs, _ = params_mod.from_jax(
            jax.device_get(_momentum(jstate.opt_state)))
        for k, v in before.items():
            tstate.params[k].copy_(v)
        tstate.opt.bufs = bufs
        st["jax_p"] = _flat(before, lay)
        rec["steps"].append(st)
    eval_toks = synthetic_text(SEED + 1, 0, 8, 2, 32, 64)
    rec["eval"] = (float(jset.eval_step(jstate.params,
                                        jnp.asarray(eval_toks))),
                   float(tset.eval_step(tstate.params, eval_toks)))
    return request.param, rec


def test_metric_columns_and_decode(leg):
    name, rec = leg
    # the reference's columns, its packed forensics masks among them, in
    # its order; the masks bit for bit its words
    assert rec["names"] == rec["jax_names"]
    if name != "geomedian":
        for st in rec["steps"]:
            for k in mask_metric_names(8):
                assert st["port"][k] == st["jax"][k], k
    for st in rec["steps"]:
        assert st["port"]["loss"] == pytest.approx(st["jax"]["loss"],
                                                   rel=1e-4)
        if name == "geomedian":
            assert rec["names"] == ("loss",)
            continue
        for k in ("located_errors", "det_tp", "det_adv"):
            assert st["port"][k] == st["jax"][k], k
        assert st["port"]["located_errors"] == st["port"]["det_tp"] == 1
        assert st["port"]["honest_located"] == 6
        assert st["port"]["decode_residual"] < 1e-4
        assert st["jax"]["decode_residual"] < 1e-4


def test_updates_and_params(leg):
    _, rec = leg
    for st in rec["steps"]:
        d_port, d_jax = st["port_p"] - st["before"], st["jax_p"] - st["before"]
        assert np.linalg.norm(d_jax) > 0
        assert np.linalg.norm(d_port - d_jax) <= 1e-2 * np.linalg.norm(d_jax)
        np.testing.assert_allclose(st["port_p"], st["jax_p"], rtol=0,
                                   atol=1e-4 * np.abs(st["jax_p"]).max())


def test_eval_step(leg):
    _, rec = leg
    jax_loss, port_loss = rec["eval"]
    assert port_loss == pytest.approx(jax_loss, rel=1e-4)


# the device tokens and the random attack under K > 1 run now (their
# draws read the staged step), and sequence shards, remat and the scanned
# layer stack, and tensor parallelism, the pipeline and the Switch experts
# (each on its route, parallel.build_route_setup): those cases (PORTED)
# validate and run a step; the others are still refused
PORTED = ("token_gen=device", "steps_per_call=4", "seq_shards=2",
          "remat=True", "scan_layers=True", "seq_shards=2-wire_dtype=int8",
          "tensor_shards=2", "pipeline_shards=2", "moe_experts=4")


@pytest.mark.parametrize("override", [
    {"seq_shards": 2}, {"tensor_shards": 2}, {"pipeline_shards": 2},
    {"moe_experts": 4}, {"remat": True}, {"scan_layers": True},
    {"token_gen": "device"},
    pytest.param({"steps_per_call": 4, "err_mode": "random"},
                 id="steps_per_call=4"),
    {"attn_impl": "ring"},
    {"model_heads": 5}, {"model_dim": 24, "model_heads": 8},
    {"dataset": "synthetic-cifar10"}, {"compute_dtype": "float16"},
    {"approach": "maj_vote"},
    # the approx code, the narrow wire and stragglers run on the LM now,
    # within the reference's own checks: a live adversary under approx,
    # an adversary beside a straggler at s=1, a wire with no threshold,
    # and a sharded route beside the new options
    {"approach": "approx", "redundancy": "shared", "worker_fail": 1},
    {"straggle_mode": "drop", "straggle_count": 1},
    {"wire_dtype": "fp8"},
    {"seq_shards": 2, "wire_dtype": "int8"}],
    ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_lm_config_rejects_what_is_not_ported(request, override):
    base = dict(LM, approach="cyclic")
    TrainConfig(**base).validate()
    if request.node.callspec.id not in PORTED:
        with pytest.raises(ValueError):
            TrainConfig(**dict(base, **override)).validate()
        return
    cfg = TrainConfig(**dict(base, **override)).validate()
    setup = build_route_setup(cfg, device="cpu")
    toks = (None if cfg.token_gen == "device"
            else synthetic_text(SEED, 1, 8, 2, 32, 64))
    _, m = setup.train_step(setup.state, toks,
                            rng.adversary_schedule(SEED, 3, 8, 1)[1])
    assert np.isfinite(float(m["loss"])) and float(m["det_tp"]) == 1


def test_cnn_rejects_bfloat16():
    """The CNN takes the reference's compute dtypes, bfloat16 among them
    (its convolutions and Dense layers in bf16, models/layers.py), and
    rejects any other, as the LM does."""
    cnn = dict(network="ResNet18", dataset="synthetic-cifar10")
    TrainConfig(**cnn).validate()
    TrainConfig(**cnn, compute_dtype="bfloat16").validate()
    with pytest.raises(ValueError, match="float32|bfloat16"):
        TrainConfig(**cnn, compute_dtype="float16").validate()


def test_cli_writes_the_reference_columns(tmp_path):
    """The CLI's LM route on the CPU: metrics.jsonl with the reference's
    column names (and the port's step_ms), the eval record, and a cuda
    request without a card refused."""
    import json

    from draco_tpu_torch import cli

    argv = ["--network", "TransformerLM", "--dataset", "synthetic-text",
            "--approach", "cyclic", "--redundancy", "shared", "--attn-impl",
            "flash", "--num-workers", "8", "--worker-fail", "1",
            "--batch-size", "2", "--seq-len", "16", "--model-dim", "32",
            "--model-heads", "2", "--model-layers", "1", "--vocab", "32",
            "--max-steps", "2", "--eval-freq", "2", "--log-every", "1",
            "--train-dir", str(tmp_path)]
    last = cli.main(argv + ["--device", "cpu"])
    assert last["step"] == 2 and last["det_tp"] == 1
    recs = [json.loads(x) for x in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in recs if "split" not in r]
    assert [r["step"] for r in train] == [1, 2]
    assert tuple(train[0]) == ("step", "loss", "decode_residual",
                               "located_errors", "det_tp", "det_adv",
                               "wmask_accused0", "wmask_present0",
                               "wmask_adv0", "step_ms")
    assert [r for r in recs if r.get("split") == "eval"][0]["step"] == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(argv)
