"""The port's configuration against the reference's: the default
configuration (LeNet on MNIST), the presets
``single-lenet`` and ``cyclic-vgg11``, every network of the reference's
zoo, bfloat16 compute on the CNN, and the optimizer fields (``optimizer``,
``weight_decay``, ``lr_schedule``, ``warmup_steps``, ``clip_norm``) and
the run-state fields (``test_batch_size``, ``checkpoint_step``,
``compress_ckpt``, ``keep_checkpoints``, ``prefetch_restarts``,
``prefetch_timeout_s``) and the resilience fields (``step_guard``,
``guard_residual_tol``, ``fault_spec``, ``incident_watch``,
``incident_thresholds``) with the reference's names, defaults, checks and
flags. No JAX computation: seconds.
"""

import pytest

from draco_tpu import optim as joptim
from draco_tpu import presets as jpresets
from draco_tpu.config import TrainConfig as JaxConfig
from draco_tpu.models import _REGISTRY as JAX_MODELS
from draco_tpu_torch import cli, presets
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.models import NAMES, build_model

OPT_FIELDS = ("optimizer", "lr", "momentum", "weight_decay", "lr_schedule",
              "warmup_steps", "clip_norm")
RUN_FIELDS = ("test_batch_size", "checkpoint_step", "compress_ckpt",
              "keep_checkpoints", "prefetch_restarts", "prefetch_timeout_s")


def test_the_default_configuration_validates():
    """The reference's defaults: LeNet on MNIST, the baseline, SGD."""
    cfg = TrainConfig().validate()
    ref = JaxConfig().validate()
    assert (cfg.network, cfg.dataset) == ("LeNet", "MNIST")
    for f in OPT_FIELDS + RUN_FIELDS + ("network", "dataset", "approach",
                                        "compute_dtype"):
        assert getattr(cfg, f) == getattr(ref, f), f


@pytest.mark.parametrize("name", ["single-lenet", "cyclic-vgg11"])
def test_new_presets_are_the_references(name):
    port, ref = presets.get_preset(name), jpresets.get_preset(name)
    for f in ("network", "dataset", "approach", "mode", "num_workers",
              "worker_fail", "err_mode", "batch_size", "redundancy",
              "adversary_count", "seed") + OPT_FIELDS:
        assert getattr(port, f) == getattr(ref, f), f
    assert port.num_adversaries == ref.num_adversaries


def test_every_reference_network_is_built():
    """The whole zoo: its names, and each CNN built at both datasets'
    shapes and both compute dtypes."""
    assert set(NAMES) == set(JAX_MODELS)
    for name in NAMES:
        TrainConfig(network=name, dataset="synthetic-cifar10",
                    compute_dtype="bfloat16").validate()
    for name in ("LeNet", "FC", "VGG13_bn"):
        for ds in ("synthetic-mnist", "synthetic-cifar10"):
            build_model(name, ds, dtype="bfloat16")


LM_FIELDS = dict(network="TransformerLM", dataset="synthetic-text")
# (fields, the reference's validate() raises)
CASES = [
    (dict(lr_schedule="linear"), True),
    (dict(warmup_steps=-1), True),
    (dict(clip_norm=-0.5), True),
    (dict(warmup_steps=2), True),  # with the constant schedule
    (dict(warmup_steps=2, lr_schedule="cosine"), False),
    (dict(clip_norm=0.0), False),
    (dict(clip_norm=1.0, optimizer="adamw", weight_decay=0.05), False),
    (dict(optimizer="adam", lr_schedule="cosine"), False),
    (dict(network="ResNet18", dataset="synthetic-cifar10",
          compute_dtype="bfloat16"), False),
    (dict(network="VGG11", dataset="synthetic-cifar10",
          compute_dtype="bfloat16", approach="cyclic", num_workers=9,
          worker_fail=2, err_mode="constant"), False),
    (dict(compute_dtype="float16"), True),
    (dict(checkpoint_step=-1), False),
    (dict(checkpoint_step=-2), True),
    (dict(keep_checkpoints=-1), True),
    (dict(keep_checkpoints=2), False),
    (dict(prefetch_restarts=-1), True),
    (dict(prefetch_timeout_s=-0.5), True),
    (dict(prefetch_timeout_s=0.0, prefetch_restarts=0), False),
    # the LM's expert and pipeline fields (the reference's defaults, its
    # checks and messages)
    (dict(expert_shards=2), True),
    (dict(pp_microbatches=2), False),
    (dict(pp_microbatches=-1), False),
    (dict(LM_FIELDS, moe_experts=4, expert_shards=2), False),
    (dict(LM_FIELDS, expert_shards=2), True),
    (dict(LM_FIELDS, moe_experts=4, expert_shards=3), True),
    (dict(LM_FIELDS, pp_microbatches=2), False),
    (dict(LM_FIELDS, pp_microbatches=-1), True),
    (dict(LM_FIELDS, pp_microbatches=5), True),
    (dict(LM_FIELDS, pp_microbatches=2, expert_shards=2, moe_experts=2),
     True),
]


@pytest.mark.parametrize("fields,raises", CASES,
                         ids=lambda v: "-".join(f"{k}={x}" for k, x in
                                                v.items())
                         if isinstance(v, dict) else str(v))
def test_checks_match_the_reference(fields, raises):
    def outcome(cls):
        try:
            cls(**fields).validate()
        except ValueError as e:
            return str(e)
        return None

    port, ref = outcome(TrainConfig), outcome(JaxConfig)
    assert (ref is not None) == raises
    assert (port is not None) == raises, port
    if raises and "compute_dtype" not in fields:
        assert port == ref  # the reference's own message


def test_an_unknown_optimizer():
    """The reference accepts the name in validate() and refuses it when it
    builds the optimizer; the port refuses it in validate(), with the same
    message, before any data is loaded."""
    with pytest.raises(ValueError, match="unknown optimizer: lamb"):
        joptim.build_optimizer_from_cfg(JaxConfig(optimizer="lamb"))
    with pytest.raises(ValueError, match="unknown optimizer: lamb"):
        TrainConfig(optimizer="lamb").validate()


def test_cli_flags():
    args = cli.parser().parse_args([
        "--preset", "cyclic-vgg11", "--optimizer", "adamw", "--lr", "0.001",
        "--weight-decay", "0.05", "--lr-schedule", "cosine",
        "--warmup-steps", "2", "--clip-norm", "1.0", "--compute-dtype",
        "bfloat16"])
    cfg = cli.config_from_args(args)
    want = dict(network="VGG11", num_workers=9, worker_fail=2,
                optimizer="adamw", lr=0.001, weight_decay=0.05,
                lr_schedule="cosine", warmup_steps=2, clip_norm=1.0,
                compute_dtype="bfloat16")
    assert {k: getattr(cfg, k) for k in want} == want
    cfg = cli.config_from_args(cli.parser().parse_args(
        ["--preset", "single-lenet"]))
    assert cfg == presets.get_preset("single-lenet")


def test_run_state_flags():
    """The reference's flag names for the run-state fields; a preset takes
    ``--checkpoint-step`` as the reference's CLI passes it."""
    args = cli.parser().parse_args([
        "--preset", "cyclic-resnet18", "--checkpoint-step", "-1",
        "--compress-ckpt", "--keep-checkpoints", "2", "--test-batch-size",
        "500", "--prefetch-timeout", "30", "--prefetch-restarts", "0"])
    cfg = cli.config_from_args(args)
    want = dict(network="ResNet18", checkpoint_step=-1, compress_ckpt=True,
                keep_checkpoints=2, test_batch_size=500,
                prefetch_timeout_s=30.0, prefetch_restarts=0)
    assert {k: getattr(cfg, k) for k in want} == want
    cfg = cli.config_from_args(cli.parser().parse_args([]))
    for f in RUN_FIELDS:
        assert getattr(cfg, f) == getattr(JaxConfig(), f), f
    from draco_tpu.cli import add_fit_args
    import argparse

    ref = add_fit_args(argparse.ArgumentParser())
    ref_flags = {s for a in ref._actions for s in a.option_strings}
    new = {"--test-batch-size", "--checkpoint-step", "--compress-ckpt",
           "--keep-checkpoints", "--prefetch-timeout", "--prefetch-restarts"}
    assert new <= set(cli.FLAGS) and new <= ref_flags
    assert ref.parse_args(["--prefetch-timeout", "30"]).prefetch_timeout_s \
        == 30.0


def test_the_port_config_fields_are_the_references():
    """Every field of the port's configuration is one of the reference's,
    under the same name (the run-state fields among them)."""
    import dataclasses

    assert set(RUN_FIELDS) <= {f.name for f in
                               dataclasses.fields(TrainConfig)}
    assert {f.name for f in dataclasses.fields(TrainConfig)} <= {
        f.name for f in dataclasses.fields(JaxConfig)}


RESILIENCE_FIELDS = ("step_guard", "guard_residual_tol", "fault_spec",
                     "incident_watch", "incident_thresholds")
_CODED = dict(approach="cyclic", num_workers=8, worker_fail=1)
_APPROX = dict(approach="approx", redundancy="shared", num_workers=8,
               worker_fail=0)
RESILIENCE_CASES = [
    (dict(step_guard="maybe"), True),
    (dict(step_guard="on", **_CODED), False),
    (dict(guard_residual_tol=0.0), True),
    (dict(guard_residual_tol=-1e-3), True),
    (dict(guard_residual_tol=5e-3, step_guard="on"), False),
    (dict(fault_spec="bogus@1"), True),
    (dict(fault_spec="nan_grad@0"), True),
    (dict(fault_spec="nan_grad@2:w9", **_CODED), True),
    (dict(fault_spec="nan_grad@2,sigterm@5,straggle@3-6:w2:d1", **_CODED),
     False),
    (dict(fault_spec="over_budget@3", **_APPROX), True),
    (dict(fault_spec="adversary@5:w2", **_APPROX), True),
    (dict(fault_spec="straggle@2:w3:d2,nan_grad@4", **_APPROX), False),
    (dict(incident_watch="maybe"), True),
    (dict(incident_watch="on"), False),
    (dict(incident_thresholds="bogus.x=1"), True),
    (dict(incident_thresholds="trust.bogus=1"), True),
    (dict(incident_thresholds="trust.floor=0.4,guard.off_count=2"), False),
]


@pytest.mark.parametrize("fields,raises", RESILIENCE_CASES,
                         ids=lambda v: "-".join(f"{k}={x}" for k, x in
                                                v.items())
                         if isinstance(v, dict) else str(v))
def test_resilience_checks_match_the_reference(fields, raises):
    test_checks_match_the_reference(fields, raises)


def test_resilience_fields_and_flags():
    """The five fields with the reference's defaults and flags; a straggle
    event on the LM validates and takes its worker's row out of that step
    of the LM's loop."""
    port, ref = TrainConfig(), JaxConfig()
    for f in RESILIENCE_FIELDS:
        assert getattr(port, f) == getattr(ref, f), f
    from draco_tpu.cli import add_fit_args
    import argparse

    ref_p = add_fit_args(argparse.ArgumentParser())
    flags = ["--step-guard", "on", "--guard-residual-tol", "0.002",
             "--fault-spec", "nan_grad@2", "--incident-watch", "on",
             "--incident-thresholds", "trust.floor=0.4"]
    cfg = cli.config_from_args(cli.parser().parse_args(flags))
    theirs = ref_p.parse_args(flags)
    for f in RESILIENCE_FIELDS:
        assert getattr(cfg, f) == getattr(theirs, f), f
    lm = dict(network="TransformerLM", dataset="synthetic-text", **_CODED)
    TrainConfig(fault_spec="inf_grad@2:w5,over_budget@3", **lm).validate()
    cfg = TrainConfig(fault_spec="straggle@2:w1", batch_size=2, seq_len=16,
                      vocab=32, model_dim=32, model_heads=2, model_layers=1,
                      max_steps=2, train_dir="", **lm).validate()
    from draco_tpu_torch.obs.forensics import record_masks
    from draco_tpu_torch.parallel.sp_step import build_sp_train_setup
    from draco_tpu_torch.parallel.token_loop import TokenLoop

    loop = TokenLoop(build_sp_train_setup(cfg, "cpu"), cfg, quiet=True)
    present = [record_masks(loop.step(), cfg.num_workers)["present"]
               for _ in range(2)]
    assert present[0] == (True,) * cfg.num_workers
    assert present[1] == tuple(w != 1 for w in range(cfg.num_workers))
