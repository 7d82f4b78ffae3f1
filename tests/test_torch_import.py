"""The PyTorch port imports neither JAX nor the JAX package: a fresh
interpreter imports every module of ``draco_tpu_torch`` and
``chip_smoke``'s imports, then looks at ``sys.modules``. Also the
configuration rejections of what the port does not run yet, each with
its reason."""

import json
import os
import pkgutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, json, pkgutil, sys
import draco_tpu_torch
names = ["draco_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(draco_tpu_torch.__path__,
                                          "draco_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # its import block (main() is not run)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "draco_tpu"))
print(json.dumps({"modules": names, "bad": bad}))
"""


@pytest.fixture(scope="module")
def probe():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax(probe):
    assert probe["bad"] == []


def test_every_submodule_imported(probe):
    import draco_tpu_torch

    expected = {"draco_tpu_torch"} | {
        m.name for m in pkgutil.walk_packages(draco_tpu_torch.__path__,
                                              "draco_tpu_torch.")}
    assert set(probe["modules"]) == expected
    for mod in ("draco_tpu_torch.ops.coded", "draco_tpu_torch.ops.decode_kernels",
                "draco_tpu_torch.training.step", "draco_tpu_torch.cli",
                "draco_tpu_torch.ops.controls",
                "draco_tpu_torch.analysis.kernel_audit",
                "draco_tpu_torch.analysis.registry",
                "draco_tpu_torch.analysis.rules",
                "draco_tpu_torch.analysis.controls",
                "draco_tpu_torch.analysis.program_lint",
                "draco_tpu_torch.obs.tracer",
                "draco_tpu_torch.obs.trace_report",
                "draco_tpu_torch.obs.step_ab",
                "draco_tpu_torch.training.chunk_graph",
                "draco_tpu_torch.control.engine",
                "draco_tpu_torch.control.clients",
                "draco_tpu_torch.data.prefetch",
                "draco_tpu_torch.utils.metrics",
                "draco_tpu_torch.coding.repetition",
                "draco_tpu_torch.ops.vote",
                "draco_tpu_torch.aggregation",
                "draco_tpu_torch.attacks"):
        assert mod in expected


def test_port_source_names_no_jax():
    """No source file of the port even mentions an import of JAX or of the
    JAX package (a lazy import inside a function would escape the probe)."""
    pkg = os.path.join(ROOT, "draco_tpu_torch")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, fs in os.walk(pkg):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    for path in files:
        for line in open(path, encoding="utf-8"):
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1].split(".")[0]
                assert mod not in ("jax", "jaxlib", "flax", "optax",
                                   "draco_tpu"), f"{path}: {s}"


VOTE = dict(network="ResNet18", dataset="synthetic-cifar10",
            approach="maj_vote", num_workers=9, group_size=3, worker_fail=1)


# reason None: the vote's narrow wire, which validates now, and whose rows
# (stochastically rounded, one draw shared by the rows) the vote runs on
@pytest.mark.parametrize("override,reason", [
    (dict(network="TransformerLM", dataset="synthetic-text"),
     "not supported for TransformerLM"),
    (dict(wire_dtype="bf16", shadow_round="stochastic"), None),
    (dict(wire_dtype="int8", shadow_round="stochastic"), None),
    (dict(straggle_mode="drop", straggle_count=1), "joint budget"),
    (dict(worker_fail=0, straggle_mode="drop", straggle_count=3),
     "silence an entire repetition group"),
], ids=["vote_on_the_lm", "vote_bf16_wire", "vote_int8_wire",
        "vote_joint_budget", "vote_group_silenced"])
def test_config_rejects_with_its_reason(override, reason):
    import torch

    from draco_tpu_torch.coding import repetition
    from draco_tpu_torch.config import TrainConfig
    from draco_tpu_torch.obs import numerics

    TrainConfig(**VOTE).validate()
    if reason is not None:
        with pytest.raises(ValueError, match=reason):
            TrainConfig(**{**VOTE, **override}).validate()
        return
    cfg = TrainConfig(**{**VOTE, **override}).validate()
    g = torch.Generator().manual_seed(0)
    rows = torch.randn(3, 777, generator=g).repeat_interleave(3, dim=0)
    rows[4] *= -100.0  # one adversary in group 1
    mode, buf, block = numerics.narrow_wire_single(
        cfg, rows, torch.tensor(3, dtype=torch.int32))
    wide = numerics.widen_wire_rows(buf, mode, block)
    voted, health = repetition.majority_vote(
        repetition.build_repetition_code(9, 3), wide, with_health=True)
    assert float(health["vote_agree"]) == pytest.approx(8 / 9)
    assert torch.equal(voted, wide[[0, 3, 6]].mean(0))
