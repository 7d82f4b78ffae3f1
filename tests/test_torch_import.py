"""The PyTorch port imports neither JAX nor the JAX package: a fresh
interpreter imports every module of ``draco_tpu_torch`` and
``chip_smoke``'s imports, then looks at ``sys.modules``."""

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
                "draco_tpu_torch.training.step", "draco_tpu_torch.cli"):
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
