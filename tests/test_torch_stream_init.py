"""The initial parameters from the reference's key chain, with no
parameter handed in: the port's ``models.layers.init_params`` at a seed
against Flax's ``model.init`` at ``key(seed)`` (``{"params": key(seed),
"dropout": fold_in(key(seed), 1)}`` for a CNN, ``{"params": key(seed)}``
for the LM), for LeNet, FC, ResNet-18, VGG-11 and a 2-layer
TransformerLM, leaf for leaf: within 1e-6·σ of the leaf, σ its
initialiser's scale (√(1/fan_in) / 0.8796 for a kernel, √(1/dim) for the
embedding; measured ≤ 5.1e-7·σ: the truncated normal's erfinv); biases
and scales exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from draco_tpu.models import build_model as jax_build_model
from draco_tpu.models import input_shape
from draco_tpu.models.transformer import TransformerLM as JaxLM
from draco_tpu_torch import params as params_mod
from draco_tpu_torch.models import build_model
from draco_tpu_torch.models.layers import init_params
from draco_tpu_torch.models.transformer import TransformerLM

torch.set_num_threads(1)

SEED = 428

CNNS = {"LeNet": "synthetic-cifar10", "FC": "synthetic-mnist",
        "ResNet18": "synthetic-cifar10", "VGG11": "synthetic-cifar10"}


def _scale(name: str, leaf: np.ndarray) -> float:
    """The leaf's initialiser scale σ (Flax layout)."""
    if name.endswith("embedding"):
        return float(np.sqrt(1.0 / leaf.shape[-1]))
    return float(np.sqrt(1.0 / np.prod(leaf.shape[:-1])) / 0.87962566103423978)


@pytest.mark.parametrize("network", sorted(CNNS) + ["TransformerLM"])
def test_initial_parameters_are_flax_init(network):
    root = jax.random.key(SEED)
    if network == "TransformerLM":
        jm = JaxLM(vocab=64, dim=32, heads=2, layers=2)
        tm = TransformerLM(vocab=64, dim=32, heads=2, layers=2)
        # jitted: op by op the LM's init compiles for seconds on the CPU
        ref = jax.jit(jm.init)({"params": root}, jnp.zeros((2, 8), jnp.int32))
    else:
        ds = CNNS[network]
        jm, tm = jax_build_model(network), build_model(network, ds)
        ref = jm.init({"params": root, "dropout": jax.random.fold_in(root, 1)},
                      jnp.zeros((2,) + input_shape(ds)), train=True)
    init_params(tm, SEED)
    want, _ = params_mod.from_jax(jax.device_get(ref["params"]))
    lay = params_mod.layout(tm)
    assert set(want) == {k for k, _ in tm.named_parameters()}
    for name, kind in zip(lay.names, lay.kinds):
        got = dict(tm.named_parameters())[name].detach()
        w = want[name]
        assert got.shape == w.shape, name
        if kind == params_mod.SAME and not name.endswith("embed.weight"):
            assert torch.equal(got, w), name  # biases 0, scales 1
            continue
        jleaf = params_mod.to_jax_layout(w, kind).numpy()
        sd = _scale("embedding" if name.endswith("embed.weight") else name,
                    jleaf)
        err = (got - w).abs().max().item()
        assert err <= 1e-6 * sd, (name, err / sd)
