"""The port's ResNet-18 step under the random attack against the JAX
package's, with no ``noise=`` input: both draw the reference's own numbers,
``normal(random_key(seed, step))`` (the cyclic pair: its split), the port
from the step staged on the device (``ops/draws.py``'s plain version
here). The harness is ``test_torch_step.py``'s: the same weights, batches,
augmentation draws and random projection, one step each at batch 2 per
worker: cyclic ``shared`` at n=8, ``simulate`` at n=5 and the
geometric-median baseline at n=4, each with one random adversary.

Tolerances are ``test_torch_step``'s: the discrete decode columns equal
(the decode removes the adversary's rows whatever their noise), the loss
to 1e-4 relative, the update to 1e-2 in relative L2 norm and the
parameters to 1e-4 of their scale. On the geometric median the noise rows
enter the Weiszfeld weights: the port's normals lie within 3e-5·max(1,
|z|) of the reference's (``test_torch_draws.py``), far inside the update's
tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from draco_tpu.config import TrainConfig as JaxConfig
from draco_tpu.runtime import make_mesh
from draco_tpu.training.step import build_train_setup as jax_setup
from draco_tpu_torch import params as params_mod
from draco_tpu_torch import rng
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.data import batching, datasets
from draco_tpu_torch.training.step import build_train_setup
from test_torch_step import COMMON, SEED, _flat_params, _resync

torch.set_num_threads(1)

LEGS = {
    "shared": dict(approach="cyclic", redundancy="shared", num_workers=8),
    "simulate": dict(approach="cyclic", redundancy="simulate",
                     num_workers=5),
    "geomedian": dict(approach="baseline", mode="geometric_median",
                      num_workers=4, geomedian_iters=8),
}


@pytest.fixture(scope="module")
def ds():
    return datasets.load_dataset("synthetic-cifar10", synthetic_train=256,
                                 synthetic_test=8)


@pytest.fixture(scope="module", params=sorted(LEGS))
def leg(request, ds):
    kw = dict(COMMON, **LEGS[request.param], err_mode="random", batch_size=2)
    n, b, step = kw["num_workers"], kw["batch_size"], 1
    jset = jax_setup(JaxConfig(eval_freq=0, log_every=1000,
                               decode_impl="pallas", **kw), make_mesh(n))
    init = params_mod.from_jax(jax.device_get(jset.state.params),
                               jax.device_get(jset.state.batch_stats))
    tset = build_train_setup(TrainConfig(**kw), device="cpu",
                             dataset_name=ds.name, init=init)
    adv = rng.adversary_schedule(SEED, kw["max_steps"], n, 1)[step]
    pick = (batching.indices_baseline if kw["approach"] == "baseline"
            else batching.indices_cyclic)
    x, y = batching.gather(ds, pick(len(ds), step - 1, n, b, SEED), n, b)
    jstate, jm = jset.train_step(jset.state, jnp.asarray(x), jnp.asarray(y),
                                 jnp.asarray(adv))
    tstate, tm = tset.train_step(tset.state, x, y, adv)
    lay = tset.layout
    rec = {"n": n, "names": tset.metric_names,
           "jax": {k: float(v) for k, v in jm.items()
                   if k in tset.metric_names},
           "port": {k: float(v) for k, v in tm.items()},
           "before": _flat_params(init[0], lay),
           "port_p": _flat_params(tstate.params, lay)}
    rec["jax_p"] = _flat_params(_resync(tstate, jstate), lay)
    return request.param, rec


def test_metric_columns(leg):
    name, rec = leg
    port, ref = rec["port"], rec["jax"]
    assert tuple(port) == rec["names"]
    assert port["loss"] == pytest.approx(ref["loss"], rel=1e-4)
    if name == "geomedian":
        return
    for k in ("honest_located", "located_errors", "det_tp", "det_adv"):
        assert port[k] == ref[k], k
    assert port["honest_located"] == rec["n"] - 2
    assert port["det_tp"] == port["det_adv"] == 1


def test_updates_and_params(leg):
    _, rec = leg
    d_port = rec["port_p"] - rec["before"]
    d_jax = rec["jax_p"] - rec["before"]
    assert np.linalg.norm(d_jax) > 0
    assert np.linalg.norm(d_port - d_jax) <= 1e-2 * np.linalg.norm(d_jax)
    np.testing.assert_allclose(rec["port_p"], rec["jax_p"], rtol=0,
                               atol=1e-4 * np.abs(rec["jax_p"]).max())
