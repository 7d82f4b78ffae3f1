"""The port's coded steps against the JAX package's ``train_step``:
``lenet_simulate`` (preset cyclic-vgg11's code, n=9, s=2, on 45 LeNet
lanes), ``vgg_simulate`` (VGG-11 at n=5, s=1) and ``single_lenet`` (n=1),
at batch 2 on a one-device mesh, with the tolerances and the reference's
own draws and dropout masks of ``test_torch_vgg_step.py``, whose tests
this file runs on its legs.
"""

import pytest
from test_torch_vgg_step import (  # noqa: F401  (the tests and fixture)
    data,
    run_leg,
    test_metric_columns,
    test_updates_and_params,
)


@pytest.fixture(scope="module",
                params=["lenet_simulate", "single_lenet", "vgg_simulate"])
def leg(request, data):  # noqa: F811
    return run_leg(request.param, data)
