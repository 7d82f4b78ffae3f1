"""The ResNet-18 step on the segmented int8 wire against the JAX
package's: the cyclic code with ``wire_segments=2`` and the approx code
with ``wire_segments=2`` and two stragglers a step, at CI size (n=5, batch
2). The harness and the tolerances are ``test_torch_segments_step.py``'s.
"""

import pytest
import torch

from test_torch_segments_step import (  # noqa: F401 (the ds fixture)
    check_metric_columns,
    check_update,
    ds,
    step_both,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=("seg2_int8", "approx_seg2"))
def leg(request, ds):  # noqa: F811
    return request.param, step_both(request.param, ds)


def test_metric_columns(leg):
    check_metric_columns(leg[1])


def test_update(leg):
    check_update(leg[1])
