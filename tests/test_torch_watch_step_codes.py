"""The watch step's tests (``test_torch_watch_step.py``, its harness and
tolerances) on the approx code, the repetition code and the LM:

  * ``approx_int8_sr``: the approx code at n=8, r=1.5, 2 stragglers a step,
    the int8 shadow rounded stochastically (its draws at seed + 11);
  * ``majvote_int8``: the repetition code, one group (n=3), the int8
    shadow;
  * ``lm_bf16``: the TransformerLM's cyclic ``shared`` step at 2 layers,
    the bf16 shadow.
"""

import pytest

from test_torch_watch_step import ds, run_leg  # noqa: F401
from test_torch_watch_step import (  # noqa: F401
    test_numerics_columns,
    test_schema_and_masks,
    test_shadow_columns,
    test_the_watch_leaves_the_update_alone,
)


@pytest.fixture(scope="module",
                params=["approx_int8_sr", "lm_bf16", "majvote_int8"])
def leg(request, ds):  # noqa: F811
    return run_leg(request.param, ds)
