"""The CPU program lint (``analysis/rules.py``) of the registry's later
legs (from ``lenet_single`` on, the observatory's but: the LM's, the
device draws', the tree topology's and the model-parallel routes'), held
as ``test_torch_audit.py`` holds the earlier ones, in a file of their own
so that xdist's loadfile runs the two halves side by side: no would-be
synchronisation in a step, the state in place, no float64, the int8
wire's payload where the wire is int8.
"""

import pytest

from test_torch_audit import ELSEWHERE, assert_green, lint_rows_of


@pytest.fixture(scope="module")
def lint_rows():
    return lint_rows_of(ELSEWHERE)


@pytest.mark.parametrize("leg", ELSEWHERE)
def test_every_leg_green_on_the_cpu_rules(lint_rows, leg):
    assert_green(lint_rows[leg], leg)
