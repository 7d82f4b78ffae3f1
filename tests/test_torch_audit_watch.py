"""The CPU program lint (``analysis/rules.py``) of the observatory's legs
(``numerics_watch=on`` with a shadow decode, ``analysis/registry.py``),
held as ``test_torch_audit.py`` holds every other leg: no would-be
synchronisation in a step, the state in place, no float64, the int8 wire's
payload where the wire is int8 (a shadow rounds in f32 and carries none).
"""

import pytest

from test_torch_audit import WATCH_LEGS, assert_green, lint_rows_of


@pytest.fixture(scope="module")
def lint_rows():
    return lint_rows_of(WATCH_LEGS)


@pytest.mark.parametrize("leg", WATCH_LEGS)
def test_every_leg_green_on_the_cpu_rules(lint_rows, leg):
    assert_green(lint_rows[leg], leg)
