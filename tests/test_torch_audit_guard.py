"""The CPU program lint (``analysis/rules.py``) of the resilience legs
(``registry.GUARD_PROGRAMS``: the step guard and a seeded fault plan) and
of the guarded approx code's chunk, held as ``test_torch_audit.py`` holds
every other leg: no would-be synchronisation in a step (the fault plan's
events on the device from setup, the guard's verdict a device bool), the
state in place under the gated update, no float64; the chunk's flush one
fetch with the incident engine folding its records. Each guarded leg's
manifest is its twin's, the approx certificate's staged bound aside. (The
guarded flagship, ``simulate_guard_nan``, and its chunk are linted at full
width on the card, ``chip_smoke.py``: its 15 ResNet-18 lanes make the
slowest CPU step.)
"""

import pytest
import torch

from draco_tpu_torch.analysis import program_lint, registry, rules
from test_torch_audit import CPU, assert_green, lint_rows_of

torch.set_num_threads(1)

GUARD_LEGS = tuple(p.name for p in registry.GUARD_PROGRAMS)
CPU_LEGS = tuple(leg for leg in GUARD_LEGS if leg != "simulate_guard_nan")
CHUNK = "chunk_approx_guard_watch"


@pytest.fixture(scope="module")
def lint_rows():
    rows = lint_rows_of(CPU_LEGS)
    torch.manual_seed(0)
    rows[CHUNK] = program_lint.lint_leg(registry.get(CHUNK).build(CPU))
    return rows


@pytest.mark.parametrize("leg", CPU_LEGS)
def test_every_guard_leg_green_on_the_cpu_rules(lint_rows, leg):
    assert_green(lint_rows[leg], leg)


@pytest.mark.parametrize("leg", GUARD_LEGS)
def test_a_guard_legs_manifest_is_its_twins(leg):
    twin = registry.GUARD_TWINS[leg]
    cfg, tcfg = (registry.get(x).config(True) for x in (leg, twin))
    assert cfg.step_guard == "on" and tcfg.step_guard == "off"
    assert cfg.fault_spec and not tcfg.fault_spec
    extra = 4 if cfg.approach == "approx" else 0
    m, tm = (registry.get(leg).manifest(cfg, True),
             registry.get(twin).manifest(tcfg, True))
    assert m.h2d_bytes == tm.h2d_bytes + extra
    assert (m.host_syncs, m.collectives, m.in_place) == (
        tm.host_syncs, tm.collectives, tm.in_place)


def test_the_guarded_chunk_flushes_once_with_the_engine(lint_rows):
    row = lint_rows[CHUNK]
    assert_green(row, CHUNK)
    assert row["rules"]["host_traffic"]["flush"]["fetches"] == 1
    assert registry.get(CHUNK).config().incident_watch == "on"
    assert rules.twin_failures(row, row) == []
