"""The autopilot's straggler ladder on the CNN Trainer, the port's against
the JAX package's, as ``test_torch_autopilot_cnn.py`` compares the
lifecycle (FC on synthetic MNIST, n=8, K=4, 20 steps, worker 5 straggling
at steps 5-12, ``straggle.streak=2``):

  * the segment dial (the reference's ``tests/test_segments.py``
    scenario): segments_up to cyclic_r3_seg2 (``"compiled"``), then
    segments_down back to cyclic_r3, the wire ledger back to one segment;
  * the fanout dial (the reference's ``tests/test_tree.py`` scenario, the
    tree at fanout 4, s=0): fanout_down to cyclic_r1_g2, then fanout_up
    back to cyclic_r1_g4, the wire ledger back to fanout 4.

Each: the remediation lines and the control block equal the reference's
but for ``ts``, every step's mask words exactly, the update's columns
within 1e-5, one step graph a regime on the Trainer's state.
"""

import json
import os

import pytest

from test_torch_autopilot_cnn import (
    FC,
    assert_one_graph_a_regime,
    assert_same_records,
    assert_same_remediations,
    run_both,
)

DIALS = dict(FC, max_steps=20, fault_spec="straggle@5-12:w5")
SEGMENTS = dict(DIALS, autopilot_policy=(
    "segments_up_boundaries=1,segments_max=2,segments_down_boundaries=1,"
    "dial_down_boundaries=99,clean_boundaries=99"))
FANOUT = dict(DIALS, worker_fail=0, topology="tree", tree_fanout=4,
              autopilot_policy=(
                  "fanout_down_boundaries=1,fanout_up_boundaries=1,"
                  "segments_up_boundaries=99,dial_down_boundaries=99,"
                  "clean_boundaries=99"))
CASES = {
    "segments": (SEGMENTS, ["segments_up", "segments_down"],
                 ("cyclic_r3", "cyclic_r3_seg2")),
    "fanout": (FANOUT, ["fanout_down", "fanout_up"],
               ("cyclic_r1_g4", "cyclic_r1_g2")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_dial_goes_and_returns_as_the_references(tmp_path, case):
    fields, actions, regimes = CASES[case]
    ref_dir, port_dir, tr, _ = run_both(tmp_path, fields)
    rems = assert_same_remediations(ref_dir, port_dir)
    assert [e["action"] for e in rems] == actions
    assert [e["regime"]["tag"] for e in rems] == list(regimes[::-1])
    assert rems[0]["evidence"]["executable"] == "compiled"
    assert rems[0]["trigger"]["type"] in ("straggle", "starvation")
    assert_same_records(ref_dir, port_dir, 8)
    assert_one_graph_a_regime(tr, regimes)
    with open(os.path.join(port_dir, "status.json")) as f:
        st = json.load(f)
    assert st["control"]["regime"]["tag"] == regimes[0]
    assert st["control"]["swaps"] == 2
    # the wire ledger re-stamped back to the configured shape
    if case == "segments":
        assert st["wire"]["segments"]["count"] == 1
    else:
        assert st["wire"]["tree"]["fanout"] == 4
