"""The port's TransformerLM step on the cyclic code's narrow wire and with
stragglers, against the JAX package's, in the harness of
``test_torch_lm_approx_step.py`` (two steps a leg from the reference's
parameters, at the LM's CI size, n=8, batch 2):

  * ``shared_bf16``, ``shared_int8``: the cyclic ``shared`` code (s=1)
    with a rev_grad adversary every step, its codeword pair on the bf16 /
    int8 wire (block 256), decoded with the wire's flag threshold and
    locator λ; ``shared_bf16_sr`` the bf16 wire rounded stochastically
    (the reference's threefry draws, which the port makes itself);
  * ``shared_drop2``: the cyclic ``shared`` code with no adversary and
    the seeded schedule dropping two workers a step: erasures at the 2s
    budget, zero-filled, the locator given the presence row.

Tolerances as there: the discrete columns (located_errors, det_tp,
det_adv, honest_located's count) and the mask words exact; the loss 1e-4
relative; the residual under the wire's flag threshold on both sides; the
update within 1e-2 relative L2, 5e-2 on the int8 wire.
"""

import pytest
import torch

from draco_tpu_torch.coding.cyclic import HEALTH_REL_TOL
from draco_tpu_torch.obs import numerics
from test_torch_lm_approx_step import LM, assert_common, assert_update, \
    run_both

torch.set_num_threads(1)

CYCLIC = dict(approach="cyclic", redundancy="shared")
LEGS = {
    "shared_bf16": dict(CYCLIC, wire_dtype="bf16"),
    "shared_bf16_sr": dict(CYCLIC, wire_dtype="bf16",
                           shadow_round="stochastic"),
    "shared_int8": dict(CYCLIC, wire_dtype="int8"),
    "shared_drop2": dict(CYCLIC, adversary_count=0, straggle_mode="drop",
                         straggle_count=2),
}
DISCRETE = ("located_errors", "det_tp", "det_adv")


@pytest.fixture(scope="module", params=sorted(LEGS))
def leg(request):
    return request.param, run_both(dict(LM, **LEGS[request.param]))


def test_columns_and_detection(leg):
    name, rec = leg
    assert_common(rec)
    cfg = rec["cfg"]
    tol = (HEALTH_REL_TOL if cfg.wire_dtype == "f32"
           else numerics.wire_rel_tol(8, 1, cfg.wire_dtype))
    for st in rec["steps"]:
        port, ref = st["port"], st["jax"]
        for k in DISCRETE:
            assert port[k] == ref[k], k
        adversaries = cfg.num_adversaries
        assert port["located_errors"] == port["det_tp"] == \
            port["det_adv"] == adversaries
        # n − 2s honest rows: the adversary and a neighbour out, or the
        # two erasures
        assert port["honest_located"] == 6
        assert port["decode_residual"] < tol and ref["decode_residual"] < tol
        if name == "shared_drop2":
            assert int(st["present"].sum()) == 6
        else:
            assert st["present"] is None


def test_update(leg):
    assert_update(leg[1])
