"""The LM's approx code, narrow wire and stragglers through the port's token
loop, and its robust baselines over the present rows against the JAX
package's step.

The chunked loop: K=1 (the eager loop) and K=4 (chunks snapped to the
eval boundary at 3: 3, 3, 1) agree bit for bit — every column of every
written record but the wall clock's ``step_ms``, the eval records, and
the final parameters — on the approx code with two drops a step and the
watch with its bf16 shadow (the reference's ``approx`` route of
``tests/test_chunked_token_loop.py``), and on the cyclic code's int8 wire
with a rev_grad adversary and the watch on. The K=4 run's records and
status.json then meet the reference's ``_assert_route_telemetry`` rules:
on approx the residual within its bound, 0 < recovered_fraction ≤ 1, no
detection columns, the present word the straggler schedule's row, no
accused worker, and status.json's forensics block with no accusation, no
episode and full trust; on the cyclic code located_errors = det_tp =
det_adv = the adversaries present, the accused word the adversary's; on
both, no guard trip and no incident. At the LM's CI size
(``analysis/registry.LM_CI``, n=8, batch 2).

The baselines: ``geomedian`` and ``krum`` with the seeded schedule
dropping one worker a step, two steps against the reference's
(``test_torch_lm_approx_step.run_both``): the loss 1e-4 relative, the
update within 1e-2 relative L2.
"""

import json
import os

import pytest
import torch

from draco_tpu_torch import rng
from draco_tpu_torch.analysis.registry import APPROX
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.obs import forensics
from draco_tpu_torch.parallel.common import token_metric_names
from draco_tpu_torch.parallel.sp_step import build_sp_train_setup
from draco_tpu_torch.parallel.token_loop import TokenLoop
from test_torch_lm_approx_step import LM, assert_common, assert_update, \
    run_both

torch.set_num_threads(1)

SEED = 428
WATCH = dict(numerics_watch="on", step_guard="on", incident_watch="on")
ROUTES = {
    "approx": dict(APPROX, straggler_alpha=0.25, shadow_wire="bf16",
                   **WATCH),
    "cyclic_int8": dict(approach="cyclic", redundancy="shared",
                        wire_dtype="int8", **WATCH),
}


def run_loop(kw, k, d):
    cfg = TrainConfig(**dict(LM, **kw, max_steps=7, eval_freq=3,
                             log_every=1, steps_per_call=k,
                             train_dir=d)).validate()
    loop = TokenLoop(build_sp_train_setup(cfg, "cpu"), cfg, quiet=True)
    last = loop.run()
    with open(os.path.join(d, "metrics.jsonl")) as f:
        recs = [json.loads(x) for x in f]
    params = torch.cat([p.reshape(-1) for p in loop.state.params.values()])
    return cfg, recs, params, last


@pytest.fixture(scope="module", params=sorted(ROUTES))
def route(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(request.param)
    runs = {k: run_loop(ROUTES[request.param], k, str(root / f"k{k}"))
            for k in (1, 4)}
    return request.param, runs, str(root / "k4")


def test_chunked_equals_eager_bitwise(route):
    _, runs, _ = route
    (cfg, recs1, p1, last1), (_, recs4, p4, last4) = runs[1], runs[4]
    assert torch.equal(p1, p4)

    def strip(recs):
        return [{k: v for k, v in r.items() if k != "step_ms"} for r in recs]

    assert strip(recs1) == strip(recs4)
    assert [r["step"] for r in recs4 if "split" not in r] == list(
        range(1, 8))
    assert [r["step"] for r in recs4 if r.get("split") == "eval"] == [3, 6]
    # a written record keeps the LM schema's columns (no presence count)
    for r in recs4:
        if "split" not in r:
            assert tuple(r) == (("step",) + token_metric_names(cfg)
                                + ("step_ms",))
    assert last1["loss"] == last4["loss"]


def test_route_telemetry(route):
    """The reference's ``_assert_route_telemetry`` rules on the K=4 run."""
    name, runs, d = route
    cfg, recs, _, _ = runs[4]
    n = cfg.num_workers
    adv = rng.adversary_schedule(SEED, 8, n, cfg.num_adversaries)
    strag = rng.straggler_schedule(SEED, 8, n, cfg.straggle_count)
    train = [r for r in recs if "split" not in r]
    for r in train:
        assert r["guard_trips"] == 0.0 and r["skipped_steps"] == 0.0, r
        assert r["nx_wire_absmax"] > 0 and r["nx_grad_nonfinite"] == 0.0
        masks = forensics.record_masks(r, n)
        assert masks["present"] == tuple(~strag[r["step"]])
        assert masks["adv"] == tuple(adv[r["step"]])
        assert masks["accused"] == tuple(adv[r["step"]] & ~strag[r["step"]])
    with open(os.path.join(d, "status.json")) as f:
        status = json.load(f)
    assert status["schema"] == 5 and status["state"] == "done"
    assert status["guard"] == {"trips": 0.0, "skipped_steps": 0.0}
    inc = status["incidents"]
    assert inc["total"] == 0 and inc["open"] == [] and inc["by_type"] == {}
    assert not os.path.exists(os.path.join(d, "incidents.jsonl"))
    fxb = status["forensics"]
    if name == "approx":
        for r in train:
            assert r["decode_residual"] <= r["decode_residual_bound"] + 1e-5
            assert 0.0 < r["recovered_fraction"] <= 1.0
            assert "det_tp" not in r and "located_errors" not in r
            assert r["shadow_flag_agree"] == 1.0
            assert r["shadow_det_flagged"] == 0.0
            assert 0.0 <= r["shadow_err"] < 0.05, r
        health = status["decode_health"]
        assert health["decode_residual"] <= \
            health["decode_residual_bound"] + 1e-5
        # absence decays nothing: no accusation, no episode, full trust
        assert fxb["accused_total"] == 0 and fxb["episodes_total"] == 0
        assert fxb["trust"] == [1.0] * n
        return
    for r in train:
        want = int((adv[r["step"]] & ~strag[r["step"]]).sum())
        assert r["det_adv"] == r["det_tp"] == r["located_errors"] == want
        assert want == 1
    health = status["decode_health"]
    assert health["precision"] == 1.0 and health["recall"] == 1.0
    assert fxb["num_workers"] == n and fxb["accused_total"] > 0


BASELINES = {
    "geomedian_drop1": dict(approach="baseline", mode="geometric_median",
                            geomedian_iters=8),
    "krum_drop1": dict(approach="baseline", mode="krum"),
}


@pytest.fixture(scope="module", params=sorted(BASELINES))
def baseline(request):
    kw = dict(LM, **BASELINES[request.param], straggle_mode="drop",
              straggle_count=1)
    return request.param, run_both(kw)


def test_baseline_over_the_present_rows(baseline):
    _, rec = baseline
    assert_common(rec)
    assert rec["names"] == ("loss",)
    for st in rec["steps"]:
        assert int(st["present"].sum()) == 7
    assert_update(rec)

