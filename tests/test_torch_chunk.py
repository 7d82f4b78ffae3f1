"""The port's K-fused chunk on the CPU (``steps_per_call`` K > 1): the
chunk's plain version — the cursor-indexed step run k times from the
chunk's staging buffers — against k eager steps of the same setup, and
the pieces around it. No JAX here (``test_torch_chunk_parity.py`` holds
the chunk to the reference).

Tolerances. The chunk and the eager loop run the same step body on the
same inputs on one device, so everything is exact: parameters, momentum
buffers, BN statistics and every metric row equal (``torch.equal``, which
holds +0 and −0 equal: the chunk makes its momentum buffers as zeros
before its first step, μ·0 + g, where the eager first step clones g); the
metrics.jsonl rows equal apart from ``step_ms``. The ResNet-18 legs'
counterparts are in ``test_torch_chunk_{simulate,int8,cnn}.py``, one
file a leg or two, each under about 90 s on one core.
"""

import json
import threading

import numpy as np
import pytest
import torch

from draco_tpu_torch import optim, rng
from draco_tpu_torch.analysis import program_lint, registry
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.data import batching, datasets
from draco_tpu_torch.data.prefetch import (
    ChunkPrefetcher,
    PrefetchStallError,
    TokenChunkPrefetcher,
)
from draco_tpu_torch.parallel.sp_step import build_sp_train_setup
from draco_tpu_torch.parallel.sp_step import synthetic_text
from draco_tpu_torch.parallel.token_loop import TokenLoop
from draco_tpu_torch.training.chunk_graph import Chunk, StepGraph, warm_up
from draco_tpu_torch.utils.metrics import host_rows

torch.set_num_threads(1)

SEED = 428
RANGES = [(1, 3), (4, 1)]  # a chunk of K=3 and a remainder chunk of 1
LM = dict(network="TransformerLM", dataset="synthetic-text", lr=0.01,
          momentum=0.9, num_workers=8, worker_fail=1, err_mode="rev_grad",
          batch_size=2, seq_len=16, vocab=32, model_dim=32, model_heads=2,
          model_layers=2, max_steps=7, train_dir="", seed=SEED,
          steps_per_call=3)
LM_LEGS = {
    "shared": dict(approach="cyclic", redundancy="shared"),
    "simulate": dict(approach="cyclic", redundancy="simulate",
                     attn_impl="flash"),
    "geomedian": dict(approach="baseline", mode="geometric_median",
                      geomedian_iters=8),
}


# --------------------------------------------------------------------------
# the chunk against the eager steps (shared by the ResNet files)
# --------------------------------------------------------------------------

def state_copy(state) -> dict:
    return {k: v.detach().clone() for k, v in state.tensors().items()}


def assert_same_state(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def run_eager(build, steps: int) -> tuple:
    """``steps`` eager steps of a fresh ``build()`` -> (setup, runner): the
    metrics of each step (floats) and the final state."""
    setup, runner = build()
    rows = []
    for _ in range(steps):
        rows.append(runner.step())
    return rows, state_copy(setup.state)


def run_chunks(build, chunk_of, ranges) -> tuple:
    """The same steps as chunks of a fresh setup: the block rows with the
    host columns merged, and the final state."""
    setup, runner = build()
    many = getattr(setup, "train_many", None) or setup.train_token_many
    rows = []
    for rng_ in ranges:
        chunk = chunk_of(runner, rng_)
        _, block = many(setup.state, chunk)
        assert block.shape == (chunk.k, len(setup.block_names))
        # the host's rows as a flush makes them: mask columns as words
        for i, vals in enumerate(host_rows(block, setup.block_names)):
            row = dict(zip(setup.block_names, vals))
            row.update({k: v[i] for k, v in chunk.host.items()})
            rows.append(row)
    assert setup.state.step == ranges[-1][0] + ranges[-1][1]
    return rows, state_copy(setup.state)


def assert_chunk_equals_eager(build, chunk_of, ranges=RANGES) -> None:
    steps = sum(k for _, k in ranges)
    eager_rows, eager_state = run_eager(build, steps)
    chunk_rows, chunk_state = run_chunks(build, chunk_of, ranges)
    assert_same_state(chunk_state, eager_state)
    assert len(chunk_rows) == steps
    for e, c in zip(eager_rows, chunk_rows):
        assert c == {k: e[k] for k in c}, (e, c)


# --------------------------------------------------------------------------
# the LM chunk
# --------------------------------------------------------------------------

def lm_build(kw):
    def build():
        cfg = TrainConfig(**kw)
        setup = build_sp_train_setup(cfg, device="cpu")
        return setup, TokenLoop(setup, cfg, quiet=True)
    return build


def lm_chunk(loop, rng_):
    start, k = rng_
    toks = [loop.inputs(s)[0] for s in range(start, start + k)]
    return loop.setup.make_chunk(
        start, None if toks[0] is None else np.stack(toks),
        loop.adv_schedule[start:start + k])


@pytest.mark.parametrize("leg", sorted(LM_LEGS))
def test_train_token_many_equals_eager_steps(leg):
    assert_chunk_equals_eager(lm_build(dict(LM, **LM_LEGS[leg])), lm_chunk)


def _jsonl(path):
    rows = [json.loads(x) for x in path.read_text().splitlines()]
    for r in rows:
        r.pop("step_ms", None)
    return rows


def test_token_loop_chunked_writes_the_eager_rows(tmp_path):
    """K=3, eval_freq=4, max_steps=7: chunks (1,3) (4,1) (5,3); the same
    metrics.jsonl rows (key order too) and eval records as K=1, apart from
    step_ms."""
    out = {}
    for K in (1, 3):
        d = tmp_path / f"k{K}"
        cfg = TrainConfig(**dict(LM, approach="cyclic", redundancy="shared",
                                 steps_per_call=K, eval_freq=4, log_every=2,
                                 train_dir=str(d)))
        last = TokenLoop(build_sp_train_setup(cfg, "cpu"), cfg,
                         quiet=True).run()
        out[K] = (_jsonl(d / "metrics.jsonl"), last)
    assert out[3][0] == out[1][0]
    assert [list(r) for r in out[3][0]] == [list(r) for r in out[1][0]]
    assert [r["step"] for r in out[1][0]] == [1, 2, 4, 4, 6, 7]
    assert [r.get("split") for r in out[1][0]].count("eval") == 1
    last1, last3 = ({k: v for k, v in r.items() if k != "step_ms"}
                    for r in (out[1][1], out[3][1]))
    assert last3 == last1 and last3["step"] == 7


def test_cli_steps_per_call_on_the_cpu(tmp_path):
    from draco_tpu_torch import cli

    argv = ["--network", "TransformerLM", "--dataset", "synthetic-text",
            "--approach", "cyclic", "--redundancy", "shared",
            "--num-workers", "8", "--worker-fail", "1", "--batch-size", "2",
            "--seq-len", "16", "--model-dim", "32", "--model-heads", "2",
            "--model-layers", "1", "--vocab", "32", "--max-steps", "5",
            "--eval-freq", "0", "--log-every", "1", "--steps-per-call", "4",
            "--train-dir", str(tmp_path), "--device", "cpu"]
    last = cli.main(argv)
    assert last["step"] == 5 and last["det_tp"] == 1
    rows = _jsonl(tmp_path / "metrics.jsonl")
    assert [r["step"] for r in rows] == [1, 2, 3, 4, 5]
    assert tuple(rows[0]) == ("step", "loss", "decode_residual",
                              "located_errors", "det_tp", "det_adv",
                              "wmask_accused0", "wmask_present0",
                              "wmask_adv0")


# --------------------------------------------------------------------------
# the step graph's plain version, the snapshot, SGD
# --------------------------------------------------------------------------

def _toy_graph(K=3):
    """A step that adds its input to a state vector and reports its sum and
    the cursor's row."""
    w = torch.zeros(4)

    def body(inputs):
        w.add_(inputs["x"])
        return torch.stack([w.sum(), inputs["i"].to(torch.float32)])

    return w, StepGraph("toy", torch.device("cpu"), K, ("sum", "i"), body,
                        lambda: {"w": w})


def _toy_chunk(start, k):
    return Chunk(start, k, {"x": torch.ones((k, 4)) * start,
                            "i": torch.arange(start, start + k)})


def test_step_graph_cursor_and_remainder_chunks():
    w, graph = _toy_graph()
    block = graph.run(_toy_chunk(1, 3))
    assert block.tolist() == [[4.0, 1.0], [8.0, 2.0], [12.0, 3.0]]
    assert int(graph.cursor) == 3
    block = graph.run(_toy_chunk(4, 1))  # a remainder chunk: fewer steps
    assert block.tolist() == [[28.0, 4.0]] and int(graph.cursor) == 1
    assert torch.equal(w, torch.full((4,), 7.0))
    with pytest.raises(ValueError, match="K=3"):
        graph.run(_toy_chunk(5, 4))
    with pytest.raises(ValueError, match="inputs"):
        graph.run(Chunk(5, 1, {"x": torch.ones((1, 4))}))
    with pytest.raises(ValueError, match="staged"):
        graph.run(Chunk(5, 1, {"x": torch.ones((1, 5)),
                               "i": torch.arange(1)}))


def test_warm_up_restores_the_state_in_place():
    """A real step (the tiny LM's body, which updates parameters and
    momentum) run by ``warm_up``: afterwards every state tensor holds its
    old values in its old storage."""
    cfg = TrainConfig(**dict(LM, **LM_LEGS["shared"]))
    setup = build_sp_train_setup(cfg, device="cpu")
    state = setup.state
    state.opt.zero_bufs(state.params)
    before = state_copy(state)
    ptrs = {k: v.data_ptr() for k, v in state.tensors().items()}
    chunk = setup.make_chunk(1, synthetic_text(SEED, 1, 8, 2, 16, 32)[None],
                             rng.adversary_schedule(SEED, 3, 8, 1)[1:2])
    inputs = {k: v[0] for k, v in chunk.tensors.items()}
    moved = []

    def step():
        setup.step_body(state, inputs)
        moved.append(any(not torch.equal(v, before[k])
                         for k, v in state.tensors().items()))

    warm_up(step, state.tensors())
    assert moved == [True]  # the step trained
    assert_same_state(state_copy(state), before)
    assert {k: v.data_ptr() for k, v in state.tensors().items()} == ptrs
    assert state.step == 1


def test_sgd_zero_buffers_give_the_first_step():
    """μ·0 + g = g: the first step from zero buffers equals the one that
    clones g (a −0 entry becomes +0, equal under torch.equal)."""
    g = torch.randn(5, 3, generator=torch.Generator().manual_seed(0))
    g[0, 0] = -0.0
    p0 = torch.randn(5, 3, generator=torch.Generator().manual_seed(1))
    runs = []
    for zero in (False, True):
        opt, p = optim.SGD(0.05, 0.9), {"w": p0.clone()}
        if zero:
            opt.zero_bufs(p)
            assert torch.equal(opt.bufs["w"], torch.zeros(5, 3))
        for _ in range(2):
            opt.step(p, {"w": g})
        runs.append((p["w"], opt.bufs["w"]))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    opt = optim.SGD(0.05, 0.0)
    opt.zero_bufs({"w": p0})
    assert opt.bufs is None  # no momentum, no buffers


# --------------------------------------------------------------------------
# prefetchers
# --------------------------------------------------------------------------

def test_prefetchers_give_the_stacked_steps():
    ds = datasets.load_dataset("synthetic-cifar10", synthetic_train=64,
                               synthetic_test=8)
    n, b = 5, 2
    pf = ChunkPrefetcher(
        ds, lambda s, k: batching.indices_cyclic_range(len(ds), s - 1, k, n,
                                                       b, SEED), n, b,
        timeout_s=60)
    tp = TokenChunkPrefetcher(lambda s: synthetic_text(SEED, s, n, b, 8, 16),
                              timeout_s=60)
    ranges = [(1, 3), (4, 3), (7, 1), (2, 2)]  # the last out of sequence
    try:
        for i, rng_ in enumerate(ranges):
            nxt = ranges[i + 1] if i + 1 < len(ranges) else None
            xs, ys = pf.get(rng_, nxt)
            toks = tp.get(rng_, nxt)
            steps = range(rng_[0], rng_[0] + rng_[1])
            per = [batching.gather(ds, batching.indices_cyclic(
                len(ds), s - 1, n, b, SEED), n, b) for s in steps]
            np.testing.assert_array_equal(xs, np.stack([p[0] for p in per]))
            np.testing.assert_array_equal(ys, np.stack([p[1] for p in per]))
            np.testing.assert_array_equal(toks, np.stack(
                [synthetic_text(SEED, s, n, b, 8, 16) for s in steps]))
            assert pf.depth == tp.depth == int(nxt is not None)
    finally:
        pf.close()
        tp.close()


def test_prefetch_stall_and_worker_errors():
    release = threading.Event()
    hung = TokenChunkPrefetcher(lambda s: release.wait(30) and np.zeros(1),
                                timeout_s=0.2)
    with pytest.raises(PrefetchStallError, match="exceeded"):
        hung.get((1, 1))
    release.set()
    hung.close()

    def boom(step):
        raise RuntimeError(f"no step {step}")

    bad = TokenChunkPrefetcher(boom, timeout_s=60)
    with pytest.raises(RuntimeError, match="no step 1"):
        bad.get((1, 2))
    bad.close()


@pytest.mark.parametrize("route", ["cnn", "lm"])
def test_the_chunked_loops_bound_their_prefetch_wait(route):
    """Each loop's prefetcher waits cfg.prefetch_timeout_s at most: a hung
    source stops the run with PrefetchStallError, not a hang, once the
    supervisor's restarts (cfg.prefetch_restarts) are spent."""
    from draco_tpu_torch.training.trainer import Trainer

    release = threading.Event()
    lp = registry.get("shared" if route == "cnn" else "lm_shared_flash")
    cfg = lp.config(False, max_steps=4, steps_per_call=2,
                    prefetch_timeout_s=0.2)
    if route == "cnn":
        ds = datasets.load_dataset("synthetic-cifar10", synthetic_train=64,
                                   synthetic_test=8)
        loop = Trainer(cfg, device="cpu", dataset=ds, quiet=True)
        loop.chunk_indices = lambda start, k: release.wait(30)
    else:
        loop = TokenLoop(build_sp_train_setup(cfg, device="cpu"), cfg,
                         quiet=True)
        loop.text = lambda seed, step: release.wait(30)
    try:
        with pytest.raises(PrefetchStallError, match="exceeded 0.2s"):
            loop.run()
        assert loop.state.step == 1  # nothing trained
    finally:
        release.set()


# --------------------------------------------------------------------------
# configuration, the audit
# --------------------------------------------------------------------------

def test_validate_accepts_every_leg_at_k4():
    for lp in registry.collect():
        for full in (True, False):
            assert lp.config(full, steps_per_call=4).steps_per_call == 4


# reason None: the option validates at K = 4 and a K = 2 chunk of it runs
# (the random attack and the LM's device tokens draw on the device from the
# staged step); a route the option does not apply to keeps the reference's
# refusal
@pytest.mark.parametrize("fields,reason", [
    (dict(err_mode="random"), {"cnn": None, "lm": None}),
    (dict(token_gen="device"),
     {"cnn": "TransformerLM token routes only", "lm": None}),
    (dict(token_gen="disk"), "host|device"),
    (dict(steps_per_call=0), ">= 1"),
], ids=["random", "token_gen_device", "token_gen_unknown", "k0"])
@pytest.mark.parametrize("route", ["cnn", "lm"])
def test_validate_rejects_with_its_reason(route, fields, reason):
    lp = registry.get("shared" if route == "cnn" else "lm_shared_flash")
    lp.config(False, steps_per_call=4).validate()
    if isinstance(reason, dict):
        reason = reason[route]
    if reason is not None:
        with pytest.raises(ValueError, match=reason):
            lp.config(False, **{"steps_per_call": 4, **fields})
        return
    assert lp.config(False, steps_per_call=4, **fields).validate()
    cfg = lp.config(False, max_steps=2, steps_per_call=2, **fields)
    runner = lp.runner(cfg, torch.device("cpu"), False)
    client = runner.chunk_client(1, 2)
    chunk = client.assemble(0, client.ranges)
    _, block = client.dispatch(runner.state, chunk)
    client.cleanup()
    assert chunk.tensors["step"].tolist() == [1, 2]
    if route == "lm":
        assert ("tokens" in chunk.tensors) == (fields.get("token_gen")
                                               != "device")
    assert block.shape[0] == 2 and torch.isfinite(block).all()


def test_the_registry_lists_the_chunked_programs():
    assert [c.name for c in registry.collect_chunks()] == [
        "chunk_simulate", "chunk_lm_shared_flash", "chunk_majvote",
        "chunk_lm_shared_flash_devgen", "chunk_lm_shared_flash_watch",
        "chunk_lm_approx_flash"]
    # the resilience legs' and the autopilot's chunks are selected beside
    # them
    assert {c.name for c in program_lint.select("chunk_")} == {
        "chunk_simulate", "chunk_lm_shared_flash", "chunk_majvote",
        "chunk_lm_shared_flash_devgen", "chunk_lm_shared_flash_watch",
        "chunk_lm_approx_flash", "chunk_simulate_guard_nan", "chunk_approx_guard_watch",
        "chunk_shared_autopilot"}
    for c in registry.collect_chunks():
        cfg = c.config(full=True)
        m = c.manifest(cfg, True)
        assert cfg.steps_per_call == 4 and m.flush_fetches == 1
        assert m.host_syncs == 0 and m.max_peak_bytes > 0
        step = registry.uploads(cfg)
        assert m.h2d_bytes == 4 * sum(step.values())


@pytest.mark.parametrize("name", ["chunk_simulate", "chunk_lm_shared_flash",
                                  "chunk_majvote",
                                  "chunk_lm_shared_flash_devgen",
                                  "chunk_lm_shared_flash_watch",
                                  "chunk_lm_approx_flash"])
def test_chunked_programs_green_on_the_cpu_rules(name):
    """One inspected chunk after a first chunk and its flush, on the CPU
    loop: no would-be sync in the chunk, one fetch in the flush, the state
    in place."""
    torch.manual_seed(0)
    row = program_lint.lint_leg(registry.get(name).build("cpu"))
    assert row["ok"], row
    r = row["rules"]
    assert r["host_traffic"]["syncs"] == 0
    assert r["host_traffic"]["flush"]["fetches"] == 1
    assert r["in_place"]["state_tensors"] > 0
