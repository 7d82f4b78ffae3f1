"""The port's static audit on the CPU (no card here).

* The mis-tiled control's plain version against the same ``pallas_call``
  geometry as the TPU lowering audit's negative control ``bad``
  (tools/tpu_attn_lowering_check.py:107-121, local to its ``main()``, so
  rebuilt here) run by JAX in interpret mode: 576 outputs left NaN, the
  (16, 12) first column block equal to x, the two equal with NaN in the
  same places.
* The kernel audit's coverage rule (poisoned, guarded outputs) trips on
  that control and passes on the plain versions of the sixteen main-path
  kernels at ragged shapes (the segment kernels with tiny and unaligned
  segments, the approx decode's offset entry on views off a strip).
* The program lint at CI size: every registered leg green on the CPU
  rules, every CPU control tripping exactly its rule, the honest miniature
  green (the legs from ``lenet_single`` on in ``test_torch_audit_legs.py``,
  the observatory's in ``test_torch_audit_watch.py``); the registry covers
  the legs ``chip_smoke.py`` drives, each segmented leg beside its S = 1
  twin, each model-parallel leg on its own route.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from draco_tpu_torch.analysis import controls as lint_controls
from draco_tpu_torch.analysis import kernel_audit, program_lint, registry
from draco_tpu_torch.analysis import rules
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.ops import controls

CPU = torch.device("cpu")
MAIN_KERNELS = ("complex_matmul", "complex_project", "complex_recombine",
                "cyclic_locator", "cyclic_narrow_recombine", "approx_decode",
                "flash_fwd", "flash_dq", "flash_dkv", "row_fingerprints",
                "complex_project_segments", "complex_recombine_segments",
                "cyclic_narrow_recombine_segments", "random_inject",
                "round_draw", "synthetic_text", "augment_draws",
                "dropout_keep", "vote_salts", "stage_stats",
                "nonfinite_rows")
LEGS = ("simulate", "geomedian", "shared", "approx", "approx_int8",
        "shared_bf16", "shared_int8", "majvote", "krum", "lm_shared_flash",
        "lm_simulate_flash", "lm_geomedian_flash", "shared_layer",
        "shared_int8_seg4", "approx_int8_seg4", "lm_shared_flash_layer",
        "vgg11_simulate", "vgg11_shared", "lenet_single", "shared_c16",
        "lm_shared_flash_adamw", "vgg11_random", "shared_int8_sr",
        "majvote_bf16_sr", "majvote_random", "lm_shared_flash_devgen",
        "shared_tree_g8", "shared_int8_tree_g8", "approx_tree_g3",
        "lm_shared_flash_tree_g4", "simulate_watch_bf16",
        "approx_watch_int8_sr", "majvote_shadow_int8",
        "lm_shared_flash_watch", "lm_approx_flash",
        "lm_approx_int8_sr_flash", "lm_shared_int8_flash",
        "lm_shared_flash_drop2", "lm_shared_flash_remat",
        "lm_shared_flash_scan", "lm_big_shared_flash", "lm_sp4_ring_flash",
        "lm_sp4_a2a_flash", "lm_shared_dense", "lm_shared_dense_tp2",
        "lm_shared_flash_pp2", "lm_shared_dense_moe4",
        "lm_shared_dense_moe4_ep2")
# the legs' workers at full width: presets rep-resnet18 and cyclic-vgg11
# (n=9), single-lenet (n=1), the ResNet tree legs (n=16), the approx tree
# (n=9), the others n=8
FULL_N = {"majvote": 9, "vgg11_simulate": 9, "vgg11_shared": 9,
          "lenet_single": 1, "vgg11_random": 9, "majvote_bf16_sr": 9,
          "majvote_random": 9, "shared_tree_g8": 16,
          "shared_int8_tree_g8": 16, "approx_tree_g3": 9,
          "majvote_shadow_int8": 9}


def _bad(x):
    """The TPU lowering audit's mis-tiled pallas_call, in interpret mode."""
    def kern(x_ref, o_ref):
        o_ref[...] = x_ref[...]

    return pl.pallas_call(
        kern, grid=(4,),
        in_specs=[pl.BlockSpec((4, 12), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((4, 12), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((16, 48), jnp.float32),
        interpret=True)(x)


def test_mistiled_plain_matches_the_pallas_geometry():
    x = np.random.RandomState(0).normal(size=(16, 48)).astype(np.float32)
    ref = np.asarray(_bad(jnp.asarray(x)))
    port = controls.control_mistiled_copy(torch.from_numpy(x)).numpy()
    assert np.isnan(ref).sum() == np.isnan(port).sum() == 576
    np.testing.assert_array_equal(port, ref)  # NaN in the same places
    np.testing.assert_array_equal(port[:, :12], x[:, :12])


def test_controls_plain_versions():
    rng = np.random.RandomState(1)
    n = 70
    x = torch.from_numpy(rng.randint(-8, 8, n).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, 1 << 20, n).astype(np.int32))
    want = np.zeros(n, np.float32)
    for i in range(n):
        live = [x[(i + k) % n].item() * (k + 1) for k in range(64)]
        want[i] = sum(live[idx[(i + k) % n].item() & 63] for k in range(64))
    np.testing.assert_array_equal(controls.control_spill(x, idx).numpy(),
                                  want)
    out = controls.control_overlaunch(torch.zeros(5))
    assert torch.equal(out, torch.ones(5))
    with pytest.raises(ValueError):
        controls.control_mistiled_copy(torch.zeros(16, 47))


@pytest.mark.parametrize("name", MAIN_KERNELS)
def test_coverage_passes_on_the_plain_versions(name):
    res = kernel_audit.rule_coverage(kernel_audit.spec(name), CPU)
    assert res["ok"], res
    assert res["unwritten"] == res["guard_touched"] == 0
    assert all(o["elements"] > 0 for c in res["cases"]
               for o in c["outputs"].values())


def test_coverage_trips_on_the_mistiled_control():
    res = kernel_audit.rule_coverage(
        kernel_audit.spec("control_mistiled_copy"), CPU)
    assert not res["ok"]
    assert res["unwritten"] == 576 and res["guard_touched"] == 0


def test_coverage_counts_a_guard_write():
    buf, view = kernel_audit._guarded((3, 4), torch.float32, CPU)
    view.fill_(1.0)
    assert kernel_audit._verdict(buf, 12) == (0, 0)
    buf[kernel_audit.GUARD + 12] = 0.0  # one past the end
    buf[kernel_audit.GUARD + 2] = float("nan")  # a written NaN counts
    assert kernel_audit._verdict(buf, 12) == (0, 1)
    buf, view = kernel_audit._guarded((5,), torch.uint8, CPU)
    view[:4] = 1
    assert kernel_audit._verdict(buf, 5) == (1, 0)


def test_kernel_audit_report_on_the_cpu(tmp_path):
    out = tmp_path / "kernel_audit.json"
    report = kernel_audit.run_audit("cpu", str(out))
    assert report["all_ok"]
    rows = {r["name"]: r for r in json.loads(out.read_text())["rows"]}
    assert list(rows) == [s.name for s in kernel_audit.SPECS]
    assert len(rows) == 24
    mis = rows["control_mistiled_copy"]
    assert mis["failed_rules"] == ["coverage"]
    assert mis["plain"]["bitwise_equal"]
    assert mis["replaces"] == "tools/tpu_attn_lowering_check.py:111"


_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                     r"\s+)?(\w+)\s*\(")
_ENTRY = re.compile(r'\{"([^"]+)",\s*\(const void\*\)([\w<>:]+)')


@pytest.mark.parametrize("source", sorted(
    {s.source for s in kernel_audit.SPECS}))
def test_audit_table_lists_every_global_function(source):
    """Each source's resource-query table (the names the audit reads from
    the built library) names every ``__global__`` function of the source,
    each entry the function it points at, and the specs of that source
    cover exactly the table."""
    from draco_tpu_torch import _build

    text = (_build.PKG_DIR / "csrc" / f"{source}.cu").read_text()
    globals_ = set(_GLOBAL.findall(text))
    entries = _ENTRY.findall(text)
    assert globals_ and entries
    assert all(name == fn for name, fn in entries), entries
    table = [name for name, _ in entries]
    assert {t.split("<")[0] for t in table} == globals_
    specs = [f for s in kernel_audit.SPECS if s.source == source
             for f in s.functions]
    assert sorted(specs) == sorted(table)


_REFUSED = """========= COMPUTE-SANITIZER
========= Error: Device not supported. Please refer to the "Supported \
Devices" section of the sanitizer documentation
=========
========= Program hit cudaErrorUnknown (error 999) due to "unknown error" on \
CUDA API call to cudaMalloc.
========= Target application returned an error
========= ERROR SUMMARY: 3 errors
""".replace("\\\n", "")
_CLEAN = """========= COMPUTE-SANITIZER
sanitizer child: ok complex_matmul
sanitizer child: ok flash_fwd
sanitizer child: ok control_spill
sanitizer child: done
========= ERROR SUMMARY: 0 errors
"""
_NAMED = """========= COMPUTE-SANITIZER
sanitizer child: ok complex_matmul
========= Invalid __global__ write of size 4 bytes
=========     at flash_fwd_kernel<64>(const float *, const float *)+0x1a0
=========     by thread (3,0,0) in block (1,0,0)
sanitizer child: ok flash_fwd
sanitizer child: ok control_spill
sanitizer child: done
========= ERROR SUMMARY: 1 error
"""
_CRASHED = """========= COMPUTE-SANITIZER
sanitizer child: ok complex_matmul
========= Invalid __global__ read of size 4 bytes
=========     at 0x1a0 in an unnamed function
========= Target application returned an error
========= ERROR SUMMARY: 2 errors
Traceback (most recent call last):
torch.AcceleratorError: CUDA error: unspecified launch failure
"""
_DIED = """========= COMPUTE-SANITIZER
sanitizer child: ok complex_matmul
Segmentation fault
"""
_RACE = """========= COMPUTE-SANITIZER
sanitizer child: ok complex_matmul
========= Error: Race reported between Write access at flash_fwd_kernel<64>\
(const float *)+0x2b0 and Read access at flash_fwd_kernel<64>(const float *)
sanitizer child: ok flash_fwd
sanitizer child: ok control_spill
sanitizer child: done
========= RACECHECK SUMMARY: 1 hazard displayed (1 error, 0 warnings)
""".replace("\\\n", "")
_RUN = ["complex_matmul", "flash_fwd", "control_spill"]


@pytest.mark.parametrize("text,timed_out,ran,errors,failed,completed", [
    (_REFUSED, False, False, None, None, False),
    (_CLEAN, False, True, 0, [], True),
    (_NAMED, False, True, 1, ["flash_fwd"], True),
    (_CRASHED, False, True, 2, _RUN, False),
    (_DIED, False, True, None, ["flash_fwd", "control_spill"], False),
    (_RACE, False, True, 1, ["flash_fwd"], True),
    (_CLEAN.replace("sanitizer child: done\n", "").rsplit("=", 1)[0]
     .replace("sanitizer child: ok control_spill\n", ""), True, True,
     None, ["control_spill"], False),
], ids=["refused", "clean", "named", "crashed", "died", "race", "timeout"])
def test_sanitizer_verdict(text, timed_out, ran, errors, failed, completed):
    """Only a refused device records ``ran: false``; errors fail the entry
    points they name (all, when they name none), a child that died or
    timed out under the tool fails those it never reported done."""
    v = kernel_audit.parse_sanitizer(_RUN, text, 1, "/cuda/compute-sanitizer",
                                     timed_out=timed_out)
    assert v["ran"] is ran
    if not ran:
        assert v["reason"].startswith("Device not supported")
        return
    assert v["errors"] == errors
    assert v["failed"] == failed
    assert v["completed"] is completed
    for name in _RUN:
        row = kernel_audit.rule_sanitizer(kernel_audit.spec(name),
                                          {"memcheck": v})
        assert row["ok"] is (name not in failed), (name, row)


@pytest.mark.parametrize("code,tripped", [(9, True), (700, False)])
def test_overlaunch_control_needs_error_9(monkeypatch, code, tripped):
    """The over-launch control trips launch_limits with CUDA error 9
    (cudaErrorInvalidConfiguration); any other error is not its finding."""
    from draco_tpu_torch import _build

    def refused(out):
        raise _build.CudaError("control_overlaunch", code)

    monkeypatch.setattr(controls, "control_overlaunch", refused)
    s = kernel_audit.spec("control_overlaunch")
    funcs = {"control_overlaunch_kernel": {
        "threads": 1200, "max_threads": 1024, "static_smem": 0,
        "dynamic_smem": 0, "opt_in": 0}}
    res = kernel_audit.rule_launch_limits(
        s, funcs, {"smem_block": 49152, "smem_block_optin": 232448}, CPU)
    assert not res["ok"] and res["error_code"] == code
    assert ("wrong_error" not in res) is tripped


def test_every_source_has_a_spec():
    from draco_tpu_torch import _build

    assert {s.source for s in kernel_audit.SPECS} == set(_build.SIGNATURES)
    assert {s.control for s in kernel_audit.SPECS} == {
        "", "coverage", "launch_limits", "resources"}


def test_the_largest_coded_config_validate_accepts():
    """The launch-limit rule checks n = 64, s = 15: config.validate()
    rejects a coded step of more workers (the kernels' block width)."""
    base = dict(network="ResNet18", dataset="synthetic-cifar10",
                approach="cyclic", redundancy="shared")
    TrainConfig(**base, num_workers=kernel_audit.MAX_N,
                worker_fail=kernel_audit.MAX_S).validate()
    with pytest.raises(ValueError, match="n > 4s"):
        TrainConfig(**base, num_workers=kernel_audit.MAX_N,
                    worker_fail=kernel_audit.MAX_S + 1).validate()
    with pytest.raises(ValueError, match="at most 64 workers"):
        TrainConfig(**base, num_workers=kernel_audit.MAX_N + 1,
                    worker_fail=1).validate()
    TrainConfig(**dict(base, approach="baseline"), num_workers=65,
                worker_fail=1).validate()


_ROUTE = re.compile(r"\{(\d+),\s*(\d+),\s*(\d+),\s*(\d+),\s*(k\w+)\}")


def test_locator_dispatch_covers_every_cyclic_config():
    """The locator's dispatch table (``kRoutes`` of csrc/cyclic_locator.cu)
    is ``ops/decode_kernels.LOCATOR_ROUTES``, and every (n, s) that
    config.validate() admits for the cyclic code (n <= 64, n > 4s) matches
    exactly one row, whose instance the audit table and the spec list;
    every instance serves some (n, s)."""
    from draco_tpu_torch import _build
    from draco_tpu_torch.ops import decode_kernels as dk

    text = (_build.PKG_DIR / "csrc" / "cyclic_locator.cu").read_text()
    table = text[text.index("kRoutes[] = {"):]
    table = table[:table.index("};")]
    rows = tuple((int(a), int(b), int(c), int(d), v)
                 for a, b, c, d, v in _ROUTE.findall(table))
    assert rows == dk.LOCATOR_ROUTES
    functions = kernel_audit.spec("cyclic_locator").functions
    used = set()
    admitted = 0
    for n in range(1, 70):
        for s in range(0, 20):
            try:
                TrainConfig(approach="cyclic", num_workers=n,
                            worker_fail=s).validate()
            except ValueError:
                continue
            assert n <= 64 and n > 4 * s
            hits = [r for r in rows if r[0] <= n <= r[1] and r[2] <= s <= r[3]]
            assert len(hits) == 1, (n, s, hits)
            name = dk.locator_instance(n, s)
            assert name in functions and f'"{name}"' in text
            used.add(name)
            admitted += 1
    assert admitted == 544 and used == set(functions)
    assert dk.locator_instance(8, 1) == "cyclic_locator_kernel<kRow1M2>"
    assert dk.locator_instance(9, 2) == "cyclic_locator_kernel<kRow1M4>"
    assert dk.locator_instance(40, 3) == "cyclic_locator_kernel<kRow2>"
    with pytest.raises(ValueError):
        dk.locator_instance(65, 1)


def test_flash_past_the_kernels_head_dim_validate_rejects():
    """The flash kernels take Dh <= MAX_DH (128): config.validate()
    rejects attn_impl="flash" past it and accepts the dense attention
    there (the port routes nothing to dense by itself)."""
    from draco_tpu_torch.ops.flash_attention import MAX_DH

    base = dict(network="TransformerLM", dataset="synthetic-text",
                approach="cyclic", redundancy="shared", num_workers=8,
                worker_fail=1, batch_size=2, seq_len=32, vocab=64,
                model_layers=1)
    TrainConfig(**base, attn_impl="flash", model_dim=2 * MAX_DH,
                model_heads=2).validate()
    with pytest.raises(ValueError, match=f"head dims up to {MAX_DH}"):
        TrainConfig(**base, attn_impl="flash", model_dim=4 * MAX_DH,
                    model_heads=2).validate()
    TrainConfig(**base, attn_impl="dense", model_dim=4 * MAX_DH,
                model_heads=2).validate()


def test_the_registry_covers_the_ten_legs():
    import chip_smoke

    assert tuple(p.name for p in registry.collect()) == LEGS
    assert set(chip_smoke.EXPECT) == set(LEGS)
    for leg, twin in registry.TWINS.items():
        a, b = registry.get(leg).config(True), registry.get(twin).config(True)
        assert (a.wire_segments > 1 or a.decode_granularity == "layer")
        assert b.wire_segments == 1 and b.decode_granularity == "global"
        assert registry.uploads(a) == registry.uploads(b)
    for p in registry.collect():
        full, ci = p.config(full=True), p.config(full=False)
        assert full.num_workers == FULL_N.get(p.name, 8)
        assert (full.network, full.approach, full.wire_dtype) == (
            ci.network, ci.approach, ci.wire_dtype)
        m = p.manifest(full, True)
        assert m.host_syncs == 0 and m.in_place and m.collectives == {}
        assert m.h2d_bytes == sum(registry.uploads(full).values()) > 0
        assert m.max_peak_bytes > 0
    from draco_tpu_torch.parallel import route_of

    for leg, twin in registry.MP_TWINS.items():
        lp = registry.get(leg)
        route = route_of(lp.config(True))
        assert lp.route == ("lm" if route == "sp" else route)
        assert registry.get(twin).route == "lm"


# the observatory's legs, linted in test_torch_audit_watch.py (their CPU
# steps are the slowest: a file of their own runs beside this one)
WATCH_LEGS = ("simulate_watch_bf16", "approx_watch_int8_sr",
              "majvote_shadow_int8", "lm_shared_flash_watch")


def lint_rows_of(legs) -> dict:
    torch.manual_seed(0)
    return {name: program_lint.lint_leg(registry.get(name).build(CPU))
            for name in legs}


# the legs linted here; the later ones (from LATER on, the watch legs
# but) in test_torch_audit_legs.py, a file of their own beside this one:
# the CPU lint of every leg takes minutes on one core, and xdist loadfile
# keeps a file on one worker
LATER = "lenet_single"
HERE = tuple(leg for leg in LEGS[:LEGS.index(LATER)]
             if leg not in WATCH_LEGS)
ELSEWHERE = tuple(leg for leg in LEGS[LEGS.index(LATER):]
                  if leg not in WATCH_LEGS)


@pytest.fixture(scope="module")
def lint_rows():
    return lint_rows_of(HERE)


def assert_green(row, leg) -> None:
    assert row["ok"], row
    r = row["rules"]
    assert r["host_traffic"]["syncs"] == 0
    assert r["in_place"]["state_tensors"] > 0
    assert r["constant_bloat"]["skipped"] and r["memory_budget"]["skipped"]
    assert "float64" not in r["dtype"]["dtypes"]
    if registry.get(leg).config().wire_dtype == "int8":
        assert "int8" in r["dtype"]["dtypes"]


@pytest.mark.parametrize("leg", HERE)
def test_every_leg_green_on_the_cpu_rules(lint_rows, leg):
    assert_green(lint_rows[leg], leg)


CPU_CONTROLS = [c for c in lint_controls.CONTROLS if not c.card_only]


@pytest.mark.parametrize("control", CPU_CONTROLS, ids=lambda c: c.name)
def test_control_trips_exactly_its_rule(control):
    try:
        row = program_lint.control_row(control, CPU)
    finally:
        lint_controls.release()
    assert row["ok"], row
    assert row["failed_rules"] == [control.expected_fail]


def test_the_honest_miniature_is_green():
    row, rec = rules.lint_program(lint_controls.honest_program(CPU))
    assert row["ok"], row
    # w, its momentum, the optimizer's update count, the statistics
    assert rec["state"]["tensors"] == 4


def test_card_controls_are_listed_for_the_card_only():
    assert {c.name for c in program_lint.controls_for("cpu")} == {
        c.name for c in CPU_CONTROLS}
    assert {c.expected_fail for c in lint_controls.CONTROLS
            if c.card_only} == {"constant_bloat", "memory_budget"}
