"""The catalog of the port's training programs and their manifests
(draco_tpu/analysis/registry.py).

Every leg ``chip_smoke.py`` drives registers here as a :class:`LintProgram`:
the configuration fields that make the leg, built through the entry points
a user calls (``Trainer`` for ResNet-18, the route's builder and
``TokenLoop`` for the TransformerLM) at a CI size on the CPU
(``full=False``) or at the width the leg runs on the card (``full=True``).
Its :class:`Manifest` is the reviewable statement of what one step does
that no output-level test sees: the element types it computes in, the host
synchronisations and host-to-device bytes it makes, the collectives it
calls, that it updates its state in place, and its peak device memory.
``analysis/rules.py`` holds each step to its manifest;
``analysis/program_lint.py`` drives the catalog. Three legs also register
their chunked program (:class:`ChunkProgram`, ``steps_per_call`` K > 1):
one inspected chunk of K steps through the loop's engine client — on the
card the replays of the captured step — and its flush.

The full-width configurations are the legs' own (PERF.md §4): ResNet-18 on
synthetic CIFAR-10 at n=8 workers of batch 32, s=1, a rev_grad adversary
every step (``bench.py``'s flagship cut to n=8); the approx code at r=1.5
with 2 stragglers a step (preset ``approx-resnet18`` at n=8); the narrow
wires at block 256; the repetition code of preset ``rep-resnet18`` (n=9,
groups of 3) with the adversary, and Krum (preset ``krum-resnet18`` at
n=8); the LM benchmark's TransformerLM (dim 768, 12 heads, 8 layers, vocab
8192, T=512, batch 2, bf16 compute, flash attention). Four legs run the
segmented wire and the per-layer decode beside their S = 1 twins
(``TWINS``). Five more run the other models, bf16 compute and the
optimizers: preset ``cyclic-vgg11`` (VGG-11, n=9, s=2, a constant attack
on two workers a step) under ``simulate`` and ``shared``; preset
``single-lenet`` (LeNet on MNIST shapes, n=1, batch 128); the ResNet-18
``shared`` leg at bfloat16 compute; and the LM's ``shared`` leg under
AdamW with the cosine schedule and the clip. Four run the device draws
(the reference's threefry stream, ``ops/draws.py``): ``vgg11_random``
(preset cyclic-vgg11's simulate leg with the random attack, BASELINE
config 4's random adversary), ``shared_int8_sr`` (``shared_int8`` under
stochastic rounding, beside it as its twin, ``SR_TWINS``),
``majvote_bf16_sr`` (the vote on a stochastically rounded bf16 wire),
``majvote_random`` (the vote's gradient rows under the random attack, the
plain form of ``random_inject``) and ``lm_shared_flash_devgen`` (the LM
with device tokens and the random attack: a chunk stages K step numbers
and the masks, no tokens). Four run the tree topology
(``coding/topology.py``): ``shared_tree_g8`` and ``shared_int8_tree_g8``
(ResNet-18 ``shared`` at n=16 in two groups of 8, s_g = 1, the adversary
every step; the f32 and the int8 wire), ``approx_tree_g3`` (preset
approx-resnet18 at n=9 in three groups of 3) and
``lm_shared_flash_tree_g4`` (the LM at n=8 in two groups of 4, s_g = 0, no
adversary). Four run the wire observatory (``obs/numerics.py``: the
numerics columns from the ``stage_stats`` kernel and a shadow-quantized
second decode): ``simulate_watch_bf16`` (the flagship with the bf16
shadow), ``approx_watch_int8_sr`` (preset approx-resnet18 with the int8
shadow, stochastically rounded), ``majvote_shadow_int8`` (preset
rep-resnet18 with the int8 shadow) and ``lm_shared_flash_watch`` (the LM's
``shared`` leg with the bf16 shadow). Four run the LM's approx code,
narrow wire and stragglers (``LM_CODE_TWINS`` names each one's yardstick):
``lm_approx_flash`` (preset approx-resnet18's code on the LM: r=1.5
pairwise, two workers dropped a step), ``lm_approx_int8_sr_flash`` (its
int8 wire rounded stochastically), ``lm_shared_int8_flash``
(``lm_shared_flash`` on the int8 wire) and ``lm_shared_flash_drop2``
(``lm_shared_flash`` with no adversary and two erasures a step). Every
coded leg runs the ingest check (``nonfinite_rows``) and packs its
forensics masks.

Five run the LM's layer stack and sequence shards, each held to
``lm_shared_flash`` (``STACK_TWINS``): ``lm_shared_flash_remat`` (each
block recomputed in the backward), ``lm_shared_flash_scan`` (the stacked
layers), ``lm_big_shared_flash`` (the reference's ``lm_big`` shape, d =
159,470,592: T=2048, dim 1024, 16 heads, 12 layers, with remat and the
stacked layers, tools/tpu_lm_lowering_check.py), and
``lm_sp4_ring_flash`` and ``lm_sp4_a2a_flash`` (four sequence shards, the
ring with the flash kernels at every hop and the a2a head scatter around
them).

Five run the LM's model-parallel routes at LM_FULL's width, the shard
axis a tensor axis (``MP_TWINS``): ``lm_shared_dense`` (dense attention,
the twin of ``lm_shared_dense_tp2``, two tensor shards),
``lm_shared_flash_pp2`` (the GPipe pipeline, two stages and two
microbatches, beside ``lm_shared_flash_scan``), ``lm_shared_dense_moe4``
(four Switch experts a block, d = 176,321,280) and
``lm_shared_dense_moe4_ep2`` (the same MoE on the ep route at two expert
shards, bit for bit its twin: ``parallel/ep_step.py``). Each is built
through its route's builder (``parallel.build_route_setup``).

The resilience legs (``GUARD_PROGRAMS``, ``chip_smoke.py``'s guard phase,
each beside the leg it guards, ``GUARD_TWINS``) run the step guard and a
seeded fault plan: ``simulate_guard_nan`` (the flagship, a NaN gradient
from a drawn worker at step 2), ``shared_int8_over_budget`` (the int8
``shared`` wire, step 3's adversaries past the budget),
``approx_guard_watch`` (preset approx-resnet18, worker 3 absent on steps
2–3) and ``lm_shared_flash_adamw_guard`` (the AdamW LM, an Inf gradient
from worker 5 at step 2). The plan's in-step events go to the card once at
setup: a guarded step moves its twin's host-to-device bytes, the approx
code's plus the staged bound its certificate reads (4 bytes).

The autopilot's chunk (``AUTOPILOT_CHUNKS``: ``chunk_shared_autopilot``,
the cyclic ``shared`` leg with the incident watch and the autopilot on)
is held beside ``chunk_simulate``: no synchronising call inside a chunk
and one fetch a flush with the autopilot's decisions inside it, its
staging the twin's plus the all-present schedule's K·n bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

SEED = 428
N, S = 8, 1
CNN_FULL = dict(network="ResNet18", dataset="synthetic-cifar10",
                num_workers=N, worker_fail=S, err_mode="rev_grad",
                batch_size=32, lr=0.01, momentum=0.9, train_dir="", seed=SEED)
# CI size: the fewest workers a cyclic s=1 code takes, one sample each, a
# few Weiszfeld passes (each leg keeps its network: ResNet-18's d =
# 11,173,962 at CI size too)
CNN_CI = dict(num_workers=5, batch_size=1, geomedian_iters=4)
# the approx legs: preset approx-resnet18 (r=1.5 pairwise, 2 workers dropped
# a step, no adversary)
APPROX = dict(approach="approx", redundancy="shared", worker_fail=0,
              code_redundancy=1.5, assignment_scheme="pairwise",
              straggle_mode="drop", straggle_count=2)
# the LM benchmark's configuration (tools/tpu_lm_perf.py, variant
# lm_cyclic_s1_shared_bf16_flash, at that tool's defaults)
LM_FULL = dict(network="TransformerLM", dataset="synthetic-text",
               batch_size=2, lr=0.01, momentum=0.9, num_workers=N,
               worker_fail=S, err_mode="rev_grad", seq_len=512, vocab=8192,
               model_dim=768, model_heads=12, model_layers=8,
               compute_dtype="bfloat16", attn_impl="flash", eval_freq=0,
               train_dir="", seed=SEED)
LM_CI = dict(seq_len=32, vocab=64, model_dim=64, model_heads=4,
             model_layers=2)
# the reference's lm_big shape (tools/tpu_lm_lowering_check.py,
# tools/tpu_lm_perf.py): d = 159,470,592, with remat and the scanned
# layer stack, as the reference runs it on its chip
LM_BIG = dict(seq_len=2048, model_dim=1024, model_heads=16, model_layers=12,
              remat=True, scan_layers=True)
# preset rep-resnet18 (n=9, groups of r=3, batch 32) with one rev_grad
# adversary a step for the vote to outvote; one group at CI size
MAJVOTE = dict(approach="maj_vote", num_workers=9, group_size=3)
MAJVOTE_CI = dict(num_workers=3)
# preset cyclic-vgg11: VGG-11, the cyclic code at r=5 (n=9, s=2), a
# constant attack on both adversaries a step (n > 4s keeps n=9 at CI size)
VGG11 = dict(network="VGG11", num_workers=9, worker_fail=2,
             err_mode="constant")
VGG11_CI = dict(num_workers=9)
# preset single-lenet: LeNet on MNIST shapes, one worker, the mean
LENET = dict(network="LeNet", dataset="synthetic-mnist", approach="baseline",
             mode="normal", num_workers=1, worker_fail=0, batch_size=128)
LENET_CI = dict(num_workers=1, batch_size=4)
# the tree topology (coding/topology.py): ResNet-18 shared at n=16 in two
# groups of 8 (s_g = 1) with the rev_grad adversary; at CI size n=10 in two
# groups of 5 (the smallest group that keeps s_g = 1)
TREE16 = dict(approach="cyclic", redundancy="shared", num_workers=16,
              topology="tree", tree_fanout=8)
TREE_CI = dict(num_workers=10, tree_fanout=5)
# preset approx-resnet18 at n=9 in three groups of 3 (n=9 admits no g=4);
# two groups of 3 at CI size
APPROX_TREE = dict(APPROX, num_workers=9, topology="tree", tree_fanout=3)
APPROX_TREE_CI = dict(num_workers=6)
# the LM in two groups of 4: s_g = 0, no adversary (the reference's LM tree
# configuration, tests/test_tree.py)
LM_TREE = dict(approach="cyclic", redundancy="shared", worker_fail=0,
               adversary_count=0, topology="tree", tree_fanout=4)
# the numerics observatory on (the shadow's dtype is each leg's own)
WATCH = dict(numerics_watch="on")
# the LM's AdamW: an Adam-sized rate, the cosine schedule with a 2-step
# warmup and the global-norm clip at 1
ADAMW = dict(optimizer="adamw", lr=1e-3, lr_schedule="cosine",
             warmup_steps=2, clip_norm=1.0)

DEFAULT_DTYPES = frozenset({torch.float32, torch.int64, torch.int32,
                            torch.bool})
# the bf16 wire writes NaN as its 0x7FC0 bits through an int16 view
WIRE_DTYPES = {"f32": frozenset(),
               "bf16": frozenset({torch.bfloat16, torch.int16}),
               "int8": frozenset({torch.int8})}
WIRE_TORCH = {"bf16": torch.bfloat16, "int8": torch.int8}
# bf16 -> f32 promotion sites of the bf16 routes: the explicit casts (the
# CNN's BatchNorm input and classifier input, the parameters' gradients
# through their casts), and the LM LayerNorm's x − mean in float32 (Flax's
# normalisation of a bf16 input, which the reference writes as
# convert_element_type then sub)
BF16_PROMOTIONS = ("_to_copy", "sub")


@dataclasses.dataclass(frozen=True)
class Manifest:
    """What one step of a program may do; ``rules.py`` checks each field.

    ``allowed_dtypes``: every tensor an op of the step reads or writes has
    one of these types (float64 and complex128 never pass).
    ``bf16_promotions``: the ops allowed to take bfloat16 and give float32.
    ``required_dtypes``: types that must appear (a narrow wire's payload).
    ``host_syncs``: synchronising calls in one step (0: the step queues all
    its work without waiting for the card).
    ``uploads``: the host-to-device copies of one step, name -> bytes; the
    step may move at most their sum (``h2d_bytes``).
    ``collectives``: calls into ``torch.distributed`` by kind (missing
    kinds 0); None skips the rule.
    ``in_place``: parameters, the optimizer's state and batch statistics keep
    their storage across the step.
    ``max_peak_bytes``: the memory one step allocates on the card above
    what was live when it began, and a chunked program's graph pool; None
    skips the rule.
    ``flush_fetches``: a chunked program's device-to-host fetches in one
    flush (1: every pending metrics block in one copy); None for a step."""

    allowed_dtypes: frozenset = DEFAULT_DTYPES
    bf16_promotions: tuple = ("_to_copy",)
    required_dtypes: frozenset = frozenset()
    host_syncs: int = 0
    uploads: dict = dataclasses.field(default_factory=dict)
    collectives: Optional[dict] = dataclasses.field(default_factory=dict)
    in_place: bool = True
    max_peak_bytes: Optional[int] = None
    flush_fetches: Optional[int] = None

    @property
    def h2d_bytes(self) -> int:
        return sum(self.uploads.values())


@dataclasses.dataclass
class Program:
    """A built program: ``step()`` runs one step (a chunked program: one
    chunk) through the user's entry points without reading its metrics;
    ``state()`` names its state tensors. ``warm()`` runs what precedes the
    inspected step (default: one eager step of ``runner``); ``flush()``, a
    chunked program's, fetches and writes its pending metrics and returns
    the fetches it made; ``pool_bytes()`` the memory its graph holds."""

    name: str
    manifest: Manifest
    device: torch.device
    step: Callable[[], object]
    state: Callable[[], dict]
    runner: object = None  # the Trainer / TokenLoop, for the legs
    cfg: object = None
    warm: Optional[Callable[[], object]] = None
    flush: Optional[Callable[[], int]] = None
    pool_bytes: Optional[Callable[[], int]] = None


def uploads(cfg) -> dict:
    """The host-to-device copies of one step of ``cfg``, name -> bytes: the
    batch at the dataset's shape and its labels (the LM's tokens, unless
    the device makes them), the masks and the step number, which every
    draw of the step reads on the device (augmentation, dropout, the
    vote's salts, the random attack, stochastic rounding, the LM's device
    tokens), and the approx code's host solve."""
    from draco_tpu_torch.models import input_shape

    n, b = cfg.num_workers, cfg.batch_size
    out = {}
    if cfg.network != "TransformerLM":
        h, w, c = input_shape(cfg.dataset)
        out = {"batch (f32 NHWC)": n * b * h * w * c * 4,
               "labels (int32)": n * b * 4}
    elif cfg.token_gen != "device":
        out["tokens (int32)"] = n * b * cfg.seq_len * 4
    if cfg.approach != "approx":
        out["adv_mask"] = n
    out["step (int32)"] = 4  # the device draws' step
    # the autopilot quarantines through an all-present schedule
    stragglers = (cfg.straggle_mode == "drop" and cfg.straggle_count > 0
                  or cfg.autopilot == "on")
    if stragglers:
        out["present (bool)"] = n
    if cfg.approach == "approx":
        out["v/n and presence (f32)"] = 2 * n * 4
        if cfg.step_guard == "on":
            out["the certificate's bound (f32)"] = 4
    return out


@dataclasses.dataclass(frozen=True)
class LintProgram:
    """A registered leg: ``overrides`` on the route's full-width fields;
    ``peak_gb`` its step's memory budget on the card at full width; ``ci``
    overrides of the route's CI size."""

    name: str
    # "cnn" (the Trainer) | "lm" (the LM's default route, sp_step) | "tp"
    # | "pp" | "ep" (the LM's model-parallel routes, each built through
    # its own builder)
    route: str
    overrides: dict
    peak_gb: float
    ci: dict = dataclasses.field(default_factory=dict)

    def config(self, full: bool = False, max_steps: int = 3, **fields):
        from draco_tpu_torch.config import TrainConfig

        base = CNN_FULL if self.route == "cnn" else LM_FULL
        small = {} if full else {
            **(CNN_CI if self.route == "cnn" else LM_CI), **self.ci}
        return TrainConfig(**{**base, **self.overrides, **small,
                              "max_steps": max_steps, **fields}).validate()

    def manifest(self, cfg, full: bool) -> Manifest:
        # a bf16 shadow rounds through the bf16 wire's core: its buffers
        # appear, though nothing crosses a wire narrow (an int8 shadow keeps
        # its levels in f32)
        dtypes = DEFAULT_DTYPES | WIRE_DTYPES[cfg.wire_dtype]
        if cfg.shadow_wire == "bf16":
            dtypes = dtypes | WIRE_DTYPES["bf16"]
        promos = ("_to_copy",)
        if cfg.compute_dtype == "bfloat16":
            dtypes = dtypes | {torch.bfloat16}
            promos = BF16_PROMOTIONS
        return Manifest(
            allowed_dtypes=dtypes, bf16_promotions=promos,
            required_dtypes=(frozenset({WIRE_TORCH[cfg.wire_dtype]})
                             if cfg.wire_dtype != "f32" else frozenset()),
            uploads=uploads(cfg),
            max_peak_bytes=int(self.peak_gb * 2 ** 30) if full else None)

    def runner(self, cfg, dev, full: bool, dataset=None):
        """The leg's Trainer or TokenLoop at ``cfg`` on ``dev``."""
        if self.route == "cnn":
            from draco_tpu_torch.data.datasets import load_dataset
            from draco_tpu_torch.training.trainer import Trainer

            if dataset is None:
                dataset = (load_dataset(cfg.dataset) if full else
                           load_dataset(cfg.dataset, synthetic_train=256,
                                        synthetic_test=16))
            return Trainer(cfg, device=dev, dataset=dataset, quiet=True)
        from draco_tpu_torch.parallel import build_route_setup
        from draco_tpu_torch.parallel.token_loop import TokenLoop

        route = "sp" if self.route == "lm" else self.route
        return TokenLoop(build_route_setup(cfg, dev, route=route), cfg,
                         quiet=True, tag=route)

    def build(self, device=None, full: bool = False, max_steps: int = 3,
              dataset=None, **fields) -> Program:
        """The leg's runner on ``device`` (default cuda) and its step;
        ``fields`` override the configuration's (``steps_per_call``)."""
        from draco_tpu_torch.runtime import resolve_device

        cfg = self.config(full, max_steps, **fields)
        dev = resolve_device(device)
        runner = self.runner(cfg, dev, full, dataset)
        setup = runner.setup

        def step():
            args = runner.inputs(runner.state.step)
            if self.route == "cnn":
                x, y, adv, present = args
                runner.state, metrics = setup.train_step(
                    runner.state, x, y, adv, present=present)
            else:
                runner.state, metrics = setup.train_step(runner.state, *args)
            return metrics
        return Program(self.name, self.manifest(cfg, full), dev, step,
                       lambda: runner.state.tensors(), runner, cfg)


@dataclasses.dataclass(frozen=True)
class ChunkProgram:
    """A leg's chunked program: ``steps_per_call`` = K (2 at CI size) and
    one chunk of K steps a ``step()``, through the loop's engine client
    (``control/clients.py``) and ``train_many``. Its manifest: no
    synchronising call inside a chunk, one device-to-host fetch a flush,
    the H2D bytes of a chunk (its staging copy: K steps' uploads) and a
    peak that includes the graph's private pool. The flush runs as the
    loops run it: the run heartbeat (``obs/heartbeat.py``, on a temporary
    train_dir) observes its records and beats, within the one fetch, and
    under ``incident_watch="on"`` its incident engine folds them too."""

    name: str
    leg: str  # the LintProgram it chunks
    K: int = 4

    def config(self, full: bool = False):
        k = self.K if full else 2
        return get(self.leg).config(full, max_steps=2 * k, steps_per_call=k)

    def manifest(self, cfg, full: bool) -> Manifest:
        k = cfg.steps_per_call
        m = get(self.leg).manifest(cfg, full)
        return dataclasses.replace(
            m, uploads={f"{name} x{k}": b * k for name, b in m.uploads.items()},
            flush_fetches=1)

    def _config_in(self, full: bool, train_dir: str):
        return self.config(full)

    def _observers(self, runner, cfg, client, train_dir: str) -> tuple:
        """The flush's heartbeat (its own, on ``train_dir``) and what runs
        after its beat (nothing)."""
        from draco_tpu_torch.obs.heartbeat import RunHeartbeat
        from draco_tpu_torch.obs.incidents import make_engine

        hb = RunHeartbeat(train_dir, num_workers=cfg.num_workers,
                          incidents=make_engine(dataclasses.replace(
                              cfg, train_dir=train_dir)))
        return hb, lambda step: None

    def build(self, device=None, full: bool = False, dataset=None) -> Program:
        import tempfile

        from draco_tpu_torch.runtime import resolve_device
        from draco_tpu_torch.utils.metrics import (
            DeferredMetricWriter,
            MetricWriter,
        )

        lp = get(self.leg)
        status_dir = tempfile.TemporaryDirectory(prefix="draco_lint_")
        cfg = self._config_in(full, status_dir.name)
        dev = resolve_device(device)
        runner = lp.runner(cfg, dev, full, dataset)
        client = runner.chunk_client(1, cfg.max_steps)
        ranges = client.ranges
        hb, after_beat = self._observers(runner, cfg, client,
                                         status_dir.name)
        deferred = DeferredMetricWriter(MetricWriter("", quiet=True),
                                        observer=hb.observe)
        done = []

        def step():
            chunk = client.assemble(len(done), ranges)
            runner.state, block = client.dispatch(runner.state, chunk)
            deferred.defer(range(chunk.start, chunk.start + chunk.k),
                           client.block_names, block, client.extras(chunk))
            done.append(chunk.start)

        def flush(status_dir=status_dir) -> int:
            # (the default keeps the heartbeat's directory while the
            # program lives)
            before = deferred.fetches
            last = deferred.flush()
            hb.beat(last["step"], cfg.max_steps, extra=client.beat_extras())
            after_beat(last["step"])
            return deferred.fetches - before

        def warm():
            step()
            flush()

        def pool_bytes() -> int:
            graph = client.many.graph()
            return graph.pool_bytes if graph is not None else 0

        return Program(self.name, self.manifest(cfg, full), dev, step,
                       lambda: runner.state.tensors(), runner, cfg,
                       warm=warm, flush=flush, pool_bytes=pool_bytes)


_CYCLIC_SHARED = dict(approach="cyclic", redundancy="shared")
_BASELINE_GM = dict(approach="baseline", mode="geometric_median")
DENSE = dict(_CYCLIC_SHARED, attn_impl="dense")
MOE4 = dict(DENSE, moe_experts=4)

# peak_gb: what one full-width step allocates on the card above its
# starting memory, with headroom (measured by chip_smoke.py's audit phase,
# PERF.md §6)
PROGRAMS = (
    LintProgram("simulate", "cnn",
                dict(approach="cyclic", redundancy="simulate"), 13.0),
    LintProgram("geomedian", "cnn", _BASELINE_GM, 4.5),
    LintProgram("shared", "cnn", _CYCLIC_SHARED, 4.5),
    LintProgram("approx", "cnn", APPROX, 4.5),
    LintProgram("approx_int8", "cnn", dict(APPROX, wire_dtype="int8"), 4.5),
    LintProgram("shared_bf16", "cnn", dict(_CYCLIC_SHARED, wire_dtype="bf16"),
                4.5),
    LintProgram("shared_int8", "cnn", dict(_CYCLIC_SHARED, wire_dtype="int8"),
                4.5),
    LintProgram("majvote", "cnn", MAJVOTE, 6.0, ci=MAJVOTE_CI),
    LintProgram("krum", "cnn", dict(approach="baseline", mode="krum"), 4.5),
    LintProgram("lm_shared_flash", "lm", _CYCLIC_SHARED, 14.5),
    LintProgram("lm_simulate_flash", "lm",
                dict(approach="cyclic", redundancy="simulate"), 25.5),
    LintProgram("lm_geomedian_flash", "lm", _BASELINE_GM, 8.5),
    # the segmented wire and the per-layer decode, each beside its S = 1
    # twin (TWINS): 62 ResNet-18 leaves; the int8 wire in 4 segments; the
    # approx code's int8 wire in 4; the LM's 66 leaves refined by 4
    # segments into 69
    LintProgram("shared_layer", "cnn",
                dict(_CYCLIC_SHARED, decode_granularity="layer"), 4.5),
    LintProgram("shared_int8_seg4", "cnn",
                dict(_CYCLIC_SHARED, wire_dtype="int8", wire_segments=4),
                4.5),
    LintProgram("approx_int8_seg4", "cnn",
                dict(APPROX, wire_dtype="int8", wire_segments=4), 4.5),
    LintProgram("lm_shared_flash_layer", "lm",
                dict(_CYCLIC_SHARED, decode_granularity="layer",
                     wire_segments=4), 14.5),
    # the other models, bf16 compute, the optimizers: preset cyclic-vgg11
    # (45 lanes under simulate), preset single-lenet, bf16 compute on the
    # CNN, AdamW on the LM
    LintProgram("vgg11_simulate", "cnn",
                dict(VGG11, approach="cyclic", redundancy="simulate"), 8.0,
                ci=VGG11_CI),
    LintProgram("vgg11_shared", "cnn", dict(VGG11, **_CYCLIC_SHARED), 2.5,
                ci=VGG11_CI),
    LintProgram("lenet_single", "cnn", LENET, 1.0, ci=LENET_CI),
    LintProgram("shared_c16", "cnn",
                dict(_CYCLIC_SHARED, compute_dtype="bfloat16"), 4.5),
    LintProgram("lm_shared_flash_adamw", "lm", dict(_CYCLIC_SHARED, **ADAMW),
                14.5),
    # the device draws: the random attack on preset cyclic-vgg11's 45
    # simulate lanes; stochastic rounding on the int8 cyclic wire and the
    # vote's bf16 wire (one draw a step shared by the rows); the random
    # attack on the vote's gradient rows; the LM's device tokens with the
    # random attack
    LintProgram("vgg11_random", "cnn",
                dict(VGG11, approach="cyclic", redundancy="simulate",
                     err_mode="random"), 8.0, ci=VGG11_CI),
    LintProgram("shared_int8_sr", "cnn",
                dict(_CYCLIC_SHARED, wire_dtype="int8",
                     shadow_round="stochastic"), 4.5),
    LintProgram("majvote_bf16_sr", "cnn",
                dict(MAJVOTE, wire_dtype="bf16", shadow_round="stochastic"),
                9.0, ci=MAJVOTE_CI),
    LintProgram("majvote_random", "cnn", dict(MAJVOTE, err_mode="random"),
                6.0, ci=MAJVOTE_CI),
    LintProgram("lm_shared_flash_devgen", "lm",
                dict(_CYCLIC_SHARED, token_gen="device", err_mode="random"),
                14.5),
    # the tree topology: one locator launch over the groups' columns, each
    # with its group's presence; the f32 and the int8 wire; the approx
    # code's groups; the LM's groups
    LintProgram("shared_tree_g8", "cnn", TREE16, 9.0, ci=TREE_CI),
    LintProgram("shared_int8_tree_g8", "cnn", dict(TREE16, wire_dtype="int8"),
                9.0, ci=TREE_CI),
    LintProgram("approx_tree_g3", "cnn", APPROX_TREE, 5.0, ci=APPROX_TREE_CI),
    LintProgram("lm_shared_flash_tree_g4", "lm", LM_TREE, 14.5),
    # the wire observatory: the numerics columns and a shadow decode on
    # the flagship (bf16), the approx code (int8, stochastic), the vote
    # (int8) and the LM (bf16)
    LintProgram("simulate_watch_bf16", "cnn",
                dict(approach="cyclic", redundancy="simulate", **WATCH,
                     shadow_wire="bf16"), 16.0),
    LintProgram("approx_watch_int8_sr", "cnn",
                dict(APPROX, **WATCH, shadow_wire="int8",
                     shadow_round="stochastic"), 6.5),
    LintProgram("majvote_shadow_int8", "cnn",
                dict(MAJVOTE, **WATCH, shadow_wire="int8"), 8.5,
                ci=MAJVOTE_CI),
    LintProgram("lm_shared_flash_watch", "lm",
                dict(_CYCLIC_SHARED, **WATCH, shadow_wire="bf16"), 24.0),
    # the LM's approx code, narrow wire and stragglers: preset
    # approx-resnet18's code (f32, and int8 rounded stochastically), the
    # cyclic int8 wire, and two erasures a step at the 2s budget (step
    # peaks 7.78, 11.51, 14.09 and 13.14 GiB measured, PERF.md §6)
    LintProgram("lm_approx_flash", "lm", APPROX, 9.0),
    LintProgram("lm_approx_int8_sr_flash", "lm",
                dict(APPROX, wire_dtype="int8", shadow_round="stochastic"),
                13.0),
    LintProgram("lm_shared_int8_flash", "lm",
                dict(_CYCLIC_SHARED, wire_dtype="int8"), 15.5),
    LintProgram("lm_shared_flash_drop2", "lm",
                dict(_CYCLIC_SHARED, adversary_count=0, straggle_mode="drop",
                     straggle_count=2), 14.5),
    # the LM's layer stack and sequence shards: remat, the stacked layers,
    # the lm_big shape with both, and four sequence shards on the flash
    # ring and the a2a head scatter (step peaks 13.14 GiB each at LM_FULL,
    # the coded tail's; 33.27 GiB at lm_big, PERF.md §6)
    LintProgram("lm_shared_flash_remat", "lm",
                dict(_CYCLIC_SHARED, remat=True), 14.5),
    LintProgram("lm_shared_flash_scan", "lm",
                dict(_CYCLIC_SHARED, scan_layers=True), 14.5),
    LintProgram("lm_big_shared_flash", "lm", dict(_CYCLIC_SHARED, **LM_BIG),
                36.0),
    LintProgram("lm_sp4_ring_flash", "lm",
                dict(_CYCLIC_SHARED, seq_shards=4), 14.5),
    LintProgram("lm_sp4_a2a_flash", "lm",
                dict(_CYCLIC_SHARED, seq_shards=4, sp_attn="a2a"), 14.5),
    # the LM's model-parallel routes, each shard axis a tensor axis
    # (MP_TWINS): the plain streaming attention (the reference refuses
    # flash on tp, MoE and ep), tensor parallelism over 2 shards, the GPipe
    # pipeline of 2 stages and 2 microbatches on the flash kernels, 4
    # Switch experts a block on the default route (d = 176,321,280) and
    # the same MoE on the ep route at 2 expert shards (step peaks 14.44,
    # 14.44, 13.14, 36.78 and 36.78 GiB measured, PERF.md §6; the
    # pipeline's lint once read 21.69 GiB late in a whole chip_smoke.py
    # run, an open fault, ROADMAP Queue C)
    LintProgram("lm_shared_dense", "lm", DENSE, 16.0),
    LintProgram("lm_shared_dense_tp2", "tp", dict(DENSE, tensor_shards=2),
                16.0),
    LintProgram("lm_shared_flash_pp2", "pp",
                dict(_CYCLIC_SHARED, pipeline_shards=2, pp_microbatches=2),
                14.5),
    LintProgram("lm_shared_dense_moe4", "lm", MOE4, 40.5),
    LintProgram("lm_shared_dense_moe4_ep2", "ep", dict(MOE4, expert_shards=2),
                40.5),
)

# each segmented leg's S = 1, global-granularity twin
TWINS = {"shared_layer": "shared", "shared_int8_seg4": "shared_int8",
         "approx_int8_seg4": "approx_int8",
         "lm_shared_flash_layer": "lm_shared_flash"}
# each stochastically rounded leg's nearest-rounding twin: the same
# detection columns every step
SR_TWINS = {"shared_int8_sr": "shared_int8"}
# each LM code leg's yardstick in the same call (its chunk's ms/step)
LM_CODE_TWINS = {"lm_approx_flash": "lm_shared_flash_devgen",
                 "lm_approx_int8_sr_flash": "lm_approx_flash",
                 "lm_shared_int8_flash": "lm_shared_flash",
                 "lm_shared_flash_drop2": "lm_shared_flash"}
# each layer-stack and sequence-shard leg's twin: the same decode columns
# every step (chip_smoke.py's stack_twin_checks)
STACK_TWINS = {"lm_shared_flash_remat": "lm_shared_flash",
               "lm_shared_flash_scan": "lm_shared_flash",
               "lm_sp4_ring_flash": "lm_shared_flash",
               "lm_sp4_a2a_flash": "lm_shared_flash"}
# each model-parallel leg's twin (chip_smoke.py's mp_twin_checks): tp2 and
# ep2 from the twin's draw, pp2 from the pipeline's parameters renamed
# blocks.loop.b.* -> blocks.* (the reference's own oracle is the
# sequential stack), each giving its twin's decode columns with its update
# inside a bound that a control falls outside; the MoE leg beside the
# dense one for its time only (another model)
MP_TWINS = {"lm_shared_dense_tp2": "lm_shared_dense",
            "lm_shared_flash_pp2": "lm_shared_flash_scan",
            "lm_shared_dense_moe4": "lm_shared_dense",
            "lm_shared_dense_moe4_ep2": "lm_shared_dense_moe4"}
# each watch leg's leg without the observatory: the same update bit for bit
WATCH_TWINS = {"simulate_watch_bf16": "simulate",
               "approx_watch_int8_sr": "approx",
               "majvote_shadow_int8": "majvote",
               "lm_shared_flash_watch": "lm_shared_flash"}


# the flagship's coded leg, the host-bound LM leg (PERF.md §5), the vote
# (its salts staged with the draws), the LM with device tokens (a
# chunk's staging: K step numbers and the masks), the LM with the
# observatory (36 + 5 more columns a row, the heartbeat's fold at the
# flush) and the LM's approx code (K host solves at assembly, v/n and the
# presence staged)
CHUNKS = (ChunkProgram("chunk_simulate", "simulate"),
          ChunkProgram("chunk_lm_shared_flash", "lm_shared_flash"),
          ChunkProgram("chunk_majvote", "majvote"),
          ChunkProgram("chunk_lm_shared_flash_devgen",
                       "lm_shared_flash_devgen"),
          ChunkProgram("chunk_lm_shared_flash_watch",
                       "lm_shared_flash_watch"),
          ChunkProgram("chunk_lm_approx_flash", "lm_approx_flash"))


# the resilience legs: the step guard and a seeded fault plan, each beside
# the leg it guards (GUARD_TWINS)
GUARD = dict(step_guard="on")
GUARD_PROGRAMS = (
    LintProgram("simulate_guard_nan", "cnn",
                dict(approach="cyclic", redundancy="simulate", **GUARD,
                     fault_spec="nan_grad@2", incident_watch="on"), 13.0),
    LintProgram("shared_int8_over_budget", "cnn",
                dict(_CYCLIC_SHARED, wire_dtype="int8", **GUARD,
                     fault_spec="over_budget@3"), 4.5),
    LintProgram("approx_guard_watch", "cnn",
                dict(APPROX, **GUARD, incident_watch="on",
                     fault_spec="straggle@2:w3:d2"), 4.5),
    # the gated update's and the Inf row's (8, d) temporaries: 15.02 GiB
    # measured against the twin's 13.14 (PERF.md §6)
    LintProgram("lm_shared_flash_adamw_guard", "lm",
                dict(_CYCLIC_SHARED, **ADAMW, **GUARD,
                     fault_spec="inf_grad@2:w5"), 16.5),
)
GUARD_TWINS = {"simulate_guard_nan": "simulate",
               "shared_int8_over_budget": "shared_int8",
               "approx_guard_watch": "approx",
               "lm_shared_flash_adamw_guard": "lm_shared_flash_adamw"}
# the guarded flagship's chunk, beside chunk_simulate: the same syncs,
# fetches and staging bytes; the guarded approx code's, whose flush the
# incident engine folds too
GUARD_CHUNKS = (ChunkProgram("chunk_simulate_guard_nan",
                             "simulate_guard_nan"),
                ChunkProgram("chunk_approx_guard_watch",
                             "approx_guard_watch"))


@dataclasses.dataclass(frozen=True)
class AutopilotChunkProgram(ChunkProgram):
    """A leg's chunked program with the incident watch and the autopilot
    on (``control/autopilot.py``): the Trainer's own heartbeat and
    incident engine fold the flush's records, then the autopilot decides
    on them, within the flush's one fetch. Its chunk stages the
    all-present schedule the autopilot quarantines through (K·n bytes
    beyond its leg's)."""

    def config(self, full: bool = False, train_dir: str = "autopilot_lint"):
        # validate() wants the train_dir the run writes into; ``build``
        # gives a temporary one
        return dataclasses.replace(
            super().config(full), incident_watch="on", autopilot="on",
            train_dir=train_dir).validate()

    def _config_in(self, full: bool, train_dir: str):
        return self.config(full, train_dir)

    def _observers(self, runner, cfg, client, train_dir: str) -> tuple:
        from types import SimpleNamespace

        pilot = runner._make_autopilot()
        pilot.attach(client)
        engine = SimpleNamespace(client=client)
        return runner.heartbeat, lambda step: pilot.act(step, engine)


# the autopilot on the cyclic shared leg, beside chunk_simulate (the same
# family's chunk): no sync inside a chunk, one fetch a flush with the
# autopilot's decisions in it
AUTOPILOT_CHUNKS = (AutopilotChunkProgram("chunk_shared_autopilot", "shared"),)


def collect_chunks() -> "list[ChunkProgram]":
    return list(CHUNKS)


def collect_autopilot() -> "list[ChunkProgram]":
    return list(AUTOPILOT_CHUNKS)


def collect_guard() -> list:
    """The resilience legs and their chunk."""
    return list(GUARD_PROGRAMS + GUARD_CHUNKS)


def collect() -> "list[LintProgram]":
    names = [p.name for p in PROGRAMS]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate lint program names: {names}")
    return list(PROGRAMS)


def get(name: str):
    every = (PROGRAMS + CHUNKS + GUARD_PROGRAMS + GUARD_CHUNKS
             + AUTOPILOT_CHUNKS)
    for p in every:
        if p.name == name:
            return p
    raise KeyError(f"no lint program named {name!r}; registered: "
                   f"{[p.name for p in every]}")
