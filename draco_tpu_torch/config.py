"""Experiment configuration — the slice of ``draco_tpu.config.TrainConfig``
the port runs.

Field names and defaults are the reference's. ``validate()`` keeps the
reference's checks on these fields and rejects, with a clear error, every
value the port does not implement yet. Four reference fields have no port
field yet: ``pp_microbatches`` and ``expert_shards`` (the LM's sharded
routes) and ``compile_guard`` and ``compile_warmup`` (the reference's
compile ledger).

The repetition code (``approach="maj_vote"``) votes on the bits of its
group members' gradient rows: the lanes of a group must compute bit for
bit the same gradient, which on the card holds only with cuDNN restricted
to its deterministic algorithms (at its default settings every honest
lane differs, PERF.md §6). The maj_vote step runs its lanes under
``torch.backends.cudnn.deterministic`` (``training/step.py``), a property
of the route, not a switch; it costs the chunked step about 5%.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from draco_tpu_torch.coding.assignment import build_assignment
from draco_tpu_torch.coding.topology import (TOPOLOGIES, group_worker_fail,
                                             tree_plan)
from draco_tpu_torch.obs.numerics import (SHADOW_WIRES, WIRE_DTYPES,
                                          wire_rel_tol)
from draco_tpu_torch.ops.flash_attention import MAX_DH
from draco_tpu_torch.optim import OPTIMIZERS, SCHEDULES

# Deterministic seed shared by every participant (reference: SEED_=428).
SEED = 428

APPROACHES = ("baseline", "maj_vote", "cyclic", "approx")
# the baseline's aggregation rules (aggregation.py): the reference's three
# (normal, geometric_median, krum) and its robust baselines beyond them
AGG_MODES = ("normal", "geometric_median", "krum", "coord_median",
             "trimmed_mean", "multi_krum", "bulyan")
KRUM_MODES = ("krum", "multi_krum", "bulyan")
CNN_NETWORKS = ("LeNet", "FC", "ResNet18", "ResNet34", "ResNet50",
                "ResNet101", "ResNet152", "VGG11", "VGG11_bn", "VGG13",
                "VGG13_bn", "VGG16", "VGG16_bn", "VGG19", "VGG19_bn")
LM_NETWORK = "TransformerLM"
NETWORKS = CNN_NETWORKS + (LM_NETWORK,)
LM_DATASET = "synthetic-text"  # the LM trains on sp_step.synthetic_text
ERR_MODES = ("rev_grad", "constant", "random", "alie", "ipm")
# the coded kernels' block width (ops.decode_kernels.MAX_N): a coded step
# of more workers could not launch them
MAX_CODED_WORKERS = 64


@dataclasses.dataclass
class TrainConfig:
    # --- model / data ---
    network: str = "LeNet"
    dataset: str = "MNIST"
    data_dir: str = "./data"
    batch_size: int = 128  # per-worker batch size
    test_batch_size: int = 1000  # the test-set evaluation's batch
    # --- optimization (optim.py) ---
    optimizer: str = "sgd"  # sgd | adam | adamw (decoupled decay)
    lr: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 0.01  # adamw's decoupled decay (unused by sgd/adam)
    lr_schedule: str = "constant"  # constant | cosine (warmup + cosine to 10%)
    warmup_steps: int = 0  # linear warmup length for lr_schedule=cosine
    clip_norm: float = 0.0  # >0: global-norm clip of the aggregated gradient
    max_steps: int = 10000
    # --- coded data parallelism ---
    num_workers: int = 8
    approach: str = "baseline"  # baseline | maj_vote | cyclic | approx
    mode: str = "normal"  # baseline aggregation: one of AGG_MODES
    # --- repetition code (approach="maj_vote") ---
    group_size: int = 3  # r: members of a group compute the same batch
    # the vote's row-equality check: "fingerprint" = two salted 32-bit
    # hashes of each row's bits (one pass, the row_fingerprints kernel);
    # "exact" = pairwise bit equality of the rows, O(r²·d)
    vote_check: str = "fingerprint"
    worker_fail: int = 0  # s
    # --- approximate code (approach="approx") ---
    code_redundancy: float = 1.5  # r in [1, n]: batches per worker
    # the decode is dimensioned for up to ⌈straggler_alpha · n⌉ absent
    # workers a step
    straggler_alpha: float = 0.25
    assignment_scheme: str = "pairwise"  # pairwise | clustered
    err_mode: str = "rev_grad"  # rev_grad | constant | random | alie | ipm
    adversarial: float = -100.0
    adversary_count: Optional[int] = None  # None = worker_fail
    # --- stragglers: "drop" = straggle_count workers a step never arrive
    # (erasures at known positions; rng.straggler_schedule) ---
    straggle_mode: str = "none"  # none | drop
    straggle_count: int = 0
    redundancy: str = "simulate"  # simulate | shared
    # "layer": the cyclic decode runs one locator a parameter tensor, as
    # the reference's per-layer decode; the approx code decodes globally
    decode_granularity: str = "global"
    decode_impl: str = "auto"  # auto | pallas: kernel on cuda, plain on cpu
    # --- TransformerLM (network="TransformerLM"; single shard only) ---
    seq_len: int = 256  # tokens per sequence
    vocab: int = 256
    model_dim: int = 128
    model_heads: int = 4
    model_layers: int = 2
    # single-shard attention: "dense" materialises (T, T) scores per head;
    # "flash" runs the blockwise kernels (ops/flash_attention.py)
    attn_impl: str = "dense"
    # forward/backward dtype of the convolutions and Dense layers
    # (parameters, BN statistics, the LM's attention math and the logits
    # stay float32)
    compute_dtype: str = "float32"
    # every eval_freq steps (0 = never): the CNN's test-set accuracy or the
    # LM's held-out loss, then a checkpoint into train_dir
    eval_freq: int = 50
    # --- the wire: what the coded rows cross it as (obs/numerics.py):
    # f32, or bf16 / int8 with per-block scales over shadow_block elements,
    # rounded to nearest or "stochastic" (one draw a step shared by every
    # row, the reference's stream) ---
    wire_dtype: str = "f32"  # f32 | bf16 | int8
    shadow_block: int = 256
    shadow_round: str = "nearest"
    # the segmented wire: S > 1 cuts d into S segments (obs/numerics
    # .wire_segment_bounds), each decoded on its own and their verdicts
    # folded to one a step (cyclic, approx); on maj_vote the wire only
    wire_segments: int = 1
    # --- the numerics observatory (obs/numerics.py): "on" adds each
    # step's dynamic-range columns of the gradients, the wire and the
    # decoded aggregate; shadow_wire rounds the f32 codewords to bf16 /
    # int8 (at shadow_block, shadow_round) and decodes them a second time
    # beside the f32 decode, which alone updates; coded approaches only ---
    numerics_watch: str = "off"  # off | on
    shadow_wire: str = "off"  # off | bf16 | int8
    # --- the tree topology (coding/topology.py): topology="tree" splits
    # the workers into n / tree_fanout leaf groups of fan-in g, each
    # running one small code (cyclic at s_g = min(worker_fail, (g - 1) //
    # 4), approx at code_redundancy), their decoded partials combined
    # level by level; cyclic/approx, shared redundancy, global decode
    # granularity; composes with wire_dtype and wire_segments ---
    topology: str = "flat"  # flat | tree
    tree_fanout: int = 4  # leaf-group size g (must divide num_workers)
    # total tree levels including the leaf level; 0 = auto
    # (1 + ceil(log_g(n/g)), coding/topology.auto_levels)
    tree_levels: int = 0
    # --- the LM's sequence parallelism and layer stack ---
    # sequence shards (the reference's sp mesh axis; on one card a tensor
    # axis of the attention, parallel/ring_attention.py)
    seq_shards: int = 1
    # the sp attention: "ring" (K/V blocks folded shard by shard) or "a2a"
    # (Ulysses head scatter; needs model_heads % seq_shards == 0)
    sp_attn: str = "ring"
    # recompute each block in the backward from its input
    # (models/transformer.py)
    remat: bool = False
    # the blocks' parameters stacked on a leading layer axis, one block
    # body run L times (the reference's nn.scan; a different tree)
    scan_layers: bool = False
    # --- the LM's model-parallel routes, each shard axis a tensor axis on
    # one card (parallel/tp_step.py, pp_step.py, ep_step.py); at most one
    # is active ---
    # Megatron tensor shards: column-parallel qkv/mlp_in, row-parallel
    # proj/mlp_out as per-shard partial sums
    tensor_shards: int = 1
    # Switch mixture-of-experts experts per block (0 = the dense MLP;
    # models/moe.py)
    moe_experts: int = 0
    # the reference's expert shards (needs moe_experts > 0): selects the
    # ep route, whose one-card step is the MoE's as it is (ep_step.py)
    expert_shards: int = 1
    # GPipe stages the block stack splits into
    pipeline_shards: int = 1
    # microbatches per pipeline step (0 = pipeline_shards); > 0 alone
    # selects the pipeline route
    pp_microbatches: int = 0
    # the LM's tokens: "host" (synthetic_text, uploaded) or "device" (made
    # on the card from the staged step, the reference's in-graph stream)
    token_gen: str = "host"
    # steps a dispatch: K > 1 runs the chunked loops (on the card, one
    # captured CUDA graph replayed K times a chunk)
    steps_per_call: int = 1
    # --- run ---
    train_dir: str = "./train_out/"
    # a label status.json carries (obs/heartbeat.py); "" leaves it out
    job_name: str = ""
    # resume from this step's checkpoint if > 0; -1 resumes from the newest
    # loadable one in train_dir (corrupt ones are walked past,
    # resilience/supervisor.restore_with_walkback)
    checkpoint_step: int = 0
    # zlib level 1 for the .dcg checkpoints (the reference's compressed
    # checkpoint); False writes the same container stored (level 0), where
    # the reference writes an Orbax directory (utils/checkpoint.py)
    compress_ckpt: bool = False
    # after each save keep only the newest N checkpoints (0 = all); N >= 2
    # leaves the walk-back an older one past a torn newest
    keep_checkpoints: int = 0
    # bound on a chunked loop's wait for its prefetch worker (0 = wait
    # forever): a dead or hung worker raises PrefetchStallError
    prefetch_timeout_s: float = 300.0
    # a prefetcher that fails or stalls is rebuilt, with a backoff, up to
    # this many times a request before the error propagates (0 = off)
    prefetch_restarts: int = 2
    # host span trace of the loops' phases (obs/tracer.py) at
    # trace_dir/trace.json; "" = off
    trace_dir: str = ""
    # --- resilience (resilience/faults.py, resilience/guards.py) ---
    # "on": the step guard skips an untrusted step's update by a select
    # (a non-finite aggregate, a loud decode residual, located rows past
    # the budget), the step counter still advancing, and appends the
    # guard_trips / skipped_steps columns; "off" keeps the unguarded update
    step_guard: str = "off"
    # decode_residual above this is loud (clean decodes sit at f32 solve
    # noise, ~1e-6 relative), widened by the narrow wire's slack
    guard_residual_tol: float = 1e-3
    # the seeded fault plan: comma-separated "kind@step[-end][:w<worker>]
    # [:d<dwell>][:every<k>]" events (resilience/faults.py); "" = none
    fault_spec: str = ""
    # "on": the incident engine (obs/incidents.py) folds the records and
    # beats into episodes, train_dir/incidents.jsonl and status.json's
    # incidents block (host only); needs a train_dir to write them
    incident_watch: str = "off"
    # "<detector>.<key>=<float>,..." overrides of the detectors' thresholds
    incident_thresholds: str = ""
    # "on": the autopilot (control/autopilot.py) reads the incident stream
    # at every flush of the chunked loop and remediates: quarantine a
    # trust-collapsed worker through the presence schedule, dial the wire
    # (dtype, segments, tree fanout) and the code family (cyclic <-> approx)
    # by swapping between captured step graphs that share one state, drop
    # the shadow dtype; each decision a remediation line in incidents.jsonl
    # and status.json's control block. Needs incident_watch="on", a
    # train_dir, steps_per_call > 1 and a cyclic or approx code
    autopilot: str = "off"
    # "<key>=<float>,..." overrides of control/autopilot.DEFAULT_POLICY
    autopilot_policy: str = ""
    log_every: int = 10
    seed: int = SEED
    geomedian_iters: int = 80

    @property
    def s(self) -> int:
        return self.worker_fail

    @property
    def hat_s(self) -> int:
        return 2 * self.worker_fail + 1

    @property
    def num_groups(self) -> int:
        return self.num_workers // self.group_size

    @property
    def tree_group_fail(self) -> int:
        """The tree's per-group cyclic budget s_g = min(worker_fail,
        (tree_fanout - 1) // 4)."""
        return group_worker_fail(self.tree_fanout, self.worker_fail)

    @property
    def num_adversaries(self) -> int:
        return (self.worker_fail if self.adversary_count is None
                else self.adversary_count)

    def validate(self) -> "TrainConfig":
        if self.approach not in APPROACHES:
            raise ValueError(
                f"approach={self.approach!r} is not ported yet (the port "
                f"runs {'|'.join(APPROACHES)})")
        if self.approach == "baseline" and self.mode not in AGG_MODES:
            raise ValueError(
                f"baseline supports mode in {'|'.join(AGG_MODES)}, got: "
                f"{self.mode}")
        if (self.mode in KRUM_MODES
                and self.num_workers < self.worker_fail + 3):
            raise ValueError(
                f"{self.mode} requires num_workers >= worker_fail + 3")
        if (self.mode in ("trimmed_mean", "bulyan")
                and self.num_workers <= 2 * self.worker_fail):
            raise ValueError(
                f"{self.mode} requires num_workers > 2 * worker_fail")
        self._validate_optimizer()
        if self.network not in NETWORKS:
            raise ValueError(
                f"network={self.network!r} is not ported yet (the port runs "
                f"{'|'.join(NETWORKS)})")
        if self.err_mode not in ERR_MODES:
            raise ValueError(
                f"err_mode={self.err_mode!r} is not ported yet (the port "
                f"runs {'|'.join(ERR_MODES)})")
        if self.err_mode in ("alie", "ipm") and self.approach == "cyclic":
            raise ValueError(
                f"err_mode={self.err_mode} targets approximate robust "
                f"aggregation (baseline modes / maj_vote); the cyclic path's "
                f"attack surface is the encoded rows, where decode is exact "
                f"and any per-row corruption is removed — use rev_grad/"
                f"constant there (attacks.py)")
        if self.approach == "maj_vote":
            self._validate_vote()
        if self.redundancy not in ("simulate", "shared"):
            raise ValueError(f"unknown redundancy: {self.redundancy!r}")
        if self.decode_granularity not in ("global", "layer"):
            raise ValueError(
                f"decode_granularity must be global|layer, got "
                f"{self.decode_granularity}")
        if self.decode_impl not in ("auto", "pallas"):
            raise ValueError(
                f"decode_impl={self.decode_impl!r} is not ported (auto|pallas:"
                f" the kernels on cuda, their plain versions on cpu)")
        if self.wire_segments < 1:
            raise ValueError(
                f"wire_segments must be >= 1, got {self.wire_segments}")
        if self.wire_segments > 1 and self.approach not in (
                "cyclic", "maj_vote", "approx"):
            # the baseline ships raw rows, with no decode to segment; the
            # vote is row-wise, not separable over d: on maj_vote the
            # segments cut the wire only and the vote is unchanged
            raise ValueError(
                "wire_segments > 1 requires a coded approach "
                f"(cyclic|maj_vote|approx), got {self.approach!r}")
        self._validate_topology()
        if self.approach != "baseline" and \
                self.num_workers > MAX_CODED_WORKERS:
            raise ValueError(
                f"approach={self.approach!r} takes at most "
                f"{MAX_CODED_WORKERS} workers (the coded kernels' block "
                f"width), got num_workers={self.num_workers}")
        if (self.approach == "cyclic" and self.topology == "flat"
                and self.num_workers <= 4 * self.worker_fail):
            raise ValueError(
                f"cyclic code needs n > 4s (got n={self.num_workers}, "
                f"s={self.worker_fail})")
        if self.worker_fail > self.num_workers:
            raise ValueError("worker_fail cannot exceed num_workers")
        if self.adversary_count is not None and not (
                0 <= self.adversary_count <= self.worker_fail):
            raise ValueError(
                "adversary_count must lie in [0, worker_fail] (the code is "
                f"only built to tolerate worker_fail={self.worker_fail})")
        if self.batch_size < 1 or self.num_workers < 1:
            raise ValueError("batch_size and num_workers must be >= 1")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be float32|bfloat16, got "
                             f"{self.compute_dtype}")
        self._validate_chunk()
        self._validate_run_state()
        self._validate_resilience()
        if self.approach == "approx":
            self._validate_approx()
        self._validate_stragglers()
        self._validate_wire()
        if self.network == LM_NETWORK:
            self._validate_lm()
        elif self.seq_shards > 1:
            raise ValueError("seq_shards > 1 requires network=TransformerLM")
        elif self.tensor_shards > 1:
            raise ValueError("tensor_shards > 1 requires network=TransformerLM")
        elif self.expert_shards > 1 or self.moe_experts > 0:
            raise ValueError(
                "moe_experts / expert_shards require network=TransformerLM")
        elif self.pipeline_shards > 1:
            raise ValueError(
                "pipeline_shards > 1 requires network=TransformerLM")
        return self

    def _validate_optimizer(self) -> None:
        """The reference's optimizer checks (draco_tpu/config.py)."""
        if self.optimizer not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer: {self.optimizer}")
        if self.lr_schedule not in SCHEDULES:
            raise ValueError(f"unknown lr_schedule: {self.lr_schedule}")
        if self.warmup_steps < 0:
            raise ValueError(
                f"warmup_steps must be >= 0, got {self.warmup_steps}")
        if self.clip_norm < 0:
            raise ValueError(f"clip_norm must be >= 0, got {self.clip_norm}")
        if self.warmup_steps > 0 and self.lr_schedule == "constant":
            raise ValueError(
                "warmup_steps > 0 has no effect with lr_schedule=constant — "
                "set --lr-schedule cosine (or drop --warmup-steps)")

    def _validate_topology(self) -> None:
        """The reference's tree checks (draco_tpu/config.py)."""
        if self.topology not in TOPOLOGIES:
            raise ValueError(f"topology must be one of "
                             f"{'|'.join(TOPOLOGIES)}, got {self.topology!r}")
        if self.topology != "tree":
            return
        if self.approach not in ("cyclic", "approx"):
            raise ValueError(
                "topology='tree' supports the algebraic code families "
                f"(cyclic|approx), got approach={self.approach!r} — "
                "maj_vote's repetition groups are already a one-level tree "
                "of constant fan-in 2s+1")
        if self.redundancy != "shared":
            raise ValueError(
                "topology='tree' requires redundancy='shared': each leaf "
                "group's code mixes its own batch rows in place (the "
                "simulate lanes have no per-group shape)")
        if self.decode_granularity != "global":
            raise ValueError(
                "topology='tree' requires decode_granularity='global' — the "
                "tree already partitions the locator per group (compose "
                "with --wire-segments instead)")
        # divisibility, the group count, the levels' feasibility
        tree_plan(self.num_workers, self.tree_fanout, self.tree_levels)
        if self.approach == "cyclic":
            s_g = self.tree_group_fail
            if self.num_adversaries > s_g:
                # worst case every adversary lands in one leaf group
                raise ValueError(
                    f"tree per-group budget exceeded: adversary_count="
                    f"{self.num_adversaries} > s_g={s_g} (= min(worker_fail, "
                    f"(tree_fanout-1)//4) — raise tree_fanout past "
                    f"{4 * self.num_adversaries} or reduce the adversary "
                    f"load)")

    def _validate_run_state(self) -> None:
        """The reference's checks of the prefetch, checkpoint and resume
        fields (draco_tpu/config.py)."""
        if self.prefetch_timeout_s < 0:
            raise ValueError(
                f"prefetch_timeout_s must be >= 0, got "
                f"{self.prefetch_timeout_s}")
        if self.prefetch_restarts < 0:
            raise ValueError(
                f"prefetch_restarts must be >= 0, got "
                f"{self.prefetch_restarts}")
        if self.keep_checkpoints < 0:
            raise ValueError(
                f"keep_checkpoints must be >= 0, got {self.keep_checkpoints}")
        if self.checkpoint_step < -1:
            raise ValueError(
                "checkpoint_step must be >= -1 (-1 resumes from the newest "
                f"loadable checkpoint), got {self.checkpoint_step}")

    def _validate_resilience(self) -> None:
        """The reference's checks of the guard, the fault plan and the
        incident watch (draco_tpu/config.py)."""
        if self.incident_watch not in ("off", "on"):
            raise ValueError(
                f"incident_watch must be off|on, got {self.incident_watch!r}")
        if self.incident_thresholds:
            from draco_tpu_torch.obs.incidents import parse_thresholds

            parse_thresholds(self.incident_thresholds)
        self._validate_autopilot()
        if self.step_guard not in ("off", "on"):
            raise ValueError(
                f"step_guard must be off|on, got {self.step_guard!r}")
        if self.guard_residual_tol <= 0:
            raise ValueError(f"guard_residual_tol must be > 0, got "
                             f"{self.guard_residual_tol}")
        if not self.fault_spec:
            return
        from draco_tpu_torch.resilience.faults import FaultPlan

        plan = FaultPlan.parse(self.fault_spec, self.seed, self.num_workers)
        if self.approach == "approx" and plan.of_kind("over_budget",
                                                      "adversary"):
            # both kinds mark schedule rows as live adversaries, which the
            # approx code never injects
            raise ValueError(
                "fault kinds over_budget/adversary are not expressible "
                "under approach=approx (the family injects no "
                "adversaries); use straggle/nan_grad/host kinds, or "
                "cyclic/maj_vote for Byzantine-budget faults")

    def _validate_autopilot(self) -> None:
        """The reference's autopilot checks, in its order and with its
        messages (draco_tpu/config.py)."""
        if self.autopilot not in ("off", "on"):
            raise ValueError(
                f"autopilot must be off|on, got {self.autopilot!r}")
        if self.autopilot == "on":
            if self.incident_watch != "on":
                raise ValueError(
                    "autopilot='on' requires incident_watch='on' — the "
                    "incident stream IS the sensing layer the policy "
                    "engine actuates on (control/autopilot.py)")
            if not self.train_dir:
                raise ValueError(
                    "autopilot='on' needs a train_dir (the incident "
                    "stream and the control status block live there)")
            if self.steps_per_call <= 1 and not (
                    self.network == LM_NETWORK
                    and self.token_gen == "device"):
                raise ValueError(
                    "autopilot='on' requires the chunked regime "
                    "(steps_per_call > 1): chunk boundaries are the "
                    "actuation points — remediations apply between "
                    "dispatched chunks, never inside one")
            if self.approach not in ("cyclic", "approx"):
                raise ValueError(
                    "autopilot='on' supports the algebraic code families "
                    f"(cyclic|approx), got approach={self.approach!r} — "
                    "the redundancy dial swaps between exactly those two")
        if self.autopilot_policy:
            from draco_tpu_torch.control.autopilot import parse_policy

            parse_policy(self.autopilot_policy)

    def _validate_vote(self) -> None:
        """The reference's maj_vote checks (draco_tpu/config.py)."""
        if self.vote_check not in ("fingerprint", "exact"):
            raise ValueError(f"vote_check must be 'fingerprint' or 'exact', "
                             f"got {self.vote_check!r}")
        if self.group_size < 1:
            raise ValueError(f"group_size must be >= 1, got "
                             f"{self.group_size}")
        if self.num_workers % self.group_size != 0:
            raise ValueError(
                "maj_vote requires num_workers divisible by group_size "
                f"(got {self.num_workers} % {self.group_size})")
        if self.worker_fail > 0 and \
                self.group_size < 2 * self.worker_fail + 1:
            # r = 2s+1: with fewer members all s adversaries can land in
            # one group and break its majority
            raise ValueError(
                f"maj_vote with worker_fail={self.worker_fail} requires "
                f"group_size >= {2 * self.worker_fail + 1} (r = 2s+1)")

    def _validate_chunk(self) -> None:
        """The chunked loops (``steps_per_call`` K > 1: K steps a dispatch,
        on the card replays of one captured CUDA graph) and the token
        source. Every draw a step makes on the device (the random attack,
        stochastic rounding, the device tokens) reads the staged step, so
        each option runs in chunks as it runs eagerly."""
        if self.steps_per_call < 1:
            raise ValueError(
                f"steps_per_call must be >= 1, got {self.steps_per_call}")
        if self.token_gen not in ("host", "device"):
            raise ValueError(
                f"token_gen must be host|device, got {self.token_gen!r}")
        if self.token_gen == "device" and self.network != LM_NETWORK:
            # the CNN Trainer trains on dataset rows, not a generated token
            # stream: there is nothing for the device generator to replace
            raise ValueError(
                "token_gen='device' applies to the TransformerLM token "
                "routes only (the CNN Trainer reads dataset batches)")

    def _validate_approx(self) -> None:
        """The reference's approx checks (draco_tpu/config.py)."""
        if self.num_adversaries > 0:
            # the decode weights average whatever arrives: no locator, so
            # one live Byzantine row poisons the decode undetectably
            raise ValueError(
                "approach=approx carries no Byzantine certificate: set "
                "worker_fail=0 (or adversary_count=0) — use cyclic for live "
                "adversaries")
        if self.redundancy != "shared":
            raise ValueError(
                "approach=approx requires redundancy='shared' (the "
                "assignment's fractional loads have no fixed-lane simulate "
                "shape)")
        if not 1.0 <= self.code_redundancy <= self.num_workers:
            raise ValueError(
                f"code_redundancy must lie in [1, num_workers], got "
                f"{self.code_redundancy} at n={self.num_workers}")
        if not 0.0 <= self.straggler_alpha < 1.0:
            raise ValueError(f"straggler_alpha must lie in [0, 1), got "
                             f"{self.straggler_alpha}")
        # scheme name, clustered integrality and divisibility fail here,
        # not mid-run
        build_assignment(self.num_workers, self.code_redundancy,
                         self.assignment_scheme)

    def _validate_stragglers(self) -> None:
        """The reference's straggler budgets. Erasures cost one redundancy
        unit, unknown errors two: the cyclic decode covers t = 0 with
        e ≤ 2s, or t + e ≤ s; the approx code is dimensioned for
        e ≤ ⌈α·n⌉."""
        if self.straggle_mode not in ("none", "drop"):
            raise ValueError(f"unknown straggle_mode: {self.straggle_mode}")
        e = self.straggle_count if self.straggle_mode == "drop" else 0
        if e <= 0:
            return
        s, t, n = self.worker_fail, self.num_adversaries, self.num_workers
        tree = self.topology == "tree"
        if tree:
            # the per-group budget: every straggler and adversary may land
            # in one leaf group
            s = self.tree_group_fail
        if self.approach == "maj_vote":
            if e >= self.group_size:
                raise ValueError(
                    f"straggle_count {e} >= group_size {self.group_size} can "
                    "silence an entire repetition group")
            # worst case all e stragglers and all t adversaries land in one
            # group: the group_size - e present members need an honest
            # majority
            if t > 0 and self.group_size - e <= 2 * t:
                raise ValueError(
                    f"maj_vote joint budget exceeded: group_size - "
                    f"straggle_count must exceed 2*adversaries "
                    f"({self.group_size} - {e} <= {2 * t}); an unlucky "
                    "group could be voted over by adversarial rows")
        if self.approach == "baseline":
            if e >= n:
                raise ValueError(
                    "straggle_count must leave at least one worker")
            if self.mode in KRUM_MODES and n - e < s + 3:
                raise ValueError(
                    f"{self.mode} needs num_workers - straggle_count >= "
                    f"worker_fail + 3 ({n} - {e} < {s} + 3)")
            if (self.mode in ("coord_median", "trimmed_mean", "bulyan")
                    and n - e <= 2 * s):
                # the median-based rules need an honest majority among the
                # rows that arrive
                raise ValueError(
                    f"{self.mode} needs num_workers - straggle_count > "
                    f"2 * worker_fail ({n} - {e} <= {2 * s})")
        if self.approach == "cyclic" and not (
                (t == 0 and e <= 2 * s) or t + e <= s):
            raise ValueError(
                f"cyclic {'per-group (tree) ' if tree else ''}straggler "
                f"budget exceeded: need adversary_count + "
                f"straggle_count <= s ({t}+{e} <= {s}), or adversary_count "
                f"== 0 with straggle_count <= 2*s ({e} <= {2 * s})")
        if self.approach == "approx" and e > math.ceil(
                self.straggler_alpha * n):
            raise ValueError(
                f"approx straggler budget exceeded: straggle_count {e} > "
                f"ceil(straggler_alpha * n) = "
                f"{math.ceil(self.straggler_alpha * n)}")

    def _validate_wire(self) -> None:
        """The reference's wire checks."""
        if self.wire_dtype not in WIRE_DTYPES:
            raise ValueError(f"wire_dtype must be {'|'.join(WIRE_DTYPES)}, "
                             f"got {self.wire_dtype!r}")
        if self.wire_dtype != "f32":
            if self.approach not in ("cyclic", "maj_vote", "approx"):
                raise ValueError(
                    "wire_dtype != f32 requires a coded approach "
                    f"(cyclic|maj_vote|approx), got {self.approach!r}")
            # the tree decodes a group at a time: the threshold at the
            # group shape (fan-in, s_g)
            wn, ws = ((self.tree_fanout, self.tree_group_fail)
                      if self.topology == "tree"
                      else (self.num_workers, self.worker_fail))
            if self.approach == "cyclic" and not wire_rel_tol(
                    wn, ws, self.wire_dtype) < 1.0:
                raise ValueError(
                    f"no usable narrow-wire flag threshold at (n={wn}, "
                    f"s={ws}, {self.wire_dtype}) — route the narrow wire "
                    f"through approach=approx")
        if self.shadow_round not in ("nearest", "stochastic"):
            raise ValueError(f"shadow_round must be nearest|stochastic, got "
                             f"{self.shadow_round!r}")
        if self.shadow_block < 1:
            raise ValueError(
                f"shadow_block must be >= 1, got {self.shadow_block}")
        self._validate_watch()

    def _validate_watch(self) -> None:
        """The reference's observatory checks (draco_tpu/config.py)."""
        if self.numerics_watch not in ("off", "on"):
            raise ValueError(f"numerics_watch must be off|on, got "
                             f"{self.numerics_watch!r}")
        if self.shadow_wire not in SHADOW_WIRES:
            raise ValueError(f"shadow_wire must be {'|'.join(SHADOW_WIRES)}"
                             f", got {self.shadow_wire!r}")
        if self.wire_dtype != "f32" and self.shadow_wire != "off":
            raise ValueError(
                "wire_dtype and shadow_wire are mutually exclusive: the "
                "shadow measures a candidate dtype against the f32 wire, "
                "which a narrow wire no longer ships (set shadow_wire=off, "
                "or keep wire_dtype=f32 while calibrating)")
        if self.topology == "tree" and self.shadow_wire != "off":
            raise ValueError(
                "topology='tree' composes with the narrow wire "
                "(--wire-dtype) but not the shadow decode (--shadow-wire "
                "measures the flat locator; run it at topology='flat')")
        if ((self.numerics_watch == "on" or self.shadow_wire != "off")
                and self.approach not in ("cyclic", "maj_vote", "approx")):
            raise ValueError(
                "numerics_watch/shadow_wire require a coded approach "
                f"(cyclic|maj_vote|approx), got {self.approach!r}")

    def _validate_lm(self) -> None:
        """The reference's TransformerLM checks (draco_tpu/config.py)."""
        if self.dataset != LM_DATASET:
            raise ValueError(f"network={LM_NETWORK} trains on the "
                             f"{LM_DATASET!r} token stream, got dataset="
                             f"{self.dataset!r}")
        if self.model_dim % self.model_heads != 0:
            raise ValueError(f"model_dim {self.model_dim} not divisible by "
                             f"model_heads {self.model_heads}")
        if (self.model_dim // self.model_heads) % 2 != 0:
            raise ValueError(
                "head dim must be even for the rotary embedding "
                f"(model_dim/model_heads = "
                f"{self.model_dim // self.model_heads})")
        if self.attn_impl not in ("dense", "flash"):
            raise ValueError(
                f"attn_impl must be dense|flash, got {self.attn_impl}")
        head_dim = self.model_dim // self.model_heads
        if self.attn_impl == "flash" and head_dim > MAX_DH:
            raise ValueError(
                f"attn_impl='flash': the port's flash kernels take head dims "
                f"up to {MAX_DH}, this model's is {head_dim} (model_dim "
                f"{self.model_dim} / model_heads {self.model_heads}); "
                f"attn_impl='dense' trains it")
        if self.seq_len < 2 or self.vocab < 1 or self.model_layers < 1:
            raise ValueError("seq_len >= 2, vocab >= 1 and model_layers >= 1")
        if self.approach == "maj_vote":
            raise ValueError(
                "approach=maj_vote is not supported for TransformerLM: the "
                "vote's bitwise-equality contract is specified over "
                "replicated CNN lanes (use baseline or cyclic; "
                "draco_tpu/parallel/sp_step.py)")
        if self.seq_shards < 1:
            raise ValueError(f"seq_shards must be >= 1, got "
                             f"{self.seq_shards}")
        if self.seq_len % self.seq_shards != 0:
            raise ValueError(f"seq_len {self.seq_len} not divisible by "
                             f"seq_shards {self.seq_shards}")
        if self.sp_attn not in ("ring", "a2a"):
            raise ValueError(f"sp_attn must be ring|a2a, got {self.sp_attn}")
        self._validate_model_parallel()

    def _validate_model_parallel(self) -> None:
        """The reference's checks of the LM's model-parallel axes
        (draco_tpu/config.py), in its order and with its messages."""
        if self.attn_impl == "flash" and (
                self.tensor_shards > 1 or self.expert_shards > 1
                or self.moe_experts > 0):
            raise ValueError(
                "attn_impl=flash runs on the shard_map paths (sp/pp): "
                "the GSPMD paths (tensor_shards/expert_shards/moe) "
                "cannot partition an opaque Pallas call over the mesh")
        # pp_microbatches alone selects the pipeline route (cli.py), so it
        # counts as the pp axis in use
        pp_active = self.pipeline_active
        if (sum(int(x > 1) for x in (self.tensor_shards, self.seq_shards,
                                     self.expert_shards))
                + int(pp_active) > 1):
            raise ValueError(
                "tensor_shards / seq_shards / expert_shards / "
                "pipeline_shards are separate paths (tp_step / sp_step / "
                "ep_step / pp_step); combining model-parallel axes is "
                "not implemented")
        if self.expert_shards > 1:
            if self.moe_experts <= 0:
                raise ValueError("expert_shards > 1 needs moe_experts > 0")
            if self.moe_experts % self.expert_shards:
                raise ValueError(
                    f"expert_shards={self.expert_shards} must divide "
                    f"moe_experts {self.moe_experts}")
        if self.moe_experts < 0:
            raise ValueError("moe_experts must be >= 0")
        if self.moe_experts > 0 and self.seq_shards > 1:
            raise ValueError(
                "moe_experts > 0 with seq_shards > 1 is not implemented: "
                "per-shard MoE routing/capacity would break sp "
                "layout-invariance")
        if self.tensor_shards > 1:
            if self.moe_experts > 0:
                raise ValueError(
                    "tensor_shards with moe_experts is not implemented "
                    "(the tp partition rules cover the dense MLP only)")
            if (self.model_dim % self.tensor_shards
                    or self.model_heads % self.tensor_shards):
                raise ValueError(
                    f"tensor_shards={self.tensor_shards} must divide "
                    f"model_dim {self.model_dim} and model_heads "
                    f"{self.model_heads}")
        if (self.sp_attn == "a2a" and self.seq_shards > 1
                and self.model_heads % self.seq_shards != 0):
            raise ValueError(
                f"sp_attn=a2a needs model_heads % seq_shards == 0 "
                f"({self.model_heads} % {self.seq_shards})")
        if self.pp_microbatches < 0 or self.pipeline_shards < 1:
            raise ValueError(
                "pipeline_shards must be >= 1 and pp_microbatches >= 0")
        if pp_active:
            if self.moe_experts > 0:
                raise ValueError(
                    "the pipeline path with moe_experts is not implemented "
                    "(pp_step's scanned block stack covers the dense "
                    "MLP only)")
            if self.model_layers % max(self.pipeline_shards, 1):
                raise ValueError(
                    f"pipeline_shards={self.pipeline_shards} must divide "
                    f"model_layers {self.model_layers}")
            mb = self.pp_microbatches or self.pipeline_shards
            if self.batch_size % mb:
                raise ValueError(
                    f"pipeline microbatch count {mb} must divide "
                    f"batch_size {self.batch_size}")

    @property
    def pipeline_active(self) -> bool:
        """The pipeline route is selected: ``pipeline_shards > 1`` or
        ``pp_microbatches > 0`` (the reference's cli.py)."""
        return self.pipeline_shards > 1 or self.pp_microbatches > 0
