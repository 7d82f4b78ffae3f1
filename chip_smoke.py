#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``draco_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--steps N] [--lm-steps N] [--profile] [--out FILE]

Phases, each of which raises on failure (the script then exits non-zero and
prints no result line):

  1. build    every kernel of ``draco_tpu_torch/csrc`` with nvcc, in
              parallel, and beside them the old one-block-a-column locator
              (``obs/locator_ab.cu``), the yardstick of the wide codes
  2. kernels  each kernel against its plain PyTorch version on the card, at
              the main paths' shapes: the coded products at n=8,
              d=11,173,962 and at the VGG-11 legs' n=9, d=9,750,922, the
              encode also at the LM's d=62,958,336, each bit for bit
              across two launches; the locator at L=1 and L=62 columns,
              n=8, s=1, with an attacked row, an absent row, a λ>0 case
              and NaN-poisoned columns, and at n=9, s=2 with two attacked
              rows, an attacked row beside an absent one, a λ>0 clean
              column and a NaN row; at the wide codes n=32, s=3 and s=5
              (attacked rows, an absent row, λ>0, a NaN row) and n=40,
              s=3 (two rows a lane) beside the old one-block-a-column kernel
              (``obs/locator_ab``), held to the plain version at least as
              well as it; the narrow recombination (bf16, int8 at
              block 256) and the approx decode (f32, bf16, int8; two absent
              rows, one of them NaN) at n=8, d=11,173,962 and at a small
              ragged d; the flash forward, dq and dk/dv at G=8·2·12 heads,
              T=512, Dh=64 and at a ragged T=520, and at G=8, T=520 at
              every head width the kernels take; at lm_big's G=256, T=2048
              (causal) and the four-shard ring's first hop (G=576, T=128,
              non-causal, with dlse), each timed beside SDPA; the three
              flash kernels bit for bit across launches and places in G,
              and their TF32 tensor-core instructions (cuobjdump -sass);
              the projection bit for bit across two launches; the vote's row
              fingerprints bit for bit (both uint32 hashes) at n=9, f32
              and bf16, d=11,173,962 and 5003, aligned and offset
              buffers, public and drawn salts, two launches each, and
              forged rows separated; the audit's
              mis-tiled copy at (16, 48) and spill control at n=1003, each
              bit for bit (the over-launch control never launches). The
              segment kernels (``segment_kernels``) at the segmented legs'
              cuts — ResNet-18's 62 leaves, its int8 wire's 4 segments, the
              LM's 69 segments of d=62,958,336 — and at d=5003 with tiny
              and unaligned segments, several cuts inside one 16-column
              strip among them: each against its plain version, twice
              bit for bit, the recombinations bit for bit the whole-d
              kernels on each segment's contiguous copy or block-aligned
              slice, the approx offset entry's decoded slices bit for bit
              approx_decode on the contiguous slices, the projection at
              S=1 against complex_project with equal locator outputs; the
              locator at L=62 and 69 from a graph. The device draws
              (``draw_kernels``, csrc/draws.cu, the reference's threefry
              stream): random_inject's cyclic pair at vgg11_random's 2 of 9
              rows (d=9,750,922) and the LM leg's 1 of 8 (d=62,958,336),
              its plain form at ResNet-18's d, its normals within
              3e-5·max(1, |z|) of the plain version's and no other row
              written; round_draw's int8 pair and bf16 draw at ResNet-18's
              d and the wires rounded with them, synthetic_text's tokens
              at the LM's shape, each bit for bit; the training step's
              draws (``step_draw_kernels``): augment_draws at the ResNet
              legs' n=8 and 16, the vote's 9 lanes in groups of 3 and
              VGG-11's 9, dropout_keep at VGG-11's 9 × 2 × 32 × 512,
              vote_salts, each bit for bit, and the step's draws a step
              from a graph as kernels and as plain versions (a chunk's
              cost); each twice bit for bit
              and from a graph replayed at two staged steps, each replay
              its step's draws. The locator with a presence row a column
              (the tree's groups, L=2 at n=8, s=1): each column bit for
              bit the kernel on that column alone. The observatory's
              kernels (``numerics_kernels``, csrc/numerics.cu):
              ``stage_stats`` on inputs with subnormals, NaN, ±Inf,
              bfloat16's largest and larger and values at and under the
              exponent edges, at ``shared``'s grad, wire-pair and
              aggregate stages, ``simulate``'s (8, 3, d) grad stage and
              small ragged shapes at blocks 1, 7, 256, 5000 and past d:
              every count column bit for bit its plain version, rms within
              1e-5 of it and 1e-6 of an f64 sum; ``nonfinite_rows`` bool
              for bool on NaN and Inf rows, (8, 3, d) lanes and an
              unaligned buffer; each twice and from a graph replay. The
              LM legs' decode kernels at the LM's d = 62,958,336
              (``lm_width_kernels``): approx_decode f32 / bf16 / int8 on
              six present rows (two absent, one of them NaN),
              cyclic_narrow_recombine on the int8 pair, round_draw's int8
              pair and single draw, each against its plain version and its
              bound, twice bit for bit and from a graph replay bit for
              bit, beside the plain quantization the LM's narrow wires run
              (ms and the memory above its inputs). The
              decode chain on non-finite rows (``nan_chain_kernels``):
              complex_project, cyclic_locator and complex_recombine at
              n=8, d=11,173,962 on codewords with a NaN row, an Inf row
              and every row NaN (an honest worker's NaN gradient through
              the shared encode), each kernel against its plain version
              on the same inputs: the masks equal, the residual NaN where
              the plain version's is, NaN and Inf where the plain
              version's are. Times
              each kernel, its plain version, its bound and the one PyTorch
              call that computes the same function, where there is one
              (torch.matmul; scaled_dot_product_attention and its autograd
              backward, whose kernels the profiler names at the end)
  3. legs     ResNet-18 on synthetic CIFAR-10 at full width, n=8 workers,
              batch 32: the cyclic ``simulate`` leg, the geometric-median
              leg and the cyclic ``shared`` leg (s=1, a rev_grad adversary
              every step); the approx code at r=1.5 with 2 stragglers a
              step (``approx``, and ``approx_int8`` on the int8 wire); the
              shared cyclic leg on the bf16 and the int8 wire
              (``shared_bf16``, ``shared_int8``); the repetition code of
              preset rep-resnet18 (n=9, groups of 3) with a rev_grad
              adversary (``majvote``: every step 8 of 9 rows agree, the
              adversary's group flagged and the adversary out-voted), and
              Krum (``krum``, n=8: every step's aggregate one of the
              schedule's honest rows bit for bit); then the TransformerLM of
              the LM benchmark at full width (dim 768, 12 heads, 8 layers,
              vocab 8192, T=512, batch 2, bfloat16 compute, flash
              attention, d=62,958,336): ``lm_shared_flash``,
              ``lm_simulate_flash`` (24 lanes) and ``lm_geomedian_flash``;
              then the segmented wire and the per-layer decode, each
              beside its S = 1 twin: ``shared_layer`` (62 locator columns),
              ``shared_int8_seg4``, ``approx_int8_seg4`` and
              ``lm_shared_flash_layer`` (69 segments). A segmented leg
              launches no whole-d decode kernel, an earlier leg no segment
              kernel. Then the rest of the model zoo, bf16 compute and
              the optimizers: preset cyclic-vgg11 (VGG-11, n=9, s=2, a
              constant attack on two workers a step, dropout masks from
              the host) as ``vgg11_simulate`` (45
              lanes) and ``vgg11_shared`` (its decoded aggregate equal to
              the mean of the batch gradients within 1e-5 relative L2,
              every step); preset single-lenet (``lenet_single``, n=1,
              batch 128, 12 steps: its loss must fall); ``shared_c16``
              (``shared`` at bfloat16 compute); ``lm_shared_flash_adamw``
              (AdamW, the cosine schedule with a 2-step warmup, the clip
              at 1). Then the device draws' legs: ``vgg11_random``
              (preset cyclic-vgg11's simulate leg with the random attack:
              every step its 2 adversaries located, 5 honest rows),
              ``shared_int8_sr`` (shared_int8 under stochastic rounding),
              ``majvote_bf16_sr`` (the vote on a stochastically rounded
              bf16 wire: every step 8 of 9 rows agree and each group's
              honest rows are bit for bit equal on the wire),
              ``majvote_random`` (the vote's rows under the random attack,
              an eager step and a chunk: every step 8 of 9 rows agree) and
              ``lm_shared_flash_devgen`` (device tokens and the random
              attack); every CIFAR leg draws its augmentation on the card
              (``augment_draws``), the VGG legs their dropout masks, the
              vote legs their salts; no other leg launches a draw kernel.
              Then the tree topology: ``shared_tree_g8`` and
              ``shared_int8_tree_g8`` (ResNet-18 ``shared`` at n=16 in two
              groups of 8, s_g = 1, a rev_grad adversary every step, the
              f32 and the int8 wire: every step it is located, 12 honest
              rows), ``approx_tree_g3`` (preset approx-resnet18 at n=9 in
              three groups of 3) and ``lm_shared_flash_tree_g4`` (the LM
              at n=8 in two groups of 4). Then the wire observatory
              (``numerics_watch=on`` and a shadow decode):
              ``simulate_watch_bf16``, ``approx_watch_int8_sr`` (the int8
              shadow rounded stochastically), ``majvote_shadow_int8`` and
              ``lm_shared_flash_watch``: every step's shadow finite, its
              flags the f32 flags, its aggregate within the dtype's band.
              On every coded leg each step's ``wmask_adv0`` is the
              schedule's row, ``wmask_present0`` the presence row and
              ``wmask_accused0`` the located adversaries; every coded leg
              launches ``nonfinite_rows``, only a watched one
              ``stage_stats``. Then the LM's approx code, narrow wire and
              stragglers, each beside its yardstick
              (``registry.LM_CODE_TWINS``): ``lm_approx_flash`` (preset
              approx-resnet18's code on the LM, 2 workers dropped a step:
              ``approx_decode`` over six present rows of d = 62,958,336),
              ``lm_approx_int8_sr_flash`` (its int8 wire rounded
              stochastically: ``round_draw``, the int8 ``approx_decode``),
              ``lm_shared_int8_flash`` (the narrow pair, the λ locator,
              ``cyclic_narrow_recombine``) and ``lm_shared_flash_drop2``
              (no adversary, two erasures a step, the locator given the
              presence row); a chunk's host assembly timed (on the approx
              code K host solves). Five run the LM's layer stack and
              sequence shards (``registry.STACK_TWINS``):
              ``lm_shared_flash_remat``, ``lm_shared_flash_scan``,
              ``lm_big_shared_flash`` (the reference's lm_big shape, d =
              159,470,592, T=2048, with remat and the stacked layers),
              ``lm_sp4_ring_flash`` and ``lm_sp4_a2a_flash`` (four
              sequence shards: the flash kernels at every ring hop, or on
              the a2a's permuted heads). Five run the LM's model-parallel
              routes, each shard axis a tensor axis
              (``registry.MP_TWINS``): ``lm_shared_dense`` (the plain
              streaming attention), ``lm_shared_dense_tp2`` (two tensor
              shards), ``lm_shared_flash_pp2`` (the GPipe pipeline, two
              stages and two microbatches), ``lm_shared_dense_moe4``
              (four Switch experts a block, d = 176,321,280) and
              ``lm_shared_dense_moe4_ep2`` (the ep route at two expert
              shards: the MoE as it is, ``parallel/ep_step.py``).
              Each leg runs through the entry points a user calls (Trainer /
              the route's builder + TokenLoop) with the launch counts
              zeroed just before it and read just after; every coded step
              must locate its adversaries (honest_located = n − 2s, on a
              segmented leg ≤ n − 2s: the rows honest in every segment;
              located_errors = det_tp = det_adv = the leg's adversary
              count), every approx step hold its certificate (residual ≤
              bound + the wire's slack)
  4. check    the layer-stack legs against ``lm_shared_flash``
              (``stack_twin_checks``): remat for 3 eager steps from the
              same draw, the scanned stack from the twin's initial
              parameters restacked, each with the same discrete columns,
              the loss to 1e-6 relative and the update to 1e-5 relative
              L2 (bit for bit or not, printed); the four-shard a2a leg
              the same way, and the ring with the same columns, the loss
              to 1e-4 and the update to 3e-2, its timed legs' eager and
              chunked steps with the twin's columns and losses within the
              same bounds, and the ring without its last hop outside the
              update bound (a negative control); each one's chunk
              ms/step beside the twin's; what remat saves
              (``remat_memory``): the gradient phase's peak lower with it
              at LM_FULL and at lm_big, and lm_big's step without remat
              once (its step peak, or the out-of-memory message); the
              model-parallel legs against their twins (``mp_twin_checks``):
              tp2 beside lm_shared_dense and ep2 beside
              lm_shared_dense_moe4 from the same draw, pp2 beside
              lm_shared_flash_scan from the pipeline's parameters renamed
              blocks.loop.b.* -> blocks.*, 3 eager steps each with the
              twin's decode columns; tp2 and pp2 with the loss to 1e-3
              relative and the update inside a bound that a control falls
              outside (tp2 with one shard's row-parallel partial dropped,
              pp2 with its last microbatch dropped from the schedule), ep2
              bit for bit, its routing, losses and updates; the MoE leg's
              dropped tokens a step; each one's chunk ms/step beside its
              twin's;
              each segmented leg against its twin: the detection columns
              equal on every eager and chunked step, and the first step's
              decoded aggregate (fresh setups, deterministic cuDNN) within
              rtol 2e-4, atol 1e-6 of the twin's;
              shared_int8_sr against shared_int8: the detection columns
              equal on every eager and chunked step; each watch leg
              against its leg without the watch (``watch_twin_checks``):
              one step from fresh setups, the aggregate handed to the
              optimizer bit for bit and every shared column equal; tree against flat
              (``tree_vs_flat``): one step's (16, d) ResNet-18 batch
              gradients encoded flat (n=16, s=1) and as the tree, a
              rev_grad adversary on row 11, then row 9 dropped, decoded
              both ways: the flagged rows equal, the straggler never
              accused, both aggregates within 1e-5 relative L2 of the true
              mean; the tree's encode timed as one block-diagonal launch
              against a launch a group;
              majvote without its adversary for 8 steps (vote_agree 1.0:
              the honest lanes of a group bit-identical) and the exact
              vote equal to the fingerprint vote on one step's rows;
              ResNet-18 ``simulate`` at bfloat16 compute, 4 steps at
              cuDNN's default settings and 4 under deterministic cuDNN,
              each step's largest relative disagreement between the copies
              of a batch gradient printed beside honest_located (the
              default-setting run, the leg's own, must locate every step
              at the unchanged HEALTH_REL_TOL); the
              ResNet decode at full size and one small ResNet step, on
              the card against the CPU; the wire buffers of one real encode,
              the narrow cyclic decode and the approx decode at full size
              and one small approx step with stragglers, card against CPU;
              one full-width LM step with attn_impl=dense against flash on
              the card; one small coded LM step on the card against the CPU
  5. audit    the kernel audit (draco_tpu_torch/analysis/kernel_audit.py)
              right after the kernel phase: every kernel of csrc/ green on
              resources, launch limits, coverage and compute-sanitizer, and
              its three negative controls each tripping exactly its rule
              (the mis-tiled copy, the counterpart of the TPU lowering
              audit's ``bad``, leaves 576 outputs unwritten and still equals
              its plain version bit for bit); after the checks, the program
              lint of each leg (analysis/rules.py) at the width it ran, one
              inspected step after a warm-up: dtypes, no synchronising
              call, host-to-device bytes within the manifest, the state
              updated in place, no collective, the step's memory within
              budget, a segmented leg's host-to-device bytes its twin's
              (the segment plan lives on the card from setup), the device
              tokens' chunk's host-to-device bytes exactly its manifest's:
              K int32 step numbers and K masks, each layer-stack and
              sequence-shard leg's syncs and bytes its twin's, and
              lm_big's step peak below the same step's without remat;
              then the lint's
              seeded-defect controls, each tripping exactly its rule

  6. chunk    each leg also as the K-fused chunk (``steps_per_call`` K=4,
              on the card one captured CUDA graph replayed K times,
              ``training/chunk_graph.py``). Timing, on the leg's own
              setup and at the settings a user runs: from one snapshot of
              the state, K eager steps, then one chunk of the same K steps
              through the loop's engine client (capture, then replays
              only, both by CUDA events), then the loop a user runs
              (``runner.run``: the engine, its prefetch thread and flush)
              over 3 chunks, whose records' ``step_ms`` is the loop's
              own; the discrete columns equal the eager run's, and every
              kernel the leg needs is in the capture. Agreement, from one
              snapshot: K eager steps twice, then the chunk twice and the
              loop over the same K steps; the two eager runs must agree
              bit for bit, and each chunk must give their losses, metric
              columns and final state (parameters, momentum, BN
              statistics) bit for bit. The LM legs are held on their own
              setup; the ResNet legs on a fresh setup under deterministic
              cuDNN (``cudnn.deterministic``), since cuDNN's default
              backward is free to sum in another order each call. The
              flagship ratio geomedian/simulate under the chunk. Each
              kernel of the legs (the ten ported and the segment kernels)
              captured in a graph alone, its replay bit for bit its direct
              launch at the main path's shapes. The lint (phase 5) also runs the chunked
              programs of ``simulate``, ``lm_shared_flash``, ``majvote``,
              ``lm_shared_flash_devgen``, ``lm_shared_flash_watch`` and
              ``lm_approx_flash``: no
              synchronising call inside a chunk, one device-to-host fetch
              a flush (the run heartbeat folding its records), the staging
              copy's bytes (the approx chunk's ``chunk_lm_shared_flash``'s
              plus v/n and the presence, 2·n·4 bytes a step), the graph's
              pool
  7. state    the run state (``state_phase``), ResNet legs under
              deterministic cuDNN: preset cyclic-resnet18 with
              ``shared``, n=8, K=4, 12 steps with the test-set eval
              (2048 images at batch 1000, a ragged tail of 48) and a
              checkpoint at 4, 8 and 12; resumed from 4 on its own setup,
              whose graph already replayed (every state tensor keeps its
              storage, no recapture); walked back past a byte flipped in
              the newest checkpoint to 8, on a fresh setup; SIGTERM from a
              timer thread mid-chunk (steps 5–8), which stops at 8 with a
              checkpoint, then resumed from −1. Each final state
              (parameters, momentum, BN statistics, count, step) bit for
              bit the uninterrupted run's, and each capture launching the
              uninterrupted run's kernels. The .dcg at zlib levels 0 and 1
              (bytes, save and load ms) and the eval ms; the checkpoint-
              polling evaluator (``python -m
              draco_tpu_torch.training.evaluator --once``) against
              ``Trainer.evaluate`` at 4, 8, 12. The uninterrupted run's
              status.json passes the schema check at schema 5 with its
              forensics (the adversary accused on every step) and wire
              blocks and ends ``done``; the SIGTERM run's ends
              ``preempted`` with ``resumable_step`` 8.
              The host faults (``host_fault_run``): ``shared``, K=4, 8
              steps, eval and save every 3, ``fault_spec=
              "prefetch_crash@2,sigterm@5"``: the crash retried by the
              supervised prefetcher, the run stopped at 6 (status.json
              ``preempted``, ``resumable_step`` 6), resumed from −1 to 8,
              the state bit for bit an uninterrupted run's with the crash
              alone. ``lm_shared_flash`` at full
              width, K=4: 8 steps with a checkpoint at 4 and 8, then a
              fresh setup resumed from 4 for 4 steps, the state at 8 bit
              for bit. ``single_machine`` on preset single-lenet for 12
              steps
  8. guard    the resilience legs (``guard_phase``, registry
              ``GUARD_PROGRAMS``; it runs before the lint of phase 5,
              whose profiler would slow its timings), each beside the leg
              it guards: ``simulate_guard_nan`` (the flagship,
              ``step_guard=on``, ``fault_spec="nan_grad@2"`` on the seeded
              victim, ``incident_watch=on``), ``shared_int8_over_budget``
              (``over_budget@3`` on the int8 wire), ``approx_guard_watch``
              (preset approx-resnet18, ``straggle@2:w3:d2``, the incident
              watch) and ``lm_shared_flash_adamw_guard`` (``inf_grad@2:w5``
              under AdamW, the cosine schedule and the clip). The ResNet
              legs under deterministic cuDNN: K=4 eager steps, a skipped
              step's parameters, optimizer buffers, update count and BN
              statistics bit for bit the step before's, the others
              trusted (the approx leg's trips the certificate rule
              computed on the host from its own columns, worker 3 absent
              on steps 2–3); step 1 bit for bit the twin's step 1; the
              chunk twice bit for bit the eager run; each chunk timed
              beside its twin's and the twin's with the guard alone (no
              fault plan); the loop over two chunks into a
              train_dir: status.json through the schema check with its
              guard block, incidents.jsonl with a guard episode naming
              the victim, the live incidents block equal to an offline
              fold of metrics.jsonl. The lint (phase 5) also holds each
              guarded leg and ``chunk_simulate_guard_nan`` to its twin:
              no more syncs or fetches, the twin's H2D bytes (the approx
              certificate's staged bound, 4 bytes, aside)
  9. autopilot the autopilot on the chunked CNN loop, then the LM's
              (``autopilot_phase``; it runs after phase 8, before the
              lint's profiler), at preset cyclic-resnet18's shapes
              (``shared``, n=8, batch 32, K=4, ``step_guard=on``,
              ``incident_watch=on``), through the Trainer a user runs,
              the launch counts zeroed just before each run and read just
              after: the reference's lifecycle (its policy and thresholds,
              ``fault_spec="adversary@3-8:w2,straggle@13-20:w5"``, 32
              steps, eval every 4): the remediations in one of the
              reference's two orders, each with its trigger, dial_down's
              executable ``compiled`` and dial_up's ``reused``; one capture
              a regime and none on the return, each regime's setup on the
              Trainer's model and state, the state bit for bit across the
              mid-run capture (what the new graph's first replay reads is
              what the old graph left); 0 guard trips; worker 2's present
              bit 0 from the quarantine's effective step + K to the
              readmit's effective step + K - 1; the run ending in cyclic_r3
              with 2 swaps; the cyclic kernels and approx_decode launched.
              The segment rung (``straggle@5-12:w5``, 20 steps):
              cyclic_r3 -> cyclic_r3_seg2 -> cyclic_r3 with the segmented
              kernels launched. Printed: each regime's chunk ms/step (CUDA
              events) beside the ``shared`` and ``approx`` chunks of phase
              6, each swap's wall (a new regime's setup build, re-made
              chunk and capture; a cached one's switch and re-made chunk),
              ``act``'s host ms a boundary, each graph's pool and the
              peak memory. Then ``SegmentPipeline`` over the int8 wire's
              codeword pair at d = 11,173,962, S = 2 and 4, pipelined and
              serial: pinned host segments put on a copy stream of their
              own, the decode (cyclic_narrow_recombine) waiting on the
              copy's event on the compute stream; the segments' results
              bit for bit the whole-d launch, each rail's wall, its
              device overlap (decode time under a copy, from events on
              both streams: > 0 on the pipelined rail) and the host
              overlap the reference measures (0 on the serial rail).
              The LM's lifecycle (``lm_lifecycle``) at LM_FULL through
              build_sp_train_setup and the TokenLoop: the CNN lifecycle's
              policy, thresholds, fault plan and checks, the flash kernels
              launched, each regime's chunk beside ``lm_shared_flash`` /
              ``lm_approx_flash`` of phase 6, each regime's graph pool and
              the run's peak allocated and reserved memory; then the
              reference's LM dial (``straggle@3-10:w5``, 24 steps) at K=1
              with device tokens, in chunks of one step: dial_down
              (compiled) and dial_up (reused), one capture a regime

``--profile`` adds one torch.profiler step per leg (device time by kernel
and by the step's phases draco_comp / draco_encode / draco_decode /
draco_update, and the device's busy share) and one profiled chunk of
``lm_shared_flash`` (its busy share under the chunk); ``--out`` writes the
whole record as JSON.

It imports nothing of JAX and nothing of the JAX package. Without a CUDA
device it exits with status 1 before printing anything on stdout.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from draco_tpu_torch import _build, attacks, ops, presets, single_machine
from draco_tpu_torch import params as params_mod
from draco_tpu_torch import rng as drng
from draco_tpu_torch.analysis import kernel_audit, program_lint, registry
from draco_tpu_torch.analysis import rules
from draco_tpu_torch.analysis import controls as lint_controls
from draco_tpu_torch.analysis.registry import APPROX, LM_FULL
from draco_tpu_torch.coding import approx, cyclic, repetition, topology
from draco_tpu_torch.config import TrainConfig
from draco_tpu_torch.data.datasets import load_dataset
from draco_tpu_torch.models import build_model
from draco_tpu_torch.models.transformer import TransformerLM
from draco_tpu_torch.obs import heartbeat, locator_ab, numerics
from draco_tpu_torch.obs.trace_report import fold_device_phases
from draco_tpu_torch.obs.tracer import PHASES
from draco_tpu_torch.ops import coded, controls, decode_kernels, draws, vote
from draco_tpu_torch.ops import flash_attention as fa
from draco_tpu_torch.ops import numerics as ops_numerics
from draco_tpu_torch.parallel import build_route_setup
from draco_tpu_torch.parallel import common as common_mod
from draco_tpu_torch.parallel.common import decode_bounds
from draco_tpu_torch.parallel.sp_step import build_sp_train_setup
from draco_tpu_torch.parallel.sp_step import synthetic_text as sp_text
from draco_tpu_torch.parallel.token_loop import TokenLoop
from draco_tpu_torch.runtime import cudnn_deterministic, resolve_device
from draco_tpu_torch.training import step as step_mod
from draco_tpu_torch.training.chunk_graph import StateSnapshot
from draco_tpu_torch.training.trainer import Trainer
from draco_tpu_torch.utils import checkpoint as ckpt
from draco_tpu_torch.utils.metrics import host_rows

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
# split TF32: three TF32 tensor-core products (495 TFLOP/s dense) for each
# float32 one, the flash backward's instructions
TF32X3_FLOPS = 495e12 / 3
# 32-bit integer operations a second: on each of the 132 SMs at the
# 1,980 MHz boost clock, 128 a clock — the four schedulers issue one warp
# instruction a clock each, and integer multiply-adds (the FMA pipe) and
# shifts, logic and adds (the INT32 pipe, 64 lanes) can both run (the
# arithmetic-instruction throughput table of the CUDA C++ documentation
# for compute capability 9.0)
INT32_OPS = 132 * 128 * 1.98e9
ADVERSARY_MAG = attacks.ADVERSARY  # the random attack's magnitude
N, S, D = 8, 1, 11_173_962  # ResNet-18's flat gradient at n=8, s=1
VOTE_N = 9  # the majvote leg's workers (preset rep-resnet18)
# the VGG-11 legs (preset cyclic-vgg11): n=9, s=2, VGG-11's flat gradient
VGG_N, VGG_S, VGG_D = 9, 2, 9_750_922
SEED = 428
# the locator's wide codes (n, s), held beside the old kernel
WIDE_CODES = ((32, 3), (32, 5), (40, 3))
CODED = ("complex_matmul", "complex_project", "complex_recombine",
         "cyclic_locator")
NARROW = ("complex_matmul", "complex_project", "cyclic_locator",
          "cyclic_narrow_recombine")  # a narrow shared cyclic leg
FLASH = ("flash_fwd", "flash_dq", "flash_dkv")
BLOCK = 256  # the int8 wire's scale block (cfg.shadow_block's default)
WIRE_BYTES = {"f32": 4, "bf16": 2, "int8": 1}
# the legs' configurations (the approx preset, the LM benchmark's
# TransformerLM) live in draco_tpu_torch/analysis/registry.py, which the
# program lint holds to their manifests
LM_D = 62_958_336  # the LM's flat gradient
# the reference's lm_big shape: 12 blocks of 12,590,080, embed 8,388,608
# and final_ln 1,024
LM_BIG_D = 12 * 12_590_080 + 8_388_608 + 1_024
assert LM_BIG_D == 159_470_592
# the LM with four Switch experts a block: 8 blocks of 21,253,632 (qkv
# 1,769,472, proj 589,824, router 3,072, w1 and w2 9,437,184 each, b1
# 12,288, b2 3,072, two scales 1,536), embed 6,291,456 and final_ln 768
MOE_D = 8 * 21_253_632 + 6_291_456 + 768
assert MOE_D == 176_321_280
LEG_D = {"lm_big_shared_flash": LM_BIG_D, "lm_shared_dense_moe4": MOE_D,
         "lm_shared_dense_moe4_ep2": MOE_D}
G_LM = N * 2 * 12  # flash heads per call on the shared leg: lanes·B·H
# the segmented decode's kernels (the layer decode, wire_segments > 1), and
# the whole-d kernels they take the place of on a segmented leg
SEGMENTED = ("complex_project_segments", "complex_recombine_segments",
             "cyclic_narrow_recombine_segments", "approx_decode_segment")
WHOLE = ("complex_project", "complex_recombine", "cyclic_narrow_recombine",
         "approx_decode")
SEG_CODED = ("complex_matmul", "complex_project_segments", "cyclic_locator",
             "complex_recombine_segments")
# the training step's draws on the card: every CIFAR leg's augmentation,
# VGG's dropout masks, the vote's salts
AUG = ("augment_draws",)
VGG_DRAWS = AUG + ("dropout_keep",)
VOTE_DRAWS = AUG + ("vote_salts",)
# the observatory's kernels: the statistics of a watched leg's stages and
# the ingest check, which every coded leg runs (``drive``)
WATCHED = ("stage_stats", "nonfinite_rows")
# the kernels each leg must launch
EXPECT = {"simulate": CODED[1:] + AUG, "geomedian": AUG,
          "shared": CODED + AUG,
          "approx": ("approx_decode",) + AUG,
          "approx_int8": ("approx_decode",) + AUG,
          "shared_bf16": NARROW + AUG, "shared_int8": NARROW + AUG,
          "majvote": ("row_fingerprints",) + VOTE_DRAWS, "krum": AUG,
          "lm_shared_flash": CODED + FLASH,
          "lm_simulate_flash": CODED[1:] + FLASH,
          "lm_geomedian_flash": FLASH,
          "shared_layer": SEG_CODED + AUG,
          "shared_int8_seg4": SEG_CODED[:3]
          + ("cyclic_narrow_recombine_segments",) + AUG,
          "approx_int8_seg4": ("approx_decode_segment",) + AUG,
          "lm_shared_flash_layer": SEG_CODED + FLASH,
          "vgg11_simulate": CODED[1:] + VGG_DRAWS,
          "vgg11_shared": CODED + VGG_DRAWS,
          "lenet_single": (), "shared_c16": CODED + AUG,
          "lm_shared_flash_adamw": CODED + FLASH,
          "vgg11_random": CODED[1:] + ("random_inject",) + VGG_DRAWS,
          "shared_int8_sr": NARROW + ("round_draw",) + AUG,
          "majvote_bf16_sr": ("row_fingerprints", "round_draw") + VOTE_DRAWS,
          "majvote_random": ("row_fingerprints", "random_inject")
          + VOTE_DRAWS,
          "lm_shared_flash_devgen": CODED + FLASH + ("random_inject",
                                                     "synthetic_text"),
          "shared_tree_g8": CODED + AUG,
          "shared_int8_tree_g8": NARROW + AUG,
          "approx_tree_g3": ("approx_decode",) + AUG,
          "lm_shared_flash_tree_g4": CODED + FLASH,
          # the observatory: the statistics kernel, and the shadow's
          # second decode through the leg's own decode kernels
          "simulate_watch_bf16": CODED[1:] + AUG + WATCHED,
          "approx_watch_int8_sr": ("approx_decode", "round_draw") + AUG
          + WATCHED,
          "majvote_shadow_int8": ("row_fingerprints",) + VOTE_DRAWS
          + WATCHED,
          "lm_shared_flash_watch": CODED + FLASH + WATCHED,
          # the LM's approx code, narrow wire and stragglers
          "lm_approx_flash": ("approx_decode",) + FLASH,
          "lm_approx_int8_sr_flash": ("approx_decode", "round_draw")
          + FLASH,
          "lm_shared_int8_flash": NARROW + FLASH,
          "lm_shared_flash_drop2": CODED + FLASH,
          # the LM's layer stack and sequence shards
          "lm_shared_flash_remat": CODED + FLASH,
          "lm_shared_flash_scan": CODED + FLASH,
          "lm_big_shared_flash": CODED + FLASH,
          "lm_sp4_ring_flash": CODED + FLASH,
          "lm_sp4_a2a_flash": CODED + FLASH,
          # the LM's model-parallel routes: no flash kernel on the dense
          # attention (``drive`` holds them at 0 there)
          "lm_shared_dense": CODED, "lm_shared_dense_tp2": CODED,
          "lm_shared_flash_pp2": CODED + FLASH,
          "lm_shared_dense_moe4": CODED, "lm_shared_dense_moe4_ep2": CODED}
# the draw kernels a leg launches only where it draws: no other leg
# launches them
DRAWS = ("random_inject", "round_draw", "synthetic_text", "augment_draws",
         "dropout_keep", "vote_salts")
# the columns a segmented leg must give on every step as its twin does (the
# reference's, tests/test_segments.py DET_COLS). Not honest_located: each
# segment's locator keeps n − 2s rows, the adversary and, at s = 1, one of
# its two neighbours on the DFT circle excluded, and the neighbours tie up
# to the tie-break's 1e-4 margin, so two segments can exclude different
# neighbours and the folded honest set count fewer rows (the reference's
# decode_segments does the same on the same rows, PERF.md §6)
DETECT = ("located_errors", "det_tp", "det_adv", "present",
          "decode_residual_bound", "recovered_fraction")
# the legs whose loss must fall over their timed steps (preset
# single-lenet), and whose decoded aggregate must equal the mean of the
# batch gradients (the shared encode's input) to f32 accuracy: 9-row
# complex sums of the encoded rows, relative L2
FALLING = ("lenet_single",)
# timed steps of a leg that needs more than --steps: LeNet's loss first
# rises from its initial value at lr 0.01, momentum 0.9 (3.30, 3.44, 5.02,
# 3.94, then 2.57 on the synthetic set), and its steps take milliseconds
LEG_STEPS = {"lenet_single": 12}
MEAN_HELD = ("vgg11_shared",)
MEAN_RTOL = 1e-5
CHUNK_K = 4  # steps of the chunk phase's chunk (steps_per_call)
LOOP_CHUNKS = 3  # chunks of the chunk phase's timed loop (runner.run)
# the columns a chunk must give exactly as the eager loop does
DISCRETE = ("honest_located", "located_errors", "det_tp", "det_adv",
            "present", "decode_residual_bound", "recovered_fraction",
            "vote_agree", "flagged_groups", "det_flagged", "wmask_accused0",
            "wmask_present0", "wmask_adv0", "shadow_det_flagged",
            "shadow_det_tp")
# the majvote leg's every step: 8 of its 9 rows agree with their group's
# winner, the adversary's group flagged, the adversary out-voted
VOTE_HELD = {"vote_agree": 8 / 9, "flagged_groups": 1, "det_flagged": 1,
             "det_tp": 1, "det_adv": 1}


class SmokeFailure(RuntimeError):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA
    events, after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(fn, reps: int) -> float:
    """Device time of one ``fn`` call: ``reps`` calls captured in one CUDA
    graph and replayed, so the host's cost of each call drops out (for a
    kernel shorter than its wrapper's Python)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_ms(graph.replay, 3, warmup=1) / reps


def bound(nbytes: float, flops: float, rate: float = F32_FLOPS) -> tuple:
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over ``rate``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def product_rows(code, dev, d, g, reps: int = 20) -> dict:
    """The three coded products at (code.n, d) on random inputs: each held
    against its plain version and bit for bit across two launches, timed
    beside its plain version and torch.matmul, with its byte and operation
    counts. name -> {err, tol, ms, plain_ms, library_ms, nbytes, flops}."""
    n = code.n
    t = code.tensors(dev)
    out = {}

    def timed(name, err, tol, kernel, plain, lib, nbytes, flops):
        out[name] = {"err": err, "tol": tol, "ms": time_ms(kernel, reps),
                     "plain_ms": time_ms(plain, reps),
                     "library_ms": time_ms(lib, reps), "nbytes": nbytes,
                     "flops": flops}

    # encode (the shared legs): n-term f32 sums in another order agree to
    # a few ulps of the output's scale
    w_re, w_im = t["w_masked_re"], t["w_masked_im"]
    w_stack = torch.cat([w_re, w_im])
    grads = torch.randn((n, d), generator=g, device=dev)
    err, tol = encode_check(w_re, w_im, grads)
    timed("complex_matmul", err, tol,
          lambda: coded.complex_matmul(w_re, w_im, grads),
          lambda: coded.complex_matmul_plain(w_re, w_im, grads),
          lambda: torch.matmul(w_stack, grads),
          4 * (2 * n * n + n * d + 2 * n * d), 2 * 2 * n * n * d)
    del grads
    torch.cuda.empty_cache()
    r_re, r_im = torch.randn((2, n, d), generator=g, device=dev)
    f = drng.projection_factors(SEED, d, dev)

    # projection: a d-term reduction; two f32 summation orders agree to
    # 1e-5 of the sum of the terms' magnitudes
    k_re, k_im = coded.complex_project(r_re, r_im, f)
    again = coded.complex_project(r_re, r_im, f)
    require(torch.equal(k_re, again[0]) and torch.equal(k_im, again[1]),
            f"complex_project at n={n}: two launches on the same inputs "
            f"differ")
    del again
    p_re, p_im = coded.complex_project_plain(r_re, r_im, f)
    scale = max((r_re.abs() @ f.abs()).max().item(),
                (r_im.abs() @ f.abs()).max().item())
    err = max((k_re - p_re).abs().max().item(),
              (k_im - p_im).abs().max().item())
    r_stack = torch.cat([r_re, r_im])
    timed("complex_project", err, 1e-5 * scale,
          lambda: coded.complex_project(r_re, r_im, f),
          lambda: coded.complex_project_plain(r_re, r_im, f),
          lambda: torch.matmul(r_stack, f),
          4 * (2 * n * d + d + 2 * n), 2 * 2 * n * d)

    # recombination: 2n-term sums per column, tolerance 1e-5 of the
    # largest column's sum of magnitudes
    v_re = torch.randn(n, generator=g, device=dev)
    v_im = torch.randn(n, generator=g, device=dev)
    k = coded.complex_recombine(v_re, v_im, r_re, r_im)
    require(_same_bits(k, coded.complex_recombine(v_re, v_im, r_re, r_im)),
            f"complex_recombine at n={n}: two launches on the same inputs "
            f"differ")
    p = coded.complex_recombine_plain(v_re, v_im, r_re, r_im)
    scale = (v_re.abs() @ r_re.abs() + v_im.abs() @ r_im.abs()).max().item()
    v_cat = torch.cat([v_re, -v_im])
    timed("complex_recombine", (k - p).abs().max().item(), 1e-5 * scale,
          lambda: coded.complex_recombine(v_re, v_im, r_re, r_im),
          lambda: coded.complex_recombine_plain(v_re, v_im, r_re, r_im),
          lambda: torch.matmul(v_cat, r_stack),
          4 * (2 * n * d + 2 * n + d), 2 * 2 * n * d)
    return out


def encode_check(w_re, w_im, grads) -> tuple:
    """complex_matmul twice bit for bit, and (max_abs_err, tol) against its
    plain version: 1e-5 of the output's scale."""
    k_re, k_im = coded.complex_matmul(w_re, w_im, grads)
    again = coded.complex_matmul(w_re, w_im, grads)
    require(torch.equal(_bits(k_re), _bits(again[0]))
            and torch.equal(_bits(k_im), _bits(again[1])),
            f"complex_matmul at n={grads.shape[0]}, d={grads.shape[1]}: two "
            f"launches on the same inputs differ")
    del again
    p_re, p_im = coded.complex_matmul_plain(w_re, w_im, grads)
    err = max((k_re - p_re).abs().max().item(),
              (k_im - p_im).abs().max().item())
    tol = 1e-5 * max(p_re.abs().max().item(), p_im.abs().max().item())
    return err, tol


def coded_kernels(code, dev, code9) -> list:
    """The three coded products at the ResNet legs' n=8, d=11,173,962 (the
    encode also at the LM's d, float4 columns) and at the VGG-11 legs' n=9,
    d=9,750,922 (``n9_s2`` in each row: the encode's second, one-row output
    group through the staged-store path, rows 40 bytes off a line)."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    lines = {"complex_matmul": "draco_tpu/ops/coded.py:82",
             "complex_project": "draco_tpu/ops/coded.py:152",
             "complex_recombine": "draco_tpu/ops/coded.py:201"}
    rows = []
    for name, m in product_rows(code, dev, D, g).items():
        b_ms, b_by = bound(m["nbytes"], m["flops"])
        print(f"kernel {name}: max_abs_err={m['err']:.3e} (tol "
              f"{m['tol']:.3e}) ms={m['ms']:.4f} plain_ms="
              f"{m['plain_ms']:.4f} library_ms={m['library_ms']:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by})", flush=True)
        require(m["err"] <= m["tol"], f"{name}: max_abs_err {m['err']} > tol "
                f"{m['tol']}")
        rows.append({"name": name, "route": "cuda",
                     "source": "draco_tpu_torch/csrc/coded.cu",
                     "replaces": lines[name], "ok": True,
                     "max_abs_err": m["err"], "tol": m["tol"],
                     "ms": m["ms"], "plain_ms": m["plain_ms"],
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": m["library_ms"], "bitwise_repeat": True})
    rows[1]["chunks"] = coded.project_chunks(N, D)
    torch.cuda.empty_cache()

    # the encode at the LM's d (float4 columns)
    t = code.tensors(dev)
    w_re, w_im = t["w_masked_re"], t["w_masked_im"]
    w_stack = torch.cat([w_re, w_im])
    grads = torch.randn((N, LM_D), generator=g, device=dev)
    err, tol = encode_check(w_re, w_im, grads)
    require(err <= tol, f"complex_matmul at the LM's d: max_abs_err {err} "
            f"> tol {tol}")
    b_ms, b_by = bound(4 * (2 * N * N + N * LM_D + 2 * N * LM_D),
                       2 * 2 * N * N * LM_D)
    lm = {"d": LM_D, "max_abs_err": err, "tol": tol,
          "ms": time_ms(lambda: coded.complex_matmul(w_re, w_im, grads), 10),
          "plain_ms": time_ms(
              lambda: coded.complex_matmul_plain(w_re, w_im, grads), 5),
          "library_ms": time_ms(lambda: torch.matmul(w_stack, grads), 10),
          "bound_ms": b_ms, "bound_by": b_by}
    rows[0]["lm"] = lm
    print(f"kernel complex_matmul at the LM's d={LM_D}: max_abs_err={err:.3e}"
          f" (tol {tol:.3e}) ms={lm['ms']:.4f} plain_ms={lm['plain_ms']:.4f}"
          f" library_ms={lm['library_ms']:.4f} bound_ms={b_ms:.4f} ({b_by})",
          flush=True)
    del grads
    torch.cuda.empty_cache()

    # the VGG-11 legs' shapes: n=9 (s=2), d=9,750,922
    for row, (name, m) in zip(rows, product_rows(code9, dev, VGG_D,
                                                 g).items()):
        b_ms, b_by = bound(m["nbytes"], m["flops"])
        require(m["err"] <= m["tol"], f"{name} at n=9, d={VGG_D}: "
                f"max_abs_err {m['err']} > tol {m['tol']}")
        row["n9_s2"] = {"n": code9.n, "d": VGG_D, "max_abs_err": m["err"],
                        "tol": m["tol"], "ms": m["ms"],
                        "plain_ms": m["plain_ms"],
                        "library_ms": m["library_ms"], "bound_ms": b_ms,
                        "bound_by": b_by, "bitwise_repeat": True}
        print(f"kernel {name} at n=9, d={VGG_D}: max_abs_err={m['err']:.3e} "
              f"(tol {m['tol']:.3e}) ms={m['ms']:.4f} plain_ms="
              f"{m['plain_ms']:.4f} library_ms={m['library_ms']:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}); two launches bit for bit",
              flush=True)
    torch.cuda.empty_cache()
    return rows


def locator_columns(code, L, attacked, absent, dev, g, width=64):
    """(L, n) projected columns of a real encode: random batch gradients
    over L layers of ``width`` coordinates, encoded, the ``attacked`` rows
    reversed (rev_grad), the ``absent`` rows zero-filled, projected per
    layer on a loc=1 normal factor. Returns (e_re, e_im, pres_f)."""
    t, n = code.tensors(dev), code.n
    grads = torch.randn((n, L * width), generator=g, device=dev)
    enc_re, enc_im = coded.complex_matmul_plain(t["w_masked_re"],
                                                t["w_masked_im"], grads)
    mask = torch.zeros(n, dtype=torch.bool, device=dev)
    mask[list(attacked)] = True
    enc_re, enc_im = attacks.inject_cyclic(enc_re, enc_im, mask, "rev_grad")
    pres = torch.ones(n, device=dev)
    pres[list(absent)] = 0.0
    enc_re, enc_im = enc_re * pres[:, None], enc_im * pres[:, None]
    f = 1.0 + torch.randn(L * width, generator=g, device=dev)
    proj = lambda r: (r.view(n, L, width) * f.view(L, width)).sum(-1).T  # noqa: E731
    return (proj(enc_re).contiguous(), proj(enc_im).contiguous(),
            pres[None, :].contiguous())


def locator_pair(code, dev) -> tuple:
    """(plain, kernel): the locator's plain version and its kernel on
    ``code``'s constants, at the f32 wire's tolerance."""
    t = code.tensors(dev)

    def plain(e_re, e_im, pres, lam=0.0):
        return cyclic.locator_core(
            e_re, e_im, t["c2h_re"], t["c2h_im"], t["c1_re"], t["c1_im"],
            t["est_re"], t["est_im"], pres, code.s, cyclic.HEALTH_REL_TOL,
            lam=lam)

    def kernel(e_re, e_im, pres, lam=0.0):
        return decode_kernels.cyclic_locator(code, e_re, e_im, pres,
                                             cyclic.HEALTH_REL_TOL, lam=lam)

    return plain, kernel


def locator_cases(code, dev, g, cases, old_lib=None, width=64) -> float:
    """Each case (label, L, attacked, absent, λ, NaN) through the kernel
    and its plain version: the discrete outputs (honest, flagged, loud)
    equal; v within 1e-4 of max|v| and the residual within 1e-5 (f32 solves
    of the 2s×2s Hankel system and the (n−2s)×(n−2s) complex Gauss–Jordan
    inverse: 6×6 at n=8, s=1 and 5×5 at n=9, s=2, each well conditioned),
    NaN in the same places; on a case without NaN each attacked row
    located and each absent row unused. The NaN cases poison a row of
    every column, or one row of one column (a worker that sent NaN).

    With ``old_lib`` (the wide codes, n >= 32, whose m×m honest inverse
    amplifies f32 noise ~4e4×, so a flag can sit at the noise floor for any
    kernel): the old one-block-a-column kernel (``obs/locator_ab``) runs on
    the same columns, and the kernel is held to the plain version at least
    as well as it is. The honest set equals the plain version's (the data
    decide it), and flagged and loud wherever the old kernel equals the
    plain version; v within the larger of 1e-4 of max|v| and twice the old
    kernel's v error, the residual within the larger of 1e-5 and twice its.
    Returns the largest v error."""
    plain, kernel = locator_pair(code, dev)
    instance = decode_kernels.locator_instance(code.n, code.s)
    worst = 0.0
    for label, L, attacked, absent, lam, nan in cases:
        label = f"n={code.n}, s={code.s}, {label}"
        e_re, e_im, pres = locator_columns(code, L, attacked, absent, dev, g,
                                           width)
        if nan is not None:
            cols = slice(None) if nan[0] is None else nan[0]
            e_re[cols, nan[1]] = float("nan")
        k = kernel(e_re, e_im, pres, lam)
        p = plain(e_re, e_im, pres, lam)
        o = (None if old_lib is None else locator_ab.old_locator(
            old_lib, code, e_re, e_im, pres, cyclic.HEALTH_REL_TOL, lam))
        for i, name in zip((2, 3, 4), ("honest", "flagged", "loud")):
            a, b = k[i], p[i]
            held = (torch.ones_like(a) if o is None or name == "honest"
                    else o[i] == b)
            require(torch.equal(a[held], b[held]), f"cyclic_locator "
                    f"[{label}]: {name} differs: kernel {a.int().tolist()} "
                    f"plain {b.int().tolist()}"
                    + ("" if o is None
                       else f" old kernel {o[i].int().tolist()}"))
        for name, i in (("v_re", 0), ("v_im", 1), ("residual", 5)):
            require(torch.equal(k[i].isnan(), p[i].isnan()),
                    f"cyclic_locator [{label}]: {name} NaN in other places")
        k = [torch.nan_to_num(x, nan=0.0) for x in k]
        p = [torch.nan_to_num(x, nan=0.0) for x in p]
        v_scale = max(p[0].abs().max().item(), p[1].abs().max().item())
        v_err = max((k[0] - p[0]).abs().max().item(),
                    (k[1] - p[1]).abs().max().item())
        r_err = (k[5] - p[5]).abs().max().item()
        v_tol, r_tol, against = 1e-4 * v_scale, 1e-5, ""
        if o is not None:
            o = [torch.nan_to_num(x, nan=0.0) for x in o]
            o_v = max((o[0] - p[0]).abs().max().item(),
                      (o[1] - p[1]).abs().max().item())
            o_r = (o[5] - p[5]).abs().max().item()
            v_tol, r_tol = max(v_tol, 2 * o_v), max(r_tol, 2 * o_r)
            o_same = all(torch.equal(o[i], p[i]) for i in (2, 3, 4))
            against = (f" (the old kernel: v err {o_v:.3e}, residual err "
                       f"{o_r:.3e}, discrete "
                       f"{'equal' if o_same else 'differs'})")
        require(v_err <= v_tol,
                f"cyclic_locator [{label}]: v err {v_err} > {v_tol}")
        require(r_err <= r_tol, f"cyclic_locator [{label}]: residual err "
                f"{r_err} > {r_tol}")
        worst = max(worst, v_err)
        if nan is not None:  # the reference's outcome, not a location
            print(f"kernel cyclic_locator [{label}] ({instance}): discrete "
                  f"outputs held (honest {k[2][0].int().tolist()}), v err "
                  f"{v_err:.3e}{against}", flush=True)
            continue
        # the columns whose attacked rows the plain version locates (all of
        # them, but on the wide codes' λ path, where the reference's gate
        # can miss a column: those are counted, not held)
        cols = torch.ones(L, dtype=torch.bool, device=dev)
        for row in attacked:
            cols &= ~p[2][:, row].bool() & p[3][:, row].bool()
        missed = L - int(cols.sum())
        require(missed == 0 or (o is not None and lam > 0),
                f"cyclic_locator [{label}]: the plain version leaves an "
                f"attacked row unlocated in {missed} of {L} columns")
        for row in attacked:
            require(not bool(k[2][cols, row].any())
                    and bool(k[3][cols, row].all()),
                    f"cyclic_locator [{label}]: attacked row {row} not "
                    f"located")
        for row in absent:
            require(not bool(k[2][:, row].any()),
                    f"cyclic_locator [{label}]: absent row {row} used")
        print(f"kernel cyclic_locator [{label}] ({instance}): discrete "
              f"outputs held, v err {v_err:.3e}, residual err {r_err:.3e}"
              f"{against}"
              + (f"; the plain version (the reference's λ gate) leaves an "
                 f"attacked row unlocated in {missed} of {L} columns"
                 if missed else ""), flush=True)
    return worst


def locator_timing(code, dev, g) -> dict:
    """One column (the global decode) from a CUDA graph, as back-to-back
    wrapper calls, the plain version's time and the bound."""
    plain, kernel = locator_pair(code, dev)
    e_re, e_im, pres = locator_columns(code, 1, (3,), (), dev, g)
    n, s, m = code.n, code.s, code.n - 2 * code.s
    nbytes = 4 * (2 * n + 2 * (2 * s * n + n * m + n * (s + 1)) + n
                  + 2 * n + 1) + 3 * n
    b_ms, b_by = bound(nbytes, locator_flops(n, s))
    return {"n": n, "s": s,
            "instance": decode_kernels.locator_instance(n, s),
            "ms": graph_ms(lambda: kernel(e_re, e_im, pres), 200),
            "launch_ms": time_ms(lambda: kernel(e_re, e_im, pres), 200),
            "plain_ms": time_ms(lambda: plain(e_re, e_im, pres), 10),
            "bound_ms": b_ms, "bound_by": b_by}


LAM = 2.0 ** -6  # the narrow wires' λ (the signal-scale path)
# the tree topology's locator (shared_tree_g8: a group of 8, s_g = 1): two
# groups' columns, each column with its own group's presence; per column
# (attacked rows, absent rows)
TREE_LOCATOR_CASES = (
    ("an attacked row in group 0, an absent one in group 1",
     (((3,), ()), ((), (6,)))),
    ("two absent rows in each group, at other places",
     (((), (1, 4)), ((), (2, 7)))),
    ("an attacked row in group 0, two absent rows in group 1",
     (((0,), ()), ((), (3, 5)))))


def group_columns(code, per_column, dev, g):
    """(L, n) projected columns, one a group, each from its own encode with
    its own attacked and absent rows (``per_column``: (attacked, absent)
    a column), and the (L, n) presence a row a column."""
    cols = [locator_columns(code, 1, att, ab, dev, g)
            for att, ab in per_column]
    return tuple(torch.cat([c[i] for c in cols]).contiguous()
                 for i in range(3))


def tree_locator(code, dev, g) -> dict:
    """The locator with a presence row a column (the tree's groups, L=2 at
    n=8, s=1) against its plain version: discrete outputs equal, v within
    1e-4 of max|v|, the residual within 1e-5; each column bit for bit the
    kernel on that column alone with its presence as the shared (1, n)
    row; each column's attacked rows located and absent rows unused.
    Timed from a graph at L=2."""
    plain, kernel = locator_pair(code, dev)
    worst = 0.0
    for label, per_column in TREE_LOCATOR_CASES:
        e_re, e_im, pres = group_columns(code, per_column, dev, g)
        k = kernel(e_re, e_im, pres)
        p = plain(e_re, e_im, pres)
        for i, name in zip((2, 3, 4), ("honest", "flagged", "loud")):
            require(torch.equal(k[i], p[i]), f"cyclic_locator per-column "
                    f"[{label}]: {name} kernel {k[i].int().tolist()} plain "
                    f"{p[i].int().tolist()}")
        v_scale = max(p[0].abs().max().item(), p[1].abs().max().item())
        v_err = max((k[0] - p[0]).abs().max().item(),
                    (k[1] - p[1]).abs().max().item())
        r_err = (k[5] - p[5]).abs().max().item()
        require(v_err <= 1e-4 * v_scale and r_err <= 1e-5,
                f"cyclic_locator per-column [{label}]: v err {v_err}, "
                f"residual err {r_err}")
        worst = max(worst, v_err)
        for c, (att, ab) in enumerate(per_column):
            one = kernel(e_re[c:c + 1].contiguous(),
                         e_im[c:c + 1].contiguous(),
                         pres[c:c + 1].contiguous())
            require(all(_same_bits(a[c], b[0]) for a, b in zip(k, one)),
                    f"cyclic_locator per-column [{label}]: column {c} "
                    f"differs from the kernel on that column alone")
            for row in att:
                require(bool(k[3][c, row]) and not bool(k[2][c, row]),
                        f"cyclic_locator per-column [{label}]: column {c} "
                        f"did not locate row {row}")
            for row in ab:
                require(not bool(k[2][c, row]),
                        f"cyclic_locator per-column [{label}]: column {c} "
                        f"used absent row {row}")
        print(f"kernel cyclic_locator per-column presence [{label}]: "
              f"discrete outputs held, each column the kernel alone bit "
              f"for bit, v err {v_err:.3e}", flush=True)
    e_re, e_im, pres = group_columns(code, TREE_LOCATOR_CASES[0][1], dev, g)
    ms = graph_ms(lambda: kernel(e_re, e_im, pres), 200)
    plain_ms = time_ms(lambda: plain(e_re, e_im, pres), 10)
    print(f"kernel cyclic_locator at L=2, n=8 with a presence row a column: "
          f"ms={ms:.4f} (device, CUDA graph) plain_ms={plain_ms:.4f}",
          flush=True)
    return {"L": 2, "n": code.n, "s": code.s, "max_abs_err": worst,
            "ms": ms, "plain_ms": plain_ms}


# the NaN columns of the decode chain (``nan_chain_kernels``): one encoded
# row poisoned by a NaN, one by an Inf, and every row NaN (an honest
# worker's NaN gradient through the shared encode, the simulate_guard_nan
# leg's step 2)
NAN_CASES = (("a NaN row", float("nan"), (3,)),
             ("an Inf row", float("inf"), (5,)),
             ("every row NaN", float("nan"), tuple(range(N))))


def _nan_equal(a: torch.Tensor, b: torch.Tensor, rtol: float) -> bool:
    """The same non-finite entries (NaN where NaN, ±Inf where ±Inf) and the
    finite ones within ``rtol`` of the largest."""
    if not torch.equal(torch.isnan(a), torch.isnan(b)):
        return False
    fin = torch.isfinite(b)
    if not torch.equal(torch.isfinite(a), fin) or not torch.equal(
            a[torch.isinf(b)], b[torch.isinf(b)]):
        return False
    if not bool(fin.any()):
        return True
    scale = float(b[fin].abs().max()) or 1.0
    return float((a[fin] - b[fin]).abs().max()) <= rtol * scale


def nan_chain_kernels(code, dev) -> dict:
    """``complex_project`` → ``cyclic_locator`` → ``complex_recombine`` on
    codewords at ResNet-18's n=8, d=11,173,962 with non-finite rows
    (``NAN_CASES``), each kernel against its plain version on the same
    inputs: the projected column and the recombination NaN and Inf where
    the plain version's are (finite entries within 1e-5 of the largest),
    the locator's honest, flagged and loud masks equal and its residual
    NaN where the plain version's is. Every launch returns: no hang, no
    trap."""
    g = torch.Generator(device=dev).manual_seed(SEED + 18)
    t = code.tensors(dev)
    grads = torch.randn((N, D), generator=g, device=dev)
    enc_re, enc_im = coded.complex_matmul_plain(t["w_masked_re"],
                                                t["w_masked_im"], grads)
    del grads
    f = 1.0 + torch.randn(D, generator=g, device=dev)
    plain_loc, kernel_loc = locator_pair(code, dev)
    pres = torch.ones((1, N), device=dev)
    out = {}
    for label, val, rows in NAN_CASES:
        r_re, r_im = enc_re.clone(), enc_im.clone()
        r_re[list(rows), 4099] = val
        r_im[list(rows), D - 7] = val
        e_k = coded.complex_project(r_re, r_im, f)
        e_p = coded.complex_project_plain(r_re, r_im, f)
        require(all(_nan_equal(a, b, 1e-5) for a, b in zip(e_k, e_p)),
                f"nan chain {label}: complex_project {e_k} vs plain {e_p}")
        cols = (e_p[0][None].contiguous(), e_p[1][None].contiguous())
        lk, lp = kernel_loc(*cols, pres), plain_loc(*cols, pres)
        masks = ("honest", "flagged", "loud")
        for name, a, b in zip(masks, lk[2:5], lp[2:5]):
            require(torch.equal(a, b), f"nan chain {label}: locator {name} "
                    f"{a.tolist()} vs plain {b.tolist()}")
        rk, rp = float(lk[5][0]), float(lp[5][0])
        require(math.isnan(rk) == math.isnan(rp)
                and (math.isnan(rp) or abs(rk - rp) <= 1e-5),
                f"nan chain {label}: residual {rk} vs plain {rp}")
        v_re, v_im = lk[0][0] / N, lk[1][0] / N
        dk = coded.complex_recombine(v_re, v_im, r_re, r_im)
        dp = coded.complex_recombine_plain(v_re, v_im, r_re, r_im)
        require(_nan_equal(dk, dp, 1e-5), f"nan chain {label}: "
                f"complex_recombine against its plain version")
        torch.cuda.synchronize()
        out[label] = {"residual": rk, "plain_residual": rp,
                      "flagged": lk[3][0].tolist(), "loud": lk[4][0].tolist(),
                      "honest": lk[2][0].tolist(),
                      "decoded_nan": int(torch.isnan(dk).sum()),
                      "decoded_inf": int(torch.isinf(dk).sum())}
        print(f"kernel nan chain ({label}, rows {list(rows)}): project, "
              f"locator and recombine as their plain versions; residual "
              f"{rk} (plain {rp}), flagged {out[label]['flagged']}, loud "
              f"{out[label]['loud']}, decoded NaN {out[label]['decoded_nan']}"
              f" Inf {out[label]['decoded_inf']} of {D}", flush=True)
        del r_re, r_im, dk, dp
    del enc_re, enc_im
    torch.cuda.empty_cache()
    return out


def locator_kernel(code, dev, code9, old_lib) -> list:
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    worst = locator_cases(code, dev, g, [
        ("L=1, attacked row 3", 1, (3,), (), 0.0, None),
        ("L=62, attacked row 5", 62, (5,), (), 0.0, None),
        ("L=1, attacked row 2, absent row 6", 1, (2,), (6,), 0.0, None),
        ("L=62, λ=2^-6, attacked row 1", 62, (1,), (), LAM, None),
        ("L=8, λ=2^-6, clean", 8, (), (), LAM, None),
        ("L=1, attacked row 1, NaN row 3", 1, (1,), (), 0.0, (None, 3)),
        ("L=62, attacked row 5, NaN in column 7 row 2", 62, (5,), (), 0.0,
         (7, 2)),
        ("L=62, λ=2^-6, NaN row 4", 62, (), (), LAM, (None, 4))])
    # the VGG-11 legs' code: two attacked rows; one attacked row beside an
    # absent one (t + e <= s); λ > 0 on a clean column; a NaN row
    worst9 = locator_cases(code9, dev, g, [
        ("L=1, attacked rows 2 and 6", 1, (2, 6), (), 0.0, None),
        ("L=22, attacked rows 0 and 8", 22, (0, 8), (), 0.0, None),
        ("L=1, attacked row 4, absent row 7", 1, (4,), (7,), 0.0, None),
        ("L=8, λ=2^-6, clean", 8, (), (), LAM, None),
        ("L=1, attacked rows 1 and 5, NaN row 3", 1, (1, 5), (), 0.0,
         (None, 3))])
    # the wide codes, held beside the old kernel: the reference's int8
    # study code n=32, s=3 and its construction ceiling n=32, s=5 (the
    # shared-tile solve), and n=40, s=3 (two rows a lane)
    wide = {}
    for n, s in WIDE_CODES:
        c = cyclic.build_cyclic_code(n, s)
        rows = tuple(range(1, 1 + 5 * s, 5))  # s attacked rows
        if n > 32:  # rows past lane 31 attacked and absent
            cases = [("L=5, attacked rows 6 and 33, absent row 37", 5,
                      (6, 33), (37,), 0.0, None)]
        else:
            cases = [
                (f"L=1, attacked rows {rows}", 1, rows, (), 0.0, None),
                (f"L=4, attacked rows {rows[:-1]}, absent row {n - 3}", 4,
                 rows[:-1], (n - 3,), 0.0, None),
                (f"L=8, λ=2^-6, attacked rows {rows}", 8, rows, (), LAM,
                 None),
                (f"L=1, attacked rows {rows[:-1]}, NaN row {n - 5}", 1,
                 rows[:-1], (), 0.0, (None, n - 5))]
        wide[(n, s)] = locator_cases(c, dev, g, cases, old_lib)
    # the layer legs' column counts (ResNet-18's 62 leaves, the LM's 69
    # segments), from a graph
    _, kernel = locator_pair(code, dev)
    at_l = {}
    for L in (62, 69):
        e_re, e_im, pres = locator_columns(code, L, (3,), (), dev, g)
        at_l[str(L)] = graph_ms(lambda: kernel(e_re, e_im, pres), 50)
    print(f"kernel cyclic_locator: L=62 {at_l['62']:.4f} ms, L=69 "
          f"{at_l['69']:.4f} ms (device, CUDA graph)", flush=True)
    per_column = tree_locator(code, dev, g)
    # timed at the main path's shape, one column (global decode), and at
    # the wide codes n=32, s=3 and s=5
    t8, t9 = locator_timing(code, dev, g), locator_timing(code9, dev, g)
    tw = {f"n{n}_s{s}": locator_timing(cyclic.build_cyclic_code(n, s), dev,
                                       g)
          for n, s in WIDE_CODES if n == 32}
    for t in (t8, t9, *tw.values()):
        print(f"kernel cyclic_locator at n={t['n']}, s={t['s']} "
              f"({t['instance']}): ms={t['ms']:.4f} (device, CUDA graph) "
              f"launch_ms={t['launch_ms']:.4f} (back-to-back wrapper calls) "
              f"plain_ms={t['plain_ms']:.4f} bound_ms={t['bound_ms']:.3e} "
              f"({t['bound_by']}; the dependency chain and the launch set "
              f"its time)", flush=True)
    return [{"name": "cyclic_locator", "route": "cuda",
             "source": "draco_tpu_torch/csrc/cyclic_locator.cu",
             "replaces": "draco_tpu/ops/decode_kernels.py:127", "ok": True,
             "max_abs_err": worst, "tol": "discrete equal; v 1e-4 rel",
             "ms": t8["ms"], "launch_ms": t8["launch_ms"],
             "plain_ms": t8["plain_ms"], "graph_ms_at_L": at_l,
             "bound_ms": t8["bound_ms"], "bound_by": t8["bound_by"],
             "library_ms": None, "instance": t8["instance"],
             "n9_s2": {"max_abs_err": worst9, **t9},
             "per_column_presence": per_column,
             **{k: {"max_abs_err": wide[(t["n"], t["s"])], **t}
                for k, t in tw.items()},
             "n40_s3": {"n": 40, "s": 3, "max_abs_err": wide[(40, 3)],
                        "instance": decode_kernels.locator_instance(40, 3)}}]


def vote_kernels(dev) -> list:
    """``row_fingerprints`` against its plain version (int64 masked to 32
    bits), bit for bit in both hashes: f32 and bf16 rows at n=9,
    d=11,173,962 (the majvote leg's) and at d=5003, each from a buffer
    aligned to 16 bytes and from one that starts 4 (f32) / 2 (bf16) bytes
    past it, under the public salts and under drawn ones, each launched
    twice with the same bits. Rows that differ in one element, or in the
    top bits of two positions, must get other fingerprints. Timed at the
    leg's shape in f32: the kernel (CUDA graph of back-to-back calls), its
    plain version and the bound: the larger of the rows' bytes over the
    memory rate and its 32-bit integer operations (ops/vote.py) over the
    card's INT32 rate."""
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    drawn = vote.salts_tensor(
        torch.randint(0, 1 << 32, (2,), generator=torch.Generator()
                      .manual_seed(SEED), dtype=torch.int64).tolist(), dev)
    checked = 0
    for dtype in (torch.float32, torch.bfloat16):
        for d in (D, 5003):
            for offset in (0, 4 if dtype == torch.float32 else 2):
                flat = torch.randn(VOTE_N * d + 8, generator=g,
                                   device=dev).to(dtype)
                start = offset // flat.element_size()
                rows = flat[start:start + VOTE_N * d].view(VOTE_N, d)
                for salts in (vote.public_salts(dev), drawn):
                    k1 = vote.row_fingerprints(rows, salts)
                    k2 = vote.row_fingerprints(rows, salts)
                    p = repetition._row_fingerprints(rows, salts)
                    require(torch.equal(k1, p) and torch.equal(k1, k2),
                            f"row_fingerprints {dtype} d={d} at byte "
                            f"{offset}: kernel {k1.tolist()} / again "
                            f"{k2.tolist()}, plain {p.tolist()}")
                    checked += 1
                del flat, rows
    # forgeries: one element changed, the top bits of two positions flipped
    rows = torch.randn((3, 5003), generator=g, device=dev)
    rows[1] = rows[0]
    rows[1, 4001] = torch.nextafter(rows[0, 4001], rows[0, 4001] + 1)
    bits = rows[0].view(torch.int32).clone()
    bits[[17, 2900]] ^= torch.tensor(-(1 << 31), dtype=torch.int32,
                                     device=dev)
    rows[2] = bits.view(torch.float32)
    for salts in (vote.public_salts(dev), drawn):
        fp = vote.row_fingerprints(rows, salts)
        require(not torch.equal(fp[0], fp[1]) and
                not torch.equal(fp[0], fp[2]),
                f"row_fingerprints: a forged row collided: {fp.tolist()}")
    del rows
    rows = torch.randn((VOTE_N, D), generator=g, device=dev)
    salts = vote.public_salts(dev)
    ms = graph_ms(lambda: vote.row_fingerprints(rows, salts), 20)
    launch_ms = time_ms(lambda: vote.row_fingerprints(rows, salts), 20)
    plain_ms = time_ms(lambda: repetition._row_fingerprints(rows, salts), 3,
                       warmup=1)
    b_ms, b_by = bound(4 * VOTE_N * D + 8 + 8 * VOTE_N,
                       vote.fingerprint_ops(VOTE_N, D), INT32_OPS)
    # the compiled loop against the INT32 pipe alone (64 lanes a SM)
    loops = vote_loop_instructions()
    f32 = loops["row_fingerprints_kernel<4>"]
    pipe_ms = (f32["int32_pipe_per_element"] * VOTE_N * D
               / (INT32_OPS / 2) * 1e3)
    print(f"kernel row_fingerprints: bit for bit its plain version in "
          f"{checked} cases (f32/bf16, d={D}/5003, aligned and offset "
          f"buffers, public and drawn salts, two launches each), forgeries "
          f"separated; ms={ms:.4f} (CUDA graph) launch_ms={launch_ms:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}; bytes "
          f"{4 * VOTE_N * D / HBM_BYTES_PER_S * 1e3:.4f} ms); the f32 loop "
          f"{f32['instructions_per_element']:.2f} instructions an element, "
          f"{f32['int32_pipe_per_element']:.2f} on the INT32 pipe: "
          f"{pipe_ms:.4f} ms at 64 a clock a SM", flush=True)
    return [{"name": "row_fingerprints", "route": "cuda",
             "source": "draco_tpu_torch/csrc/vote.cu",
             "replaces": "draco_tpu/coding/repetition.py:94", "ok": True,
             "max_abs_err": 0.0, "tol": "bit for bit (uint32, both hashes)",
             "cases": checked, "ms": ms, "launch_ms": launch_ms,
             "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": None, "sass_loop": loops,
             "int32_pipe_ms": pipe_ms}]


# the device draws (csrc/draws.cu) at the legs' shapes: the random attack's
# cyclic pair on vgg11_random's 2 of 9 rows at VGG-11's d and on
# lm_shared_flash_devgen's 1 of 8 at the LM's d, its plain form on
# majvote_random's 1 of 9 at ResNet-18's d; stochastic rounding's draws at
# ResNet-18's d (shared_int8_sr's int8 pair, majvote_bf16_sr's bf16 rows);
# the tokens of the LM leg (n=8, B=2, T=512, vocab 8192)
DRAW_STEP = 7
NORMAL_TOL = 3e-5  # relative to max(1, |z|): the CPU tests' tolerance
INJECT_CASES = (("pair, vgg11_random", VGG_N, VGG_D, (1, 6), True),
                ("pair, lm_shared_flash_devgen", N, LM_D, (3,), True),
                ("plain form, majvote_random", VOTE_N, D, (5,), False))
LM_TEXT = (N, 2, 512, 8192)


def replay_steps(name: str, fn, step: torch.Tensor, s1: int, s2: int):
    """``fn()`` (a draw entry point reading the device ``step``) launched
    directly twice at step ``s1`` and once at ``s2``, then captured once in
    a CUDA graph and replayed with the staged step set to ``s1`` and to
    ``s2``: the two launches bit for bit, each replay bit for bit the
    direct launch at its step, and the two steps' draws different."""
    def outs():
        r = fn()
        return [r] if isinstance(r, torch.Tensor) else list(r)

    step.fill_(s1)
    d1 = [t.clone() for t in outs()]
    again = [t.clone() for t in outs()]
    require(all(_same_bits(a, b) for a, b in zip(d1, again)),
            f"{name}: two launches on the same inputs differ")
    step.fill_(s2)
    d2 = [t.clone() for t in outs()]
    current = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(current)
    with torch.cuda.stream(side):
        outs()
    current.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = outs()
    got = []
    for s in (s1, s2):
        step.fill_(s)
        graph.replay()
        got.append([t.clone() for t in captured])
    torch.cuda.synchronize()
    require(all(_same_bits(a, b) for a, b in zip(d1, got[0]))
            and all(_same_bits(a, b) for a, b in zip(d2, got[1])),
            f"{name}: a graph replay differs from the direct launch at its "
            f"staged step")
    require(not all(_same_bits(a, b) for a, b in zip(got[0], got[1])),
            f"{name}: the replays at steps {s1} and {s2} drew the same "
            f"numbers")
    del graph, captured


def draw_kernels(dev) -> tuple:
    """The three draw entry points against their plain versions (the torch
    stream of ``rng.py``, run on the card on the same inputs): the random
    attack's normals within NORMAL_TOL·max(1, |z|) of the plain version's
    (from zero rows, so the output is magnitude·z) and every other row
    untouched, the rounding draws and the tokens bit for bit, and the
    wires quantized with the kernel's draws bit for bit those quantized
    with the plain version's; each bit for bit across two launches and
    between a graph replay and a direct launch, at two staged steps whose
    draws differ. Timed at vgg11_random's pair, shared_int8_sr's int8 pair
    and the LM's tokens: the kernel from a CUDA graph, its plain version,
    and the bound, the larger of the bytes over the memory rate and the
    32-bit integer operations (ops/draws.py) over the card's INT32 rate.
    Returns (kernel rows, the graph-replay notes)."""
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    step = torch.tensor(DRAW_STEP, dtype=torch.int32, device=dev)
    seed = SEED + draws.RANDOM_SALT
    replays, rows = [], []

    def mask_of(n, hit):
        m = torch.zeros(n, dtype=torch.bool, device=dev)
        m[list(hit)] = True
        return m

    # ---- random_inject ----
    inject_err, checks = 0.0, []
    for label, n, d, hit, pair in INJECT_CASES:
        mask = mask_of(n, hit)
        parts = 2 if pair else 1
        k = [torch.zeros((n, d), device=dev) for _ in range(parts)]
        draws.random_inject(k[0], mask, step, seed, ADVERSARY_MAG,
                            k[1] if pair else None)
        p = [torch.zeros((n, d), device=dev) for _ in range(parts)]
        draws.random_inject_plain(p[0], mask, step, seed, ADVERSARY_MAG,
                                  p[1] if pair else None)
        idle = ~mask
        for a, b in zip(k, p):
            za, zb = a[mask] / ADVERSARY_MAG, b[mask] / ADVERSARY_MAG
            err = ((za - zb).abs() / zb.abs().clamp_min(1.0)).max().item()
            inject_err = max(inject_err, err)
            require(err <= NORMAL_TOL and not a[idle].any()
                    and not b[idle].any(),
                    f"random_inject {label}: normals {err:.3e} off the "
                    f"plain version's (tol {NORMAL_TOL}·max(1, |z|)), or a "
                    f"row outside the mask written")
        checks.append(f"{label}: n={n} d={d} rows {list(hit)}")
        del k, p
        torch.cuda.empty_cache()
        base = torch.randn((n, d), generator=g, device=dev)
        bufs = [torch.empty_like(base) for _ in range(parts)]

        def inject(mask=mask, pair=pair, base=base, bufs=bufs):
            for b in bufs:
                b.copy_(base)
            draws.random_inject(bufs[0], mask, step, seed, ADVERSARY_MAG,
                                bufs[1] if pair else None)
            return bufs
        replay_steps(f"random_inject {label}", inject, step, DRAW_STEP,
                     DRAW_STEP + 1)
        replays.append(f"random_inject ({label}, steps {DRAW_STEP} and "
                       f"{DRAW_STEP + 1})")
        del base, bufs
        torch.cuda.empty_cache()
    step.fill_(DRAW_STEP)
    label, n, d, hit, _ = INJECT_CASES[0]
    mask = mask_of(n, hit)
    re_, im_ = (torch.randn((n, d), generator=g, device=dev)
                for _ in range(2))
    ms = graph_ms(lambda: draws.random_inject(re_, mask, step, seed,
                                              ADVERSARY_MAG, im_), 20)
    plain_ms = time_ms(lambda: draws.random_inject_plain(
        re_, mask, step, seed, ADVERSARY_MAG, im_), 3, warmup=1)
    t = len(hit)
    b_ms, b_by = bound(2 * 2 * 4 * t * d + n + 4,
                       draws.draw_ops(2 * t * d), INT32_OPS)
    del re_, im_
    rows.append({"name": "random_inject", "route": "cuda",
                 "source": "draco_tpu_torch/csrc/draws.cu",
                 "replaces": "draco_tpu/attacks.py:40", "ok": True,
                 "max_abs_err": inject_err,
                 "tol": f"{NORMAL_TOL}·max(1, |z|) on the normals",
                 "cases": checks, "timed_at": f"{label}: n={n} d={d}, "
                 f"{t} rows, real and imaginary", "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": None})
    print(f"kernel random_inject: normals within {inject_err:.3e}·max(1, "
          f"|z|) of the plain version's (tol {NORMAL_TOL}) in "
          f"{'; '.join(checks)}; two launches and graph replays at two "
          f"steps bit for bit; ms={ms:.4f} (CUDA graph, {label}) "
          f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by})",
          flush=True)

    # ---- round_draw ----
    wseed = SEED + draws.WIRE_SALT
    for mode, parts, n in (("int8", 2, N), ("bf16", 1, VOTE_N)):
        k = draws.round_draw(step, wseed, D, mode, parts)
        p = draws.round_draw_plain(step, wseed, D, mode, parts, dev)
        require(_same_bits(k, p), f"round_draw {mode}: the kernel's draws "
                f"differ from the plain version's")
        x = torch.randn((n, D), generator=g, device=dev)
        qk = numerics.narrow_wire_rows(x, mode, BLOCK, k[0])
        qp = numerics.narrow_wire_rows(x, mode, BLOCK, p[0])
        require(all(_same_bits(qk[c], qp[c]) for c in qk),
                f"round_draw {mode}: the wire rounded with the kernel's "
                f"draw differs from the plain version's")
        del x, qk, qp, k, p
        replay_steps(f"round_draw {mode}", lambda mode=mode, parts=parts:
                     draws.round_draw(step, wseed, D, mode, parts), step,
                     DRAW_STEP, DRAW_STEP + 1)
        replays.append(f"round_draw ({mode}, {parts} part(s), d={D}, steps "
                       f"{DRAW_STEP} and {DRAW_STEP + 1})")
    step.fill_(DRAW_STEP)
    ms = graph_ms(lambda: draws.round_draw(step, wseed, D, "int8", 2), 20)
    plain_ms = time_ms(lambda: draws.round_draw_plain(
        step, wseed, D, "int8", 2, dev), 3, warmup=1)
    b_ms, b_by = bound(2 * 4 * D + 4, draws.draw_ops(2 * D), INT32_OPS)
    rows.append({"name": "round_draw", "route": "cuda",
                 "source": "draco_tpu_torch/csrc/draws.cu",
                 "replaces": "draco_tpu/obs/numerics.py:494", "ok": True,
                 "max_abs_err": 0.0, "tol": "bit for bit (the draws and "
                 "the rounded wires)", "timed_at": f"int8, 2 parts, d={D} "
                 f"(shared_int8_sr)", "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    print(f"kernel round_draw: bit for bit its plain version (int8 pair at "
          f"n={N}, bf16 at n={VOTE_N}, d={D}) and the wires rounded with "
          f"it; two launches and graph replays at two steps bit for bit; "
          f"ms={ms:.4f} (CUDA graph) plain_ms={plain_ms:.4f} "
          f"bound_ms={b_ms:.4f} ({b_by})", flush=True)

    # ---- synthetic_text ----
    n, b, t, vocab = LM_TEXT
    k = draws.synthetic_text(step, SEED, n, b, t, vocab)
    p = draws.synthetic_text_plain(step, SEED, n, b, t, vocab, dev)
    require(torch.equal(k, p), "synthetic_text: the kernel's tokens differ "
            "from the plain version's")
    replay_steps("synthetic_text", lambda: draws.synthetic_text(
        step, SEED, n, b, t, vocab), step, DRAW_STEP, DRAW_STEP + 1)
    replays.append(f"synthetic_text (n={n} B={b} T={t}, steps {DRAW_STEP} "
                   f"and {DRAW_STEP + 1})")
    step.fill_(DRAW_STEP)
    ms = graph_ms(lambda: draws.synthetic_text(step, SEED, n, b, t, vocab),
                  20)
    plain_ms = time_ms(lambda: draws.synthetic_text_plain(
        step, SEED, n, b, t, vocab, dev), 3, warmup=1)
    b_ms, b_by = bound(4 * n * b * t + 4, draws.text_ops(n * b), INT32_OPS)
    rows.append({"name": "synthetic_text", "route": "cuda",
                 "source": "draco_tpu_torch/csrc/draws.cu",
                 "replaces": "draco_tpu/parallel/sp_step.py:83", "ok": True,
                 "max_abs_err": 0.0, "tol": "bit for bit (int32 tokens)",
                 "timed_at": f"n={n} B={b} T={t} vocab={vocab}", "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": None})
    print(f"kernel synthetic_text: bit for bit its plain version at n={n} "
          f"B={b} T={t}; two launches and graph replays at two steps bit "
          f"for bit; ms={ms:.4f} (CUDA graph) plain_ms={plain_ms:.4f} "
          f"bound_ms={b_ms:.4f} ({b_by})", flush=True)
    step_rows, step_replays = step_draw_kernels(dev, step)
    torch.cuda.empty_cache()
    return rows + step_rows, replays + step_replays


# the training step's draws at the legs' shapes: (rows, div, B) of the
# augmentation (shared and the ResNet legs at n=8, the tree legs at n=16,
# the vote's 9 lanes in groups of 3, the VGG-11 legs' 9), (rows, layers,
# B, width) of VGG-11's dropout
AUG_CASES = ((N, 1, 32), (16, 1, 32), (VOTE_N, 3, 32), (VGG_N, 1, 32))
DROPOUT_CASE = (VGG_N, 2, 32, 512)


def step_draw_kernels(dev, step) -> tuple:
    """The training step's draws (``augment_draws``, ``dropout_keep``,
    ``vote_salts``) against their plain versions run on the card, bit for
    bit at the legs' shapes, twice and from a graph replayed at two staged
    steps. Timed: each kernel from a graph, its plain version called
    directly, and the step's draws as a chunk would pay them — the
    kernels' and the plain versions' captured in one graph each — for
    ``shared`` (the augmentation at n=8) and ``vgg11_simulate`` (n=9, and
    the dropout masks)."""
    rows, replays = [], []
    aseed = SEED + draws.AUG_SALT
    dseed = SEED + draws.DROPOUT_SALT
    vseed = SEED + draws.VOTE_SALT
    step.fill_(DRAW_STEP)
    for r, div, b in AUG_CASES:
        k = draws.augment_draws(step, aseed, r, b, div)
        p = draws.augment_draws_plain(step, aseed, r, b, div, dev)
        require(torch.equal(k, p), f"augment_draws rows={r} div={div}: the "
                f"kernel's draws differ from the plain version's")
    replay_steps("augment_draws", lambda: draws.augment_draws(
        step, aseed, N, 32), step, DRAW_STEP, DRAW_STEP + 1)
    replays.append(f"augment_draws (n={N} B=32, steps {DRAW_STEP} and "
                   f"{DRAW_STEP + 1})")
    r, count, b, w = DROPOUT_CASE
    step.fill_(DRAW_STEP)
    k = draws.dropout_keep(step, dseed, r, count, b, w)
    p = draws.dropout_keep_plain(step, dseed, r, count, b, w, 1, dev)
    require(torch.equal(k, p), "dropout_keep: the kernel's masks differ "
            "from the plain version's")
    replay_steps("dropout_keep", lambda: draws.dropout_keep(
        step, dseed, r, count, b, w), step, DRAW_STEP, DRAW_STEP + 1)
    replays.append(f"dropout_keep ({r} rows x {count} x {b} x {w}, steps "
                   f"{DRAW_STEP} and {DRAW_STEP + 1})")
    step.fill_(DRAW_STEP)
    require(torch.equal(draws.vote_salts(step, vseed),
                        draws.vote_salts_plain(step, vseed, dev)),
            "vote_salts: the kernel's salts differ from the plain version's")
    replay_steps("vote_salts", lambda: draws.vote_salts(step, vseed), step,
                 DRAW_STEP, DRAW_STEP + 1)
    replays.append(f"vote_salts (steps {DRAW_STEP} and {DRAW_STEP + 1})")
    step.fill_(DRAW_STEP)

    # a chunk's draws a step, kernels and plain versions each in a graph
    def shared_k():
        draws.augment_draws(step, aseed, N, 32)

    def shared_p():
        draws.augment_draws_plain(step, aseed, N, 32, 1, dev)

    def vgg_k():
        draws.augment_draws(step, aseed, VGG_N, 32)
        draws.dropout_keep(step, dseed, *DROPOUT_CASE)

    def vgg_p():
        draws.augment_draws_plain(step, aseed, VGG_N, 32, 1, dev)
        draws.dropout_keep_plain(step, dseed, *DROPOUT_CASE, 1, dev)

    chunk_cost = {"shared": {"kernels_ms": graph_ms(shared_k, 20),
                             "plain_ms": graph_ms(shared_p, 5)},
                  "vgg11_simulate": {"kernels_ms": graph_ms(vgg_k, 20),
                                     "plain_ms": graph_ms(vgg_p, 5)}}
    print(f"the step's draws a step from a graph (a chunk's cost): shared "
          f"kernels {chunk_cost['shared']['kernels_ms']:.4f} ms, plain "
          f"{chunk_cost['shared']['plain_ms']:.4f}; vgg11_simulate kernels "
          f"{chunk_cost['vgg11_simulate']['kernels_ms']:.4f}, plain "
          f"{chunk_cost['vgg11_simulate']['plain_ms']:.4f}", flush=True)
    samples = N * 32
    cases = (
        ("augment_draws", "draco_tpu/data/augment.py:18",
         lambda: draws.augment_draws(step, aseed, N, 32),
         lambda: draws.augment_draws_plain(step, aseed, N, 32, 1, dev),
         bound(3 * 4 * samples + 4, draws.sample_ops(N, 32), INT32_OPS),
         f"n={N} B=32 (shared); also n=16, the vote's 9 in groups of 3 "
         f"and VGG-11's 9"),
        ("dropout_keep", "draco_tpu/models/vgg.py:52",
         lambda: draws.dropout_keep(step, dseed, *DROPOUT_CASE),
         lambda: draws.dropout_keep_plain(step, dseed, *DROPOUT_CASE, 1,
                                          dev),
         bound(math.prod(DROPOUT_CASE) + 4,
               draws.draw_ops(math.prod(DROPOUT_CASE)), INT32_OPS),
         f"{DROPOUT_CASE[0]} rows x {DROPOUT_CASE[1]} layers x "
         f"{DROPOUT_CASE[2]} x {DROPOUT_CASE[3]} (VGG-11)"),
        ("vote_salts", "draco_tpu/coding/repetition.py:115",
         lambda: draws.vote_salts(step, vseed),
         lambda: draws.vote_salts_plain(step, vseed, dev),
         bound(8 + 4, draws.draw_ops(2 + 1), INT32_OPS), "(2,)"))
    for name, replaces, kfn, pfn, (b_ms, b_by), at in cases:
        ms = graph_ms(kfn, 20)
        plain_ms = time_ms(pfn, 5, warmup=1)
        row = {"name": name, "route": "cuda",
               "source": "draco_tpu_torch/csrc/draws.cu",
               "replaces": replaces, "ok": True, "max_abs_err": 0.0,
               "tol": "bit for bit", "timed_at": at, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": None}
        if name == "augment_draws":
            row["chunk_cost_per_step"] = chunk_cost
        rows.append(row)
        print(f"kernel {name}: bit for bit its plain version ({at}); two "
              f"launches and graph replays at two steps bit for bit; "
              f"ms={ms:.4f} (CUDA graph) plain_ms={plain_ms:.4f} "
              f"bound_ms={b_ms:.3e} ({b_by})", flush=True)
    return rows, replays


# --------------------------------------------------------------------------
# the numerics observatory's kernels (csrc/numerics.cu)
# --------------------------------------------------------------------------

# the statistics' columns that must equal the plain version's bit for bit:
# all but rms, whose Σ x² the kernel sums in f64 and the plain version in
# torch's f32 reduction
STAT_EXACT = tuple(i for i, k in enumerate(ops_numerics.STAT_NAMES)
                   if k != "rms")
RMS_RTOL = 1e-5  # the kernel's rms against the plain version's
RMS_F64_RTOL = 1e-6  # the kernel's rms against an f64 sum of the squares


def planted(shape, g, dev, huge: bool = True) -> torch.Tensor:
    """Normal values scaled over 2^-140 .. 2^20 with the edge cases planted
    in every row: zeros, subnormals above and below 2^-133, values at and
    just under the exponent edges, bfloat16's largest and larger
    (``huge``: their squares overflow f32, so Σ x² and rms are inf), ±Inf
    and NaN (one row kept finite)."""
    x = torch.randn(shape, generator=g, device=dev)
    e = torch.randint(-140, 21, shape, generator=g, device=dev)
    x = torch.ldexp(x, e.to(torch.float32))
    rows = x.view(-1, shape[-1])
    d = shape[-1]
    picks = [0.0, 2.0 ** -140, -(2.0 ** -134), 2.0 ** -130, 2.0 ** -126]
    if huge:
        picks += [3.3895313892515355e38, 3.4e38, -3.4e38]
    for k in (-32, -16, -8, 0, 8):
        picks += [2.0 ** k, math.nextafter(2.0 ** k, 0.0),
                  -math.nextafter(2.0 ** k, 0.0)]
    for r in range(rows.shape[0]):
        at = (r * 7919 + torch.arange(len(picks) + 2, device=dev) * 104729) % d
        rows[r, at[:len(picks)]] = torch.tensor(picks, device=dev)
        if r % 3 == 1:
            rows[r, at[-2]] = float("nan")
        if r % 3 == 2:
            rows[r, at[-1]] = float("inf") if r % 2 else float("-inf")
    return x


def stats_f64(parts) -> float:
    """The rms of the finite elements of ``parts``, the squares summed in
    f64."""
    s = n = 0.0
    for p in parts:
        f = p[torch.isfinite(p)].double()
        s += float((f * f).sum())
        n += f.numel()
    return math.sqrt(s / max(n, 1.0))


def numerics_kernels(dev) -> tuple:
    """``stage_stats`` and ``nonfinite_rows`` against their plain versions
    on the card. stage_stats on planted inputs (``planted``: subnormals,
    NaN, ±Inf, bfloat16's largest and larger, values at and under the
    exponent edges) at the shapes of the legs' stages — ``shared``'s grad
    (8, d), its wire pair and its aggregate (d,), ``simulate``'s grad
    (8, 3, d), ResNet-18's d — at block 256, and small ragged ones at
    blocks 1, 7, 256, 5000 (a whole CTA a block) and past d: every count
    column bit for bit, rms within 1e-5 of the plain version's and 1e-6 of
    an f64 sum; each twice and from a graph replay bit for bit.
    nonfinite_rows on clean rows, a NaN row, an Inf row, rows of
    ``simulate``'s (8, 3, d) lanes and a buffer off a 16-byte boundary,
    bool for bool. Times (CUDA graph) the shared leg's three stage calls
    against their byte bound, and nonfinite_rows at ``shared``'s (8, d),
    ``simulate``'s (8, 3, d) and the LM's (8, 62,958,336)."""
    g = torch.Generator(device=dev).manual_seed(SEED + 17)
    cases = 0
    worst_rms = worst_f64 = 0.0

    def hold(label, parts, block):
        nonlocal cases, worst_rms, worst_f64
        k1 = ops_numerics.stage_stats(parts, block)
        k2 = ops_numerics.stage_stats(parts, block)
        p = ops_numerics.stage_stats_plain(parts, block)
        idx = list(STAT_EXACT)
        require(_same_bits(k1, k2), f"stage_stats {label}: two launches "
                f"differ: {k1.tolist()} / {k2.tolist()}")
        require(_same_bits(k1[idx], p[idx]),
                f"stage_stats {label}: kernel {k1.tolist()}, plain "
                f"{p.tolist()}")
        if math.isinf(float(p[1])):
            # a square past f32's range: Σ x² is inf in f32, as the
            # reference sums it
            require(math.isinf(float(k1[1])), f"stage_stats {label}: rms "
                    f"{float(k1[1])!r}, plain inf")
            cases += 1
            return
        rel = abs(float(k1[1]) - float(p[1])) / max(float(p[1]), 1e-30)
        rel64 = (abs(float(k1[1]) - stats_f64(parts))
                 / max(stats_f64(parts), 1e-30))
        require(rel <= RMS_RTOL and rel64 <= RMS_F64_RTOL,
                f"stage_stats {label}: rms {float(k1[1])!r}, plain "
                f"{float(p[1])!r} ({rel:.2e}), f64 {stats_f64(parts)!r} "
                f"({rel64:.2e})")
        worst_rms, worst_f64 = max(worst_rms, rel), max(worst_f64, rel64)
        cases += 1

    grad = planted((N, D), g, dev, huge=False)
    hold("shared grad (8, d)", [grad], BLOCK)
    wre, wim = planted((N, D), g, dev, huge=False), planted((N, D), g, dev)
    hold("shared wire pair", [wre, wim], BLOCK)
    hold("shared wire re", [wre], BLOCK)
    agg = planted((D,), g, dev, huge=False)
    hold("aggregate (d,)", [agg], BLOCK)
    sim = planted((N, 3, D), g, dev, huge=False)
    hold("simulate grad (8, 3, d)", [sim], BLOCK)
    for shape in ((3, 1003), (5, 4100), (2, 2, 777)):
        for block in (1, 7, 256, 5000, 1 << 20):
            for huge in (False, True):
                parts = [planted(shape, g, dev, huge)]
                hold(f"{shape} block {block}", parts, block)
                parts.append(planted(shape, g, dev, huge))
                hold(f"{shape} x2 block {block}", parts, block)
    replays = []
    replay_bitwise("stage_stats", lambda: ops_numerics.stage_stats(
        [wre, wim], BLOCK))
    replays.append("stage_stats [shared wire pair]")
    # timed at the shared leg's three stages
    stages = ([grad], [wre, wim], [agg])
    ms = sum(graph_ms(lambda s=s: ops_numerics.stage_stats(s, BLOCK), 10)
             for s in stages)
    plain_ms = sum(time_ms(lambda s=s: ops_numerics.stage_stats_plain(
        s, BLOCK), 2, warmup=1) for s in stages)
    nbytes = sum(ops_numerics.stage_bytes(s) for s in stages)
    b_ms, b_by = bound(nbytes, ops_numerics.OPS_PER_ELEMENT * nbytes / 4,
                       INT32_OPS)
    sim_bytes = ops_numerics.stage_bytes([sim])
    sim_ms = graph_ms(lambda: ops_numerics.stage_stats([sim], BLOCK), 10)
    print(f"kernel stage_stats: {cases} cases, every count column bit for "
          f"bit its plain version, rms within {worst_rms:.2e} of the "
          f"plain's and {worst_f64:.2e} of an f64 sum; two launches and a "
          f"graph replay bit for bit; shared's three stages ms={ms:.4f} "
          f"(CUDA graph) plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} "
          f"({b_by}, {nbytes / 1e9:.4f} GB); simulate's grad stage "
          f"{sim_ms:.4f} ms ({sim_bytes / 1e9:.4f} GB, bound "
          f"{sim_bytes / HBM_BYTES_PER_S * 1e3:.4f})", flush=True)
    rows = [{"name": "stage_stats", "route": "cuda",
             "source": "draco_tpu_torch/csrc/numerics.cu",
             "replaces": "draco_tpu/obs/numerics.py:446", "ok": True,
             "max_abs_err": 0.0, "rms_rel_err": worst_rms,
             "rms_rel_err_f64": worst_f64,
             "tol": f"counts bit for bit; rms rtol {RMS_RTOL:g} (plain), "
                    f"{RMS_F64_RTOL:g} (f64)",
             "cases": cases, "timed_at": "shared's grad, wire and agg "
             "stages (n=8, d=11,173,962, block 256)", "ms": ms,
             "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": None, "simulate_grad_ms": sim_ms,
             "simulate_grad_bound_ms": sim_bytes / HBM_BYTES_PER_S * 1e3}]
    del grad, wre, wim, agg
    # nonfinite_rows
    checked = 0
    for shape in ((N, D), (N, 3, D), (9, 5003), (4, 1)):
        x = torch.randn(shape, generator=g, device=dev)
        flat = x.view(shape[0], -1)
        L = flat.shape[1]
        if shape[0] > 2:
            flat[1, L - 1] = float("nan")
            flat[2, L // 2] = float("-inf")
        for offset in (0, 1):
            buf = torch.empty(x.numel() + 1, device=dev)
            buf[offset:offset + x.numel()] = x.flatten()
            y = buf[offset:offset + x.numel()].view(shape)
            k = ops_numerics.nonfinite_rows(y)
            p = ops_numerics.nonfinite_rows_plain(y)
            require(torch.equal(k, p) and torch.equal(
                k, ops_numerics.nonfinite_rows(y)),
                f"nonfinite_rows {shape} at element {offset}: kernel "
                f"{k.tolist()}, plain {p.tolist()}")
            checked += 1
        del x, flat, buf, y
    sim = torch.randn((N, 3, D), generator=g, device=dev)
    replay_bitwise("nonfinite_rows", lambda: ops_numerics.nonfinite_rows(
        sim))
    replays.append("nonfinite_rows [simulate (8, 3, d)]")
    timed = {}
    for label, shape in (("shared", (N, D)), ("simulate", (N, 3, D)),
                         ("lm_shared_flash", (N, LM_D))):
        x = sim if label == "simulate" else torch.randn(
            shape, generator=g, device=dev)
        nb = 4 * x.numel() + shape[0]
        timed[label] = {
            "ms": graph_ms(lambda: ops_numerics.nonfinite_rows(x), 10),
            "plain_ms": time_ms(lambda: ops_numerics.nonfinite_rows_plain(
                x), 3, warmup=1),
            "bound_ms": nb / HBM_BYTES_PER_S * 1e3}
        del x
    del sim
    t = timed["simulate"]
    print(f"kernel nonfinite_rows: bool for bool its plain version in "
          f"{checked} cases (NaN and Inf rows, (8, 3, d) lanes, a buffer "
          f"off 16 bytes), a graph replay bit for bit; "
          + "; ".join(f"{k} ms={v['ms']:.4f} plain_ms={v['plain_ms']:.4f} "
                      f"bound_ms={v['bound_ms']:.4f}"
                      for k, v in timed.items()), flush=True)
    rows.append({"name": "nonfinite_rows", "route": "cuda",
                 "source": "draco_tpu_torch/csrc/numerics.cu",
                 "replaces": "draco_tpu/obs/forensics.py:161", "ok": True,
                 "max_abs_err": 0.0, "tol": "bool for bool",
                 "cases": checked, "timed_at": "simulate's (8, 3, d)",
                 "ms": t["ms"], "plain_ms": t["plain_ms"],
                 "bound_ms": t["bound_ms"], "bound_by": "bytes",
                 "library_ms": None, "by_leg": timed})
    return rows, replays


def vote_loop_instructions() -> dict:
    """The instructions of each fingerprint instance's 16-byte-load loop in
    the built library (``cuobjdump -sass``: from the loop's branch target
    to its backward branch), a loaded element: all of them, and those of
    the INT32 pipe (every integer instruction but the multiply-adds, IMAD,
    which issue to the FMA pipe)."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([exe, "-sass", str(_build.lib_path("vote"))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    out = {}
    for part in sass.split("Function : ")[1:]:
        m = re.search(r"row_fingerprints_kernelILi(\d)E", part)
        if not m:
            continue
        ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+(@!?P\w+\s+)?([A-Z0-9_.]+)"
                         r"([^;]*);", part)
        addr = [int(a, 16) for a, _, _, _ in ins]
        wide = next(i for i, x in enumerate(ins) if x[2].startswith("LDG")
                    and ".128" in x[2])
        back = next(i for i in range(wide, len(ins)) if ins[i][2] == "BRA"
                    and int(ins[i][3].split("0x")[-1], 16) < addr[wide])
        top = addr.index(int(ins[back][3].split("0x")[-1], 16))
        ops = [x[2].split(".")[0] for x in ins[top:back + 1]]
        per = 16 // int(m.group(1))
        skip = ("LDG", "BRA", "NOP")
        total = sum(o not in skip for o in ops)
        int_pipe = sum(o not in skip + ("IMAD",) for o in ops)
        out[f"row_fingerprints_kernel<{m.group(1)}>"] = {
            "elements": per, "instructions_per_element": total / per,
            "int32_pipe_per_element": int_pipe / per}
    require(len(out) == 2, f"row_fingerprints: loops found {sorted(out)}")
    return out


def locator_flops(n: int, s: int, sweeps: int = 12) -> int:
    """Floating-point operations of one locator column (f32, counted from
    the algorithm: syndrome, Jacobi sweeps on the 2s×2s system, locator
    values, complex Gauss–Jordan on the m×m honest rows, fit, median)."""
    M, m = 2 * s, n - 2 * s
    syndrome = 4 * 2 * M * n
    jacobi = sweeps * (M * (M - 1) // 2) * (6 * M + 12 * M + 20) + 4 * M * M
    values = 8 * 2 * (s + 1) * n
    gauss = m * (16 * m + 2 * 8 * m * m)
    fit = 8 * 2 * m * m + 8 * 2 * n * m + 10 * n
    rank = 3 * n * n
    return syndrome + jacobi + values + gauss + fit + rank


def narrow_kernels(code, dev) -> list:
    """The narrow recombination (bf16; int8 at block 256) and the approx
    decode (f32, bf16, int8) against their plain versions at n=8 and
    d=11,173,962, and at the small ragged d = 5002 (≡ 10 mod 16, as the
    full d) and 5003; at the small d also int8 at block 24 (which the
    recombination's 16-column strip does not divide) and block 1, and wire
    buffers that start 3 (int8) / 2 (bf16) bytes into their storage. The
    approx decode's rows are the partial sums of a real approx encode with
    rows 2 and 5 absent, row 2 a NaN payload that must not reach the
    output. Tolerance: 1e-5 of the largest column's Σ|coef|·|row| for the
    vectors (n-term f32 sums in another order), 1e-5 relative for the two
    squared norms (d-term sums). Each kernel's second launch on the same
    inputs must give the same bits (out; decoded and both sums). Timed at
    full size, beside the widened path each kernel replaces (widen the
    buffers, then complex_recombine or the plain f32 decode)."""
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    t = code.tensors(dev)
    acode = approx.build_approx_code(N, 1.5)
    absent = [2, 5]
    present = torch.ones(N, dtype=torch.bool)
    present[absent] = False
    vn = (approx.decode_weights(acode, present)[0] / N).to(dev)
    pres_f = present.float().to(dev)
    rows = {"cyclic_narrow_recombine": {}, "approx_decode": {}}
    nb = -(-D // BLOCK)
    widen = numerics.widen_wire_rows

    def note(name, mode, **kw):
        rows[name].setdefault(mode, {"max_abs_err": 0.0, "tol": 0.0,
                                     "bitwise_repeat": True})
        r = rows[name][mode]
        for k in ("max_abs_err", "tol"):
            if k in kw:
                r[k] = max(r[k], kw.pop(k))
        if "bitwise_repeat" in kw:
            r["bitwise_repeat"] &= kw.pop("bitwise_repeat")
        r.update(kw)

    def same_bits(a, b) -> bool:
        return all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))

    def wires(full):
        """(label, mode, block, byte offset) of the narrow wires taken at
        one length."""
        out = [(mode, mode, BLOCK, 0) for mode in ("bf16", "int8")]
        if not full:
            out += [("int8@24", "int8", 24, 0), ("int8@1", "int8", 1, 0),
                    ("int8@byte3", "int8", BLOCK, 3),
                    ("bf16@byte2", "bf16", BLOCK, 2)]
        return out

    def buffer(x, mode, block, offset):
        buf = numerics.narrow_wire_rows(x, mode, block)
        return {**buf, "q": kernel_audit.offset_copy(buf["q"], offset)}

    for d in (5002, 5003, D):
        full = d == D
        grads = torch.randn((N, d), generator=g, device=dev)
        enc_re, enc_im = coded.complex_matmul(t["w_masked_re"],
                                              t["w_masked_im"], grads)
        v_re = torch.randn(N, generator=g, device=dev)
        v_im = torch.randn(N, generator=g, device=dev)
        for label, mode, block, offset in wires(full):
            wire = (mode, buffer(enc_re, mode, block, offset),
                    buffer(enc_im, mode, block, offset), block)
            k = decode_kernels.cyclic_narrow_recombine(v_re, v_im, wire)
            k2 = decode_kernels.cyclic_narrow_recombine(v_re, v_im, wire)
            p = decode_kernels.cyclic_narrow_recombine_plain(v_re, v_im, wire)
            w_re, w_im = widen(wire[1], mode, block), widen(wire[2], mode,
                                                            block)
            scale = (v_re.abs() @ w_re.abs()
                     + v_im.abs() @ w_im.abs()).max().item()
            err = (k - p).abs().max().item()
            require(err <= 1e-5 * scale, f"cyclic_narrow_recombine {label} "
                    f"d={d}: max_abs_err {err} > {1e-5 * scale}")
            rep = same_bits([k], [k2])
            require(rep, f"cyclic_narrow_recombine {label} d={d}: two "
                    f"launches differ")
            note("cyclic_narrow_recombine", mode, max_abs_err=err,
                 tol=1e-5 * scale, bitwise_repeat=rep)
            del w_re, w_im
            if full:
                scales = 2 * N * nb * 4 if mode == "int8" else 0
                note("cyclic_narrow_recombine", mode,
                     ms=time_ms(lambda: decode_kernels.cyclic_narrow_recombine(
                         v_re, v_im, wire), 20),
                     plain_ms=time_ms(
                         lambda: decode_kernels.cyclic_narrow_recombine_plain(
                             v_re, v_im, wire), 10),
                     widened_ms=time_ms(lambda: coded.complex_recombine(
                         v_re, v_im, widen(wire[1], mode, BLOCK),
                         widen(wire[2], mode, BLOCK)), 10),
                     work=(2 * N * D * WIRE_BYTES[mode] + scales + 2 * N * 4
                           + D * 4,
                           2 * 2 * N * D + (2 * N * D if scales else 0)))
            del wire
        del enc_re, enc_im

        # the approx decode tail on the partial sums, rows 2 and 5 absent
        prow = approx.encode_shared(acode, grads)
        prow[absent] = 0.0
        prow[absent[0]] = float("nan")
        live = pres_f[:, None] > 0
        for label, mode, block, offset in [("f32", "f32", 1, 0)] + wires(
                full):
            wire = (None if mode == "f32" else
                    (mode, buffer(prow, mode, block, offset), block))
            rows_in = prow if wire is None else None
            k = decode_kernels.approx_decode(rows_in, grads, vn, pres_f, wire)
            k2 = decode_kernels.approx_decode(rows_in, grads, vn, pres_f,
                                              wire)
            p = decode_kernels.approx_decode_plain(rows_in, grads, vn, pres_f,
                                                   wire)
            require(bool(torch.isfinite(k[0]).all()),
                    f"approx_decode {label} d={d}: the absent NaN row "
                    f"reached the output")
            wide = prow if wire is None else widen(wire[1], mode, block)
            wide = torch.where(live, wide, torch.zeros_like(wide))
            scale = (vn.abs() @ wide.abs()).max().item()
            err = (k[0] - p[0]).abs().max().item()
            rel = max(abs(a.item() - b.item()) / abs(b.item())
                      for a, b in zip(k[1:], p[1:]))
            require(err <= 1e-5 * scale and rel <= 1e-5,
                    f"approx_decode {label} d={d}: max_abs_err {err} (tol "
                    f"{1e-5 * scale}), squared norms rel err {rel} (tol 1e-5)")
            rep = same_bits(k, k2)
            require(rep, f"approx_decode {label} d={d}: two launches differ "
                    f"(decoded or the sums)")
            note("approx_decode", mode, max_abs_err=err, tol=1e-5 * scale,
                 bitwise_repeat=rep)
            rows["approx_decode"][mode]["norms_rel_err"] = max(
                rel, rows["approx_decode"][mode].get("norms_rel_err", 0.0))
            del wide
            if full:
                # only the present rows are read: count what this run needs
                pr = N - len(absent)
                scales = pr * nb * 4 if mode == "int8" else 0

                def widened(wire=wire, mode=mode):
                    rows_w = prow if wire is None else widen(wire[1], mode,
                                                             BLOCK)
                    return decode_kernels.approx_decode_plain(
                        rows_w, grads, vn, pres_f)

                note("approx_decode", mode,
                     ms=time_ms(lambda: decode_kernels.approx_decode(
                         rows_in, grads, vn, pres_f, wire), 20),
                     plain_ms=time_ms(
                         lambda: decode_kernels.approx_decode_plain(
                             rows_in, grads, vn, pres_f, wire), 10),
                     widened_ms=time_ms(widened, 10),
                     work=(pr * D * WIRE_BYTES[mode] + scales + N * D * 4
                           + D * 4 + 2 * N * 4,
                           2 * pr * D + (pr * D if scales else 0)
                           + 4 * N * D + 3 * D))
            del wire
        del grads, prow

    # the kernels line carries the wire each leg's launches are read from:
    # int8 for the narrow recombination (shared_int8), f32 for the approx
    # decode (approx); the other wires ride along as "wires"
    main = {"cyclic_narrow_recombine": "int8", "approx_decode": "f32"}
    lines = {"cyclic_narrow_recombine": "draco_tpu/ops/decode_kernels.py:378",
             "approx_decode": "draco_tpu/ops/decode_kernels.py:271"}
    out = []
    for name, by_mode in rows.items():
        for mode, r in by_mode.items():
            work = r.pop("work")
            r["bound_ms"], r["bound_by"] = bound(*work)
            r["share_of_bound"] = r["bound_ms"] / r["ms"]
            print(f"kernel {name} [{mode}]: max_abs_err={r['max_abs_err']:.3e}"
                  f" (tol {r['tol']:.3e}) ms={r['ms']:.4f} plain_ms="
                  f"{r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
                  f"({r['bound_by']}, {100 * r['share_of_bound']:.1f}% of "
                  f"bound) bitwise_repeat={r['bitwise_repeat']} "
                  f"library_ms=null; the widened path it replaces "
                  f"{r['widened_ms']:.4f} ms", flush=True)
        out.append({"name": name, "route": "cuda",
                    "source": "draco_tpu_torch/csrc/narrow_decode.cu",
                    "replaces": lines[name], "ok": True, "wire": main[name],
                    **by_mode[main[name]], "library_ms": None,
                    "wires": by_mode})
    return out


def lm_width_kernels(code, dev) -> dict:
    """The LM legs' decode kernels at the LM's d = 62,958,336, n=8: the
    approx decode (f32, bf16, int8 at block 256) on the partial sums of a
    real approx encode with rows 2 and 5 absent (row 2 a NaN payload), the
    narrow recombination on the int8 codeword pair, and round_draw's int8
    pair. Each against its plain version at ``narrow_kernels``' tolerances
    (round_draw bit for bit), twice bit for bit, its replay from a CUDA
    graph bit for bit its direct launch, timed beside its plain version and
    its bound. Beside them the plain quantization the LM's narrow wires
    run in draco_encode (``numerics.narrow_wire_pair`` /
    ``narrow_wire_single``, not fused into a kernel): its ms and the
    memory it allocates above its inputs. Returns {kernel: {wire: row}}."""
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    d = LM_D
    nb = -(-d // BLOCK)
    out = {"approx_decode": {}, "cyclic_narrow_recombine": {},
           "round_draw": {}, "quantize": {}}
    grads = torch.randn((N, d), generator=g, device=dev)

    def held(name, k, k2, p, scale, rel_tol=1e-5):
        err = (k[0] - p[0]).abs().max().item()
        rel = max([abs(a.item() - b.item()) / abs(b.item())
                   for a, b in zip(k[1:], p[1:])] or [0.0])
        require(err <= 1e-5 * scale and rel <= rel_tol,
                f"{name} at the LM's d: max_abs_err {err} (tol "
                f"{1e-5 * scale}), squared norms rel err {rel}")
        require(all(_same_bits(a, b) for a, b in zip(k, k2)),
                f"{name} at the LM's d: two launches differ")
        return {"max_abs_err": err, "tol": 1e-5 * scale,
                "norms_rel_err": rel, "bitwise_repeat": True,
                "graph_replay_bitwise": True}

    def quantize_cost(label, fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        kept = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        held_b = torch.cuda.memory_allocated(dev) - base
        del kept
        out["quantize"][label] = {"ms": time_ms(fn, 5, warmup=1),
                                  "peak_bytes_above_inputs": peak,
                                  "output_bytes": held_b}

    # the approx decode on six present rows
    acode = approx.build_approx_code(N, 1.5)
    absent = [2, 5]
    present = torch.ones(N, dtype=torch.bool)
    present[absent] = False
    vn = (approx.decode_weights(acode, present)[0] / N).to(dev)
    pres_f = present.float().to(dev)
    prow = approx.encode_shared(acode, grads)
    prow[absent] = 0.0
    prow[absent[0]] = float("nan")
    live = pres_f[:, None] > 0
    pr = N - len(absent)
    step = torch.tensor(DRAW_STEP, dtype=torch.int32, device=dev)
    sr = TrainConfig(**{**LM_FULL, **APPROX, "wire_dtype": "int8",
                        "shadow_round": "stochastic"})
    quantize_cost("approx int8 stochastic (8, d)",
                  lambda: numerics.narrow_wire_single(sr, prow, step))
    for mode in ("f32", "bf16", "int8"):
        wire = (None if mode == "f32" else
                (mode, numerics.narrow_wire_rows(prow, mode, BLOCK), BLOCK))
        rows_in = prow if wire is None else None

        def launch(rows_in=rows_in, wire=wire):
            return decode_kernels.approx_decode(rows_in, grads, vn, pres_f,
                                                wire)

        k, k2 = launch(), launch()
        p = decode_kernels.approx_decode_plain(rows_in, grads, vn, pres_f,
                                               wire)
        require(bool(torch.isfinite(k[0]).all()), f"approx_decode {mode} at "
                f"the LM's d: the absent NaN row reached the output")
        wide = prow if wire is None else numerics.widen_wire_rows(
            wire[1], mode, BLOCK)
        wide = torch.where(live, wide, torch.zeros_like(wide))
        scale = (vn.abs() @ wide.abs()).max().item()
        del wide
        row = held(f"approx_decode {mode}", k, k2, p, scale)
        del k, k2, p
        replay_bitwise(f"approx_decode [{mode}, d={d}]", launch)
        scales = pr * nb * 4 if mode == "int8" else 0
        row.update(ms=time_ms(launch, 20),
                   plain_ms=time_ms(lambda: decode_kernels.approx_decode_plain(
                       rows_in, grads, vn, pres_f, wire), 5))
        row["bound_ms"], row["bound_by"] = bound(
            pr * d * WIRE_BYTES[mode] + scales + N * d * 4 + d * 4 + 2 * N * 4,
            2 * pr * d + (pr * d if scales else 0) + 4 * N * d + 3 * d)
        row["bytes_per_coordinate"] = (pr * WIRE_BYTES[mode] + N * 4 + 4)
        out["approx_decode"][mode] = row
        del wire
    del prow

    # the narrow recombination on the int8 pair of a real encode
    t = code.tensors(dev)
    enc_re, enc_im = coded.complex_matmul(t["w_masked_re"], t["w_masked_im"],
                                          grads)
    cyc = TrainConfig(**{**LM_FULL, "approach": "cyclic",
                         "redundancy": "shared", "wire_dtype": "int8"})
    quantize_cost("cyclic int8 pair (2, 8, d)",
                  lambda: numerics.narrow_wire_pair(cyc, enc_re, enc_im))
    quantize_cost("cyclic bf16 pair (2, 8, d)", lambda: numerics.narrow_wire_pair(
        dataclasses.replace(cyc, wire_dtype="bf16"), enc_re, enc_im))
    v_re, v_im = torch.randn((2, N), generator=g, device=dev)
    wire = ("int8", numerics.narrow_wire_rows(enc_re, "int8", BLOCK),
            numerics.narrow_wire_rows(enc_im, "int8", BLOCK), BLOCK)
    del enc_re, enc_im

    def recombine():
        return decode_kernels.cyclic_narrow_recombine(v_re, v_im, wire)

    k, k2 = recombine(), recombine()
    p = decode_kernels.cyclic_narrow_recombine_plain(v_re, v_im, wire)
    scale = (v_re.abs() @ numerics.widen_wire_rows(wire[1], "int8",
                                                   BLOCK).abs()
             + v_im.abs() @ numerics.widen_wire_rows(wire[2], "int8",
                                                     BLOCK).abs()
             ).max().item()
    row = held("cyclic_narrow_recombine int8", [k], [k2], [p], scale)
    del k, k2, p
    replay_bitwise(f"cyclic_narrow_recombine [int8, d={d}]", recombine)
    scales = 2 * N * nb * 4
    row.update(ms=time_ms(recombine, 20),
               plain_ms=time_ms(lambda: decode_kernels
                                .cyclic_narrow_recombine_plain(v_re, v_im,
                                                               wire), 5))
    row["bound_ms"], row["bound_by"] = bound(
        2 * N * d + scales + 2 * N * 4 + d * 4, 2 * 2 * N * d + 2 * N * d)
    row["bytes_per_coordinate"] = 2 * N + 4
    out["cyclic_narrow_recombine"]["int8"] = row
    del wire, grads

    # round_draw's int8 pair (lm_approx_int8_sr_flash draws one part)
    wseed = SEED + draws.WIRE_SALT
    for parts in (2, 1):
        k = draws.round_draw(step, wseed, d, "int8", parts)
        require(_same_bits(k, draws.round_draw_plain(step, wseed, d, "int8",
                                                     parts, dev)),
                f"round_draw int8 x{parts} at the LM's d: the kernel's "
                f"draws differ from the plain version's")
        del k
        replay_steps(f"round_draw int8 x{parts} at the LM's d",
                     lambda parts=parts: draws.round_draw(step, wseed, d,
                                                          "int8", parts),
                     step, DRAW_STEP, DRAW_STEP + 1)
        step.fill_(DRAW_STEP)
        r = {"max_abs_err": 0.0, "bitwise_repeat": True,
             "graph_replay_bitwise": True,
             "ms": graph_ms(lambda parts=parts: draws.round_draw(
                 step, wseed, d, "int8", parts), 10),
             "plain_ms": time_ms(lambda parts=parts: draws.round_draw_plain(
                 step, wseed, d, "int8", parts, dev), 1, warmup=1)}
        r["bound_ms"], r["bound_by"] = bound(parts * 4 * d + 4,
                                             draws.draw_ops(parts * d),
                                             INT32_OPS)
        out["round_draw"][f"int8 x{parts}"] = r
    torch.cuda.empty_cache()
    for name, rows in out.items():
        for wire_name, r in rows.items():
            print(f"kernel {name} [{wire_name}] at the LM's d={d}: "
                  + ", ".join(f"{k}={v:.4g}" if isinstance(v, float)
                              else f"{k}={v}" for k, v in r.items()),
                  flush=True)
    return out


def moe_width_kernels(code, dev) -> dict:
    """Rows 1–4 at the MoE legs' d = 176,321,280, n=8 (their first run at
    that d): the three coded products on random inputs (``product_rows``:
    each against its plain version, twice bit for bit, timed beside its
    plain version, torch.matmul and its bound), and the locator on the
    projected column of a real encode at that d with row 3 reversed, its
    discrete outputs equal the plain version's and the adversary located,
    timed on one column (the work does not grow with d) from a graph
    beside its plain version. name -> row."""
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    out = {}
    for name, m in product_rows(code, dev, MOE_D, g, reps=5).items():
        b_ms, b_by = bound(m["nbytes"], m["flops"])
        require(m["err"] <= m["tol"], f"{name} at the MoE's d: max_abs_err "
                f"{m['err']} > tol {m['tol']}")
        out[name] = {"d": MOE_D, "max_abs_err": m["err"], "tol": m["tol"],
                     "ms": m["ms"], "plain_ms": m["plain_ms"],
                     "library_ms": m["library_ms"], "bound_ms": b_ms,
                     "bound_by": b_by, "bitwise_repeat": True}
    torch.cuda.empty_cache()
    worst = locator_cases(code, dev, g, [
        ("L=1 at the MoE's d, attacked row 3", 1, (3,), (), 0.0, None)],
        width=MOE_D)
    torch.cuda.empty_cache()
    # the global decode's one column: the same work at any d
    t8 = locator_timing(code, dev, g)
    out["cyclic_locator"] = {
        "d": MOE_D, "max_abs_err": worst, "tol": "discrete equal; v 1e-4 rel",
        "library_ms": None, **{k: t8[k] for k in ("ms", "plain_ms",
                                                  "bound_ms", "bound_by")}}
    for name, r in out.items():
        print(f"kernel {name} at the MoE's d={MOE_D}: "
              + ", ".join(f"{k}={v:.4g}" if isinstance(v, float)
                          else f"{k}={v}" for k, v in r.items()), flush=True)
    return out


# --------------------------------------------------------------------------
# phase 2b: the segment kernels (the segmented wire, the layer decode)
# --------------------------------------------------------------------------

def leg_bounds() -> dict:
    """The decode cuts of the four segmented legs at full width, from their
    registry configurations and the models' leaf offsets (meta tensors: no
    weights): ResNet-18's 62 leaves, the int8 wire's and the approx code's
    4 segments, the LM's 66 leaves refined by 4 segments into 69."""
    with torch.device("meta"):
        offsets = {"cnn": params_mod.layout(build_model(
            "ResNet18", registry.CNN_FULL["dataset"])).offsets,
            "lm": params_mod.layout(TransformerLM(
                vocab=LM_FULL["vocab"], dim=LM_FULL["model_dim"],
                heads=LM_FULL["model_heads"],
                layers=LM_FULL["model_layers"])).offsets}
    out = {}
    for leg in registry.TWINS:
        lp = registry.get(leg)
        cfg, off = lp.config(True), offsets[lp.route]
        dim = int(off[-1])
        out[leg] = (numerics.cfg_segment_bounds(cfg, dim)
                    if cfg.approach == "approx"
                    else tuple(decode_bounds(cfg, dim, off)))
    require(len(out["shared_layer"]) - 1 == 62
            and len(out["shared_int8_seg4"]) - 1 == 4
            and len(out["approx_int8_seg4"]) - 1 == 4
            and len(out["lm_shared_flash_layer"]) - 1 == 69,
            f"segmented legs' cuts: {[len(b) - 1 for b in out.values()]} "
            f"segments, expected 62, 4, 4, 69")
    return out


# d = 5003 with segments of 1 and 9 columns, one tile and a column more,
# cuts off every 16-byte chunk and every int8 block
SMALL_CUTS = (0, 1, 10, 2059, 2060, 4100, 5003)
# three cuts inside one 16-column strip and two inside the next but one:
# the strip reads over a plan send those strips to their scalar loop
STRIP_CUTS = (0, 5, 9, 12, 40, 41, 47, 5003)


def segment_kernels(code, dev, cuts) -> list:
    """The three segment kernels and the approx decode's offset entry
    against their plain versions (the per-segment torch products), at the
    segmented legs' cuts and d (ResNet-18 at 62 leaves and at 4 int8
    segments; the LM at 69 segments of d = 62,958,336) and at d = 5003 with
    tiny and unaligned segments; each launched twice bit for bit. The
    bitwise checks: the recombination against ``complex_recombine`` on
    each segment's contiguous copy; the narrow recombination against
    ``cyclic_narrow_recombine`` on each block-aligned slice of the wire
    (every bf16 cut; the int8 wire's 4 segments); the offset entry's
    decoded slice against ``approx_decode`` on the contiguous slice. The
    projection groups its partial sums otherwise than ``complex_project``:
    at S = 1 the two agree to 1e-5 of Σ|r|·|f| and the locator's discrete
    outputs from either are equal. Tolerances as the unsegmented kernels':
    1e-5 of each output's Σ|terms| (the squared norms 1e-5 relative).
    Timed at the legs' shapes beside the unsegmented kernel at the same d
    (the same bytes: its yardstick; no PyTorch call computes a segmented
    product), and the locator at L = 62 and 69 from a graph."""
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    t = code.tensors(dev)
    out = []

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def same_bits(a, b) -> bool:
        return torch.equal(_bits(a), _bits(b))

    def row(name, replaces, source, **kw):
        b_ms, b_by = bound(*kw.pop("work"))
        r = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "ok": True, "bound_ms": b_ms,
             "bound_by": b_by, "library_ms": None, **kw}
        r["share_of_bound"] = b_ms / r["ms"]
        print(f"kernel {name}: max_abs_err={r['max_abs_err']:.3e} (tol "
              f"{r['tol']:.3e}) ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f}"
              f" bound_ms={b_ms:.4f} ({b_by}, {100 * r['share_of_bound']:.1f}"
              f"% of bound) library_ms=null; the unsegmented kernel at the "
              f"same d {r['unsegmented_ms']:.4f} ms; {r['checks']}",
              flush=True)
        out.append(r)
        return r

    # the projection and the recombination, f32 rows of a real encode with
    # a reversed row
    def encoded(d):
        grads = randn(N, d)
        er, ei = coded.complex_matmul(t["w_masked_re"], t["w_masked_im"],
                                      grads)
        mask = torch.zeros(N, dtype=torch.bool, device=dev)
        mask[3] = True
        return attacks.inject_cyclic(er, ei, mask, "rev_grad")

    proj = {"max_abs_err": 0.0, "tol": 0.0, "checks": [], "lm": {}}
    rec = {"max_abs_err": 0.0, "tol": 0.0, "checks": [], "lm": {}}
    for label, bnds in (("resnet L=62", cuts["shared_layer"]),
                        ("lm L=69", cuts["lm_shared_flash_layer"]),
                        ("d=5003 tiny", SMALL_CUTS),
                        ("resnet S=1", (0, D))):
        d = bnds[-1]
        r_re, r_im = encoded(d)
        f = drng.projection_factors(SEED, d, dev)
        plan = coded.segment_plan(bnds, dev)
        S = plan.segments
        k = coded.complex_project_segments(r_re, r_im, f, plan)
        k2 = coded.complex_project_segments(r_re, r_im, f, plan)
        require(same_bits(k[0], k2[0]) and same_bits(k[1], k2[1]),
                f"complex_project_segments {label}: two launches differ")
        p = coded.complex_project_segments_plain(r_re, r_im, f, plan)
        scale = max(coded.complex_project_segments_plain(
            r_re.abs(), r_im.abs(), f.abs(), plan)[i].max().item()
            for i in (0, 1))
        err = max((k[i] - p[i]).abs().max().item() for i in (0, 1))
        require(err <= 1e-5 * scale, f"complex_project_segments {label}: "
                f"max_abs_err {err} > {1e-5 * scale}")
        proj["max_abs_err"] = max(proj["max_abs_err"], err)
        proj["tol"] = max(proj["tol"], 1e-5 * scale)
        proj["checks"].append(f"{label}: {S} segments, two launches bit "
                              f"for bit")
        if S == 1:
            # the unsegmented projection groups its sums otherwise: the
            # locator's discrete outputs from either must be equal
            u = coded.complex_project(r_re, r_im, f)
            uerr = max((k[i][0] - u[i]).abs().max().item() for i in (0, 1))
            require(uerr <= 1e-5 * scale, f"complex_project_segments S=1 "
                    f"against complex_project: {uerr} > {1e-5 * scale}")
            pres = torch.ones((1, N), device=dev)
            a = decode_kernels.cyclic_locator(code, k[0], k[1], pres,
                                              cyclic.HEALTH_REL_TOL)
            b = decode_kernels.cyclic_locator(code, u[0][None], u[1][None],
                                              pres, cyclic.HEALTH_REL_TOL)
            require(all(torch.equal(x, y) for x, y in zip(a[2:5], b[2:5]))
                    and not bool(a[2][0, 3]),
                    "complex_project_segments S=1: the locator's discrete "
                    "outputs differ from the unsegmented projection's")
            proj["checks"].append(f"S=1 against complex_project {uerr:.3e}"
                                  f", locator discrete outputs equal")
            proj["s1_err_vs_unsegmented"] = uerr
        # the recombination, each segment its own v pair
        v_re, v_im = randn(S, N), randn(S, N)
        kr = coded.complex_recombine_segments(v_re, v_im, r_re, r_im, plan)
        kr2 = coded.complex_recombine_segments(v_re, v_im, r_re, r_im, plan)
        require(same_bits(kr, kr2), f"complex_recombine_segments {label}: "
                f"two launches differ")
        pr = coded.complex_recombine_segments_plain(v_re, v_im, r_re, r_im,
                                                    plan)
        rscale = coded.complex_recombine_segments_plain(
            v_re.abs(), v_im.abs(), r_re.abs(), r_im.abs(), plan).abs().max()
        rscale = rscale.item()
        rerr = (kr - pr).abs().max().item()
        require(rerr <= 1e-5 * rscale, f"complex_recombine_segments {label}"
                f": max_abs_err {rerr} > {1e-5 * rscale}")
        same = all(same_bits(kr[a:b], coded.complex_recombine(
            v_re[j], v_im[j], r_re[:, a:b].contiguous(),
            r_im[:, a:b].contiguous()))
            for j, (a, b) in enumerate(zip(bnds[:-1], bnds[1:])))
        require(same, f"complex_recombine_segments {label}: differs from "
                f"complex_recombine on a segment's contiguous copy")
        rec["max_abs_err"] = max(rec["max_abs_err"], rerr)
        rec["tol"] = max(rec["tol"], 1e-5 * rscale)
        rec["checks"].append(f"{label}: {S} segments bit for bit "
                             f"complex_recombine on each contiguous copy, "
                             f"two launches bit for bit")
        if label in ("resnet L=62", "lm L=69"):
            nb = 4 * (2 * N * d + d + 2 * S * N)
            times = {
                "ms": time_ms(lambda: coded.complex_project_segments(
                    r_re, r_im, f, plan), 20),
                "plain_ms": time_ms(
                    lambda: coded.complex_project_segments_plain(
                        r_re, r_im, f, plan), 5),
                "unsegmented_ms": time_ms(lambda: coded.complex_project(
                    r_re, r_im, f), 20),
                "work": (nb, 2 * 2 * N * d), "segments": S, "d": d}
            rtimes = {
                "ms": time_ms(lambda: coded.complex_recombine_segments(
                    v_re, v_im, r_re, r_im, plan), 20),
                "plain_ms": time_ms(
                    lambda: coded.complex_recombine_segments_plain(
                        v_re, v_im, r_re, r_im, plan), 5),
                "unsegmented_ms": time_ms(lambda: coded.complex_recombine(
                    v_re[0], v_im[0], r_re, r_im), 20),
                "work": (4 * (2 * N * d + 2 * S * N + d), 2 * 2 * N * d),
                "segments": S, "d": d}
            if label == "resnet L=62":
                proj.update(times)
                rec.update(rtimes)
            else:
                for x, tm in ((proj, times), (rec, rtimes)):
                    bm, by = bound(*tm.pop("work"))
                    x["lm"] = {**tm, "bound_ms": bm, "bound_by": by}
                    print(f"kernel segments at the LM's d: {tm}, bound "
                          f"{bm:.4f} ms", flush=True)
        del r_re, r_im, f
    row("complex_project_segments", "draco_tpu/ops/coded.py:152",
        "draco_tpu_torch/csrc/coded.cu", **proj)
    row("complex_recombine_segments", "draco_tpu/ops/coded.py:201",
        "draco_tpu_torch/csrc/coded.cu", **rec)

    # the narrow recombination over a plan, bf16 and int8 wires
    nar = {"max_abs_err": 0.0, "tol": 0.0, "checks": [], "wires": {}}
    cases = [("int8 4 segments", D, cuts["shared_int8_seg4"], "int8", BLOCK),
             ("bf16 4 segments", D, cuts["shared_int8_seg4"], "bf16", BLOCK),
             ("int8 L=62 (cuts inside blocks)", D, cuts["shared_layer"],
              "int8", BLOCK)]
    cases += [(f"{m}@{b} d=5003 tiny", 5003, SMALL_CUTS, m, b)
              for m, b in (("bf16", BLOCK), ("int8", BLOCK), ("int8", 24),
                           ("int8", 1))]
    cases += [(f"{m}@{b} d=5003 cuts in one strip", 5003, STRIP_CUTS, m, b)
              for m, b in (("int8", BLOCK), ("bf16", BLOCK), ("int8", 24))]
    for label, d, bnds, mode, block in cases:
        r_re, r_im = encoded(d)
        wire = (mode, numerics.narrow_wire_rows(r_re, mode, block),
                numerics.narrow_wire_rows(r_im, mode, block), block)
        del r_re, r_im
        plan = coded.segment_plan(bnds, dev)
        S = plan.segments
        v_re, v_im = randn(S, N), randn(S, N)
        k = decode_kernels.cyclic_narrow_recombine_segments(v_re, v_im, wire,
                                                            plan)
        k2 = decode_kernels.cyclic_narrow_recombine_segments(v_re, v_im,
                                                             wire, plan)
        require(same_bits(k, k2), f"cyclic_narrow_recombine_segments "
                f"{label}: two launches differ")
        p = decode_kernels.cyclic_narrow_recombine_segments_plain(
            v_re, v_im, wire, plan)
        sc = decode_kernels.cyclic_narrow_recombine_segments_plain(
            v_re.abs(), v_im.abs(),
            (mode, {**wire[1], "q": wire[1]["q"].abs()},
             {**wire[2], "q": wire[2]["q"].abs()}, block), plan)
        scale = sc.abs().max().item()
        err = (k - p).abs().max().item()
        require(err <= 1e-5 * scale, f"cyclic_narrow_recombine_segments "
                f"{label}: max_abs_err {err} > {1e-5 * scale}")
        nar["max_abs_err"] = max(nar["max_abs_err"], err)
        nar["tol"] = max(nar["tol"], 1e-5 * scale)
        aligned = mode == "bf16" or all(c % block == 0 for c in bnds[:-1])
        note = f"{label}: two launches bit for bit"
        if aligned:
            for j, (a, b) in enumerate(zip(bnds[:-1], bnds[1:])):
                sl = decode_kernels.wire_slice_pair(wire, a, b)
                sl = (mode, *({k_: v.contiguous() for k_, v in x.items()}
                              for x in sl[1:3]), block)
                ref = decode_kernels.cyclic_narrow_recombine(v_re[j],
                                                             v_im[j], sl)
                require(same_bits(k[a:b], ref),
                        f"cyclic_narrow_recombine_segments {label}: segment"
                        f" {j} differs from cyclic_narrow_recombine on its "
                        f"block-aligned slice")
            note += (", bit for bit cyclic_narrow_recombine on each "
                     "block-aligned slice")
        nar["checks"].append(note)
        if d == D and S == 4:
            scales = 2 * N * -(-D // BLOCK) * 4 if mode == "int8" else 0
            nar["wires"][mode] = {
                "ms": time_ms(
                    lambda: decode_kernels.cyclic_narrow_recombine_segments(
                        v_re, v_im, wire, plan), 20),
                "plain_ms": time_ms(
                    lambda: decode_kernels
                    .cyclic_narrow_recombine_segments_plain(v_re, v_im, wire,
                                                            plan), 5),
                "unsegmented_ms": time_ms(
                    lambda: decode_kernels.cyclic_narrow_recombine(
                        v_re[0], v_im[0], wire), 20),
                "work": (2 * N * D * WIRE_BYTES[mode] + scales
                         + 2 * S * N * 4 + D * 4,
                         2 * 2 * N * D + (2 * N * D if scales else 0))}
            bm, by = bound(*nar["wires"][mode]["work"])
            nar["wires"][mode].update(bound_ms=bm, bound_by=by)
        del wire
    main = nar["wires"].pop("int8")
    row("cyclic_narrow_recombine_segments",
        "draco_tpu/ops/decode_kernels.py:378",
        "draco_tpu_torch/csrc/narrow_decode.cu", wire="int8", **main,
        **nar)

    # the approx decode's offset entry: rows 2 and 5 absent (row 2 NaN)
    acode = approx.build_approx_code(N, 1.5)
    present = torch.ones(N, dtype=torch.bool)
    present[[2, 5]] = False
    vn = (approx.decode_weights(acode, present)[0] / N).to(dev)
    pres_f = present.float().to(dev)
    apx = {"max_abs_err": 0.0, "tol": 0.0, "norms_rel_err": 0.0,
           "checks": [], "wires": {}}
    cases = [(f"{m} 4 segments", D, cuts["approx_int8_seg4"], m, b)
             for m, b in (("int8", BLOCK), ("f32", 1), ("bf16", BLOCK))]
    cases += [(f"{m}@{b} d=5003 tiny", 5003, SMALL_CUTS, m, b)
              for m, b in (("f32", 1), ("bf16", BLOCK), ("int8", BLOCK),
                           ("int8", 24))]
    for label, d, bnds, mode, block in cases:
        grads = randn(N, d)
        prow = approx.encode_shared(acode, grads)
        prow[[2, 5]] = 0.0
        prow[2] = float("nan")
        wire = None if mode == "f32" else (
            mode, numerics.narrow_wire_rows(prow, mode, block), block)
        rows_in = prow if wire is None else None

        def run(rows_in=rows_in, grads=grads, wire=wire, bnds=bnds):
            o = torch.empty((bnds[-1],), device=dev)
            sums = [decode_kernels.approx_decode_segment(
                rows_in, grads, vn, pres_f, a, b, wire, o)[1:]
                for a, b in zip(bnds[:-1], bnds[1:])]
            return o, torch.stack([torch.stack(s) for s in sums])

        k, ks = run()
        k2, ks2 = run()
        require(same_bits(k, k2) and same_bits(ks, ks2), f"approx_decode_"
                f"segment {label}: two launches differ (decoded or sums)")
        require(bool(torch.isfinite(k).all()), f"approx_decode_segment "
                f"{label}: the absent NaN row reached the output")
        whole = decode_kernels.approx_decode(rows_in, grads, vn, pres_f,
                                             wire)
        wide = prow if wire is None else numerics.widen_wire_rows(
            wire[1], mode, block)
        wide = torch.where(pres_f[:, None] > 0, wide, torch.zeros_like(wide))
        scale = (vn.abs() @ wide.abs()).max().item()
        p = torch.cat([decode_kernels.approx_decode_plain(
            wide[:, a:b], grads[:, a:b], vn, pres_f)[0]
            for a, b in zip(bnds[:-1], bnds[1:])])
        err = (k - p).abs().max().item()
        folded = ks.sum(0)
        rel = max(abs(folded[i].item() - whole[1 + i].item())
                  / abs(whole[1 + i].item()) for i in (0, 1))
        require(err <= 1e-5 * scale and rel <= 1e-5, f"approx_decode_segment"
                f" {label}: max_abs_err {err} (tol {1e-5 * scale}), folded "
                f"squared norms against the whole decode's rel {rel}")
        apx["max_abs_err"] = max(apx["max_abs_err"], err)
        apx["tol"] = max(apx["tol"], 1e-5 * scale)
        apx["norms_rel_err"] = max(apx["norms_rel_err"], rel)
        note = f"{label}: two launches bit for bit"
        if mode != "int8" or all(c % block == 0 for c in bnds[:-1]):
            for a, b in zip(bnds[:-1], bnds[1:]):
                sl = (None if wire is None else
                      decode_kernels.wire_slice_single(wire, a, b))
                if sl is not None:
                    sl = (mode, {k_: v.contiguous()
                                 for k_, v in sl[1].items()}, block)
                ref = decode_kernels.approx_decode(
                    None if sl is not None else prow[:, a:b].contiguous(),
                    grads[:, a:b].contiguous(), vn, pres_f, sl)
                require(same_bits(k[a:b], ref[0]), f"approx_decode_segment "
                        f"{label}: [{a}, {b}) differs from approx_decode on "
                        f"the contiguous slice")
            note += ", decoded bit for bit approx_decode on each slice"
        apx["checks"].append(note)
        if d == D:
            # four wrapper calls outrun the card's 4 × 2 launches: the
            # device time from a graph, the wrappers' back to back beside
            pr = N - 2
            scales = pr * -(-D // BLOCK) * 4 if mode == "int8" else 0
            apx["wires"][mode] = {
                "ms": graph_ms(run, 10),
                "launch_ms": time_ms(run, 20),
                "plain_ms": time_ms(lambda: [decode_kernels.approx_decode_plain(
                    wide[:, a:b], grads[:, a:b], vn, pres_f)
                    for a, b in zip(bnds[:-1], bnds[1:])], 5),
                "unsegmented_ms": graph_ms(
                    lambda: decode_kernels.approx_decode(
                        rows_in, grads, vn, pres_f, wire), 10),
                "work": (pr * D * WIRE_BYTES[mode] + scales + N * D * 4
                         + D * 4 + 2 * N * 4,
                         2 * pr * D + (pr * D if scales else 0) + 4 * N * D
                         + 3 * D)}
            bm, by = bound(*apx["wires"][mode]["work"])
            apx["wires"][mode].update(bound_ms=bm, bound_by=by)
        del grads, prow, wire, wide
    main = apx["wires"].pop("int8")
    row("approx_decode_segment", "draco_tpu/ops/decode_kernels.py:271",
        "draco_tpu_torch/csrc/narrow_decode.cu", wire="int8", **main, **apx)
    return out


def _flash_pairs(q, k, v, do, dl, causal=True) -> list:
    """(name, kernel output, plain output) of the three flash kernels on one
    input, the backward with the lse cotangent ``dl`` and without."""
    o, lse = fa.flash_fwd(q, k, v, causal)
    po, plse = fa.flash_fwd_plain(q, k, v, causal)
    dcap = (do * o).sum(-1)
    pairs = [("flash_fwd", o, po), ("flash_fwd", lse, plse)]
    for dlse in (None, dl):
        args = (q, k, v, do, lse, dcap, dlse, causal)
        pairs.append(("flash_dq", fa.flash_dq(*args),
                      fa.flash_dq_plain(*args)))
        for a, b in zip(fa.flash_dkv(*args), fa.flash_dkv_plain(*args)):
            pairs.append(("flash_dkv", a, b))
    torch.cuda.synchronize()
    return pairs


def _backward_outputs(q, k, v, do, lse, dcap) -> list:
    return [fa.flash_dq(q, k, v, do, lse, dcap),
            *fa.flash_dkv(q, k, v, do, lse, dcap)]


def flash_determinism(q, k, v, do) -> dict:
    """The forward's (o, lse) and the backward's outputs bit for bit: two
    launches on the same inputs, and a G axis that holds each of its first
    G/2 heads twice (the redundant lanes that vmap folds into G must agree
    exactly)."""
    o, lse = fa.flash_fwd(q, k, v)
    dcap = (do * o).sum(-1)
    h = q.shape[0] // 2
    fwd_again = fa.flash_fwd(q, k, v)
    fwd_dup = fa.flash_fwd(*(torch.cat([x[:h], x[:h]]) for x in (q, k, v)))
    first = _backward_outputs(q, k, v, do, lse, dcap)
    again = _backward_outputs(q, k, v, do, lse, dcap)
    twice = [torch.cat([x[:h], x[:h]]) for x in (q, k, v, do, lse, dcap)]
    dup = _backward_outputs(*twice)
    torch.cuda.synchronize()
    out = {"forward_repeat_equal": all(
               torch.equal(a, b) for a, b in zip((o, lse), fwd_again)),
           "forward_positions_equal": all(
               torch.equal(x[:h], x[h:]) for x in fwd_dup),
           "repeat_equal": all(torch.equal(a, b)
                               for a, b in zip(first, again)),
           "positions_equal": all(torch.equal(x[:h], x[h:]) for x in dup)}
    require(out["forward_repeat_equal"], "flash forward: two launches on "
            "the same inputs differ")
    require(out["forward_positions_equal"], "flash forward: one head at two "
            "places of G gives different rows")
    require(out["repeat_equal"], "flash backward: two launches on the same "
            "inputs differ")
    require(out["positions_equal"], "flash backward: one head at two places "
            "of G gives different rows")
    return out


def tensor_core_instructions() -> dict:
    """The TF32 tensor-core instructions (HMMA.*.TF32) of each function of
    the built flash library (forward, dq, dk/dv at the four head widths),
    from ``cuobjdump -sass``, every one of which must have some; and the
    instructions a HMMA in the span from a function's first HMMA to its
    last (the unrolled tile body, whose other instructions split operands,
    sum partials and take the softmax)."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([exe, "-sass",
                           str(_build.lib_path("flash_attention"))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    body, example, fn = {}, "", None
    for line in sass.splitlines():
        m = re.search(
            r"Function : \S*?(flash_(?:fwd|dq|dkv)_kernel)ILi(\d+)E", line)
        if "Function :" in line:
            fn = f"{m.group(1)}<{m.group(2)}>" if m else None
            if fn:
                body[fn] = []
        elif fn and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            op = line.split("*/", 1)[1].strip()
            body[fn].append("HMMA" in op and "TF32" in op)
            if body[fn][-1] and not example:
                example = op.split(";")[0].strip() + " ;"
    counts, per_hmma = {}, {}
    for f, is_mma in body.items():
        counts[f] = sum(is_mma)
        if counts[f]:
            first = is_mma.index(True)
            last = len(is_mma) - 1 - is_mma[::-1].index(True)
            per_hmma[f] = (last - first + 1) / counts[f]
    require(len(counts) == 12 and all(counts.values()),
            f"flash: functions without TF32 HMMA: {counts}")
    return {"hmma_tf32": counts, "span_instructions_per_hmma": per_hmma,
            "example": example}


SDPA_MARK = "chip_smoke sdpa: "


def sdpa_kernels_child() -> dict:
    """:func:`sdpa_kernels` in a process of its own, which has run no
    profiler before: after ``--profile``'s profiled steps, a session in
    this process saw no kernel of SDPA's forward at all (the backward's,
    which autograd runs on another thread, it saw)."""
    proc = subprocess.run([sys.executable, __file__, "--sdpa-kernels"],
                          capture_output=True, text=True, timeout=600)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith(SDPA_MARK)]
    require(proc.returncode == 0 and bool(lines),
            f"the SDPA profiling process failed ({proc.returncode}): "
            f"{proc.stderr[-2000:]}")
    print(proc.stdout.replace(lines[-1], "").strip(), flush=True)
    return json.loads(lines[-1][len(SDPA_MARK):])


def sdpa_kernels(dev, reps: int = 3) -> dict:
    """The CUDA kernels PyTorch runs for scaled_dot_product_attention's
    forward and for its backward at the LM path's shape (f32, causal), by
    name, launches and mean device ms a launch, each from one profiled
    session of ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    q, k, v, do = (torch.randn((1, G_LM, 512, 64), generator=g, device=dev)
                   for _ in range(4))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    torch.autograd.grad(out, (q, k, v), do, retain_graph=True)  # warm-up
    calls = {"forward": lambda: F.scaled_dot_product_attention(
                 q, k, v, is_causal=True),
             "backward": lambda: torch.autograd.grad(
                 out, (q, k, v), do, retain_graph=True)}
    found = {}
    for which, call in calls.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        rows = [{"kernel": e.key, "launches": e.count,
                 "device_ms": getattr(
                     e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
                 / max(e.count, 1) / 1e3}
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        rows.sort(key=lambda r: -r["device_ms"] * r["launches"])
        require(bool(rows), f"the profiler saw no kernel of SDPA's {which}")
        print(f"library SDPA {which} kernels ({reps} calls): " + "; ".join(
            f"{r['kernel'][:80]} {r['device_ms']:.4f} ms x{r['launches']}"
            for r in rows), flush=True)
        found[which] = rows
    return found


def flash_kernels(dev) -> list:
    """The flash forward, dq and dk/dv against their plain versions at the
    LM path's shape (G = lanes·B·H = 192 heads of T=512, Dh=64, f32) and at
    a ragged T=520, with and without an lse cotangent; at G=8, T=520 at
    every head width the kernels take (Dh 16, 32, 64, 128, and 17 and 100,
    which pad the head dim, 17 copying rows 4 bytes at a time), causal and,
    at Dh 64, not; the backward's outputs bit for bit across two launches
    and across places in G; its tensor-core instructions in the built
    library. Timed at T=512; each kernel's bound at the split-TF32 rate its
    instructions run at, beside the bound at the CUDA cores' float32
    rate."""
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    dh = 64
    rows = {}

    def hold(label, pairs):
        # float32 sums of up to T products in another order (the plain
        # versions' full-f32 einsums; the kernels' split-TF32 products
        # keep ~2^-21 of each): 1e-5 of each output's largest entry
        for name, a, b in pairs:
            err = (a - b).abs().max().item()
            tol = 1e-5 * b.abs().max().item()
            require(err <= tol, f"{name} {label}: max_abs_err {err} > {tol}")
            row = rows.setdefault(name, {"max_abs_err": 0.0, "tol": 0.0})
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row["tol"] = max(row["tol"], tol)

    for t in (512, 520):
        q, k, v, do = (torch.randn((G_LM, t, dh), generator=g, device=dev)
                       for _ in range(4))
        dl = torch.randn((G_LM, t), generator=g, device=dev)
        hold(f"T={t}", _flash_pairs(q, k, v, do, dl))
        print(f"kernel flash G={G_LM} T={t}: " + ", ".join(
            f"{n} err {r['max_abs_err']:.3e}" for n, r in rows.items()),
            flush=True)
    for width, causal in ((16, True), (17, True), (32, True), (64, True),
                          (64, False), (100, True), (128, True)):
        q, k, v, do = (torch.randn((8, 520, width), generator=g, device=dev)
                       for _ in range(4))
        dl = torch.randn((8, 520), generator=g, device=dev)
        pairs = _flash_pairs(q, k, v, do, dl, causal)
        hold(f"G=8 T=520 Dh={width} causal={causal}", pairs)
        ratio = [(a - b).abs().max().item() / (1e-5 * b.abs().max().item())
                 for _, a, b in pairs]
        print(f"kernel flash G=8 T=520 Dh={width} causal={causal}: worst "
              f"err/tol forward {max(ratio[:2]):.3f}, backward "
              f"{max(ratio[2:]):.3f}", flush=True)
    t = 512
    q, k, v, do = (torch.randn((G_LM, t, dh), generator=g, device=dev)
                   for _ in range(4))
    det = flash_determinism(q, k, v, do)
    sass = tensor_core_instructions()
    print(f"kernel flash: forward bit for bit across launches "
          f"{det['forward_repeat_equal']} and places in G "
          f"{det['forward_positions_equal']}, backward "
          f"{det['repeat_equal']} and {det['positions_equal']}; "
          f"TF32 HMMA in the built library {sass['hmma_tf32']} (e.g. "
          f"{sass['example']}); instructions a HMMA from the first to the "
          f"last " + ", ".join(
              f"{f} {r:.2f}" for f, r in
              sass["span_instructions_per_hmma"].items()), flush=True)

    o, lse = fa.flash_fwd(q, k, v)
    dcap = (do * o).sum(-1)
    args = (q, k, v, do, lse, dcap, None)
    q4, k4, v4 = (x[None] for x in (q, k, v))  # (1, G, T, Dh)
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True), 20)
    ql, kl, vl = (x.clone().requires_grad_() for x in (q4, k4, v4))
    out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        out, (ql, kl, vl), do[None], retain_graph=True), 20)
    times = {
        "flash_fwd": (time_ms(lambda: fa.flash_fwd(q, k, v), 20),
                      time_ms(lambda: fa.flash_fwd_plain(q, k, v), 10),
                      lib_fwd),
        "flash_dq": (time_ms(lambda: fa.flash_dq(*args), 20),
                     time_ms(lambda: fa.flash_dq_plain(*args), 10),
                     lib_bwd),
        "flash_dkv": (time_ms(lambda: fa.flash_dkv(*args), 20),
                      time_ms(lambda: fa.flash_dkv_plain(*args), 10),
                      lib_bwd),
    }
    del ql, kl, vl, out
    # causal (q, k) pairs; products of Dh-long rows per pair: 2 in the
    # forward (q·k, p·v), 3 in dq (q·k, do·v, ds·k), 4 in dk/dv (q·k, do·v,
    # p·do, ds·q); each 2·Dh flops. Bytes: each input read once, each
    # output written once.
    pairs = G_LM * t * (t + 1) / 2
    mat, stat = 4 * G_LM * t * dh, 4 * G_LM * t
    work = {"flash_fwd": (3 * mat + mat + stat, 2 * 2 * dh * pairs),
            "flash_dq": (4 * mat + 2 * stat + mat, 3 * 2 * dh * pairs),
            "flash_dkv": (4 * mat + 2 * stat + 2 * mat, 4 * 2 * dh * pairs)}
    lines = {"flash_fwd": "draco_tpu/ops/flash_attention.py:174",
             "flash_dq": "draco_tpu/ops/flash_attention.py:328",
             "flash_dkv": "draco_tpu/ops/flash_attention.py:353"}
    out = []
    for name in FLASH:
        ms, plain_ms, lib_ms = times[name]
        # the bound at both rates; bound_ms at the one the instructions
        # run at: split TF32 on the tensor cores
        f32 = bound(*work[name])
        b_ms, b_by = bound(*work[name], rate=TF32X3_FLOPS)
        extra = {"bound_rate": "split TF32, 165 TFLOP/s",
                 "bound_ms_f32_cores": f32[0],
                 "bound_ms_split_tf32": b_ms,
                 "tensor_core_instructions": {
                     f: c for f, c in sass["hmma_tf32"].items()
                     if f.startswith(name + "_kernel")},
                 "span_instructions_per_hmma": {
                     f: r for f, r in
                     sass["span_instructions_per_hmma"].items()
                     if f.startswith(name + "_kernel")},
                 "sass_example": sass["example"], **det}
        print(f"kernel {name}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by} at "
              f"{extra['bound_rate']}; {f32[0]:.4f} at float32, "
              f"{b_ms:.4f} at split TF32)", flush=True)
        out.append({"name": name, "route": "cuda",
                    "source": "draco_tpu_torch/csrc/flash_attention.cu",
                    "replaces": lines[name], "ok": True, **rows[name],
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": lib_ms,
                    "library_call": ("scaled_dot_product_attention"
                                     if name == "flash_fwd" else
                                     "its autograd backward (dq, dk, dv "
                                     "together)"), **extra})
    return out


# the flash kernels at this slice's shapes: lm_big's (G = lanes·B·H =
# 8·2·16, T=2048, causal, no lse cotangent on its path) and the four-shard
# ring's first hop (q's shards [1, 4) against k/v's [0, 3), non-causal: G =
# 3·8·2·12 at T = 512 / 4, with the merge's lse cotangent)
FLASH_SHAPES = (("lm_big G=256 T=2048 causal", 256, 2048, True, False),
                ("ring hop G=576 T=128 non-causal with dlse", 576, 128,
                 False, True))


def flash_shape_kernels(dev) -> dict:
    """The three flash kernels at FLASH_SHAPES against their plain
    versions (forward, and the backward with and without dlse, 1e-5 of
    each output's largest entry as in ``flash_kernels``), each timed beside
    its plain version, its split-TF32 bound and SDPA at the same shape:
    kernel name -> shape label -> row."""
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    dh = 64
    out = {name: {} for name in FLASH}
    for label, G, t, causal, with_dlse in FLASH_SHAPES:
        q, k, v, do = (torch.randn((G, t, dh), generator=g, device=dev)
                       for _ in range(4))
        dl = torch.randn((G, t), generator=g, device=dev)
        errs = {}
        for name, a, b in _flash_pairs(q, k, v, do, dl, causal):
            err = (a - b).abs().max().item()
            tol = 1e-5 * b.abs().max().item()
            require(err <= tol, f"{name} {label}: max_abs_err {err} > {tol}")
            e = errs.setdefault(name, [0.0, 0.0])
            e[0], e[1] = max(e[0], err), max(e[1], tol)
        torch.cuda.empty_cache()
        o, lse = fa.flash_fwd(q, k, v, causal)
        dcap = (do * o).sum(-1)
        args = (q, k, v, do, lse, dcap, dl if with_dlse else None, causal)
        q4, k4, v4 = (x[None] for x in (q, k, v))
        lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal), 10)
        ql, kl, vl = (x.clone().requires_grad_() for x in (q4, k4, v4))
        o_lib = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            o_lib, (ql, kl, vl), do[None], retain_graph=True), 10)
        del ql, kl, vl, o_lib
        times = {
            "flash_fwd": (time_ms(lambda: fa.flash_fwd(q, k, v, causal), 10),
                          time_ms(lambda: fa.flash_fwd_plain(q, k, v,
                                                             causal), 3),
                          lib_fwd),
            "flash_dq": (time_ms(lambda: fa.flash_dq(*args), 10),
                         time_ms(lambda: fa.flash_dq_plain(*args), 3),
                         lib_bwd),
            "flash_dkv": (time_ms(lambda: fa.flash_dkv(*args), 10),
                          time_ms(lambda: fa.flash_dkv_plain(*args), 3),
                          lib_bwd),
        }
        # as in flash_kernels: the (q, k) pairs the mask keeps, 2, 3 and
        # 4 products of Dh-long rows a pair; each input read once, each
        # output written once (dlse one more (G, T) read)
        pairs = G * t * (t + 1) / 2 if causal else G * t * t
        mat, stat = 4 * G * t * dh, 4 * G * t
        dls = stat if with_dlse else 0
        work = {"flash_fwd": (3 * mat + mat + stat, 2 * 2 * dh * pairs),
                "flash_dq": (4 * mat + 2 * stat + dls + mat,
                             3 * 2 * dh * pairs),
                "flash_dkv": (4 * mat + 2 * stat + dls + 2 * mat,
                              4 * 2 * dh * pairs)}
        for name in FLASH:
            ms, plain_ms, lib_ms = times[name]
            b_ms, b_by = bound(*work[name], rate=TF32X3_FLOPS)
            out[name][label] = {
                "G": G, "T": t, "Dh": dh, "causal": causal,
                "dlse": with_dlse, "max_abs_err": errs[name][0],
                "tol": errs[name][1], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                "library_call": ("scaled_dot_product_attention"
                                 if name == "flash_fwd" else
                                 "its autograd backward (dq, dk, dv "
                                 "together)")}
            print(f"kernel {name} {label}: ms={ms:.4f} plain_ms="
                  f"{plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms="
                  f"{b_ms:.4f} ({b_by} at split TF32); err "
                  f"{errs[name][0]:.3e} (tol {errs[name][1]:.3e})",
                  flush=True)
        del q, k, v, do, dl, o, lse, dcap, args, q4, k4, v4
        torch.cuda.empty_cache()
    return out


def control_kernels(dev) -> list:
    """The controls of csrc/controls.cu that launch, against their plain
    versions. The mis-tiled copy (the counterpart of the TPU lowering
    audit's ``bad``) at its shape (16, 48): NaN in the same 576 places and
    the copied (16, 12) region bit for bit; its bound counts the 192
    elements it must read and the 768 its output holds. The spill control
    at the kernel audit's n=1003 (small integers, so its 64-term sums are
    exact in f32): bit for bit; its bound counts x, idx and the output once
    and 64 multiply-adds an element. The over-launch control never
    launches (the kernel audit checks its CUDA error 9)."""
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    x = torch.randn(controls.SHAPE, generator=g, device=dev)
    k = controls.control_mistiled_copy(x)
    p = controls.control_mistiled_copy_plain(x)
    require(torch.equal(k.view(torch.int32), p.view(torch.int32)),
            "control_mistiled_copy: differs from its plain version")
    nan = int(k.isnan().sum())
    require(nan == 576, f"control_mistiled_copy: {nan} NaN, expected 576")
    err = (torch.nan_to_num(k) - torch.nan_to_num(p)).abs().max().item()
    rows, cols = controls.SHAPE
    b_ms, b_by = bound(4 * (controls.GRID * controls.TILE[0]
                            * controls.TILE[1] + rows * cols), 0)
    ms = time_ms(lambda: controls.control_mistiled_copy(x), 50)
    plain_ms = time_ms(lambda: controls.control_mistiled_copy_plain(x), 50)
    print(f"kernel control_mistiled_copy: bitwise equal to plain, {nan} NaN "
          f"left unwritten; ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={b_ms:.3e} ({b_by}) library_ms=null", flush=True)
    out = [{"name": "control_mistiled_copy", "route": "cuda",
            "source": "draco_tpu_torch/csrc/controls.cu",
            "replaces": "tools/tpu_attn_lowering_check.py:111",
            "maps_to": "tools/tpu_attn_lowering_check.py:111",
            "control": True, "ok": True, "max_abs_err": err,
            "tol": "bitwise, NaN positions included", "unwritten": nan,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}]

    n = 1003
    xs = torch.randint(-8, 8, (n,), generator=g, device=dev).to(torch.float32)
    idx = torch.randint(0, 1 << 20, (n,), generator=g,
                        device=dev).to(torch.int32)
    k = controls.control_spill(xs, idx)
    p = controls.control_spill_plain(xs, idx)
    require(torch.equal(k.view(torch.int32), p.view(torch.int32)),
            f"control_spill: differs from its plain version by "
            f"{(k - p).abs().max().item()}")
    live = controls.SPILL_LIVE
    b_ms, b_by = bound(3 * 4 * n, 2 * live * n)
    ms = time_ms(lambda: controls.control_spill(xs, idx), 50)
    plain_ms = time_ms(lambda: controls.control_spill_plain(xs, idx), 50)
    print(f"kernel control_spill: bitwise equal to plain at n={n}; "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.3e} "
          f"({b_by}) library_ms=null", flush=True)
    out.append({"name": "control_spill", "route": "cuda",
                "source": "draco_tpu_torch/csrc/controls.cu",
                "replaces": None, "maps_to": None, "control": True,
                "ok": True, "max_abs_err": (k - p).abs().max().item(),
                "tol": "bitwise", "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    return out


# --------------------------------------------------------------------------
# phase 5: the audit
# --------------------------------------------------------------------------

def audit_kernels() -> dict:
    """The kernel audit of every csrc/ kernel and its three controls
    (analysis/kernel_audit.py), report in draco_tpu_torch/_build/audit/."""
    report = kernel_audit.run_audit("cuda")
    for row in report["rows"]:
        r = row["rules"]
        funcs = r["resources"].get("functions", [])
        main = set(row.get("main_path_functions") or
                   (f["function"] for f in funcs))
        res = "; ".join(
            f"{f['function']} {f['registers']} regs, {f['local_bytes']} B "
            f"local, {f['static_smem']}+{f['dynamic_smem']} B smem, "
            f"{f['threads']} threads, {f['resident_blocks']} blocks/SM"
            for f in funcs if f["function"] in main)
        san = ", ".join(
            f"{t} " + (f"{v.get('errors')} errors" if v.get("ran") else
                       f"not run ({v.get('reason', '')})")
            for t, v in r["sanitizer"].items() if isinstance(v, dict)
            and t in ("memcheck", "racecheck"))
        cov = r["coverage"]
        print(f"audit kernel {row['name']}: "
              f"{'ok' if row['ok'] else 'FAIL'} failed "
              f"{row['failed_rules']}"
              + (f" (expected {row['expected_fail']})" if row["control"]
                 else "")
              + f"; {res}; coverage unwritten {cov.get('unwritten')} guard "
              f"{cov.get('guard_touched')}; sanitizer: {san}"
              + (f"; launch error {r['launch_limits']['error_code']}"
                 if "error_code" in r["launch_limits"] else ""), flush=True)
    require(report["all_ok"], "the kernel audit failed: " + "; ".join(
        f"{r['name']}: {r.get('error')}" for r in report["rows"]
        if not r["ok"]))
    return report


def lint_controls_card(dev) -> list:
    """The program lint's seeded-defect controls on the card (the
    collective's on a gloo group on the CPU): each trips exactly its
    rule."""
    rows = []
    try:
        for c in program_lint.controls_for(dev):
            row = program_lint.control_row(c, dev)
            rows.append({"name": c.name, **row})
            print(f"audit lint {c.name}: {'ok' if row['ok'] else 'FAIL'} "
                  f"tripped {row['failed_rules']} (expected "
                  f"{c.expected_fail})", flush=True)
            require(row["ok"], f"{c.name}: {row.get('error')}")
    finally:
        lint_controls.release()
    return rows


# --------------------------------------------------------------------------
# phase 3: the training legs
# --------------------------------------------------------------------------

# each CNN dataset loaded once a run and shared by the legs and the lint
# (a synthetic set takes seconds to make)
DATASETS = {}


def dataset_of(lp):
    """The full-width dataset a leg of the registry trains on (None for
    the LM, which makes its tokens), loaded on first use."""
    if lp.route != "cnn":
        return None
    name = lp.config(True).dataset
    if name not in DATASETS:
        DATASETS[name] = load_dataset(name)
    return DATASETS[name]


def run_leg(lp, steps: int, dev, profile: bool = False) -> dict:
    """One leg of the registry (analysis/registry.py) at full width, built
    through the entry points a user calls: a ResNet-18 leg through the CNN
    Trainer, an LM leg through build_sp_train_setup and the token loop, as
    ``python -m draco_tpu_torch.cli`` runs them; its eager steps, then its
    chunk (phase 6), then under ``profile`` one profiled step."""
    program = lp.build(dev, full=True,
                       max_steps=steps + 1 + LOOP_CHUNKS * CHUNK_K,
                       steps_per_call=CHUNK_K, dataset=dataset_of(lp))
    if lp.route != "cnn":
        dim, want = program.runner.setup.dim, LEG_D.get(lp.name, LM_D)
        require(dim == want, f"{lp.name}: d={dim}, expected {want}")
    out = drive(lp.name, program, steps, EXPECT[lp.name], dev)
    out["chunk"] = chunk_leg(lp, program, dev, profile)
    if profile:
        profile_leg(out, program.runner)
    if lp.route != "cnn":
        out["dim"] = program.runner.setup.dim
    return out


def drive(name, program, steps, expect, dev) -> dict:
    """One warm-up step, then ``steps`` steps with the launch counts zeroed
    just before them and read just after; every cyclic step must locate the
    adversary, every approx step hold residual ≤ bound + the wire's slack
    with its 2 stragglers absent. On a narrow cyclic wire the recombination
    must read the narrow buffers: complex_recombine is never launched."""
    runner, cfg = program.runner, program.cfg
    setup = runner.setup
    require(setup.decode_impl == "cuda",
            f"{name}: the locator resolved to {setup.decode_impl!r}")
    first = runner.step()  # warm-up: cuDNN/cuBLAS plans, kernel loads
    require(first["loss"] == first["loss"], f"{name}: warm-up loss is NaN")
    torch.cuda.reset_peak_memory_stats(dev)
    watch = (krum_watch() if cfg.approach == "baseline"
             and cfg.mode == "krum" else contextlib.nullcontext([]))
    mean_watch = (decode_watch(runner.state.opt) if name in MEAN_HELD
                  else contextlib.nullcontext([]))
    narrow_vote = cfg.approach == "maj_vote" and cfg.wire_dtype != "f32"
    rows_watch = (vote_rows_watch(cfg.group_size) if narrow_vote
                  else contextlib.nullcontext([]))
    ops.reset_launch_counts()
    with watch as picks, mean_watch as mean_errs, rows_watch as equal_rows:
        recs = [runner.step() for _ in range(steps)]
    counts = ops.launch_counts()
    require(len(equal_rows) == (steps if narrow_vote else 0),
            f"{name}: the vote watch saw {len(equal_rows)} of {steps} steps")
    for r, eq in zip(recs, equal_rows):
        # each group's honest members quantized bit for bit alike: one
        # rounding draw shared by the rows
        adv = runner.adv_schedule[r["step"]]
        eq = eq.cpu()
        for gi in range(eq.shape[0]):
            honest = [i for i in range(cfg.group_size)
                      if not adv[gi * cfg.group_size + i]]
            require(all(bool(eq[gi, a, b]) for a in honest for b in honest),
                    f"{name} step {r['step']}: group {gi}'s honest rows "
                    f"{honest} differ on the wire")
    mean_errs = [float(e) for e in mean_errs]
    require(len(mean_errs) == (steps if name in MEAN_HELD else 0),
            f"{name}: the decode watch saw {len(mean_errs)} of {steps} steps")
    for r, pick in zip(recs, picks):
        # Krum's aggregate is one of its rows bit for bit: an honest one
        honest = ~runner.adv_schedule[r["step"]]
        if runner.straggle_schedule is not None:
            honest &= ~runner.straggle_schedule[r["step"]]
        pick = pick.cpu().numpy()
        require(bool((pick & honest).any()) and not bool((pick & ~honest)
                                                         .any()),
                f"{name} step {r['step']}: the aggregate equals rows "
                f"{pick.nonzero()[0].tolist()}, honest rows "
                f"{honest.nonzero()[0].tolist()}")
    require(len(picks) == (steps if cfg.mode == "krum"
                           and cfg.approach == "baseline" else 0),
            f"{name}: krum ran {len(picks)} times in {steps} steps")
    for r in recs:
        require(math.isfinite(r["loss"]),
                f"{name} step {r['step']}: loss {r['loss']}")
        if cfg.approach != "baseline":
            require(masks_held(r, runner, cfg),
                    f"{name} step {r['step']}: forensics masks: {r}")
        if cfg.shadow_wire != "off":
            require(shadow_held(r, cfg),
                    f"{name} step {r['step']}: the shadow decode: {r}")
        if cfg.approach == "maj_vote":
            require(vote_held(r), f"{name} step {r['step']}: the vote did "
                    f"not out-vote exactly the adversary: {r}")
        if cfg.approach == "cyclic":
            require(located(name, r, cfg),
                    f"{name} step {r['step']}: adversaries not located: {r}")
        if cfg.approach == "approx":
            slack = numerics.wire_residual_slack(cfg.wire_dtype)
            require(r["present"] == cfg.num_workers - cfg.straggle_count
                    and 0.0 < r["recovered_fraction"] <= 1.0
                    and r["decode_residual"]
                    <= r["decode_residual_bound"] + slack + 1e-5,
                    f"{name} step {r['step']}: approx certificate: {r}")
    for k in expect:
        require(counts[k] > 0, f"{name}: kernel {k} was never launched "
                f"({counts})")
    # every coded step runs the ingest check; only a watched leg the
    # statistics
    coded_leg = cfg.approach != "baseline"
    require((counts["nonfinite_rows"] > 0) == coded_leg
            and (counts["stage_stats"] > 0) == (cfg.numerics_watch == "on"),
            f"{name}: observatory kernels {counts}")
    if cfg.approach == "cyclic" and cfg.wire_dtype != "f32":
        require(counts["complex_recombine"] == 0,
                f"{name}: complex_recombine ran on the narrow wire "
                f"({counts})")
    # a segmented leg runs the segment kernels only; one segment at global
    # granularity never enters the segmented code
    off = WHOLE if name in registry.TWINS else SEGMENTED
    # a leg draws on the device only for the options that draw
    off += tuple(k for k in DRAWS if k not in expect)
    # the plain streaming attention launches no flash kernel
    if cfg.network == "TransformerLM" and cfg.attn_impl == "dense":
        off += FLASH
    require(all(counts[k] == 0 for k in off),
            f"{name}: launched {[k for k in off if counts[k]]} ({counts})")
    if name in FALLING:
        require(recs[-1]["loss"] < first["loss"], f"{name}: the loss did "
                f"not fall: {first['loss']} at step 1, "
                f"{[r['loss'] for r in recs]} after")
    for i, err in enumerate(mean_errs):
        require(err <= MEAN_RTOL, f"{name} step {recs[i]['step']}: the "
                f"decoded aggregate is {err:.3e} (relative L2) off the mean "
                f"of the batch gradients (tol {MEAN_RTOL:g})")
    ms = [r["step_ms"] for r in recs]
    out = {"leg": name, "steps": steps, "ms_per_step": sum(ms) / len(ms),
           "records": recs,
           "ms_steps": ms, "loss": [r["loss"] for r in recs],
           "launches": counts,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    if mean_errs:
        out["decoded_vs_mean_rel_l2"] = mean_errs
        print(f"leg {name}: the decoded aggregate against the mean of the "
              f"batch gradients, relative L2 "
              f"{['%.2e' % e for e in mean_errs]} (tol {MEAN_RTOL:g})",
              flush=True)
    print(f"leg {name}: {out['ms_per_step']:.2f} ms/step over {steps} steps "
          f"(host clock, device synchronised); launches {counts}; "
          f"losses {['%.4f' % x for x in out['loss']]}", flush=True)
    return out


@contextlib.contextmanager
def vote_rows_watch(group: int):
    """Inside: each call of the vote appends, as a (groups, r, r) bool
    device tensor, which of each group's rows (the widened wire rows the
    vote reads) are bit for bit equal."""
    seen, vote_fn = [], repetition.majority_vote

    def watched(code, grads, *args, **kw):
        bits = grads.view(torch.int32).view(-1, group, grads.shape[1])
        seen.append(torch.stack([torch.stack([torch.stack([
            (bits[gi, a] == bits[gi, b]).all() for b in range(group)])
            for a in range(group)]) for gi in range(bits.shape[0])]))
        return vote_fn(code, grads, *args, **kw)

    repetition.majority_vote = watched
    try:
        yield seen
    finally:
        repetition.majority_vote = vote_fn


@contextlib.contextmanager
def krum_watch():
    """Inside: each call of ``aggregation.krum`` appends, as an (n,) bool
    device tensor, which of its input rows its result equals bit for
    bit."""
    from draco_tpu_torch import aggregation

    picks, krum = [], aggregation.krum

    def watched(grads, s, present=None):
        out = krum(grads, s, present)
        picks.append((grads.view(torch.int32)
                      == out.view(torch.int32)[None]).all(1))
        return out

    aggregation.krum = watched
    try:
        yield picks
    finally:
        aggregation.krum = krum


@contextlib.contextmanager
def decode_watch(opt):
    """Inside: each step's relative L2 gap (a 0-d device tensor) between
    the aggregate the optimizer ``opt`` is handed and the mean of the batch
    gradients the shared encode took."""
    means, errs, enc = [], [], cyclic.encode_shared
    step_flat = opt.step_flat

    def watched_encode(code, grads):
        means.append(grads.mean(0))
        return enc(code, grads)

    def watched_step(params, flat, layout, ok=None):
        mean = means.pop()
        errs.append(torch.linalg.vector_norm(flat - mean)
                    / torch.linalg.vector_norm(mean))
        return step_flat(params, flat, layout, ok)

    cyclic.encode_shared, opt.step_flat = watched_encode, watched_step
    try:
        yield errs
    finally:
        cyclic.encode_shared = enc
        del opt.step_flat


@contextlib.contextmanager
def copies_watch(code):
    """Inside: for each ``simulate`` step, the largest disagreement between
    the 2s+1 copies of one batch gradient that its workers computed, as
    (relative L2, relative max) 0-d device tensors: over every batch k and
    copy j, ‖g_kj − g_k0‖ / ‖g_k0‖ and max|g_kj − g_k0| / max|g_k0|."""
    n, hat_s = code.n, code.hat_s
    lanes = [[] for _ in range(n)]  # batch k -> its lanes i·hat_s + j
    for i in range(n):
        for j in range(hat_s):
            lanes[int(code.batch_ids[i, j])].append(i * hat_s + j)
    gaps, enc = [], cyclic.encode

    def watched(c, grads):
        idx = torch.as_tensor(lanes, device=grads.device)
        cp = grads.reshape(n * hat_s, -1)[idx]  # (n batches, hat_s, d)
        diff = cp[:, 1:] - cp[:, :1]
        l2 = (torch.linalg.vector_norm(diff, dim=2)
              / torch.linalg.vector_norm(cp[:, :1], dim=2)).max()
        mx = (diff.abs().amax(dim=(1, 2))
              / cp[:, 0].abs().amax(dim=1)).max()
        gaps.append((l2, mx))
        del cp, diff
        return enc(c, grads)

    cyclic.encode = watched
    try:
        yield gaps
    finally:
        cyclic.encode = enc


def bf16_simulate_check(dev, ds, steps: int = 4) -> dict:
    """ResNet-18 ``simulate`` (n=8, s=1, batch 32) at bfloat16 compute for
    a few steps after a warm-up, at cuDNN's default settings and under
    deterministic cuDNN: every step the largest relative disagreement
    between the copies of a batch gradient and the decode's detection
    columns, printed. The leg's own setting must locate the adversary
    every step (HEALTH_REL_TOL = 1e-3 unchanged)."""
    lp = registry.get("simulate")
    out = {}
    for setting in ("default", "deterministic"):
        cfg = lp.config(True, max_steps=steps + 1, compute_dtype="bfloat16")
        with (cudnn_deterministic() if setting == "deterministic"
              else contextlib.nullcontext()):
            runner = lp.runner(cfg, dev, True, ds)
            runner.step()  # warm-up
            with copies_watch(runner.setup.code) as gaps:
                t0 = time.perf_counter()
                recs = [runner.step() for _ in range(steps)]
                wall = (time.perf_counter() - t0) * 1e3 / steps
        rows = []
        for r, (l2, mx) in zip(recs, gaps):
            rows.append({"step": r["step"], "copies_rel_l2": float(l2),
                         "copies_rel_max": float(mx),
                         "honest_located": r["honest_located"],
                         "located_errors": r["located_errors"],
                         "located": located("simulate", r, cfg)})
            print(f"bf16 simulate [{setting} cuDNN] step {r['step']}: "
                  f"copies disagree by {rows[-1]['copies_rel_l2']:.3e} "
                  f"relative L2, {rows[-1]['copies_rel_max']:.3e} relative "
                  f"max; honest_located {r['honest_located']:g}, "
                  f"located_errors {r['located_errors']:g}", flush=True)
        out[setting] = {"steps": rows, "ms_per_step": wall,
                        "all_located": all(x["located"] for x in rows)}
        del runner
        gc.collect()
        torch.cuda.empty_cache()
    require(out["default"]["all_located"], f"bf16 simulate at cuDNN's "
            f"default settings (the leg's own): a step did not locate "
            f"exactly its adversary: {out['default']['steps']}")
    return out


def vote_held(r: dict) -> bool:
    """A majvote record out-votes exactly its one adversary (VOTE_HELD)."""
    return all(abs(r[k] - v) < 1e-6 for k, v in VOTE_HELD.items())


def vote_checks(dev, ds) -> dict:
    """The majvote leg without its adversary, 8 steps at full width: every
    honest lane of a group bit-identical (vote_agree 1.0, no group
    flagged). Then one step of the leg (with its adversary) from two fresh
    setups of one seed, ``vote_check="fingerprint"`` and ``"exact"``: the
    same step's rows voted both ways give the same record and the same
    parameters bit for bit."""
    lp = registry.get("majvote")
    clean = lp.build(dev, full=True, max_steps=9, dataset=ds, worker_fail=0)
    recs = [clean.runner.step() for _ in range(8)]
    for r in recs:
        require(r["vote_agree"] == 1.0 and r["flagged_groups"] == 0
                and r["det_flagged"] == 0,
                f"majvote without an adversary, step {r['step']}: honest "
                f"lanes differ: {r}")
    del clean
    runs = {}
    for check in ("fingerprint", "exact"):
        prog = lp.build(dev, full=True, max_steps=2, dataset=ds,
                        vote_check=check)
        rec = prog.runner.step()
        runs[check] = (rec, {k: v.detach().clone()
                             for k, v in prog.runner.state.params.items()})
        del prog
        gc.collect()
    (rf, pf), (re_, pe) = runs["fingerprint"], runs["exact"]
    same = all(_same_bits(pf[k], pe[k]) for k in pf)
    require(vote_held(rf) and all(rf[k] == re_[k] for k in VOTE_HELD)
            and same, f"majvote: the exact vote differs from the "
            f"fingerprint vote: {rf} / {re_}, parameters equal: {same}")
    print(f"check majvote: without an adversary vote_agree 1.0 and no group "
          f"flagged on all 8 steps (honest lanes bit-identical); the exact "
          f"vote equals the fingerprint vote on one step's rows (record and "
          f"{len(pf)} parameter tensors bit for bit)", flush=True)
    return {"clean_steps": len(recs),
            "clean_vote_agree": [r["vote_agree"] for r in recs],
            "exact_equals_fingerprint": same}


def profile_leg(out, runner) -> None:
    """One profiled eager step of the leg, printed."""
    name = out["leg"]
    out["profile"] = prof = profile_step(runner)
    print(f"leg {name} profile: wall {prof['wall_ms']:.2f} ms, device "
          f"busy {prof['device_busy_ms']:.2f} ms; top kernels "
          + "; ".join(f"{r['name'][:48]} {r['device_ms']:.2f} ms x"
                      f"{r['calls']}" for r in prof["top"][:8])
          + f"; {prof['host_ops']} host ops, top by self time "
          + "; ".join(f"{r['name'][:40]} {r['host_self_ms']:.1f} ms x"
                      f"{r['calls']}" for r in prof["host_top"][:6]),
          flush=True)
    ph = prof["phases"]
    print(f"leg {name} device time by phase (ms, busy "
          f"{ph['busy_ms']:.2f}): " + ", ".join(
              f"{k} {v:.2f}" for k, v in ph["phases_ms"].items()),
          flush=True)


# --------------------------------------------------------------------------
# phase 6: the chunk
# --------------------------------------------------------------------------

def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (NaN payloads and the sign of zero included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        as_int = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            a.element_size()]
        a, b = a.view(as_int), b.view(as_int)
    return torch.equal(a, b)


# a final state copied for the chunk phase's comparisons stays on the card
# up to this size, on the host past it (lm_big's 1.28 GB state, copied
# five times a leg, would fragment the card's memory before its capture)
STATE_ON_CARD = 1 << 30


def _state_copy(state) -> dict:
    tensors = state.tensors()
    on_card = sum(v.numel() * v.element_size()
                  for v in tensors.values()) <= STATE_ON_CARD
    return {k: v.detach().clone() if on_card else v.detach().cpu()
            for k, v in tensors.items()}


def _update_err(before: dict, a: dict, b: dict) -> float:
    """‖Δa − Δb‖ / ‖Δb‖ over the parameters, Δ = final − ``before``."""
    num = den = 0.0
    for k, v in before.items():
        if k.startswith("params/"):
            v = v.to(a[k].device)
            da, db = a[k].double() - v.double(), b[k].double() - v.double()
            num += float(((da - db) ** 2).sum())
            den += float((db ** 2).sum())
    return math.sqrt(num / den)


def _timed(fn) -> tuple:
    """(fn's result, its device ms by CUDA events around it)."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


class _ChunkRuns:
    """K steps of a program from one snapshot of its state, eagerly, as a
    chunk through the loop's engine client, or through the loop a user
    runs; each run leaves the state as the snapshot had it."""

    def __init__(self, program):
        self.name, self.runner, self.cfg = (program.name, program.runner,
                                            program.cfg)
        self.K, self.step0 = self.cfg.steps_per_call, self.runner.state.step
        self.snap = StateSnapshot(self.runner.state.tensors())
        client = self.runner.chunk_client(self.step0,
                                          self.step0 + self.K - 1)
        try:
            self.chunk = client.assemble(0, [(self.step0, self.K)])
        finally:
            client.cleanup()
        self.client, self.extras = client, client.extras(self.chunk)

    def rewind(self):
        self.snap.restore()
        self.runner.state.step = self.step0

    def _end(self, recs, ms, k):
        final = _state_copy(self.runner.state)
        self.rewind()
        return recs, ms / k, final

    def eager(self):
        """(records, ms/step by CUDA events, final state)."""
        recs, ms = _timed(lambda: [self.runner.step() for _ in range(self.K)])
        return self._end(recs, ms, self.K)

    def chunk_run(self):
        """The chunk's (records, ms/step by CUDA events, final state)."""
        (_, block), ms = _timed(
            lambda: self.client.dispatch(self.runner.state, self.chunk))
        names = self.client.block_names
        recs = [{**dict(zip(names, row)),
                 **{c: float(v[i]) for c, v in self.extras.items()}}
                for i, row in enumerate(host_rows(block, names))]
        return self._end(recs, ms, self.K)

    def loop(self, chunks: int):
        """``runner.run`` over ``chunks`` chunks: (its last record, host
        wall ms/step of the whole call, final state)."""
        t0 = time.perf_counter()
        last = self.runner.run(self.step0 + chunks * self.K - 1)
        wall_ms = (time.perf_counter() - t0) * 1e3
        require(last["step"] == self.step0 + chunks * self.K - 1,
                f"chunk {self.name}: the loop ended at step {last['step']}")
        return self._end(last, wall_ms, chunks * self.K)


def mask_word(mask) -> int:
    """A (n ≤ 32,) bool row as its packed word (bit i: worker i)."""
    return sum(1 << i for i, b in enumerate(mask) if b)


def masks_held(r: dict, runner, cfg) -> bool:
    """A coded record's forensics words: ``wmask_adv0`` the schedule's row
    (none on the approx code), ``wmask_present0`` the presence row, the
    accused word a subset of the present one holding every adversary the
    step located (cyclic: det_tp of det_adv; the vote out-votes its
    adversary) and nothing else on these clean legs."""
    n, step = cfg.num_workers, r["step"]
    adv = ([False] * n if cfg.approach == "approx"
           else [bool(b) for b in runner.adv_schedule[step]])
    stragglers = getattr(runner, "straggle_schedule", None)  # CNN only
    present = ([True] * n if stragglers is None
               else [not b for b in stragglers[step]])
    adv_w, pres_w = mask_word(adv), mask_word(present)
    located_w = mask_word([a and p for a, p in zip(adv, present)])
    return (r["wmask_adv0"] == adv_w and r["wmask_present0"] == pres_w
            and r["wmask_accused0"] == located_w)


def shadow_held(r: dict, cfg) -> bool:
    """A shadow decode beside the f32 one: finite (no sentinel), its flags
    the f32 flags and its aggregate within the dtype's calibration band
    (5e-2 relative L2 on bf16, 1.5e-1 on int8, numerics.SHADOW_REL_TOL)."""
    tol = numerics.SHADOW_REL_TOL[cfg.shadow_wire]
    return (0.0 <= r["shadow_err"] <= tol and r["shadow_residual"] >= 0.0
            and r["shadow_flag_agree"] == 1.0)


def located(name, r, cfg) -> bool:
    """A cyclic record locates exactly its adversaries: located_errors,
    det_tp and det_adv the leg's adversary count, and n − 2s honest rows —
    on a segmented leg at most n − 2s, the rows honest in every segment
    (``DETECT``)."""
    s = cfg.worker_fail
    if cfg.topology == "tree":  # each group's n − 2s_g
        s = cfg.tree_group_fail * (cfg.num_workers // cfg.tree_fanout)
    m = cfg.num_workers - 2 * s
    honest = (r["honest_located"] <= m if name in registry.TWINS
              else r["honest_located"] == m)
    return honest and (r["located_errors"] == r["det_tp"] == r["det_adv"]
                       == cfg.num_adversaries)


def _check_records(name, cfg, recs_a, recs) -> None:
    """The discrete columns of a chunked run equal the eager run's (on a
    segmented leg but honest_located, ``DETECT``), its losses are finite
    and every cyclic step locates the adversary."""
    for i, (ra, rc) in enumerate(zip(recs_a, recs)):
        for c in DISCRETE:
            if c in ra and not (c == "honest_located"
                                and name in registry.TWINS):
                require(rc.get(c) == ra[c], f"chunk {name} step {i + 1} of "
                        f"the chunk: {c} {rc.get(c)}, eager {ra[c]}")
        require(math.isfinite(rc["loss"]), f"chunk {name}: loss {rc}")
        if cfg.approach == "cyclic":
            require(located(name, rc, cfg), f"chunk {name} step {i + 1} of "
                    f"the chunk: adversaries not located: {rc}")
        if cfg.approach == "maj_vote":
            require(vote_held(rc), f"chunk {name} step {i + 1} of the chunk: "
                    f"the vote did not out-vote exactly the adversary: {rc}")


def _differs(fin_x: dict, fin_y: dict) -> dict:
    """The state tensors that differ: name -> largest absolute gap."""
    return {k: float((fin_x[k].double() - fin_y[k].double()).abs().max())
            for k in fin_y if not _same_bits(fin_x[k], fin_y[k])}


def _loop_records(recs_c, last) -> list:
    """A K-step loop's records as far as they can be compared: its last
    record (``runner.run`` returns that one) after the chunk's others."""
    return recs_c[:-1] + [{k: last[k] for k in recs_c[-1]}]


def hold_bitwise(name, cfg, eager_a, eager_b, runs) -> dict:
    """Two eager runs (records, final state) of the same K steps must agree
    bit for bit; then each of ``runs`` (what, records, final state) — the
    chunk, the chunk again, the loop — must give the first one's records
    (every block column) and final state (parameters, momentum,
    statistics) bit for bit."""
    (recs_a, fin_a), (recs_b, fin_b) = eager_a, eager_b
    eager_gap = _differs(fin_b, fin_a)
    losses_a = [r["loss"] for r in recs_a]
    require(not eager_gap and [r["loss"] for r in recs_b] == losses_a,
            f"chunk {name}: two eager runs of the same steps differ: losses "
            f"{losses_a} vs {[r['loss'] for r in recs_b]}, state "
            f"{dict(list(eager_gap.items())[:6])} ({len(eager_gap)} "
            f"tensors)")
    held = []
    for what, recs, fin in runs:
        _check_records(name, cfg, recs_a, recs)
        cols = [c for c in recs[0] if c in recs_a[0]]
        rows = [[r[c] for c in cols] for r in recs]
        gap = _differs(fin, fin_a)
        held.append({"run": what, "rows_bitwise":
                     rows == [[r[c] for c in cols] for r in recs_a],
                     "state_differs": gap})
        require(held[-1]["rows_bitwise"] and not gap, f"chunk {name}: "
                f"{what} against the eager run: rows {rows} vs eager "
                f"{[[r[c] for c in cols] for r in recs_a]}, state "
                f"{dict(list(gap.items())[:6])} ({len(gap)} tensors)")
    return {"cudnn_deterministic": torch.backends.cudnn.deterministic,
            "state_tensors": len(fin_a), "held": held}


def chunk_leg(lp, program, dev, profile: bool) -> dict:
    """Phase 6 for one leg (module docstring). Timing on the leg's own
    setup: K eager steps, the chunk (capture, then replays only) and the
    loop over LOOP_CHUNKS chunks. Agreement (``hold_bitwise``): the LM
    legs on that setup, from a second eager run and the timed chunks; the
    ResNet legs on a fresh setup under deterministic cuDNN, its own two
    eager runs, two chunks and the loop. Every eager run of a setup comes
    before its capture: an eager step's peak beside the graph's pool does
    not fit the card on ``lm_simulate_flash``. The default-setting chunk
    of a ResNet leg is held to its eager run within the leg's card-vs-CPU
    tolerance (loss 1e-4 relative, update 5e-2 relative L2,
    cross_device_check). The state is left as the snapshot had it."""
    name, cfg = lp.name, program.cfg
    K, lm = cfg.steps_per_call, lp.route != "cnn"
    runs = _ChunkRuns(program)
    recs_e, eager_ms, fin_e = runs.eager()
    recs_b, _, fin_b = runs.eager() if lm else (None, None, None)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    recs_c, first_ms, fin_c = runs.chunk_run()  # warm-up, capture, replays
    first_wall_s = time.perf_counter() - t0
    captured = ops.launch_counts()
    recs_c2, chunk_ms, fin_c2 = runs.chunk_run()
    last, loop_wall_ms, _ = runs.loop(LOOP_CHUNKS)
    loop_ms = last["step_ms"]
    for k in EXPECT[name]:
        require(captured[k] > 0, f"chunk {name}: kernel {k} is not in the "
                f"captured step ({captured})")
    loss_tol, upd_tol = (1e-5, 1e-3) if lm else (1e-4, 5e-2)
    default_err = []
    for recs, fin in ((recs_c, fin_c), (recs_c2, fin_c2)):
        _check_records(name, cfg, recs_e, recs)
        default_err.append({
            "loss_rel_err": max(abs(c["loss"] - a["loss"]) / abs(a["loss"])
                                for a, c in zip(recs_e, recs)),
            "update_rel_l2_err": _update_err(runs.snap.saved, fin, fin_e)})
        require(default_err[-1]["loss_rel_err"] <= loss_tol
                and default_err[-1]["update_rel_l2_err"] <= upd_tol,
                f"chunk {name}: {default_err[-1]} against the eager run "
                f"(tol loss {loss_tol}, update {upd_tol})")
    graph = runs.client.many.graph()
    if lm:
        last1, _, fin_l = runs.loop(1)
        agreement = hold_bitwise(
            name, cfg, (recs_e, fin_e), (recs_b, fin_b),
            [("chunk", recs_c, fin_c), ("chunk again", recs_c2, fin_c2),
             ("the loop", _loop_records(recs_c, last1), fin_l)])
        det = ""
    else:
        with cudnn_deterministic():
            fresh = lp.build(dev, full=True, max_steps=1 + K,
                             steps_per_call=K, dataset=program.runner.ds)
            fresh.runner.step()  # one step before the snapshot, as above
            fr = _ChunkRuns(fresh)
            (da, det_eager_ms, fa), (db, _, fb) = fr.eager(), fr.eager()
            (dc, _, fc), (dc2, det_chunk_ms, fc2) = (fr.chunk_run(),
                                                     fr.chunk_run())
            dl, _, fl = fr.loop(1)
            agreement = hold_bitwise(
                name, cfg, (da, fa), (db, fb),
                [("chunk", dc, fc), ("chunk again", dc2, fc2),
                 ("the loop", _loop_records(dc, dl), fl)])
        agreement.update(eager_ms_per_step=det_eager_ms,
                         chunk_ms_per_step=det_chunk_ms)
        det = (f", deterministic cuDNN: eager {det_eager_ms:.2f}, chunk "
               f"{det_chunk_ms:.2f} ms/step")
    # the host's assembly of one chunk from its pieces (on the approx code
    # K host solves of the decode weights), before its dispatch
    make_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        runs.client.remake(runs.chunk)
        make_ms.append((time.perf_counter() - t0) * 1e3)
    out = {"k": K, "eager_ms_per_step": eager_ms,
           "chunk_ms_per_step": chunk_ms, "loop_ms_per_step": loop_ms,
           "make_chunk_ms": sorted(make_ms)[len(make_ms) // 2],
           "loop_chunks": LOOP_CHUNKS, "loop_wall_ms_per_step": loop_wall_ms,
           "first_chunk_ms_per_step": first_ms,
           "first_chunk_wall_s": first_wall_s,
           "default_settings_err": default_err, "agreement": agreement,
           "captured_launches": captured,
           "pool_bytes": graph.pool_bytes, "slot_waits": graph.slot_waits,
           "records": recs_c}
    print(f"chunk {name}: eager {eager_ms:.2f} ms/step, chunk {chunk_ms:.2f} "
          f"ms/step (K={K}, CUDA events around the dispatch of an assembled "
          f"chunk; the capturing chunk {first_ms:.2f} ms/step, "
          f"{first_wall_s:.2f} s wall), the loop {loop_ms:.2f} ms/step (its "
          f"records' step_ms over {LOOP_CHUNKS} chunks: assembly, prefetch, "
          f"dispatch and flush; the whole call {loop_wall_ms:.2f} ms/step "
          f"wall); default settings vs eager: worst loss rel "
          f"{max(e['loss_rel_err'] for e in default_err):.2e} (tol "
          f"{loss_tol:g}), update "
          f"{max(e['update_rel_l2_err'] for e in default_err):.2e} (tol "
          f"{upd_tol:g}); bit for bit (eager twice, chunk, chunk again, the "
          f"loop; {agreement['state_tensors']} state tensors and every "
          f"block column{det}): yes; pool {graph.pool_bytes / 2**30:.2f} "
          f"GiB; a chunk made on the host in {out['make_chunk_ms']:.3f} ms "
          f"(median of 5); captured {captured}", flush=True)
    if profile and name == "lm_shared_flash":
        out["profile"] = prof = profile_chunk(runs.client, runs.runner,
                                              runs.chunk, runs.rewind)
        print(f"chunk {name} profile: device busy {prof['device_busy_ms']:.2f}"
              f" ms of {prof['wall_ms']:.2f} ms wall a chunk of {K} under the "
              f"profiler ({100 * prof['busy_share']:.1f}% busy); "
              f"{100 * prof['device_busy_ms'] / (K * chunk_ms):.1f}% of the "
              f"unprofiled chunk's {K * chunk_ms:.2f} ms (CUDA events)",
              flush=True)
    return out


def profile_chunk(client, runner, chunk, rewind) -> dict:
    """One chunk (replays only) under torch.profiler: the device's busy
    time (its kernels, copies and sets) against the chunk's wall time
    inside the profiler, dispatch to synchronise."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        client.dispatch(runner.state, chunk)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rewind()
    busy_ms = sum(getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0.0))
                  for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.key not in PHASES) / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms}


def chunk_summary(legs) -> dict:
    """Eager, chunk and loop ms/step of every leg, and the flagship ratio
    as bench.py computes its vs_baseline — the geometric-median step's ms
    over the cyclic simulate step's, each timed as the dispatch of chunks
    already assembled (bench.py's time_scanned_steps) — beside the same
    ratio from the loop's own step_ms (assembly and flush included)."""
    cols = ("eager_ms_per_step", "chunk_ms_per_step", "loop_ms_per_step")
    by = {lg["leg"]: lg["chunk"] for lg in legs}
    out = {name: {c: v[c] for c in cols} for name, v in by.items()}
    ratio = {c: by["geomedian"][c] / by["simulate"][c] for c in cols}
    print(f"chunk flagship: vs_baseline = geomedian / simulate = "
          f"{ratio['chunk_ms_per_step']:.4f} under the chunk (the loop "
          f"{ratio['loop_ms_per_step']:.4f}, eager "
          f"{ratio['eager_ms_per_step']:.4f}); eager -> chunk / loop ms/step: "
          + ", ".join(f"{n} {v['eager_ms_per_step']:.2f} -> "
                      f"{v['chunk_ms_per_step']:.2f} / "
                      f"{v['loop_ms_per_step']:.2f}"
                      for n, v in out.items()), flush=True)
    return {"legs": out, "vs_baseline": ratio["chunk_ms_per_step"],
            "vs_baseline_loop": ratio["loop_ms_per_step"],
            "vs_baseline_eager": ratio["eager_ms_per_step"]}


def lm_code_twins(legs) -> dict:
    """Each LM code leg (``registry.LM_CODE_TWINS``) beside its yardstick
    of this call: eager, chunk and loop ms/step, the eager steps' peak
    memory, the graph's pool and the host's chunk assembly."""
    by = {lg["leg"]: lg for lg in legs}
    out = {}
    for leg, twin in registry.LM_CODE_TWINS.items():
        row = {}
        for name in (leg, twin):
            lg = by[name]
            c = lg["chunk"]
            row[name] = {"eager_ms_per_step": c["eager_ms_per_step"],
                         "chunk_ms_per_step": c["chunk_ms_per_step"],
                         "loop_ms_per_step": c["loop_ms_per_step"],
                         "peak_mem_gb": lg["peak_mem_gb"],
                         "pool_bytes": c["pool_bytes"],
                         "make_chunk_ms": c["make_chunk_ms"]}
        out[leg] = {"twin": twin, **row}
        a, b = row[leg], row[twin]
        print(f"lm code leg {leg} beside {twin}: eager "
              f"{a['eager_ms_per_step']:.2f} / {b['eager_ms_per_step']:.2f}, "
              f"chunk {a['chunk_ms_per_step']:.2f} / "
              f"{b['chunk_ms_per_step']:.2f}, loop "
              f"{a['loop_ms_per_step']:.2f} / {b['loop_ms_per_step']:.2f} "
              f"ms/step; eager peak {a['peak_mem_gb']:.2f} / "
              f"{b['peak_mem_gb']:.2f} GB; pool "
              f"{a['pool_bytes'] / 2**30:.2f} / {b['pool_bytes'] / 2**30:.2f}"
              f" GiB; chunk made on the host in {a['make_chunk_ms']:.3f} / "
              f"{b['make_chunk_ms']:.3f} ms", flush=True)
    return out


# the layer stack's twins run the same function: remat recomputes the
# block, the scanned stack runs the same body on the same slices
STACK_STEPS = 3
STACK_LOSS_RTOL = 1e-6
STACK_UPDATE_RTOL = 1e-5
# four sequence shards, (loss rtol, update rel L2 tol) against the twin:
# a2a runs the same flash launches on a permuted head axis (bit for bit
# on an H100); the ring sums each query's hops in float32 in another
# order, and the bf16 projections round the difference up. On an H100
# 80GB HBM3 at LM_FULL over 3 steps the ring read loss rel ≤ 1.84e-5 and
# update rel L2 ≤ 7.06e-3, the ring without its last hop update rel L2
# ≥ 0.147: the bounds sit ~4-5x from each
SP_RING_LOSS_RTOL = 1e-4
SP_RING_UPDATE_RTOL = 3e-2
SP_TOL = {"lm_sp4_ring_flash": (SP_RING_LOSS_RTOL, SP_RING_UPDATE_RTOL),
          "lm_sp4_a2a_flash": (STACK_LOSS_RTOL, STACK_UPDATE_RTOL)}


def _lm_steps(cfg, dev, steps: int, init=None, probe=None) -> tuple:
    """``steps`` eager LM steps through the route's builder and the token
    loop from ``init`` (default: the seed's draw): (their records, each
    step's parameter update as one flat host vector in the unrolled
    layout's order, the initial parameters on the card). ``probe(setup,
    step)`` runs before each step."""
    setup = build_route_setup(cfg, dev, init=init)
    loop = TokenLoop(setup, cfg, quiet=True)
    first = {k: v.clone() for k, v in setup.state.params.items()}
    with torch.device("meta"):
        unrolled = params_mod.layout(TransformerLM(
            cfg.vocab, cfg.model_dim, cfg.model_heads, cfg.model_layers,
            experts=cfg.moe_experts))

    def flat():
        p = unpipe(setup.state.params)
        if cfg.scan_layers or cfg.pipeline_active:
            p = unstack(p, cfg.model_layers)
        return params_mod.flatten(p, unrolled).cpu()

    prev = flat()
    recs, deltas = [], []
    for _ in range(steps):
        if probe is not None:
            probe(setup, loop.state.step)
        recs.append(loop.step())
        cur = flat()
        deltas.append(cur - prev)
        prev = cur
    return recs, deltas, first


def unpipe(params: dict) -> dict:
    """The pipeline's parameters under the scanned LM's names:
    ``blocks.loop.b.<leaf>`` -> ``blocks.<leaf>`` (the same stacked
    shapes)."""
    return {("blocks." + k[len(PP_BLOCKS):] if k.startswith(PP_BLOCKS)
             else k): v for k, v in params.items()}


PP_BLOCKS = "blocks.loop.b."


def restack(params: dict, layers: int) -> dict:
    """An unrolled LM's parameters as the scanned tree's: each
    ``block{i}.<leaf>`` stacked on a leading layer axis as
    ``blocks.<leaf>`` (the reference's tests/test_transformer_scan.py)."""
    out = {k: v for k, v in params.items() if not k.startswith("block")}
    leaves = {k.split(".", 1)[1] for k in params if k.startswith("block")}
    for leaf in leaves:
        out["blocks." + leaf] = torch.stack(
            [params[f"block{i}.{leaf}"] for i in range(layers)])
    return out


def unstack(params: dict, layers: int) -> dict:
    """The scanned tree's parameters as the unrolled tree's (the inverse
    of :func:`restack`)."""
    out = {k: v for k, v in params.items() if not k.startswith("blocks.")}
    for k, v in params.items():
        if k.startswith("blocks."):
            for i in range(layers):
                out[f"block{i}." + k[len("blocks."):]] = v[i]
    return out


def _held_steps(label, a, b, loss_rtol, update_rtol) -> list:
    """Step by step: the discrete columns equal, the loss within
    ``loss_rtol`` relative, the update within ``update_rtol`` in relative
    L2 norm (and whether it is bit for bit)."""
    (ra, da, _), (rb, db, _) = a, b
    out = []
    for x, y, u, w in zip(ra, rb, da, db):
        cols = {c: (x[c], y[c]) for c in DISCRETE if c in y}
        require(all(p == q for p, q in cols.values()),
                f"{label} step {x['step']}: columns differ: {cols}")
        loss_rel = abs(x["loss"] - y["loss"]) / abs(y["loss"])
        upd = ((u - w).norm() / w.norm()).item()
        out.append({"step": x["step"], "loss": x["loss"],
                    "twin_loss": y["loss"], "loss_rel_err": loss_rel,
                    "update_rel_l2_err": upd,
                    "update_bitwise": torch.equal(u, w)})
        require(loss_rel <= loss_rtol and upd <= update_rtol,
                f"{label} step {x['step']}: loss rel {loss_rel:.3e} (tol "
                f"{loss_rtol:g}), update rel L2 {upd:.3e} (tol "
                f"{update_rtol:g})")
    print(f"stack twin {label}: columns equal on {len(out)} steps; loss rel "
          f"{['%.2e' % r['loss_rel_err'] for r in out]} (tol {loss_rtol:g});"
          f" update rel L2 {['%.2e' % r['update_rel_l2_err'] for r in out]} "
          f"(tol {update_rtol:g}); bit for bit "
          f"{[r['update_bitwise'] for r in out]}", flush=True)
    return out


@contextlib.contextmanager
def ring_without_last_hop():
    """A negative control for the sp bounds: the ring skips its last hop
    (the last shard's queries lose the first shard's keys)."""
    from draco_tpu_torch.parallel import ring_attention

    hops = ring_attention._hops
    ring_attention._hops = lambda *a: list(hops(*a))[:-1]
    try:
        yield
    finally:
        ring_attention._hops = hops


def stack_twin_checks(legs, dev) -> dict:
    """The layer-stack and sequence-shard legs beside ``lm_shared_flash``
    (``registry.STACK_TWINS``). remat: STACK_STEPS eager steps from the
    same draw, the same columns, the loss to float32 rounding and the
    update within STACK_UPDATE_RTOL. The scanned stack: the same steps from
    the twin's initial parameters restacked, the same bounds. The four
    sequence shards (ring, a2a): STACK_STEPS eager steps from the same
    draw held as above within their SP_TOL, and the same columns on every
    eager and chunked step of the timed legs with their losses within it.
    And every leg's eager, chunk and loop ms/step beside the twin's."""
    by = {lg["leg"]: lg for lg in legs}
    twin = "lm_shared_flash"
    out = {}

    def cfg_of(name):
        return registry.get(name).config(True, max_steps=STACK_STEPS)

    base = _lm_steps(cfg_of(twin), dev, STACK_STEPS)
    remat = _lm_steps(cfg_of("lm_shared_flash_remat"), dev, STACK_STEPS)
    out["lm_shared_flash_remat"] = {"steps": _held_steps(
        "lm_shared_flash_remat / lm_shared_flash", remat, base,
        STACK_LOSS_RTOL, STACK_UPDATE_RTOL)}
    del remat
    gc.collect()
    torch.cuda.empty_cache()
    scfg = cfg_of("lm_shared_flash_scan")
    scan = _lm_steps(scfg, dev, STACK_STEPS,
                     init=restack(base[2], scfg.model_layers))
    out["lm_shared_flash_scan"] = {"steps": _held_steps(
        "lm_shared_flash_scan (restacked) / lm_shared_flash", scan, base,
        STACK_LOSS_RTOL, STACK_UPDATE_RTOL)}
    base = base[:2] + (None,)
    del scan
    gc.collect()
    torch.cuda.empty_cache()
    for leg, (loss_rtol, update_rtol) in SP_TOL.items():
        sp = _lm_steps(cfg_of(leg), dev, STACK_STEPS)
        out[leg] = {"steps": _held_steps(f"{leg} / {twin}", sp, base,
                                         loss_rtol, update_rtol)}
        del sp
        gc.collect()
        torch.cuda.empty_cache()
        a, b = by[leg], by[twin]
        worst = 0.0
        for what, ra, rb in (("eager", a["records"], b["records"]),
                             ("chunk", a["chunk"]["records"],
                              b["chunk"]["records"])):
            require(len(ra) == len(rb) > 0, f"{leg}: {what} records")
            for x, y in zip(ra, rb):
                cols = {c: (x[c], y[c]) for c in DISCRETE if c in y}
                require(all(p == q for p, q in cols.values()),
                        f"{leg} / {twin}, {what} step: columns differ: "
                        f"{cols}")
                worst = max(worst, abs(x["loss"] - y["loss"])
                            / abs(y["loss"]))
        require(worst <= loss_rtol, f"{leg} / {twin}: loss rel err "
                f"{worst:.3e} (tol {loss_rtol:g})")
        out[leg].update({"columns_equal": True, "worst_loss_rel_err": worst,
                         "loss_rtol": loss_rtol,
                         "update_rtol": update_rtol})
        print(f"stack twin {leg} / {twin}: columns equal on every eager and "
              f"chunked step of the timed legs, worst loss rel {worst:.3e} "
              f"(tol {loss_rtol:g})", flush=True)
    ring = "lm_sp4_ring_flash"
    with ring_without_last_hop():
        _, bad, _ = _lm_steps(cfg_of(ring), dev, STACK_STEPS)
    worst = max(((u - w).norm() / w.norm()).item()
                for u, w in zip(bad, base[1]))
    require(worst > SP_TOL[ring][1], f"{ring} without its last hop: update "
            f"rel L2 {worst:.3e}, inside the bound {SP_TOL[ring][1]:g}")
    out["ring_last_hop_dropped"] = {"worst_update_rel_l2_err": worst}
    print(f"control: {ring} without its last hop, worst update rel L2 "
          f"{worst:.3e} (outside {SP_TOL[ring][1]:g})", flush=True)
    del base, bad
    cols = ("eager_ms_per_step", "chunk_ms_per_step", "loop_ms_per_step")
    for leg in tuple(registry.STACK_TWINS) + ("lm_big_shared_flash", twin):
        row = {c: by[leg]["chunk"][c] for c in cols}
        row["eager_peak_mem_gb"] = by[leg]["peak_mem_gb"]
        row["pool_bytes"] = by[leg]["chunk"]["pool_bytes"]
        out.setdefault(leg, {})["timing"] = row
        print(f"stack leg {leg}: eager {row['eager_ms_per_step']:.2f}, chunk "
              f"{row['chunk_ms_per_step']:.2f}, loop "
              f"{row['loop_ms_per_step']:.2f} ms/step; eager peak "
              f"{row['eager_peak_mem_gb']:.2f} GB, graph pool "
              f"{row['pool_bytes'] / 2**30:.2f} GiB", flush=True)
    return out


# the model-parallel legs against their twins (registry.MP_TWINS), over
# STACK_STEPS eager steps: the twin's decode columns, the loss within
# MP_LOSS_RTOL relative and the update within the leg's bound in relative
# L2, a control outside it. Set before the first run on the card: tp2's
# bf16 row-parallel partials round to bf16 before their sum, and pp2's
# microbatches change the matmuls' shapes, so each takes the ring's 3e-2
# (bf16 chaos over three steps, PERF.md §6). ep2 runs its twin's MoE as
# it is (parallel/ep_step.py: with top-1 routing a per-group combine adds
# exact zeros), so it is held bit for bit: losses, updates and routing
MP_LOSS_RTOL = 1e-3
MP_UPDATE_RTOL = {"lm_shared_dense_tp2": 3e-2, "lm_shared_flash_pp2": 3e-2}


@contextlib.contextmanager
def row_partial_dropped():
    """tp2's negative control: a row-parallel layer leaves its last
    shard's partial out of the sum."""
    from draco_tpu_torch.models import transformer as tmod

    fwd = tmod.Dense.forward

    def dropped(self, x):
        if self.parallel != "row" or self.shards == 1:
            return fwd(self, x)
        dt = self.dtype
        parts = list(zip(x.to(dt).chunk(self.shards, -1),
                         self.weight.to(dt).chunk(self.shards, 1)))[:-1]
        out = sum(F.linear(xi, wi) for xi, wi in parts)
        return out if self.bias is None else out + self.bias.to(dt)

    tmod.Dense.forward = dropped
    try:
        yield
    finally:
        tmod.Dense.forward = fwd


@contextlib.contextmanager
def last_microbatch_dropped():
    """pp2's negative control: the schedule's last microbatch never
    reaches the head (its output zeros)."""
    from draco_tpu_torch.parallel.pp_step import PipelineLM

    sched = PipelineLM.schedule

    def dropped(self, x_mb, positions):
        outs = sched(self, x_mb, positions)
        return torch.cat([outs[:-1], torch.zeros_like(outs[-1:])])

    PipelineLM.schedule = dropped
    try:
        yield
    finally:
        PipelineLM.schedule = sched


def moe_probe(sink: list, cfg):
    """A probe for ``_lm_steps`` of ``cfg``: each MoE block's routing of
    every lane at the step's tokens and parameters (one forward a lane,
    outside the step), as (expert index (n, blocks, B·T) int, dropped
    tokens a lane and block (n, blocks))."""
    from draco_tpu_torch.models.moe import MoeMlp

    def probe(setup, step):
        model = setup.model
        toks = torch.as_tensor(sp_text(cfg.seed, step, cfg.num_workers,
                                       cfg.batch_size, cfg.seq_len,
                                       cfg.vocab), device=setup.device).long()
        seen = []

        def hook(mod, inp, _):
            h = inp[0]
            dispatch, _, eidx = mod.route(h.reshape(-1, h.shape[-1]))
            seen.append((eidx, eidx.numel() - dispatch.sum()))

        hooks = [m.register_forward_hook(hook) for m in model.modules()
                 if isinstance(m, MoeMlp)]
        try:
            with torch.no_grad():
                for lane in toks:
                    model(lane)
        finally:
            for h in hooks:
                h.remove()
        blocks = len(hooks)
        eidx = torch.stack([e for e, _ in seen]).view(
            toks.shape[0], blocks, -1).cpu()
        drops = torch.stack([d for _, d in seen]).view(
            toks.shape[0], blocks).cpu()
        sink.append((eidx, drops))
    return probe


def _control_outside(label, bad, base, bound_rtol) -> float:
    worst = max(((u - w).norm() / w.norm()).item()
                for u, w in zip(bad, base))
    require(worst > bound_rtol, f"control {label}: update rel L2 "
            f"{worst:.3e}, inside the bound {bound_rtol:g}")
    print(f"control: {label}, worst update rel L2 {worst:.3e} (outside "
          f"{bound_rtol:g})", flush=True)
    return worst


def mp_twin_checks(legs, dev) -> dict:
    """The model-parallel legs beside their twins (``registry.MP_TWINS``,
    module docstring, phase 4): tp2 and ep2 from their twins' draw, pp2's
    twin from the pipeline's parameters renamed; tp2 and pp2 each with its
    control, ep2 bit for bit; the MoE leg's routing and dropped tokens;
    every leg's eager, chunk and loop ms/step and step peak beside its
    twin's."""
    by = {lg["leg"]: lg for lg in legs}
    out = {}

    def cfg_of(name):
        return registry.get(name).config(True, max_steps=STACK_STEPS)

    def settle():
        gc.collect()
        torch.cuda.empty_cache()

    tp, twin = "lm_shared_dense_tp2", "lm_shared_dense"
    base = _lm_steps(cfg_of(twin), dev, STACK_STEPS)
    leg = _lm_steps(cfg_of(tp), dev, STACK_STEPS)
    out[tp] = {"steps": _held_steps(f"{tp} / {twin}", leg, base,
                                    MP_LOSS_RTOL, MP_UPDATE_RTOL[tp])}
    del leg
    settle()
    with row_partial_dropped():
        _, bad, _ = _lm_steps(cfg_of(tp), dev, STACK_STEPS)
    out[tp]["control_row_partial_dropped"] = _control_outside(
        f"{tp} with one shard's row-parallel partial dropped", bad, base[1],
        MP_UPDATE_RTOL[tp])
    del base, bad
    settle()

    pp, twin = "lm_shared_flash_pp2", "lm_shared_flash_scan"
    leg = _lm_steps(cfg_of(pp), dev, STACK_STEPS)
    base = _lm_steps(cfg_of(twin), dev, STACK_STEPS, init=unpipe(leg[2]))
    out[pp] = {"steps": _held_steps(f"{pp} / {twin} (renamed)", leg, base,
                                    MP_LOSS_RTOL, MP_UPDATE_RTOL[pp])}
    del leg
    settle()
    with last_microbatch_dropped():
        _, bad, _ = _lm_steps(cfg_of(pp), dev, STACK_STEPS)
    out[pp]["control_last_microbatch_dropped"] = _control_outside(
        f"{pp} with its last microbatch dropped", bad, base[1],
        MP_UPDATE_RTOL[pp])
    del base, bad
    settle()

    ep, twin = "lm_shared_dense_moe4_ep2", "lm_shared_dense_moe4"
    routes_twin, routes_ep = [], []
    base = _lm_steps(cfg_of(twin), dev, STACK_STEPS,
                     probe=moe_probe(routes_twin, cfg_of(twin)))
    leg = _lm_steps(cfg_of(ep), dev, STACK_STEPS,
                    probe=moe_probe(routes_ep, cfg_of(ep)))
    for i, ((ea, da), (eb, db)) in enumerate(zip(routes_ep, routes_twin)):
        require(torch.equal(ea, eb) and torch.equal(da, db),
                f"{ep} step {i + 1}: routing differs from {twin}'s on "
                f"{int((ea != eb).sum())} tokens")
    steps = _held_steps(f"{ep} / {twin}", leg, base, 0.0, 0.0)
    require(all(r["update_bitwise"] for r in steps),
            f"{ep} / {twin}: the updates differ")
    out[ep] = {"steps": steps, "routing_equal_steps": len(routes_ep)}
    del leg, base
    settle()
    cfg = cfg_of(twin)
    n_tok = cfg.batch_size * cfg.seq_len
    drops = [d.sum(dim=1).tolist() for _, d in routes_twin]
    out[twin] = {"dropped_tokens_per_lane": drops,
                 "tokens_per_lane": n_tok * cfg.model_layers,
                 "capacity": max(int(1.25 * n_tok / cfg.moe_experts), 1)}
    print(f"moe {twin}: dropped tokens a step, per lane over its "
          f"{cfg.model_layers} blocks of {n_tok} tokens (capacity "
          f"{out[twin]['capacity']} an expert): {drops}", flush=True)

    cols = ("eager_ms_per_step", "chunk_ms_per_step", "loop_ms_per_step")
    for leg_name, twin_name in registry.MP_TWINS.items():
        for name in (leg_name, twin_name):
            row = {c: by[name]["chunk"][c] for c in cols}
            row["eager_peak_mem_gb"] = by[name]["peak_mem_gb"]
            row["pool_bytes"] = by[name]["chunk"]["pool_bytes"]
            out.setdefault(name, {})["timing"] = row
        a, b = out[leg_name]["timing"], out[twin_name]["timing"]
        print(f"mp leg {leg_name} beside {twin_name}: eager "
              f"{a['eager_ms_per_step']:.2f} / {b['eager_ms_per_step']:.2f}, "
              f"chunk {a['chunk_ms_per_step']:.2f} / "
              f"{b['chunk_ms_per_step']:.2f}, loop "
              f"{a['loop_ms_per_step']:.2f} / {b['loop_ms_per_step']:.2f} "
              f"ms/step; eager peak {a['eager_peak_mem_gb']:.2f} / "
              f"{b['eager_peak_mem_gb']:.2f} GB; pool "
              f"{a['pool_bytes'] / 2**30:.2f} / {b['pool_bytes'] / 2**30:.2f}"
              f" GiB", flush=True)
    return out


def grad_phase_peak(cfg, dev) -> int:
    """The gradient phase's peak bytes (``setup.lane_grads``: the lanes'
    forward and backward under vmap(grad_and_value), up to the flat
    gradients) above the memory live before it: a warm-up call, then one
    from the peak's reset, on step 1's tokens."""
    setup = build_sp_train_setup(cfg, dev)
    toks = torch.as_tensor(sp_text(cfg.seed, 1, cfg.num_workers,
                                   cfg.batch_size, cfg.seq_len, cfg.vocab),
                           device=dev).long()
    setup.lane_grads(setup.state.params, toks)
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = setup.lane_grads(setup.state.params, toks)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - start
    del out, setup, toks
    gc.collect()
    torch.cuda.empty_cache()
    return peak


def remat_memory(dev) -> dict:
    """What remat saves: the gradient phase's peak of ``lm_shared_flash``
    and ``lm_shared_flash_remat``, and of ``lm_big_shared_flash`` with and
    without remat (each lower with it); and lm_big's whole step without
    remat once (one warm-up step, then one from the peak's reset, as the
    lint measures a step), or the out-of-memory message. At LM_FULL the
    coded tail sets the step's peak (13.14 GiB, remat or not: PERF.md §6),
    at lm_big without remat the gradient phase does."""
    big = registry.get("lm_big_shared_flash").config(True, max_steps=2)
    cfgs = {"lm_shared_flash": registry.get("lm_shared_flash").config(True),
            "lm_shared_flash_remat":
                registry.get("lm_shared_flash_remat").config(True),
            "lm_big_shared_flash": big,
            "lm_big_shared_flash without remat":
                dataclasses.replace(big, remat=False)}
    out = {"grad_phase_peak_bytes": {k: grad_phase_peak(c, dev)
                                     for k, c in cfgs.items()}}
    peaks = out["grad_phase_peak_bytes"]
    print("remat: the gradient phase's peak " + ", ".join(
        f"{k} {v / 2**30:.2f} GiB" for k, v in peaks.items()), flush=True)
    require(peaks["lm_shared_flash_remat"] < peaks["lm_shared_flash"]
            and peaks["lm_big_shared_flash"]
            < peaks["lm_big_shared_flash without remat"],
            f"remat does not lower the gradient phase's peak: {peaks}")
    cfg = cfgs["lm_big_shared_flash without remat"]
    loop = None
    try:
        loop = TokenLoop(build_sp_train_setup(cfg, dev), cfg, quiet=True)
        loop.step()
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        rec = loop.step()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        nr = {"fits": True, "step_peak_bytes": peak - start,
              "peak_bytes": peak, "loss": rec["loss"]}
        print(f"lm_big_shared_flash without remat: step peak "
              f"{(peak - start) / 2**30:.2f} GiB (absolute "
              f"{peak / 2**30:.2f} GiB)", flush=True)
    except torch.cuda.OutOfMemoryError as e:
        nr = {"fits": False, "oom": str(e).splitlines()[0]}
        print(f"lm_big_shared_flash without remat: out of memory: "
              f"{nr['oom']}", flush=True)
    out["lm_big_without_remat"] = nr
    del loop
    gc.collect()
    torch.cuda.empty_cache()
    return out


def first_aggregate(lp, dev, ds) -> tuple:
    """One step of a leg from a fresh setup (the ResNet legs under
    deterministic cuDNN, so two setups give the same gradients): its
    record and the aggregate the optimizer was handed, as one flat
    vector."""
    program = lp.build(dev, full=True, max_steps=2, dataset=ds)
    opt = program.runner.state.opt
    step, seen = opt.step_flat, []

    def watched(params, flat, layout, ok=None):
        seen.append(flat)
        return step(params, flat, layout, ok)

    opt.step_flat = watched
    with (cudnn_deterministic() if lp.route == "cnn"
          else contextlib.nullcontext()):
        rec = program.runner.step()
    return rec, seen[0].clone()


# the tree-vs-flat phase: the adversary's row and the straggler's
TREE_ADVERSARY, TREE_STRAGGLER = 11, 9
TREE_MEAN_RTOL = 1e-5


def tree_vs_flat(dev, ds) -> dict:
    """One step's (16, d) ResNet-18 batch gradients (the first step of
    ``shared_tree_g8``, captured at its encode) encoded flat (n=16, s=1)
    and as the tree (two groups of 8, s_g = 1), then, in one case, the
    rev_grad adversary on row TREE_ADVERSARY, in another row
    TREE_STRAGGLER dropped as a straggler (zero-filled, absent); each
    decoded both ways. The flagged rows equal, the adversary flagged, the
    straggler never, both aggregates within TREE_MEAN_RTOL relative L2 of
    the true mean. Timed: the tree's encode as one launch of the
    block-diagonal matrix against a launch a group, and each decode."""
    lp = registry.get("shared_tree_g8")
    cfg = lp.config(True, max_steps=2)
    runner = lp.runner(cfg, dev, True, ds)
    seen, real = [], step_mod.encode_shared

    def watched(code, grads):
        seen.append(grads.detach().clone())
        return real(code, grads)

    step_mod.encode_shared = watched
    try:
        runner.step()
    finally:
        step_mod.encode_shared = real
    require(len(seen) == 1, f"tree_vs_flat: the encode ran {len(seen)} times")
    grads = seen[0]
    n, d = grads.shape
    tcode = runner.setup.code
    del runner
    require(topology.is_tree(tcode) and (tcode.groups, tcode.fanout,
                                         tcode.s) == (2, 8, 1),
            f"tree_vs_flat: the leg's code is {tcode}")
    flat = cyclic.build_cyclic_code(n, 1)
    true_mean = grads.mean(dim=0)
    f = drng.projection_factors(SEED, d, dev)
    out = {"n": n, "d": d}
    for case, adv, absent in (("adversary", (TREE_ADVERSARY,), ()),
                              ("straggler", (), (TREE_STRAGGLER,))):
        flagged = {}
        for topo_name, code in (("flat", flat), ("tree", tcode)):
            enc_re, enc_im = common_mod.encode_shared(code, grads)
            mask = torch.zeros(n, dtype=torch.bool, device=dev)
            mask[list(adv)] = True
            enc_re, enc_im = attacks.inject_cyclic(enc_re, enc_im, mask,
                                                   "rev_grad")
            present = None
            if absent:
                present = torch.ones(n, dtype=torch.bool, device=dev)
                present[list(absent)] = False
                pw = present[:, None].to(torch.float32)
                enc_re, enc_im = enc_re * pw, enc_im * pw
            dec, honest, health = common_mod.cyclic_decode(
                cfg, code, enc_re, enc_im, f, None, present=present)
            err = ((dec - true_mean).norm() / true_mean.norm()).item()
            fl = health["flagged"]
            if present is not None:
                fl = fl & present
            flagged[topo_name] = fl.cpu()
            ms = time_ms(lambda: common_mod.cyclic_decode(
                cfg, code, enc_re, enc_im, f, None, present=present), 5)
            out[f"{case}_{topo_name}"] = {
                "flagged": fl.nonzero().flatten().tolist(),
                "honest": int(honest.sum()), "rel_l2": err,
                "decode_ms": ms}
            require(err <= TREE_MEAN_RTOL, f"tree_vs_flat {case} "
                    f"{topo_name}: the aggregate is {err:.3e} (relative L2) "
                    f"off the true mean (tol {TREE_MEAN_RTOL:g})")
            for row in absent:
                require(not bool(fl[row]), f"tree_vs_flat {case} "
                        f"{topo_name}: the straggler {row} accused")
            require(fl.nonzero().flatten().tolist() == list(adv),
                    f"tree_vs_flat {case} {topo_name}: flagged "
                    f"{fl.nonzero().flatten().tolist()}, adversary {adv}")
            del enc_re, enc_im
        require(torch.equal(flagged["flat"], flagged["tree"]),
                f"tree_vs_flat {case}: flagged flat "
                f"{flagged['flat'].tolist()} tree {flagged['tree'].tolist()}")
        print(f"tree vs flat [{case}]: flagged equal "
              f"{out[case + '_tree']['flagged']}, relative L2 to the true "
              f"mean flat {out[case + '_flat']['rel_l2']:.3e} tree "
              f"{out[case + '_tree']['rel_l2']:.3e}; decode ms flat "
              f"{out[case + '_flat']['decode_ms']:.4f} tree "
              f"{out[case + '_tree']['decode_ms']:.4f}", flush=True)
    t = tcode.group_code.tensors(dev)
    blocks = [torch.block_diag(*[t[k]] * tcode.groups)
              for k in ("w_masked_re", "w_masked_im")]
    out["encode_ms"] = {
        "block_diagonal": time_ms(lambda: coded.complex_matmul(*blocks,
                                                               grads), 10),
        "a_launch_a_group": time_ms(lambda: topology.encode_tree(tcode,
                                                                 grads), 10)}
    enc = topology.encode_tree(tcode, grads)
    ref = coded.complex_matmul(*blocks, grads)
    out["encode_block_diagonal_max_abs_diff"] = max(
        (a - b).abs().max().item() for a, b in zip(enc, ref))
    del enc, ref
    print(f"tree encode at n={n}, d={d}: a launch a group (the port's) "
          f"{out['encode_ms']['a_launch_a_group']:.4f} ms, one launch of the "
          f"block-diagonal matrix {out['encode_ms']['block_diagonal']:.4f} "
          f"ms; the two differ by at most "
          f"{out['encode_block_diagonal_max_abs_diff']:.3e}", flush=True)
    return out


def twin_checks(legs, dev, ds) -> dict:
    """Each segmented leg against its S = 1 twin (registry.TWINS): on every
    eager step and every step of the timed chunk, the detection columns
    equal; and the first step's decoded aggregate, from a fresh setup of
    each, within the CPU step tests' tolerance of the twin's in relative L2
    norm: 1e-2 (test_torch_step), 5e-2 on the int8 wire
    (test_torch_approx_step). A segment whose locator keeps another
    neighbour of the adversary (``DETECT``) recombines other rows, which
    carry other int8 rounding: the two decodes then differ at the wire's
    quantization, not at f32 rounding; with the same honest sets they are
    bit for bit (each column summed as the whole-d kernel sums it)."""
    by = {lg["leg"]: lg for lg in legs}
    out = {}
    for leg, twin in registry.TWINS.items():
        a, b = by[leg], by[twin]
        for what, ra, rb in (("eager", a["records"], b["records"]),
                             ("chunk", a["chunk"]["records"],
                              b["chunk"]["records"])):
            for x, y in zip(ra, rb):
                cols = {c: (x[c], y[c]) for c in DETECT if c in y}
                require(all(u == v for u, v in cols.values()),
                        f"twin {leg} / {twin}, {what} step: detection "
                        f"columns differ: {cols}")
        lp, tp = registry.get(leg), registry.get(twin)
        rec_a, agg_a = first_aggregate(lp, dev, ds)
        rec_b, agg_b = first_aggregate(tp, dev, ds)
        tol = 5e-2 if lp.config(True).wire_dtype == "int8" else 1e-2
        rel = ((agg_a - agg_b).norm() / agg_b.norm()).item()
        out[leg] = {"twin": twin, "rel_l2": rel, "tol": tol,
                    "max_abs_gap": (agg_a - agg_b).abs().max().item(),
                    "bitwise": _same_bits(agg_a, agg_b),
                    "honest_located": (rec_a["honest_located"],
                                       rec_b["honest_located"])
                    if "honest_located" in rec_b else None}
        require(rel <= tol and all(rec_a[c] == rec_b[c] for c in DETECT
                                   if c in rec_b),
                f"twin {leg} / {twin}: the first step's aggregate differs "
                f"by {rel:.3e} relative L2 (tol {tol}) or its detection "
                f"columns do: {rec_a} / {rec_b}")
        print(f"twin {leg} / {twin}: detection columns equal on every "
              f"eager and chunked step; first-step aggregate {rel:.3e} "
              f"relative L2 (tol {tol}), max gap "
              f"{out[leg]['max_abs_gap']:.3e}, bit for bit: "
              f"{out[leg]['bitwise']}; honest_located (leg, twin) "
              f"{out[leg]['honest_located']}", flush=True)
        del agg_a, agg_b
        gc.collect()
        torch.cuda.empty_cache()
    return out


def watch_twin_checks(dev, ds) -> dict:
    """Each watch leg against its leg without the observatory
    (registry.WATCH_TWINS), one step of each from a fresh setup (the ResNet
    legs under deterministic cuDNN): the aggregate the optimizer is handed
    bit for bit the twin's — the f32 decode alone feeds the update — and
    every column the twin has equal."""
    out = {}
    for leg, twin in registry.WATCH_TWINS.items():
        rec_a, agg_a = first_aggregate(registry.get(leg), dev, ds)
        rec_b, agg_b = first_aggregate(registry.get(twin), dev, ds)
        cols = [c for c in rec_b if c not in ("step", "step_ms")]
        same = _same_bits(agg_a, agg_b)
        require(same and all(rec_a[c] == rec_b[c] for c in cols),
                f"watch {leg} / {twin}: the update differs (aggregate bit "
                f"for bit: {same}) or a shared column does: {rec_a} / "
                f"{rec_b}")
        out[leg] = {"twin": twin, "aggregate_bitwise": same,
                    "columns_equal": len(cols)}
        print(f"watch {leg} / {twin}: the first step's aggregate bit for "
              f"bit the twin's, {len(cols)} shared columns equal", flush=True)
        del agg_a, agg_b
        gc.collect()
        torch.cuda.empty_cache()
    return out


def sr_twin_checks(legs) -> dict:
    """Each stochastically rounded leg against its nearest-rounding twin
    (registry.SR_TWINS): the detection columns equal on every eager step
    and every step of the timed chunk (the rounding moves no
    accusation)."""
    by = {lg["leg"]: lg for lg in legs}
    out = {}
    for leg, twin in registry.SR_TWINS.items():
        a, b = by[leg], by[twin]
        steps = 0
        for what, ra, rb in (("eager", a["records"], b["records"]),
                             ("chunk", a["chunk"]["records"],
                              b["chunk"]["records"])):
            for x, y in zip(ra, rb):
                cols = {c: (x[c], y[c]) for c in DETECT if c in y}
                require(all(u == v for u, v in cols.values()),
                        f"stochastic twin {leg} / {twin}, {what} step: "
                        f"detection columns differ: {cols}")
                steps += 1
        out[leg] = {"twin": twin, "steps": steps}
        print(f"stochastic twin {leg} / {twin}: detection columns equal on "
              f"{steps} eager and chunked steps", flush=True)
    return out


def replay_bitwise(name: str, fn) -> None:
    """``fn`` (a kernel wrapper's call on static inputs) launched directly,
    then captured alone in a CUDA graph (after a warm-up call on a side
    stream) and replayed: its outputs bit for bit."""
    def outs():
        r = fn()
        return [r] if isinstance(r, torch.Tensor) else list(r)

    direct = [t.clone() for t in outs()]
    current = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(current)
    with torch.cuda.stream(side):
        outs()
    current.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = outs()
    graph.replay()
    torch.cuda.synchronize()
    require(all(_same_bits(a, b) for a, b in zip(direct, captured)),
            f"{name}: its replay from a CUDA graph differs from a direct "
            f"launch")
    del graph, captured


def graph_replay_kernels(code, dev, cuts) -> list:
    """Each kernel of the legs (rows 1–9 of the kernel table, the vote's
    fingerprints and the segment kernels) captured in a
    graph, its replay bit for bit its direct launch, at the main paths'
    shapes: n=8, d=11,173,962 (the coded products, the narrow
    recombination at int8 and bf16 block 256, the approx decode f32 and
    int8 with rows 2 and 5 absent; the segment kernels at the segmented
    legs' cuts, their plans on the card before the capture), the locator
    at one column, the flash kernels at G=192, T=512, Dh=64."""
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    t = code.tensors(dev)
    grads = torch.randn((N, D), generator=g, device=dev)
    f = drng.projection_factors(SEED, D, dev)
    v_re, v_im = torch.randn((2, N), generator=g, device=dev)
    checked = []

    def check(name, fn):
        replay_bitwise(name, fn)
        checked.append(name)

    check("complex_matmul", lambda: coded.complex_matmul(
        t["w_masked_re"], t["w_masked_im"], grads))
    enc_re, enc_im = coded.complex_matmul(t["w_masked_re"],
                                          t["w_masked_im"], grads)
    check("complex_project", lambda: coded.complex_project(enc_re, enc_im, f))
    check("complex_recombine", lambda: coded.complex_recombine(
        v_re, v_im, enc_re, enc_im))
    e_re, e_im, pres = locator_columns(code, 1, (3,), (), dev, g)
    check("cyclic_locator", lambda: decode_kernels.cyclic_locator(
        code, e_re, e_im, pres, cyclic.HEALTH_REL_TOL))
    # the tree's form: two groups' columns, each with its own presence
    e_re, e_im, pres = group_columns(code, TREE_LOCATOR_CASES[0][1], dev, g)
    check("cyclic_locator [per-column presence, L=2]",
          lambda: decode_kernels.cyclic_locator(code, e_re, e_im, pres,
                                                cyclic.HEALTH_REL_TOL))
    for mode in ("int8", "bf16"):
        wire = (mode, numerics.narrow_wire_rows(enc_re, mode, BLOCK),
                numerics.narrow_wire_rows(enc_im, mode, BLOCK), BLOCK)
        check(f"cyclic_narrow_recombine [{mode}]",
              lambda: decode_kernels.cyclic_narrow_recombine(v_re, v_im,
                                                            wire))
        del wire
    layer = coded.segment_plan(cuts["shared_layer"], dev)
    seg4 = coded.segment_plan(cuts["shared_int8_seg4"], dev)
    vs_re, vs_im = torch.randn((2, layer.segments, N), generator=g,
                               device=dev)
    check("complex_project_segments [L=62]",
          lambda: coded.complex_project_segments(enc_re, enc_im, f, layer))
    check("complex_recombine_segments [L=62]",
          lambda: coded.complex_recombine_segments(vs_re, vs_im, enc_re,
                                                   enc_im, layer))
    for mode in ("int8", "bf16"):
        wire = (mode, numerics.narrow_wire_rows(enc_re, mode, BLOCK),
                numerics.narrow_wire_rows(enc_im, mode, BLOCK), BLOCK)
        check(f"cyclic_narrow_recombine_segments [{mode}, 4 segments]",
              lambda: decode_kernels.cyclic_narrow_recombine_segments(
                  vs_re[:4].contiguous(), vs_im[:4].contiguous(), wire,
                  seg4))
        del wire
    del enc_re, enc_im
    acode = approx.build_approx_code(N, 1.5)
    present = torch.ones(N, dtype=torch.bool)
    present[[2, 5]] = False
    vn = (approx.decode_weights(acode, present)[0] / N).to(dev)
    pres_f = present.float().to(dev)
    prow = approx.encode_shared(acode, grads)
    prow[[2, 5]] = 0.0
    check("approx_decode [f32]", lambda: decode_kernels.approx_decode(
        prow, grads, vn, pres_f))
    wire = ("int8", numerics.narrow_wire_rows(prow, "int8", BLOCK), BLOCK)
    check("approx_decode [int8]", lambda: decode_kernels.approx_decode(
        None, grads, vn, pres_f, wire))
    a, b = cuts["approx_int8_seg4"][1:3]
    check("approx_decode_segment [int8, segment 2]",
          lambda: decode_kernels.approx_decode_segment(
              None, grads, vn, pres_f, a, b, wire))
    del grads, prow, wire
    q, k, v, do = (torch.randn((G_LM, 512, 64), generator=g, device=dev)
                   for _ in range(4))
    o, lse = fa.flash_fwd(q, k, v)
    dcap = (do * o).sum(-1)
    check("flash_fwd", lambda: fa.flash_fwd(q, k, v))
    check("flash_dq", lambda: fa.flash_dq(q, k, v, do, lse, dcap))
    check("flash_dkv", lambda: fa.flash_dkv(q, k, v, do, lse, dcap))
    del q, k, v, do, o, lse, dcap
    rows = torch.randn((VOTE_N, D), generator=g, device=dev)
    salts = vote.salts_tensor((0x2545F491, 0x9E3779B9), dev)
    check("row_fingerprints", lambda: vote.row_fingerprints(rows, salts))
    print(f"graph replay: {len(checked)} kernel calls, each captured alone "
          f"and replayed bit for bit its direct launch: {checked}",
          flush=True)
    return checked


def lint_legs(dev) -> list:
    """The program lint (analysis/rules.py) of every leg at the width it
    ran, each built anew through the registry: one warm-up step, then the
    inspected step against the leg's manifest. It runs after every leg was
    timed: the profiler the lint runs stays attached to the process and
    slows each later kernel launch (a leg timed after a profiled step ran
    up to 40 ms a step slower, PERF.md §6)."""
    rows = []
    for lp in (registry.collect() + registry.collect_chunks()
               + registry.collect_guard() + registry.collect_autopilot()):
        # the memory live around each leg's lint (a step peak above its
        # budget late in a whole run shows here whether an earlier phase
        # left memory live)
        live_before = torch.cuda.memory_allocated(dev)
        program = lp.build(dev, full=True, dataset=dataset_of(
            registry.get(getattr(lp, "leg", lp.name))))
        row = {"leg": lp.name, "manifest_h2d_bytes":
               program.manifest.h2d_bytes, "live_before_bytes": live_before}
        try:
            row.update(lint_leg(lp.name, program))
        finally:
            del program
            gc.collect()
            torch.cuda.empty_cache()
            row["live_after_bytes"] = torch.cuda.memory_allocated(dev)
            print(f"audit lint memory {lp.name}: live "
                  f"{live_before / 2**30:.3f} GiB before its build, "
                  f"{row['live_after_bytes'] / 2**30:.3f} after", flush=True)
        rows.append(row)
    # the device tokens' chunk stages K step numbers and the masks, nothing
    # else: its measured bytes are its manifest's
    devgen = next(r for r in rows if r["leg"] == "chunk_lm_shared_flash_devgen")
    k = registry.get("chunk_lm_shared_flash_devgen").K
    want = k * (4 + N)
    got = devgen["rules"]["constant_bloat"]["h2d_bytes"]
    require(got == devgen["manifest_h2d_bytes"] == want,
            f"audit lint chunk_lm_shared_flash_devgen: {got} H2D bytes a "
            f"chunk, manifest {devgen['manifest_h2d_bytes']}, expected "
            f"{want} ({k} step numbers and {k} masks of {N})")
    print(f"audit lint chunk_lm_shared_flash_devgen: {got} H2D bytes a "
          f"chunk = {k} int32 step numbers + {k} masks of {N} bytes, no "
          f"tokens", flush=True)
    # a segmented leg's plan lives on the card from its setup: a step moves
    # the twin's host-to-device bytes
    h2d = {r["leg"]: r["rules"]["constant_bloat"]["h2d_bytes"] for r in rows}
    for leg, twin in registry.TWINS.items():
        require(h2d[leg] == h2d[twin], f"audit lint {leg}: {h2d[leg]} H2D "
                f"bytes a step, its twin {twin} {h2d[twin]}")
    # a guarded leg: no more syncs or fetches than its twin, its twin's
    # bytes (the fault plan's tensors went to the card at setup), the
    # approx certificate's staged bound (4 bytes a step) aside
    by = {r["leg"]: r for r in rows}
    pairs = dict(registry.GUARD_TWINS, chunk_simulate_guard_nan="chunk_simulate")
    for leg, twin in pairs.items():
        extra = (4 if registry.get(leg).config(True).approach == "approx"
                 else 0)
        bad = rules.twin_failures(by[leg], by[twin], extra)
        require(not bad, f"audit lint {leg} against {twin}: {bad}")
        print(f"audit lint {leg}: syncs, fetches and {h2d[leg]} H2D bytes "
              f"as its twin {twin}'s ({h2d[twin]} + {extra})", flush=True)
    # the LM's approx chunk: chunk_lm_shared_flash's syncs and fetches, its
    # bytes with the presence row for the adversary mask (n bytes each)
    # and the host solve's v/n and presence, 2·n·4 bytes a step, beside
    leg, twin = "chunk_lm_approx_flash", "chunk_lm_shared_flash"
    extra = registry.get(leg).K * 2 * N * 4
    bad = rules.twin_failures(by[leg], by[twin], extra)
    require(not bad, f"audit lint {leg} against {twin}: {bad}")
    print(f"audit lint {leg}: syncs, fetches and {h2d[leg]} H2D bytes as "
          f"{twin}'s ({h2d[twin]} + {extra}: v/n and the presence)",
          flush=True)
    # the layer stack and the sequence shards: lm_shared_flash's syncs,
    # fetches and bytes (the ring's hops and the head scatter are static
    # slices and permutes of tensors on the card); remat's step peak below
    # its twin's
    peak = {r["leg"]: r["rules"]["memory_budget"]["step_peak_bytes"]
            for r in rows}
    for leg, twin in registry.STACK_TWINS.items():
        bad = rules.twin_failures(by[leg], by[twin])
        syncs = [by[x]["rules"]["host_traffic"]["syncs"] for x in (leg, twin)]
        require(not bad and syncs[0] == syncs[1],
                f"audit lint {leg} against {twin}: {bad}, syncs {syncs}")
        print(f"audit lint {leg}: {syncs[0]} syncs and {h2d[leg]} H2D bytes "
              f"as its twin {twin}'s; step peak "
              f"{peak[leg] / 2**30:.2f} GiB, the twin's "
              f"{peak[twin] / 2**30:.2f}", flush=True)
    print(f"audit lint lm_big_shared_flash: step peak "
          f"{peak['lm_big_shared_flash'] / 2**30:.2f} GiB", flush=True)
    # the autopilot's chunk: chunk_simulate's syncs and fetches (the
    # autopilot decides inside the flush's one fetch), its bytes plus the
    # all-present schedule's K·n
    for ap_chunk in registry.collect_autopilot():
        leg, twin = ap_chunk.name, "chunk_simulate"
        extra = ap_chunk.K * N
        bad = rules.twin_failures(by[leg], by[twin], extra)
        require(not bad, f"audit lint {leg} against {twin}: {bad}")
        print(f"audit lint {leg}: syncs, fetches and {h2d[leg]} H2D bytes "
              f"as {twin}'s ({h2d[twin]} + {extra}: the presence rows)",
              flush=True)
    return rows


def lint_leg(name, program) -> dict:
    """One leg's lint row (program_lint.lint_leg), printed."""
    t0 = time.perf_counter()
    row = program_lint.lint_leg(program)
    row["seconds"] = time.perf_counter() - t0
    r = row["rules"]
    print(f"audit lint {name}: {'ok' if row['ok'] else 'FAIL'} "
          f"{row['failed_rules'] or ''} dtypes {r['dtype']['dtypes']}, "
          f"syncs {r['host_traffic']['syncs']}, h2d "
          f"{r['constant_bloat']['h2d_bytes']} B in "
          f"{r['constant_bloat']['h2d_copies']} copies (profiler "
          f"{r['constant_bloat']['profiler']['bytes']}, dispatcher "
          f"{r['constant_bloat']['dispatcher']['bytes']}; budget "
          f"{r['constant_bloat']['budget']}), step peak "
          f"{r['memory_budget']['step_peak_bytes'] / 2**30:.3f} GiB (budget "
          f"{r['memory_budget']['budget'] / 2**30:.2f}), absolute peak "
          f"{r['memory_budget']['peak_bytes'] / 2**30:.3f} GiB, "
          f"{r['in_place']['state_tensors']} state tensors in place, "
          f"{row['ops']} ops"
          + (f"; flush {r['host_traffic']['flush']}"
             if "flush" in r["host_traffic"] else ""), flush=True)
    require(row["ok"], f"{name}: the program lint failed "
            f"{row['failed_rules']}: " + "; ".join(
                r[k].get("error", "") for k in row["failed_rules"]))
    return row


def cross_device_check(dev) -> dict:
    """The coded step on the card against the same step on the CPU.

    (a) The decode alone at the main path's size: the received rows of a
    real encode with one reversed row, decoded on the card (the kernels)
    and on the CPU (the plain versions); the honest set must be equal and
    the decoded mean agree to 1e-5 of the largest batch gradient.
    (b) One shared-redundancy step of ResNet-18 (n=8, B=4) from the same
    seed, batch and draws on both devices: the discrete metrics must be
    equal, the loss agree to 1e-4 and the parameter update to 5e-2 in
    relative L2 norm — in f32 a pre-activation within rounding of a ReLU
    kink can land on the other side of it on one device, and at a batch of
    a few samples one such unit moves the gradient by ~0.5% (measured
    5.4e-3 on an H100)."""
    code = cyclic.build_cyclic_code(N, S)
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    grads = torch.randn((N, D), generator=g, device=dev)
    t = code.tensors(dev)
    enc = coded.complex_matmul(t["w_masked_re"], t["w_masked_im"], grads)
    mask = torch.zeros(N, dtype=torch.bool, device=dev)
    mask[4] = True
    enc = attacks.inject_cyclic(*enc, mask, "rev_grad")
    f = drng.projection_factors(SEED, D)
    dec_c, hon_c = cyclic.decode(code, *enc, f.to(dev))
    dec_p, hon_p = cyclic.decode(code, enc[0].cpu(), enc[1].cpu(), f)
    require(torch.equal(hon_c.cpu(), hon_p) and not bool(hon_p[4]),
            f"decode: honest set cuda {hon_c.tolist()} cpu {hon_p.tolist()}")
    scale = grads.abs().max().item()
    dec_err = (dec_c.cpu() - dec_p).abs().max().item()
    mean_err = (dec_c - grads.mean(0)).abs().max().item()
    print(f"check decode cuda vs cpu (n=8, d={D}, row 4 reversed): "
          f"max_abs_err {dec_err:.3e}, vs the true mean {mean_err:.3e} "
          f"(tol {1e-5 * scale:.3e})", flush=True)
    require(dec_err <= 1e-5 * scale and mean_err <= 1e-5 * scale,
            f"decode err {dec_err} / {mean_err} > {1e-5 * scale}")
    del grads, enc, dec_c

    cfg = TrainConfig(network="ResNet18", dataset="synthetic-cifar10",
                      approach="cyclic", redundancy="shared", num_workers=N,
                      worker_fail=S, err_mode="rev_grad", batch_size=4,
                      max_steps=1, train_dir="", seed=SEED)
    (rc, dc), (rp, dp) = (_trainer_step(cfg, d) for d in (dev, "cpu"))
    for k in ("honest_located", "located_errors", "det_tp", "det_adv"):
        require(rc[k] == rp[k], f"cross-device: {k} cuda {rc[k]} cpu {rp[k]}")
    rel = ((dc - dp).norm() / dp.norm()).item()
    print(f"check step cuda vs cpu (shared, n=8 B=4): update relative L2 "
          f"err {rel:.3e} (tol 5e-2); loss cuda {rc['loss']:.6f} cpu "
          f"{rp['loss']:.6f}", flush=True)
    require(abs(rc["loss"] - rp["loss"]) <= 1e-4 * abs(rp["loss"]),
            f"cross-device loss {rc['loss']} vs {rp['loss']}")
    require(rel <= 5e-2, f"cross-device update relative err {rel} > 5e-2")
    return {"decode_max_abs_err": dec_err, "decode_vs_mean_err": mean_err,
            "update_rel_l2_err": rel, "loss_cuda": rc["loss"],
            "loss_cpu": rp["loss"]}


def _trainer_step(cfg, dev) -> tuple:
    """One small ResNet step through the Trainer on ``dev``: its record and
    the parameter update as one flat host vector."""
    ds = load_dataset("synthetic-cifar10", synthetic_train=256,
                      synthetic_test=16)
    tr = Trainer(cfg, device=dev, dataset=ds, quiet=True)
    before = {k: v.detach().cpu().clone() for k, v in tr.state.params.items()}
    rec = tr.step()
    delta = torch.cat([(tr.state.params[k].detach().cpu() - before[k])
                       .reshape(-1) for k in before])
    return rec, delta


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The raw bits of a host copy of ``t`` (NaN payloads included)."""
    t = t.cpu()
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32}[
        t.element_size()])


def wire_checks(dev) -> dict:
    """The narrow wire and the approx code on the card against the CPU.

    (a) The bf16 and int8 buffers (block 256) of one real shared encode at
    full size, quantized on the card and on the CPU from the same rows:
    equal level for level and scale for scale (both round to nearest even
    and divide by the same f32 scale); any difference is counted.
    (b) The narrow cyclic decode at full size (row 4 reversed, each wire's
    threshold and λ): equal honest sets, the attacked row out, and the
    decoded mean card vs CPU within 1e-5 of the largest batch gradient.
    (c) The approx decode at full size, rows 2 and 5 absent: v, bound and
    recovered_fraction to 1e-6 (the same host solve), the decoded mean
    within 1e-5 of the largest batch gradient, the residual to 1e-4
    relative.
    (d) One small approx step (n=8, B=4, 2 stragglers) through the
    Trainer: the presence and recovered_fraction equal, the loss to 1e-4
    relative and the update to 5e-2 in relative L2 norm (the ReLU-kink
    argument of cross_device_check)."""
    out = {}
    code = cyclic.build_cyclic_code(N, S)
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    grads = torch.randn((N, D), generator=g, device=dev)
    scale = grads.abs().max().item()
    t = code.tensors(dev)
    enc = coded.complex_matmul(t["w_masked_re"], t["w_masked_im"], grads)
    mask = torch.zeros(N, dtype=torch.bool, device=dev)
    mask[4] = True
    enc = attacks.inject_cyclic(*enc, mask, "rev_grad")
    enc_cpu = tuple(x.cpu() for x in enc)
    f = drng.projection_factors(SEED, D)
    for mode in ("bf16", "int8"):
        cfg = TrainConfig(approach="cyclic", num_workers=N, worker_fail=S,
                          wire_dtype=mode, shadow_block=BLOCK)
        wc = numerics.narrow_wire_pair(cfg, *enc)
        wp = numerics.narrow_wire_pair(cfg, *enc_cpu)
        diffs = sum(int((_bits(a[k]) != _bits(b[k])).sum())
                    for a, b in ((wc[2][1], wp[2][1]), (wc[2][2], wp[2][2]))
                    for k in a)
        print(f"check {mode} wire buffers cuda vs cpu (n=8, d={D}): "
              f"{diffs} elements differ", flush=True)
        require(diffs == 0, f"{mode} wire: {diffs} elements differ between "
                f"the card and the CPU")
        rel_tol, lam = numerics.wire_decode_params(cfg)
        dec_c, hon_c = cyclic.decode(code, wc[0], wc[1], f.to(dev),
                                     rel_tol=rel_tol, lam=lam, wire=wc[2])
        dec_p, hon_p = cyclic.decode(code, wp[0], wp[1], f, rel_tol=rel_tol,
                                     lam=lam, wire=wp[2])
        err = (dec_c.cpu() - dec_p).abs().max().item()
        print(f"check {mode} cyclic decode cuda vs cpu: honest "
              f"{hon_c.int().tolist()}, max_abs_err {err:.3e} (tol "
              f"{1e-5 * scale:.3e})", flush=True)
        require(torch.equal(hon_c.cpu(), hon_p) and not bool(hon_p[4]),
                f"{mode} decode: honest cuda {hon_c.tolist()} cpu "
                f"{hon_p.tolist()}")
        require(err <= 1e-5 * scale, f"{mode} decode err {err}")
        out[f"{mode}_wire"] = {"buffer_diffs": diffs, "decode_err": err}
        del wc, wp, dec_c
    del enc, enc_cpu

    acode = approx.build_approx_code(N, 1.5)
    present = torch.ones(N, dtype=torch.bool)
    present[[2, 5]] = False
    res = []
    for gr in (grads, grads.cpu()):
        rows = approx.encode_shared(acode, gr)
        res.append(approx.decode(acode, rows, gr, present=present))
    (dc, vc, hc), (dp, vp, hp) = res
    dec_err = (dc.cpu() - dp).abs().max().item()
    host_err = max((vc - vp).abs().max().item(),
                   abs(hc["bound"].item() - hp["bound"].item()),
                   abs(hc["recovered_fraction"].item()
                       - hp["recovered_fraction"].item()))
    r_rel = abs(hc["residual"].item() - hp["residual"].item()) / abs(
        hp["residual"].item())
    print(f"check approx decode cuda vs cpu (n=8, d={D}, rows 2 and 5 "
          f"absent): max_abs_err {dec_err:.3e} (tol {1e-5 * scale:.3e}); v, "
          f"bound, recovered_fraction err {host_err:.3e} (tol 1e-6); "
          f"residual {hc['residual'].item():.6f} vs "
          f"{hp['residual'].item():.6f} (bound {hp['bound'].item():.6f})",
          flush=True)
    require(dec_err <= 1e-5 * scale and host_err <= 1e-6 and r_rel <= 1e-4,
            f"approx decode: err {dec_err}, host {host_err}, residual rel "
            f"{r_rel}")
    out["approx_decode"] = {"decode_err": dec_err, "host_err": host_err,
                            "residual_rel_err": r_rel}
    del grads, res, dc

    cfg = TrainConfig(**dict(APPROX, network="ResNet18",
                             dataset="synthetic-cifar10", num_workers=N,
                             batch_size=4, max_steps=1, train_dir="",
                             seed=SEED))
    (rc, dc), (rp, dp) = (_trainer_step(cfg, d) for d in (dev, "cpu"))
    for k in ("present", "recovered_fraction"):
        require(rc[k] == rp[k], f"approx step: {k} cuda {rc[k]} cpu {rp[k]}")
    rel = ((dc - dp).norm() / dp.norm()).item()
    loss_rel = abs(rc["loss"] - rp["loss"]) / abs(rp["loss"])
    print(f"check approx step cuda vs cpu (n=8 B=4, 2 stragglers): update "
          f"relative L2 err {rel:.3e} (tol 5e-2); loss cuda "
          f"{rc['loss']:.6f} cpu {rp['loss']:.6f} (rel {loss_rel:.2e}, tol "
          f"1e-4)", flush=True)
    require(loss_rel <= 1e-4 and rel <= 5e-2,
            f"approx step: loss rel {loss_rel}, update rel {rel}")
    out["approx_step"] = {"update_rel_l2_err": rel, "loss_rel_err": loss_rel}
    return out


def _lm_step(cfg, dev, init=None) -> tuple:
    """One LM step through build_sp_train_setup and the token loop: its
    record and the parameter update as one flat host vector."""
    setup = build_sp_train_setup(cfg, dev, init=init)
    before = params_mod.flatten(setup.state.params, setup.layout).cpu()
    rec = TokenLoop(setup, cfg, quiet=True).step()
    delta = params_mod.flatten(setup.state.params, setup.layout).cpu() - before
    return rec, delta


def _compare_lm(label, a, b, loss_rtol, update_rtol) -> dict:
    (ra, da), (rb, db) = a, b
    for k in ("honest_located", "located_errors", "det_tp", "det_adv"):
        if k in ra:
            require(ra[k] == rb[k], f"{label}: {k} {ra[k]} vs {rb[k]}")
    loss_rel = abs(ra["loss"] - rb["loss"]) / abs(rb["loss"])
    rel = ((da - db).norm() / db.norm()).item()
    print(f"check {label}: loss {ra['loss']:.7f} vs {rb['loss']:.7f} (rel "
          f"{loss_rel:.2e}, tol {loss_rtol:g}); update relative L2 err "
          f"{rel:.3e} (tol {update_rtol:g})", flush=True)
    require(loss_rel <= loss_rtol, f"{label}: loss rel err {loss_rel}")
    require(rel <= update_rtol, f"{label}: update rel err {rel}")
    return {"loss_a": ra["loss"], "loss_b": rb["loss"],
            "loss_rel_err": loss_rel, "update_rel_l2_err": rel}


def lm_checks(dev) -> dict:
    """(a) One full-width LM step (shared redundancy, float32 compute, the
    same init and tokens) with attn_impl=dense and with flash on the card:
    the discrete decode equal, the losses to 1e-5 relative, the updates to
    1e-3 in relative L2 norm — the two attentions are the same float32
    function summed in another order, and the step has no ReLU kink to
    amplify that (GELU is smooth).
    (b) One small coded LM step (simulate, 24 lanes, flash, n=8, B=2,
    T=32, dim 64, 2 layers) on the card against the CPU through the plain
    versions, from the same host-drawn init: the same bounds."""
    full = TrainConfig(**dict(LM_FULL, approach="cyclic", redundancy="shared",
                              compute_dtype="float32", max_steps=1))
    flash = _lm_step(full, dev)
    torch.cuda.empty_cache()
    dense = _lm_step(dataclasses.replace(full, attn_impl="dense"), dev)
    torch.cuda.empty_cache()
    out = {"dense_vs_flash": _compare_lm(
        "LM step dense vs flash (full width, f32, shared)", flash, dense,
        1e-5, 1e-3)}
    small = TrainConfig(**dict(LM_FULL, approach="cyclic",
                               redundancy="simulate", compute_dtype="float32",
                               seq_len=32, vocab=64, model_dim=64,
                               model_heads=4, model_layers=2, max_steps=1))
    out["cuda_vs_cpu"] = _compare_lm(
        "LM step cuda vs cpu (simulate, small)", _lm_step(small, dev),
        _lm_step(small, "cpu"), 1e-5, 1e-3)
    return out


# --------------------------------------------------------------------------
# phase 7: the run state
# --------------------------------------------------------------------------

STATE_STEPS, STATE_EVERY = 12, 4  # the ResNet legs: eval and save every 4
LM_STATE_STEPS = 8


def _records(d: str) -> list:
    with open(os.path.join(d, "metrics.jsonl")) as f:
        return [json.loads(x) for x in f]


def _held(label: str, fin: dict, want: dict) -> None:
    gap = _differs(fin, want)
    require(not gap, f"state {label}: the final state is not the "
            f"uninterrupted run's bit for bit: {dict(list(gap.items())[:6])} "
            f"({len(gap)} of {len(want)} tensors differ)")


def _launched(label: str, counts: dict, want: dict, names) -> dict:
    """The wrappers' launches of a leg (the warm-up and the capture of its
    chunk's step: replays run the captured kernels without a wrapper
    call), each expected kernel among them, equal to the uninterrupted
    leg's."""
    got = {k: counts[k] for k in names}
    require(all(v > 0 for v in got.values()), f"state {label}: a kernel "
            f"of the path was not launched: {got}")
    ref = {k: want[k] for k in names}
    require(got == ref, f"state {label}: launches {got}, the "
            f"uninterrupted leg's {ref}")
    return got


def _timed_run(runner, **kw) -> tuple:
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    last = runner.run(**kw)
    return last, ops.launch_counts(), time.perf_counter() - t0


def _save_load(tr, d: str, step: int, compress: bool) -> dict:
    """Save the trainer's state at zlib level 1 or 0, then load it back in
    place: host wall ms of each (the save's copies off the card included,
    the load's onto it), and the file's bytes."""
    lay = tr.setup.layout
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = ckpt.save(d, step, tr.state.arrays(lay), compress=compress)
    save_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    tr.state.load(ckpt.load(d, step, tr.state.specs(lay)), lay)
    torch.cuda.synchronize()
    return {"level": int(compress), "save_ms": save_ms,
            "load_ms": (time.perf_counter() - t0) * 1e3,
            "bytes": os.path.getsize(path)}


def _stop_mid_chunk(tr, start: int) -> None:
    """Deliver SIGTERM through ``GracefulStop.deliver_signal`` from a
    timer thread while the card runs the chunk that starts at ``start``
    (its replays queued, the host waiting on the thread)."""
    make = tr.chunk_client

    def chunk_client(first, last):
        client = make(first, last)
        dispatch = client.dispatch

        def wrapped(state, chunk):
            out = dispatch(state, chunk)
            if chunk.start == start:
                timer = threading.Timer(0.005, tr._stop.deliver_signal,
                                        (signal.SIGTERM,))
                timer.start()
                timer.join()
            return out
        client.dispatch = wrapped
        return client
    tr.chunk_client = chunk_client


def status_held(label: str, train_dir: str, state: str, cfg) -> dict:
    """The run's status.json: schema 5 under the reference's check
    (``check_status_schema``), the terminal ``state``, the forensics block
    with the adversary accused on every observed step and the wire block
    of the run's wire ledger."""
    with open(os.path.join(train_dir, "status.json")) as f:
        status = json.load(f)
    heartbeat.check_status_schema(status, tool="chip_smoke")
    fx, wire = status.get("forensics", {}), status.get("wire", {})
    require(status.get("schema") == heartbeat.STATUS_SCHEMA
            and status.get("state") == state and status.get("run_id")
            and fx.get("num_workers") == cfg.num_workers
            and fx.get("accused_total") == fx.get("steps") > 0
            and wire.get("family") == cfg.approach
            and wire.get("num_workers") == cfg.num_workers,
            f"state {label}: status.json {status}")
    print(f"state {label}: status.json schema {status['schema']}, "
          f"{status['state']}, forensics {fx}, wire "
          f"{wire.get('physical_bytes_per_step')} bytes a step", flush=True)
    return status


# the resilience legs' steps: K eager, then the loop over two chunks
GUARD_STEPS = 2 * CHUNK_K
# each guard leg's skipped steps (the certificate decides the approx leg's)
GUARD_SKIPS = {"simulate_guard_nan": (2,), "shared_int8_over_budget": (3,),
               "approx_guard_watch": (),
               "lm_shared_flash_adamw_guard": (2,)}
GUARD_COLS = ("guard_trips", "skipped_steps")


def _same_value(a, b) -> bool:
    """Two record values equal, NaN equal to NaN."""
    if isinstance(a, float) and isinstance(b, float) and a != a:
        return b != b
    return a == b


def _guard_rows_held(label, eager, recs) -> None:
    for i, (a, b) in enumerate(zip(eager, recs)):
        cols = [c for c in b if c in a and c not in ("step", "step_ms")]
        bad = [c for c in cols if not _same_value(a[c], b[c])]
        require(not bad, f"guard {label} step {i + 1}: {bad} differ from the "
                f"eager run: {[(a[c], b[c]) for c in bad]}")


def _certificate_trips(r: dict, cfg) -> int:
    """The approx guard's trips on the host from a record's own columns:
    residual > bound + tol in float32, as the step compares them."""
    tol = np.float32(cfg.guard_residual_tol
                     + numerics.wire_residual_slack(cfg.wire_dtype))
    res = np.float32(r["decode_residual"])
    return int(not res <= np.float32(r["decode_residual_bound"]) + tol)


def _incidents_held(label, d, cfg) -> dict:
    """status.json through the schema check with its guard and incidents
    blocks; the live incidents block equal to an offline fold of the run's
    metrics.jsonl (``obs/replay.py``) at the run's own thresholds."""
    from draco_tpu_torch.obs import incidents, replay

    with open(os.path.join(d, "status.json")) as f:
        status = json.load(f)
    heartbeat.check_status_schema(status, tool="chip_smoke")
    require(status.get("state") == "done" and "guard" in status,
            f"guard {label}: status.json {status}")
    live = status.get("incidents")
    out = {"guard": status["guard"], "incidents": live}
    if cfg.incident_watch != "on":
        return out
    eng = incidents.IncidentEngine(num_workers=cfg.num_workers,
                                   thresholds=live["thresholds"])
    for r in replay.train_records(os.path.join(d, "metrics.jsonl")):
        eng.observe(r)
    require(eng.status_block() == live, f"guard {label}: the offline fold "
            f"{eng.status_block()} is not the live block {live}")
    out["events"] = list(replay.iter_jsonl(os.path.join(d,
                                                        "incidents.jsonl")))
    return out


def guard_leg(lp, dev, ds, root) -> dict:
    """One resilience leg (``registry.GUARD_PROGRAMS``) at full width, the
    ResNet legs under deterministic cuDNN: K eager steps from a snapshot
    with the launch counts zeroed before them, each step's guard columns
    and state held to the leg's fault (a skipped step leaves parameters,
    optimizer buffers, update count and BN statistics bit for bit as the
    step before); step 1 bit for bit its twin's step 1 (the same leg
    without the guard and the plan, ``registry.GUARD_TWINS``); the K=4
    chunk twice, each bit for bit the eager run, records and state; each
    leg's chunk timed beside its twin's; then the loop a user runs over
    two chunks into a train_dir: its records' guard columns, status.json
    (schema, ``guard`` and ``incidents`` blocks) and, with the incident
    watch, incidents.jsonl and the offline replay."""
    name, twin = lp.name, registry.GUARD_TWINS[lp.name]
    d = os.path.join(root, name)
    cnn = lp.route == "cnn"
    ctx = cudnn_deterministic() if cnn else contextlib.nullcontext()
    with ctx:
        program = lp.build(dev, full=True, max_steps=GUARD_STEPS,
                           steps_per_call=CHUNK_K,
                           dataset=ds if cnn else None, train_dir=d,
                           log_every=1)
        runner, cfg = program.runner, program.cfg
        require(runner.setup.decode_impl == "cuda",
                f"guard {name}: the locator resolved to "
                f"{runner.setup.decode_impl!r}")
        runs = _ChunkRuns(program)
        ops.reset_launch_counts()
        recs, states = [], []
        for _ in range(CHUNK_K):
            recs.append(runner.step())
            states.append(_state_copy(runner.state))
        counts = ops.launch_counts()
        runs.rewind()
        for k in EXPECT[twin] + ("nonfinite_rows",):
            require(counts[k] > 0, f"guard {name}: kernel {k} was never "
                    f"launched ({counts})")
        skips = GUARD_SKIPS[name]
        for r, fin in zip(recs, states):
            s = r["step"]
            if cfg.approach == "approx":
                want = _certificate_trips(r, cfg)
                require(r["guard_trips"] == want
                        and r["skipped_steps"] == float(want > 0),
                        f"guard {name} step {s}: {r}, the certificate "
                        f"gives {want} trips")
                # worker 3 absent on steps 2-3 (the plan), the seeded
                # stragglers beside it
                drop = runner.straggle_schedule[s]
                require(s not in (2, 3) or bool(drop[3]),
                        f"guard {name} step {s}: straggle row {drop}")
                require(r["wmask_present0"] == mask_word(~drop),
                        f"guard {name} step {s}: present word "
                        f"{r['wmask_present0']}, schedule row {drop}")
            elif s in skips:
                require(r["skipped_steps"] == 1.0 and r["guard_trips"] >= 1,
                        f"guard {name} step {s}: not skipped: {r}")
            else:
                require(r["skipped_steps"] == 0.0 and r["guard_trips"] == 0,
                        f"guard {name} step {s}: tripped: {r}")
            require(math.isfinite(r["loss"]) and all(
                bool(torch.isfinite(v).all()) for k, v in fin.items()
                if k.startswith("params/")),
                f"guard {name} step {s}: non-finite loss or parameters")
            if r["skipped_steps"] == 1.0 and s > 1:
                gap = _differs(fin, states[s - 2])
                require(not gap, f"guard {name} step {s}: the skipped step "
                        f"moved {dict(list(gap.items())[:6])}")
        if name == "simulate_guard_nan":
            victim = runner.fault_plan.events[0].worker
            require((int(recs[1]["wmask_accused0"]) >> victim) & 1,
                    f"guard {name}: the victim {victim} is not accused at "
                    f"step 2: {recs[1]}")
        if name == "lm_shared_flash_adamw_guard":
            count = int(states[-1]["opt/count"])
            require(count == CHUNK_K - len(skips), f"guard {name}: the "
                    f"update count is {count} after {CHUNK_K} steps")
        # the chunk twice, each bit for bit the eager run
        timed = []
        for again in (False, True):
            recs_c, ms, fin_c = runs.chunk_run()
            _guard_rows_held(name, recs, recs_c)
            gap = _differs(fin_c, states[-1])
            require(not gap, f"guard {name}: the chunk's state differs from "
                    f"the eager run's: {dict(list(gap.items())[:6])}")
            timed.append(ms)
        # the twin: its step 1 is the guarded step 1, its chunk timed
        tp = registry.get(twin).build(dev, full=True, max_steps=GUARD_STEPS,
                                      steps_per_call=CHUNK_K,
                                      dataset=ds if cnn else None)
        truns = _ChunkRuns(tp)
        tp.runner.step()
        gap = _differs(_state_copy(tp.runner.state), states[0])
        require(not gap, f"guard {name}: step 1 differs from {twin}'s step "
                f"1: {dict(list(gap.items())[:6])}")
        truns.rewind()
        twin_ms = [truns.chunk_run()[1] for _ in range(2)]
        del tp, truns
        gc.collect()
        torch.cuda.empty_cache()
        # the guard alone: the twin with step_guard=on and no fault plan
        gp = registry.get(twin).build(dev, full=True, max_steps=GUARD_STEPS,
                                      steps_per_call=CHUNK_K,
                                      dataset=ds if cnn else None,
                                      step_guard="on")
        gruns = _ChunkRuns(gp)
        guard_only_ms = [gruns.chunk_run()[1] for _ in range(2)]
        del gp, gruns
        gc.collect()
        torch.cuda.empty_cache()
        # the loop a user runs, from step 1 into the train_dir
        last = runner.run()
    require(last["step"] == GUARD_STEPS, f"guard {name}: the loop ended at "
            f"{last}")
    loop_recs = [r for r in _records(d) if "loss" in r]
    require([r["step"] for r in loop_recs] == list(range(1, GUARD_STEPS + 1)),
            f"guard {name}: the loop wrote steps "
            f"{[r['step'] for r in loop_recs]}")
    _guard_rows_held(name, recs, loop_recs[:CHUNK_K])
    for r in loop_recs[CHUNK_K:]:
        require(r["skipped_steps"] == 0.0 and math.isfinite(r["loss"]),
                f"guard {name} step {r['step']}: {r}")
    held = _incidents_held(name, d, cfg)
    skipped = sum(r["skipped_steps"] for r in loop_recs)
    require(held["guard"]["skipped_steps"] == skipped,
            f"guard {name}: status.json guard {held['guard']}, the records "
            f"skip {skipped}")
    if name == "simulate_guard_nan":
        onsets = [e for e in held["events"] if e["event"] == "onset"
                  and e["type"] == "guard"]
        require(onsets and victim in (onsets[0]["workers"] or ()),
                f"guard {name}: incidents.jsonl {held['events']}, victim "
                f"{victim}")
    out = {"leg": name, "twin": twin, "records": recs,
           "loop_records": loop_recs, "launches": counts,
           "chunk_ms_per_step": timed[1], "twin_chunk_ms_per_step": twin_ms[1],
           "guard_only_chunk_ms_per_step": guard_only_ms[1],
           "guard_cost_ms_per_step": guard_only_ms[1] - twin_ms[1],
           "cudnn_deterministic": cnn, **held}
    print(f"guard {name}: steps 1-{CHUNK_K} guard columns "
          f"{[(r['guard_trips'], r['skipped_steps']) for r in recs]}, the "
          f"skipped steps' state bit for bit the step before's, step 1 bit "
          f"for bit {twin}'s, the K={CHUNK_K} chunk twice bit for bit the "
          f"eager run; chunk {timed[1]:.3f} ms/step against {twin}'s "
          f"{twin_ms[1]:.3f} and the guard alone's {guard_only_ms[1]:.3f} "
          f"(CUDA events, "
          f"{'deterministic cuDNN' if cnn else 'default settings'}); the "
          f"loop over {GUARD_STEPS} steps: status.json guard {held['guard']}"
          f", incidents {held['incidents']}", flush=True)
    del program, runner, runs
    gc.collect()
    torch.cuda.empty_cache()
    return out


def guard_phase(dev, ds) -> dict:
    """Phase 8: the resilience legs (``guard_leg``); the lint (phase 5,
    ``lint_legs``) holds each to its twin."""
    root = tempfile.mkdtemp(prefix="chip_smoke_guard_")
    try:
        return {lp.name: guard_leg(lp, dev, ds, root)
                for lp in registry.GUARD_PROGRAMS}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def host_fault_run(dev, ds, root: str) -> dict:
    """Preset cyclic-resnet18 at ``shared``, K=4, 8 steps, eval and save
    every 3, under deterministic cuDNN: ``prefetch_crash@2,sigterm@5``
    (the crash retried by the supervised prefetcher; the sigterm due at
    the chunk that ends at 6, where the run stops with its checkpoint and
    status.json ends ``preempted`` with ``resumable_step`` 6), then the
    resume from −1 to step 8 with the crash alone: the final state bit for
    bit an uninterrupted run's with ``prefetch_crash@2``."""
    cfg = presets.get_preset(
        "cyclic-resnet18", redundancy="shared", num_workers=N,
        steps_per_call=CHUNK_K, eval_freq=3, max_steps=8,
        test_batch_size=1000, train_dir="", log_every=1)

    def trainer(d, **fields):
        return Trainer(dataclasses.replace(cfg, train_dir=d, **fields),
                       device=dev, dataset=ds, quiet=True)

    a_dir, b_dir = (os.path.join(root, "faults_" + x) for x in "ab")
    gc.collect()  # the earlier runs' setups and their graphs
    torch.cuda.empty_cache()
    with cudnn_deterministic():
        tr = trainer(a_dir, fault_spec="prefetch_crash@2")
        last = tr.run()
        want = _state_copy(tr.state)
        require(last["step"] == 8, f"host faults: the uninterrupted run "
                f"ended at {last}")
        del tr
        tr = trainer(b_dir, fault_spec="prefetch_crash@2,sigterm@5")
        tr.run()
        stopped = tr.stopped_step
        del tr
        with open(os.path.join(b_dir, "status.json")) as f:
            status = json.load(f)
        heartbeat.check_status_schema(status, tool="chip_smoke")
        require(stopped == 6 and status.get("state") == "preempted"
                and status.get("resumable_step") == 6
                and status.get("prefetch_restarts", 0) >= 1,
                f"host faults: stopped at {stopped}, status.json {status}")
        tr = trainer(b_dir, fault_spec="prefetch_crash@2", checkpoint_step=-1)
        require(tr.state.step == 7, f"host faults: resumed at "
                f"{tr.state.step}")
        last = tr.run()
        _held("host faults (resumed)", _state_copy(tr.state), want)
        del tr
    gc.collect()
    torch.cuda.empty_cache()
    print(f"state host faults: prefetch_crash@2 retried and masked "
          f"(prefetch_restarts {status['prefetch_restarts']}), sigterm@5 "
          f"stopped the run at 6 (status.json preempted, resumable_step 6), "
          f"resumed from -1 to 8: the state bit for bit the uninterrupted "
          f"run's ({len(want)} tensors)", flush=True)
    return {"stopped_step": stopped, "status": status, "last": last,
            "state_tensors": len(want)}


def state_resnet(dev, ds, root: str) -> dict:
    """Preset cyclic-resnet18 at n=8, ``shared``, K=4, eval and checkpoint
    every 4 of 12 steps, all under deterministic cuDNN: the uninterrupted
    run; the resume from 4 on its own setup, whose graph already replayed;
    the walk-back past a corrupt newest checkpoint on a fresh setup; a
    SIGTERM mid-chunk and its resume from −1. Each final state bit for bit
    the uninterrupted run's."""
    cfg = presets.get_preset(
        "cyclic-resnet18", redundancy="shared", num_workers=N,
        steps_per_call=CHUNK_K, eval_freq=STATE_EVERY,
        max_steps=STATE_STEPS, test_batch_size=1000, train_dir="")

    def trainer(d, **fields):
        return Trainer(dataclasses.replace(cfg, train_dir=d, **fields),
                       device=dev, dataset=ds, quiet=True)

    names = EXPECT["shared"]
    out = {}
    a_dir = os.path.join(root, "resnet")
    with cudnn_deterministic():
        tr = trainer(a_dir)
        last, counts, wall = _timed_run(tr)
        require(last["step"] == STATE_STEPS and located("shared", last, cfg),
                f"state resnet: the last record {last}")
        want = {k: counts[k] for k in names}
        _launched("resnet", counts, want, names)
        evals = [r for r in _records(a_dir) if "prec1_test" in r]
        require([r["step"] for r in evals] == [4, 8, 12]
                and all(0.0 <= r["prec1_test"] <= r["prec5_test"] <= 1.0
                        for r in evals), f"state resnet: evals {evals}")
        require(ckpt.available_steps(a_dir) == [4, 8, 12],
                f"state resnet: checkpoints {ckpt.available_steps(a_dir)}")
        final = _state_copy(tr.state)
        status = status_held("uninterrupted", a_dir, "done", cfg)
        out["uninterrupted"] = {"wall_s": wall, "evals": evals,
                                "launches": want, "state_tensors": len(final),
                                "status": status}

        # resume from 4 on the same setup: its graph captured and replayed
        graph = tr.setup.train_many.graph()
        ptrs = {k: v.data_ptr() for k, v in tr.state.tensors().items()}
        require(tr.restore(4) == 4 and tr.state.step == 5,
                "state resume_4: restore")
        require({k: v.data_ptr() for k, v in tr.state.tensors().items()}
                == ptrs, "state resume_4: a restored tensor moved")
        last4, counts4, wall4 = _timed_run(tr)
        require(tr.setup.train_many.graph() is graph
                and not any(counts4[k] for k in names),
                f"state resume_4: recaptured, launches {counts4}")
        _held("resume_4", _state_copy(tr.state), final)
        out["resume_4_same_setup"] = {"wall_s": wall4, "graph_reused": True,
                                      "launches": {k: counts4[k]
                                                   for k in names}}

        # sizes and times of the step-12 state; then the eval's
        out["ckpt"] = [_save_load(tr, os.path.join(root, f"level{c}"),
                                  STATE_STEPS, bool(c)) for c in (0, 1)]
        _held("save and load", _state_copy(tr.state), final)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = tr.evaluate(STATE_STEPS)
        out["eval_ms"] = (time.perf_counter() - t0) * 1e3
        require(rec["prec1_test"] == evals[-1]["prec1_test"],
                f"state eval: {rec} against the run's {evals[-1]}")

        # walk-back: the newest checkpoint's byte flipped, a fresh setup
        w_dir = os.path.join(root, "walkback")
        shutil.copytree(a_dir, w_dir)
        path = os.path.join(w_dir, f"model_step_{STATE_STEPS}.dcg")
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) // 2)
            byte = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([byte[0] ^ 0xFF]))
        trw = trainer(w_dir, checkpoint_step=-1)
        require(trw.state.step == 9, f"state walkback: resumed at "
                f"{trw.state.step}, not after step 8")
        _, counts_w, wall_w = _timed_run(trw)
        _held("walkback", _state_copy(trw.state), final)
        out["walkback_to_8"] = {"wall_s": wall_w, "launches": _launched(
            "walkback", counts_w, want, names)}
        del trw

        # SIGTERM mid-chunk (steps 5-8), then the resume from -1
        s_dir = os.path.join(root, "stop")
        trs = trainer(s_dir)
        _stop_mid_chunk(trs, 5)
        _, counts_s, wall_s = _timed_run(trs)
        require(trs.stopped_step == 8
                and ckpt.available_steps(s_dir) == [4, 8],
                f"state stop: stopped at {trs.stopped_step}, checkpoints "
                f"{ckpt.available_steps(s_dir)}")
        _launched("stop", counts_s, want, names)
        stopped = status_held("stop", s_dir, "preempted", cfg)
        require(stopped.get("resumable_step") == 8,
                f"state stop: status.json {stopped}")
        del trs
        trr = trainer(s_dir, checkpoint_step=-1)
        require(trr.state.step == 9, "state stop: resumed at "
                f"{trr.state.step}")
        _, counts_r, wall_r = _timed_run(trr)
        _held("stop and resume", _state_copy(trr.state), final)
        out["sigterm_at_8_resume"] = {
            "wall_s": [wall_s, wall_r],
            "launches": _launched("stop resume", counts_r, want, names)}
        del trr
    gc.collect()
    torch.cuda.empty_cache()

    # the evaluator process over the run's checkpoints, against
    # Trainer.evaluate at the same (default) cuDNN settings
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "draco_tpu_torch.training.evaluator",
         "--preset", "cyclic-resnet18", "--redundancy", "shared",
         "--num-workers", str(N), "--train-dir", a_dir,
         "--test-batch-size", "1000", "--once"],
        capture_output=True, text=True, timeout=600)
    require(proc.returncode == 0, f"state evaluator: rc {proc.returncode}: "
            f"{proc.stderr[-2000:]}")
    got = {int(s): p for s, p in re.findall(
        r"Cur Step:(\d+) Prec@1: ([0-9.]+)", proc.stdout)}
    mine = {}
    for step in (4, 8, STATE_STEPS):
        tr.restore(step)
        mine[step] = f"{tr.evaluate(step)['prec1_test']:.4f}"
    require(got == mine, f"state evaluator: {got}, Trainer.evaluate {mine}")
    out["evaluator"] = {"prec1": got, "wall_s": time.perf_counter() - t0}
    del tr
    return out


def state_lm(dev, root: str) -> dict:
    """``lm_shared_flash`` at full width, K=4: 8 steps with the held-out
    loss and a checkpoint at 4 and 8; then, on a fresh setup, resumed from
    4 for 4 more steps (``checkpoint_step``, the reference's LM
    semantics): the state at 8 bit for bit. A held-out eval launches the
    forward kernel outside the graph, once a layer: each run's launches
    less its evals' are the capture's, equal in both."""
    d = os.path.join(root, "lm")
    cfg = registry.get("lm_shared_flash").config(
        True, max_steps=LM_STATE_STEPS, steps_per_call=CHUNK_K,
        eval_freq=STATE_EVERY, train_dir=d)
    names = EXPECT["lm_shared_flash"]

    def leg(c):
        loop = TokenLoop(build_sp_train_setup(c, dev), c, quiet=True)
        first = loop.state.step
        last, counts, wall = _timed_run(
            loop, max_steps=loop.state.step - 1 + LM_STATE_STEPS // 2
            if c.checkpoint_step else None)
        evals = (LM_STATE_STEPS - first + 1) // STATE_EVERY
        ops.reset_launch_counts()
        loop.eval_loss()
        one = ops.launch_counts()
        captured = {k: counts[k] - evals * one[k] for k in names}
        return loop, last, captured, wall

    loop, last, want, wall = leg(cfg)
    _launched("lm", want, want, names)
    require(ckpt.available_steps(d) == [4, 8] and last["step"] == 8,
            f"state lm: checkpoints {ckpt.available_steps(d)}, last {last}")
    final = _state_copy(loop.state)
    del loop
    gc.collect()
    torch.cuda.empty_cache()
    rloop, rlast, got, wall_r = leg(dataclasses.replace(cfg,
                                                        checkpoint_step=4))
    require(rlast["step"] == 8 and rlast["loss"] == last["loss"],
            f"state lm resume: {rlast} against {last}")
    _held("lm resume", _state_copy(rloop.state), final)
    out = {"wall_s": [wall, wall_r], "state_tensors": len(final),
           "launches": _launched("lm resume", got, want, names),
           "evals": [r for r in _records(d) if r.get("split") == "eval"],
           "dcg_bytes": os.path.getsize(os.path.join(d, "model_step_8.dcg"))}
    del rloop
    gc.collect()
    torch.cuda.empty_cache()
    return out


def state_phase(dev, ds) -> dict:
    """Phase 7 (module docstring)."""
    root = tempfile.mkdtemp(prefix="chip_smoke_state_")
    try:
        out = {"resnet": state_resnet(dev, ds, root)}
        out["host_faults"] = host_fault_run(dev, ds, root)
        out["lm"] = state_lm(dev, root)
        d = os.path.join(root, "lenet")
        t0 = time.perf_counter()
        last = single_machine.main(["--preset", "single-lenet",
                                    "--max-steps", "12", "--eval-freq", "4",
                                    "--train-dir", d])
        require(last["step"] == 12 and math.isfinite(last["loss"])
                and ckpt.available_steps(d) == [4, 8, 12],
                f"state single_machine: {last}, checkpoints "
                f"{ckpt.available_steps(d)}")
        out["single_machine"] = {
            "last": last, "wall_s": time.perf_counter() - t0,
            "evals": [r for r in _records(d) if "prec1_test" in r]}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rn = out["resnet"]
    lv = {c["level"]: c for c in rn["ckpt"]}
    p1 = [round(r["prec1_test"], 4) for r in rn["uninterrupted"]["evals"]]
    print(f"state: ResNet-18 shared n=8 K=4, 12 steps: eval at 4/8/12 "
          f"prec1_test {p1}"
          f" (2048 images at batch 1000, {rn['eval_ms']:.1f} ms an eval); "
          f"resumed from 4 on the same setup (graph reused), walked back "
          f"past a corrupt step 12 to 8, SIGTERM mid-chunk stopped at 8 and "
          f"resumed from -1: each final state bit for bit "
          f"({rn['uninterrupted']['state_tensors']} tensors), launches "
          f"{rn['uninterrupted']['launches']} in each capture; .dcg level 0 "
          f"{lv[0]['bytes']} B (save {lv[0]['save_ms']:.1f} ms, load "
          f"{lv[0]['load_ms']:.1f} ms), level 1 {lv[1]['bytes']} B (save "
          f"{lv[1]['save_ms']:.1f} ms, load {lv[1]['load_ms']:.1f} ms); the "
          f"evaluator process's prec1 {rn['evaluator']['prec1']} = "
          f"Trainer.evaluate's; LM full width K=4 resumed from 4: the state "
          f"at 8 bit for bit ({out['lm']['state_tensors']} tensors, .dcg "
          f"{out['lm']['dcg_bytes']} B, launches {out['lm']['launches']}); "
          f"single_machine single-lenet 12 steps loss "
          f"{out['single_machine']['last']['loss']:.4f}", flush=True)
    return out


# ---- phase 9: the autopilot -------------------------------------------------
# the reference's compressed policy and detector threshold
# (tests/test_autopilot.py), its lifecycle's fault plan, and the segment
# rung's (tests/test_segments.py)
AP_POLICY = ("dial_down_boundaries=1,clean_boundaries=1,"
             "dial_up_boundaries=2,readmit_boundaries=2,"
             "segments_up_boundaries=99")
AP_THRESHOLDS = "straggle.streak=2"
AP_LIFECYCLE = dict(max_steps=32, autopilot_policy=AP_POLICY,
                    fault_spec="adversary@3-8:w2,straggle@13-20:w5")
AP_SEGMENTS = dict(max_steps=20, fault_spec="straggle@5-12:w5",
                   autopilot_policy=(
                       "segments_up_boundaries=1,segments_max=2,"
                       "segments_down_boundaries=1,dial_down_boundaries=99,"
                       "clean_boundaries=99"))
# the reference's LM dial (tests/test_autopilot.py test_autopilot_dial_lm_sp)
# at K=1 with device tokens
# at K=1 with device tokens; without eval boundaries the engine flushes
# every 4 one-step chunks, the reference's boundaries at eval_freq=4,
# without a checkpoint at each (a 0.5 GB LM state)
AP_DIAL_K1 = dict(max_steps=24, autopilot_policy=AP_POLICY,
                  fault_spec="straggle@3-10:w5", steps_per_call=1,
                  token_gen="device", eval_freq=0)
AP_ORDERS = (["quarantine", "readmit", "dial_down", "dial_up"],
             ["quarantine", "dial_down", "readmit", "dial_up"])
AP_KERNELS = {"cyclic_r3": ("complex_matmul", "complex_project",
                            "cyclic_locator", "complex_recombine"),
              "approx_r1.5": ("approx_decode",),
              "cyclic_r3_seg2": ("complex_project_segments",
                                 "complex_recombine_segments")}
PIPE_SEGMENTS = (2, 4)
PIPE_REPS = 7  # timed runs of each rail, in turns


@contextlib.contextmanager
def autopilot_watch(tr, client_cls):
    """Instruments one autopilot run of the loop ``tr`` (a Trainer or a
    TokenLoop) whose engine client is a ``client_cls`` (class-level wraps,
    undone on exit): each dispatch's chunk by CUDA events with its regime
    label, each capture's wall with the shared state held bit for bit
    across it (a regime captured mid-run: the state its first replay reads
    is the state the previous graph left), each ``act``'s host wall and
    each setup build and chunk re-make."""
    from draco_tpu_torch.training.chunk_graph import StepGraph

    log = {"chunks": [], "captures": [], "acts": [], "builds": [],
           "remakes": [], "peaks": []}
    wrapped = ("dispatch", "build_setup", "remake")
    own = {k: client_cls.__dict__.get(k) for k in wrapped}
    orig = {"dispatch": client_cls.dispatch,
            "build": client_cls.build_setup,
            "remake": client_cls.remake,
            "capture": StepGraph._capture}

    def dispatch(self, state, chunk):
        before = len(log["captures"])
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = orig["dispatch"](self, state, chunk)
        b.record()
        log["chunks"].append({"label": self.label, "start": chunk.start,
                              "k": chunk.k, "events": (a, b),
                              "captured": len(log["captures"]) > before})
        return out

    def capture(self):
        # the capture resets the peak counters (its pool's measure): keep
        # the run's peaks so far
        log["peaks"].append((torch.cuda.max_memory_allocated(),
                             torch.cuda.max_memory_reserved()))
        held = bool(log["captures"])  # a regime captured mid-run
        snap = _state_copy(tr.state) if held else None
        t0 = time.perf_counter()
        orig["capture"](self)
        wall = time.perf_counter() - t0
        if held:
            gap = _differs(_state_copy(tr.state), snap)
            require(not gap, f"autopilot {self.name}: the capture moved the "
                    f"shared state: {dict(list(gap.items())[:6])}")
        log["captures"].append({"graph": id(self), "name": self.name,
                                "wall_s": wall,
                                "state_held": held,
                                "pool_bytes": self.pool_bytes})

    def timed(key, fn):
        def wrapped(self, *a):
            t0 = time.perf_counter()
            out = fn(self, *a)
            log[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapped

    client_cls.dispatch = dispatch
    client_cls.build_setup = timed("builds", orig["build"])
    client_cls.remake = timed("remakes", orig["remake"])
    StepGraph._capture = capture
    pilot = tr._make_autopilot()
    act = pilot.act

    def timed_act(step, engine):
        swaps = pilot.swaps
        t0 = time.perf_counter()
        act(step, engine)
        log["acts"].append({"step": step,
                            "ms": (time.perf_counter() - t0) * 1e3,
                            "swapped": pilot.swaps > swaps})
    pilot.act = timed_act
    try:
        yield log
    finally:
        for k in wrapped:  # the class's own methods back, or the base's
            if own[k] is None:
                delattr(client_cls, k)
            else:
                setattr(client_cls, k, own[k])
        StepGraph._capture = orig["capture"]
        del pilot.act


def autopilot_run(label, fields, dev, ds, root) -> tuple:
    """One autopilot run of preset cyclic-resnet18's shapes (``shared``,
    n=8, K=4, step_guard and incident_watch on) through the Trainer a user
    runs, with the launch counts zeroed just before it and read just
    after; returns (trainer, train_dir, watch log, counts, remediations,
    records, status)."""
    from draco_tpu_torch.control.clients import TrainerChunkClient

    d = os.path.join(root, label)
    cfg = TrainConfig(**{
        **registry.CNN_FULL, "approach": "cyclic", "redundancy": "shared",
        "adversary_count": 0, "steps_per_call": CHUNK_K, "eval_freq": 4,
        "log_every": 1, "test_batch_size": 1000, "step_guard": "on",
        "incident_watch": "on", "autopilot": "on",
        "incident_thresholds": AP_THRESHOLDS, "train_dir": d, **fields})
    tr = Trainer(cfg, device=dev, dataset=ds, quiet=True)
    return autopilot_drive(label, tr, TrainerChunkClient, cfg, d, dev)


def lm_autopilot_run(label, fields, dev, root) -> tuple:
    """The lifecycle on the LM at ``LM_FULL`` (``shared``, s=1, no
    declared adversary, K=4, step_guard and incident_watch on) through
    build_sp_train_setup and the TokenLoop a user runs; returns what
    ``autopilot_run`` does."""
    from draco_tpu_torch.control.clients import TokenChunkClient

    d = os.path.join(root, label)
    cfg = TrainConfig(**{
        **LM_FULL, "approach": "cyclic", "redundancy": "shared",
        "adversary_count": 0, "steps_per_call": CHUNK_K, "eval_freq": 4,
        "log_every": 1, "keep_checkpoints": 1, "step_guard": "on",
        "incident_watch": "on", "autopilot": "on",
        "incident_thresholds": AP_THRESHOLDS, "train_dir": d, **fields})
    tr = TokenLoop(build_sp_train_setup(cfg, dev), cfg, quiet=True)
    return autopilot_drive(label, tr, TokenChunkClient, cfg, d, dev)


def autopilot_drive(label, tr, client_cls, cfg, d, dev) -> tuple:
    """``tr.run()`` under ``autopilot_watch``, the launch counts zeroed just
    before it and read just after, then its records, remediations and
    status.json checked."""
    from draco_tpu_torch.obs import replay

    torch.cuda.reset_peak_memory_stats(dev)
    with autopilot_watch(tr, client_cls) as log:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        last = tr.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
    log["wall_s"] = wall
    # the graphs' private pools stay reserved, not allocated
    peaks = log["peaks"] + [(torch.cuda.max_memory_allocated(dev),
                             torch.cuda.max_memory_reserved(dev))]
    log["peak_gb"] = max(a for a, _ in peaks) / 1e9
    log["peak_reserved_gb"] = max(r for _, r in peaks) / 1e9
    require(last["step"] == cfg.max_steps and math.isfinite(last["loss"]),
            f"autopilot {label}: the run ended at {last}")
    rems = [e for e in replay.iter_jsonl(os.path.join(d, "incidents.jsonl"))
            if e.get("event") == "remediation"]
    recs = replay.train_records(os.path.join(d, "metrics.jsonl"))
    require([r["step"] for r in recs] == list(range(1, cfg.max_steps + 1)),
            f"autopilot {label}: records {[r['step'] for r in recs]}")
    require(all(r["guard_trips"] == 0.0 for r in recs),
            f"autopilot {label}: guard trips "
            f"{[(r['step'], r['guard_trips']) for r in recs]}")
    for e in rems:
        require(e.get("trigger") and e["trigger"].get("type")
                and e["trigger"].get("onset_step") is not None,
                f"autopilot {label}: a remediation without its trigger: {e}")
    with open(os.path.join(d, "status.json")) as f:
        status = json.load(f)
    heartbeat.check_status_schema(status, tool="chip_smoke")
    require(status.get("state") == "done" and "control" in status,
            f"autopilot {label}: status.json {status}")
    return tr, d, log, counts, rems, recs, status


def regime_summary(label, tr, log, counts) -> dict:
    """Per regime: one capture (none on a return), its graph's pool, its
    chunks' ms/step by CUDA events (the capturing chunk aside), and the
    kernels its path launched."""
    pilot = tr._autopilot
    caps = [c["graph"] for c in log["captures"]]
    lm = isinstance(tr, TokenLoop)
    base = "train_token_many" if lm else "train_many"
    out = {}
    for regime, setup in pilot._setups.items():
        graph = (setup.train_token_many if lm else setup.train_many).graph()
        require(graph is not None and graph.captures == 1
                and caps.count(id(graph)) == 1,
                f"autopilot {label} {regime.tag}: captures "
                f"{None if graph is None else graph.captures}, the run's "
                f"{[c['name'] for c in log['captures']]}")
        require(setup.state is tr.state and setup.model is tr.setup.model,
                f"autopilot {label} {regime.tag}: a second state")
        tag = regime.tag
        label = base if regime == pilot.base else f"{base}@{tag}"
        mine = [c for c in log["chunks"] if c["label"] == label]
        steady = [c for c in mine if not c["captured"]]
        ms = [c["events"][0].elapsed_time(c["events"][1]) / c["k"]
              for c in steady]
        for k in AP_KERNELS.get(tag, ()):
            require(counts[k] > 0, f"autopilot {label}: {tag}'s kernel {k} "
                    f"was never launched ({counts})")
        out[tag] = {"captures": graph.captures,
                    "pool_bytes": graph.pool_bytes,
                    "chunks": len(mine), "steady_chunks": len(steady),
                    "chunk_ms_per_step": ms,
                    "mean_ms_per_step": sum(ms) / len(ms) if ms else None}
    require(len(caps) == len(pilot._setups),
            f"autopilot {label}: {len(caps)} captures for "
            f"{len(pilot._setups)} regimes")
    return out


def swap_walls(log, rems) -> list:
    """Each swap's wall: a new regime's setup build, its chunk's re-make
    and its capture; a cached one's pointer switch (inside act) and the
    re-make."""
    swaps = [e for e in rems if e.get("regime")]
    acts = [a for a in log["acts"] if a["swapped"]]
    new = [c for c in log["captures"] if c["state_held"]]
    builds, out = list(log["builds"]), []
    require(len(acts) == len(swaps) == len(log["remakes"]),
            f"autopilot: {len(swaps)} swaps, {len(acts)} swapping acts, "
            f"{len(log['remakes'])} re-made chunks")
    for e, a, remake in zip(swaps, acts, log["remakes"]):
        row = {"action": e["action"], "to": e["regime"]["tag"],
               "executable": e["evidence"]["executable"],
               "act_ms": a["ms"], "remake_ms": remake}
        if e["evidence"]["executable"] == "compiled":
            row["build_ms"] = builds.pop(0)
            row["capture_s"] = new.pop(0)["wall_s"]
        out.append(row)
    return out


def lifecycle_checks(tr, log, rems, recs, status) -> None:
    actions = [e["action"] for e in rems]
    require(actions in AP_ORDERS, f"autopilot lifecycle: remediations "
            f"{actions}, the reference's orders {AP_ORDERS}")
    by = {e["action"]: e for e in rems}
    require(by["quarantine"]["worker"] == 2
            and by["quarantine"]["trigger"]["type"] == "trust"
            and by["dial_down"]["regime"]["tag"] == "approx_r1.5"
            and by["dial_down"]["evidence"]["executable"] == "compiled"
            and by["dial_up"]["regime"]["tag"] == "cyclic_r3"
            and by["dial_up"]["evidence"]["executable"] == "reused",
            f"autopilot lifecycle: {rems}")
    # each schedule write reaches the wire one assembled chunk later
    out = range(by["quarantine"]["effective_step"] + CHUNK_K,
                by["readmit"]["effective_step"] + CHUNK_K)
    for r in recs:
        word = int(r["wmask_present0"])
        require(bool(word >> 2 & 1) == (r["step"] not in out),
                f"autopilot lifecycle step {r['step']}: present word "
                f"{word:#x}, worker 2 out at steps {list(out)}")
    c = status["control"]
    require(c["regime"]["tag"] == "cyclic_r3" == c["base_regime"]
            and c["swaps"] == 2 and c["quarantined"] == []
            and c["remediations"] == 4
            and c["last"]["action"] == "dial_up",
            f"autopilot lifecycle: control block {c}")
    require(int(tr.state.opt.count) == 32, f"autopilot lifecycle: update "
            f"count {int(tr.state.opt.count)} after 32 trusted steps")


def pipeline_rails(dev) -> dict:
    """SegmentPipeline over the int8 wire's codeword pair at d = 11,173,962
    (ResNet-18's, n=8, block 256), S = 2 and 4, pipelined and serial: each
    segment a pinned host copy of its columns, put on a copy stream of its
    own with an event; the decode makes the compute stream wait on that
    event and launches cyclic_narrow_recombine on the segment; the drain
    synchronizes the decode's event. The segments' results concatenated
    bit for bit the whole-d launch; each rail's wall, the reference's host
    overlap and the device overlap from events on both streams."""
    from draco_tpu_torch.control.engine import SegmentPipeline
    from draco_tpu_torch.obs.tracer import NULL_TRACER

    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    er = torch.randn((N, D), generator=g, device=dev)
    ei = torch.randn((N, D), generator=g, device=dev)
    mode, buf_re, buf_im, block = "int8", *(
        numerics.narrow_wire_rows(x, "int8", BLOCK) for x in (er, ei)), BLOCK
    del er, ei
    v_re = torch.randn((N,), generator=g, device=dev)
    v_im = torch.randn((N,), generator=g, device=dev)
    wire = (mode, buf_re, buf_im, block)
    whole = decode_kernels.cyclic_narrow_recombine(v_re, v_im, wire)
    nbytes = sum(t.numel() * t.element_size() for b in (buf_re, buf_im)
                 for t in b.values())
    whole_ms = time_ms(lambda: decode_kernels.cyclic_narrow_recombine(
        v_re, v_im, wire), reps=20)
    compute = torch.cuda.current_stream(dev)
    copy = torch.cuda.Stream(dev)
    require(copy != compute, "pipeline: the copy stream is the compute "
            "stream")
    out = {"d": D, "n": N, "block": BLOCK, "pair_bytes": nbytes,
           "whole_decode_ms": whole_ms, "rails": []}
    for S in PIPE_SEGMENTS:
        cuts = numerics.wire_segment_bounds(D, S, BLOCK)
        segs = [decode_kernels.wire_slice_pair(wire, a, b)
                for a, b in zip(cuts[:-1], cuts[1:])]
        host = [{side: {k: t.to("cpu").contiguous().pin_memory()
                        for k, t in buf.items()}
                 for side, buf in zip(("re", "im"), seg[1:3])}
                for seg in segs]
        require(all(t.is_pinned() for h in host for side in h.values()
                    for t in side.values()), "pipeline: a pageable segment")
        devbuf = [{side: {k: torch.empty_like(t, device=dev)
                          for k, t in buf.items()}
                   for side, buf in h.items()} for h in host]
        events = {}

        def put(j, h, events=events, devbuf=devbuf):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(copy):
                a.record(copy)
                for side in ("re", "im"):
                    for k, t in h[side].items():
                        devbuf[j][side][k].copy_(t, non_blocking=True)
                b.record(copy)
            events.setdefault(j, {})["copy"] = (a, b)
            return devbuf[j], b

        def decode(j, dev_seg, events=events):
            bufs, ready = dev_seg
            compute.wait_event(ready)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record(compute)
            res = decode_kernels.cyclic_narrow_recombine(
                v_re, v_im, (mode, bufs["re"], bufs["im"], block))
            b.record(compute)
            events.setdefault(j, {})["decode"] = (a, b)
            return res, b

        def drain(res):
            res[1].synchronize()

        def rail(pipelined):
            """One run: (wall ms, results, device spans from the origin,
            the pipeline)."""
            events.clear()
            torch.cuda.synchronize()
            origin = torch.cuda.Event(enable_timing=True)
            origin.record(compute)
            pipe = SegmentPipeline(NULL_TRACER, put, decode, drain,
                                   pipelined=pipelined)
            t0 = time.perf_counter()
            results = pipe.run(host)
            wall = (time.perf_counter() - t0) * 1e3
            got = torch.cat([r[0] for r in results])
            require(torch.equal(_bits(got), _bits(whole)),
                    f"pipeline S={S} pipelined={pipelined}: the segments' "
                    f"results are not the whole-d launch bit for bit")
            span = {j: {k: (origin.elapsed_time(a), origin.elapsed_time(b))
                        for k, (a, b) in ev.items()}
                    for j, ev in events.items()}
            return wall, span, pipe

        walls = {True: [], False: []}
        last = {}
        for rep in range(PIPE_REPS + 1):  # the first pair warms up
            for pipelined in ((True, False) if rep % 2 else (False, True)):
                wall, span, pipe = rail(pipelined)
                if rep:
                    walls[pipelined].append(wall)
                last[pipelined] = (span, pipe)
        for pipelined in (True, False):
            span, pipe = last[pipelined]
            copy_ms = sum(s["copy"][1] - s["copy"][0] for s in span.values())
            dec_ms = sum(s["decode"][1] - s["decode"][0]
                         for s in span.values())
            hidden = sum(max(min(span[j]["decode"][1], span[i]["copy"][1])
                             - max(span[j]["decode"][0], span[i]["copy"][0]),
                             0.0)
                         for j in span for i in span if i != j)
            over, inflight = pipe.overlap_us()
            if pipelined:
                require(hidden > 0.0, f"pipeline S={S}: no decode ran under "
                        f"a copy (device spans {span})")
            else:
                require(over == 0.0, f"pipeline S={S} serial: host overlap "
                        f"{over} µs")
            w = sorted(walls[pipelined])
            row = {"segments": S, "pipelined": pipelined, "wall_ms": w,
                   "wall_ms_median": w[len(w) // 2],
                   "copy_ms": copy_ms, "decode_ms": dec_ms,
                   "device_overlap_ms": hidden,
                   "decode_hidden_fraction": (hidden / dec_ms if dec_ms
                                              else 0.0),
                   "host_overlap_us": over, "host_inflight_us": inflight,
                   "host_overlap_fraction": over / inflight if inflight
                   else 0.0}
            out["rails"].append(row)
            print(f"autopilot pipeline S={S} "
                  f"{'pipelined' if pipelined else 'serial'}: wall median "
                  f"{row['wall_ms_median']:.3f} ms of {len(w)} runs "
                  f"({w[0]:.3f}-{w[-1]:.3f}, the rails in turns); the last "
                  f"run's copies {copy_ms:.3f} ms and decodes {dec_ms:.4f} "
                  f"ms on the card, decode time under a copy {hidden:.4f} "
                  f"ms = {100 * row['decode_hidden_fraction']:.1f}%, the "
                  f"host's overlap {over:.1f} of {inflight:.1f} µs in "
                  f"flight; every run's segments bit for bit the whole-d "
                  f"decode", flush=True)
        del host, devbuf
    print(f"autopilot pipeline: the int8 pair {nbytes} bytes at d={D}, the "
          f"whole-d decode {whole_ms:.4f} ms", flush=True)
    return out


def autopilot_phase(dev, ds, legs) -> dict:
    """Phase 9 (module docstring): the lifecycle, the segment rung and the
    SegmentPipeline's rails; timings beside the shared and approx legs'
    chunks (phase 6) of the same call."""
    root = tempfile.mkdtemp(prefix="chip_smoke_autopilot_")
    twins = {lg["leg"]: lg["chunk"]["chunk_ms_per_step"] for lg in legs}
    out = {}
    try:
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        tr, _, log, counts, rems, recs, status = autopilot_run(
            "lifecycle", AP_LIFECYCLE, dev, ds, root)
        out["lifecycle"] = lifecycle_report(
            "lifecycle", tr, log, counts, rems, recs, status,
            {"cyclic_r3": "shared", "approx_r1.5": "approx"}, twins)
        del tr
        out["lifecycle_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        tr, _, log, counts, rems, recs, status = autopilot_run(
            "segments", AP_SEGMENTS, dev, ds, root)
        require([e["action"] for e in rems] == ["segments_up",
                                                 "segments_down"]
                and [e["regime"]["tag"] for e in rems]
                == ["cyclic_r3_seg2", "cyclic_r3"]
                and rems[0]["evidence"]["executable"] == "compiled"
                and status["control"]["swaps"] == 2
                and status["wire"]["segments"]["count"] == 1,
                f"autopilot segments: {rems}, {status.get('control')}")
        regimes = regime_summary("segments", tr, log, counts)
        out["segments"] = {"remediations": rems, "regimes": regimes,
                           "swaps": swap_walls(log, rems),
                           "act_ms": [a["ms"] for a in log["acts"]],
                           "launches": counts, "peak_gb": log["peak_gb"],
                           "peak_reserved_gb": log["peak_reserved_gb"]}
        for tag, r in regimes.items():
            print(f"autopilot segments {tag}: {r['steady_chunks']} steady "
                  f"chunks at {r['mean_ms_per_step']:.3f} ms/step, graph "
                  f"pool {r['pool_bytes'] / 2**30:.3f} GiB", flush=True)
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        out["segments_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["lm_lifecycle"] = lm_lifecycle(dev, root, legs)
        gc.collect()
        torch.cuda.empty_cache()
        out["lm_lifecycle_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["pipeline"] = pipeline_rails(dev)
        out["pipeline_s"] = time.perf_counter() - t0
        print(f"autopilot phase: lifecycle {out['lifecycle_s']:.1f} s, "
              f"segment rung {out['segments_s']:.1f} s, the LM's "
              f"{out['lm_lifecycle_s']:.1f} s, pipeline "
              f"{out['pipeline_s']:.1f} s", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lifecycle_report(label, tr, log, counts, rems, recs, status, twin_of,
                     twins) -> dict:
    """``lifecycle_checks`` and ``regime_summary`` of one lifecycle run,
    then printed: each regime's chunk ms/step beside its twin's chunk in
    phase 6 of this call (``twin_of``: regime tag -> leg, ``twins``: leg ->
    ms/step), its graph pool, each swap's wall and the run's act ms and
    peak allocated and reserved memory."""
    lifecycle_checks(tr, log, rems, recs, status)
    regimes = regime_summary(label, tr, log, counts)
    walls = swap_walls(log, rems)
    acts = [a["ms"] for a in log["acts"]]
    for tag, r in regimes.items():
        twin = twin_of.get(tag)
        print(f"autopilot {label} {tag}: {r['steady_chunks']} steady chunks "
              f"at {r['mean_ms_per_step']:.3f} ms/step (CUDA events; its "
              f"twin {twin} {twins.get(twin, 0):.3f} in phase 6); one "
              f"capture, graph pool {r['pool_bytes'] / 2**30:.3f} GiB "
              f"({r['pool_bytes']} B)", flush=True)
    for w in walls:
        print(f"autopilot {label} swap {w['action']} -> {w['to']} "
              f"({w['executable']}): act {w['act_ms']:.3f} ms"
              + (f" (the setup built in {w['build_ms']:.1f} ms), capture "
                 f"{w['capture_s'] * 1e3:.1f} ms" if "build_ms" in w else "")
              + f", chunk re-made in {w['remake_ms']:.3f} ms", flush=True)
    print(f"autopilot {label}: {[e['action'] for e in rems]}, {len(acts)} "
          f"boundaries, act {sum(acts) / len(acts):.3f} ms a boundary (max "
          f"{max(acts):.3f}), peak {log['peak_gb']:.2f} GB allocated, "
          f"{log['peak_reserved_gb']:.2f} GB reserved, wall "
          f"{log['wall_s']:.1f} s for {len(recs)} steps, 0 guard trips, "
          f"worker 2's present bit out for one chunk after the lag, the "
          f"state held bit for bit across the mid-run capture, control "
          f"{status['control']['regime']['tag']} swaps "
          f"{status['control']['swaps']}", flush=True)
    return {"remediations": rems, "control": status["control"],
            "regimes": regimes, "swaps": walls, "act_ms": acts,
            "captures": log["captures"], "launches": counts,
            "wall_s": log["wall_s"], "peak_gb": log["peak_gb"],
            "peak_reserved_gb": log["peak_reserved_gb"],
            "twin_chunk_ms_per_step": {t: twins.get(t)
                                       for t in twin_of.values()}}


def lm_lifecycle(dev, root, legs) -> dict:
    """The CNN lifecycle's policy, thresholds, fault plan and checks on the
    LM at ``LM_FULL`` through the TokenLoop, the flash kernels launched
    (``lifecycle_report``: each regime beside ``lm_shared_flash`` /
    ``lm_approx_flash`` of phase 6); then the reference's LM dial at K=1
    with device tokens."""
    twins = {lg["leg"]: lg["chunk"]["chunk_ms_per_step"] for lg in legs}
    tr, _, log, counts, rems, recs, status = lm_autopilot_run(
        "lm_lifecycle", AP_LIFECYCLE, dev, root)
    for k in FLASH:
        require(counts[k] > 0, f"autopilot lm_lifecycle: {k} was never "
                f"launched ({counts})")
    out = lifecycle_report("lm_lifecycle", tr, log, counts, rems, recs,
                           status, {"cyclic_r3": "lm_shared_flash",
                                    "approx_r1.5": "lm_approx_flash"}, twins)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    # K=1 with device tokens, which validate() admits under the autopilot:
    # the loop runs chunks of one step, each regime's step captured alone
    tr, _, log, counts, rems, recs, status = lm_autopilot_run(
        "lm_dial_k1", AP_DIAL_K1, dev, root)
    require([e["action"] for e in rems] == ["dial_down", "dial_up"]
            and rems[0]["regime"]["tag"] == "approx_r1.5"
            and [e["evidence"]["executable"] for e in rems]
            == ["compiled", "reused"]
            and status["control"]["regime"]["tag"] == "cyclic_r3"
            and status["control"]["swaps"] == 2,
            f"autopilot lm_dial_k1: {rems}, {status.get('control')}")
    regimes = regime_summary("lm_dial_k1", tr, log, counts)
    out["dial_k1"] = {"remediations": rems, "regimes": regimes,
                      "swaps": swap_walls(log, rems),
                      "wall_s": log["wall_s"], "peak_gb": log["peak_gb"],
                      "peak_reserved_gb": log["peak_reserved_gb"]}
    for tag, r in regimes.items():
        print(f"autopilot lm_dial_k1 {tag}: {r['steady_chunks']} steady "
              f"chunks of one step at {r['mean_ms_per_step']:.3f} ms/step, "
              f"graph pool {r['pool_bytes'] / 2**30:.3f} GiB", flush=True)
    del tr
    return out


def profile_step(tr) -> dict:
    """One more step under torch.profiler: device time by kernel name (the
    top 15), by the step's phases (the device work launched inside each
    draco_* range; the ranges are on while the profiler runs) and the
    device's busy time, beside the step's wall time under the profiler
    (which adds host overhead of its own)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side events only (kernels, copies, memsets): an aten op's
    # device total repeats the time of the kernels it launched, and so does
    # the device-side span of a draco_* range
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and dev_us(e) > 0 and e.key not in PHASES]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:15]
    rows = [{"name": e.key[:90], "device_ms": dev_us(e) / 1e3,
             "calls": e.count} for e in top]
    # where the host's time goes: host-side events by self time (under the
    # profiler, which inflates each one)
    host = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU]
    host_top = [{"name": e.key[:90], "host_self_ms": e.self_cpu_time_total
                 / 1e3, "calls": e.count}
                for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                                reverse=True)[:12]]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "top": rows,
            "host_top": host_top,
            "host_ops": sum(e.count for e in host),
            "phases": fold_device_phases(
                rules.export_trace(prof)["traceEvents"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=4,
                    help="timed steps per ResNet leg, after one warm-up step")
    ap.add_argument("--lm-steps", type=int, default=3,
                    help="timed steps per LM leg, after one warm-up step")
    ap.add_argument("--out", type=str, default="",
                    help="also write the full record as JSON to this file")
    ap.add_argument("--profile", action="store_true",
                    help="profile one extra step of each leg (torch.profiler)")
    ap.add_argument("--sdpa-kernels", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this smoke "
              "runs the port on a CUDA GPU", file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    dev = resolve_device("cuda")  # also turns TF32 off (runtime.full_f32)
    if args.sdpa_kernels:
        print(SDPA_MARK + json.dumps(sdpa_kernels(dev)), flush=True)
        return 0
    card = card_line()
    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda,
              "device": torch.cuda.get_device_name(0)}
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    t0 = time.perf_counter()
    old_locator_job = locator_ab.start_build()  # the old locator, beside
    built = _build.build_all()
    old_locator_lib = locator_ab.finish_build(old_locator_job)
    record["build_s"] = time.perf_counter() - t0
    print(f"build: nvcc {built or 'nothing (up to date)'} in "
          f"{record['build_s']:.1f} s", flush=True)

    code = cyclic.build_cyclic_code(N, S)
    code9 = cyclic.build_cyclic_code(VGG_N, VGG_S)
    cuts = leg_bounds()
    draw_rows, draw_replays = draw_kernels(dev)
    numerics_rows, numerics_replays = numerics_kernels(dev)
    torch.cuda.empty_cache()
    kernels = (coded_kernels(code, dev, code9)
               + locator_kernel(code, dev, code9, old_locator_lib)
               + narrow_kernels(code, dev) + segment_kernels(code, dev, cuts)
               + flash_kernels(dev) + vote_kernels(dev) + draw_rows
               + numerics_rows + control_kernels(dev))
    shapes = flash_shape_kernels(dev)
    for row in kernels:
        if row["name"] in FLASH:
            row["shapes"] = shapes[row["name"]]
    record["nan_chain"] = nan_chain_kernels(code, dev)
    torch.cuda.empty_cache()
    record["lm_width_kernels"] = lm_rows = lm_width_kernels(code, dev)
    for row in kernels:
        if row["name"] in lm_rows:
            row["lm_d"] = lm_rows[row["name"]]
    torch.cuda.empty_cache()
    moe_rows = moe_width_kernels(code, dev)
    for row in kernels:
        if row["name"] in moe_rows:
            row["moe_d"] = moe_rows[row["name"]]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    record["kernel_audit"] = audit_kernels()
    record["kernel_audit_s"] = time.perf_counter() - t0

    record["graph_replay"] = (graph_replay_kernels(code, dev, cuts)
                              + draw_replays + numerics_replays)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    legs = []
    for lp in registry.collect():
        steps = LEG_STEPS.get(lp.name, args.lm_steps if lp.route != "cnn"
                              else args.steps)
        legs.append(run_leg(lp, steps, dev, args.profile))
        gc.collect()  # the leg's setups and their graphs' pools
        torch.cuda.empty_cache()
    record["legs"] = legs
    record["legs_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    record["chunk"] = chunk_summary(legs)
    record["lm_code_twins"] = lm_code_twins(legs)
    record["stack_twins"] = stack_twin_checks(legs, dev)
    record["mp_twins"] = mp_twin_checks(legs, dev)
    record["remat_memory"] = remat_memory(dev)
    ds = dataset_of(registry.get("simulate"))
    record["twins"] = twin_checks(legs, dev, ds)
    record["tree_vs_flat"] = tree_vs_flat(dev, ds)
    gc.collect()
    torch.cuda.empty_cache()
    record["sr_twins"] = sr_twin_checks(legs)
    record["watch_twins"] = watch_twin_checks(dev, ds)
    record["vote_checks"] = vote_checks(dev, ds)
    record["bf16_simulate"] = bf16_simulate_check(dev, ds)
    gc.collect()
    torch.cuda.empty_cache()
    record["cross_device"] = cross_device_check(dev)
    record["wire_checks"] = wire_checks(dev)
    record["lm_checks"] = lm_checks(dev)
    record["checks_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    record["guard"] = guard_phase(dev, ds)
    record["guard_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    record["autopilot"] = autopilot_phase(dev, ds, legs)
    record["autopilot_s"] = time.perf_counter() - t0
    print(f"autopilot phase: {record['autopilot_s']:.1f} s", flush=True)
    t0 = time.perf_counter()
    record["lint"] = lint_legs(dev)
    record["lint_legs_s"] = time.perf_counter() - t0
    # remat lowers lm_big's step peak: below the same step's without it
    big_peak = next(r for r in record["lint"] if r["leg"]
                    == "lm_big_shared_flash")["rules"]["memory_budget"][
                        "step_peak_bytes"]
    nr = record["remat_memory"]["lm_big_without_remat"]
    require(not nr["fits"] or big_peak < nr["step_peak_bytes"],
            f"lm_big_shared_flash: step peak {big_peak} with remat, "
            f"{nr['step_peak_bytes']} without")
    t0 = time.perf_counter()
    record["lint_controls"] = lint_controls_card(dev)
    record["lint_controls_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    record["state"] = state_phase(dev, ds)
    record["state_s"] = time.perf_counter() - t0
    # the kernels the flash rows' yardsticks ran, named by the profiler
    sdpa = sdpa_kernels_child()
    for row in kernels:
        if row["name"] in FLASH:
            which = "forward" if row["name"] == "flash_fwd" else "backward"
            row["library_kernels"] = sdpa[which]
            row["library_call"] += (": " + sdpa[which][0]["kernel"]
                                    .split("(")[0])

    # launches per kernel: the coded kernels from the ResNet simulate leg
    # (the first slice's main path) and the encode from the shared leg,
    # which only that leg runs; the narrow recombination from shared_int8,
    # the approx decode from approx; the flash kernels from lm_shared_flash
    by_name = {lg["leg"]: lg for lg in legs}
    source_leg = {"complex_matmul": "shared",
                  "cyclic_narrow_recombine": "shared_int8",
                  "approx_decode": "approx",
                  "row_fingerprints": "majvote",
                  "complex_project_segments": "shared_layer",
                  "complex_recombine_segments": "shared_layer",
                  "cyclic_narrow_recombine_segments": "shared_int8_seg4",
                  "approx_decode_segment": "approx_int8_seg4",
                  "random_inject": "vgg11_random",
                  "round_draw": "shared_int8_sr",
                  "synthetic_text": "lm_shared_flash_devgen",
                  "augment_draws": "shared",
                  "dropout_keep": "vgg11_simulate",
                  "vote_salts": "majvote",
                  "stage_stats": "simulate_watch_bf16",
                  **{k: "lm_shared_flash" for k in FLASH}}
    # the controls run on no main path: their counts are read from every
    # leg, and are 0 on each
    for row in kernels:
        if row.get("control"):
            ran = sum(lg["launches"][row["name"]] for lg in legs)
            require(ran == 0, f"{row['name']} ran {ran} times on the main "
                    f"paths")
            row["launches"] = ran
            row["launches_from_leg"] = f"all {len(legs)}"
            row["launches_per_step"] = 0.0
            continue
        src = by_name[source_leg.get(row["name"], "simulate")]
        row["launches"] = src["launches"][row["name"]]
        row["launches_from_leg"] = src["leg"]
        row["launches_per_step"] = row["launches"] / src["steps"]
    for row in kernels:
        if not row.get("control"):
            row["graph_replay_bitwise"] = any(
                c.split(" ")[0] == row["name"] for c in record["graph_replay"])
            require(row["graph_replay_bitwise"], f"{row['name']}: no graph "
                    f"replay check")
    record["kernels"] = kernels
    record["script_s"] = time.perf_counter() - t_start
    print(f"done: every phase passed in {record['script_s']:.1f} s "
          f"(build {record['build_s']:.1f} s, kernel audit "
          f"{record['kernel_audit_s']:.1f} s, the legs "
          f"{record['legs_s']:.1f} s, the checks {record['checks_s']:.1f} s,"
          f" guard {record['guard_s']:.1f} s, autopilot "
          f"{record['autopilot_s']:.1f} s, the legs' lint "
          f"{record['lint_legs_s']:.1f} s, the lint's controls "
          f"{record['lint_controls_s']:.1f} s, state "
          f"{record['state_s']:.1f} s)", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(2)
