"""Command-line trainer of the port (draco_tpu/cli.py's flag names).

  python -m draco_tpu_torch.cli --preset cyclic-resnet18 --num-workers 8 \\
      --max-steps 5
  python -m draco_tpu_torch.cli --approach cyclic --network ResNet18 \\
      --dataset synthetic-cifar10 --num-workers 8 --worker-fail 1 \\
      --batch-size 4 --max-steps 3 --device cpu
  python -m draco_tpu_torch.cli --preset approx-resnet18 --num-workers 8 \\
      --max-steps 5
  python -m draco_tpu_torch.cli --preset cyclic-resnet18 --num-workers 8 \\
      --redundancy shared --wire-dtype int8 --max-steps 5
  python -m draco_tpu_torch.cli --preset rep-resnet18 --worker-fail 1 \\
      --max-steps 5                      # the repetition code's vote
  python -m draco_tpu_torch.cli --preset krum-resnet18 --num-workers 8 \\
      --straggle-mode drop --straggle-count 1 --max-steps 5
  python -m draco_tpu_torch.cli --preset cyclic-vgg11 --max-steps 5
  python -m draco_tpu_torch.cli --preset single-lenet --max-steps 5
  python -m draco_tpu_torch.cli --preset cyclic-resnet18 --num-workers 8 \\
      --compute-dtype bfloat16 --optimizer adamw --lr 0.001 \\
      --lr-schedule cosine --warmup-steps 2 --clip-norm 1.0 --max-steps 5
  python -m draco_tpu_torch.cli --network TransformerLM \\
      --dataset synthetic-text --approach cyclic --redundancy shared \\
      --attn-impl flash --compute-dtype bfloat16 --num-workers 8 \\
      --worker-fail 1 --batch-size 2 --seq-len 512 --model-dim 768 \\
      --model-heads 12 --model-layers 8 --vocab 8192 --max-steps 5

``--optimizer`` takes sgd, adam or adamw (``--weight-decay``: AdamW's
decoupled decay), ``--lr-schedule`` constant or cosine (``--warmup-steps``
ramps it), ``--clip-norm`` C > 0 clips the aggregated gradient to global
norm C; ``--compute-dtype bfloat16`` runs the convolutions and Dense
layers of any network in bf16.
``--mode`` takes the baseline's seven rules (normal, geometric_median,
krum, coord_median, trimmed_mean, multi_krum, bulyan), ``--err-mode``
rev_grad, constant, random, alie or ipm (random draws the reference's
own numbers on the device, eagerly or in chunks), ``--vote-check``
fingerprint or exact. ``--shadow-round stochastic`` rounds a narrow wire
(``--wire-dtype bf16|int8``, on cyclic, approx and maj_vote) with the
reference's shared per-step draw; ``--token-gen device`` makes the LM's
tokens on the device from the step (no token upload).
``--steps-per-call K`` (K > 1) trains in chunks of K steps, on the card
each chunk the replays of one captured CUDA graph
(``training/chunk_graph.py``). ``--trace-dir DIR`` writes the loop's host
spans to ``DIR/trace.json`` (``python -m draco_tpu_torch.obs.trace_report
DIR`` folds them by phase).
Every ``--eval-freq`` steps the CNN evaluates on the whole test split
(``--test-batch-size``) and the LM its held-out loss; then, with a
``--train-dir``, each checkpoints there (``model_step_k.dcg``, zlib level
1 with ``--compress-ckpt``, else stored; ``--keep-checkpoints N`` keeps
the newest N). ``--checkpoint-step k`` resumes from step k, ``-1`` from
the newest loadable checkpoint (walking back past corrupt ones); SIGTERM
or SIGINT stops at the next step or chunk end with a checkpoint.
``--prefetch-timeout`` and ``--prefetch-restarts`` bound and supervise the
chunked loops' prefetch worker.
``--step-guard on`` skips an untrusted step's update (``--guard-residual-tol``
is the loud residual), ``--fault-spec "nan_grad@2,sigterm@5"`` runs the
seeded fault plan (``resilience/faults.py``), ``--incident-watch on``
writes ``incidents.jsonl`` and the status.json incidents block
(``--incident-thresholds "trust.floor=0.4"``):

  python -m draco_tpu_torch.cli --preset cyclic-resnet18 --num-workers 8 \\
      --step-guard on --fault-spec nan_grad@2 --incident-watch on \\
      --max-steps 5 --train-dir train_out/guard

``--autopilot on`` (with ``--incident-watch on``, a ``--train-dir`` and
``--steps-per-call`` > 1; ``--autopilot-policy "r_low=1.2,..."``
overrides its policy) remediates from the incident stream at every flush
(``control/autopilot.py``): quarantine, readmit and regime swaps, each a
``remediation`` line in ``incidents.jsonl`` and the status.json control
block.
Runs on the card unless ``--device cpu`` is given. With ``--preset``, the
flags given on the command line override the preset's fields.
``network=TransformerLM`` runs the LM step and its token loop on the
reference's route: ``--tensor-shards`` > 1 tensor parallelism
(``parallel/tp_step.py``), else ``--expert-shards`` > 1 expert
parallelism over ``--moe-experts`` Switch experts (``ep_step.py``), else
``--pipeline-shards`` > 1 or ``--pp-microbatches`` > 0 the GPipe pipeline
(``pp_step.py``), else the default route (``sp_step.py``; ``--seq-shards``
sequence shards, ``--sp-attn ring|a2a``, ``--remat``, ``--moe-experts``);
every other network the CNN trainer.
"""

from __future__ import annotations

import argparse
import dataclasses

from draco_tpu_torch.config import LM_NETWORK, TrainConfig

# flag -> (type, TrainConfig field); every flag defaults to "not given"
FLAGS = {
    "--network": (str, "network"),
    "--dataset": (str, "dataset"),
    "--data-dir": (str, "data_dir"),
    "--batch-size": (int, "batch_size"),
    "--test-batch-size": (int, "test_batch_size"),
    "--optimizer": (str, "optimizer"),
    "--lr": (float, "lr"),
    "--momentum": (float, "momentum"),
    "--weight-decay": (float, "weight_decay"),
    "--lr-schedule": (str, "lr_schedule"),
    "--warmup-steps": (int, "warmup_steps"),
    "--clip-norm": (float, "clip_norm"),
    "--max-steps": (int, "max_steps"),
    "--num-workers": (int, "num_workers"),
    "--approach": (str, "approach"),
    "--mode": (str, "mode"),
    "--group-size": (int, "group_size"),
    "--vote-check": (str, "vote_check"),
    "--worker-fail": (int, "worker_fail"),
    "--code-redundancy": (float, "code_redundancy"),
    "--straggler-alpha": (float, "straggler_alpha"),
    "--assignment-scheme": (str, "assignment_scheme"),
    "--straggle-mode": (str, "straggle_mode"),
    "--straggle-count": (int, "straggle_count"),
    "--err-mode": (str, "err_mode"),
    "--adversarial": (float, "adversarial"),
    "--adversary-count": (int, "adversary_count"),
    "--redundancy": (str, "redundancy"),
    "--decode-granularity": (str, "decode_granularity"),
    "--decode-impl": (str, "decode_impl"),
    "--wire-dtype": (str, "wire_dtype"),
    "--shadow-block": (int, "shadow_block"),
    "--shadow-round": (str, "shadow_round"),
    "--numerics-watch": (str, "numerics_watch"),
    "--shadow-wire": (str, "shadow_wire"),
    "--job-name": (str, "job_name"),
    "--wire-segments": (int, "wire_segments"),
    "--topology": (str, "topology"),
    "--tree-fanout": (int, "tree_fanout"),
    "--tree-levels": (int, "tree_levels"),
    "--train-dir": (str, "train_dir"),
    "--log-every": (int, "log_every"),
    "--seed": (int, "seed"),
    "--geomedian-iters": (int, "geomedian_iters"),
    "--seq-len": (int, "seq_len"),
    "--vocab": (int, "vocab"),
    "--model-dim": (int, "model_dim"),
    "--model-heads": (int, "model_heads"),
    "--model-layers": (int, "model_layers"),
    "--attn-impl": (str, "attn_impl"),
    "--seq-shards": (int, "seq_shards"),
    "--sp-attn": (str, "sp_attn"),
    "--remat": (bool, "remat"),  # a switch
    "--tensor-shards": (int, "tensor_shards"),
    "--moe-experts": (int, "moe_experts"),
    "--expert-shards": (int, "expert_shards"),
    "--pipeline-shards": (int, "pipeline_shards"),
    "--pp-microbatches": (int, "pp_microbatches"),
    "--compute-dtype": (str, "compute_dtype"),
    "--eval-freq": (int, "eval_freq"),
    "--trace-dir": (str, "trace_dir"),
    "--steps-per-call": (int, "steps_per_call"),
    "--token-gen": (str, "token_gen"),
    "--checkpoint-step": (int, "checkpoint_step"),
    "--compress-ckpt": (bool, "compress_ckpt"),  # a switch
    "--keep-checkpoints": (int, "keep_checkpoints"),
    "--prefetch-timeout": (float, "prefetch_timeout_s"),
    "--prefetch-restarts": (int, "prefetch_restarts"),
    "--step-guard": (str, "step_guard"),
    "--guard-residual-tol": (float, "guard_residual_tol"),
    "--fault-spec": (str, "fault_spec"),
    "--incident-watch": (str, "incident_watch"),
    "--incident-thresholds": (str, "incident_thresholds"),
    "--autopilot": (str, "autopilot"),
    "--autopilot-policy": (str, "autopilot_policy"),
}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="draco_tpu_torch trainer")
    for flag, (typ, field) in FLAGS.items():
        if typ is bool:
            p.add_argument(flag, action="store_const", const=True,
                           default=None, dest=field)
        else:
            p.add_argument(flag, type=typ, default=None, dest=field)
    p.add_argument("--preset", type=str, default="",
                   help="named configuration (draco_tpu_torch.presets)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def config_from_args(args) -> TrainConfig:
    given = {field: getattr(args, field) for _, field in FLAGS.values()
             if getattr(args, field) is not None}
    if given.get("approach") == "approx":
        # approx has only the shared (compute-once) encode: an unset
        # --redundancy resolves to it, an explicit simulate still fails
        given.setdefault("redundancy", "shared")
    if args.preset:
        from draco_tpu_torch.presets import get_preset

        return get_preset(args.preset, **given)
    return dataclasses.replace(TrainConfig(), **given).validate()


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    cfg = config_from_args(args)
    if cfg.network == LM_NETWORK:
        # tp, then ep, then pp, else sp, as the reference's CLI dispatches
        from draco_tpu_torch.parallel import train_route

        return train_route(cfg, device=args.device)[1]
    from draco_tpu_torch.training.trainer import Trainer

    return Trainer(cfg, device=args.device).run()


if __name__ == "__main__":
    main()
