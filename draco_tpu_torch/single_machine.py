"""The single-process path (draco_tpu/single_machine.py): the trainer at
one worker, the baseline mean, no adversary — the original Draco's
single_machine.py.

  python -m draco_tpu_torch.single_machine --network LeNet --dataset MNIST \\
      --max-steps 500
  python -m draco_tpu_torch.single_machine --network TransformerLM \\
      --dataset synthetic-text --max-steps 50

It takes the trainer's flags (``cli.py``) and forces ``approach=baseline``,
``mode=normal``, ``num_workers=1`` and ``worker_fail=0``. The LM runs the
one-worker token loop; the model-parallel knobs, which span devices this
entry point does not have, are refused with the reference's message. Runs
on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import dataclasses

from draco_tpu_torch.config import LM_NETWORK, TrainConfig

ONE_WORKER = dict(approach="baseline", mode="normal", num_workers=1,
                  worker_fail=0)


def run(cfg: TrainConfig, device=None) -> dict:
    """Train ``cfg`` at one worker on ``device``; returns the last step's
    record."""
    cfg = dataclasses.replace(cfg, **ONE_WORKER)
    if cfg.network == LM_NETWORK:
        if (cfg.seq_shards > 1 or cfg.tensor_shards > 1
                or cfg.expert_shards > 1 or cfg.pipeline_shards > 1
                or cfg.pp_microbatches > 0):
            raise SystemExit(
                "single_machine is the one-device path; use "
                "python -m draco_tpu.cli for seq/tensor/expert/pipeline "
                "shards")
        from draco_tpu_torch.parallel.sp_step import train_sp

        return train_sp(cfg.validate(), device)[1]
    from draco_tpu_torch.training.trainer import Trainer

    return Trainer(cfg, device=device).run()


def main(argv=None) -> dict:
    from draco_tpu_torch import cli

    parser = cli.parser()
    parser.description = "draco_tpu_torch single machine"
    args = parser.parse_args(argv)
    for field, value in ONE_WORKER.items():
        setattr(args, field, value)
    return run(cli.config_from_args(args), args.device)


if __name__ == "__main__":
    main()
