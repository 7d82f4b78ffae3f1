"""Command-line trainer of the port (draco_tpu/cli.py's flag names).

  python -m draco_tpu_torch.cli --preset cyclic-resnet18 --num-workers 8 \\
      --max-steps 5
  python -m draco_tpu_torch.cli --approach cyclic --network ResNet18 \\
      --dataset synthetic-cifar10 --num-workers 8 --worker-fail 1 \\
      --batch-size 4 --max-steps 3 --device cpu

Runs on the card unless ``--device cpu`` is given. With ``--preset``, the
flags given on the command line override the preset's fields.
"""

from __future__ import annotations

import argparse
import dataclasses

from draco_tpu_torch.config import TrainConfig

# flag -> (type, TrainConfig field); every flag defaults to "not given"
FLAGS = {
    "--network": (str, "network"),
    "--dataset": (str, "dataset"),
    "--data-dir": (str, "data_dir"),
    "--batch-size": (int, "batch_size"),
    "--lr": (float, "lr"),
    "--momentum": (float, "momentum"),
    "--max-steps": (int, "max_steps"),
    "--num-workers": (int, "num_workers"),
    "--approach": (str, "approach"),
    "--mode": (str, "mode"),
    "--worker-fail": (int, "worker_fail"),
    "--err-mode": (str, "err_mode"),
    "--adversarial": (float, "adversarial"),
    "--adversary-count": (int, "adversary_count"),
    "--redundancy": (str, "redundancy"),
    "--decode-granularity": (str, "decode_granularity"),
    "--decode-impl": (str, "decode_impl"),
    "--wire-dtype": (str, "wire_dtype"),
    "--wire-segments": (int, "wire_segments"),
    "--topology": (str, "topology"),
    "--train-dir": (str, "train_dir"),
    "--log-every": (int, "log_every"),
    "--seed": (int, "seed"),
    "--geomedian-iters": (int, "geomedian_iters"),
}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="draco_tpu_torch trainer")
    for flag, (typ, field) in FLAGS.items():
        p.add_argument(flag, type=typ, default=None, dest=field)
    p.add_argument("--preset", type=str, default="",
                   help="named configuration (draco_tpu_torch.presets)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def config_from_args(args) -> TrainConfig:
    given = {field: getattr(args, field) for _, field in FLAGS.values()
             if getattr(args, field) is not None}
    if args.preset:
        from draco_tpu_torch.presets import get_preset

        return get_preset(args.preset, **given)
    return dataclasses.replace(TrainConfig(), **given).validate()


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    cfg = config_from_args(args)
    from draco_tpu_torch.training.trainer import Trainer

    return Trainer(cfg, device=args.device).run()


if __name__ == "__main__":
    main()
