"""Test-set evaluation and the checkpoint-polling evaluator
(draco_tpu/training/evaluator.py).

  python -m draco_tpu_torch.training.evaluator --preset cyclic-resnet18 \\
      --train-dir ./train_out/ --once
  python -m draco_tpu_torch.training.evaluator --network LeNet \\
      --dataset MNIST --train-dir ./train_out/ --poll-seconds 10

The evaluator takes the trainer's flags (``cli.py``) and ``--poll-seconds``
(the original Draco polls every 10 s) and ``--once`` (evaluate what is
there, then exit). It loads each new ``model_step_k.dcg`` of
``train_dir`` into one setup's state in place and prints
``Testset Performance: Cur Step:k Prec@1: p1 Prec@5: p5``. It runs on the
card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.func import functional_call

from draco_tpu_torch.runtime import upload


def masked_full_split_eval(count_fn, xs, ys, batch_size):
    """Accuracy over all n samples in fixed-shape batches: the ragged last
    batch is padded with copies of its first row up to ``batch_size`` and
    those rows are masked out of the counts. ``count_fn(x, y, valid) ->
    (correct@1, correct@5)`` counts over the valid rows. Shared by
    ``Trainer.evaluate`` and the polling evaluator.

    Deliberate deviation from the original Draco, as the reference's:
    that averages per-batch accuracies (distributed_evaluator.py:105-107),
    which overweights a ragged last batch; here the counts are summed and
    divided by n, the sample-weighted accuracy (ADVICE.md)."""
    n = len(xs)
    if n == 0:
        return 0.0, 0.0
    bs = min(batch_size, n)
    c1 = c5 = 0.0
    for i in range(0, n, bs):
        x = np.asarray(xs[i:i + bs])
        y = np.asarray(ys[i:i + bs])
        k = len(x)
        if k < bs:
            x = np.concatenate([x, np.repeat(x[:1], bs - k, axis=0)])
            y = np.concatenate([y, np.repeat(y[:1], bs - k, axis=0)])
        p1, p5 = count_fn(x, y, np.arange(bs) < k)
        c1 += float(p1)
        c5 += float(p5)
    return c1 / n, c5 / n


def correct_counts(model, params: dict, stats: dict, x, y, valid):
    """Correct@1 and correct@5 counts (0-d float32 tensors) of ``model``
    in evaluation mode on a batch, over the ``valid`` rows. ``stats``:
    one set of running statistics (no worker axis)."""
    logits, _ = functional_call(model, (params,), (x, stats, None),
                                {"train": False})
    y = y.long()
    ok1 = (logits.argmax(-1) == y) & valid
    ok5 = (torch.topk(logits, 5, dim=-1).indices == y[:, None]).any(1) \
        & valid
    return ok1.sum().to(torch.float32), ok5.sum().to(torch.float32)


@torch.inference_mode()
def evaluate_params(model, params: dict, stats, xs, ys,
                    batch_size: int = 1000):
    """(prec@1, prec@5) of ``params`` (torch names, on the model's device)
    with one set of running statistics ``stats`` (or None) over the whole
    split."""
    dev = next(iter(params.values())).device

    def count(x, y, valid):
        return correct_counts(model, params, stats or {},
                              *(upload(torch.as_tensor(t), dev)
                                for t in (x, y, valid)))

    return masked_full_split_eval(count, xs, ys, batch_size)


def main(argv=None) -> list:
    """Poll ``train_dir``; returns ``[(step, prec@1, prec@5), ...]`` of
    what it evaluated (with ``--once``)."""
    from draco_tpu_torch import cli
    from draco_tpu_torch.data.datasets import load_dataset
    from draco_tpu_torch.training.step import build_train_setup
    from draco_tpu_torch.utils import checkpoint as ckpt

    parser = cli.parser()
    parser.description = "draco_tpu_torch evaluator"
    parser.add_argument("--poll-seconds", type=float, default=10.0,
                        help="poll interval (the original Draco sleeps 10 s)")
    parser.add_argument("--once", action="store_true",
                        help="evaluate what exists, then exit")
    args = parser.parse_args(argv)
    cfg = cli.config_from_args(args)
    ds = load_dataset(cfg.dataset, cfg.data_dir)
    setup = build_train_setup(cfg, args.device, dataset_name=ds.name)
    state, lay = setup.state, setup.layout
    specs = state.specs(lay)
    seen, out = set(), []
    while True:
        for step in ckpt.available_steps(cfg.train_dir):
            if step in seen:
                continue
            state.load(ckpt.load(cfg.train_dir, step, specs), lay)
            p1, p5 = evaluate_params(
                setup.model, state.params,
                {k: v[0] for k, v in state.stats.items()},
                ds.test_x, ds.test_y, cfg.test_batch_size)
            print(f"Testset Performance: Cur Step:{step} Prec@1: {p1:.4f} "
                  f"Prec@5: {p5:.4f}", flush=True)
            seen.add(step)
            out.append((step, p1, p5))
        if args.once:
            return out
        time.sleep(args.poll_seconds)


if __name__ == "__main__":
    main()
