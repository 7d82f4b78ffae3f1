"""The ResNet-18 chunk on the CPU against the eager steps
(``test_torch_chunk.py``'s harness and tolerance: bit for bit), at the
registry's CI size (``registry.CNN_CI``: n=5, batch 1, 4 Weiszfeld
passes): the baseline geometric median, the approx code with 2 stragglers
a step (its host columns and presence count included), and the Trainer's
chunked metrics.jsonl against its eager one. ``train_many`` runs the
chunks (1, 3) and (4, 1) against four eager steps."""

import json
import os

import pytest
import torch

from draco_tpu_torch.analysis import registry
from draco_tpu_torch.data import datasets
from draco_tpu_torch.training.trainer import Trainer
from test_torch_chunk import assert_chunk_equals_eager

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ds():
    return datasets.load_dataset("synthetic-cifar10", synthetic_train=256,
                                 synthetic_test=16)


def cnn_build(leg, ds, **fields):
    def build():
        cfg = registry.get(leg).config(False, max_steps=7, steps_per_call=3,
                                       **fields)
        tr = Trainer(cfg, device="cpu", dataset=ds, quiet=True)
        return tr.setup, tr
    return build


def cnn_chunk(tr, rng_):
    """The chunk the Trainer's engine client assembles for ``rng_``."""
    client = tr.chunk_client(rng_[0], rng_[0] + rng_[1] - 1)
    try:
        return client.assemble(0, [rng_])
    finally:
        client.cleanup()


@pytest.mark.parametrize("leg", ["geomedian", "approx"])
def test_train_many_equals_eager_steps(ds, leg):
    assert_chunk_equals_eager(cnn_build(leg, ds), cnn_chunk)


def test_trainer_chunked_writes_the_eager_rows(ds, tmp_path):
    """The approx leg at K=3, eval_freq=4, max_steps=7 (chunks (1,3) (4,1)
    (5,3)): the same metrics.jsonl rows, key order included (the host
    columns and the presence count among them), as K=1, apart from
    step_ms; the test-set eval record follows step 4 in both, and both
    checkpoint step 4."""
    rows = {}
    for K in (1, 3):
        d = tmp_path / f"k{K}"
        cfg = registry.get("approx").config(
            False, max_steps=7, steps_per_call=K, eval_freq=4, log_every=2,
            train_dir=str(d))
        last = Trainer(cfg, device="cpu", dataset=ds, quiet=True).run()
        lines = [json.loads(x)
                 for x in (d / "metrics.jsonl").read_text().splitlines()]
        rows[K] = [{k: v for k, v in r.items() if k != "step_ms"}
                   for r in lines + [last]]
        assert all(("step_ms" in r) != ("prec1_test" in r) for r in lines)
        # and the run's status.json (obs/heartbeat.py)
        assert sorted(os.listdir(d)) == ["metrics.jsonl", "model_step_4.dcg",
                                         "model_step_4.dcg.sha256",
                                         "status.json"]
    assert [list(r) for r in rows[3]] == [list(r) for r in rows[1]]
    assert rows[3] == rows[1]
    assert [r["step"] for r in rows[1]] == [1, 2, 4, 4, 6, 7]
    assert list(rows[1][3]) == ["step", "prec1_test", "prec5_test"]
    assert rows[1][0]["present"] == 3.0
