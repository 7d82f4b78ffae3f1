"""The Trainer a user runs through the CLI, profiled and watched on the
CPU (``test_torch_profiling.observed_run``): LeNet eagerly and in chunks
of K=3, each with ``--profile-dir --trace-dir --train-dir --compile-guard
raise`` and an ``eval_freq`` of 4 that leaves a remainder chunk, each held
bit for bit to one unprofiled eager run, whose rows the chunked Trainer
writes too (``test_torch_chunk.py``)."""

import pytest

from draco_tpu_torch import cli
from test_torch_profiling import RUN, capture_double, observed_run  # noqa

LENET = ["--network", "LeNet", "--dataset", "synthetic-mnist",
         "--approach", "cyclic", "--redundancy", "shared",
         "--num-workers", "5", "--worker-fail", "1", "--err-mode",
         "rev_grad", "--batch-size", "2", "--test-batch-size", "512"]


@pytest.fixture(scope="module")
def twin(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("twin"))
    cli.main(LENET + RUN + ["--steps-per-call", "1", "--train-dir", d])
    return d


@pytest.mark.parametrize("k,profiled", [(1, 5), (3, 7)],
                         ids=["eager", "chunked"])
def test_the_trainer_profiled_and_watched(tmp_path, capture_double, twin, k,
                                          profiled):
    observed_run(tmp_path, LENET, k, profiled, "train_many[3]", twin)
