"""The narrow wire as a chunk on the CPU: cyclic ``shared`` ResNet-18 on
the int8 wire (block 256; n=5, s=1, a rev_grad adversary every step,
batch 1, ``registry.CNN_CI``), ``train_many`` over the chunks (1, 3) and
(4, 1) against four eager steps, bit for bit (``test_torch_chunk.py``'s
harness)."""

import torch

from draco_tpu_torch.data import datasets
from test_torch_chunk import assert_chunk_equals_eager
from test_torch_chunk_cnn import cnn_build, cnn_chunk

torch.set_num_threads(1)


def test_train_many_equals_eager_steps():
    ds = datasets.load_dataset("synthetic-cifar10", synthetic_train=256,
                               synthetic_test=16)
    assert_chunk_equals_eager(cnn_build("shared_int8", ds), cnn_chunk)
