"""Dataset ingestion — MNIST / CIFAR-10 from raw files, synthetic fallback
(a copy of draco_tpu/data/datasets.py: the port imports nothing of the
reference package).

The original Draco pulls MNIST/CIFAR-10 through torchvision with
download=True (src/util.py:23-66). Nothing here downloads:

  * ``MNIST`` / ``Cifar10`` load from raw files if present under data_dir
    (idx-ubyte files / cifar-10-batches-py pickles — the standard layouts),
  * otherwise a deterministic class-conditional synthetic set with identical
    shapes/normalisation is generated (clearly labelled in metadata), so
    every pipeline and benchmark runs end-to-end anywhere.
  * ``synthetic-mnist`` / ``synthetic-cifar10`` request the synthetic set
    explicitly.

Normalisation constants match the reference exactly: MNIST (0.1307, 0.3081)
(util.py:33), CIFAR-10 mean/std per channel in 0-255 units (util.py:37-38).
Arrays are NHWC float32, labels int32.
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import pickle
from typing import Optional

import numpy as np

MNIST_MEAN, MNIST_STD = 0.1307, 0.3081
CIFAR_MEAN = np.array([125.3, 123.0, 113.9], dtype=np.float32) / 255.0
CIFAR_STD = np.array([63.0, 62.1, 66.7], dtype=np.float32) / 255.0


@dataclasses.dataclass
class Dataset:
    name: str
    train_x: np.ndarray  # (N, H, W, C) float32, normalised
    train_y: np.ndarray  # (N,) int32
    test_x: np.ndarray
    test_y: np.ndarray
    num_classes: int = 10
    synthetic: bool = False

    def __len__(self):
        return len(self.train_x)


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    magic = int.from_bytes(data[0:4], "big")
    ndim = magic & 0xFF
    dims = [int.from_bytes(data[4 + 4 * i : 8 + 4 * i], "big") for i in range(ndim)]
    return np.frombuffer(data, dtype=np.uint8, offset=4 + 4 * ndim).reshape(dims)


def _find(root: str, names) -> Optional[str]:
    for name in names:
        for cand in (os.path.join(root, name), os.path.join(root, name + ".gz")):
            if os.path.exists(cand):
                return cand
    return None


def _try_load_mnist(data_dir: str) -> Optional[Dataset]:
    roots = [data_dir, os.path.join(data_dir, "mnist"), os.path.join(data_dir, "MNIST", "raw")]
    for root in roots:
        tri = _find(root, ["train-images-idx3-ubyte", "train-images.idx3-ubyte"])
        trl = _find(root, ["train-labels-idx1-ubyte", "train-labels.idx1-ubyte"])
        tei = _find(root, ["t10k-images-idx3-ubyte", "t10k-images.idx3-ubyte"])
        tel = _find(root, ["t10k-labels-idx1-ubyte", "t10k-labels.idx1-ubyte"])
        if all([tri, trl, tei, tel]):
            norm = lambda x: ((x.astype(np.float32) / 255.0 - MNIST_MEAN) / MNIST_STD)[..., None]
            return Dataset(
                name="MNIST",
                train_x=norm(_read_idx(tri)),
                train_y=_read_idx(trl).astype(np.int32),
                test_x=norm(_read_idx(tei)),
                test_y=_read_idx(tel).astype(np.int32),
            )
    return None


def _try_load_cifar10(data_dir: str) -> Optional[Dataset]:
    for root in [data_dir, os.path.join(data_dir, "cifar10"), os.path.join(data_dir, "cifar10_data")]:
        batch_dir = os.path.join(root, "cifar-10-batches-py")
        if not os.path.isdir(batch_dir):
            continue
        xs, ys = [], []
        for i in range(1, 6):
            with open(os.path.join(batch_dir, f"data_batch_{i}"), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(d[b"data"])
            ys.append(d[b"labels"])
        with open(os.path.join(batch_dir, "test_batch"), "rb") as f:
            d = pickle.load(f, encoding="bytes")

        def norm(raw):
            x = raw.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1).astype(np.float32) / 255.0
            return (x - CIFAR_MEAN) / CIFAR_STD

        return Dataset(
            name="Cifar10",
            train_x=norm(np.concatenate(xs)),
            train_y=np.concatenate(ys).astype(np.int32),
            test_x=norm(d[b"data"]),
            test_y=np.asarray(d[b"labels"], dtype=np.int32),
        )
    return None


def _synthetic(name: str, shape, n_train: int, n_test: int, seed: int = 1234) -> Dataset:
    """Class-conditional Gaussian blobs: learnable (a linear probe reaches
    high accuracy), deterministic, correct shapes/dtypes."""
    rng = np.random.RandomState(seed)
    h, w, c = shape
    num_classes = 10
    protos = rng.randn(num_classes, h, w, c).astype(np.float32)

    def make(n, salt):
        r = np.random.RandomState(seed + salt)
        y = r.randint(0, num_classes, size=n).astype(np.int32)
        x = 0.6 * protos[y] + 0.8 * r.randn(n, h, w, c).astype(np.float32)
        return x.astype(np.float32), y

    tx, ty = make(n_train, 1)
    ex, ey = make(n_test, 2)
    return Dataset(name=name, train_x=tx, train_y=ty, test_x=ex, test_y=ey, synthetic=True)


def load_dataset(dataset: str, data_dir: str = "./data", synthetic_train: int = 8192,
                 synthetic_test: int = 2048) -> Dataset:
    key = dataset.lower()
    if key == "mnist":
        ds = _try_load_mnist(data_dir)
        if ds is not None:
            return ds
        return _synthetic("synthetic-mnist", (28, 28, 1), synthetic_train, synthetic_test)
    if key in ("cifar10", "cifar-10"):
        ds = _try_load_cifar10(data_dir)
        if ds is not None:
            return ds
        return _synthetic("synthetic-cifar10", (32, 32, 3), synthetic_train, synthetic_test)
    if key == "synthetic-mnist":
        return _synthetic("synthetic-mnist", (28, 28, 1), synthetic_train, synthetic_test)
    if key in ("synthetic-cifar10", "synthetic-cifar"):
        return _synthetic("synthetic-cifar10", (32, 32, 3), synthetic_train, synthetic_test)
    raise ValueError(f"unknown dataset: {dataset}")
