"""Step-indexed checkpoints (draco_tpu/utils/checkpoint.py), in the
reference's ``.dcg`` container, which its ``ckpt.load`` and its evaluator
read.

Layout: ``{train_dir}/model_step_{k}.dcg`` (the reference's evaluator polls
``model_step_(\\d+)(\\.dcg)?``) and its ``.dcg.sha256`` sidecar. A
``.dcg`` is ``DCKP`` + the leaf count (uint32), then per leaf its blob
length (uint64) and its blob (``utils/compress.py``). The leaves are the
state's arrays in the order of ``jax.tree.leaves`` of the reference's
``TrainState`` (``TrainState.leaves``, ``training/step.py``).

**Deviation from the reference:** its uncompressed checkpoint is an Orbax
directory, a JAX-only format. The port writes the ``.dcg`` container
either way; ``compress`` picks only the zlib level: 1 (the reference's
``compress_ckpt``) or 0 (stored). The reference's ``load`` takes the
``.dcg`` first, so it reads every checkpoint the port writes; the port
reads no Orbax directory (``load`` says so).

Resilience (the reference's):

* a save streams the leaves to ``.dcg.tmp`` under an incremental sha256,
  then drops the old sidecar, installs the payload (``os.replace``) and
  writes the new sidecar: a crash at any point leaves a complete payload,
  old or new, with either no sidecar or its own;
* a load verifies the sidecar over the same streamed reads; torn bytes
  (a checksum mismatch, a truncation, a torn header, a blob that does not
  inflate) raise :class:`CheckpointCorruptError`, the class the resume
  walk-back retries past (``resilience/supervisor.py``); a structural
  mismatch (the wrong leaf count, shape or dtype) raises a plain
  ``ValueError``, since an older checkpoint would not fix it;
* ``save(..., keep=N)`` keeps the newest N checkpoints, never deleting the
  newest one.

The port also writes the state's parameter names beside a checkpoint
(``model_step_k.dcg.tree``, one name a line; the reference reads no such
file, and neither package's ``model_step_(\\d+)(\\.dcg)?`` poll matches
it). Trees that hold the same leaves under other names (the pipeline's
``blocks.loop.b.*`` and the scanned LM's ``blocks.*``) are not
interchangeable: :func:`check_tree` refuses a resume across them. A
checkpoint the reference wrote carries no names, and is held to its leaf
count, shapes and dtypes only.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import struct
import zlib
from typing import NamedTuple, Sequence

import numpy as np

from draco_tpu_torch.utils import compress as compress_mod

_DCG_MAGIC = b"DCKP"


class LeafSpec(NamedTuple):
    """What :func:`load` expects of one leaf."""

    shape: tuple
    dtype: np.dtype


class CheckpointCorruptError(ValueError):
    """Torn checkpoint bytes (checksum mismatch, truncation, a torn header,
    a failed inflate): the class the walk-back retries past. Structural
    mismatches stay plain ValueError."""

    def __init__(self, path: str, reason: str, expected: str = "",
                 actual: str = ""):
        detail = f"corrupt checkpoint {path}: {reason}"
        if expected or actual:
            detail += (f" (expected checksum {expected or '?'}, "
                       f"actual {actual or '?'})")
        super().__init__(detail)
        self.path = path
        self.reason = reason
        self.expected = expected
        self.actual = actual


class LeafCountError(ValueError):
    """A checkpoint that holds ``count`` arrays for a state of
    ``expected`` leaves (a structural mismatch, never retried past)."""

    def __init__(self, count: int, expected: int):
        super().__init__(f"checkpoint holds {count} arrays, the state has "
                         f"{expected}")
        self.count, self.expected = count, expected


def _path(train_dir: str, step: int) -> str:
    return os.path.abspath(os.path.join(train_dir, f"model_step_{step}"))


def _sidecar(dcg_path: str) -> str:
    return dcg_path + ".sha256"


def _tree_file(dcg_path: str) -> str:
    return dcg_path + ".tree"


def save(train_dir: str, step: int, leaves: Sequence[np.ndarray],
         compress: bool = False, keep: int = 0,
         tree: Sequence[str] = ()) -> str:
    """Write step ``step``'s checkpoint of ``leaves`` (and ``tree``, the
    parameters' names, beside it); ``keep > 0`` then keeps only the newest
    ``keep`` checkpoints. Returns the ``.dcg`` path."""
    os.makedirs(train_dir, exist_ok=True)
    dcg = _path(train_dir, step) + ".dcg"
    level = 1 if compress else 0
    tmp = dcg + ".tmp"
    digest = hashlib.sha256()
    with open(tmp, "wb") as f:
        def put(chunk: bytes) -> None:
            digest.update(chunk)
            f.write(chunk)

        put(_DCG_MAGIC + struct.pack("<I", len(leaves)))
        for leaf in leaves:
            blob = compress_mod.compress(np.asarray(leaf), level)
            put(struct.pack("<Q", len(blob)))
            put(blob)
    sidecar = _sidecar(dcg)
    try:
        os.remove(sidecar)
    except FileNotFoundError:
        pass
    if tree:
        with open(_tree_file(dcg) + ".tmp", "w") as f:
            f.write("\n".join(tree) + "\n")
        os.replace(_tree_file(dcg) + ".tmp", _tree_file(dcg))
    os.replace(tmp, dcg)
    with open(sidecar + ".tmp", "w") as f:
        f.write(digest.hexdigest() + "\n")
    os.replace(sidecar + ".tmp", sidecar)
    gc_checkpoints(train_dir, keep)
    return dcg


def gc_checkpoints(train_dir: str, keep: int) -> list:
    """Delete every checkpoint in ``train_dir`` but the newest ``keep``
    (``keep <= 0`` keeps all); returns the deleted steps."""
    if keep <= 0:
        return []
    doomed = available_steps(train_dir)[:-max(keep, 1)]
    for step in doomed:
        path = _path(train_dir, step)
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        for f in (path + ".dcg", _sidecar(path + ".dcg"),
                  _tree_file(path + ".dcg")):
            if os.path.isfile(f):
                os.remove(f)
    return doomed


def _read_sidecar(path: str) -> str:
    sidecar = _sidecar(path)
    if not os.path.isfile(sidecar):
        return ""
    with open(sidecar) as f:
        return f.read().strip()


def verify(train_dir: str, step: int) -> None:
    """Check the step's ``.dcg`` bytes without a state: the sidecar's
    checksum, then the walk over the blob lengths. Raises
    :class:`CheckpointCorruptError` on torn bytes; no-op without a
    ``.dcg``."""
    path = _path(train_dir, step) + ".dcg"
    if not os.path.isfile(path):
        return
    expected = _read_sidecar(path)
    if expected:
        digest = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                digest.update(chunk)
        if digest.hexdigest() != expected:
            raise CheckpointCorruptError(path, "checksum mismatch",
                                         expected=expected,
                                         actual=digest.hexdigest())
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise CheckpointCorruptError(path, "truncated header")
        if head[:4] != _DCG_MAGIC:
            raise CheckpointCorruptError(path, "bad magic (torn header)")
        (count,) = struct.unpack("<I", head[4:])
        pos = 8
        for i in range(count):
            f.seek(pos)
            lenb = f.read(8)
            if len(lenb) < 8:
                raise CheckpointCorruptError(
                    path, f"truncated at blob {i} length")
            pos += 8 + struct.unpack("<Q", lenb)[0]
            if pos > size:
                raise CheckpointCorruptError(
                    path, f"truncated inside blob {i}")


def _load_dcg(path: str, specs: Sequence) -> list:
    """One streamed pass: the sidecar's digest accumulates over the reads
    the parse makes and is compared at the end, and on any failure, where
    a mismatch makes the failure a :class:`CheckpointCorruptError`."""
    expected = _read_sidecar(path)
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        def take(n: int, what: str) -> bytes:
            data = f.read(n)
            digest.update(data)
            if len(data) < n:
                raise CheckpointCorruptError(
                    path, f"truncated while reading {what} "
                          f"(needed {n} bytes, had {len(data)})")
            return data

        def check_digest() -> None:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                digest.update(chunk)
            if expected and digest.hexdigest() != expected:
                raise CheckpointCorruptError(
                    path, "checksum mismatch", expected=expected,
                    actual=digest.hexdigest())

        try:
            head = take(8, "header")
            if head[:4] != _DCG_MAGIC:
                raise CheckpointCorruptError(path,
                                             "bad magic (torn header)")
            (count,) = struct.unpack("<I", head[4:])
            if count != len(specs):
                raise LeafCountError(count, len(specs))
            out = []
            for spec in specs:
                (blen,) = struct.unpack("<Q", take(8, "blob length"))
                blob = take(blen, "blob")
                try:
                    arr = compress_mod.decompress(blob)
                except (zlib.error, struct.error, ValueError) as e:
                    raise CheckpointCorruptError(
                        path, f"blob decompress failed: {e}") from e
                if (tuple(arr.shape) != tuple(spec.shape)
                        or arr.dtype != np.dtype(spec.dtype)):
                    raise ValueError(
                        f"checkpoint leaf {arr.shape}/{arr.dtype} does not "
                        f"match the state's {tuple(spec.shape)}/"
                        f"{np.dtype(spec.dtype)}")
                out.append(arr)
        except Exception:
            # the checksum's verdict wins: torn bytes that parse into a
            # structural-looking failure are still corruption
            check_digest()
            raise
        check_digest()
    return out


def load(train_dir: str, step: int, specs: Sequence) -> list:
    """The step's leaves as numpy arrays, each checked against ``specs``
    (``LeafSpec`` or anything with ``shape`` and ``dtype``)."""
    path = _path(train_dir, step)
    if os.path.isfile(path + ".dcg"):
        return _load_dcg(path + ".dcg", specs)
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is an Orbax directory (the reference's checkpoint "
            f"without compress_ckpt); the port reads .dcg checkpoints only "
            f"— re-save it with the reference's compress_ckpt=True")
    raise FileNotFoundError(f"no checkpoint {path}.dcg")


def _tree_kind(names: Sequence[str]) -> str:
    if any(n.startswith("blocks.loop.b.") for n in names):
        return "pipeline (pp, blocks.loop.b.*)"
    if any(n.startswith("blocks.") for n in names):
        return "stacked LM (scan_layers, blocks.*)"
    if any(n.startswith("block0.") for n in names):
        return "unrolled LM (block{i}.*)"
    return "model"


def check_tree(train_dir: str, step: int, names: Sequence[str]) -> None:
    """Refuse (``ValueError``) a checkpoint whose names (written beside it
    by the port) are not ``names``, this run's tree; one without names
    passes (the reference's)."""
    path = _tree_file(_path(train_dir, step) + ".dcg")
    if not names or not os.path.isfile(path):
        return
    with open(path) as f:
        held = tuple(f.read().split())
    if held != tuple(names):
        raise ValueError(
            f"checkpoint step {step} in {train_dir!r} holds a "
            f"{_tree_kind(held)} tree of {len(held)} parameters; this run's "
            f"is a {_tree_kind(names)} tree of {len(names)}: the two are "
            f"not interchangeable, and the resume is refused")


def exists(train_dir: str, step: int) -> bool:
    path = _path(train_dir, step)
    return os.path.isdir(path) or os.path.isfile(path + ".dcg")


def available_steps(train_dir: str) -> list:
    if not train_dir or not os.path.isdir(train_dir):
        return []
    steps = set()
    for name in os.listdir(train_dir):
        m = re.fullmatch(r"model_step_(\d+)(\.dcg)?", name)
        if m:
            steps.add(int(m.group(1)))
    return sorted(steps)
