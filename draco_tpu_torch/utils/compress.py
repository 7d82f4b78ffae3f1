"""Array packing for checkpoints (draco_tpu/utils/compress.py, its numpy
path).

One array becomes ``DCG1`` + a header (element size, dtype string, shape,
byte count) + a zlib stream of its bytes, byte-shuffled first: byte j of
every element, then byte j + 1 of every element, and so on (blosc's
SHUFFLE filter), so the like bytes of float32s sit together. The
reference's numpy and native backends give the same stream, and so does
this copy: a checkpoint written by either package decompresses in the
other. ``level`` is zlib's: 1 (the reference's default) or 0 (stored,
the bytes framed as they are).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = b"DCG1"


def _shuffle(raw: bytes, elem: int) -> bytes:
    a = np.frombuffer(raw, np.uint8)
    n = (len(a) // elem) * elem
    return a[:n].reshape(-1, elem).T.tobytes() + a[n:].tobytes()


def _unshuffle(raw: bytes, elem: int) -> bytes:
    a = np.frombuffer(raw, np.uint8)
    n = (len(a) // elem) * elem
    body = np.ascontiguousarray(a[:n].reshape(elem, -1).T)
    return body.tobytes() + a[n:].tobytes()


def compress(arr: np.ndarray, level: int = 1) -> bytes:
    """Pack an ndarray (any layout; a 0-d array keeps its shape)."""
    arr = np.asarray(arr)
    if arr.ndim:
        arr = np.ascontiguousarray(arr)
    elem = arr.dtype.itemsize
    dt = arr.dtype.str.encode()
    header = (_MAGIC + struct.pack("<BBH", elem, len(dt), arr.ndim) + dt
              + struct.pack(f"<{arr.ndim}q", *arr.shape)
              + struct.pack("<q", arr.nbytes))
    raw = arr.tobytes()
    if elem > 1 and arr.nbytes >= elem:
        raw = _shuffle(raw, elem)
    return header + zlib.compress(raw, level)


def decompress(buf: bytes) -> np.ndarray:
    """Unpack what :func:`compress` (or the reference's) packed."""
    if buf[:4] != _MAGIC:
        raise ValueError("not a draco_tpu compressed array")
    elem, dt_len, ndim = struct.unpack_from("<BBH", buf, 4)
    off = 8
    dtype = np.dtype(buf[off:off + dt_len].decode())
    off += dt_len
    shape = struct.unpack_from(f"<{ndim}q", buf, off)
    off += 8 * ndim
    (nbytes,) = struct.unpack_from("<q", buf, off)
    raw = zlib.decompress(buf[off + 8:])
    if elem > 1 and nbytes >= elem:
        raw = _unshuffle(raw, elem)
    return np.frombuffer(raw, dtype).reshape(shape).copy()
