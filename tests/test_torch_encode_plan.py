"""The read and write plan of the cyclic encode kernels, emulated on the
CPU (``draco_tpu_torch/csrc/coded.cu``: ``encode``'s choice of V,
``complex_matmul_kernel``'s warp windows, ``complex_matmul_lines_kernel``'s
block windows and line-stored rows, the row groups and groups of kK rows
of G, and the shared-memory layout of W).

A numpy model of the kernels' index arithmetic: a lane takes the V columns
[V·c, V·c + V) of every row (V = 4 where d is a multiple of 32 and the
three buffers start 128-byte aligned, 2 where d is even and they start
8-byte aligned, else 1), kRowGroup = 8 output rows at a time (at m = 9 a
group of 8 and a second, one-row group), and loads
the rows of G kK = 8 at a time; W's rows are padded to a multiple of kK in
shared memory and read 16 bytes at a time. At V = 4 and 1 a warp takes
windows of 32 groups and a lane stores its own; at V = 2 a block's window
computes the 256 groups [240w − 16, 240w + 240), stages them, and stores,
of each output row, the 240 groups from the row's own 128-byte line, two
staged groups a lane (16 bytes). For every buffer alignment (the start of
G and of both outputs, 0–120 bytes past a 128-byte line), d ≡ 0…15
(mod 16) and m, n in {1, 5, 8, 9, 64}:

- every element of both outputs is written exactly once, with the sums of
  the thread that computed its group;
- no load leaves G and no store leaves its output, and every access is
  aligned to its width;
- at V = 2 every window's store of a row starts on a 128-byte line (but
  for the row's first, partial, line);
- every coefficient the kernel reads from shared memory for row i and
  term k is W[i, k] (the padding only where k >= n, whose products are
  never taken), and no read leaves the 2·m·np floats.

No GPU and no JAX; seconds.
"""

import numpy as np
import pytest

K, ROWS = 8, 8  # kK, kRowGroup
BASE = 1 << 16  # a 4 KB-aligned address
D0 = 1024  # d = D0 + residue


THREADS, LINE = 256, 16  # kThreads; kLineGroups, float2 groups a line
STORED = THREADS - LINE  # the groups a block window stores a row


def width(d, g, out_re, out_im):
    """``encode``: the columns a lane takes."""
    any_ = g | out_re | out_im
    if d % 32 == 0 and any_ % 128 == 0:
        return 4
    if d % 2 == 0 and any_ % 8 == 0:
        return 2
    return 1


def line_shift(addr):
    """``line_shift``: the first float2 group at a 128-byte line."""
    return ((128 - addr % 128) % 128) // 8


def check(m, n, d, offsets):
    g, o_re, o_im = (BASE + 3 * (m * n * d + 64) * 4 * k + off
                     for k, off in enumerate(offsets))
    v = width(d, g, o_re, o_im)
    assert d % v == 0
    groups = d // v
    if v == 2:
        windows = -(-(groups + LINE) // STORED)
        c0 = np.arange(windows, dtype=np.int64) * STORED - LINE
        c = c0[:, None] + np.arange(THREADS)  # (windows, threads)
    else:
        windows = -(-groups // 32)
        c0 = np.arange(windows, dtype=np.int64) * 32
        c = c0[:, None] + np.arange(32)  # (windows, lanes)
    live = (c >= 0) & (c < groups)
    # loads: row k of G, the lane's V columns, every row group
    for k in range(n):
        addr = g + (k * d + c[live] * v) * 4
        assert np.all(addr % (4 * v) == 0), "a misaligned load"
        assert np.all(addr >= g) and np.all(addr + 4 * v <= g + n * d * 4), \
            "a load leaves G"
    # stores: each output element counted
    for out in (o_re, o_im):
        written = np.zeros(m * d, dtype=np.int64)
        for i0 in range(0, m, ROWS):
            for q in range(ROWS):
                if i0 + q >= m:
                    continue
                row = out + (i0 + q) * d * 4
                if v != 2:
                    addr = row + c[live] * v * 4
                    assert np.all(addr % (4 * v) == 0), "a misaligned store"
                    firsts = [addr]
                else:
                    # lane h stores the staged pair e, e + 1: groups at,
                    # at + 1, computed by threads e and e + 1
                    e = line_shift(row) + 2 * np.arange(STORED // 2)
                    at = c0[:, None] + e
                    assert e.max() + 1 < THREADS
                    assert np.array_equal(c[:, e], at)
                    assert np.array_equal(c[:, e + 1], at + 1)
                    start = row + at[:, 0] * 8
                    assert np.all(start[at[:, 0] >= 0] % 128 == 0), \
                        "a window's store of a row starts off a line"
                    whole = (at >= 0) & (at + 1 < groups)
                    wide = row + at[whole] * 8
                    assert np.all(wide % 16 == 0), "a misaligned 16-byte store"
                    assert np.all(live[:, e][whole] & live[:, e + 1][whole])
                    edge = np.concatenate([at[~whole], at[~whole] + 1])
                    edge = edge[(edge >= 0) & (edge < groups)]
                    firsts = [wide, wide + 8, row + edge * 8]
                for addr in firsts:
                    assert np.all(addr >= out) and \
                        np.all(addr + 4 * min(v, 2) <= out + m * d * 4), \
                        "a store leaves its output"
                    elem = (addr - out) // 4
                    np.add.at(written, (elem[:, None]
                                        + np.arange(v if v != 2 else 2)
                                        ).ravel(), 1)
        assert np.array_equal(written, np.ones(m * d)), \
            "an output element written twice or never"
    return v


def check_shared_w(m, n):
    """The shared-memory image of W (rows padded to kK with zeros) and the
    kernel's 16-byte reads of it: row i0 + q, terms k0 .. k0 + 7."""
    rng = np.random.RandomState(m * 100 + n)
    w = {"re": rng.normal(size=(m, n)), "im": rng.normal(size=(m, n))}
    np_ = -(-n // K) * K
    sw = np.full(2 * m * np_, np.nan)
    for t in range(m * np_):  # the kernel's fill loop
        i, k = divmod(t, np_)
        sw[t] = w["re"][i, k] if k < n else 0.0
        sw[m * np_ + t] = w["im"][i, k] if k < n else 0.0
    sw4 = sw.reshape(-1, 4)
    for i0 in range(0, m, ROWS):
        for k0 in range(0, n, K):
            for q in range(ROWS):
                if i0 + q >= m:
                    continue
                pr = ((i0 + q) * np_ + k0) // 4
                pi = ((m + i0 + q) * np_ + k0) // 4
                assert ((i0 + q) * np_ + k0) % 4 == 0
                assert pr + 2 <= len(sw4) and pi + 2 <= len(sw4)
                wr = np.concatenate([sw4[pr], sw4[pr + 1]])
                wi = np.concatenate([sw4[pi], sw4[pi + 1]])
                for r in range(K):
                    if k0 + r < n:
                        assert wr[r] == w["re"][i0 + q, k0 + r]
                        assert wi[r] == w["im"][i0 + q, k0 + r]
                    else:
                        assert wr[r] == 0.0 and wi[r] == 0.0


# G's start, then both outputs' (bytes past a 128-byte line)
OFFSETS = [(a, 0, 0) for a in (0, 4, 8, 32, 120)] \
    + [(0, a, 0) for a in (8, 64)] + [(0, 0, a) for a in (4, 96)] \
    + [(0, 8, 24)]
SIZES = (1, 5, 8, 9, 64)


@pytest.mark.parametrize("m", SIZES)
def test_encode_plan(m):
    widths = set()
    # 64 rows already start at every line shift of a buffer
    offsets_of = OFFSETS if m < 64 else OFFSETS[::3]
    for n in SIZES:
        check_shared_w(m, n)
        for res in range(16):
            for offsets in offsets_of:
                widths.add(check(m, n, D0 + res, offsets))
    assert widths == {1, 2, 4}


def test_every_last_window():
    """d = 2·(240·4 + r) for r over every residue mod 240 in steps of 7,
    and every window tail: the last block window's 240 stored groups end
    at each place against the row's end, at several line shifts."""
    for r in list(range(0, 240, 7)) + [238, 239]:
        for offsets in ((0, 8, 24), (8, 16, 0), (16, 0, 0)):
            assert check(9, 8, 2 * (240 * 4 + r), offsets) == 2


def test_the_main_paths_widths():
    """ResNet-18's d (≡ 2 mod 8: row i starts 40·i mod 128 bytes past a
    line) takes float2 columns stored a line at a time, the LM's (a
    multiple of 32) float4, on buffers that start 512-byte aligned as the
    caching allocator gives them."""
    assert width(11_173_962, BASE, BASE + 512, BASE + 1024) == 2
    assert [line_shift(BASE + i * 11_173_962 * 4) for i in range(5)] == \
        [0, 11, 6, 1, 12]
    assert width(62_958_336, BASE, BASE + 512, BASE + 1024) == 4


def test_the_vgg_legs_rows():
    """VGG-11's d = 9,750,922 at m = n = 9 (preset cyclic-vgg11): float2
    columns, and row i starts 40·i mod 128 bytes past a line, as
    ResNet-18's rows do; the nine output rows are a group of 8 and a
    second, one-row group, each stored a line at a time from the staging.
    d mod 32 sets the rows' line shifts and d mod 480 where the last block
    window ends ((d/2 + 16) mod 240), so the model at the small d ≡
    9,750,922 (mod 480) runs the VGG legs' plan, at every buffer alignment
    of OFFSETS."""
    d = 9_750_922
    assert width(d, BASE, BASE + 512, BASE + 1024) == 2
    assert d * 4 % 128 == 40
    small = d % 480 + 4 * 480
    assert [line_shift(BASE + i * d * 4) for i in range(9)] == \
        [line_shift(BASE + i * small * 4) for i in range(9)] == \
        [0, 11, 6, 1, 12, 7, 2, 13, 8]
    for offsets in OFFSETS:
        v = check(9, 9, small, offsets)
        assert v == (2 if all(o % 8 == 0 for o in offsets) else 1)
