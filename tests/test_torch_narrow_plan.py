"""The read plan of the narrow-wire decode kernels, emulated on the CPU
(``draco_tpu_torch/csrc/narrow_decode.cu``: ``wide_span``, ``join``,
``strip_of``, ``blocks_of``, ``block_of``, ``widen_strip`` and the window
loop of ``narrow_recombine_kernel`` / ``approx_decode_partial_kernel``).

A numpy model of the kernels' index arithmetic, in their order: each lane
of a warp loads the CB-byte aligned chunk that holds the start of its
strip (when the strip is at most the span's end), takes lane+1's chunk by
a shuffle, selects whole words by the row's misalignment a >> 2 in steps of
CW/2 ... 1 words and funnel-shifts by (a & 3) bytes; 31 strips a window;
the columns outside the wide span go to the scalar loop. Every byte of the
buffer is labelled with its offset, so the model holds, for every row
alignment 0–15 (the buffer's start mod 16), d ≡ 0…15 (mod 16) and the int8
blocks 1, 24, 64 and 256:

- every column of every row is summed exactly once (a wide strip or the
  scalar loop);
- no load leaves the allocation;
- the bytes a strip sums are exactly its row's columns, in order: bytes of
  a neighbouring row are shifted out;
- the scale index of every column equals ``j // block`` (one scale a strip
  where the strip divides the block, else counted up column by column).

And the int8 and bf16 widening (a byte perm into 2^23 + 128, a shift) gives
the exact f32 of every level. The approx decode's offset entry (a view of
columns [col0, col0 + d) of an (n, ld) buffer, ``wide_span_view``) is held
to the same four properties at every buffer alignment, first column 0–19
and view width, its loads inside the whole buffer and its scale index the
absolute column's. The segmented recombination over a segment plan
(``narrow_recombine_segments_kernel``: the window loop over the strips of
the plan's columns, each lane walking the cuts up to its strip's segment,
the strips a cut crosses and the columns outside the wide strips in the
scalar loop, ``segment_of``'s binary search there) is held, at every
buffer alignment, d mod 16, int8 blocks 1, 24, 64 and 256 and cuts at every
alignment of a strip and of a scale block (segments of 1 and 9 columns,
several cuts in one strip, plans that start and end inside the buffer), to
every column of the plan summed exactly once with the v of its own
segment, every load inside the allocation and every scale index
``j // block``. No GPU and no JAX; seconds.

The CPU program lint (``analysis/rules.py``) of the narrow and segmented
wires' legs (``shared_bf16``, ``shared_int8``, ``majvote``,
``shared_int8_seg4``, ``approx_int8_seg4``) is held here as
``test_torch_audit.py`` holds the other legs: in a file of many tests, which
xdist's loadfile schedules early (it orders files by their count of tests).
"""

import numpy as np
import pytest
import torch

from test_torch_audit import NARROW_LEGS, assert_green, lint_rows_of

STRIPS = 31  # kStrips: strips a warp computes a window
BASE = 1 << 16  # a 4 KB-aligned address; the buffer starts BASE + offset
N = 3  # rows: a first, a middle and a last one
D0 = 160  # d = D0 + residue: 10 int8 strips a row, two windows at bf16


def wide_span(base, n, d, sz, cb):
    """``wide_span``: the strips [lo, hi) whose chunk and the chunk after
    lie inside the buffer for every row."""
    w = cb // sz
    e = base + n * d * sz
    last = (base + (n - 1) * d * sz) & ~(cb - 1)
    lo = 1 if base & (cb - 1) else 0
    end = (e - last) // cb - 1
    hi = min(d // w, end)
    return (lo, hi) if hi > lo else (0, 0)


def meet(x, y):
    lo, hi = max(x[0], y[0]), min(x[1], y[1])
    return (lo, hi) if hi > lo else (0, 0)


def lanes(span):
    """(s, mine, feed) of every lane of every window, (windows·32,)."""
    lo, hi = span
    windows = -(-(hi - lo) // STRIPS)
    win = np.repeat(np.arange(windows), 32)
    lane = np.tile(np.arange(32), windows)
    s = lo + win * STRIPS + lane
    return s, (lane < STRIPS) & (s < hi), s <= hi


def wide_span_view(base, n, d, ld, col0, sz, cb):
    """``wide_span_view``: a view of d columns from column col0 of n rows
    ld apart, every load inside the whole (n, ld) buffer."""
    w = cb // sz
    start = base - col0 * sz
    e = start + n * ld * sz
    last = (base + (n - 1) * ld * sz) & ~(cb - 1)
    lo = 1 if (base & ~(cb - 1)) < start else 0
    end = (e - last) // cb - 1
    hi = min(d // w, end)
    return (lo, hi) if hi > lo else (0, 0)


def strips_read(base, n, d, sz, cb, span, ld=None, col0=0):
    """The byte labels (offsets into the buffer, -2 for a chunk not loaded)
    the kernel's join leaves for every row and lane: (n, lanes, cb), with
    every load checked against the allocation. ``ld``, ``col0``: a view of
    an (n, ld) buffer from its column col0 (labels from the buffer's
    start)."""
    cw = cb // 4
    ld = d if ld is None else ld
    start = base - col0 * sz
    e = start + n * ld * sz
    s, mine, feed = lanes(span)
    out = []
    for i in range(n):
        p = base + i * ld * sz
        chunk, a = p & ~(cb - 1), p & (cb - 1)
        addr = chunk + s * cb
        lo = np.where(feed[:, None], addr[:, None] - start + np.arange(cb),
                      -2)
        loaded = addr[feed]
        assert np.all(loaded >= start) and np.all(loaded + cb <= e), \
            "a load leaves the allocation"
        # __shfl_down_sync(…, 1): lane l takes lane l+1's chunk; lane 31
        # keeps its own
        hi = lo.reshape(-1, 32, cb)
        hi = np.concatenate([hi[:, 1:], hi[:, 31:]], axis=1).reshape(-1, cb)
        win = np.concatenate([lo, hi], axis=1).reshape(-1, 2 * cw, 4)
        q, r = a >> 2, a & 3
        b = cw // 2
        while b >= 1:  # whole words, in place in increasing k, as join
            if q & b:
                win = np.concatenate([win[:, b:], win[:, 2 * cw - b:]],
                                     axis=1)
            b //= 2
        pair = np.concatenate([win[:, :cw], win[:, 1:cw + 1]], axis=2)
        out.append(pair[:, :, r:r + 4].reshape(-1, cb))  # __funnelshift_r
    return np.stack(out), s, mine


def check_plan(offset, d, sz, cb, others=()):
    """The plan of a kernel reading a buffer of sz-byte elements in
    cb-byte chunks beside ``others`` ((sz, cb) of buffers read in the same
    strips, their own offsets 0): coverage, bounds, row bytes. Returns the
    mine strips' first columns and the strip width."""
    w = cb // sz
    base = BASE + offset
    span = wide_span(base, N, d, sz, cb)
    for osz, ocb in others:
        assert ocb // osz == w
        span = meet(span, wide_span(BASE, N, d, osz, ocb))
    got, s, mine = strips_read(base, N, d, sz, cb, span)
    for osz, ocb in others:
        strips_read(BASE, N, d, osz, ocb, span)  # bounds of the others
    cols = s[mine]
    for i in range(N):
        want = ((i * d + cols[:, None] * w) * sz
                + np.arange(cb)[None, :])
        assert np.array_equal(got[i][mine], want), \
            f"row {i}: a strip sums bytes that are not its columns"
    lo, hi = span
    c0, c1 = lo * w, hi * w
    covered = np.concatenate([(cols[:, None] * w + np.arange(w)).ravel(),
                              np.arange(c0), np.arange(c1, d)])
    assert np.array_equal(np.sort(covered), np.arange(d)), \
        "a column is summed twice or never"
    return cols * w, w


def scale_blocks(j0, w, block, one=None):
    """The kernels' block index of each column of the strips at j0 (one
    scale a strip where ``one``, by default where the strip divides the
    block)."""
    if block % w == 0 if one is None else one:  # block_of(j0), 32-bit
        return np.repeat((j0 % (1 << 32)) // block, w).reshape(-1, w)
    b = j0 // block  # blocks_of: counted up from j0's
    rem = j0 - b * block
    out = np.empty((len(j0), w), dtype=np.int64)
    for k in range(w):
        out[:, k] = b
        rem = rem + 1
        wrap = rem == block
        rem = np.where(wrap, 0, rem)
        b = b + wrap
    return out


CASES = [(o, r) for o in range(16) for r in range(16)]
BLOCKS = (1, 24, 64, 256)


@pytest.mark.parametrize("block", BLOCKS)
def test_recombine_int8_plan(block):
    """16-byte chunks of int8 levels (16 columns a strip), two buffers."""
    for offset, res in CASES:
        d = D0 + res
        j0, w = check_plan(offset, d, 1, 16, others=((1, 16),))
        blk = scale_blocks(j0, w, block)
        assert np.array_equal(blk, (j0[:, None] + np.arange(w)) // block)
        assert blk.max(initial=0) < -(-d // block)


@pytest.mark.parametrize("sz", (2, 4), ids=("bf16", "f32"))
def test_recombine_wide_plan(sz):
    """16-byte chunks of bf16 (8 columns) and f32 (4 columns)."""
    for offset, res in CASES:
        # a buffer of 2- or 4-byte elements starts on its element size
        check_plan(offset - offset % sz, D0 + res, sz, 16,
                   others=((sz, 16),))


@pytest.mark.parametrize("sz,block", [(1, b) for b in BLOCKS]
                         + [(2, 256), (4, 256)],
                         ids=[f"int8-{b}" for b in BLOCKS] + ["bf16", "f32"])
def test_approx_plan(sz, block):
    """4 columns a strip: 4·sz bytes of wire beside a 16-byte chunk of the
    (n, d) f32 batch gradients."""
    for offset, res in CASES:
        d = D0 + res
        j0, w = check_plan(offset - offset % sz, d, sz, 4 * sz,
                           others=((4, 16),))
        assert w == 4
        if sz == 1:
            blk = scale_blocks(j0, w, block)
            assert np.array_equal(blk, (j0[:, None] + np.arange(w)) // block)


def check_view_plan(offset, ld, col0, d, sz, cb):
    """The offset entry's plan: a view of d columns from column col0 of
    an (N, ld) buffer of sz-byte elements read in cb-byte chunks, beside
    the (N, ld) f32 batch gradients at the same columns (16-byte chunks):
    coverage, bounds and row bytes as ``check_plan``. Returns the mine
    strips' first columns (of the view) and the strip width."""
    w = cb // sz
    base = BASE + offset + col0 * sz
    span = meet(wide_span_view(base, N, d, ld, col0, sz, cb),
                wide_span_view(BASE + col0 * 4, N, d, ld, col0, 4, 16))
    got, s, mine = strips_read(base, N, d, sz, cb, span, ld, col0)
    strips_read(BASE + col0 * 4, N, d, 4, 16, span, ld, col0)
    cols = s[mine]
    for i in range(N):
        want = ((i * ld + col0 + cols[:, None] * w) * sz
                + np.arange(cb)[None, :])
        assert np.array_equal(got[i][mine], want), \
            f"row {i}: a strip sums bytes that are not its columns"
    lo, hi = span
    covered = np.concatenate([(cols[:, None] * w + np.arange(w)).ravel(),
                              np.arange(lo * w), np.arange(hi * w, d)])
    assert np.array_equal(np.sort(covered), np.arange(d)), \
        "a column is summed twice or never"
    return cols * w, w


@pytest.mark.parametrize("sz,block", [(1, 64), (1, 24), (1, 1), (2, 256),
                                      (4, 256)],
                         ids=["int8-64", "int8-24", "int8-1", "bf16", "f32"])
def test_approx_offset_plan(sz, block):
    """The offset entry at every buffer alignment, first column 0–19 and
    widths from below a strip to the rest of the row: at col0 = 0 and the
    whole row it is the whole-buffer plan; the scale of every column is
    its absolute column's block, one a strip only where the block and
    col0 are multiples of the strip."""
    ld = D0 + 37
    for offset in range(0, 16, sz):
        for col0 in range(20):
            for d in (1, 3, 4, 5, 31, 77, ld - col0):
                j0, w = check_view_plan(offset, ld, col0, d, sz, 4 * sz)
                if sz == 1:
                    one = block % w == 0 and col0 % w == 0
                    blk = scale_blocks(col0 + j0, w, block, one)
                    assert np.array_equal(
                        blk, (col0 + j0[:, None] + np.arange(w)) // block)
    for offset in range(0, 16, sz):
        assert wide_span_view(BASE + offset, N, ld, ld, 0, sz, 4 * sz) == \
            wide_span(BASE + offset, N, ld, sz, 4 * sz)


def test_every_alignment_and_residue_is_taken():
    """The cases cover every start mod 16 and d mod 16, and the rows of the
    int8 buffers every alignment 0–15."""
    aligns = {(BASE + o + i * (D0 + r)) % 16 for o, r in CASES
              for i in range(N)}
    assert aligns == set(range(16))
    assert {(D0 + r) % 16 for _, r in CASES} == set(range(16))


def test_a_buffer_shorter_than_a_strip_goes_to_the_scalar_loop():
    for sz, cb in ((1, 16), (2, 16), (4, 16), (1, 4)):
        for d in range(1, cb // sz):
            assert wide_span(BASE + 3 * (sz == 1), 1, d, sz, cb) == (0, 0)
            check_plan(3 if sz == 1 else 0, d, sz, cb)


def test_int8_and_bf16_widening_is_exact():
    """widen_strip: level + 128 in the low mantissa byte of 2^23, minus
    2^23 + 128, is the level; a bf16 is its bits shifted into the high
    half of a float."""
    levels = np.arange(-128, 128, dtype=np.int8)
    biased = levels.view(np.uint8).astype(np.uint32) ^ 0x80
    got = (np.uint32(0x4B000000) | biased).view(np.float32) \
        - np.float32(8388736.0)
    assert got.dtype == np.float32
    assert np.array_equal(got, levels.astype(np.float32))
    bits = np.arange(0, 1 << 16, 97, dtype=np.uint32)
    bf = torch.from_numpy(bits.astype(np.int32).astype(np.int16)).view(
        torch.bfloat16).float().numpy()
    wide = (bits << 16).view(np.float32)
    finite = np.isfinite(bf)
    assert np.array_equal(wide[finite], bf[finite])
    assert np.array_equal(np.isnan(wide), np.isnan(bf))


# --------------------------------------------------------------------------
# the segmented recombination over a segment plan
# --------------------------------------------------------------------------

def segment_of(bounds, j):
    """``segment_of``: the binary search over the cuts (cut_after(mid - 1)
    is the first column of segment mid)."""
    lo, hi = 0, len(bounds) - 2
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if bounds[mid] <= j:
            lo = mid
        else:
            hi = mid - 1
    return lo


def segments_plan(offset, d, sz, bounds, warps=3):
    """The kernel's plan on an (N, d) buffer of sz-byte elements starting
    BASE + offset beside one at BASE (16-byte chunks), over the cuts
    ``bounds``, with ``warps`` warps striding over the windows. Returns
    {column: (segment, wide strip's first column or None)}; raises on a
    column summed twice, a load outside either buffer or a strip whose
    bytes are not its row's."""
    w = 16 // sz
    base = BASE + offset
    S = len(bounds) - 1
    p0, p1 = bounds[0], bounds[-1]

    def cut_after(seg):  # seg = -1: p0; the last segment: p1
        return bounds[seg + 1]

    span = meet(meet(wide_span(base, N, d, sz, 16),
                     wide_span(BASE, N, d, sz, 16)),
                (-(-p0 // w), p1 // w))
    got, _, _ = strips_read(base, N, d, sz, 16, span)
    strips_read(BASE, N, d, sz, 16, span)  # the other buffer's bounds
    done = {}
    lo, hi = span
    windows = -(-(hi - lo) // STRIPS)
    for warp in range(warps):
        seg = [0] * 32
        steps = [0] * 32
        for win in range(warp, windows, warps):
            for lane in range(STRIPS):
                st = lo + win * STRIPS + lane
                if st >= hi:
                    continue
                j0 = st * w
                nxt = cut_after(seg[lane])
                while nxt <= j0:
                    seg[lane] += 1
                    steps[lane] += 1
                    nxt = cut_after(seg[lane])
                if nxt < j0 + w:  # a cut strictly inside: the scalar loop
                    continue
                for i in range(N):
                    want = (i * d + j0) * sz + np.arange(16)
                    assert np.array_equal(got[i][win * 32 + lane], want), \
                        f"row {i}: a strip sums bytes that are not its columns"
                for j in range(j0, j0 + w):
                    assert j not in done, f"column {j} summed twice"
                    done[j] = (seg[lane], j0)
        assert max(steps) <= S - 1  # the walk: each cut passed once
    wide = hi > lo
    c0, c1 = (lo * w, hi * w) if wide else (p0, p0)
    head, edge = c0 - p0, c0 - p0 + p1 - c1
    for t in range(edge + (S - 1) * w):
        if t < head:
            j = p0 + t
        elif t < edge:
            j = c1 + t - head
        else:
            k = 1 + (t - edge) // w
            c, b = cut_after(k - 1), cut_after(k - 2)
            sc = c // w
            crosses = c % w != 0 and lo <= sc < hi
            first = not (b % w != 0 and b // w == sc)
            if not (crosses and first):
                continue
            j = sc * w + (t - edge) % w
        assert j not in done, f"column {j} summed twice"
        done[j] = (segment_of(bounds, j), None)
    return done


def segment_cuts(d):
    """Plans over d columns: every cut residue mod 16, cuts on, before and
    after scale blocks of 24, 64 and 256, segments of 1 and 9 columns,
    several cuts in one strip, and plans that start or end inside the
    buffer."""
    every = tuple([0] + [67 * i for i in range(1, 16)] + [d])
    return [every,
            (0, 1, 10, 11, 20, d),
            (0, 5, 9, 12, 40, 41, 47, d),
            (0, 23, 24, 25, 63, 64, 65, 255, 256, 257, 512, 769, d),
            (0, 256, 512, 768, d),
            (3, 700),
            (17, 18, 27, d - 5),
            (0, d)]


SEG_BLOCKS = (1, 24, 64, 256)


@pytest.mark.parametrize("sz", (1, 2), ids=("int8", "bf16"))
def test_segments_plan(sz):
    """Every column of the plan summed exactly once, with its own
    segment's v; the loads inside both buffers; the scale index of every
    column j // block (one scale a strip where 16 divides the block, else
    counted up column by column from the strip's first)."""
    for offset in range(0, 16, sz):
        for res in range(16):
            d = 1008 + res
            for bounds in segment_cuts(d):
                done = segments_plan(offset, d, sz, bounds)
                cols = np.arange(bounds[0], bounds[-1])
                assert sorted(done) == list(cols), \
                    "a column of the plan is summed never, or one outside it"
                seg = np.searchsorted(bounds, cols, side="right") - 1
                assert [done[j][0] for j in cols] == list(seg)
                if sz != 1:
                    continue
                j0 = np.array(sorted({v[1] for v in done.values()
                                      if v[1] is not None}), dtype=np.int64)
                for block in SEG_BLOCKS:
                    blk = scale_blocks(j0, 16, block)
                    assert np.array_equal(
                        blk, (j0[:, None] + np.arange(16)) // block)


def test_segments_plan_walk_with_one_warp_and_many():
    """The walk does not depend on how the windows are dealt to warps: one
    warp takes every window, or every warp one."""
    d = 5003
    for bounds in ((0, 1, 10, 2059, 2060, 4100, d), (0, d)):
        for warps in (1, 2, 64):
            done = segments_plan(3, d, 1, bounds, warps)
            assert sorted(done) == list(range(d))


def test_segments_plan_tiny_and_outside_the_span():
    """A plan narrower than a strip, and one over the first or last strip
    of a buffer that does not start on a chunk, go to the scalar loop
    alone."""
    d = 203
    for bounds in ((0, 3), (5, 9), (0, 1, 2, 3), (d - 7, d), (190, 200, d)):
        for offset in (0, 3, 13):
            done = segments_plan(offset, d, 1, bounds)
            assert sorted(done) == list(range(bounds[0], bounds[-1]))


# --------------------------------------------------------------------------
# the CPU program lint of these legs (test_torch_audit.py's rule)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lint_rows():
    return lint_rows_of(NARROW_LEGS)


@pytest.mark.parametrize("leg", NARROW_LEGS)
def test_every_leg_green_on_the_cpu_rules(lint_rows, leg):
    assert_green(lint_rows[leg], leg)
