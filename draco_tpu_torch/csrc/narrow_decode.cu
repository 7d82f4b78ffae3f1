// Decode kernels that read the wire as it arrived — f32, bf16, or int8
// levels with per-block f32 scales — by hand for Hopper (sm_90a). Plain C
// interface, loaded with ctypes by draco_tpu_torch/ops/decode_kernels.py;
// every launch goes on the caller's stream and the functions return
// cudaGetLastError().
//
// Replaces the Pallas TPU kernels of draco_tpu/ops/decode_kernels.py:
//   narrow_recombine  <- _cyclic_recombine_kernel_{bf16,int8} /
//                        _cyclic_recombine_pallas (pallas_call :378),
//                        with _dequant_tile (:174)
//   approx_decode     <- _approx_decode_kernel{,_narrow} /
//                        _approx_decode_pallas (pallas_call :271)
//   narrow_recombine_segments <- _cyclic_recombine_pallas once a segment
//                        on the [a, b) slices of the buffers
//                        (cyclic_narrow_recombine_segment, :458)
// and approx_decode's launch takes a column offset and a row stride: the
// reference's approx_decode_segment (:465) on [a, b) of the (n, d)
// buffers, read in place.
//
// What bounds them on an H100: both stream (n, d) operands once with
// n <= 64 (n = 8 on the main path) and do a few flops per element, far
// below the card's balance point — they are bound by device-memory bytes
// (3.35 TB/s). At n = 8, d = 11,173,962: the narrow recombination reads
// 2·n·d wire elements (bf16 357.6 MB, int8 178.8 MB + 2·n·⌈d/256⌉ scales)
// and writes d f32; the approx decode reads n·d wire elements and the
// (n, d) f32 batch gradients and writes d f32.
//
// Design against that bound: a thread owns a strip of W consecutive
// columns and reads each row of a strip with one aligned load of a chunk
// of CB bytes through the read-only path (the recombination: 16 bytes, so
// 16 int8, 8 bf16 or 4 f32 columns; the approx decode: 4 columns, a
// 16-byte chunk of the f32 batch gradients beside 4·sizeof(wire) bytes of
// wire). The loads of every row of a group (the recombination: 4 rows of
// each buffer; the approx decode: 8 rows) are issued before any
// arithmetic. Rows are not aligned to a chunk (d = 11,173,962 ≡ 10 mod 16:
// int8 row i starts at byte 10·i mod 16), so lane l loads the aligned
// chunk that holds the start of its strip, takes the chunk after it from
// lane l+1 (a warp shuffle), and a funnel shift by the row's misalignment
// leaves the strip's CB bytes; a warp computes 31 strips a window and its
// lane 31 only feeds lane 30. Bytes of the neighbouring rows that a chunk
// holds are shifted out. Strips whose chunks, with the chunk after, would
// leave the allocation (the first strip of a buffer that does not start
// on a chunk, the last ones of its last row) and the columns past the
// last whole strip go to a scalar loop over the same arithmetic, so no
// load leaves the buffer.
//
// int8 levels are widened without a conversion instruction (the byte is
// placed in the mantissa of 2^23 + 128 and that is subtracted, exactly),
// then dequantized as level × scale[i, j / block], one f32 multiply as the
// plain version does; rows are summed in row order with fmaf, as before,
// so the wide strips and the scalar loop give the same bits for a column.
// When the strip divides the block (block 256 on the main path) a row
// takes one scale a strip, its index computed once a strip in 32 bits; at
// any other block >= 1 (kInt8Any) each column's block index is counted up
// from the strip's first one, with no division.
//
// The grid is one whole wave (the SMs × the blocks a SM holds, from the
// occupancy query, made once), each warp striding over the windows, so
// the warps in flight read neighbouring windows. What the card showed
// (PERF.md §6): the per-element 64-bit division and scale load, not the
// one-byte loads, held the old int8 kernel back; evict-first streaming
// loads, a cp.async double buffer in shared memory and a contiguous range
// of windows a warp were each slower than this.
//
// narrow_recombine_segments takes the whole buffers and the segment plan
// of ops/coded.py, and reads them in the strips above: the window loop of
// narrow_recombine_kernel over the strips of the plan's columns [p0, p1),
// each strip with the v pair of its own segment. Why the whole-buffer
// window loop and not a block a plan tile: a tile (<= 2048 columns, cut at
// any column) holds 128 int8 strips, 4.1 windows of 31, so a block of 8
// warps on one tile would leave half of them idle and each block would
// pay its start-up again; the window loop keeps every warp on full
// windows, as the whole-d kernel does. A
// lane finds its strip's segment by walking the cuts up from the one it
// found for its previous window (a warp's windows go up in column, so the
// walk costs each warp at most S steps in all), reading the cuts from the
// plan's table through L1, and takes the segment's v pair with its row's
// loads. A strip that a cut crosses (a cut strictly inside it) is not
// summed wide: its columns go to the scalar loop, with the columns of
// [p0, p1) outside the wide strips; there a column finds its segment by a
// binary search over the cuts. Each element is widened and summed as the
// whole-d kernel does (level × scale[i, j / block] with the absolute
// column, fmaf in row order), so every column has the bits of
// cyclic_narrow_recombine, and a cut inside a scale block (a layer
// boundary) needs no special case. tests/test_torch_narrow_plan.py models
// the plan.
//
// The approx decode's offset entry: the view of columns [col0, col0 + d)
// of an (n, ld) buffer, base pointers advanced by col0 and rows ld apart;
// the wide span keeps every load inside the whole buffer (rows 0..n-1 of
// ld columns from base − col0), the scale index is the absolute column's,
// and one scale a strip needs col0 as well as the block to be a multiple
// of the strip's 4 columns. At col0 = 0, ld = d it is the whole-buffer
// decode, unchanged.
//
// approx_decode skips the rows of absent workers (pres[i] == 0, the same
// for every thread, so no divergence): an absent row is never loaded,
// which is the reference's true zero-fill — a NaN payload there cannot
// reach the sum. It reduces Σ(dec − mean)² and Σ bg² in two deterministic
// passes (per-block partials, then one block in a fixed order), as
// complex_project does: no float atomics, the same bits launch to launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "audit.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int MAX_N = 64;  // rows the wrappers take
constexpr int kRows = 8;     // approx: rows whose loads are in flight together
constexpr int kRecRows = 4;  // recombination: the same, of each buffer
constexpr int kStrips = 31;  // strips a warp computes a window
constexpr unsigned kFull = 0xffffffffu;

// the wire codes of the C interface, and the read of an int8 wire at a
// block the strip does not divide
enum WireType { kF32 = 0, kBF16 = 1, kInt8 = 2, kInt8Any = 3 };

template <int R>
struct Wire;
template <>
struct Wire<kF32> {
  using T = float;
};
template <>
struct Wire<kBF16> {
  using T = __nv_bfloat16;
};
template <>
struct Wire<kInt8> {
  using T = int8_t;
};
template <>
struct Wire<kInt8Any> {
  using T = int8_t;
};

// dynamic shared bytes of both kernels' n-vector pair; the launchers and
// the audit share it
inline size_t vector_smem(long long n, long long) {
  return 2 * (size_t)n * sizeof(float);
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float widen(int8_t x) { return (float)x; }

// Row i, column j of a wire buffer as f32: the element, times its block's
// scale for int8 (the scalar loop's read). wire_at_view: of a view whose
// rows are ld apart and whose column j is col0 + j of the scales.
template <typename T>
__device__ __forceinline__ float wire_at(const T* __restrict__ q,
                                         const float* __restrict__ scale,
                                         int i, long long j, long long d,
                                         int block, long long nb) {
  const float x = widen(q[(long long)i * d + j]);
  if constexpr (std::is_same<T, int8_t>::value) {
    return x * __ldg(scale + (long long)i * nb + j / block);
  } else {
    return x;
  }
}

template <typename T>
__device__ __forceinline__ float wire_at_view(const T* __restrict__ q,
                                              const float* __restrict__ scale,
                                              int i, long long j,
                                              long long ld, long long col0,
                                              int block, long long nb) {
  const float x = widen(q[(long long)i * ld + j]);
  if constexpr (std::is_same<T, int8_t>::value) {
    return x * __ldg(scale + (long long)i * nb + (col0 + j) / block);
  } else {
    return x;
  }
}

// CW consecutive 32-bit words of one row, loaded from a CB = 4·CW aligned
// address through the read-only path (an evict-first streaming load was
// slower on the card)
template <int CW>
struct Chunk {
  uint32_t w[CW];
};

template <int CW>
__device__ __forceinline__ Chunk<CW> load_chunk(const char* p) {
  Chunk<CW> c;
  if constexpr (CW == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    c.w[0] = v.x; c.w[1] = v.y; c.w[2] = v.z; c.w[3] = v.w;
  } else if constexpr (CW == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    c.w[0] = v.x; c.w[1] = v.y;
  } else {
    c.w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  }
  return c;
}

// Row i of an (n, d) buffer whose rows are rb bytes: its address rounded
// down to a CB-byte chunk, and the bytes it starts past it (the same for
// every strip of the row, since a strip is CB bytes).
struct RowAt {
  const char* chunk;
  uint32_t a;
};

template <int CB>
__device__ __forceinline__ RowAt row_at(const void* base, long long rb,
                                        int i) {
  const uintptr_t p = (uintptr_t)base + (uintptr_t)((long long)i * rb);
  return {(const char*)(p & ~(uintptr_t)(CB - 1)), (uint32_t)(p & (CB - 1))};
}

// The CB bytes of a strip of a row that starts a bytes past its chunks:
// the strip's first chunk, then the next, shifted right by a bytes
template <int CW>
__device__ __forceinline__ Chunk<CW> join(const Chunk<CW>& lo,
                                          const Chunk<CW>& hi, uint32_t a) {
  uint32_t win[2 * CW];
#pragma unroll
  for (int k = 0; k < CW; ++k) {
    win[k] = lo.w[k];
    win[CW + k] = hi.w[k];
  }
  // whole words first (a / 4, in steps of CW/2 ... 1 words), then bytes
  const uint32_t q = a >> 2, r = (a & 3u) * 8u;
#pragma unroll
  for (int b = CW / 2; b >= 1; b >>= 1) {
    const bool sh = (q & (uint32_t)b) != 0;
#pragma unroll
    for (int k = 0; k + b < 2 * CW; ++k) win[k] = sh ? win[k + b] : win[k];
  }
  Chunk<CW> out;
#pragma unroll
  for (int k = 0; k < CW; ++k) out.w[k] = __funnelshift_r(win[k], win[k + 1], r);
  return out;
}

// This lane's strip from its chunk and lane+1's (a warp shuffle): every
// lane of the warp calls it
template <int CW>
__device__ __forceinline__ Chunk<CW> strip_of(const Chunk<CW>& lo,
                                              uint32_t a) {
  Chunk<CW> hi;
#pragma unroll
  for (int k = 0; k < CW; ++k) hi.w[k] = __shfl_down_sync(kFull, lo.w[k], 1);
  return join<CW>(lo, hi, a);
}

// The strip's 4·CW / sizeof(T) elements as f32, in column order (little
// endian: byte b of word k is column 4k + b)
template <typename T, int CW>
__device__ __forceinline__ void widen_strip(const Chunk<CW>& c, float* x) {
#pragma unroll
  for (int k = 0; k < CW; ++k) {
    const uint32_t u = c.w[k];
    if constexpr (std::is_same<T, float>::value) {
      x[k] = __uint_as_float(u);
    } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      x[2 * k] = __uint_as_float(u << 16);
      x[2 * k + 1] = __uint_as_float(u & 0xffff0000u);
    } else {
      // level + 128 into the low mantissa byte of 2^23: exact, no I2F
      const uint32_t biased = u ^ 0x80808080u;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        x[4 * k + b] = __uint_as_float(__byte_perm(biased, 0x4b000000u,
                                                   0x7440u + b)) -
                       8388736.0f;
    }
  }
}

// The strips [lo, hi) of an (n, d) buffer of sz-byte elements read in
// CB-byte chunks for which both the strip's chunk and the chunk after it
// lie inside the buffer for every row: not the first strip if the buffer
// does not start on a chunk, no strip past the last whole one of a row,
// and none whose second chunk of the last row would end past the buffer.
// Empty (0, 0) when no strip qualifies. tests/test_torch_narrow_plan.py
// models it.
struct Span {
  long long lo, hi;
};

__device__ __forceinline__ Span wide_span(const void* base, int n,
                                          long long d, int sz, int cb) {
  const long long w = cb / sz;
  const uintptr_t b = (uintptr_t)base;
  const uintptr_t e = b + (uintptr_t)((long long)n * d * sz);
  const uintptr_t last =
      (b + (uintptr_t)((long long)(n - 1) * d * sz)) & ~(uintptr_t)(cb - 1);
  const long long lo = (b & (uintptr_t)(cb - 1)) ? 1 : 0;
  const long long end = (long long)((e - last) / (uintptr_t)cb) - 1;
  const long long full = d / w;
  const long long hi = full < end ? full : end;
  return hi > lo ? Span{lo, hi} : Span{0, 0};
}

// wide_span of a view: n rows of d columns, ld apart, starting col0
// columns into row 0 of an (n, ld) buffer; every load stays inside that
// whole buffer. At col0 = 0, ld = d it is wide_span.
__device__ __forceinline__ Span wide_span_view(const void* base, int n,
                                               long long d, long long ld,
                                               long long col0, int sz,
                                               int cb) {
  const long long w = cb / sz;
  const uintptr_t b = (uintptr_t)base;
  const uintptr_t start = b - (uintptr_t)(col0 * sz);
  const uintptr_t e = start + (uintptr_t)((long long)n * ld * sz);
  const uintptr_t last =
      (b + (uintptr_t)((long long)(n - 1) * ld * sz)) & ~(uintptr_t)(cb - 1);
  const long long lo = (b & ~(uintptr_t)(cb - 1)) < start ? 1 : 0;
  const long long end = (long long)((e - last) / (uintptr_t)cb) - 1;
  const long long full = d / w;
  const long long hi = full < end ? full : end;
  return hi > lo ? Span{lo, hi} : Span{0, 0};
}

__device__ __forceinline__ Span meet(Span x, Span y) {
  const long long lo = x.lo > y.lo ? x.lo : y.lo;
  const long long hi = x.hi < y.hi ? x.hi : y.hi;
  return hi > lo ? Span{lo, hi} : Span{0, 0};
}

// The block index of each of the strip's W columns from j0: counted up
// from j0's, with no division past the first (kInt8Any; an index < nb
// fits 32 bits)
template <int W>
__device__ __forceinline__ void blocks_of(long long j0, int block, int* blk) {
  int b = (int)(j0 / block);
  int rem = (int)(j0 - (long long)b * block);
#pragma unroll
  for (int w = 0; w < W; ++w) {
    blk[w] = b;
    if (++rem == block) {
      rem = 0;
      ++b;
    }
  }
}

// j0 / block in 32 bits where the columns fit (the strip's one block)
__device__ __forceinline__ long long block_of(long long j0, int block,
                                              long long d) {
  return d <= 0x7fffffffLL ? (long long)((uint32_t)j0 / (uint32_t)block)
                           : j0 / block;
}

// W results of a strip into out[j0 ..], 16 bytes a store where out is
// 16-byte aligned
template <int W>
__device__ __forceinline__ void store_strip(float* __restrict__ out,
                                            long long j0, const float* y,
                                            bool vec) {
  if (W % 4 == 0 && vec) {
#pragma unroll
    for (int k = 0; k < W; k += 4)
      *reinterpret_cast<float4*>(out + j0 + k) =
          make_float4(y[k], y[k + 1], y[k + 2], y[k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k) out[j0 + k] = y[k];
  }
}

// Re[(vr + i·vi)ᵀ (Qr + i·Qi)] = Σ vr·Qr − Σ vi·Qi with Q the widened wire:
// v (n,), Q (n, d) -> out (d,). CW: the 32-bit words of a row a lane loads
// a strip. Each row's chunk address and misalignment are computed once a
// block, into shared memory. The shuffles run for every row slot of a
// group, past n too (a zero chunk), so they stay outside any branch; only
// the sums of rows i < n are taken.
template <int R, int CW = 4>
__global__ void __launch_bounds__(kThreads, R == kInt8Any ? 1 : 2)
narrow_recombine_kernel(const float* __restrict__ v_re,
                        const float* __restrict__ v_im,
                        const void* __restrict__ q_re,
                        const void* __restrict__ q_im,
                        const float* __restrict__ s_re,
                        const float* __restrict__ s_im,
                        float* __restrict__ out, int n, long long d,
                        int block, long long nb) {
  using T = typename Wire<R>::T;
  constexpr int CB = 4 * CW, W = CB / (int)sizeof(T);
  extern __shared__ float sv[];  // [n] re, then [n] im
  __shared__ const char* row_chunk[2][MAX_N];
  __shared__ uint32_t row_a[2][MAX_N];
  const long long rb = d * (long long)sizeof(T);
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    sv[t] = v_re[t];
    sv[n + t] = v_im[t];
    const RowAt pr = row_at<CB>(q_re, rb, t), pi = row_at<CB>(q_im, rb, t);
    row_chunk[0][t] = pr.chunk;
    row_a[0][t] = pr.a;
    row_chunk[1][t] = pi.chunk;
    row_a[1][t] = pi.a;
  }
  __syncthreads();
  const Span sp = meet(wide_span(q_re, n, d, sizeof(T), CB),
                       wide_span(q_im, n, d, sizeof(T), CB));
  const int lane = threadIdx.x & 31;
  const bool vec = ((uintptr_t)out & 15) == 0;
  const long long windows = (sp.hi - sp.lo + kStrips - 1) / kStrips;
  for (long long win = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       win < windows; win += (long long)gridDim.x * kWarps) {
    const long long s = sp.lo + win * kStrips + lane;
    const bool mine = lane < kStrips && s < sp.hi;  // computes strip s
    const bool feed = s <= sp.hi;  // its chunk is the strip before's second
    const long long j0 = s * W, off = s * CB;
    long long blk1 = 0;
    int blk[R == kInt8Any ? W : 1];
    if constexpr (R == kInt8) blk1 = mine ? block_of(j0, block, d) : 0;
    if constexpr (R == kInt8Any) {
      if (mine) blocks_of<W>(j0, block, blk);
    }
    float acc_r[W], acc_i[W];
#pragma unroll
    for (int w = 0; w < W; ++w) { acc_r[w] = 0.f; acc_i[w] = 0.f; }
    for (int i0 = 0; i0 < n; i0 += kRecRows) {
      Chunk<CW> cr[kRecRows], ci[kRecRows];
      float fr[kRecRows], fi[kRecRows];  // kInt8: the row's scale
      // every load of the group first
#pragma unroll
      for (int r = 0; r < kRecRows; ++r) {
        const int i = i0 + r;
        const bool live = i < n;
        cr[r] = Chunk<CW>{};
        ci[r] = Chunk<CW>{};
        if (live && feed) {
          cr[r] = load_chunk<CW>(row_chunk[0][i] + off);
          ci[r] = load_chunk<CW>(row_chunk[1][i] + off);
        }
        if constexpr (R == kInt8) {
          const long long at = (long long)i * nb + blk1;
          fr[r] = live && mine ? __ldg(s_re + at) : 0.f;
          fi[r] = live && mine ? __ldg(s_im + at) : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < kRecRows; ++r) {
        const int i = i0 + r;
        const int ia = i < n ? i : 0;
        float x[W], y[W];
        widen_strip<T, CW>(strip_of<CW>(cr[r], row_a[0][ia]), x);
        widen_strip<T, CW>(strip_of<CW>(ci[r], row_a[1][ia]), y);
        if (i < n) {
#pragma unroll
          for (int w = 0; w < W; ++w) {
            if constexpr (R == kInt8) {
              x[w] *= fr[r];
              y[w] *= fi[r];
            } else if constexpr (R == kInt8Any) {
              x[w] *= mine ? __ldg(s_re + (long long)i * nb + blk[w]) : 0.f;
              y[w] *= mine ? __ldg(s_im + (long long)i * nb + blk[w]) : 0.f;
            }
            acc_r[w] = fmaf(sv[i], x[w], acc_r[w]);
            acc_i[w] = fmaf(sv[n + i], y[w], acc_i[w]);
          }
        }
      }
    }
    if (mine) {
      float o[W];
#pragma unroll
      for (int w = 0; w < W; ++w) o[w] = acc_r[w] - acc_i[w];
      store_strip<W>(out, j0, o, vec);
    }
  }
  // the columns outside the wide strips, one a thread
  const long long c0 = sp.lo * W, c1 = sp.hi * W;
  const long long tail = c0 + (d - c1);
  const T* qr = (const T*)q_re;
  const T* qi = (const T*)q_im;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < tail; t += (long long)gridDim.x * blockDim.x) {
    const long long j = t < c0 ? t : c1 + (t - c0);
    float acc_r = 0.f, acc_i = 0.f;
    for (int i = 0; i < n; ++i) {
      acc_r = fmaf(sv[i], wire_at(qr, s_re, i, j, d, block, nb), acc_r);
      acc_i = fmaf(sv[n + i], wire_at(qi, s_im, i, j, d, block, nb), acc_i);
    }
    out[j] = acc_r - acc_i;
  }
}

// The first column of segment seg + 1 of a segment plan of `segments`
// segments over `tiles` tiles (ops/coded.py's table: [seg, lo, hi] of each
// tile, then the first tile of each segment); the plan's end for the last
// segment, its first column for seg = -1
__device__ __forceinline__ long long cut_after(const int* __restrict__ plan,
                                               int tiles, int segments,
                                               int seg) {
  return seg + 1 < segments
             ? (long long)__ldg(plan + tiles + __ldg(plan + 3 * tiles + seg + 1))
             : (long long)__ldg(plan + 3 * tiles - 1);
}

// The segment that holds column j of the plan's [p0, p1): the last one
// whose first column is <= j
__device__ __forceinline__ int segment_of(const int* __restrict__ plan,
                                          int tiles, int segments,
                                          long long j) {
  int lo = 0, hi = segments - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (cut_after(plan, tiles, segments, mid - 1) <= j)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// The narrow recombination over a segment plan (the comment at the top):
// v (S, n), the (n, d) buffers -> out over the plan's columns. The window
// loop, loads and sums of narrow_recombine_kernel, with v from the strip's
// segment.
template <int R, int CW = 4>
__global__ void __launch_bounds__(kThreads, R == kInt8Any ? 1 : 2)
narrow_recombine_segments_kernel(const float* __restrict__ v_re,
                                 const float* __restrict__ v_im,
                                 const void* __restrict__ q_re,
                                 const void* __restrict__ q_im,
                                 const float* __restrict__ s_re,
                                 const float* __restrict__ s_im,
                                 const int* __restrict__ plan, int tiles,
                                 float* __restrict__ out, int n, long long d,
                                 int block, long long nb) {
  using T = typename Wire<R>::T;
  constexpr int CB = 4 * CW, W = CB / (int)sizeof(T);
  __shared__ const char* row_chunk[2][MAX_N];
  __shared__ uint32_t row_a[2][MAX_N];
  const long long rb = d * (long long)sizeof(T);
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const RowAt pr = row_at<CB>(q_re, rb, t), pi = row_at<CB>(q_im, rb, t);
    row_chunk[0][t] = pr.chunk;
    row_a[0][t] = pr.a;
    row_chunk[1][t] = pi.chunk;
    row_a[1][t] = pi.a;
  }
  __syncthreads();
  const int segments = __ldg(plan + tiles - 1) + 1;
  const long long p0 = __ldg(plan + tiles), p1 = __ldg(plan + 3 * tiles - 1);
  // the whole strips of [p0, p1) that both buffers' wide spans hold
  const Span sp = meet(meet(wide_span(q_re, n, d, sizeof(T), CB),
                            wide_span(q_im, n, d, sizeof(T), CB)),
                       Span{(p0 + W - 1) / W, p1 / W});
  const int lane = threadIdx.x & 31;
  const bool vec = ((uintptr_t)out & 15) == 0;
  const long long windows = (sp.hi - sp.lo + kStrips - 1) / kStrips;
  int seg = 0;  // this lane's segment, walked up window by window
  for (long long win = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       win < windows; win += (long long)gridDim.x * kWarps) {
    const long long s = sp.lo + win * kStrips + lane;
    const long long j0 = s * W, off = s * CB;
    bool mine = lane < kStrips && s < sp.hi;  // computes strip s
    if (mine) {
      long long next = cut_after(plan, tiles, segments, seg);
      while (next <= j0) next = cut_after(plan, tiles, segments, ++seg);
      mine = next >= j0 + W;  // no cut strictly inside the strip
    }
    const bool feed = s <= sp.hi;  // its chunk is the strip before's second
    const float* vr = v_re + (long long)seg * n;
    const float* vi = v_im + (long long)seg * n;
    long long blk1 = 0;
    int blk[R == kInt8Any ? W : 1];
    if constexpr (R == kInt8) blk1 = mine ? block_of(j0, block, d) : 0;
    if constexpr (R == kInt8Any) {
      if (mine) blocks_of<W>(j0, block, blk);
    }
    float acc_r[W], acc_i[W];
#pragma unroll
    for (int w = 0; w < W; ++w) { acc_r[w] = 0.f; acc_i[w] = 0.f; }
    for (int i0 = 0; i0 < n; i0 += kRecRows) {
      Chunk<CW> cr[kRecRows], ci[kRecRows];
      float fr[kRecRows], fi[kRecRows];  // kInt8: the row's scale
      float ur[kRecRows], ui[kRecRows];  // the row's v pair
      // every load of the group first
#pragma unroll
      for (int r = 0; r < kRecRows; ++r) {
        const int i = i0 + r;
        const bool live = i < n;
        cr[r] = Chunk<CW>{};
        ci[r] = Chunk<CW>{};
        if (live && feed) {
          cr[r] = load_chunk<CW>(row_chunk[0][i] + off);
          ci[r] = load_chunk<CW>(row_chunk[1][i] + off);
        }
        ur[r] = live && mine ? __ldg(vr + i) : 0.f;
        ui[r] = live && mine ? __ldg(vi + i) : 0.f;
        if constexpr (R == kInt8) {
          const long long at = (long long)i * nb + blk1;
          fr[r] = live && mine ? __ldg(s_re + at) : 0.f;
          fi[r] = live && mine ? __ldg(s_im + at) : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < kRecRows; ++r) {
        const int i = i0 + r;
        const int ia = i < n ? i : 0;
        float x[W], y[W];
        widen_strip<T, CW>(strip_of<CW>(cr[r], row_a[0][ia]), x);
        widen_strip<T, CW>(strip_of<CW>(ci[r], row_a[1][ia]), y);
        if (i < n) {
#pragma unroll
          for (int w = 0; w < W; ++w) {
            if constexpr (R == kInt8) {
              x[w] *= fr[r];
              y[w] *= fi[r];
            } else if constexpr (R == kInt8Any) {
              x[w] *= mine ? __ldg(s_re + (long long)i * nb + blk[w]) : 0.f;
              y[w] *= mine ? __ldg(s_im + (long long)i * nb + blk[w]) : 0.f;
            }
            acc_r[w] = fmaf(ur[r], x[w], acc_r[w]);
            acc_i[w] = fmaf(ui[r], y[w], acc_i[w]);
          }
        }
      }
    }
    if (mine) {
      float o[W];
#pragma unroll
      for (int w = 0; w < W; ++w) o[w] = acc_r[w] - acc_i[w];
      store_strip<W>(out, j0, o, vec);
    }
  }
  // one column a thread: the plan's columns outside the wide strips
  // ([p0, c0) and [c1, p1)), then the strips a cut crosses, each taken
  // once, by the first cut strictly inside it (interior cut k, 1 <= k < S,
  // at column c: W columns of strip c / W)
  const bool wide = sp.hi > sp.lo;
  const long long c0 = wide ? sp.lo * W : p0, c1 = wide ? sp.hi * W : p0;
  const long long head = c0 - p0, edge = head + (p1 - c1);
  const long long items = edge + (long long)(segments - 1) * W;
  const T* qr = (const T*)q_re;
  const T* qi = (const T*)q_im;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < items; t += (long long)gridDim.x * blockDim.x) {
    long long j;
    if (t < head) {
      j = p0 + t;
    } else if (t < edge) {
      j = c1 + (t - head);
    } else {
      const int k = 1 + (int)((t - edge) / W);
      const long long c = cut_after(plan, tiles, segments, k - 1);
      const long long b = cut_after(plan, tiles, segments, k - 2);
      const long long sc = c / W;
      const bool crosses = c % W != 0 && sc >= sp.lo && sc < sp.hi;
      const bool first = !(b % W != 0 && b / W == sc);
      if (!(crosses && first)) continue;
      j = sc * W + (t - edge) % W;
    }
    const int sg = segment_of(plan, tiles, segments, j);
    float acc_r = 0.f, acc_i = 0.f;
    for (int i = 0; i < n; ++i) {
      acc_r = fmaf(__ldg(v_re + (long long)sg * n + i),
                   wire_at(qr, s_re, i, j, d, block, nb), acc_r);
      acc_i = fmaf(__ldg(v_im + (long long)sg * n + i),
                   wire_at(qi, s_im, i, j, d, block, nb), acc_i);
    }
    out[j] = acc_r - acc_i;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;
}

// Sum of v over the block in a fixed order (lanes, then warps); valid in
// thread 0.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float acc = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) acc += red[w];
  __syncthreads();
  return acc;
}

// Pass 1 of the approx decode: per column j
//   dec[j]  = Σ_{i present} vn[i] · wire[i, j]
//   mean[j] = Σ_i inv_n · bg[i, j]
// writes dec and this block's partial sums of (dec − mean)² and bg². A
// strip is 4 columns: one chunk of sizeof(wire) words of the wire and one
// 16-byte chunk of bg a row. q, bg and dec point at column col0 of rows
// ld apart (the offset entry); the scales are the whole buffer's.
template <int R>
__global__ void __launch_bounds__(kThreads)
approx_decode_partial_kernel(const void* __restrict__ q,
                             const float* __restrict__ scale,
                             const float* __restrict__ bg,
                             const float* __restrict__ vn,
                             const float* __restrict__ pres,
                             float* __restrict__ dec,
                             float* __restrict__ part_d,
                             float* __restrict__ part_g, int n, long long d,
                             long long ld, long long col0, int block,
                             long long nb, float inv_n) {
  using T = typename Wire<R>::T;
  constexpr int CW = (int)sizeof(T), CB = 4 * CW, W = 4;
  constexpr bool kScaled = R == kInt8 || R == kInt8Any;
  extern __shared__ float sh[];  // [n] v/n, then [n] presence
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    sh[t] = vn[t];
    sh[n + t] = pres[t];
  }
  __syncthreads();
  const long long rq = ld * (long long)sizeof(T), rg = ld * 4;
  const Span sp = meet(wide_span_view(q, n, d, ld, col0, sizeof(T), CB),
                       wide_span_view(bg, n, d, ld, col0, 4, 16));
  const int lane = threadIdx.x & 31;
  const bool vec = ((uintptr_t)dec & 15) == 0;
  float sd = 0.f, sg = 0.f;
  const long long windows = (sp.hi - sp.lo + kStrips - 1) / kStrips;
  for (long long win = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       win < windows; win += (long long)gridDim.x * kWarps) {
    const long long s = sp.lo + win * kStrips + lane;
    const bool mine = lane < kStrips && s < sp.hi;
    const bool feed = s <= sp.hi;
    const long long j0 = s * W;
    long long blk1 = 0;
    int blk[kScaled ? W : 1];
    if constexpr (R == kInt8)
      blk1 = mine ? block_of(col0 + j0, block, col0 + d) : 0;
    if constexpr (R == kInt8Any) {
      if (mine) blocks_of<W>(col0 + j0, block, blk);
    }
    float acc[W], mean[W];
#pragma unroll
    for (int w = 0; w < W; ++w) { acc[w] = 0.f; mean[w] = 0.f; }
    for (int i0 = 0; i0 < n; i0 += kRows) {
      Chunk<CW> cq[kRows];
      Chunk<4> cg[kRows];
      uint32_t aq[kRows], ag[kRows];
      float fs[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = i0 + r;
        cq[r] = Chunk<CW>{};
        cg[r] = Chunk<4>{};
        aq[r] = 0;
        ag[r] = 0;
        fs[r] = 0.f;
        if (i < n) {
          const RowAt pq = row_at<CB>(q, rq, i);
          const RowAt pg = row_at<16>(bg, rg, i);
          aq[r] = pq.a;
          ag[r] = pg.a;
          if (sh[n + i] > 0.f) {  // an absent row is never loaded
            if (feed) cq[r] = load_chunk<CW>(pq.chunk + s * CB);
            if constexpr (R == kInt8)
              if (mine) fs[r] = __ldg(scale + (long long)i * nb + blk1);
          }
          if (feed) cg[r] = load_chunk<4>(pg.chunk + s * 16);
        }
      }
      // the shuffles run for every row slot (outside any branch); only
      // the sums of present rows / rows i < n are taken
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = i0 + r;
        float x[W], b[W];
        widen_strip<T, CW>(strip_of<CW>(cq[r], aq[r]), x);
        widen_strip<float, 4>(strip_of<4>(cg[r], ag[r]), b);
        if (i < n) {
          if (sh[n + i] > 0.f) {
#pragma unroll
            for (int w = 0; w < W; ++w) {
              if constexpr (R == kInt8) {
                x[w] *= fs[r];
              } else if constexpr (R == kInt8Any) {
                x[w] *= mine ? __ldg(scale + (long long)i * nb + blk[w]) : 0.f;
              }
              acc[w] = fmaf(sh[i], x[w], acc[w]);
            }
          }
#pragma unroll
          for (int w = 0; w < W; ++w) {
            mean[w] = fmaf(inv_n, b[w], mean[w]);
            if (mine) sg = fmaf(b[w], b[w], sg);
          }
        }
      }
    }
    if (mine) {
      store_strip<W>(dec, j0, acc, vec);
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const float diff = acc[w] - mean[w];
        sd = fmaf(diff, diff, sd);
      }
    }
  }
  // the columns outside the wide strips, one a thread
  const long long c0 = sp.lo * W, c1 = sp.hi * W;
  const long long tail = c0 + (d - c1);
  const T* qt = (const T*)q;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < tail; t += (long long)gridDim.x * blockDim.x) {
    const long long j = t < c0 ? t : c1 + (t - c0);
    float acc = 0.f, mean = 0.f;
    for (int i = 0; i < n; ++i) {
      if (sh[n + i] > 0.f)
        acc = fmaf(sh[i], wire_at_view(qt, scale, i, j, ld, col0, block, nb),
                   acc);
      const float b = __ldg(bg + (long long)i * ld + j);
      mean = fmaf(inv_n, b, mean);
      sg = fmaf(b, b, sg);
    }
    dec[j] = acc;
    const float diff = acc - mean;
    sd = fmaf(diff, diff, sd);
  }
  __shared__ float red[kWarps];
  const float bd = block_sum(sd, red);
  const float bgs = block_sum(sg, red);
  if (threadIdx.x == 0) {
    part_d[blockIdx.x] = bd;
    part_g[blockIdx.x] = bgs;
  }
}

// Pass 2: one block sums the chunks partials of both sums in a fixed order.
__global__ void approx_decode_final_kernel(const float* __restrict__ part_d,
                                           const float* __restrict__ part_g,
                                           float* __restrict__ sums,
                                           int chunks) {
  float a = 0.f, b = 0.f;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    a += part_d[c];
    b += part_g[c];
  }
  __shared__ float red[kWarps];
  a = block_sum(a, red);
  b = block_sum(b, red);
  if (threadIdx.x == 0) {
    sums[0] = a;
    sums[1] = b;
  }
}

// The blocks of one whole wave of a kernel (the SMs × the blocks a SM
// holds at the largest n's shared memory), queried once per device
int wave(const void* fn, int threads, size_t smem, int* cache) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) {
    cudaGetLastError();
    dev = 0;
  }
  if (cache[dev] == 0) {
    int sms = 0, blocks = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                  smem);
    cudaGetLastError();
    cache[dev] = sms * blocks < 1 ? 1 : sms * blocks;
  }
  return cache[dev];
}

// Blocks of `warps` warps for d columns of W-column strips: a wave, but
// no more than the windows need
inline int grid_for(int wave_blocks, int warps, long long d, int w) {
  const long long per = (long long)warps * kStrips * w;
  const long long need = (d + per - 1) / per;
  const long long g = need < wave_blocks ? need : wave_blocks;
  return g < 1 ? 1 : (int)g;
}

template <int R, int CW = 4>
int launch_recombine(const float* v_re, const float* v_im, const void* q_re,
                     const void* q_im, const float* s_re, const float* s_im,
                     float* out, int n, long long d, int block, long long nb,
                     cudaStream_t st) {
  static int cache[64];
  constexpr int W = 4 * CW / (int)sizeof(typename Wire<R>::T);
  const void* fn = (const void*)narrow_recombine_kernel<R, CW>;
  const int wave_blocks = wave(fn, kThreads, vector_smem(MAX_N, 0), cache);
  narrow_recombine_kernel<R, CW>
      <<<grid_for(wave_blocks, kWarps, d, W), kThreads, vector_smem(n, 0),
         st>>>(v_re, v_im, q_re, q_im, s_re, s_im, out, n, d, block, nb);
  return (int)cudaGetLastError();
}

template <int R>
int launch_approx(const void* q, const float* scale, const float* bg,
                  const float* vn, const float* pres, float* dec, float* part,
                  int n, long long d, long long ld, long long col0, int block,
                  long long nb, int chunks, float inv_n, cudaStream_t st) {
  approx_decode_partial_kernel<R><<<chunks, kThreads, vector_smem(n, 0), st>>>(
      q, scale, bg, vn, pres, dec, part, part + chunks, n, d, ld, col0, block,
      nb, inv_n);
  return (int)cudaGetLastError();
}

template <int R>
int launch_recombine_segments(const float* v_re, const float* v_im,
                              const void* q_re, const void* q_im,
                              const float* s_re, const float* s_im,
                              const int* plan, int tiles, float* out, int n,
                              long long d, int block, long long nb,
                              cudaStream_t st) {
  static int cache[64];
  constexpr int W = 16 / (int)sizeof(typename Wire<R>::T);
  const void* fn = (const void*)narrow_recombine_segments_kernel<R>;
  narrow_recombine_segments_kernel<R>
      <<<grid_for(wave(fn, kThreads, 0, cache), kWarps, d, W), kThreads, 0,
         st>>>(v_re, v_im, q_re, q_im, s_re, s_im, plan, tiles, out, n, d,
               block, nb);
  return (int)cudaGetLastError();
}

const draco_audit::Entry kAudit[] = {
    {"narrow_recombine_kernel<kF32>",
     (const void*)narrow_recombine_kernel<kF32>, kThreads, vector_smem, 0},
    {"narrow_recombine_kernel<kBF16>",
     (const void*)narrow_recombine_kernel<kBF16>, kThreads, vector_smem, 0},
    {"narrow_recombine_kernel<kInt8>",
     (const void*)narrow_recombine_kernel<kInt8>, kThreads, vector_smem, 0},
    {"narrow_recombine_kernel<kInt8Any>",
     (const void*)narrow_recombine_kernel<kInt8Any>, kThreads, vector_smem,
     0},
    {"approx_decode_partial_kernel<kF32>",
     (const void*)approx_decode_partial_kernel<kF32>, kThreads, vector_smem,
     0},
    {"approx_decode_partial_kernel<kBF16>",
     (const void*)approx_decode_partial_kernel<kBF16>, kThreads, vector_smem,
     0},
    {"approx_decode_partial_kernel<kInt8>",
     (const void*)approx_decode_partial_kernel<kInt8>, kThreads, vector_smem,
     0},
    {"approx_decode_partial_kernel<kInt8Any>",
     (const void*)approx_decode_partial_kernel<kInt8Any>, kThreads,
     vector_smem, 0},
    {"approx_decode_final_kernel", (const void*)approx_decode_final_kernel,
     kThreads, nullptr, 0},
    {"narrow_recombine_segments_kernel<kBF16>",
     (const void*)narrow_recombine_segments_kernel<kBF16>, kThreads, nullptr,
     0},
    {"narrow_recombine_segments_kernel<kInt8>",
     (const void*)narrow_recombine_segments_kernel<kInt8>, kThreads, nullptr,
     0},
    {"narrow_recombine_segments_kernel<kInt8Any>",
     (const void*)narrow_recombine_segments_kernel<kInt8Any>, kThreads,
     nullptr, 0},
};

}  // namespace

DRACO_AUDIT_EXPORTS(kAudit)

extern "C" {

// wire: 0 f32, 1 bf16, 2 int8 (s_re / s_im: (n, nb) f32 scales of blocks of
// `block` columns; unused otherwise).
int draco_narrow_recombine(const float* v_re, const float* v_im,
                           const void* q_re, const void* q_im,
                           const float* s_re, const float* s_im, float* out,
                           int n, long long d, int wire, int block,
                           long long nb, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (d <= 0) return (int)cudaGetLastError();
  switch (wire) {
    case kF32:
      return launch_recombine<kF32>(v_re, v_im, q_re, q_im, s_re, s_im, out,
                                    n, d, block, nb, st);
    case kBF16:
      return launch_recombine<kBF16>(v_re, v_im, q_re, q_im, s_re, s_im, out,
                                     n, d, block, nb, st);
    case kInt8:
      // a strip is 16 int8 columns: one scale a row when 16 divides block
      if (block % 16 == 0)
        return launch_recombine<kInt8>(v_re, v_im, q_re, q_im, s_re, s_im,
                                       out, n, d, block, nb, st);
      return launch_recombine<kInt8Any>(v_re, v_im, q_re, q_im, s_re, s_im,
                                        out, n, d, block, nb, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Number of pass-1 blocks of the approx decode at length d: one whole wave
// of the instance that holds the fewest blocks a SM, and no more than d
// needs (the wrapper sizes the (2, chunks) partials with it).
int draco_approx_decode_chunks(long long d) {
  static int cache[4][64];
  const size_t smem = vector_smem(MAX_N, 0);
  const int waves[4] = {
      wave((const void*)approx_decode_partial_kernel<kF32>, kThreads, smem,
           cache[0]),
      wave((const void*)approx_decode_partial_kernel<kBF16>, kThreads, smem,
           cache[1]),
      wave((const void*)approx_decode_partial_kernel<kInt8>, kThreads, smem,
           cache[2]),
      wave((const void*)approx_decode_partial_kernel<kInt8Any>, kThreads,
           smem, cache[3])};
  int least = waves[0];
  for (int k = 1; k < 4; ++k) least = waves[k] < least ? waves[k] : least;
  return grid_for(least, kWarps, d, 4);
}

// sums: (2,) f32 <- [Σ(dec − mean)², Σ bg²]; part: (2, chunks) scratch.
// q, bg and dec point at column col0 of the view's first row; rows are ld
// apart (col0 = 0, ld = d: the whole buffer); scale is the whole (n, nb).
int draco_approx_decode(const void* q, const float* scale, const float* bg,
                        const float* vn, const float* pres, float* dec,
                        float* part, float* sums, int n, long long d,
                        long long ld, long long col0, int wire, int block,
                        long long nb, int chunks, float inv_n, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int err;
  switch (wire) {
    case kF32:
      err = launch_approx<kF32>(q, scale, bg, vn, pres, dec, part, n, d, ld,
                                col0, block, nb, chunks, inv_n, st);
      break;
    case kBF16:
      err = launch_approx<kBF16>(q, scale, bg, vn, pres, dec, part, n, d, ld,
                                 col0, block, nb, chunks, inv_n, st);
      break;
    case kInt8:
      // a strip is 4 columns: one scale a row when 4 divides the block and
      // the view's first column
      err = block % 4 == 0 && col0 % 4 == 0
                ? launch_approx<kInt8>(q, scale, bg, vn, pres, dec, part, n,
                                       d, ld, col0, block, nb, chunks, inv_n,
                                       st)
                : launch_approx<kInt8Any>(q, scale, bg, vn, pres, dec, part,
                                          n, d, ld, col0, block, nb, chunks,
                                          inv_n, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  approx_decode_final_kernel<<<1, kThreads, 0, st>>>(part, part + chunks, sums,
                                                     chunks);
  return (int)cudaGetLastError();
}

// The narrow recombination over a segment plan of `tiles` tiles (ops/
// coded.py): v (S, n) f32, wire 1 bf16 or 2 int8, out (d,) over the plan's
// columns.
int draco_narrow_recombine_segments(const float* v_re, const float* v_im,
                                    const void* q_re, const void* q_im,
                                    const float* s_re, const float* s_im,
                                    const int* plan, int tiles, float* out,
                                    int n, long long d, int wire, int block,
                                    long long nb, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (tiles < 1) return (int)cudaErrorInvalidValue;
  switch (wire) {
    case kBF16:
      return launch_recombine_segments<kBF16>(v_re, v_im, q_re, q_im, s_re,
                                              s_im, plan, tiles, out, n, d,
                                              block, nb, st);
    case kInt8:
      // a strip is 16 int8 columns: one scale a row when 16 divides block
      if (block % 16 == 0)
        return launch_recombine_segments<kInt8>(v_re, v_im, q_re, q_im, s_re,
                                                s_im, plan, tiles, out, n, d,
                                                block, nb, st);
      return launch_recombine_segments<kInt8Any>(v_re, v_im, q_re, q_im,
                                                 s_re, s_im, plan, tiles, out,
                                                 n, d, block, nb, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
