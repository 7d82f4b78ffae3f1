// Complex-arithmetic products of the cyclic gradient code, by hand for
// Hopper (sm_90a). Plain C interface, loaded with ctypes by
// draco_tpu_torch/ops/coded.py; every launch goes on the caller's stream
// and the functions return cudaGetLastError().
//
// Replaces the Pallas TPU kernels of draco_tpu/ops/coded.py:
//   complex_matmul     <- _matmul_kernel / _matmul_pallas    (coded.py:70, pallas_call :82)
//   complex_project    <- _project_kernel / _project_pallas  (coded.py:128, pallas_call :152)
//   complex_recombine  <- _recombine_kernel / _recombine_pallas (coded.py:188, pallas_call :201)
// and, for the segmented decode (many column segments in one launch, where
// the reference calls the two kernels once a segment on column slices,
// draco_tpu/coding/cyclic.py decode_layers / decode_segments):
//   complex_project_segments   <- _project_pallas on r[:, a:b] per segment
//   complex_recombine_segments <- _recombine_pallas on r[:, a:b] per segment
//
// What bounds them on an H100: all three stream an (n, d) f32 operand once
// with n <= 64 (n = 8 on the main path) and do 2n flops per column, far
// below the card's ~20 flops/byte balance point in f32 — they are bound by
// device-memory bytes (3.35 TB/s). At n = 8, d = 11,173,962: encode moves
// 357.6 MB in + 715 MB out, project and recombine 715 MB in each.
//
// Design against that bound: one thread per column (or column group) of d
// (grid-stride), so a warp's loads and stores are consecutive floats of one
// row — coalesced transactions; the small n×n (or n) coefficients live in
// shared memory. Each thread keeps the sums of up to kRowGroup output rows
// in registers, so at n <= 8 every input element is read from device
// memory exactly once. The TPU kernels' TILE_D tiling, 128-lane partials
// and padding have no counterpart: a thread masks the ragged edge itself.
//
// The segment kernels take the whole (n, d) operands and a segment plan:
// an int32 table, built on the host once per set of cuts and kept on the
// card, of column tiles of at most ops/coded.py's SEGMENT_TILE columns,
// none straddling a cut — plan[t] the tile's segment, plan[T + t] and
// plan[2T + t] its columns [lo, hi), plan[3T + j] the first tile of
// segment j (S + 1 entries). A block takes one tile, one thread a column, so a segment
// slice is read in place at the row stride d with no copy, and a segment
// of 10 columns costs one block, not a launch. Per column the
// recombination does the same sum in the same order as
// complex_recombine_kernel (bit for bit on a contiguous slice); the
// projection writes one partial per (tile, row) and reduces each
// segment's tiles in a fixed order (no atomics: the same bits launch to
// launch, though grouped otherwise than complex_project's).
//
// complex_project reduces over d in two deterministic passes — per-block
// partials into an (n, chunks) scratch, then one block per row sums them in
// a fixed order — with no float atomics, so the result is the same run to
// run. Its first pass is sized to one whole wave: chunks = the SMs × the
// blocks a SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor, queried
// once), so every block streams the same share of d and none waits for a
// second, half-empty wave. At an even d (and 8-byte aligned rows) a thread
// reads float2 pairs, kUnroll pairs of each row an iteration: at n = 8 that
// is 2·17 eight-byte loads in flight a thread. d = 11,173,962 ≡ 2 (mod 4),
// so every odd row starts only 8-byte aligned: float4 would need a peeled
// head per row and f read at another alignment than the row. An odd d takes
// the same kernel one float at a time. The loads stream (evict first), and
// pass 2 is a programmatic dependent launch that overlaps pass 1's tail.
//
// The encode (redesigned for the card's memory system) moves twice as
// many bytes out as in. A lane takes a group of V consecutive columns and
// issues the loads of kK = 8 rows of G for them before any arithmetic (at
// n = 8 a group's whole input), reading each row of W from shared memory
// 16 bytes at a time (rows padded to kK); the grid is one whole wave (the
// occupancy query, made once). Where every row of the three buffers
// starts on a 128-byte line (d a multiple of 32: the LM's d = 62,958,336)
// a group is a float4 and a warp takes windows of 32 groups, each lane
// storing its own. At any other even d (ResNet-18's d = 11,173,962 ≡ 2
// mod 8) a group is a float2 and a block stages its row group's sums in
// shared memory and stores each output row from its own line boundary, 16
// bytes a lane, so that no line is written in parts by two warps: the
// card showed that the stores, not the loads, pay for rows off a line
// (the comment at complex_matmul_lines_kernel); the row's head is its
// first partial line, not a peeled loop. One float a lane at an odd d.
// The stores are evict-first. Each output element is still fmaf over k =
// 0 .. n-1 in row order from 0, so its bits are those of the
// one-column-a-thread kernel it replaces. tests/test_torch_encode_plan.py
// models the plan.

#include <cuda_runtime.h>
#include <stdint.h>

#include "audit.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowGroup = 8;  // rows per block (project) / per thread (encode)
constexpr int kUnroll = 2;  // project: column groups a thread loads at once
constexpr int kK = 8;  // encode: rows of G whose loads are in flight together
constexpr int kLineGroups = 16;  // encode: float2 groups of a 128-byte line
constexpr int kMaxBlocks = 132 * 8 * 4;  // grid-stride cap: 4 waves of 8 blocks/SM
constexpr int kMaxN = 64;  // the most rows of W or G the wrappers take

// W's row length in the encode's shared memory: n padded to kK
__host__ __device__ inline int padded(long long n) {
  return (int)((n + kK - 1) / kK * kK);
}

// dynamic shared bytes of the encode (the m×n pair of W, rows padded to
// kK; the line-stored encode also its staging of a row group's sums) and of
// the recombination (the n pair of v); the launchers and the audit share
// them
inline size_t matmul_smem(long long m, long long n) {
  return 2 * (size_t)m * padded(n) * sizeof(float);
}
inline size_t matmul_lines_smem(long long m, long long n) {
  return matmul_smem(m, n) +
         2 * (size_t)kRowGroup * kThreads * 2 * sizeof(float);
}
inline size_t vector_smem(long long n, long long) {
  return 2 * (size_t)n * sizeof(float);
}

inline int grid_for(long long d) {
  long long b = (d + kThreads - 1) / kThreads;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return b < 1 ? 1 : (int)b;
}

// V consecutive floats of one row, V-float aligned, in one access: a load
// through the read-only path, an evict-first store (st.global.cs)
template <int V>
__device__ __forceinline__ void load_cols(const float* p, float* x) {
  if constexpr (V == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if constexpr (V == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    x[0] = v.x; x[1] = v.y;
  } else {
    x[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_cols(float* p, const float* y) {
  if constexpr (V == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(y[0], y[1], y[2], y[3]));
  } else if constexpr (V == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(y[0], y[1]));
  } else {
    __stcs(p, y[0]);
  }
}

// Rows k0 .. k0 + kK - 1 of G (those < n) at this lane's V columns gc
// (live: they lie inside d), every load issued before any is used; 0 for
// the others
template <int V>
__device__ __forceinline__ void load_rows(const float* __restrict__ gc,
                                          long long d, int n, int k0,
                                          bool live, float (&x)[kK][V]) {
#pragma unroll
  for (int r = 0; r < kK; ++r) {
    if (live && k0 + r < n) {
      load_cols<V>(gc + (long long)(k0 + r) * d, x[r]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) x[r][v] = 0.f;
    }
  }
}

// Adds rows k0 .. k0 + kK - 1 of G (x) into the sums of output rows i0 ..
// i0 + kRowGroup - 1 (those < m), fmaf in row order. W's rows i0 + q,
// columns k0 .. k0 + 7, are two 16-byte reads of each of its shared-memory
// planes (rows padded to np).
template <int V>
__device__ __forceinline__ void fma_rows(const float4* __restrict__ sw4,
                                         int np, int m, int n, int i0, int k0,
                                         const float (&x)[kK][V],
                                         float (&ar)[kRowGroup][V],
                                         float (&ai)[kRowGroup][V]) {
#pragma unroll
  for (int q = 0; q < kRowGroup; ++q) {
    if (i0 + q < m) {
      const float4* pr = sw4 + ((i0 + q) * np + k0) / 4;
      const float4* pi = sw4 + ((m + i0 + q) * np + k0) / 4;
      const float4 a0 = pr[0], a1 = pr[1], b0 = pi[0], b1 = pi[1];
      const float wr[kK] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float wi[kK] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < kK; ++r) {
        if (k0 + r < n) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            ar[q][v] = fmaf(wr[r], x[r][v], ar[q][v]);
            ai[q][v] = fmaf(wi[r], x[r][v], ai[q][v]);
          }
        }
      }
    }
  }
}

template <int V>
__device__ __forceinline__ void zero_sums(float (&ar)[kRowGroup][V],
                                          float (&ai)[kRowGroup][V]) {
#pragma unroll
  for (int q = 0; q < kRowGroup; ++q) {
#pragma unroll
    for (int v = 0; v < V; ++v) { ar[q][v] = 0.f; ai[q][v] = 0.f; }
  }
}

// W into shared memory: [m][np] re, then [m][np] im, a padding column 0
__device__ __forceinline__ void load_w(const float* __restrict__ w_re,
                                       const float* __restrict__ w_im,
                                       float* sw, int m, int n, int np) {
  for (int t = threadIdx.x; t < m * np; t += blockDim.x) {
    const int i = t / np, k = t - i * np;
    sw[t] = k < n ? w_re[i * n + k] : 0.f;
    sw[m * np + t] = k < n ? w_im[i * n + k] : 0.f;
  }
  __syncthreads();
}

// (Wr + i·Wi) @ G for real G: W (m, n), G (n, d) -> out_re, out_im (m, d),
// where every row starts on a 128-byte line (V = 4) or at an odd d (V =
// 1). A lane takes the V columns [V·c, V·c + V) of column group c (V
// divides d, every row V-float aligned), kRowGroup output rows at a time,
// and stores them itself; a warp takes windows of 32 groups.
template <int V>
__global__ void __launch_bounds__(kThreads, 2)
complex_matmul_kernel(const float* __restrict__ w_re,
                      const float* __restrict__ w_im,
                      const float* __restrict__ g,
                      float* __restrict__ out_re,
                      float* __restrict__ out_im, int m, int n, long long d) {
  extern __shared__ float4 sw4[];  // W's two planes
  const int np = padded(n);
  load_w(w_re, w_im, reinterpret_cast<float*>(sw4), m, n, np);
  const long long groups = d / V;
  const long long windows = (groups + 31) / 32;
  for (long long win = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       win < windows; win += (long long)gridDim.x * kWarps) {
    const long long c = win * 32 + (threadIdx.x & 31);
    const bool live = c < groups;
    for (int i0 = 0; i0 < m; i0 += kRowGroup) {
      float ar[kRowGroup][V], ai[kRowGroup][V];
      zero_sums<V>(ar, ai);
      for (int k0 = 0; k0 < n; k0 += kK) {
        float x[kK][V];
        load_rows<V>(g + c * V, d, n, k0, live, x);
        fma_rows<V>(sw4, np, m, n, i0, k0, x, ar, ai);
      }
#pragma unroll
      for (int q = 0; q < kRowGroup; ++q) {
        if (live && i0 + q < m) {
          const long long at = (long long)(i0 + q) * d + c * V;
          store_cols<V>(out_re + at, ar[q]);
          store_cols<V>(out_im + at, ai[q]);
        }
      }
    }
  }
}

// The float2 group of row p at which a 128-byte line starts (0 .. 15; p
// 8-byte aligned)
__device__ __forceinline__ int line_shift(const float* p) {
  return (int)(((128u - ((uint32_t)(uintptr_t)p & 127u)) & 127u) >> 3);
}

// The encode at an even d whose rows start off a 128-byte line (ResNet-18's
// d ≡ 2 mod 8: row i starts 40·i mod 128 bytes past one), float2 groups.
// A line that two warps each write part of costs the card dearly
// (obs/narrow_read_ab.py at d = 11,173,962: one lane a group, each storing
// its own, 0.5267 ms; the same with the outputs' rows 256-byte aligned
// 0.3987; with only G's aligned 0.5470), so each output row is stored
// from its own line: a block's window computes the kThreads groups
// [240w − 16, 240w + 240), one a thread, stages each row group's sums in
// shared memory and stores, of output row p, the 240 groups (15 lines)
// from 240w − 16 + e_p (e_p = line_shift): 16 bytes a lane, every line
// written whole by one warp's store. The 16 groups a window shares with
// the window before are loaded and summed twice (6.25% more reads, most
// from L2); only a row's first and last lines stay partial. A window
// issues the next one's first loads of G before it stages and stores, so
// the block's reads stay in flight across its barriers.
__global__ void __launch_bounds__(kThreads, 2)
complex_matmul_lines_kernel(const float* __restrict__ w_re,
                            const float* __restrict__ w_im,
                            const float* __restrict__ g,
                            float* __restrict__ out_re,
                            float* __restrict__ out_im, int m, int n,
                            long long d) {
  constexpr int V = 2, kStored = kThreads - kLineGroups;
  extern __shared__ float4 sw4[];  // W's two planes, then the staging
  const int np = padded(n);
  load_w(w_re, w_im, reinterpret_cast<float*>(sw4), m, n, np);
  // [2 kRowGroup rows: re, im of each][kThreads groups] float2
  float2* stage = reinterpret_cast<float2*>(sw4 + m * np / 2);
  const long long groups = d / V;
  const long long windows = (groups + kLineGroups + kStored - 1) / kStored;
  // this thread's group of window w
  auto group_of = [&](long long w) { return w * kStored - kLineGroups +
                                            threadIdx.x; };
  // rows 0 .. kK - 1 of G at the first window's group, loaded ahead: each
  // window loads the next one's before its own stores, so the loads are
  // in flight while the block stages and stores
  float x[kK][V];
  {
    const long long c = group_of(blockIdx.x);
    load_rows<V>(g + c * V, d, n, 0, c >= 0 && c < groups, x);
  }
  for (long long win = blockIdx.x; win < windows; win += gridDim.x) {
    const long long c0 = win * kStored - kLineGroups;
    const long long c = group_of(win);
    const bool live = c >= 0 && c < groups;
    for (int i0 = 0; i0 < m; i0 += kRowGroup) {
      const int rows = min(kRowGroup, m - i0);
      float ar[kRowGroup][V], ai[kRowGroup][V];
      zero_sums<V>(ar, ai);
      for (int k0 = 0; k0 < n; k0 += kK) {
        if (i0 > 0 || k0 > 0) load_rows<V>(g + c * V, d, n, k0, live, x);
        fma_rows<V>(sw4, np, m, n, i0, k0, x, ar, ai);
      }
      if (i0 + kRowGroup >= m) {  // the window's last sums: load ahead
        const long long cn = group_of(win + gridDim.x);
        load_rows<V>(g + cn * V, d, n, 0, cn >= 0 && cn < groups, x);
      }
#pragma unroll
      for (int q = 0; q < kRowGroup; ++q) {
        if (q < rows) {
          stage[(2 * q) * kThreads + threadIdx.x] =
              make_float2(ar[q][0], ar[q][1]);
          stage[(2 * q + 1) * kThreads + threadIdx.x] =
              make_float2(ai[q][0], ai[q][1]);
        }
      }
      __syncthreads();
      // row slot s (re, im of row i0 + s / 2), float4 h of its 120
      for (int u = threadIdx.x; u < 2 * rows * (kStored / 2);
           u += kThreads) {
        const int slot = u / (kStored / 2), h = u - slot * (kStored / 2);
        float* row = ((slot & 1) ? out_im : out_re) +
                     (long long)(i0 + (slot >> 1)) * d;
        const int e = line_shift(row) + 2 * h;  // staged index of the pair
        const long long at = c0 + e;            // its first group
        const float2 a = stage[slot * kThreads + e];
        const float2 b = stage[slot * kThreads + e + 1];
        const float y[4] = {a.x, a.y, b.x, b.y};
        if (at >= 0 && at + 1 < groups) {
          store_cols<4>(row + at * V, y);
        } else {  // a row's first or last group
          if (at >= 0 && at < groups) store_cols<2>(row + at * V, y);
          if (at + 1 >= 0 && at + 1 < groups)
            store_cols<2>(row + (at + 1) * V, y + 2);
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// W consecutive floats, each read once: a streaming load (__ldcs, evict
// first), so the 715 MB stream does not keep lines in L2 that nothing reads
// again
template <int W>
struct Cols;
template <>
struct Cols<1> {
  float x;
  __device__ __forceinline__ static Cols load(const float* p) {
    return {__ldcs(p)};
  }
  __device__ __forceinline__ float dot(const Cols& f, float acc) const {
    return fmaf(x, f.x, acc);
  }
};
template <>
struct Cols<2> {
  float2 x;
  __device__ __forceinline__ static Cols load(const float* p) {
    return {__ldcs(reinterpret_cast<const float2*>(p))};
  }
  __device__ __forceinline__ float dot(const Cols& f, float acc) const {
    return fmaf(x.y, f.x.y, fmaf(x.x, f.x.x, acc));
  }
};

// Pass 1 of (Rr + i·Ri) @ f: block (c, row group y) sums, for up to
// kRowGroup rows, the W-column groups j ≡ c·kThreads + t (mod
// chunks·kThreads), kUnroll groups an iteration, reading f once per group
// for the whole row group; writes part[row, c]. W divides d.
template <int W>
__global__ void __launch_bounds__(kThreads)
project_partial_kernel(const float* __restrict__ r_re,
                       const float* __restrict__ r_im,
                       const float* __restrict__ f,
                       float* __restrict__ part_re,
                       float* __restrict__ part_im, int n, long long d,
                       int chunks) {
  using V = Cols<W>;
  const int i0 = blockIdx.y * kRowGroup;
  const int rows = min(kRowGroup, n - i0);
  const long long groups = d / W;
  const long long stride = (long long)chunks * kThreads;
  const float* rr = r_re + (long long)i0 * d;
  const float* ri = r_im + (long long)i0 * d;
  float ar[kRowGroup], ai[kRowGroup];
#pragma unroll
  for (int k = 0; k < kRowGroup; ++k) { ar[k] = 0.f; ai[k] = 0.f; }
  for (long long j0 = (long long)blockIdx.x * kThreads + threadIdx.x;
       j0 < groups; j0 += kUnroll * stride) {
    // every load of the iteration first, then the sums
    V fv[kUnroll], xr[kUnroll][kRowGroup], xi[kUnroll][kRowGroup];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = j0 + u * stride;
      const bool ok = j < groups;
      const long long c = W * j;
      fv[u] = ok ? V::load(f + c) : V{};  // a group past d adds 0
#pragma unroll
      for (int k = 0; k < kRowGroup; ++k) {
        if (k < rows) {
          xr[u][k] = ok ? V::load(rr + k * d + c) : V{};
          xi[u][k] = ok ? V::load(ri + k * d + c) : V{};
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int k = 0; k < kRowGroup; ++k) {
        if (k < rows) {
          ar[k] = xr[u][k].dot(fv[u], ar[k]);
          ai[k] = xi[u][k].dot(fv[u], ai[k]);
        }
      }
    }
  }
  // pass 2 may start launching now; it waits for this grid's partials
  cudaTriggerProgrammaticLaunchCompletion();
  __shared__ float red[2 * kRowGroup][kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kRowGroup; ++k) {
    const float sr = warp_sum(ar[k]);
    const float si = warp_sum(ai[k]);
    if (lane == 0) { red[k][warp] = sr; red[kRowGroup + k][warp] = si; }
  }
  __syncthreads();
  if (threadIdx.x < 2 * rows) {
    const int k = threadIdx.x % rows;
    const bool im = threadIdx.x >= rows;
    float acc = 0.f;
    for (int w = 0; w < kThreads / 32; ++w)
      acc += red[(im ? kRowGroup : 0) + k][w];
    (im ? part_im : part_re)[(long long)(i0 + k) * chunks + blockIdx.x] = acc;
  }
}

// Pass 2: one block per row sums its chunks partials in a fixed order. It
// is launched as a programmatic dependent of pass 1, so its launch overlaps
// pass 1's tail; it reads nothing before pass 1 has finished and its
// writes are visible (cudaGridDependencySynchronize).
__global__ void project_final_kernel(const float* __restrict__ part_re,
                                     const float* __restrict__ part_im,
                                     float* __restrict__ e_re,
                                     float* __restrict__ e_im, int chunks) {
  cudaGridDependencySynchronize();
  const int i = blockIdx.x;
  float sr = 0.f, si = 0.f;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    sr += part_re[(long long)i * chunks + c];
    si += part_im[(long long)i * chunks + c];
  }
  __shared__ float red[2][kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  sr = warp_sum(sr);
  si = warp_sum(si);
  if (lane == 0) { red[0][warp] = sr; red[1][warp] = si; }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.f, b = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) { a += red[0][w]; b += red[1][w]; }
    e_re[i] = a;
    e_im[i] = b;
  }
}

// Re[(vr + i·vi)ᵀ (Rr + i·Ri)] = vrᵀRr − viᵀRi: v (n,), R (n, d) -> out (d,).
__global__ void complex_recombine_kernel(const float* __restrict__ v_re,
                                         const float* __restrict__ v_im,
                                         const float* __restrict__ r_re,
                                         const float* __restrict__ r_im,
                                         float* __restrict__ out, int n,
                                         long long d) {
  extern __shared__ float sv[];  // [n] re, then [n] im
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    sv[t] = v_re[t];
    sv[n + t] = v_im[t];
  }
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    float acc_r = 0.f, acc_i = 0.f;
    for (int i = 0; i < n; ++i) {
      acc_r = fmaf(sv[i], __ldg(r_re + (long long)i * d + j), acc_r);
      acc_i = fmaf(sv[n + i], __ldg(r_im + (long long)i * d + j), acc_i);
    }
    out[j] = acc_r - acc_i;
  }
}

// The segment plan's fields (the comment at the top)
struct Tile {
  int seg;
  long long lo, hi;
};

__device__ __forceinline__ Tile tile_of(const int* __restrict__ plan,
                                        int tiles, int t) {
  return {__ldg(plan + t), (long long)__ldg(plan + tiles + t),
          (long long)__ldg(plan + 2 * tiles + t)};
}

// Pass 1 of the segmented projection: block (tile t, row group y) sums
// r[i, j]·f[j] over the tile's columns for up to kRowGroup rows, kUnroll
// columns of each row in flight a thread; writes part[row, t].
__global__ void __launch_bounds__(kThreads)
project_segments_partial_kernel(const float* __restrict__ r_re,
                                const float* __restrict__ r_im,
                                const float* __restrict__ f,
                                const int* __restrict__ plan, int tiles,
                                float* __restrict__ part_re,
                                float* __restrict__ part_im, int n,
                                long long d) {
  const int t = blockIdx.x;
  const Tile tl = tile_of(plan, tiles, t);
  const int i0 = blockIdx.y * kRowGroup;
  const int rows = min(kRowGroup, n - i0);
  const float* rr = r_re + (long long)i0 * d;
  const float* ri = r_im + (long long)i0 * d;
  float ar[kRowGroup], ai[kRowGroup];
#pragma unroll
  for (int k = 0; k < kRowGroup; ++k) { ar[k] = 0.f; ai[k] = 0.f; }
  for (long long j0 = tl.lo + threadIdx.x; j0 < tl.hi;
       j0 += kUnroll * kThreads) {
    float fv[kUnroll], xr[kUnroll][kRowGroup], xi[kUnroll][kRowGroup];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = j0 + u * kThreads;
      const bool ok = j < tl.hi;
      fv[u] = ok ? __ldg(f + j) : 0.f;  // a column past the tile adds 0
#pragma unroll
      for (int k = 0; k < kRowGroup; ++k) {
        xr[u][k] = ok && k < rows ? __ldg(rr + k * d + j) : 0.f;
        xi[u][k] = ok && k < rows ? __ldg(ri + k * d + j) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int k = 0; k < kRowGroup; ++k) {
        ar[k] = fmaf(xr[u][k], fv[u], ar[k]);
        ai[k] = fmaf(xi[u][k], fv[u], ai[k]);
      }
    }
  }
  __shared__ float red[2 * kRowGroup][kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kRowGroup; ++k) {
    const float sr = warp_sum(ar[k]);
    const float si = warp_sum(ai[k]);
    if (lane == 0) { red[k][warp] = sr; red[kRowGroup + k][warp] = si; }
  }
  __syncthreads();
  if (threadIdx.x < 2 * rows) {
    const int k = threadIdx.x % rows;
    const bool im = threadIdx.x >= rows;
    float acc = 0.f;
    for (int w = 0; w < kThreads / 32; ++w)
      acc += red[(im ? kRowGroup : 0) + k][w];
    (im ? part_im : part_re)[(long long)(i0 + k) * tiles + t] = acc;
  }
}

// Pass 2: block j sums segment j's tile partials of every row in a fixed
// order (strided over the threads, then lanes, then warps) into
// e[j, i] — the (S, n) stack of projected columns the locator reads.
__global__ void __launch_bounds__(kThreads)
project_segments_final_kernel(const float* __restrict__ part_re,
                              const float* __restrict__ part_im,
                              const int* __restrict__ plan, int tiles,
                              float* __restrict__ e_re,
                              float* __restrict__ e_im, int n) {
  const int j = blockIdx.x;
  const int t0 = __ldg(plan + 3 * tiles + j);
  const int t1 = __ldg(plan + 3 * tiles + j + 1);
  __shared__ float red[2][kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = 0; i < n; ++i) {
    float sr = 0.f, si = 0.f;
    for (int t = t0 + threadIdx.x; t < t1; t += kThreads) {
      sr += part_re[(long long)i * tiles + t];
      si += part_im[(long long)i * tiles + t];
    }
    sr = warp_sum(sr);
    si = warp_sum(si);
    if (lane == 0) { red[0][warp] = sr; red[1][warp] = si; }
    __syncthreads();
    if (threadIdx.x == 0) {
      float a = 0.f, b = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) { a += red[0][w]; b += red[1][w]; }
      e_re[(long long)j * n + i] = a;
      e_im[(long long)j * n + i] = b;
    }
    __syncthreads();
  }
}

// Re[(vr + i·vi)ᵀ (Rr + i·Ri)] with the v pair of each column's segment:
// v (S, n), R (n, d) -> out (d,) over the plan's columns. The tile's v
// pair in shared memory; each column the sum of complex_recombine_kernel.
__global__ void __launch_bounds__(kThreads)
recombine_segments_kernel(const float* __restrict__ v_re,
                          const float* __restrict__ v_im,
                          const float* __restrict__ r_re,
                          const float* __restrict__ r_im,
                          const int* __restrict__ plan, int tiles,
                          float* __restrict__ out, int n, long long d) {
  extern __shared__ float sv[];  // [n] re, then [n] im
  const Tile tl = tile_of(plan, tiles, blockIdx.x);
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    sv[t] = v_re[(long long)tl.seg * n + t];
    sv[n + t] = v_im[(long long)tl.seg * n + t];
  }
  __syncthreads();
  for (long long j = tl.lo + threadIdx.x; j < tl.hi; j += blockDim.x) {
    float acc_r = 0.f, acc_i = 0.f;
    for (int i = 0; i < n; ++i) {
      acc_r = fmaf(sv[i], __ldg(r_re + (long long)i * d + j), acc_r);
      acc_i = fmaf(sv[n + i], __ldg(r_im + (long long)i * d + j), acc_i);
    }
    out[j] = acc_r - acc_i;
  }
}

// float2 pairs when every row and f start 8-byte aligned
bool pairs_aligned(long long d, const float* a, const float* b,
                   const float* c) {
  const uintptr_t any = (uintptr_t)a | (uintptr_t)b | (uintptr_t)c;
  return d % 2 == 0 && any % 8 == 0;
}

// The blocks of one whole wave of a kernel (the SMs × the blocks a SM
// holds at `smem` dynamic bytes), queried once per device into `cache`
int wave(const void* fn, size_t smem, int* cache) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) {
    cudaGetLastError();
    dev = 0;
  }
  if (cache[dev] == 0) {
    int sms = 0, blocks = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads,
                                                  smem);
    cudaGetLastError();
    cache[dev] = sms * blocks < 1 ? 1 : sms * blocks;
  }
  return cache[dev];
}

// The encode at V columns a lane: one wave (at the largest W's shared
// memory), and no more blocks than d's column groups need
template <int V>
int launch_matmul(const float* w_re, const float* w_im, const float* g,
                  float* out_re, float* out_im, int m, int n, long long d,
                  cudaStream_t st) {
  static int cache[64];
  const int blocks = wave((const void*)complex_matmul_kernel<V>,
                          matmul_smem(kMaxN, kMaxN), cache);
  const long long need = (d / V + kThreads - 1) / kThreads;
  const int grid = need < blocks ? (int)need : blocks;
  complex_matmul_kernel<V><<<grid, kThreads, matmul_smem(m, n), st>>>(
      w_re, w_im, g, out_re, out_im, m, n, d);
  return (int)cudaGetLastError();
}

// The line-stored encode (float2): one wave, its shared memory raised past
// 48 KB for the largest W
int launch_matmul_lines(const float* w_re, const float* w_im, const float* g,
                        float* out_re, float* out_im, int m, int n,
                        long long d, cudaStream_t st) {
  static int cache[64];
  const size_t most = matmul_lines_smem(kMaxN, kMaxN);
  cudaError_t err = cudaFuncSetAttribute(
      complex_matmul_lines_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
  if (err != cudaSuccess) return (int)err;
  const int blocks = wave((const void*)complex_matmul_lines_kernel, most,
                          cache);
  const long long stored = kThreads - kLineGroups;
  const long long need = (d / 2 + kLineGroups + stored - 1) / stored;
  const int grid = need < blocks ? (int)need : blocks;
  complex_matmul_lines_kernel<<<grid, kThreads, matmul_lines_smem(m, n),
                                st>>>(w_re, w_im, g, out_re, out_im, m, n, d);
  return (int)cudaGetLastError();
}

const draco_audit::Entry kAudit[] = {
    {"complex_matmul_kernel<4>", (const void*)complex_matmul_kernel<4>,
     kThreads, matmul_smem, 0},
    {"complex_matmul_lines_kernel", (const void*)complex_matmul_lines_kernel,
     kThreads, matmul_lines_smem, 1},
    {"complex_matmul_kernel<1>", (const void*)complex_matmul_kernel<1>,
     kThreads, matmul_smem, 0},
    {"project_partial_kernel<2>", (const void*)project_partial_kernel<2>,
     kThreads, nullptr, 0},
    {"project_partial_kernel<1>", (const void*)project_partial_kernel<1>,
     kThreads, nullptr, 0},
    {"project_final_kernel", (const void*)project_final_kernel, kThreads,
     nullptr, 0},
    {"complex_recombine_kernel", (const void*)complex_recombine_kernel,
     kThreads, vector_smem, 0},
    {"project_segments_partial_kernel",
     (const void*)project_segments_partial_kernel, kThreads, nullptr, 0},
    {"project_segments_final_kernel",
     (const void*)project_segments_final_kernel, kThreads, nullptr, 0},
    {"recombine_segments_kernel", (const void*)recombine_segments_kernel,
     kThreads, vector_smem, 0},
};

}  // namespace

DRACO_AUDIT_EXPORTS(kAudit)

extern "C" {

// float4 columns where every row of the three buffers starts on a 128-byte
// line (d a multiple of 32, the buffers 128-byte aligned: the LM's d);
// float2 columns stored a line at a time at any other even d with the
// buffers 8-byte aligned (ResNet-18's d ≡ 2 mod 8); else single floats
int draco_complex_matmul(const float* w_re, const float* w_im, const float* g,
                         float* out_re, float* out_im, int m, int n,
                         long long d, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (d <= 0) return (int)cudaGetLastError();
  const uintptr_t any = (uintptr_t)g | (uintptr_t)out_re | (uintptr_t)out_im;
  if (d % 32 == 0 && any % 128 == 0)
    return launch_matmul<4>(w_re, w_im, g, out_re, out_im, m, n, d, st);
  if (d % 2 == 0 && any % 8 == 0)
    return launch_matmul_lines(w_re, w_im, g, out_re, out_im, m, n, d, st);
  return launch_matmul<1>(w_re, w_im, g, out_re, out_im, m, n, d, st);
}

// Blocks of pass 1 of a projection of n rows of length d: one whole wave of
// project_partial_kernel (the fewer resident blocks of its two instances,
// so either launch fits at once), split over the row groups, and no more
// than d needs. The wrapper sizes the (n, chunks) scratch with it.
int draco_project_chunks(int n, long long d) {
  static int cache[2][64];
  const int b2 = wave((const void*)project_partial_kernel<2>, 0, cache[0]);
  const int b1 = wave((const void*)project_partial_kernel<1>, 0, cache[1]);
  const long long row_groups = (n + kRowGroup - 1) / kRowGroup;
  long long c = (b2 < b1 ? b2 : b1) / (row_groups < 1 ? 1 : row_groups);
  const long long need = (d + kThreads - 1) / kThreads;  // one column a thread
  if (c > need) c = need;
  return c < 1 ? 1 : (int)c;
}

int draco_complex_project(const float* r_re, const float* r_im, const float* f,
                          float* part_re, float* part_im, float* e_re,
                          float* e_im, int n, long long d, int chunks,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(chunks, (n + kRowGroup - 1) / kRowGroup);
  if (pairs_aligned(d, r_re, r_im, f))
    project_partial_kernel<2><<<grid, kThreads, 0, st>>>(
        r_re, r_im, f, part_re, part_im, n, d, chunks);
  else
    project_partial_kernel<1><<<grid, kThreads, 0, st>>>(
        r_re, r_im, f, part_re, part_im, n, d, chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, project_final_kernel,
                           (const float*)part_re, (const float*)part_im, e_re,
                           e_im, chunks);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int draco_complex_recombine(const float* v_re, const float* v_im,
                            const float* r_re, const float* r_im, float* out,
                            int n, long long d, void* stream) {
  if (d > 0) {
    const size_t smem = vector_smem(n, 0);
    complex_recombine_kernel<<<grid_for(d), kThreads, smem,
                               (cudaStream_t)stream>>>(v_re, v_im, r_re, r_im,
                                                       out, n, d);
  }
  return (int)cudaGetLastError();
}

// The segmented projection over a plan of `tiles` tiles and `segments`
// segments: part (2, n, tiles) scratch, e_re / e_im (segments, n).
int draco_complex_project_segments(const float* r_re, const float* r_im,
                                   const float* f, const int* plan,
                                   int tiles, int segments, float* part_re,
                                   float* part_im, float* e_re, float* e_im,
                                   int n, long long d, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (tiles < 1 || segments < 1) return (int)cudaErrorInvalidValue;
  dim3 grid(tiles, (n + kRowGroup - 1) / kRowGroup);
  project_segments_partial_kernel<<<grid, kThreads, 0, st>>>(
      r_re, r_im, f, plan, tiles, part_re, part_im, n, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  project_segments_final_kernel<<<segments, kThreads, 0, st>>>(
      part_re, part_im, plan, tiles, e_re, e_im, n);
  return (int)cudaGetLastError();
}

// The segmented recombination: v (segments, n), out (d,) over the plan's
// columns.
int draco_complex_recombine_segments(const float* v_re, const float* v_im,
                                     const float* r_re, const float* r_im,
                                     const int* plan, int tiles, float* out,
                                     int n, long long d, void* stream) {
  if (tiles < 1) return (int)cudaErrorInvalidValue;
  recombine_segments_kernel<<<tiles, kThreads, vector_smem(n, 0),
                              (cudaStream_t)stream>>>(v_re, v_im, r_re, r_im,
                                                      plan, tiles, out, n, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
