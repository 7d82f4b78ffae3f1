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
// Design against that bound: one thread per column of d (grid-stride), so
// a warp's loads and stores are 32 consecutive floats of one row —
// coalesced 128-byte transactions; the small n×n (or n) coefficients live
// in shared memory. Each thread keeps the sums of up to kRowGroup output
// rows in registers, so at n <= 8 every input element is read from device
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

#include <cuda_runtime.h>
#include <stdint.h>

#include "audit.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowGroup = 8;  // project: rows per block, accumulators per thread
constexpr int kUnroll = 2;  // project: column groups a thread loads at once
constexpr int kMaxBlocks = 132 * 8 * 4;  // grid-stride cap: 4 waves of 8 blocks/SM

// dynamic shared bytes of the encode (the m×n pair of W) and of the
// recombination (the n pair of v); the launchers and the audit share them
inline size_t matmul_smem(long long m, long long n) {
  return 2 * (size_t)m * n * sizeof(float);
}
inline size_t vector_smem(long long n, long long) {
  return 2 * (size_t)n * sizeof(float);
}

inline int grid_for(long long d) {
  long long b = (d + kThreads - 1) / kThreads;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return b < 1 ? 1 : (int)b;
}

// (Wr + i·Wi) @ G for real G: W (m, n), G (n, d) -> out_re, out_im (m, d).
__global__ void complex_matmul_kernel(const float* __restrict__ w_re,
                                      const float* __restrict__ w_im,
                                      const float* __restrict__ g,
                                      float* __restrict__ out_re,
                                      float* __restrict__ out_im,
                                      int m, int n, long long d) {
  extern __shared__ float sw[];  // [m*n] re, then [m*n] im
  for (int t = threadIdx.x; t < m * n; t += blockDim.x) {
    sw[t] = w_re[t];
    sw[m * n + t] = w_im[t];
  }
  __syncthreads();
  const float* swr = sw;
  const float* swi = sw + m * n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    for (int i0 = 0; i0 < m; i0 += kRowGroup) {
      const int rows = min(kRowGroup, m - i0);
      float ar[kRowGroup], ai[kRowGroup];
#pragma unroll
      for (int r = 0; r < kRowGroup; ++r) { ar[r] = 0.f; ai[r] = 0.f; }
      for (int k = 0; k < n; ++k) {
        const float gv = __ldg(g + (long long)k * d + j);
#pragma unroll
        for (int r = 0; r < kRowGroup; ++r) {
          if (r < rows) {
            ar[r] = fmaf(swr[(i0 + r) * n + k], gv, ar[r]);
            ai[r] = fmaf(swi[(i0 + r) * n + k], gv, ai[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRowGroup; ++r) {
        if (r < rows) {
          out_re[(long long)(i0 + r) * d + j] = ar[r];
          out_im[(long long)(i0 + r) * d + j] = ai[r];
        }
      }
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

const draco_audit::Entry kAudit[] = {
    {"complex_matmul_kernel", (const void*)complex_matmul_kernel, kThreads,
     matmul_smem, 0},
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

int draco_complex_matmul(const float* w_re, const float* w_im, const float* g,
                         float* out_re, float* out_im, int m, int n,
                         long long d, void* stream) {
  if (d > 0) {
    const size_t smem = matmul_smem(m, n);
    complex_matmul_kernel<<<grid_for(d), kThreads, smem, (cudaStream_t)stream>>>(
        w_re, w_im, g, out_re, out_im, m, n, d);
  }
  return (int)cudaGetLastError();
}

// Blocks of pass 1 of a projection of n rows of length d: one whole wave of
// project_partial_kernel (the fewer resident blocks of its two instances,
// so either launch fits at once), split over the row groups, and no more
// than d needs. The wrapper sizes the (n, chunks) scratch with it.
int draco_project_chunks(int n, long long d) {
  static int resident[64];  // per device, queried once
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) {
    cudaGetLastError();
    dev = 0;
  }
  if (resident[dev] == 0) {
    int sms = 0, b2 = 0, b1 = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b2, project_partial_kernel<2>, kThreads, 0);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b1, project_partial_kernel<1>, kThreads, 0);
    cudaGetLastError();
    resident[dev] = sms * (b2 < b1 ? b2 : b1);
    if (resident[dev] < 1) resident[dev] = 1;
  }
  const long long row_groups = (n + kRowGroup - 1) / kRowGroup;
  long long c = resident[dev] / (row_groups < 1 ? 1 : row_groups);
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
