// Complex-arithmetic products of the cyclic gradient code, by hand for
// Hopper (sm_90a). Plain C interface, loaded with ctypes by
// draco_tpu_torch/ops/coded.py; every launch goes on the caller's stream
// and the functions return cudaGetLastError().
//
// Replaces the Pallas TPU kernels of draco_tpu/ops/coded.py:
//   complex_matmul     <- _matmul_kernel / _matmul_pallas    (coded.py:70, pallas_call :82)
//   complex_project    <- _project_kernel / _project_pallas  (coded.py:128, pallas_call :152)
//   complex_recombine  <- _recombine_kernel / _recombine_pallas (coded.py:188, pallas_call :201)
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
// complex_project reduces over d in two deterministic passes (per-block
// partials into an (n, chunks) scratch, then one block per row sums them in
// a fixed order) — no float atomics, so the result is the same run to run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowGroup = 8;  // project: rows per block, accumulators per thread
constexpr int kMaxBlocks = 132 * 8 * 4;  // grid-stride cap: 4 waves of 8 blocks/SM

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

// Pass 1 of (Rr + i·Ri) @ f: block (c, row group y) sums columns
// j ≡ c·T + t (mod chunks·T) for up to kRowGroup rows, reading f once per
// column for the whole group; writes part[row, c].
__global__ void project_partial_kernel(const float* __restrict__ r_re,
                                       const float* __restrict__ r_im,
                                       const float* __restrict__ f,
                                       float* __restrict__ part_re,
                                       float* __restrict__ part_im,
                                       int n, long long d, int chunks) {
  const int i0 = blockIdx.y * kRowGroup;
  const int rows = min(kRowGroup, n - i0);
  float ar[kRowGroup], ai[kRowGroup];
#pragma unroll
  for (int k = 0; k < kRowGroup; ++k) { ar[k] = 0.f; ai[k] = 0.f; }
  const long long stride = (long long)chunks * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    const float fj = __ldg(f + j);
#pragma unroll
    for (int k = 0; k < kRowGroup; ++k) {
      if (k < rows) {
        const long long o = (long long)(i0 + k) * d + j;
        ar[k] = fmaf(__ldg(r_re + o), fj, ar[k]);
        ai[k] = fmaf(__ldg(r_im + o), fj, ai[k]);
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
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w)
      acc += red[(im ? kRowGroup : 0) + k][w];
    (im ? part_im : part_re)[(long long)(i0 + k) * chunks + blockIdx.x] = acc;
  }
}

// Pass 2: one block per row sums its chunks partials in a fixed order.
__global__ void project_final_kernel(const float* __restrict__ part_re,
                                     const float* __restrict__ part_im,
                                     float* __restrict__ e_re,
                                     float* __restrict__ e_im, int chunks) {
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

}  // namespace

extern "C" {

int draco_complex_matmul(const float* w_re, const float* w_im, const float* g,
                         float* out_re, float* out_im, int m, int n,
                         long long d, void* stream) {
  if (d > 0) {
    const size_t smem = 2 * (size_t)m * n * sizeof(float);
    complex_matmul_kernel<<<grid_for(d), kThreads, smem, (cudaStream_t)stream>>>(
        w_re, w_im, g, out_re, out_im, m, n, d);
  }
  return (int)cudaGetLastError();
}

// Number of pass-1 chunks for a reduction of length d (the wrapper sizes
// the (n, chunks) scratch with it).
int draco_project_chunks(long long d) {
  long long c = (d + 4095) / 4096;
  if (c > 1024) c = 1024;
  return c < 1 ? 1 : (int)c;
}

int draco_complex_project(const float* r_re, const float* r_im, const float* f,
                          float* part_re, float* part_im, float* e_re,
                          float* e_im, int n, long long d, int chunks,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(chunks, (n + kRowGroup - 1) / kRowGroup);
  project_partial_kernel<<<grid, kThreads, 0, st>>>(r_re, r_im, f, part_re,
                                                    part_im, n, d, chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  project_final_kernel<<<n, kThreads, 0, st>>>(part_re, part_im, e_re, e_im,
                                               chunks);
  return (int)cudaGetLastError();
}

int draco_complex_recombine(const float* v_re, const float* v_im,
                            const float* r_re, const float* r_im, float* out,
                            int n, long long d, void* stream) {
  if (d > 0) {
    const size_t smem = 2 * (size_t)n * sizeof(float);
    complex_recombine_kernel<<<grid_for(d), kThreads, smem,
                               (cudaStream_t)stream>>>(v_re, v_im, r_re, r_im,
                                                       out, n, d);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
