// Variants of the cyclic encode, for one timing run beside the kernels of
// csrc/coded.cu (included whole, so the new encode, its launchers and
// helpers are the ones the port builds). Built and timed by
// draco_tpu_torch/obs/narrow_read_ab.py; nothing of the port launches them.
//
//   old          the one-thread-a-column encode the column-group kernel
//                replaced: 4-byte loads of G in a loop bounded at run time,
//                plain stores, the grid capped at 4 waves of 8 blocks a SM
//   lines        the new kernel's line-stored float2 path where it takes
//                float4 (every row on a 128-byte line)
//   strided      float2 columns, each lane storing its own (no sector
//                shift), with G's rows ld_g floats apart and the outputs'
//                ld_out: at ld_g = ld_out = d the kernel before the shift
//                ("unstaged"); with one of them a multiple of 64, which
//                of the loads and the stores pays for rows that start off
//                a 32-byte sector
//
// Every variant sums the same products in the same order, so each output
// element has the same bits in all of them.

#include "../csrc/coded.cu"

namespace {

__global__ void old_matmul_kernel(const float* __restrict__ w_re,
                                  const float* __restrict__ w_im,
                                  const float* __restrict__ g,
                                  float* __restrict__ out_re,
                                  float* __restrict__ out_im, int m, int n,
                                  long long d) {
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

// float2 columns, one group a thread (grid-stride), each stored by the
// thread that computed it (no line staging), with row strides of their own
// for G and for the outputs (d columns of each row)
__global__ void __launch_bounds__(kThreads, 2)
strided_matmul_kernel(const float* __restrict__ w_re,
                      const float* __restrict__ w_im,
                      const float* __restrict__ g, float* __restrict__ out_re,
                      float* __restrict__ out_im, int m, int n, long long d,
                      long long ld_g, long long ld_out) {
  constexpr int V = 2;
  extern __shared__ float4 sw4[];
  float* sw = reinterpret_cast<float*>(sw4);
  const int np = padded(n);
  for (int t = threadIdx.x; t < m * np; t += blockDim.x) {
    const int i = t / np, k = t - i * np;
    sw[t] = k < n ? w_re[i * n + k] : 0.f;
    sw[m * np + t] = k < n ? w_im[i * n + k] : 0.f;
  }
  __syncthreads();
  const long long groups = d / V;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       c < groups; c += stride) {
    const float* gc = g + c * V;
    for (int i0 = 0; i0 < m; i0 += kRowGroup) {
      float ar[kRowGroup][V], ai[kRowGroup][V];
#pragma unroll
      for (int q = 0; q < kRowGroup; ++q) {
#pragma unroll
        for (int v = 0; v < V; ++v) { ar[q][v] = 0.f; ai[q][v] = 0.f; }
      }
      for (int k0 = 0; k0 < n; k0 += kK) {
        float x[kK][V];
#pragma unroll
        for (int r = 0; r < kK; ++r) {
          if (k0 + r < n) {
            load_cols<V>(gc + (long long)(k0 + r) * ld_g, x[r]);
          } else {
#pragma unroll
            for (int v = 0; v < V; ++v) x[r][v] = 0.f;
          }
        }
#pragma unroll
        for (int q = 0; q < kRowGroup; ++q) {
          if (i0 + q < m) {
            const float4* pr = sw4 + ((i0 + q) * np + k0) / 4;
            const float4* pi = sw4 + ((m + i0 + q) * np + k0) / 4;
            const float4 a0 = pr[0], a1 = pr[1], b0 = pi[0], b1 = pi[1];
            const float wr[kK] = {a0.x, a0.y, a0.z, a0.w,
                                  a1.x, a1.y, a1.z, a1.w};
            const float wi[kK] = {b0.x, b0.y, b0.z, b0.w,
                                  b1.x, b1.y, b1.z, b1.w};
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
#pragma unroll
      for (int q = 0; q < kRowGroup; ++q) {
        if (i0 + q < m) {
          const long long at = (long long)(i0 + q) * ld_out + c * V;
          store_cols<V>(out_re + at, ar[q]);
          store_cols<V>(out_im + at, ai[q]);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// the strided variant: d even, every row 8-byte aligned
int draco_ab_matmul_strided(const float* w_re, const float* w_im,
                            const float* g, float* out_re, float* out_im,
                            int m, int n, long long d, long long ld_g,
                            long long ld_out, void* stream) {
  static int cache[64];
  const int blocks = wave((const void*)strided_matmul_kernel,
                          matmul_smem(kMaxN, kMaxN), cache);
  const long long need = (d / 2 + kThreads - 1) / kThreads;
  strided_matmul_kernel<<<need < blocks ? (int)need : blocks, kThreads,
                          matmul_smem(m, n), (cudaStream_t)stream>>>(
      w_re, w_im, g, out_re, out_im, m, n, d, ld_g, ld_out);
  return (int)cudaGetLastError();
}

// variant: 0 old, 1 lines (d even, 8-byte aligned)
int draco_ab_matmul(int variant, const float* w_re, const float* w_im,
                    const float* g, float* out_re, float* out_im, int m,
                    int n, long long d, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (variant) {
    case 0:
      old_matmul_kernel<<<grid_for(d), kThreads,
                          2 * (size_t)m * n * sizeof(float), st>>>(
          w_re, w_im, g, out_re, out_im, m, n, d);
      return (int)cudaGetLastError();
    case 1:
      if (d % 2 != 0) return (int)cudaErrorInvalidValue;
      return launch_matmul_lines(w_re, w_im, g, out_re, out_im, m, n, d, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
