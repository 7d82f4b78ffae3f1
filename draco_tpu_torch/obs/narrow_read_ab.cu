// Variants of the narrow-wire decode's read path, for one timing run beside
// the kernels of csrc/narrow_decode.cu (included whole, so the new
// kernels, their launchers and helpers are the ones the port builds).
// Built and timed by draco_tpu_torch/obs/narrow_read_ab.py; nothing of the
// port launches them.
//
//   old   the one-thread-a-column kernels the strip kernels replaced: a
//         warp's load of a row is 32 consecutive elements, every element
//         takes its own scale load and a 64-bit j / block
//   (a)   old, but a warp walks 256 consecutive columns (one scale block
//         at block 256) and takes their block index once in 32 bits and
//         each row's scale once, into shared memory; loads stay one
//         element a thread
//   (b)   the new strip read (16-byte chunks, 16 int8 columns a lane,
//         shuffle and funnel shift), but each element still takes its own
//         scale load, a 64-bit j / block and an int8 conversion
//         instruction
//   old segments  the one-thread-a-column segmented recombination the
//         strip one replaced: a block a plan tile, its v pair in shared
//         memory, one wire element a load and each element its own scale
//         load
//
// Every variant sums the same products in the same order, so each output
// column has the same bits in all of them.

#include "../csrc/narrow_decode.cu"

namespace {

// the old read: the block index computed once a column, in 64 bits
template <typename T>
__device__ __forceinline__ float old_wire_at(const T* __restrict__ q,
                                             const float* __restrict__ scale,
                                             int i, long long j, long long d,
                                             long long blk, long long nb) {
  const float x = widen(q[(long long)i * d + j]);
  if constexpr (std::is_same<T, int8_t>::value) {
    return x * __ldg(scale + (long long)i * nb + blk);
  } else {
    return x;
  }
}

template <typename T>
__device__ __forceinline__ long long old_block_of(long long j, int block) {
  if constexpr (std::is_same<T, int8_t>::value) return j / block;
  return 0;
}

template <typename T>
__global__ void old_recombine_kernel(const float* __restrict__ v_re,
                                     const float* __restrict__ v_im,
                                     const T* __restrict__ q_re,
                                     const T* __restrict__ q_im,
                                     const float* __restrict__ s_re,
                                     const float* __restrict__ s_im,
                                     float* __restrict__ out, int n,
                                     long long d, int block, long long nb) {
  extern __shared__ float sv[];
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    sv[t] = v_re[t];
    sv[n + t] = v_im[t];
  }
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    const long long blk = old_block_of<T>(j, block);
    float acc_r = 0.f, acc_i = 0.f;
    for (int i = 0; i < n; ++i) {
      acc_r = fmaf(sv[i], old_wire_at(q_re, s_re, i, j, d, blk, nb), acc_r);
      acc_i = fmaf(sv[n + i], old_wire_at(q_im, s_im, i, j, d, blk, nb), acc_i);
    }
    out[j] = acc_r - acc_i;
  }
}

// (a): block % 256 == 0
__global__ void group_scale_kernel(const float* __restrict__ v_re,
                                   const float* __restrict__ v_im,
                                   const int8_t* __restrict__ q_re,
                                   const int8_t* __restrict__ q_im,
                                   const float* __restrict__ s_re,
                                   const float* __restrict__ s_im,
                                   float* __restrict__ out, int n,
                                   long long d, int block, long long nb) {
  extern __shared__ float sv[];  // [n] re, [n] im, then [kWarps][2·64] scales
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    sv[t] = v_re[t];
    sv[n + t] = v_im[t];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* sc = sv + 2 * n + warp * 128;
  const long long groups = (d + 255) / 256;
  for (long long g = (long long)blockIdx.x * kWarps + warp; g < groups;
       g += (long long)gridDim.x * kWarps) {
    const uint32_t blk = (uint32_t)(g * 256) / (uint32_t)block;
    for (int i = lane; i < n; i += 32) {
      sc[i] = __ldg(s_re + (long long)i * nb + blk);
      sc[64 + i] = __ldg(s_im + (long long)i * nb + blk);
    }
    __syncwarp();
    for (int k = 0; k < 8; ++k) {
      const long long j = g * 256 + k * 32 + lane;
      if (j < d) {
        float acc_r = 0.f, acc_i = 0.f;
        for (int i = 0; i < n; ++i) {
          acc_r = fmaf(sv[i], (float)q_re[(long long)i * d + j] * sc[i], acc_r);
          acc_i = fmaf(sv[n + i], (float)q_im[(long long)i * d + j] * sc[64 + i],
                       acc_i);
        }
        out[j] = acc_r - acc_i;
      }
    }
    __syncwarp();
  }
}

// (b): the strip read with per-element scales, divisions and conversions
__global__ void __launch_bounds__(kThreads)
strip_only_kernel(const float* __restrict__ v_re,
                  const float* __restrict__ v_im,
                  const void* __restrict__ q_re, const void* __restrict__ q_im,
                  const float* __restrict__ s_re,
                  const float* __restrict__ s_im, float* __restrict__ out,
                  int n, long long d, int block, long long nb) {
  constexpr int CW = 4, CB = 16, W = 16;
  extern __shared__ float sv[];
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    sv[t] = v_re[t];
    sv[n + t] = v_im[t];
  }
  __syncthreads();
  const Span sp = meet(wide_span(q_re, n, d, 1, CB),
                       wide_span(q_im, n, d, 1, CB));
  const int lane = threadIdx.x & 31;
  const long long windows = (sp.hi - sp.lo + kStrips - 1) / kStrips;
  for (long long win = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       win < windows; win += (long long)gridDim.x * kWarps) {
    const long long s = sp.lo + win * kStrips + lane;
    const bool mine = lane < kStrips && s < sp.hi;
    const bool feed = s <= sp.hi;
    const long long j0 = s * W;
    float acc_r[W], acc_i[W];
#pragma unroll
    for (int w = 0; w < W; ++w) { acc_r[w] = 0.f; acc_i[w] = 0.f; }
    for (int i0 = 0; i0 < n; i0 += kRows) {
      Chunk<CW> cr[kRows], ci[kRows];
      uint32_t ar[kRows], ai[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (i0 + r < n) {
          const RowAt pr = row_at<CB>(q_re, d, i0 + r);
          const RowAt pi = row_at<CB>(q_im, d, i0 + r);
          ar[r] = pr.a;
          ai[r] = pi.a;
          cr[r] = feed ? load_chunk<CW>(pr.chunk + s * CB) : Chunk<CW>{};
          ci[r] = feed ? load_chunk<CW>(pi.chunk + s * CB) : Chunk<CW>{};
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (i0 + r < n) {
          const int i = i0 + r;
          const Chunk<CW> xr = strip_of<CW>(cr[r], ar[r]);
          const Chunk<CW> xi = strip_of<CW>(ci[r], ai[r]);
#pragma unroll
          for (int w = 0; w < W; ++w) {
            if (mine) {
              const long long j = j0 + w;
              const float fr = __ldg(s_re + (long long)i * nb + j / block);
              const float fi = __ldg(s_im + (long long)i * nb + j / block);
              const float x = (float)(int8_t)(xr.w[w / 4] >> (8 * (w % 4)));
              const float y = (float)(int8_t)(xi.w[w / 4] >> (8 * (w % 4)));
              acc_r[w] = fmaf(sv[i], x * fr, acc_r[w]);
              acc_i[w] = fmaf(sv[n + i], y * fi, acc_i[w]);
            }
          }
        }
      }
    }
    if (mine) {
#pragma unroll
      for (int w = 0; w < W; ++w) out[j0 + w] = acc_r[w] - acc_i[w];
    }
  }
  const long long c0 = sp.lo * W, c1 = sp.hi * W;
  const long long tail = c0 + (d - c1);
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < tail; t += (long long)gridDim.x * blockDim.x) {
    const long long j = t < c0 ? t : c1 + (t - c0);
    float acc_r = 0.f, acc_i = 0.f;
    for (int i = 0; i < n; ++i) {
      acc_r = fmaf(sv[i], wire_at((const int8_t*)q_re, s_re, i, j, d, block, nb),
                   acc_r);
      acc_i = fmaf(sv[n + i],
                   wire_at((const int8_t*)q_im, s_im, i, j, d, block, nb),
                   acc_i);
    }
    out[j] = acc_r - acc_i;
  }
}

template <typename T>
__global__ void old_approx_partial_kernel(
    const T* __restrict__ q, const float* __restrict__ scale,
    const float* __restrict__ bg, const float* __restrict__ vn,
    const float* __restrict__ pres, float* __restrict__ dec,
    float* __restrict__ part_d, float* __restrict__ part_g, int n,
    long long d, int block, long long nb, float inv_n) {
  extern __shared__ float sh[];
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    sh[t] = vn[t];
    sh[n + t] = pres[t];
  }
  __syncthreads();
  float sd = 0.f, sg = 0.f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    const long long blk = old_block_of<T>(j, block);
    float acc = 0.f, mean = 0.f;
    for (int i = 0; i < n; ++i) {
      if (sh[n + i] > 0.f)
        acc = fmaf(sh[i], old_wire_at(q, scale, i, j, d, blk, nb), acc);
      const float b = __ldg(bg + (long long)i * d + j);
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

// the old segmented recombination: block t takes plan tile t
template <int R>
__global__ void __launch_bounds__(kThreads)
old_segments_kernel(const float* __restrict__ v_re,
                    const float* __restrict__ v_im,
                    const void* __restrict__ q_re,
                    const void* __restrict__ q_im,
                    const float* __restrict__ s_re,
                    const float* __restrict__ s_im,
                    const int* __restrict__ plan, int tiles,
                    float* __restrict__ out, int n, long long d, int block,
                    long long nb) {
  using T = typename Wire<R>::T;
  extern __shared__ float sv[];  // [n] re, then [n] im
  const int seg = __ldg(plan + blockIdx.x);
  const long long lo = __ldg(plan + tiles + blockIdx.x);
  const long long hi = __ldg(plan + 2 * tiles + blockIdx.x);
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    sv[t] = v_re[(long long)seg * n + t];
    sv[n + t] = v_im[(long long)seg * n + t];
  }
  __syncthreads();
  const T* qr = (const T*)q_re;
  const T* qi = (const T*)q_im;
  for (long long j = lo + threadIdx.x; j < hi; j += blockDim.x) {
    long long bj = 0;  // int8: the column's scale block, in 32 bits
    if constexpr (R == kInt8) bj = block_of(j, block, d);
    float acc_r = 0.f, acc_i = 0.f;
    for (int i = 0; i < n; ++i) {
      float x = widen(qr[(long long)i * d + j]);
      float y = widen(qi[(long long)i * d + j]);
      if constexpr (R == kInt8) {
        x *= __ldg(s_re + (long long)i * nb + bj);
        y *= __ldg(s_im + (long long)i * nb + bj);
      }
      acc_r = fmaf(sv[i], x, acc_r);
      acc_i = fmaf(sv[n + i], y, acc_i);
    }
    out[j] = acc_r - acc_i;
  }
}

constexpr int kOldGridCap = 132 * 8 * 4;  // the old kernels' 4-wave cap
constexpr int kOldChunks = 132 * 8;       // the old approx pass 1: one wave

inline int old_grid(long long d, int cap) {
  long long b = (d + kThreads - 1) / kThreads;
  if (b > cap) b = cap;
  return b < 1 ? 1 : (int)b;
}

}  // namespace

extern "C" {

// variant: 0 old, 1 (a), 2 (b) — (a) and (b) int8 only
int draco_ab_recombine(int variant, const float* v_re, const float* v_im,
                       const void* q_re, const void* q_im, const float* s_re,
                       const float* s_im, float* out, int n, long long d,
                       int wire, int block, long long nb, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = vector_smem(n, 0);
  if (variant == 0 && wire == kBF16)
    old_recombine_kernel<__nv_bfloat16><<<old_grid(d, kOldGridCap), kThreads,
                                          smem, st>>>(
        v_re, v_im, (const __nv_bfloat16*)q_re, (const __nv_bfloat16*)q_im,
        s_re, s_im, out, n, d, block, nb);
  else if (variant == 0 && wire == kInt8)
    old_recombine_kernel<int8_t><<<old_grid(d, kOldGridCap), kThreads, smem,
                                   st>>>(
        v_re, v_im, (const int8_t*)q_re, (const int8_t*)q_im, s_re, s_im, out,
        n, d, block, nb);
  else if (variant == 1 && wire == kInt8 && block % 256 == 0)
    group_scale_kernel<<<old_grid(d, kOldGridCap), kThreads,
                         smem + kWarps * 128 * sizeof(float), st>>>(
        v_re, v_im, (const int8_t*)q_re, (const int8_t*)q_im, s_re, s_im, out,
        n, d, block, nb);
  else if (variant == 2 && wire == kInt8)
    strip_only_kernel<<<old_grid(d, kOldGridCap), kThreads, smem, st>>>(
        v_re, v_im, q_re, q_im, s_re, s_im, out, n, d, block, nb);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// the strip recombination at 8-byte chunks (8 int8 columns a lane)
int draco_ab_recombine_cw2(const float* v_re, const float* v_im,
                           const void* q_re, const void* q_im,
                           const float* s_re, const float* s_im, float* out,
                           int n, long long d, int block, long long nb,
                           void* stream) {
  if (block % 8 != 0) return (int)cudaErrorInvalidValue;
  return launch_recombine<kInt8, 2>(v_re, v_im, q_re, q_im, s_re, s_im, out,
                                    n, d, block, nb, (cudaStream_t)stream);
}

// the old segmented recombination: wire 1 bf16, 2 int8 (any block)
int draco_ab_segments_old(const float* v_re, const float* v_im,
                          const void* q_re, const void* q_im,
                          const float* s_re, const float* s_im,
                          const int* plan, int tiles, float* out, int n,
                          long long d, int wire, int block, long long nb,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = vector_smem(n, 0);
  if (wire == kBF16)
    old_segments_kernel<kBF16><<<tiles, kThreads, smem, st>>>(
        v_re, v_im, q_re, q_im, s_re, s_im, plan, tiles, out, n, d, block,
        nb);
  else if (wire == kInt8)
    old_segments_kernel<kInt8><<<tiles, kThreads, smem, st>>>(
        v_re, v_im, q_re, q_im, s_re, s_im, plan, tiles, out, n, d, block,
        nb);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

int draco_ab_approx_old_chunks(long long d) { return old_grid(d, kOldChunks); }

int draco_ab_approx_old(const void* q, const float* scale, const float* bg,
                        const float* vn, const float* pres, float* dec,
                        float* part, float* sums, int n, long long d, int wire,
                        int block, long long nb, int chunks, float inv_n,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = vector_smem(n, 0);
  if (wire == kF32)
    old_approx_partial_kernel<float><<<chunks, kThreads, smem, st>>>(
        (const float*)q, scale, bg, vn, pres, dec, part, part + chunks, n, d,
        block, nb, inv_n);
  else if (wire == kBF16)
    old_approx_partial_kernel<__nv_bfloat16><<<chunks, kThreads, smem, st>>>(
        (const __nv_bfloat16*)q, scale, bg, vn, pres, dec, part, part + chunks,
        n, d, block, nb, inv_n);
  else if (wire == kInt8)
    old_approx_partial_kernel<int8_t><<<chunks, kThreads, smem, st>>>(
        (const int8_t*)q, scale, bg, vn, pres, dec, part, part + chunks, n, d,
        block, nb, inv_n);
  else
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  approx_decode_final_kernel<<<1, kThreads, 0, st>>>(part, part + chunks, sums,
                                                     chunks);
  return (int)cudaGetLastError();
}

}  // extern "C"
