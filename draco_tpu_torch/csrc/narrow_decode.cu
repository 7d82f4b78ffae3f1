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
//
// What bounds them on an H100: both stream (n, d) operands once with
// n <= 64 (n = 8 on the main path) and do a few flops per element, far
// below the card's balance point — they are bound by device-memory bytes
// (3.35 TB/s). At n = 8, d = 11,173,962: the narrow recombination reads
// 2·n·d wire elements (bf16 357.6 MB, int8 178.8 MB + 2·n·⌈d/256⌉ scales)
// and writes d f32; the approx decode reads n·d wire elements and the
// (n, d) f32 batch gradients and writes d f32.
//
// Design against that bound (csrc/coded.cu's): one thread per column of d
// (grid-stride), so a warp reads 32 consecutive elements of one row; the
// n-row sums stay in registers and every element is read once. The wire
// element type is a template parameter: the TPU kernel's in-tile
// dequantization (a one-hot matmul, since Mosaic has no gather) becomes
// one load and one multiply by scale[i, j / block], for any block >= 1.
// No padding: the ragged tail is the loop bound.
//
// approx_decode skips the rows of absent workers (pres[i] == 0, the same
// for every thread, so no divergence): an absent row is never read, which
// is the reference's true zero-fill — a NaN payload there cannot reach the
// sum. It reduces Σ(dec − mean)² and Σ bg² in two deterministic passes
// (per-block partials, then one block in a fixed order), as
// complex_project does: no float atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "audit.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8 * 4;  // grid-stride cap: 4 waves of 8 blocks/SM
constexpr int kDecodeChunks = 132 * 8;   // approx pass-1 blocks: one wave

enum WireType { kF32 = 0, kBF16 = 1, kInt8 = 2 };

// dynamic shared bytes of both kernels' n-vector pair; the launchers and
// the audit share it
inline size_t vector_smem(long long n, long long) {
  return 2 * (size_t)n * sizeof(float);
}

inline int grid_for(long long d) {
  long long b = (d + kThreads - 1) / kThreads;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return b < 1 ? 1 : (int)b;
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float widen(int8_t x) { return (float)x; }

// Row i, column j of a wire buffer as f32: the element, times its block's
// scale for int8 (blk = j / block, computed once per column).
template <typename T>
__device__ __forceinline__ float wire_at(const T* __restrict__ q,
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
__device__ __forceinline__ long long block_of(long long j, int block) {
  if constexpr (std::is_same<T, int8_t>::value) return j / block;
  return 0;
}

// Re[(vr + i·vi)ᵀ (Qr + i·Qi)] = Σ vr·Qr − Σ vi·Qi with Q the widened wire:
// v (n,), Q (n, d) -> out (d,).
template <typename T>
__global__ void narrow_recombine_kernel(const float* __restrict__ v_re,
                                        const float* __restrict__ v_im,
                                        const T* __restrict__ q_re,
                                        const T* __restrict__ q_im,
                                        const float* __restrict__ s_re,
                                        const float* __restrict__ s_im,
                                        float* __restrict__ out, int n,
                                        long long d, int block, long long nb) {
  extern __shared__ float sv[];  // [n] re, then [n] im
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    sv[t] = v_re[t];
    sv[n + t] = v_im[t];
  }
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    const long long blk = block_of<T>(j, block);
    float acc_r = 0.f, acc_i = 0.f;
    for (int i = 0; i < n; ++i) {
      acc_r = fmaf(sv[i], wire_at(q_re, s_re, i, j, d, blk, nb), acc_r);
      acc_i = fmaf(sv[n + i], wire_at(q_im, s_im, i, j, d, blk, nb), acc_i);
    }
    out[j] = acc_r - acc_i;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
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
// writes dec and this block's partial sums of (dec − mean)² and bg².
template <typename T>
__global__ void approx_decode_partial_kernel(
    const T* __restrict__ q, const float* __restrict__ scale,
    const float* __restrict__ bg, const float* __restrict__ vn,
    const float* __restrict__ pres, float* __restrict__ dec,
    float* __restrict__ part_d, float* __restrict__ part_g, int n,
    long long d, int block, long long nb, float inv_n) {
  extern __shared__ float sh[];  // [n] v/n, then [n] presence
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    sh[t] = vn[t];
    sh[n + t] = pres[t];
  }
  __syncthreads();
  float sd = 0.f, sg = 0.f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    const long long blk = block_of<T>(j, block);
    float acc = 0.f, mean = 0.f;
    for (int i = 0; i < n; ++i) {
      if (sh[n + i] > 0.f)
        acc = fmaf(sh[i], wire_at(q, scale, i, j, d, blk, nb), acc);
      const float b = __ldg(bg + (long long)i * d + j);
      mean = fmaf(inv_n, b, mean);
      sg = fmaf(b, b, sg);
    }
    dec[j] = acc;
    const float diff = acc - mean;
    sd = fmaf(diff, diff, sd);
  }
  __shared__ float red[kThreads / 32];
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
  __shared__ float red[kThreads / 32];
  a = block_sum(a, red);
  b = block_sum(b, red);
  if (threadIdx.x == 0) {
    sums[0] = a;
    sums[1] = b;
  }
}

template <typename T>
void launch_recombine(const float* v_re, const float* v_im, const void* q_re,
                      const void* q_im, const float* s_re, const float* s_im,
                      float* out, int n, long long d, int block, long long nb,
                      cudaStream_t st) {
  const size_t smem = vector_smem(n, 0);
  narrow_recombine_kernel<T><<<grid_for(d), kThreads, smem, st>>>(
      v_re, v_im, (const T*)q_re, (const T*)q_im, s_re, s_im, out, n, d,
      block, nb);
}

template <typename T>
void launch_approx(const void* q, const float* scale, const float* bg,
                   const float* vn, const float* pres, float* dec,
                   float* part, int n, long long d, int block, long long nb,
                   int chunks, float inv_n, cudaStream_t st) {
  const size_t smem = vector_smem(n, 0);
  approx_decode_partial_kernel<T><<<chunks, kThreads, smem, st>>>(
      (const T*)q, scale, bg, vn, pres, dec, part, part + chunks, n, d, block,
      nb, inv_n);
}

const draco_audit::Entry kAudit[] = {
    {"narrow_recombine_kernel<float>",
     (const void*)narrow_recombine_kernel<float>, kThreads, vector_smem, 0},
    {"narrow_recombine_kernel<__nv_bfloat16>",
     (const void*)narrow_recombine_kernel<__nv_bfloat16>, kThreads,
     vector_smem, 0},
    {"narrow_recombine_kernel<int8_t>",
     (const void*)narrow_recombine_kernel<int8_t>, kThreads, vector_smem, 0},
    {"approx_decode_partial_kernel<float>",
     (const void*)approx_decode_partial_kernel<float>, kThreads, vector_smem,
     0},
    {"approx_decode_partial_kernel<__nv_bfloat16>",
     (const void*)approx_decode_partial_kernel<__nv_bfloat16>, kThreads,
     vector_smem, 0},
    {"approx_decode_partial_kernel<int8_t>",
     (const void*)approx_decode_partial_kernel<int8_t>, kThreads,
     vector_smem, 0},
    {"approx_decode_final_kernel", (const void*)approx_decode_final_kernel,
     kThreads, nullptr, 0},
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
  if (d > 0) {
    switch (wire) {
      case kF32:
        launch_recombine<float>(v_re, v_im, q_re, q_im, s_re, s_im, out, n, d,
                                block, nb, st);
        break;
      case kBF16:
        launch_recombine<__nv_bfloat16>(v_re, v_im, q_re, q_im, s_re, s_im,
                                        out, n, d, block, nb, st);
        break;
      case kInt8:
        launch_recombine<int8_t>(v_re, v_im, q_re, q_im, s_re, s_im, out, n,
                                 d, block, nb, st);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

// Number of pass-1 blocks of the approx decode at length d (the wrapper
// sizes the (2, chunks) partials with it).
int draco_approx_decode_chunks(long long d) {
  long long c = (d + kThreads - 1) / kThreads;
  if (c > kDecodeChunks) c = kDecodeChunks;
  return c < 1 ? 1 : (int)c;
}

// sums: (2,) f32 <- [Σ(dec − mean)², Σ bg²]; part: (2, chunks) scratch.
int draco_approx_decode(const void* q, const float* scale, const float* bg,
                        const float* vn, const float* pres, float* dec,
                        float* part, float* sums, int n, long long d,
                        int wire, int block, long long nb, int chunks,
                        float inv_n, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (wire) {
    case kF32:
      launch_approx<float>(q, scale, bg, vn, pres, dec, part, n, d, block, nb,
                           chunks, inv_n, st);
      break;
    case kBF16:
      launch_approx<__nv_bfloat16>(q, scale, bg, vn, pres, dec, part, n, d,
                                   block, nb, chunks, inv_n, st);
      break;
    case kInt8:
      launch_approx<int8_t>(q, scale, bg, vn, pres, dec, part, n, d, block,
                            nb, chunks, inv_n, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  approx_decode_final_kernel<<<1, kThreads, 0, st>>>(part, part + chunks, sums,
                                                     chunks);
  return (int)cudaGetLastError();
}

}  // extern "C"
