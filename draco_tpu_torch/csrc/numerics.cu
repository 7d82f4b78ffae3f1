// The numerics observatory's statistics and the ingest check, by hand for
// Hopper (sm_90a). Plain C interface, loaded with ctypes by
// draco_tpu_torch/ops/numerics.py; every launch goes on the caller's
// stream and the function returns cudaGetLastError().
//
// Replaces the XLA fusions of draco_tpu/obs/numerics.py _part_counts and
// stage_columns (:412-476) and of draco_tpu/obs/forensics.py
// nonfinite_rows (:161-177); neither has a Pallas kernel there.
//
// stage_stats: one or two f32 parts of (rows, d), d the last axis, give
// the twelve nx_<stage>_* columns in obs/numerics.STAT_NAMES order:
//
//   absmax     max |x| over the finite elements (0 when none)
//   rms        sqrt(Σ x² over the finite elements / max(n_finite, 1))
//   uf_bf16    nonzero finite |x| < 2^-133 (bits < 0x00010000), over all
//   uf_int8    nonzero finite |x| < block_absmax / 254, over all; blocks of
//              `block` elements along each row, restarting at each row
//   of_bf16    finite |x| > 0x7F7F0000 (bfloat16's largest), over all
//   nonfinite  (total − n_finite) / total
//   exp0..5    nonzero finite elements by floor(log2 |x|) in the bins
//              (-inf,-32) [-32,-16) [-16,-8) [-8,0) [0,8) [8,inf), over all
//
// floor(log2 |x|) is read off the exponent bits — counted as the
// elements below each edge, the bins their differences — not computed as a
// rounded log2 (a subnormal lies below every edge: bin 0); the block
// threshold is an IEEE f32 division; nothing here is compiled with
// --use_fast_math or -ftz=true, so subnormals are counted as subnormals.
//
// Design: a group of threads — a warp for blocks of up to 4096 elements,
// the whole CTA beyond — takes one (row, block) at a time, grid-stride.
// Its first pass reads the block once (coalesced, each lane a stride of
// the group, the first 8 strides' loads issued together), folds every
// statistic but uf_int8 into the thread's registers (the exponent bins by
// a compare each: an indexed counter would live in local memory) and
// keeps up to 8 values a lane in registers; a group max
// gives the block's absmax, and the second pass counts uf_int8 from the
// registers (a block of up to 256 elements for a warp, 2048 for a CTA: one
// read of the data) or rereads the block from the cache. At the end each
// CTA folds its threads: the integer counts go to 64-bit atomics and the
// absmax to an atomicMax on the bits of a non-negative float (both exact
// in any order), and Σ x² — each element's x·x rounded to f32 as the
// plain version rounds it, summed in f64 — to a per-CTA partial. A second
// launch of one warp sums the partials in a fixed order and finishes the
// columns in f32, so the result is the same bits from launch to launch
// and from a graph replay; no float atomics anywhere.
//
// nonfinite_rows: (n, L) f32 rows -> (n,) bytes, 1 where a row holds an
// Inf or NaN. A grid over (column tiles, rows), each thread testing the
// exponent bits of its row's 16-byte chunks (the elements before the
// row's first 16-byte boundary and after its last whole chunk one at a
// time), __syncthreads_or, and one store of 1 a tile that saw one, into
// the output the launcher zeroes first.
//
// What bounds them on an H100: each reads every element once — stage_stats
// 4·rows·d bytes a part, nonfinite_rows 4·n·L — at 3.35 TB/s; the
// integer and f64 work an element (about 30 operations) is far under the
// integer rate at these sizes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "audit.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCache = 8;  // values a lane keeps for the second pass
constexpr int kWarpBlockMax = 4096;  // blocks above this take a whole CTA
// n_finite, uf_bf16, of_bf16, uf_int8, the nonzero finite count, and
// those below each exponent edge (the finishing warp turns the last six
// into the histogram's bins)
constexpr int kCounts = 10;
// grid-stride cap: two waves of 8 CTAs a SM
constexpr int kMaxBlocks = 132 * 8 * 2;

constexpr uint32_t kAbsMask = 0x7FFFFFFFu;
constexpr uint32_t kExpMask = 0x7F800000u;
constexpr uint32_t kTinyBits = 0x00010000u;  // 2^-133
constexpr uint32_t kBf16MaxBits = 0x7F7F0000u;


struct Acc {
  uint32_t c[kCounts];
  double sumsq;
  float absmax;

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kCounts; ++i) c[i] = 0u;
    sumsq = 0.0;
    absmax = 0.0f;
  }

  // every statistic but uf_int8; returns the finite-masked |x|
  __device__ __forceinline__ float add(float x) {
    const uint32_t a = __float_as_uint(x) & kAbsMask;
    if (a >= kExpMask) return 0.0f;  // Inf or NaN
    c[0] += 1u;
    const float af = __uint_as_float(a);
    sumsq += (double)__fmul_rn(x, x);
    absmax = fmaxf(absmax, af);
    if (a == 0u) return 0.0f;
    c[1] += a < kTinyBits ? 1u : 0u;
    c[2] += a > kBf16MaxBits ? 1u : 0u;
    c[4] += 1u;
    // floor(log2 |x|) < k for k in EXP_EDGES, a compare an edge on the
    // exponent field: ef < k + 127 (a subnormal, ef = 0, lies below every
    // edge; an indexed c[bin] would put the counters in local memory)
    const uint32_t ef = a >> 23;
    const uint32_t edge[5] = {127u - 32u, 127u - 16u, 127u - 8u, 127u,
                              127u + 8u};
#pragma unroll
    for (int i = 0; i < 5; ++i) c[5 + i] += ef < edge[i] ? 1u : 0u;
    return af;
  }
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the max over the group: the warp, or (kGroup == kThreads) the CTA
template <int kGroup>
__device__ __forceinline__ float group_max(float v, float* red) {
  v = warp_max(v);
  if (kGroup == 32) return v;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red is free: the last round's readers are done
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
  return m;
}

// parts: up to two (rows, d) f32 buffers, blockIdx.y the part;
// counts: kCounts u64, zeroed; absmax: u32 bits, zeroed; partials:
// gridDim.y · gridDim.x f64
template <int kGroup>
__global__ void __launch_bounds__(kThreads)
    stage_stats_kernel(const float* __restrict__ p0,
                       const float* __restrict__ p1, long long rows,
                       long long d, long long block,
                       unsigned long long* __restrict__ counts,
                       uint32_t* __restrict__ absmax_bits,
                       double* __restrict__ partials) {
  const float* __restrict__ p = blockIdx.y ? p1 : p0;
  __shared__ float red[kWarps];
  __shared__ uint32_t csum[kCounts][kWarps];
  __shared__ double ssum[kWarps];
  __shared__ float msum[kWarps];
  constexpr int kPerCta = kThreads / kGroup;
  const int rank = threadIdx.x % kGroup;
  const long long group =
      (long long)blockIdx.x * kPerCta + threadIdx.x / kGroup;
  const long long groups = (long long)gridDim.x * kPerCta;
  const long long nb = (d + block - 1) / block;
  const long long total = rows * nb;
  Acc acc;
  acc.zero();
  for (long long bi = group; bi < total; bi += groups) {
    const long long r = bi / nb, b = bi - r * nb;
    const long long lo = b * block;
    const long long len = (d - lo < block) ? d - lo : block;
    const float* __restrict__ q = p + r * d + lo;
    // every load of the group's first kCache strides issued before any
    // is used: the loads are in flight together, not one at a time
    float keep[kCache];
#pragma unroll
    for (int k = 0; k < kCache; ++k) {
      const long long i = rank + (long long)k * kGroup;
      keep[k] = i < len ? __ldg(q + i) : 0.0f;
    }
    float bmax = 0.0f;
#pragma unroll
    for (int k = 0; k < kCache; ++k) {
      const long long i = rank + (long long)k * kGroup;
      keep[k] = i < len ? acc.add(keep[k]) : 0.0f;
      bmax = fmaxf(bmax, keep[k]);
    }
    for (long long i = rank + (long long)kCache * kGroup; i < len;
         i += kGroup)
      bmax = fmaxf(bmax, acc.add(__ldg(q + i)));
    bmax = group_max<kGroup>(bmax, red);
    const float thr = bmax / 254.0f;  // IEEE division
    uint32_t uf = 0u;
#pragma unroll
    for (int k = 0; k < kCache; ++k)
      uf += (keep[k] > 0.0f && keep[k] < thr) ? 1u : 0u;
    for (long long i = rank + (long long)kCache * kGroup; i < len;
         i += kGroup) {
      const uint32_t a = __float_as_uint(__ldg(q + i)) & kAbsMask;
      const float af = __uint_as_float(a);
      uf += (a != 0u && a < kExpMask && af < thr) ? 1u : 0u;
    }
    acc.c[3] += uf;
  }
  // fold the CTA: counts and absmax by atomics, Σ x² in a fixed order
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kCounts; ++i) {
    const uint32_t v = warp_sum(acc.c[i]);
    if (lane == 0) csum[i][warp] = v;
  }
  const double s = warp_sum(acc.sumsq);
  const float m = warp_max(acc.absmax);
  if (lane == 0) {
    ssum[warp] = s;
    msum[warp] = m;
  }
  __syncthreads();
  if (threadIdx.x < kCounts) {
    unsigned long long t = 0ull;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += csum[threadIdx.x][w];
    if (t) atomicAdd(counts + threadIdx.x, t);
  }
  if (threadIdx.x == 0) {
    double t = 0.0;
    float mm = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      t += ssum[w];
      mm = fmaxf(mm, msum[w]);
    }
    partials[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = t;
    atomicMax(absmax_bits, __float_as_uint(mm));
  }
}

// one warp: Σ of the partials in a fixed order, then the columns in f32
__global__ void __launch_bounds__(32)
    stage_finish_kernel(const unsigned long long* __restrict__ counts,
                        const uint32_t* __restrict__ absmax_bits,
                        const double* __restrict__ partials, int npartials,
                        float total, float* __restrict__ out) {
  double s = 0.0;
  for (int i = threadIdx.x; i < npartials; i += 32) s += partials[i];
  s = warp_sum(s);
  if (threadIdx.x != 0) return;
  const float denom = fmaxf(total, 1.0f);
  const float nfin = (float)counts[0];
  out[0] = __uint_as_float(*absmax_bits);
  out[1] = sqrtf((float)s / fmaxf(nfin, 1.0f));
  out[2] = (float)counts[1] / denom;  // uf_bf16
  out[3] = (float)counts[3] / denom;  // uf_int8
  out[4] = (float)counts[2] / denom;  // of_bf16
  out[5] = (total - nfin) / denom;    // nonfinite
  // the bins from the counts below each edge: bin i = lt_i − lt_{i−1},
  // the last the nonzero count − lt_4
  unsigned long long below = 0ull;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const unsigned long long lt = i < 5 ? counts[5 + i] : counts[4];
    out[6 + i] = (float)(lt - below) / denom;
    below = lt;
  }
}

__device__ __forceinline__ bool word_nonfinite(uint32_t w) {
  return (w & kExpMask) == kExpMask;
}

// rows: n rows of L f32, row-major; out: n bytes, zeroed
__global__ void __launch_bounds__(kThreads)
    nonfinite_rows_kernel(const float* __restrict__ rows,
                          unsigned char* __restrict__ out, long long L) {
  const int row = blockIdx.y;
  const float* base = rows + (size_t)row * (size_t)L;
  long long head = (long long)((16 - ((uintptr_t)base & 15)) & 15) / 4;
  if (head > L) head = L;
  const long long nvec = (L - head) / 4;
  const long long tail0 = head + nvec * 4;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  const uint4* vec = reinterpret_cast<const uint4*>(base + head);
  bool bad = false;
  for (long long v = tid; v < nvec; v += nthreads) {
    const uint4 w = __ldg(vec + v);
    bad |= word_nonfinite(w.x) | word_nonfinite(w.y) | word_nonfinite(w.z) |
           word_nonfinite(w.w);
  }
  const long long nscalar = head + (L - tail0);
  for (long long t = tid; t < nscalar; t += nthreads) {
    const long long j = t < head ? t : tail0 + (t - head);
    bad |= word_nonfinite(__float_as_uint(__ldg(base + j)));
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) out[row] = 1;
}

inline int stage_grid(long long rows, long long d, long long block) {
  const long long nb = (d + block - 1) / block;
  const long long per = block > kWarpBlockMax ? 1 : kWarps;
  long long b = (rows * nb + per - 1) / per;
  if (b < 1) b = 1;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return (int)b;
}

inline int nonfinite_tiles(int n, long long L) {
  long long work = (L + 3) / 4;
  if (work < 1) work = 1;
  long long b = (work + kThreads - 1) / kThreads;
  long long cap = kMaxBlocks / (n > 0 ? n : 1);
  if (cap < 1) cap = 1;
  if (b > cap) b = cap;
  return (int)b;
}

const draco_audit::Entry kAudit[] = {
    {"stage_stats_kernel<32>", (const void*)stage_stats_kernel<32>, kThreads,
     nullptr, 0},
    {"stage_stats_kernel<256>", (const void*)stage_stats_kernel<256>,
     kThreads, nullptr, 0},
    {"stage_finish_kernel", (const void*)stage_finish_kernel, 32, nullptr, 0},
    {"nonfinite_rows_kernel", (const void*)nonfinite_rows_kernel, kThreads,
     nullptr, 0},
};

}  // namespace

DRACO_AUDIT_EXPORTS(kAudit)

extern "C" {

// CTAs a part of (rows, d) at `block` takes: the partials' count a part
int draco_stage_grid(long long rows, long long d, long long block) {
  return stage_grid(rows, d, block);
}

// p0, p1: parts (p1 null for one part) of (rows, d) f32; work: kCounts u64,
// one u32 (padded to 8 bytes), then parts · grid f64 (draco_stage_grid);
// out: the 12 columns, f32. total: the elements of all parts, as the f32 the
// columns divide by.
int draco_stage_stats(const void* p0, const void* p1, long long rows,
                      long long d, long long block, void* work, void* out,
                      float total, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (block < 1 || rows < 0 || d < 0) return (int)cudaErrorInvalidValue;
  unsigned long long* counts = (unsigned long long*)work;
  uint32_t* absmax = (uint32_t*)(counts + kCounts);
  double* partials = (double*)(counts + kCounts + 1);
  cudaError_t err = cudaMemsetAsync(
      work, 0, (kCounts + 1) * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  const int parts = p1 ? 2 : 1;
  const int g = stage_grid(rows, d, block);
  dim3 grid(g, parts);
  const float* a = (const float*)p0;
  const float* b = (const float*)p1;
  if (rows > 0 && d > 0) {
    if (block > kWarpBlockMax)
      stage_stats_kernel<kThreads><<<grid, kThreads, 0, st>>>(
          a, b, rows, d, block, counts, absmax, partials);
    else
      stage_stats_kernel<32><<<grid, kThreads, 0, st>>>(
          a, b, rows, d, block, counts, absmax, partials);
  } else {
    err = cudaMemsetAsync(partials, 0, (size_t)parts * g * sizeof(double),
                          st);
    if (err != cudaSuccess) return (int)err;
  }
  stage_finish_kernel<<<1, 32, 0, st>>>(counts, absmax, partials, parts * g,
                                        total, (float*)out);
  return (int)cudaGetLastError();
}

// rows (n, L) f32; out: n bytes, zeroed here on the stream, then set
int draco_nonfinite_rows(const void* rows, void* out, int n, long long L,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)n, st);
  if (err != cudaSuccess) return (int)err;
  if (n < 1 || L < 1) return (int)cudaGetLastError();
  dim3 grid(nonfinite_tiles(n, L), n);
  nonfinite_rows_kernel<<<grid, kThreads, 0, st>>>(
      (const float*)rows, (unsigned char*)out, L);
  return (int)cudaGetLastError();
}

}  // extern "C"
