// Blockwise flash attention — forward, dq and dk/dv — by hand for Hopper
// (sm_90a). Plain C interface, loaded with ctypes by
// draco_tpu_torch/ops/flash_attention.py; each entry point launches on the
// caller's stream and returns cudaGetLastError().
//
// Replaces the Pallas TPU kernels of draco_tpu/ops/flash_attention.py:
//   draco_flash_fwd  _fwd_kernel / _flash_fwd     (pallas_call :174)
//   draco_flash_dq   _dq_kernel  / _flash_bwd dq  (pallas_call :328)
//   draco_flash_dkv  _dkv_kernel / _flash_bwd dkv (pallas_call :353)
// They compute what those kernels compute, on G = B·H folded heads of
// (G, T, Dh) float32 rows, without their TPU padding (Dh stays as it is,
// the row statistics are (G, T)):
//   forward  o = softmax(q kᵀ·scale, causal) v with the online-softmax
//            accumulators m, l, acc; lse = m + log(l), l clamped at 1e-30;
//            masked scores are NEG_INF = -1e30
//   dq       dq = Σ_j p_ij (dp_ij − D_i + dlse_i) k_j · scale
//   dk/dv    dv_j = Σ_i p_ij do_i,  dk_j = Σ_i p_ij (dp_ij − D_i + dlse_i) q_i
//            · scale
// with p recomputed from lse (p = exp(s − lse)), dp = do·vᵀ, D = rowsum(do∘o)
// (computed by the caller, as the JAX package does outside Pallas) and the
// optional lse cotangent dlse (null when the lse output is unused).
// Causality compares positions (q_pos >= k_pos), so it holds for any block
// sizes; keys and queries at or past T (the ragged last block) are masked.
//
// What bounds it on an H100: at the LM path's T = 512, Dh = 64 the causal
// work is ~2·G·T²·Dh flops forward and ~2.5× that backward, against ~4·G·T·Dh
// floats moved per pass: operations, by ~30× over bytes at the float32 rate
// outside the tensor cores (67 TFLOP/s). The design keeps every operand of
// that work on chip: one thread block per (head, 64-row block) streams the
// other side's 64-row tiles through shared memory and never forms the
// (T, T) matrix in device memory. It computes in float32 FMA on the CUDA
// cores; wgmma, TMA and tensor-core precision are for a later speed PR.
//
// Design: a head row is owned by TPR = DHP/16 adjacent threads, each holding
// 16 of its (zero-padded to DHP) head-dim entries in registers, as four
// float4 chunks interleaved by thread (chunk c of thread h is float4 index
// c·TPR + h), so the TPR threads reading one shared-memory row hit distinct
// banks. Dot products reduce over the TPR threads with xor shuffles, which
// leave the identical sum in each of them. The forward folds 16 keys at a
// time into m, l, acc; dq walks the key tiles of its query block, dk/dv the
// query tiles of its key block, each skipping the tiles causality masks.
// Blocks with the most causal work are scheduled first.

#include <cuda_runtime.h>
#include <math.h>

#include "audit.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kDpt = 16;  // head-dim entries per thread
constexpr int kChunks = kDpt / 4;
constexpr int kKeyChunk = 16;  // keys folded into the softmax at a time

template <int DHP>
struct Cfg {
  static constexpr int TPR = DHP / kDpt;  // threads per head row
  static constexpr int ROWS = DHP <= 64 ? 64 : 32;  // rows per block/tile
  static constexpr int THREADS = ROWS * TPR;
};

template <int TPR>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// this thread's 16 entries of one row of a (T, dh) matrix, zero past dh
template <int DHP>
__device__ __forceinline__ void load_own(const float* row, int dh, bool valid,
                                         int h, float* r) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * (c * Cfg<DHP>::TPR + h) + e;
      r[4 * c + e] = (valid && d < dh) ? row[d] : 0.f;
    }
  }
}

template <int DHP>
__device__ __forceinline__ void store_own(float* row, int dh, int h,
                                          const float* r, float mul) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * (c * Cfg<DHP>::TPR + h) + e;
      if (d < dh) row[d] = r[4 * c + e] * mul;
    }
  }
}

// rows [row0, row0 + ROWS) of a (T, dh) matrix into a zero-padded tile
template <int DHP>
__device__ __forceinline__ void load_tile(float (*tile)[DHP], const float* m,
                                          int row0, int T, int dh) {
  using C = Cfg<DHP>;
  for (int e = threadIdx.x; e < C::ROWS * DHP; e += C::THREADS) {
    const int r = e / DHP, d = e % DHP, gr = row0 + r;
    tile[r][d] = (gr < T && d < dh) ? m[(long long)gr * dh + d] : 0.f;
  }
}

template <int DHP>
__device__ __forceinline__ float dot_own(const float* r, const float* trow,
                                         int h) {
  const float4* t4 = reinterpret_cast<const float4*>(trow);
  float a = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const float4 t = t4[c * Cfg<DHP>::TPR + h];
    a += r[4 * c] * t.x + r[4 * c + 1] * t.y + r[4 * c + 2] * t.z +
         r[4 * c + 3] * t.w;
  }
  return a;
}

template <int DHP>
__device__ __forceinline__ void axpy_own(float* acc, float p,
                                         const float* trow, int h) {
  const float4* t4 = reinterpret_cast<const float4*>(trow);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const float4 t = t4[c * Cfg<DHP>::TPR + h];
    acc[4 * c] += p * t.x;
    acc[4 * c + 1] += p * t.y;
    acc[4 * c + 2] += p * t.z;
    acc[4 * c + 3] += p * t.w;
  }
}

// ---------------------------------------------------------------------------
// forward: one block per (g, query block); grid = nblk · G, heaviest first
// ---------------------------------------------------------------------------

template <int DHP>
__global__ void __launch_bounds__(Cfg<DHP>::THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int G, int T, int dh, float scale,
                 int causal) {
  using C = Cfg<DHP>;
  __shared__ __align__(16) float ks[C::ROWS][DHP];
  __shared__ __align__(16) float vs[C::ROWS][DHP];
  const int nblk = (T + C::ROWS - 1) / C::ROWS;
  const int qb = nblk - 1 - (int)(blockIdx.x / G);
  const long long g = blockIdx.x % G;
  const int row = threadIdx.x / C::TPR, h = threadIdx.x % C::TPR;
  const int qi = qb * C::ROWS + row;
  const bool qvalid = qi < T;
  const long long base = g * T * dh;
  const int q_last = min(qb * C::ROWS + C::ROWS - 1, T - 1);

  float qr[kDpt], acc[kDpt];
  load_own<DHP>(q + base + (long long)qi * dh, dh, qvalid, h, qr);
#pragma unroll
  for (int d = 0; d < kDpt; ++d) acc[d] = 0.f;
  float m = kNegInf, l = 0.f;

  const int ntiles = causal ? q_last / C::ROWS + 1 : nblk;
  for (int kt = 0; kt < ntiles; ++kt) {
    __syncthreads();
    load_tile<DHP>(ks, k + base, kt * C::ROWS, T, dh);
    load_tile<DHP>(vs, v + base, kt * C::ROWS, T, dh);
    __syncthreads();
    for (int c0 = 0; c0 < C::ROWS; c0 += kKeyChunk) {
      const int k0 = kt * C::ROWS + c0;
      if (k0 >= T || (causal && k0 > q_last)) break;  // uniform in the block
      float s[kKeyChunk];
      float mx = kNegInf;
#pragma unroll
      for (int cc = 0; cc < kKeyChunk; ++cc) {
        const float a = group_sum<C::TPR>(dot_own<DHP>(qr, ks[c0 + cc], h));
        const int kp = k0 + cc;
        const bool ok = kp < T && (!causal || qi >= kp);
        s[cc] = ok ? a * scale : kNegInf;
        mx = fmaxf(mx, s[cc]);
      }
      const float m_new = fmaxf(m, mx);
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int d = 0; d < kDpt; ++d) acc[d] *= corr;
#pragma unroll
      for (int cc = 0; cc < kKeyChunk; ++cc) {
        const float p = expf(s[cc] - m_new);
        l += p;
        axpy_own<DHP>(acc, p, vs[c0 + cc], h);
      }
      m = m_new;
    }
  }
  if (qvalid) {
    const float lc = fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < kDpt; ++d) acc[d] = acc[d] / lc;
    store_own<DHP>(o + base + (long long)qi * dh, dh, h, acc, 1.f);
    if (h == 0) lse[g * T + qi] = m + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// dq: one block per (g, query block), walking the key tiles
// ---------------------------------------------------------------------------

template <int DHP>
__global__ void __launch_bounds__(Cfg<DHP>::THREADS)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ dcap,
                const float* __restrict__ dlse, float* __restrict__ dq,
                int G, int T, int dh, float scale, int causal) {
  using C = Cfg<DHP>;
  __shared__ __align__(16) float ks[C::ROWS][DHP];
  __shared__ __align__(16) float vs[C::ROWS][DHP];
  const int nblk = (T + C::ROWS - 1) / C::ROWS;
  const int qb = nblk - 1 - (int)(blockIdx.x / G);
  const long long g = blockIdx.x % G;
  const int row = threadIdx.x / C::TPR, h = threadIdx.x % C::TPR;
  const int qi = qb * C::ROWS + row;
  const bool qvalid = qi < T;
  const long long base = g * T * dh;
  const int q_last = min(qb * C::ROWS + C::ROWS - 1, T - 1);

  float qr[kDpt], dor[kDpt], acc[kDpt];
  load_own<DHP>(q + base + (long long)qi * dh, dh, qvalid, h, qr);
  load_own<DHP>(dout + base + (long long)qi * dh, dh, qvalid, h, dor);
#pragma unroll
  for (int d = 0; d < kDpt; ++d) acc[d] = 0.f;
  const float L = qvalid ? lse[g * T + qi] : 0.f;
  const float Dc = qvalid ? dcap[g * T + qi] : 0.f;
  const float Dl = (qvalid && dlse) ? dlse[g * T + qi] : 0.f;

  const int ntiles = causal ? q_last / C::ROWS + 1 : nblk;
  for (int kt = 0; kt < ntiles; ++kt) {
    __syncthreads();
    load_tile<DHP>(ks, k + base, kt * C::ROWS, T, dh);
    load_tile<DHP>(vs, v + base, kt * C::ROWS, T, dh);
    __syncthreads();
    int nc = min(C::ROWS, T - kt * C::ROWS);
    if (causal) nc = min(nc, q_last - kt * C::ROWS + 1);
    for (int c = 0; c < nc; ++c) {
      const float s = group_sum<C::TPR>(dot_own<DHP>(qr, ks[c], h)) * scale;
      const bool ok = !causal || qi >= kt * C::ROWS + c;
      const float p = ok ? expf(s - L) : 0.f;
      const float dp = group_sum<C::TPR>(dot_own<DHP>(dor, vs[c], h));
      float dsum = dp - Dc;
      if (dlse) dsum += Dl;
      axpy_own<DHP>(acc, p * dsum, ks[c], h);
    }
  }
  if (qvalid) store_own<DHP>(dq + base + (long long)qi * dh, dh, h, acc, scale);
}

// ---------------------------------------------------------------------------
// dk/dv: one block per (g, key block), walking the query tiles
// ---------------------------------------------------------------------------

template <int DHP>
__global__ void __launch_bounds__(Cfg<DHP>::THREADS)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ dcap,
                 const float* __restrict__ dlse, float* __restrict__ dk,
                 float* __restrict__ dv, int G, int T, int dh, float scale,
                 int causal) {
  using C = Cfg<DHP>;
  __shared__ __align__(16) float qs[C::ROWS][DHP];
  __shared__ __align__(16) float ds[C::ROWS][DHP];
  __shared__ float ls[C::ROWS], dcs[C::ROWS], dls[C::ROWS];
  const int nblk = (T + C::ROWS - 1) / C::ROWS;
  const int kb = (int)(blockIdx.x / G);  // the first key blocks see most
  const long long g = blockIdx.x % G;
  const int row = threadIdx.x / C::TPR, h = threadIdx.x % C::TPR;
  const int kj = kb * C::ROWS + row;
  const bool kvalid = kj < T;
  const long long base = g * T * dh;

  float kr[kDpt], vr[kDpt], dka[kDpt], dva[kDpt];
  load_own<DHP>(k + base + (long long)kj * dh, dh, kvalid, h, kr);
  load_own<DHP>(v + base + (long long)kj * dh, dh, kvalid, h, vr);
#pragma unroll
  for (int d = 0; d < kDpt; ++d) dka[d] = dva[d] = 0.f;

  // the first query tile holding a query at or after this block's keys
  for (int qt = causal ? kb : 0; qt < nblk; ++qt) {
    const int q0 = qt * C::ROWS;
    __syncthreads();
    load_tile<DHP>(qs, q + base, q0, T, dh);
    load_tile<DHP>(ds, dout + base, q0, T, dh);
    for (int r = threadIdx.x; r < C::ROWS; r += C::THREADS) {
      const bool ok = q0 + r < T;
      ls[r] = ok ? lse[g * T + q0 + r] : 0.f;
      dcs[r] = ok ? dcap[g * T + q0 + r] : 0.f;
      dls[r] = (ok && dlse) ? dlse[g * T + q0 + r] : 0.f;
    }
    __syncthreads();
    const int nr = min(C::ROWS, T - q0);
    for (int r = 0; r < nr; ++r) {
      const float s = group_sum<C::TPR>(dot_own<DHP>(kr, qs[r], h)) * scale;
      const bool ok = !causal || q0 + r >= kj;
      const float p = ok ? expf(s - ls[r]) : 0.f;
      axpy_own<DHP>(dva, p, ds[r], h);
      const float dp = group_sum<C::TPR>(dot_own<DHP>(vr, ds[r], h));
      float dsum = dp - dcs[r];
      if (dlse) dsum += dls[r];
      axpy_own<DHP>(dka, p * dsum, qs[r], h);
    }
  }
  if (kvalid) {
    store_own<DHP>(dk + base + (long long)kj * dh, dh, h, dka, scale);
    store_own<DHP>(dv + base + (long long)kj * dh, dh, h, dva, 1.f);
  }
}

// the padded head width a kernel instance takes: 16, 32, 64 or 128
int padded_dh(int dh) {
  if (dh < 1) return 0;
  if (dh <= 16) return 16;
  if (dh <= 32) return 32;
  if (dh <= 64) return 64;
  if (dh <= 128) return 128;
  return 0;
}

template <int DHP>
unsigned grid_of(int G, int T) {
  return (unsigned)(((T + Cfg<DHP>::ROWS - 1) / Cfg<DHP>::ROWS) * (long long)G);
}

bool bad_shape(int G, int T, int dh) {
  if (G < 1 || T < 1 || padded_dh(dh) == 0) return true;
  // one block per (head, row block) in a one-dimensional grid
  return (long long)G * ((T + 31) / 32) > 2147483647LL;
}

// every instance the launchers can pick (Dh padded to 16, 32, 64, 128);
// their tiles are static shared memory
const draco_audit::Entry kAudit[] = {
    {"flash_fwd_kernel<16>", (const void*)flash_fwd_kernel<16>,
     Cfg<16>::THREADS, nullptr, 0},
    {"flash_fwd_kernel<32>", (const void*)flash_fwd_kernel<32>,
     Cfg<32>::THREADS, nullptr, 0},
    {"flash_fwd_kernel<64>", (const void*)flash_fwd_kernel<64>,
     Cfg<64>::THREADS, nullptr, 0},
    {"flash_fwd_kernel<128>", (const void*)flash_fwd_kernel<128>,
     Cfg<128>::THREADS, nullptr, 0},
    {"flash_dq_kernel<16>", (const void*)flash_dq_kernel<16>,
     Cfg<16>::THREADS, nullptr, 0},
    {"flash_dq_kernel<32>", (const void*)flash_dq_kernel<32>,
     Cfg<32>::THREADS, nullptr, 0},
    {"flash_dq_kernel<64>", (const void*)flash_dq_kernel<64>,
     Cfg<64>::THREADS, nullptr, 0},
    {"flash_dq_kernel<128>", (const void*)flash_dq_kernel<128>,
     Cfg<128>::THREADS, nullptr, 0},
    {"flash_dkv_kernel<16>", (const void*)flash_dkv_kernel<16>,
     Cfg<16>::THREADS, nullptr, 0},
    {"flash_dkv_kernel<32>", (const void*)flash_dkv_kernel<32>,
     Cfg<32>::THREADS, nullptr, 0},
    {"flash_dkv_kernel<64>", (const void*)flash_dkv_kernel<64>,
     Cfg<64>::THREADS, nullptr, 0},
    {"flash_dkv_kernel<128>", (const void*)flash_dkv_kernel<128>,
     Cfg<128>::THREADS, nullptr, 0},
};

}  // namespace

DRACO_AUDIT_EXPORTS(kAudit)

extern "C" {

int draco_flash_fwd(const float* q, const float* k, const float* v, float* o,
                    float* lse, int G, int T, int dh, float scale, int causal,
                    void* stream) {
  if (bad_shape(G, T, dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (padded_dh(dh)) {
#define DRACO_FWD(D)                                                        \
  case D:                                                                   \
    flash_fwd_kernel<D><<<grid_of<D>(G, T), Cfg<D>::THREADS, 0, st>>>(      \
        q, k, v, o, lse, G, T, dh, scale, causal);                          \
    break;
    DRACO_FWD(16) DRACO_FWD(32) DRACO_FWD(64) DRACO_FWD(128)
#undef DRACO_FWD
  }
  return (int)cudaGetLastError();
}

int draco_flash_dq(const float* q, const float* k, const float* v,
                   const float* dout, const float* lse, const float* dcap,
                   const float* dlse, float* dq, int G, int T, int dh,
                   float scale, int causal, void* stream) {
  if (bad_shape(G, T, dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (padded_dh(dh)) {
#define DRACO_DQ(D)                                                         \
  case D:                                                                   \
    flash_dq_kernel<D><<<grid_of<D>(G, T), Cfg<D>::THREADS, 0, st>>>(       \
        q, k, v, dout, lse, dcap, dlse, dq, G, T, dh, scale, causal);       \
    break;
    DRACO_DQ(16) DRACO_DQ(32) DRACO_DQ(64) DRACO_DQ(128)
#undef DRACO_DQ
  }
  return (int)cudaGetLastError();
}

int draco_flash_dkv(const float* q, const float* k, const float* v,
                    const float* dout, const float* lse, const float* dcap,
                    const float* dlse, float* dk, float* dv, int G, int T,
                    int dh, float scale, int causal, void* stream) {
  if (bad_shape(G, T, dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (padded_dh(dh)) {
#define DRACO_DKV(D)                                                        \
  case D:                                                                   \
    flash_dkv_kernel<D><<<grid_of<D>(G, T), Cfg<D>::THREADS, 0, st>>>(      \
        q, k, v, dout, lse, dcap, dlse, dk, dv, G, T, dh, scale, causal);   \
    break;
    DRACO_DKV(16) DRACO_DKV(32) DRACO_DKV(64) DRACO_DKV(128)
#undef DRACO_DKV
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
