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
// work is ~2·G·T²·Dh flops forward and ~3.5× that backward, against ~4·G·T·Dh
// floats moved per pass: operations, by ~30× over bytes. No kernel forms the
// (T, T) matrix in device memory: one thread block per (head, 64-row block)
// streams the other side's tiles through shared memory.
//
// All three run every product on the tensor cores in split TF32, so their
// bound is the operations at 495/3 = 165 TFLOP/s. mma.sync m16n8k8 takes TF32
// operands (10 mantissa bits, ~5e-4 relative), too coarse for the float32
// results the callers hold them to; each operand x is split once, as its
// fragment is loaded, into big = rna_tf32(x) and small = x − big, and
// a·b ≈ a_small·b_big + a_big·b_small + a_big·b_big (big·big last) keeps
// ~2^-21 relative, three mma a product. Each product is summed from zero
// over at most 32 positions (or 16 head-dim entries) and then added to a
// float32 total: the tensor core's own accumulation truncates (see add4).
// Not wgmma: its TF32 form takes only K-major operands (the contraction
// axis contiguous in shared memory), and four of the nine products (P·V,
// dS·K, Pᵀ·dO, dSᵀ·Q) contract over the sequence axis of row-major tiles,
// which would take a transposed copy of each tile first.
//
// Each block has 4 warps of 16 rows and streams the other side in 32-row
// tiles: the forward and dq sweep the key tiles of their 64 query rows (the
// forward S = Q·Kᵀ, then acc = acc·exp2(m_old − m_new) + P·V with the
// online softmax in base 2; dq S = Q·Kᵀ, dP = dO·Vᵀ, then dQ += dS·K), dk/dv
// the query tiles of its 64 key rows (Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ, dV += Pᵀ·dO,
// dK += dSᵀ·Q). P and dS never leave registers: the m16n8 accumulator
// becomes the next product's A operand by permuting the contraction index
// within each 8-wide step (A column t ↔ position 2t, column t+4 ↔ 2t+1), and
// the B operand is read from shared memory in the same order. Tiles arrive
// by cp.async, double-buffered, in rows padded by 4 floats, so every
// fragment load is free of bank conflicts. A warp skips a tile it needs
// nothing of and masks the rest, so the tile's code has no branches. There
// are no atomics and no cross-block sums (the forward adds a row's four
// lane shares of l once, in a fixed order): a head's result does not depend
// on its place in G or on launch order, so redundant lanes folded into G
// agree bit for bit. Blocks with the most causal work run first.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "audit.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kRows = 64;  // rows a block owns: 4 warps of 16
constexpr int kThreads = 128;
constexpr int kCols = 32;  // rows of a streamed tile
constexpr int kStat = 3 * kCols;  // lse, D, dlse of a streamed query tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int DHP>
struct Tile {
  static constexpr int SD = DHP + 4;  // padded row stride of a shared tile
  static constexpr int KS = DHP / 8;  // 8-wide steps over the head dim
  static constexpr int OWN = kRows * SD;  // floats of the block's rows
  static constexpr int STREAM = kCols * SD;  // floats of a streamed tile
  // streamed rows a pass: at Dh 128, 16, to keep the totals in registers
  static constexpr int NC = DHP <= 64 ? kCols : 16;
};

// dynamic shared memory of one block: the forward holds Q and two stages of
// (K, V); dq holds Q, dO and two stages of (K, V); dk/dv holds K, V, two
// stages of (Q, dO) and of the query rows' (lse, D, dlse)
template <int DHP>
size_t fwd_smem(long long, long long) {
  return sizeof(float) * (Tile<DHP>::OWN + 4 * Tile<DHP>::STREAM);
}

template <int DHP>
size_t dq_smem(long long, long long) {
  return sizeof(float) * (2 * Tile<DHP>::OWN + 4 * Tile<DHP>::STREAM);
}

template <int DHP>
size_t dkv_smem(long long, long long) {
  return sizeof(float) *
         (2 * Tile<DHP>::OWN + 4 * Tile<DHP>::STREAM + 2 * kStat);
}

// ---------------------------------------------------------------------------
// split TF32 on the tensor cores (mma.sync m16n8k8), for all three kernels
// ---------------------------------------------------------------------------

// a float split into two TF32 halves, x ≈ big + small
struct Split2 {
  unsigned big[2], small[2];
};
struct Split4 {
  unsigned big[4], small[4];
};

// big = x rounded to TF32 as cvt.rna.tf32.f32 rounds (to nearest, ties away
// from zero), in two integer operations: cvt compiles to a longer
// compare-and-select sequence that made both kernels slower (measured on
// the card). small = x − big, exact, whose low 13 bits the tensor core
// ignores; a NaN stays NaN in small and so in the product.
__device__ __forceinline__ void split_tf32(float x, unsigned& big,
                                           unsigned& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a·b in split TF32: the cross terms first, big·big last
__device__ __forceinline__ void mma3(float (&c)[4], const Split4& a,
                                     const Split2& b) {
  mma_tf32(c, a.small, b.big);
  mma_tf32(c, a.big, b.small);
  mma_tf32(c, a.big, b.big);
}

// The tensor core truncates each sum to the precision of its largest
// addend, so a long sum kept in its accumulator drifts toward zero by up to
// an ulp of the total at every mma: over T = 520 keys that went past the
// 1e-5 tolerance (measured on the card). So every product below is summed
// from zero over a few 8-wide steps (at most 32 keys or 16 head-dim
// entries) and that partial added to a float32 total, rounded to nearest.
__device__ __forceinline__ void add4(float (&acc)[4], const float (&t)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += t[i];
}

// The m16n8k8 fragments, lane = 4·gr + tq: A (16×8) a0 (gr, tq), a1 (gr+8,
// tq), a2 (gr, tq+4), a3 (gr+8, tq+4); B (8×8) b0 (tq, gr), b1 (tq+4, gr);
// C (16×8) c0 (gr, 2tq), c1 (gr, 2tq+1), c2 (gr+8, 2tq), c3 (gr+8, 2tq+1).

// A = tile rows [r0, r0+16), columns [k0, k0+8)
template <int SD>
__device__ __forceinline__ Split4 frag_a(const float* tile, int r0, int k0,
                                         int gr, int tq) {
  const float* p = tile + (r0 + gr) * SD + k0 + tq;
  Split4 a;
  split_tf32(p[0], a.big[0], a.small[0]);
  split_tf32(p[8 * SD], a.big[1], a.small[1]);
  split_tf32(p[4], a.big[2], a.small[2]);
  split_tf32(p[8 * SD + 4], a.big[3], a.small[3]);
  return a;
}

// B = (tile rows [n0, n0+8), columns [k0, k0+8))ᵀ: contracts the head dim
template <int SD>
__device__ __forceinline__ Split2 frag_bt(const float* tile, int n0, int k0,
                                          int gr, int tq) {
  const float* p = tile + (n0 + gr) * SD + k0 + tq;
  Split2 b;
  split_tf32(p[0], b.big[0], b.small[0]);
  split_tf32(p[4], b.big[1], b.small[1]);
  return b;
}

// B = tile rows [k0, k0+8) in the permuted order (row k0+2tq for b0,
// k0+2tq+1 for b1), columns [n0, n0+8): contracts the sequence axis
template <int SD>
__device__ __forceinline__ Split2 frag_bp(const float* tile, int k0, int n0,
                                          int gr, int tq) {
  const float* p = tile + (k0 + 2 * tq) * SD + n0 + gr;
  Split2 b;
  split_tf32(p[0], b.big[0], b.small[0]);
  split_tf32(p[SD], b.big[1], b.small[1]);
  return b;
}

// an accumulator tile as the A operand, columns in the permuted order
__device__ __forceinline__ Split4 frag_acc(const float (&c)[4]) {
  Split4 a;
  split_tf32(c[0], a.big[0], a.small[0]);
  split_tf32(c[2], a.big[1], a.small[1]);
  split_tf32(c[1], a.big[2], a.small[2]);
  split_tf32(c[3], a.big[3], a.small[3]);
  return a;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// copy 16 (4) bytes to shared memory, or zero-fill them when !ok
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// all but the newest group of copies have landed
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// rows [row0, row0 + ROWS) of a (T, dh) matrix into a zero-padded shared
// tile, asynchronously; vec: dh % 4 == 0 and 16-byte aligned rows
template <int DHP, int ROWS>
__device__ __forceinline__ void tile_async(float* tile, const float* m,
                                           int row0, int T, int dh, int vec) {
  constexpr int SD = Tile<DHP>::SD;
  if (vec) {
    constexpr int C4 = DHP / 4;
    for (int e = threadIdx.x; e < ROWS * C4; e += kThreads) {
      const int r = e / C4, d = 4 * (e % C4), row = row0 + r;
      const bool ok = row < T && d < dh;
      cp_async16(tile + r * SD + d, ok ? m + (long long)row * dh + d : m, ok);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * DHP; e += kThreads) {
      const int r = e / DHP, d = e % DHP, row = row0 + r;
      const bool ok = row < T && d < dh;
      cp_async4(tile + r * SD + d, ok ? m + (long long)row * dh + d : m, ok);
    }
  }
}

// one stage of the dk/dv sweep: the query tile from row q0 of Q and dO, and
// its rows' lse, D and dlse (zero without dlse) from offset off
template <int DHP>
__device__ __forceinline__ void dkv_stage(float* qs, float* st,
                                          const float* q, const float* dout,
                                          const float* lse, const float* dcap,
                                          const float* dlse, long long off,
                                          int q0, int T, int dh, int vec) {
  tile_async<DHP, kCols>(qs, q, q0, T, dh, vec);
  tile_async<DHP, kCols>(qs + Tile<DHP>::STREAM, dout, q0, T, dh, vec);
  for (int e = threadIdx.x; e < kStat; e += kThreads) {
    const int which = e / kCols, qi = q0 + e % kCols;
    const float* src = which == 0 ? lse : which == 1 ? dcap : dlse;
    const bool ok = qi < T && src != nullptr;
    cp_async4(st + e, ok ? src + off + qi : lse, ok);
  }
}

// S = A1·B1ᵀ and dP = A2·B2ᵀ for the warp's 16 rows r0.. of the A tiles and
// NT·8 rows c0.. of the B tiles, contracting the head dim; KP 8-wide steps
// are summed from zero before each float32 add
template <int SD, int KS, int NT, int KP>
__device__ __forceinline__ void scores(float (&s)[NT][4], float (&dp)[NT][4],
                                       const float* a1, const float* a2,
                                       const float* b1, const float* b2,
                                       int r0, int c0, int gr, int tq) {
#pragma unroll
  for (int kk = 0; kk < KS; kk += KP) {
    Split4 x1[KP], x2[KP];
#pragma unroll
    for (int j = 0; j < KP; ++j) {
      x1[j] = frag_a<SD>(a1, r0, 8 * (kk + j), gr, tq);
      x2[j] = frag_a<SD>(a2, r0, 8 * (kk + j), gr, tq);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float t[4] = {}, u[4] = {};
#pragma unroll
      for (int j = 0; j < KP; ++j) {
        mma3(t, x1[j], frag_bt<SD>(b1, c0 + 8 * nt, 8 * (kk + j), gr, tq));
        mma3(u, x2[j], frag_bt<SD>(b2, c0 + 8 * nt, 8 * (kk + j), gr, tq));
      }
      add4(s[nt], t);
      add4(dp[nt], u);
    }
  }
}

// S = A·Bᵀ for the warp's 16 rows r0.. of the A tile and NT·8 rows c0.. of
// the B tile, contracting the head dim; KP 8-wide steps are summed from zero
// before each float32 add
template <int SD, int KS, int NT, int KP>
__device__ __forceinline__ void scores1(float (&s)[NT][4], const float* a,
                                        const float* b, int r0, int c0,
                                        int gr, int tq) {
#pragma unroll
  for (int kk = 0; kk < KS; kk += KP) {
    Split4 x[KP];
#pragma unroll
    for (int j = 0; j < KP; ++j) x[j] = frag_a<SD>(a, r0, 8 * (kk + j), gr, tq);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float t[4] = {};
#pragma unroll
      for (int j = 0; j < KP; ++j)
        mma3(t, x[j], frag_bt<SD>(b, c0 + 8 * nt, 8 * (kk + j), gr, tq));
      add4(s[nt], t);
    }
  }
}

// ---------------------------------------------------------------------------
// forward: one block per (g, 64 query rows), walking 32-key tiles
// ---------------------------------------------------------------------------

// The online softmax in base 2: a thread holds the scores of its rows
// w_first + gr and + gr + 8 in the columns 2tq, 2tq+1 of each 8-key step,
// so a row's maximum is taken over the four lanes tq of its group; m is that
// running maximum of s·scale·log2(e), l this thread's own share of the row's
// sum (the four shares are added once, at the end), acc the row's float32
// total of P·V, rescaled by exp2(m_old − m_new) before each pass's partial.
// The explicit minimum of one block a SM lets ptxas take more than 128
// registers: without it ptxas stopped every instance at 128, and the <128>
// one spilled (ptxas -v: 36 bytes of spill stores).
template <int DHP>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int G, int T, int dh, float scale,
                 int causal, int vec) {
  using C = Tile<DHP>;
  constexpr int SD = C::SD, NC = C::NC, NT = NC / 8;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;  // this block's query rows
  float* kvs = qs + C::OWN;  // two stages of (K, V)
  const int nblk = (T + kRows - 1) / kRows;
  const int qb = nblk - 1 - (int)(blockIdx.x / G);  // heaviest first
  const long long g = blockIdx.x % G;
  const long long base = g * T * dh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, tq = lane % 4;
  const int r0 = 16 * warp;  // this warp's rows in the block's tile
  const int w_first = qb * kRows + r0;  // its first query
  const int w_last = min(w_first + 15, T - 1);  // its last valid query
  const int q_last = min(qb * kRows + kRows - 1, T - 1);
  const int ntiles = causal ? q_last / kCols + 1 : (T + kCols - 1) / kCols;

  tile_async<DHP, kRows>(qs, q + base, qb * kRows, T, dh, vec);
  tile_async<DHP, kCols>(kvs, k + base, 0, T, dh, vec);
  tile_async<DHP, kCols>(kvs + C::STREAM, v + base, 0, T, dh, vec);
  cp_async_commit();

  const float scale_log2 = scale * kLog2e;
  float acc[C::KS][4] = {};  // o of the warp's 16 rows, unnormalised
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * kCols;
    const float* ks = kvs + (kt & 1) * 2 * C::STREAM;
    const float* vs = ks + C::STREAM;
    if (kt + 1 < ntiles) {
      float* nxt = kvs + ((kt + 1) & 1) * 2 * C::STREAM;
      tile_async<DHP, kCols>(nxt, k + base, k0 + kCols, T, dh, vec);
      tile_async<DHP, kCols>(nxt + C::STREAM, v + base, k0 + kCols, T, dh,
                             vec);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    // a warp takes a pass if it needs any key in it (causal, and < T); the
    // keys it does not need are masked, so the pass's code is free of
    // branches. Every row's first pass holds key 0, so m is finite after it
    const int kmax = (causal ? w_last : T - 1) - k0;
#pragma unroll
    for (int c0 = 0; c0 < kCols; c0 += NC) {
      if (w_first >= T || c0 > kmax) continue;
      float s[NT][4] = {};
      scores1<SD, C::KS, NT, 2>(s, qs, ks, r0, c0, gr, tq);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int qi = w_first + gr + 8 * i;
          const int kj = k0 + c0 + 8 * nt + 2 * tq + (e & 1);
          const bool ok = kj < T && (!causal || qi >= kj);
          s[nt][e] = ok ? s[nt][e] * scale_log2 : kNegInf;
          mx[i] = fmaxf(mx[i], s[nt][e]);
        }
      }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        corr[i] = exp2f(m[i] - m_new);
        m[i] = m_new;
        l[i] *= corr[i];
      }
      // P = exp2(S·scale·log2(e) − m) in place of S (0 where masked)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = exp2f(s[nt][e] - m[e >> 1]);
          l[e >> 1] += s[nt][e];
        }
      }
      // acc = acc·corr + P·V, the pass's keys summed from zero
      Split4 a[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) a[nt] = frag_acc(s[nt]);
#pragma unroll
      for (int nd = 0; nd < C::KS; ++nd) {
        float t[4] = {};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma3(t, a[nt], frag_bp<SD>(vs, c0 + 8 * nt, 8 * nd, gr, tq));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[nd][e] = fmaf(acc[nd][e], corr[e >> 1], t[e]);
      }
    }
    __syncthreads();  // before the next copy overwrites this stage
  }

  // each row's sum over its four lanes, in a fixed order; lse = m + log(l)
  float lc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    lc[i] = fmaxf(l[i], 1e-30f);
    const int qi = w_first + gr + 8 * i;
    if (tq == 0 && qi < T) lse[g * T + qi] = m[i] * kLn2 + logf(lc[i]);
  }
#pragma unroll
  for (int nd = 0; nd < C::KS; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = w_first + gr + 8 * (e >> 1);
      const int d = 8 * nd + 2 * tq + (e & 1);
      if (qi < T && d < dh)
        o[base + (long long)qi * dh + d] = acc[nd][e] / lc[e >> 1];
    }
  }
}

// ---------------------------------------------------------------------------
// dq: one block per (g, 64 query rows), walking 32-key tiles
// ---------------------------------------------------------------------------

template <int DHP>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ dcap,
                const float* __restrict__ dlse, float* __restrict__ dq,
                int G, int T, int dh, float scale, int causal, int vec) {
  using C = Tile<DHP>;
  constexpr int SD = C::SD, NC = C::NC, NT = NC / 8;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;  // this block's query rows
  float* os = qs + C::OWN;  // their output cotangents
  float* kvs = os + C::OWN;  // two stages of (K, V)
  const int nblk = (T + kRows - 1) / kRows;
  const int qb = nblk - 1 - (int)(blockIdx.x / G);
  const long long g = blockIdx.x % G;
  const long long base = g * T * dh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, tq = lane % 4;
  const int r0 = 16 * warp;  // this warp's rows in the block's tile
  const int w_first = qb * kRows + r0;  // its first query
  const int w_last = min(w_first + 15, T - 1);  // its last valid query
  const int q_last = min(qb * kRows + kRows - 1, T - 1);
  const int ntiles =
      causal ? q_last / kCols + 1 : (T + kCols - 1) / kCols;

  tile_async<DHP, kRows>(qs, q + base, qb * kRows, T, dh, vec);
  tile_async<DHP, kRows>(os, dout + base, qb * kRows, T, dh, vec);
  tile_async<DHP, kCols>(kvs, k + base, 0, T, dh, vec);
  tile_async<DHP, kCols>(kvs + C::STREAM, v + base, 0, T, dh, vec);
  cp_async_commit();

  // the statistics of this thread's two rows, w_first + gr and + gr + 8
  float L[2], Dc[2], Dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = w_first + gr + 8 * i;
    const bool ok = qi < T;
    L[i] = ok ? lse[g * T + qi] * kLog2e : 0.f;
    Dc[i] = ok ? dcap[g * T + qi] : 0.f;
    Dl[i] = (ok && dlse) ? dlse[g * T + qi] : 0.f;
  }
  const float scale_log2 = scale * kLog2e;
  float acc[C::KS][4] = {};  // dq of the warp's 16 rows

  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * kCols;
    const float* ks = kvs + (kt & 1) * 2 * C::STREAM;
    const float* vs = ks + C::STREAM;
    if (kt + 1 < ntiles) {
      float* nxt = kvs + ((kt + 1) & 1) * 2 * C::STREAM;
      tile_async<DHP, kCols>(nxt, k + base, k0 + kCols, T, dh, vec);
      tile_async<DHP, kCols>(nxt + C::STREAM, v + base, k0 + kCols, T,
                                dh, vec);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    // a warp takes a pass if it needs any key in it (causal, and < T); the
    // keys it does not need are masked, so the pass's code is free of
    // branches
    const int kmax = (causal ? w_last : T - 1) - k0;
#pragma unroll
    for (int c0 = 0; c0 < kCols; c0 += NC) {
      if (w_first >= T || c0 > kmax) continue;
      float s[NT][4] = {}, dp[NT][4] = {};
      // two head-dim steps summed from zero (dk/dv has no registers for it)
      scores<SD, C::KS, NT, 2>(s, dp, qs, os, ks, vs, r0, c0, gr, tq);
      // dS = P∘(dP − D + dlse), with P = exp(S·scale − lse), in place of S
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int qi = w_first + gr + 8 * i;
          const int kj = k0 + c0 + 8 * nt + 2 * tq + (e & 1);
          const bool ok = kj < T && (!causal || qi >= kj);
          const float p = ok ? exp2f(fmaf(s[nt][e], scale_log2, -L[i])) : 0.f;
          s[nt][e] = p * ((dp[nt][e] - Dc[i]) + Dl[i]);
        }
      }
      // dQ += dS·K, the pass's keys summed from zero
      Split4 a[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) a[nt] = frag_acc(s[nt]);
#pragma unroll
      for (int nd = 0; nd < C::KS; ++nd) {
        float t[4] = {};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma3(t, a[nt], frag_bp<SD>(ks, c0 + 8 * nt, 8 * nd, gr, tq));
        add4(acc[nd], t);
      }
    }
    __syncthreads();  // before the next copy overwrites this stage
  }

#pragma unroll
  for (int nd = 0; nd < C::KS; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = w_first + gr + 8 * (e >> 1);
      const int d = 8 * nd + 2 * tq + (e & 1);
      if (qi < T && d < dh)
        dq[base + (long long)qi * dh + d] = acc[nd][e] * scale;
    }
  }
}

// ---------------------------------------------------------------------------
// dk/dv: one block per (g, 64 key rows), walking 32-query tiles
// ---------------------------------------------------------------------------

template <int DHP>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ dcap,
                 const float* __restrict__ dlse, float* __restrict__ dk,
                 float* __restrict__ dv, int G, int T, int dh, float scale,
                 int causal, int vec) {
  using C = Tile<DHP>;
  constexpr int SD = C::SD, NC = C::NC, NT = NC / 8;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;  // this block's key rows
  float* vs = ks + C::OWN;
  float* qos = vs + C::OWN;  // two stages of (Q, dO)
  float* sts = qos + 4 * C::STREAM;  // two stages of the rows' statistics
  const int kb = (int)(blockIdx.x / G);  // the first key blocks see most
  const long long g = blockIdx.x % G;
  const long long base = g * T * dh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, tq = lane % 4;
  const int r0 = 16 * warp;
  const int w_first = kb * kRows + r0;  // this warp's first key
  // the query tiles at or after the block's first key, up to T
  const int qt0 = causal ? kb * kRows / kCols : 0;
  const int ntiles = (T + kCols - 1) / kCols - qt0;

  tile_async<DHP, kRows>(ks, k + base, kb * kRows, T, dh, vec);
  tile_async<DHP, kRows>(vs, v + base, kb * kRows, T, dh, vec);
  dkv_stage<DHP>(qos, sts, q + base, dout + base, lse, dcap, dlse, g * T,
                 qt0 * kCols, T, dh, vec);
  cp_async_commit();

  const float scale_log2 = scale * kLog2e;
  float dka[C::KS][4] = {}, dva[C::KS][4] = {};

  for (int i = 0; i < ntiles; ++i) {
    const int q0 = (qt0 + i) * kCols;
    const float* qs = qos + (i & 1) * 2 * C::STREAM;
    const float* os = qs + C::STREAM;
    const float* st = sts + (i & 1) * kStat;
    if (i + 1 < ntiles)
      dkv_stage<DHP>(qos + ((i + 1) & 1) * 2 * C::STREAM,
                     sts + ((i + 1) & 1) * kStat, q + base, dout + base, lse,
                     dcap, dlse, g * T, q0 + kCols, T, dh, vec);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    // the queries of the tile this warp needs: from its first key on
    // (causal) and below T; a pass takes all its columns if it needs any,
    // the others masked, so its code is free of branches
    const int cmin = causal ? max(0, w_first - q0) : 0;
    const int cmax = min(kCols - 1, T - 1 - q0);
#pragma unroll
    for (int c0 = 0; c0 < kCols; c0 += NC) {
      if (w_first >= T || c0 > cmax || c0 + NC <= cmin) continue;
      float s[NT][4] = {}, dp[NT][4] = {};
      scores<SD, C::KS, NT, 1>(s, dp, ks, vs, qs, os, r0, c0, gr, tq);
      // Pᵀ in place of Sᵀ, dSᵀ = Pᵀ∘(dPᵀ − D + dlse) in place of dPᵀ
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + 8 * nt + 2 * tq + (e & 1);
          const int qi = q0 + col;
          const int kj = w_first + gr + 8 * (e >> 1);
          const bool ok = qi < T && (!causal || qi >= kj);
          const float p =
              ok ? exp2f(fmaf(s[nt][e], scale_log2, -st[col] * kLog2e)) : 0.f;
          s[nt][e] = p;
          dp[nt][e] = p * ((dp[nt][e] - st[kCols + col]) +
                           st[2 * kCols + col]);
        }
      }
      // dV += Pᵀ·dO, dK += dSᵀ·Q, the pass's queries summed from zero
      Split4 ap[NT], ad[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        ap[nt] = frag_acc(s[nt]);
        ad[nt] = frag_acc(dp[nt]);
      }
#pragma unroll
      for (int nd = 0; nd < C::KS; ++nd) {
        float t[4] = {}, u[4] = {};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma3(t, ap[nt], frag_bp<SD>(os, c0 + 8 * nt, 8 * nd, gr, tq));
          mma3(u, ad[nt], frag_bp<SD>(qs, c0 + 8 * nt, 8 * nd, gr, tq));
        }
        add4(dva[nd], t);
        add4(dka[nd], u);
      }
    }
    __syncthreads();  // before the next copy overwrites this stage
  }

#pragma unroll
  for (int nd = 0; nd < C::KS; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kj = w_first + gr + 8 * (e >> 1);
      const int d = 8 * nd + 2 * tq + (e & 1);
      if (kj < T && d < dh) {
        dk[base + (long long)kj * dh + d] = dka[nd][e] * scale;
        dv[base + (long long)kj * dh + d] = dva[nd][e];
      }
    }
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

unsigned grid_of(int G, int T) {
  return (unsigned)(((T + kRows - 1) / kRows) * (long long)G);
}

bool bad_shape(int G, int T, int dh) {
  if (G < 1 || T < 1 || padded_dh(dh) == 0) return true;
  // one block per (head, row block) in a one-dimensional grid
  return (long long)G * ((T + kRows - 1) / kRows) > 2147483647LL;
}

// 16-byte copies of whole rows: dh % 4 == 0 and every matrix 16-byte aligned
int rows_vec4(int dh, const float* a, const float* b, const float* c,
              const float* d) {
  const uintptr_t any = (uintptr_t)a | (uintptr_t)b | (uintptr_t)c |
                        (uintptr_t)d;
  return dh % 4 == 0 && any % 16 == 0;
}

// every instance the launchers can pick (Dh padded to 16, 32, 64, 128);
// their tiles are dynamic shared memory, above 48 KB at Dh 64 and 128 (the
// launchers raise the limit)
const draco_audit::Entry kAudit[] = {
    {"flash_fwd_kernel<16>", (const void*)flash_fwd_kernel<16>, kThreads,
     fwd_smem<16>, 1},
    {"flash_fwd_kernel<32>", (const void*)flash_fwd_kernel<32>, kThreads,
     fwd_smem<32>, 1},
    {"flash_fwd_kernel<64>", (const void*)flash_fwd_kernel<64>, kThreads,
     fwd_smem<64>, 1},
    {"flash_fwd_kernel<128>", (const void*)flash_fwd_kernel<128>, kThreads,
     fwd_smem<128>, 1},
    {"flash_dq_kernel<16>", (const void*)flash_dq_kernel<16>, kThreads,
     dq_smem<16>, 1},
    {"flash_dq_kernel<32>", (const void*)flash_dq_kernel<32>, kThreads,
     dq_smem<32>, 1},
    {"flash_dq_kernel<64>", (const void*)flash_dq_kernel<64>, kThreads,
     dq_smem<64>, 1},
    {"flash_dq_kernel<128>", (const void*)flash_dq_kernel<128>, kThreads,
     dq_smem<128>, 1},
    {"flash_dkv_kernel<16>", (const void*)flash_dkv_kernel<16>, kThreads,
     dkv_smem<16>, 1},
    {"flash_dkv_kernel<32>", (const void*)flash_dkv_kernel<32>, kThreads,
     dkv_smem<32>, 1},
    {"flash_dkv_kernel<64>", (const void*)flash_dkv_kernel<64>, kThreads,
     dkv_smem<64>, 1},
    {"flash_dkv_kernel<128>", (const void*)flash_dkv_kernel<128>, kThreads,
     dkv_smem<128>, 1},
};

template <int DHP>
cudaError_t launch_fwd(const float* q, const float* k, const float* v,
                       float* o, float* lse, int G, int T, int dh,
                       float scale, int causal, cudaStream_t st) {
  const size_t smem = fwd_smem<DHP>(0, 0);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DHP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<DHP><<<grid_of(G, T), kThreads, smem, st>>>(
      q, k, v, o, lse, G, T, dh, scale, causal, rows_vec4(dh, q, k, v, v));
  return cudaGetLastError();
}

template <int DHP>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const float* dout, const float* lse, const float* dcap,
                      const float* dlse, float* dq, int G, int T, int dh,
                      float scale, int causal, cudaStream_t st) {
  const size_t smem = dq_smem<DHP>(0, 0);
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<DHP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  flash_dq_kernel<DHP><<<grid_of(G, T), kThreads, smem, st>>>(
      q, k, v, dout, lse, dcap, dlse, dq, G, T, dh, scale, causal,
      rows_vec4(dh, q, k, v, dout));
  return cudaGetLastError();
}

template <int DHP>
cudaError_t launch_dkv(const float* q, const float* k, const float* v,
                       const float* dout, const float* lse, const float* dcap,
                       const float* dlse, float* dk, float* dv, int G, int T,
                       int dh, float scale, int causal, cudaStream_t st) {
  const size_t smem = dkv_smem<DHP>(0, 0);
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_kernel<DHP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  flash_dkv_kernel<DHP><<<grid_of(G, T), kThreads, smem, st>>>(
      q, k, v, dout, lse, dcap, dlse, dk, dv, G, T, dh, scale, causal,
      rows_vec4(dh, q, k, v, dout));
  return cudaGetLastError();
}

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
    return (int)launch_fwd<D>(q, k, v, o, lse, G, T, dh, scale, causal, st);
    DRACO_FWD(16) DRACO_FWD(32) DRACO_FWD(64) DRACO_FWD(128)
#undef DRACO_FWD
  }
  return (int)cudaErrorInvalidValue;
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
    return (int)launch_dq<D>(q, k, v, dout, lse, dcap, dlse, dq, G, T, dh,  \
                             scale, causal, st);
    DRACO_DQ(16) DRACO_DQ(32) DRACO_DQ(64) DRACO_DQ(128)
#undef DRACO_DQ
  }
  return (int)cudaErrorInvalidValue;
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
    return (int)launch_dkv<D>(q, k, v, dout, lse, dcap, dlse, dk, dv, G, T, \
                              dh, scale, causal, st);
    DRACO_DKV(16) DRACO_DKV(32) DRACO_DKV(64) DRACO_DKV(128)
#undef DRACO_DKV
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
