// Counter-based device draws, by hand for Hopper (sm_90a). Plain C
// interface, loaded with ctypes by draco_tpu_torch/ops/draws.py; every
// launch goes on the caller's stream and the function returns
// cudaGetLastError().
//
// The stream is the reference's JAX PRNG (threefry2x32 under
// jax_threefry_partitionable), bit for bit: draco_tpu_torch/rng.py holds
// the same arithmetic as plain torch functions. Replaces the XLA fusions of
// jax.random in draco_tpu/attacks.py (:40-47, :60-95: the random attack),
// draco_tpu/obs/numerics.py (:494-556, :668-703: the stochastic rounding
// draws of the narrow wire) and draco_tpu/parallel/sp_step.py (:83-100:
// synthetic_text_in_graph); no Pallas kernel there.
//
//   threefry2x32(k, x0, x1): k2 = k0 ^ k1 ^ 0x1BD11BDA; x += (k0, k1); five
//       groups of four rounds (x0 += x1; x1 = rotl(x1, r) ^ x0), the
//       rotations (13, 15, 26, 6) and (17, 29, 16, 24) alternating, after
//       group i: x0 += ks[(i+1)%3], x1 += ks[(i+2)%3] + i + 1
//   key(seed) = (0, seed); fold_in(k, v) = split(k)[v] = threefry(k, 0, v)
//   bits(k)[c] = a ^ b, (a, b) = threefry(k, hi32(c), lo32(c)), c the flat
//       C-order index of the element in the reference's draw, 64 bits
//   uniform = bitcast_f32((bits >> 9) | 0x3F800000) - 1
//   normal  = sqrt(2) · erfinv(max(lo, uniform · (1 - lo) + lo)),
//       lo = nextafter(-1, 0), erfinv the reference's Giles polynomial
//   randint(k, lo, hi) = lo + ((bits(k1) % span) · mult + bits(k2) % span)
//       % span, (k1, k2) = split(k), mult = (2^16 % span)^2 % span, uint32
//
// Every key comes from the seed (with its salt added by the caller) and
// the step, read from device memory (an int32 of the step's staged
// inputs), so a step captured in a CUDA graph draws each replay's own
// step's numbers. The key chain is recomputed by every thread: three
// threefry calls against thousands a thread in the loop.
//
// Six entry points:
//   random_inject   the random attack on the rows whose device mask is set:
//                   the cyclic pair (kr, ki = split(key)) adds magnitude ·
//                   normal to both parts in place, the plain form writes
//                   magnitude · normal; row i, column j draws at counter
//                   i·d + j, the counter of the reference's full (n, d)
//                   draw, so only the attacked rows are touched
//   round_draw      the (d,) draw stochastic rounding shares across the wire
//                   rows: bits & 0xFFFF (bf16) or uniform (int8); part 1,
//                   the imaginary part's, from fold_in(key, 1)
//   synthetic_text  the device token stream: start ∈ [0, vocab) and
//                   stride ∈ [1, 3) a sequence (counter: the sequence's
//                   index), tokens (start + stride · t) % vocab, int32
//   augment_draws   the training step's augmentation draws: sample b of
//                   row r draws top, left = randint(0, 9) and flip =
//                   uniform < 0.5 from the three keys of split(split(
//                   fold_in(key, r / div), batch)[b], 3), int32
//   dropout_keep    the keep-masks of a model's nn.Dropout layers: unit j
//                   of layer m of row r is uniform < keep at counter j of
//                   fold_in(fold_in(key, r / div), h_m), h_m the uint32
//                   of Flax's static fold of ("Dropout_m", 1), one byte
//   vote_salts      the vote's two fingerprint salts: bits(key, (2,))
//
// What bounds it on an H100: integer operations. A draw is one threefry
// (20 rounds of an add, a funnel shift and a xor, 5 key injections of
// three adds, and the initial two: 77 32-bit operations) and the xor of
// its pair, against 4 bytes written (and read, on the cyclic pair); at
// 128 integer operations a clock a SM an attacked cyclic row of
// ResNet-18's d = 11,173,962 is 2 · 11.2M draws, about 0.05 ms of
// integer issue against 0.05 ms of its 179 MB at 3.35 TB/s (ops/draws.py:
// draw_bound). The normal's erfinv (a log1pf, a sqrtf on the tail, nine
// FMAs) runs on the FMA pipe beside it. No fast-math: log1pf and sqrtf are
// the IEEE library versions, so the normal stays within a few ulps of the
// plain version's.
//
// Design: a grid of (column tiles, rows) of 256 threads, grid-stride over
// the columns; a random_inject block whose row is not attacked returns
// before any draw. Each element's counter is independent, so the result
// is bit for bit the same from launch to launch and from a graph replay.

#include <cuda_runtime.h>
#include <stdint.h>

#include "audit.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTextThreads = 128;
// column tiles a row at most: one wave of 8 blocks a SM on the 132 SMs
constexpr long long kMaxTiles = 132 * 8;
constexpr uint32_t kParity = 0x1BD11BDAu;
// normal(): nextafter(-1, 0), (1 - lo) as f32 rounds it, sqrt(2) in f32
constexpr float kLo = -0.99999994f;
constexpr float kSpan = 2.0f;
constexpr float kSqrt2 = 1.41421356f;

struct Key {
  uint32_t k0, k1;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1;
  x1 = rotl(x1, R0) ^ x0;
  x0 += x1;
  x1 = rotl(x1, R1) ^ x0;
  x0 += x1;
  x1 = rotl(x1, R2) ^ x0;
  x0 += x1;
  x1 = rotl(x1, R3) ^ x0;
}

__device__ __forceinline__ uint2 threefry(Key k, uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k.k0 ^ k.k1 ^ kParity;
  x0 += k.k0;
  x1 += k.k1;
  rounds<13, 15, 26, 6>(x0, x1);
  x0 += k.k1;
  x1 += k2 + 1u;
  rounds<17, 29, 16, 24>(x0, x1);
  x0 += k2;
  x1 += k.k0 + 2u;
  rounds<13, 15, 26, 6>(x0, x1);
  x0 += k.k0;
  x1 += k.k1 + 3u;
  rounds<17, 29, 16, 24>(x0, x1);
  x0 += k.k1;
  x1 += k2 + 4u;
  rounds<13, 15, 26, 6>(x0, x1);
  x0 += k2;
  x1 += k.k0 + 5u;
  return make_uint2(x0, x1);
}

// fold_in(k, v), and split(k, m)[v]: the same threefry of (0, v)
__device__ __forceinline__ Key fold_in(Key k, uint32_t v) {
  const uint2 r = threefry(k, 0u, v);
  return Key{r.x, r.y};
}

__device__ __forceinline__ uint32_t bits_at(Key k, unsigned long long c) {
  const uint2 r = threefry(k, (uint32_t)(c >> 32), (uint32_t)c);
  return r.x ^ r.y;
}

__device__ __forceinline__ float uniform_of(uint32_t b) {
  return __fsub_rn(__uint_as_float((b >> 9) | 0x3F800000u), 1.0f);
}

// the reference's float32 erfinv: M. Giles's polynomial in w - 2.5 for
// w = -log1p(-x²) < 5, else in sqrt(w) - 3
__device__ __forceinline__ float erfinv_ref(float x) {
  float w = -log1pf(-__fmul_rn(x, x));
  float p;
  if (w < 5.0f) {
    w = w - 2.5f;
    p = 2.81022636e-08f;
    p = 3.43273939e-07f + p * w;
    p = -3.5233877e-06f + p * w;
    p = -4.39150654e-06f + p * w;
    p = 0.00021858087f + p * w;
    p = -0.00125372503f + p * w;
    p = -0.00417768164f + p * w;
    p = 0.246640727f + p * w;
    p = 1.50140941f + p * w;
  } else {
    w = sqrtf(w) - 3.0f;
    p = -0.000200214257f;
    p = 0.000100950558f + p * w;
    p = 0.00134934322f + p * w;
    p = -0.00367342844f + p * w;
    p = 0.00573950773f + p * w;
    p = -0.0076224613f + p * w;
    p = 0.00943887047f + p * w;
    p = 1.00167406f + p * w;
    p = 2.83297682f + p * w;
  }
  return p * x;
}

__device__ __forceinline__ float normal_of(uint32_t b) {
  const float u = fmaxf(__fadd_rn(__fmul_rn(uniform_of(b), kSpan), kLo), kLo);
  return __fmul_rn(kSqrt2, erfinv_ref(u));
}

__device__ __forceinline__ int randint_at(Key k, unsigned long long c, int lo,
                                          int hi) {
  const Key k1 = fold_in(k, 0u), k2 = fold_in(k, 1u);
  const uint32_t span = hi > lo ? (uint32_t)(hi - lo) : 1u;
  uint32_t mult = 65536u % span;
  mult = (mult * mult) % span;
  const uint32_t off =
      ((bits_at(k1, c) % span) * mult + bits_at(k2, c) % span) % span;
  return lo + (int)off;
}

// re, im: n rows of d floats (im unused by the plain form); mask: n bytes;
// step: the int32 step; seed: the attack's seed with its salt
template <bool kPair>
__global__ void __launch_bounds__(kThreads)
    random_inject_kernel(float* __restrict__ re, float* __restrict__ im,
                         const unsigned char* __restrict__ mask,
                         const int* __restrict__ step, uint32_t seed,
                         float mag, long long d) {
  const int row = blockIdx.y;
  if (!__ldg(mask + row)) return;
  const Key key = fold_in(Key{0u, seed}, (uint32_t)__ldg(step));
  const Key kr = kPair ? fold_in(key, 0u) : key;
  const Key ki = fold_in(key, 1u);
  const unsigned long long base = (unsigned long long)row * d;
  float* r = re + base;
  float* m = kPair ? im + base : nullptr;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    const unsigned long long c = base + (unsigned long long)j;
    const float zr = normal_of(bits_at(kr, c));
    if (kPair) {
      r[j] = __fadd_rn(r[j], __fmul_rn(mag, zr));
      m[j] = __fadd_rn(m[j], __fmul_rn(mag, normal_of(bits_at(ki, c))));
    } else {
      r[j] = __fmul_rn(mag, zr);
    }
  }
}

// out: parts rows of d uint32 (part 1 from fold_in(key, 1)): bits & 0xFFFF,
// or the uniform's float bits
template <bool kUniform>
__global__ void __launch_bounds__(kThreads)
    round_draw_kernel(uint32_t* __restrict__ out, const int* __restrict__ step,
                      uint32_t seed, long long d) {
  const int part = blockIdx.y;
  Key key = fold_in(Key{0u, seed}, (uint32_t)__ldg(step));
  if (part == 1) key = fold_in(key, 1u);
  uint32_t* o = out + (unsigned long long)part * d;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    const uint32_t b = bits_at(key, (unsigned long long)j);
    o[j] = kUniform ? __float_as_uint(uniform_of(b)) : (b & 0xFFFFu);
  }
}

// out: (3, rows, batch) int32, one thread a sample: top and left in
// [0, 2·pad], the flip bit
__global__ void __launch_bounds__(kThreads)
    augment_draws_kernel(int* __restrict__ out, const int* __restrict__ step,
                         uint32_t seed, int rows, int div, int batch,
                         int span) {
  const long long total = (long long)rows * batch;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int r = (int)(i / batch), b = (int)(i - (long long)r * batch);
  const Key key = fold_in(fold_in(Key{0u, seed}, (uint32_t)__ldg(step)),
                          (uint32_t)(r / div));
  const Key ks = fold_in(key, (uint32_t)b);  // split(key, batch)[b]
  out[i] = randint_at(fold_in(ks, 0u), 0ull, 0, span);
  out[total + i] = randint_at(fold_in(ks, 1u), 0ull, 0, span);
  out[2 * total + i] = uniform_of(bits_at(fold_in(ks, 2u), 0ull)) < 0.5f;
}

// out: (rows · count, units) bytes, one grid row a (row, layer): 1 where
// the unit is kept
__global__ void __launch_bounds__(kThreads)
    dropout_keep_kernel(unsigned char* __restrict__ out,
                        const int* __restrict__ step, uint32_t seed, int div,
                        int count, uint32_t h0, uint32_t h1, long long units,
                        float keep) {
  const int rm = blockIdx.y;
  const int r = rm / count, m = rm - r * count;
  const Key key = fold_in(fold_in(fold_in(Key{0u, seed},
                                          (uint32_t)__ldg(step)),
                                  (uint32_t)(r / div)),
                          m == 0 ? h0 : h1);
  unsigned char* o = out + (unsigned long long)rm * units;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < units; j += stride)
    o[j] = uniform_of(bits_at(key, (unsigned long long)j)) < keep;
}

// out: the two salts' bits, int32
__global__ void __launch_bounds__(32)
    vote_salts_kernel(int* __restrict__ out, const int* __restrict__ step,
                      uint32_t seed) {
  const Key key = fold_in(Key{0u, seed}, (uint32_t)__ldg(step));
  if (threadIdx.x < 2) out[threadIdx.x] = (int)bits_at(key, threadIdx.x);
}

// out: rows sequences of T int32 tokens, one block a sequence
__global__ void __launch_bounds__(kTextThreads)
    synthetic_text_kernel(int* __restrict__ out, const int* __restrict__ step,
                          uint32_t seed, int T, int vocab) {
  const int row = blockIdx.x;
  const Key key = fold_in(Key{0u, seed}, (uint32_t)__ldg(step));
  const int start = randint_at(fold_in(key, 0u), row, 0, vocab);
  const int stride = randint_at(fold_in(key, 1u), row, 1, 3);
  int* o = out + (size_t)row * T;
  for (int t = threadIdx.x; t < T; t += blockDim.x)
    o[t] = (start + stride * t) % vocab;
}

inline int tiles_for(long long d) {
  long long b = (d + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  if (b > kMaxTiles) b = kMaxTiles;
  return (int)b;
}

const draco_audit::Entry kAudit[] = {
    {"random_inject_kernel<true>", (const void*)random_inject_kernel<true>,
     kThreads, nullptr, 0},
    {"random_inject_kernel<false>", (const void*)random_inject_kernel<false>,
     kThreads, nullptr, 0},
    {"round_draw_kernel<false>", (const void*)round_draw_kernel<false>,
     kThreads, nullptr, 0},
    {"round_draw_kernel<true>", (const void*)round_draw_kernel<true>, kThreads,
     nullptr, 0},
    {"synthetic_text_kernel", (const void*)synthetic_text_kernel, kTextThreads,
     nullptr, 0},
    {"augment_draws_kernel", (const void*)augment_draws_kernel, kThreads,
     nullptr, 0},
    {"dropout_keep_kernel", (const void*)dropout_keep_kernel, kThreads,
     nullptr, 0},
    {"vote_salts_kernel", (const void*)vote_salts_kernel, 32, nullptr, 0},
};

}  // namespace

DRACO_AUDIT_EXPORTS(kAudit)

extern "C" {

// re (and im, the cyclic pair; null: the plain form): (n, d) f32, written
// in place on the rows whose byte of mask is set
int draco_random_inject(void* re, void* im, const void* mask,
                        const void* step, unsigned seed, float mag, int n,
                        long long d, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n < 1 || d < 1) return (int)cudaGetLastError();
  dim3 grid(tiles_for(d), n);
  const unsigned char* m = (const unsigned char*)mask;
  const int* s = (const int*)step;
  if (im)
    random_inject_kernel<true><<<grid, kThreads, 0, st>>>(
        (float*)re, (float*)im, m, s, seed, mag, d);
  else
    random_inject_kernel<false><<<grid, kThreads, 0, st>>>(
        (float*)re, nullptr, m, s, seed, mag, d);
  return (int)cudaGetLastError();
}

// out: (parts, d) uint32, parts 1 or 2; uniform 0: bits & 0xFFFF (bf16),
// 1: the uniform's bits (int8)
int draco_round_draw(void* out, const void* step, unsigned seed, int parts,
                     long long d, int uniform, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (parts < 1 || parts > 2) return (int)cudaErrorInvalidValue;
  if (d < 1) return (int)cudaGetLastError();
  dim3 grid(tiles_for(d), parts);
  if (uniform)
    round_draw_kernel<true><<<grid, kThreads, 0, st>>>(
        (uint32_t*)out, (const int*)step, seed, d);
  else
    round_draw_kernel<false><<<grid, kThreads, 0, st>>>(
        (uint32_t*)out, (const int*)step, seed, d);
  return (int)cudaGetLastError();
}

// out: (rows, T) int32 tokens in [0, vocab)
int draco_synthetic_text(void* out, const void* step, unsigned seed, int rows,
                         int T, int vocab, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (vocab < 1) return (int)cudaErrorInvalidValue;
  if (rows < 1 || T < 1) return (int)cudaGetLastError();
  synthetic_text_kernel<<<rows, kTextThreads, 0, st>>>(
      (int*)out, (const int*)step, seed, T, vocab);
  return (int)cudaGetLastError();
}

// out: (3, rows, batch) int32; a row's key folds r / div (div: the
// vote's group size, else 1); span: 2·pad + 1
int draco_augment_draws(void* out, const void* step, unsigned seed, int rows,
                        int div, int batch, int span, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (div < 1 || span < 1) return (int)cudaErrorInvalidValue;
  const long long total = (long long)rows * batch;
  if (total < 1) return (int)cudaGetLastError();
  augment_draws_kernel<<<(unsigned)((total + kThreads - 1) / kThreads),
                         kThreads, 0, st>>>((int*)out, (const int*)step, seed,
                                            rows, div, batch, span);
  return (int)cudaGetLastError();
}

// out: (rows, count, units) bytes, count 1 or 2 with the layers' hashes
// h0, h1
int draco_dropout_keep(void* out, const void* step, unsigned seed, int rows,
                       int div, int count, unsigned h0, unsigned h1,
                       long long units, float keep, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (div < 1 || count < 1 || count > 2) return (int)cudaErrorInvalidValue;
  if (rows < 1 || units < 1) return (int)cudaGetLastError();
  dim3 grid(tiles_for(units), rows * count);
  dropout_keep_kernel<<<grid, kThreads, 0, st>>>(
      (unsigned char*)out, (const int*)step, seed, div, count, h0, h1, units,
      keep);
  return (int)cudaGetLastError();
}

// out: (2,) int32
int draco_vote_salts(void* out, const void* step, unsigned seed,
                     void* stream) {
  vote_salts_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (int*)out, (const int*)step, seed);
  return (int)cudaGetLastError();
}

}  // extern "C"
