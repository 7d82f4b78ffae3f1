// Row fingerprints of the repetition code's vote, by hand for Hopper
// (sm_90a). Plain C interface, loaded with ctypes by
// draco_tpu_torch/ops/vote.py; every launch goes on the caller's stream and
// the function returns cudaGetLastError().
//
// Replaces the XLA fusion of draco_tpu/coding/repetition.py
// _row_fingerprints (:94-124; no Pallas kernel there). For each of the n
// rows of an (n, d) f32 or bf16 matrix, two uint32 wrapping sums over the
// row's positions j of
//
//   h1 = Σ_j splitmix32(splitmix32(bits_j ^ s1) + posmix_j)
//   h2 = Σ_j splitmix32(splitmix32(bits_j ^ s2 ^ 0x7F4A7C15) + posmix_j)
//   posmix_j = splitmix32(j · 2654435761 + 0x9E3779B9)
//
// where bits_j is the element's raw bits (a bf16's 16 bits zero-extended)
// and s1, s2 the step's two salts, read from device memory so that a
// captured CUDA graph reads each replay's own. posmix_j is computed once
// an element for both hashes.
//
// What bounds it on an H100: it reads each row once (n·d·4 bytes in f32,
// 402 MB at n = 9, d = 11,173,962: 0.120 ms at 3.35 TB/s) and does 47
// 32-bit integer operations an element as written here (posmix: one
// multiply-add and the 8 operations of a splitmix32; each hash: a xor, two
// splitmix32, an add and the running add), 4.7e9 at that shape: 0.141 ms
// at 128 integer operations a clock a SM, so integer throughput, not bytes,
// bounds it (ops/vote.py: fingerprint_ops). As compiled for sm_90a the f32
// loop issues about 48 instructions an element, about 36 of them shifts,
// logic and adds on the 64-lane INT32 pipe (the multiply-adds go to the
// FMA pipe): that pipe, not the issue rate, is what the kernel runs
// against (chip_smoke.py counts the loop's instructions, PERF.md §6).
//
// Design: a grid over (column tiles, rows); each thread walks its row with
// aligned 16-byte loads (4 f32 or 8 bf16 elements), grid-stride, keeping
// both sums in registers; the elements before the row's first 16-byte
// boundary and after its last whole chunk (a row of odd length, or a
// buffer that starts off a 16-byte boundary) are taken one at a time. A
// warp-shuffle sum and a shared-memory sum over the block's warps give one
// atomicAdd a block and hash into the (n, 2) output, which the launcher
// zeroes on the same stream first. A uint32 wrapping sum is the same in
// any order, so the atomics keep the result bit for bit from launch to
// launch and from a graph replay.

#include <cuda_runtime.h>
#include <stdint.h>

#include "audit.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr uint32_t kSalt2Mix = 0x7F4A7C15u;
// grid-stride cap on the blocks over all rows: two waves of 8 blocks a SM
constexpr int kMaxBlocks = 132 * 8 * 2;

__device__ __forceinline__ uint32_t splitmix32(uint32_t z) {
  z = (z ^ (z >> 16)) * 0x85EBCA6Bu;
  z = (z ^ (z >> 13)) * 0xC2B2AE35u;
  return z ^ (z >> 16);
}

struct Sums {
  uint32_t h1, h2;
  uint32_t s1, s2;  // s2 already xor 0x7F4A7C15

  __device__ __forceinline__ void add(uint32_t bits, uint32_t j) {
    const uint32_t pm = splitmix32(j * 2654435761u + 0x9E3779B9u);
    h1 += splitmix32(splitmix32(bits ^ s1) + pm);
    h2 += splitmix32(splitmix32(bits ^ s2) + pm);
  }
};

template <int kBytes>
__device__ __forceinline__ uint32_t load_bits(const unsigned char* p) {
  if (kBytes == 4) return __ldg(reinterpret_cast<const uint32_t*>(p));
  return (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p));
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// rows: n rows of d elements of kBytes (4: f32, 2: bf16), row-major;
// salts: 2 uint32 on the device; out: (n, 2) uint32, zeroed
template <int kBytes>
__global__ void __launch_bounds__(kThreads)
    row_fingerprints_kernel(const unsigned char* __restrict__ rows,
                            const uint32_t* __restrict__ salts,
                            uint32_t* __restrict__ out, long long d) {
  constexpr int kPer = 16 / kBytes;  // elements a 16-byte load
  const int row = blockIdx.y;
  const unsigned char* base = rows + (size_t)row * (size_t)d * kBytes;
  Sums s{0u, 0u, __ldg(salts), __ldg(salts + 1) ^ kSalt2Mix};
  // the elements before the row's first 16-byte boundary
  long long head = (long long)((16 - ((uintptr_t)base & 15)) & 15) / kBytes;
  if (head > d) head = d;
  const long long nvec = (d - head) / kPer;
  const long long tail0 = head + nvec * kPer;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  const uint4* vec = reinterpret_cast<const uint4*>(base + head * kBytes);
  for (long long v = tid; v < nvec; v += nthreads) {
    const uint4 w = __ldg(vec + v);
    const uint32_t j = (uint32_t)(head + v * kPer);
    if (kBytes == 4) {
      s.add(w.x, j);
      s.add(w.y, j + 1);
      s.add(w.z, j + 2);
      s.add(w.w, j + 3);
    } else {  // little-endian: the low half is the earlier element
      s.add(w.x & 0xFFFFu, j);
      s.add(w.x >> 16, j + 1);
      s.add(w.y & 0xFFFFu, j + 2);
      s.add(w.y >> 16, j + 3);
      s.add(w.z & 0xFFFFu, j + 4);
      s.add(w.z >> 16, j + 5);
      s.add(w.w & 0xFFFFu, j + 6);
      s.add(w.w >> 16, j + 7);
    }
  }
  // the head and the tail, one element a thread
  const long long nscalar = head + (d - tail0);
  for (long long t = tid; t < nscalar; t += nthreads) {
    const long long j = t < head ? t : tail0 + (t - head);
    s.add(load_bits<kBytes>(base + j * kBytes), (uint32_t)j);
  }
  __shared__ uint32_t part[2][kWarps];
  const uint32_t a = warp_sum(s.h1), b = warp_sum(s.h2);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    part[0][warp] = a;
    part[1][warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t t1 = 0u, t2 = 0u;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      t1 += part[0][w];
      t2 += part[1][w];
    }
    atomicAdd(out + 2 * row, t1);
    atomicAdd(out + 2 * row + 1, t2);
  }
}

// column tiles a row: enough blocks for the row's 16-byte chunks (or its
// scalar elements), at most kMaxBlocks over all n rows
inline int tiles_for(int n, long long d, int elem_bytes) {
  const long long per = 16 / elem_bytes;
  long long work = (d + per - 1) / per;
  if (work < 1) work = 1;
  long long b = (work + kThreads - 1) / kThreads;
  long long cap = kMaxBlocks / (n > 0 ? n : 1);
  if (cap < 1) cap = 1;
  if (b > cap) b = cap;
  return (int)b;
}

const draco_audit::Entry kAudit[] = {
    {"row_fingerprints_kernel<4>", (const void*)row_fingerprints_kernel<4>,
     kThreads, nullptr, 0},
    {"row_fingerprints_kernel<2>", (const void*)row_fingerprints_kernel<2>,
     kThreads, nullptr, 0},
};

}  // namespace

DRACO_AUDIT_EXPORTS(kAudit)

extern "C" {

// rows (n, d) of elem_bytes 4 (f32) or 2 (bf16); salts: 2 uint32 on the
// device; out: (n, 2) uint32, zeroed here on the stream, then summed into
int draco_row_fingerprints(const void* rows, const void* salts, void* out,
                           int n, long long d, int elem_bytes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (elem_bytes != 4 && elem_bytes != 2) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaMemsetAsync(out, 0, (size_t)n * 2 * sizeof(uint32_t), st);
  if (err != cudaSuccess) return (int)err;
  if (n < 1 || d < 1) return (int)cudaGetLastError();
  dim3 grid(tiles_for(n, d, elem_bytes), n);
  const unsigned char* r = (const unsigned char*)rows;
  const uint32_t* s = (const uint32_t*)salts;
  uint32_t* o = (uint32_t*)out;
  if (elem_bytes == 4)
    row_fingerprints_kernel<4><<<grid, kThreads, 0, st>>>(r, s, o, d);
  else
    row_fingerprints_kernel<2><<<grid, kThreads, 0, st>>>(r, s, o, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
