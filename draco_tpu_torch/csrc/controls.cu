// Negative controls of the port's kernel audit, by hand for Hopper
// (sm_90a). Plain C interface, loaded with ctypes by
// draco_tpu_torch/ops/controls.py; every launch goes on the caller's stream
// and the functions return cudaGetLastError().
//
// Each control seeds one defect that one rule of the audit
// (draco_tpu_torch/analysis/kernel_audit.py) exists to catch, so a run
// that finds it proves the rule is live:
//
//   control_mistiled_copy  <- the mis-tiled pallas_call `bad` of
//                             tools/tpu_attn_lowering_check.py (kern :107,
//                             pallas_call :111), the negative control of the
//                             TPU lowering audit. It copies x (16, 48) f32
//                             into o with a (4, 12) tile and a grid of 4:
//                             block i copies rows 4i..4i+3, columns 0..11,
//                             one thread per tile element. That is 48
//                             threads (not a multiple of the 32-lane warp)
//                             and 48-byte row segments; 192 of the 768
//                             outputs are written and 576 never are, as in
//                             the TPU kernel, whose BlockSpec index map
//                             (i, 0) never moves off the first column
//                             block. Trips the coverage rule.
//   control_overlaunch     a block of 1,200 threads, over the card's 1,024:
//                             the runtime refuses the launch with
//                             cudaErrorInvalidConfiguration (9), which the
//                             wrapper's _build.check must raise. Trips the
//                             launch-limit rule.
//   control_spill          __launch_bounds__(1024, 2) caps it at 32
//                             registers a thread, over a live array of 64
//                             floats indexed at run time: the array lives
//                             in local memory. Trips the resource rule.
//
// What bounds them: nothing here is timed against a roofline of its own;
// the mis-tiled copy moves 192 floats each way and is launch-bound.

#include <cuda_runtime.h>
#include <stdint.h>

#include "audit.cuh"

namespace {

constexpr int kTileRows = 4, kTileCols = 12, kGrid = 4;
constexpr int kMistiledThreads = kTileRows * kTileCols;  // 48
constexpr int kOverThreads = 1200;
constexpr int kSpillThreads = 1024;
constexpr int kSpillLive = 64;

__global__ void control_mistiled_copy_kernel(const float* __restrict__ x,
                                             float* __restrict__ o,
                                             int cols) {
  // the TPU kernel's block (4, 12) at block index (i, 0)
  const int r = blockIdx.x * kTileRows + threadIdx.x / kTileCols;
  const int c = threadIdx.x % kTileCols;
  o[(long long)r * cols + c] = x[(long long)r * cols + c];
}

__global__ void control_overlaunch_kernel(float* __restrict__ o,
                                          long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = 1.f;
}

// o[i] = Σ_k live[idx[(i + k) mod n] mod 64], live[k] = x[(i + k) mod n]·(k+1)
__global__ void __launch_bounds__(kSpillThreads, 2)
control_spill_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                     float* __restrict__ o, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float live[kSpillLive];
  for (int k = 0; k < kSpillLive; ++k)
    live[k] = x[(i + k) % n] * (float)(k + 1);
  float acc = 0.f;
  for (int k = 0; k < kSpillLive; ++k)
    acc += live[idx[(i + k) % n] & (kSpillLive - 1)];
  o[i] = acc;
}

const draco_audit::Entry kAudit[] = {
    {"control_mistiled_copy_kernel", (const void*)control_mistiled_copy_kernel,
     kMistiledThreads, nullptr, 0},
    {"control_overlaunch_kernel", (const void*)control_overlaunch_kernel,
     kOverThreads, nullptr, 0},
    {"control_spill_kernel", (const void*)control_spill_kernel, kSpillThreads,
     nullptr, 0},
};

}  // namespace

DRACO_AUDIT_EXPORTS(kAudit)

extern "C" {

// x, o: (kGrid·4, cols) f32 with cols >= 12; o keeps what it held outside
// the tiles the grid covers.
int draco_control_mistiled_copy(const float* x, float* o, int rows, int cols,
                                void* stream) {
  if (rows != kGrid * kTileRows || cols < kTileCols)
    return (int)cudaErrorInvalidValue;
  control_mistiled_copy_kernel<<<kGrid, kMistiledThreads, 0,
                                 (cudaStream_t)stream>>>(x, o, cols);
  return (int)cudaGetLastError();
}

int draco_control_overlaunch(float* o, long long n, void* stream) {
  if (n > 0) {
    const long long blocks = (n + kOverThreads - 1) / kOverThreads;
    control_overlaunch_kernel<<<(unsigned)blocks, kOverThreads, 0,
                                (cudaStream_t)stream>>>(o, n);
  }
  return (int)cudaGetLastError();
}

int draco_control_spill(const float* x, const int* idx, float* o, long long n,
                        void* stream) {
  if (n > 0) {
    const long long blocks = (n + kSpillThreads - 1) / kSpillThreads;
    control_spill_kernel<<<(unsigned)blocks, kSpillThreads, 0,
                           (cudaStream_t)stream>>>(x, idx, o, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
