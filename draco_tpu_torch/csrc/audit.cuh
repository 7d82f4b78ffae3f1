// The resource query every source of csrc/ exports for the kernel audit
// (draco_tpu_torch/analysis/kernel_audit.py). Each source lists its
// __global__ functions in a table of Entry and defines, in C:
//
//   int         draco_audit_count(void);
//   const char* draco_audit_name(int which);
//   int         draco_audit_kernel(int which, long long a, long long b,
//                                  long long* out);
//
// draco_audit_kernel fills out[kOutLen] from the library as built: what
// cudaFuncGetAttributes reports for the function (registers, local and
// static shared bytes), the block and the dynamic shared memory its
// launcher uses at the shape (a, b) — the same helper the launcher calls —
// and the resident blocks a SM that launch gives. Every library is its own
// ctypes handle (RTLD_LOCAL), so the three names repeat across sources.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace draco_audit {

enum Out {
  kRegs = 0,        // registers a thread
  kLocal = 1,       // local (spill and stack) bytes a thread
  kStatic = 2,      // static shared bytes a block
  kConst = 3,       // constant bytes
  kMaxThreads = 4,  // the most threads a block the function can launch with
  kThreads = 5,     // threads a block the launcher uses
  kDynamic = 6,     // dynamic shared bytes the launcher asks for at (a, b)
  kOptIn = 7,       // 1 if the launcher raises the 48 KB dynamic limit
  kResident = 8,    // resident blocks a SM at that launch (0: cannot launch)
  kBinary = 9,      // the binary's compute capability, e.g. 90
  kOutLen = 10
};

// dynamic shared bytes of one launch at shape (a, b); null: none
typedef size_t (*SmemFn)(long long a, long long b);

struct Entry {
  const char* name;  // the __global__ function, with its template argument
  const void* fn;
  int threads;
  SmemFn smem;
  int opt_in;
};

constexpr size_t kDefaultDynamicLimit = 48 * 1024;

inline int fill(const Entry& e, long long a, long long b, long long* out) {
  cudaFuncAttributes at;
  cudaError_t err = cudaFuncGetAttributes(&at, e.fn);
  if (err != cudaSuccess) return (int)err;
  const size_t dyn = e.smem ? e.smem(a, b) : 0;
  out[kRegs] = at.numRegs;
  out[kLocal] = (long long)at.localSizeBytes;
  out[kStatic] = (long long)at.sharedSizeBytes;
  out[kConst] = (long long)at.constSizeBytes;
  out[kMaxThreads] = at.maxThreadsPerBlock;
  out[kThreads] = e.threads;
  out[kDynamic] = (long long)dyn;
  out[kOptIn] = e.opt_in;
  out[kBinary] = at.binaryVersion;
  int blocks = 0;
  if (e.threads <= at.maxThreadsPerBlock) {
    if (e.opt_in && dyn > kDefaultDynamicLimit) {
      err = cudaFuncSetAttribute(e.fn,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)dyn);
      if (err != cudaSuccess) return (int)err;
    }
    // a configuration that cannot launch reports an error here: it is
    // counted as 0 resident blocks, and the error is cleared
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, e.fn,
                                                      e.threads, dyn) !=
        cudaSuccess) {
      cudaGetLastError();
      blocks = 0;
    }
  }
  out[kResident] = blocks;
  return (int)cudaSuccess;
}

}  // namespace draco_audit

#define DRACO_AUDIT_EXPORTS(TABLE)                                          \
  extern "C" int draco_audit_count(void) {                                  \
    return (int)(sizeof(TABLE) / sizeof(TABLE[0]));                         \
  }                                                                         \
  extern "C" const char* draco_audit_name(int which) {                      \
    if (which < 0 || which >= draco_audit_count()) return nullptr;          \
    return TABLE[which].name;                                               \
  }                                                                         \
  extern "C" int draco_audit_kernel(int which, long long a, long long b,    \
                                    long long* out) {                       \
    if (which < 0 || which >= draco_audit_count())                          \
      return (int)cudaErrorInvalidValue;                                    \
    return draco_audit::fill(TABLE[which], a, b, out);                      \
  }
