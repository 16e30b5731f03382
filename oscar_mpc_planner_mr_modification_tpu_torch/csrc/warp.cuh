// The lane group that solves one problem: the 32 lanes of a warp on the
// card, 32 emulated lanes on the host.
//
// Per-problem code is written as phases over lanes: `L.run(f)` calls f(lane)
// for every lane, with the lanes synchronized before and after the phase, so
// that a phase reads what earlier phases wrote. What one lane computes for
// others lives in memory (shared memory on the card), not in its registers.
// Code between phases is uniform: every lane of a warp runs it on the same
// values read from shared memory, so it computes the same result and takes
// the same branch; it reads memory and writes only through `L.one(f)`
// (lane 0 on the card). That is where the ordered reductions go: the
// per-row or per-stage partials a phase wrote are combined in the serial
// code's order; and where a short chain of small vector products runs
// faster computed alike by every lane than spread over lanes with a sync
// between products.
//
// On the card `run` is f(lane) between two __syncwarp(). On the host
// (compiled with a plain C++ compiler) `run` is a serial loop over the 32
// lanes, and uniform code runs once: the host executes the card's partition
// of the work in the card's reduction order, and counts each operation of
// the algorithm once.

#pragma once

#if defined(__CUDACC__)
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>
#include <utility>
#define WARP_FN __device__ __forceinline__
#define WARP_UNROLL _Pragma("unroll")
#else  // host build: the CUDA qualifiers mean nothing
#define __host__
#define __device__
#define __forceinline__ inline
#define WARP_FN inline
#define WARP_UNROLL
#endif

namespace warp {

constexpr int WIDTH = 32;

struct Lanes {
#if defined(__CUDACC__)
  int lane;
  template <class F>
  __device__ __forceinline__ void run(F&& f) const {
    __syncwarp();
    f(lane);
    __syncwarp();
  }
  // f() once for the group, from uniform code: lane 0 stores what the
  // lanes computed alike. Other lanes read it after the next run().
  template <class F>
  __device__ __forceinline__ void one(F&& f) const {
    if (lane == 0) f();
  }
#else
  template <class F>
  void run(F&& f) const {
    for (int l = 0; l < WIDTH; ++l) f(l);
  }
  template <class F>
  void one(F&& f) const {
    f();
  }
#endif
};

#if defined(__CUDACC__)
// How a kernel with one warp per problem launches: warps (problems) per
// block, dynamic shared memory per block, problems resident per SM, the
// kernel's registers per thread and local memory per thread, and err: 0, a
// CUDA error, or -2 when no block fits the card's shared memory.
struct LaunchPlan {
  int warps, bytes, per_sm, regs, local_bytes, err;
};

// Of blocks of 4, 2 and 1 warps, the one with the most problems resident
// per SM (the larger block on a tie); bytes(W) is a block's dynamic shared
// memory. Sets the kernel's dynamic shared memory limit to the plan's.
template <class Kernel, class Bytes>
LaunchPlan plan_launch(Kernel kern, Bytes bytes) {
  int dev = 0, optin = 0;
  LaunchPlan best{0, 0, 0, 0, 0, -2};
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  for (int W = 4; W >= 1 && err == cudaSuccess; W /= 2) {
    const size_t nb = bytes(W);
    if (nb > (size_t)optin) continue;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)nb);
    int blocks = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern,
                                                          W * WIDTH, nb);
    if (err == cudaSuccess && blocks * W > best.per_sm)
      best = LaunchPlan{W, (int)nb, blocks * W, 0, 0, 0};
  }
  cudaFuncAttributes attr;
  if (err == cudaSuccess && best.err == 0)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               best.bytes);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) {
    cudaGetLastError();
    best.err = (int)err;
    return best;
  }
  best.regs = attr.numRegs;
  best.local_bytes = (int)attr.localSizeBytes;
  return best;
}

// plan_launch(kern, bytes), made once per kernel, device and sizes (k0, k1,
// k2: what bytes() depends on) and remembered: a plan depends on nothing
// else, and making one costs attribute calls and occupancy queries. On a
// remembered plan only the kernel's dynamic shared memory limit is set
// again, and only when another plan of the kernel set it last. A failed
// plan is not remembered.
template <class Kernel, class Bytes>
LaunchPlan cached_plan(Kernel kern, int k0, int k1, int k2, Bytes bytes) {
  using Fn = std::pair<const void*, int>;
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int, int>, LaunchPlan>
      plans;
  static std::map<Fn, int> limit;  // last dynamic shared memory limit set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return LaunchPlan{0, 0, 0, 0, 0, (int)err};
  }
  const void* k = (const void*)kern;
  const std::lock_guard<std::mutex> lock(mu);
  const auto it = plans.find(std::make_tuple(k, dev, k0, k1, k2));
  if (it == plans.end()) {
    const LaunchPlan p = plan_launch(kern, bytes);
    if (p.err == 0) {
      plans.emplace(std::make_tuple(k, dev, k0, k1, k2), p);
      limit[Fn{k, dev}] = p.bytes;
    } else {
      limit.erase(Fn{k, dev});  // the limit is unknown now
    }
    return p;
  }
  LaunchPlan p = it->second;
  int& set = limit[Fn{k, dev}];
  if (set != p.bytes) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               p.bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();
      limit.erase(Fn{k, dev});
      p.err = (int)err;
      return p;
    }
    set = p.bytes;
  }
  return p;
}

// A LaunchPlan as 6 ints: warps, bytes, per_sm, regs, local_bytes, err.
inline void plan_out(const LaunchPlan& p, int* out) {
  const int v[6] = {p.warps, p.bytes, p.per_sm, p.regs, p.local_bytes, p.err};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
}
#endif

}  // namespace warp
