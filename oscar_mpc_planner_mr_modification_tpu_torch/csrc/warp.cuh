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
  // A phase whose lanes exchange values in registers by shuffles, which
  // synchronize them: f(lane) with no barrier around it.
  template <class F>
  __device__ __forceinline__ void regs(F&& f) const {
    f(lane);
  }
  __device__ __forceinline__ void sync() const { __syncwarp(); }
#else
  template <class F>
  void run(F&& f) const {
    for (int l = 0; l < WIDTH; ++l) f(l);
  }
  template <class F>
  void regs(F&& f) const {
    for (int l = 0; l < WIDTH; ++l) f(l);
  }
  void sync() const {}
  template <class F>
  void one(F&& f) const {
    f();
  }
#endif
};

// The threads that solve one problem of the single-instance kernel
// (sqp_single.cuh): the W warps of a block on the card, W x 32 emulated
// threads on the host. Warp 0 is the chain warp: it runs the sequential
// sweeps as a lane group (`lanes()`, the Lanes above) while warps 1..W-1,
// the rest, work on what does not depend on them; warp 1, the follower,
// may then trail the chain warp through a sweep.
//
// `run(f)` calls f(thread) on every thread, then synchronizes the block;
// `run_rest(f)` calls f(thread) on the rest's threads only, then
// synchronizes the rest (named barrier 1, so that the chain warp is not
// held). Code between phases is uniform across the block: every thread
// computes the same value from shared memory and writes nothing there, so
// shared memory read between phases is written again only after the next
// phase's barrier. `chain()`, `rest()` and `follower()` guard the parts of
// an overlap; `sync()` joins them. On the host, run and run_rest are serial
// loops in thread order, chain(), rest() and follower() are all true (in
// that order the parts run) and sync() does nothing,
// so the host executes the card's partition in the card's reduction order.
struct Block {
  int W;    // warps
  int tid;  // this thread (card only)
  WARP_FN int threads() const { return W * WIDTH; }
#if defined(__CUDACC__)
  template <class F>
  __device__ __forceinline__ void run(F&& f) const {
    f(tid);
    __syncthreads();
  }
  template <class F>
  __device__ __forceinline__ void run_rest(F&& f) const {
    f(tid);
    asm volatile("bar.sync 1, %0;" ::"r"((W - 1) * WIDTH) : "memory");
  }
  // f(thread) on every thread, then the block synchronized; true where
  // f returned true on any thread.
  template <class F>
  __device__ __forceinline__ bool any(F&& f) const {
    return __syncthreads_or(f(tid)) != 0;
  }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
  __device__ __forceinline__ bool chain() const { return tid < WIDTH; }
  __device__ __forceinline__ bool rest() const { return tid >= WIDTH; }
  __device__ __forceinline__ bool follower() const {
    return tid / WIDTH == 1;
  }
  __device__ __forceinline__ Lanes lanes() const { return Lanes{tid % WIDTH}; }
#else
  template <class F>
  void run(F&& f) const {
    for (int t = 0; t < W * WIDTH; ++t) f(t);
  }
  template <class F>
  void run_rest(F&& f) const {
    for (int t = WIDTH; t < W * WIDTH; ++t) f(t);
  }
  template <class F>
  bool any(F&& f) const {
    bool r = false;
    for (int t = 0; t < W * WIDTH; ++t) {
      const bool v = f(t);
      r = r || v;
    }
    return r;
  }
  void sync() const {}
  bool chain() const { return true; }
  bool rest() const { return true; }
  bool follower() const { return true; }
  Lanes lanes() const { return Lanes{}; }
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

// make() (a LaunchPlan, which sets the kernel's dynamic shared memory
// limit to its bytes), made once per kernel, device and key (k0..k3: what
// the plan depends on) and remembered: a plan depends on nothing else, and
// making one costs attribute calls and occupancy queries. On a remembered
// plan only the kernel's dynamic shared memory limit is set again, and
// only when another plan of the kernel set it last. A failed plan is not
// remembered.
template <class Kernel, class Make>
LaunchPlan remembered_plan(Kernel kern, int k0, int k1, int k2, int k3,
                           Make&& make) {
  using Fn = std::pair<const void*, int>;
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int, int, int>, LaunchPlan>
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
  const auto it = plans.find(std::make_tuple(k, dev, k0, k1, k2, k3));
  if (it == plans.end()) {
    const LaunchPlan p = make();
    if (p.err == 0) {
      plans.emplace(std::make_tuple(k, dev, k0, k1, k2, k3), p);
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

// plan_launch(kern, bytes), remembered as remembered_plan says; bytes(W) is
// a block's dynamic shared memory, which depends on k0, k1, k2.
template <class Kernel, class Bytes>
LaunchPlan cached_plan(Kernel kern, int k0, int k1, int k2, Bytes bytes) {
  return remembered_plan(kern, k0, k1, k2, 0,
                         [&] { return plan_launch(kern, bytes); });
}

// A LaunchPlan as 6 ints: warps, bytes, per_sm, regs, local_bytes, err.
inline void plan_out(const LaunchPlan& p, int* out) {
  const int v[6] = {p.warps, p.bytes, p.per_sm, p.regs, p.local_bytes, p.err};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
}
#endif

}  // namespace warp
