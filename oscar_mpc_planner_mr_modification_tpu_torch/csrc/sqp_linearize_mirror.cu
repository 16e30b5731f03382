// The fused kernel's linearize entry under the "mirror" regularization, for
// Hopper (sm_90a): the variant of sqp_fused.cu's sqp_fused_linearize entry
// for tables whose regularization is REG_MIRROR, compiled for each model of
// tmpc_ocp.cuh::with_model. It is its own source so that nvcc builds it
// beside sqp_fused.cu, not after it, and so that the fused solve carries
// none of its code.
//
// Replaces, on the per-iteration fleet path, the JAX package's build_qp
// under "mirror" (ops/sqp.py: the linearization and _mirror_regularize's
// eigh around the TPU kernel ops/qp_pallas.py): every stage's Hessian is
// replaced, before it is packed, by V max(|w|, reg_eps) V^T by Jacobi (the
// whole block for t < N, the x block at N; a block with a non-finite entry
// becomes NaN). The QP fields go to a field-major (fields, Bt) buffer in
// global memory, which the QP kernel's field entry reads where it lies, and
// the iterate's (merit, cost, eq_res) to (3, Bt).
//
// Two designs; the width follows the batch:
// - the block design (mirror_block.cuh): one problem per block, each stage
//   on a group of 8 or 16 lanes (a direction of the jets, a row and column
//   of the Jacobi per lane), the Jacobi parallel-ordered, the problem's
//   inputs and tables in shared memory. It runs while the batch fits one
//   wave of its blocks (132 SMs times the blocks resident per SM) and T * G
//   fits MIRROR_BLOCK_MAX threads: the ticks' 4-5 problems and the fleets
//   up to a few hundred.
// - the one-warp design (sqp_fused.cuh linearize_column with MIRROR): lane
//   t linearizes stage t and runs its cyclic Jacobi (mirror.cuh) in local
//   memory; for larger batches, where the card is full of warps anyway.
//
// The kernels allocate nothing and do not synchronize. Each extern "C"
// entry returns cudaGetLastError() after the launch, -1 when a size is out
// of range, -2 when no block fits the card's shared memory, -3 for a model
// id with no instantiation, -4 when the tables' regularization is not
// REG_MIRROR, or -5 when the block design was asked for at sizes it does
// not take.

#include "parts.cuh"

#if !defined(TMPC_DISPATCH)
#include "mirror_block.cuh"

namespace {

// How a launch maps problems: by the batch (the entries' default), one
// warp per problem, or one block per problem.
enum { MAP_BATCH = 0, MAP_WARP = 1, MAP_BLOCK = 2 };

// The block design's plan at T stages and m rows: warps per block, shared
// memory per block, blocks resident per SM, registers, local memory; err -5
// when T * G exceeds MIRROR_BLOCK_MAX threads.
template <typename real, class M>
warp::LaunchPlan block_plan(int T, int m) {
  auto kern = mirror_block_kernel<real, M>;
  return warp::remembered_plan(kern, T, m, 0, 0, [&] {
    const MirrorBlockLayout<M> Y(T, m);
    warp::LaunchPlan p{Y.threads / WIDTH, (int)Y.template bytes<real>(), 0,
                       0, 0, 0};
    if (Y.lin_threads > MIRROR_BLOCK_MAX) {
      p.err = -5;
      return p;
    }
    int dev = 0, optin = 0, blocks = 0;
    cudaFuncAttributes attr;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess && p.bytes > optin) {
      p.err = -2;
      return p;
    }
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern,
                                                          Y.threads, p.bytes);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kern);
    if (err != cudaSuccess) {
      cudaGetLastError();
      p.err = (int)err;
      return p;
    }
    p.per_sm = blocks;
    p.regs = attr.numRegs;
    p.local_bytes = (int)attr.localSizeBytes;
    return p;
  });
}

// The design a launch of Bt problems takes (MAP_WARP or MAP_BLOCK) and its
// plan; `mapping` MAP_BATCH picks by the batch, else it is the caller's.
template <typename real, class M>
int pick_design(int mapping, int Bt, int T, int m, warp::LaunchPlan* plan) {
  if (mapping != MAP_WARP) {
    *plan = block_plan<real, M>(T, m);
    if (plan->err == 0 && mapping == MAP_BATCH) {
      int dev = 0, sms = 0;
      cudaError_t err = cudaGetDevice(&dev);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err != cudaSuccess) {
        cudaGetLastError();
        plan->err = (int)err;
        return MAP_BLOCK;
      }
      if ((long long)Bt <= (long long)sms * plan->per_sm) return MAP_BLOCK;
    } else if (plan->err != -5 || mapping == MAP_BLOCK) {
      return MAP_BLOCK;  // the block design, or its plan's error
    }
  }
  *plan = linearize_plan<real, M, true>(T);
  return MAP_WARP;
}

template <typename real>
int launch_mirror(const void* P, const void* x0, const void* Z, void* qp,
                  void* merit_out, const void* itab, const void* rtab, int Bt,
                  int T, int m, int mh, int model, int reg, int mapping,
                  void* stream) {
  if (qp == nullptr || mapping < MAP_BATCH || mapping > MAP_BLOCK) return -1;
  if (reg != tmpc::REG_MIRROR) return -4;
  if (!fused_sizes_ok(Bt, T, m, mh)) return -1;
  return tmpc::with_model(model, [&](auto mdl) {
    using M = decltype(mdl);
    warp::LaunchPlan p;
    if (pick_design<real, M>(mapping, Bt, T, m, &p) == MAP_WARP)
      return launch_linearize<real, true>(P, x0, Z, qp, merit_out, itab, rtab,
                                          Bt, T, m, mh, model, reg, stream);
    if (p.err != 0) return p.err;
    mirror_block_kernel<real, M>
        <<<Bt, p.warps * WIDTH, p.bytes, (cudaStream_t)stream>>>(
            (const real*)P, (const real*)x0, (const real*)Z, (real*)qp,
            (real*)merit_out, (const int*)itab, (const double*)rtab,
            tmpc::QpLayout<M>(T, m, mh), Bt);
    return (int)cudaGetLastError();
  });
}

#ifdef LIN_SECTIONS
__global__ void take_lin_sections(unsigned long long* out) {
  for (int k = 0; k < tmpc::LIN_SEC_COUNT; ++k) {
    out[k] = tmpc::lin_sections[k];
    tmpc::lin_sections[k] = 0;
  }
}
#endif

}  // namespace

extern "C" {

// The one-warp design's launch plan (warp.cuh plan_out, 6 ints) of the
// entry (f64: 0/1) for model id `model` at T stages; err -3 for a model
// with no instantiation.
void TMPC_ENTRY(sqp_linearize_mirror_launch_info)(int f64, int model, int T,
                                                  int* out) {
  warp::LaunchPlan l{0, 0, 0, 0, 0, -3};
  tmpc::with_model(model, [&](auto mdl) {
    using M = decltype(mdl);
    l = f64 ? linearize_plan<double, M, true>(T)
            : linearize_plan<float, M, true>(T);
    return 0;
  });
  warp::plan_out(l, out);
}

// The design (MAP_WARP 1 or MAP_BLOCK 2) and plan (6 ints, as above) of a
// launch of `problems` problems at T stages and m rows under `mapping`
// (MAP_BATCH 0, or the design asked for): 7 ints; err -3 for a model with
// no instantiation.
void TMPC_ENTRY(sqp_linearize_mirror_plan)(int f64, int model, int T, int m,
                                           int problems, int mapping,
                                           int* out) {
  warp::LaunchPlan l{0, 0, 0, 0, 0, -3};
  int design = 0;
  tmpc::with_model(model, [&](auto mdl) {
    using M = decltype(mdl);
    design = f64 ? pick_design<double, M>(mapping, problems, T, m, &l)
                 : pick_design<float, M>(mapping, problems, T, m, &l);
    return 0;
  });
  out[0] = design;
  warp::plan_out(l, out + 1);
}

// The arguments of sqp_fused.cu's sqp_fused_linearize entries; qp must not
// be null (the merit terms alone are that entry's). The design follows the
// batch.
#define MIRROR_ENTRY(NAME, REAL)                                              \
  int TMPC_ENTRY(NAME)(                                                      \
           const void* P, const void* x0, const void* Z, void* qp,            \
           void* merit_out, const void* itab, const void* rtab, int Bt,       \
           int T, int m, int mh, int model, int reg, void* stream) {          \
    return launch_mirror<REAL>(P, x0, Z, qp, merit_out, itab, rtab, Bt, T, m, \
                               mh, model, reg, MAP_BATCH, stream);            \
  }

MIRROR_ENTRY(sqp_linearize_mirror_f32, float)
MIRROR_ENTRY(sqp_linearize_mirror_f64, double)

// The same with the design named (`mapping`: MAP_BATCH 0, MAP_WARP 1,
// MAP_BLOCK 2), for the tools that time one design against the other.
#define MIRROR_AS_ENTRY(NAME, REAL)                                           \
  int TMPC_ENTRY(NAME)(                                                      \
           const void* P, const void* x0, const void* Z, void* qp,            \
           void* merit_out, const void* itab, const void* rtab, int Bt,       \
           int T, int m, int mh, int model, int reg, int mapping,             \
           void* stream) {                                                    \
    return launch_mirror<REAL>(P, x0, Z, qp, merit_out, itab, rtab, Bt, T, m, \
                               mh, model, reg, mapping, stream);              \
  }

MIRROR_AS_ENTRY(sqp_linearize_mirror_as_f32, float)
MIRROR_AS_ENTRY(sqp_linearize_mirror_as_f64, double)

#ifdef LIN_SECTIONS
// The section counters (tmpc_ocp.cuh LIN_SEC_*, LIN_SEC_COUNT of them)
// summed over the launches since the last call, copied into the device
// buffer `out` by a one-thread kernel on `stream`, then zeroed. Returns
// cudaGetLastError().
int sqp_linearize_mirror_sections(void* out, void* stream) {
  take_lin_sections<<<1, 1, 0, (cudaStream_t)stream>>>(
      (unsigned long long*)out);
  return (int)cudaGetLastError();
}
#endif

}  // extern "C"

#else  // TMPC_DISPATCH: the entries, each calling its model's part

extern "C" {

#define MIRROR_PARAMS                                                        \
  (const void* P, const void* x0, const void* Z, void* qp, void* merit_out,   \
   const void* itab, const void* rtab, int Bt, int T, int m, int mh,         \
   int model, int reg, void* stream)
#define MIRROR_ARGS \
  (P, x0, Z, qp, merit_out, itab, rtab, Bt, T, m, mh, model, reg, stream)
#define MIRROR_AS_PARAMS                                                     \
  (const void* P, const void* x0, const void* Z, void* qp, void* merit_out,   \
   const void* itab, const void* rtab, int Bt, int T, int m, int mh,         \
   int model, int reg, int mapping, void* stream)
#define MIRROR_AS_ARGS                                                       \
  (P, x0, Z, qp, merit_out, itab, rtab, Bt, T, m, mh, model, reg, mapping,    \
   stream)

TMPC_DISPATCH_FN(void, sqp_linearize_mirror_launch_info,
                 (int f64, int model, int T, int* out), (f64, model, T, out),
                 model)
TMPC_DISPATCH_FN(void, sqp_linearize_mirror_plan,
                 (int f64, int model, int T, int m, int problems, int mapping,
                  int* out),
                 (f64, model, T, m, problems, mapping, out), model)
TMPC_DISPATCH_FN(int, sqp_linearize_mirror_f32, MIRROR_PARAMS, MIRROR_ARGS,
                 model)
TMPC_DISPATCH_FN(int, sqp_linearize_mirror_f64, MIRROR_PARAMS, MIRROR_ARGS,
                 model)
TMPC_DISPATCH_FN(int, sqp_linearize_mirror_as_f32, MIRROR_AS_PARAMS,
                 MIRROR_AS_ARGS, model)
TMPC_DISPATCH_FN(int, sqp_linearize_mirror_as_f64, MIRROR_AS_PARAMS,
                 MIRROR_AS_ARGS, model)

}  // extern "C"

#endif  // TMPC_DISPATCH
