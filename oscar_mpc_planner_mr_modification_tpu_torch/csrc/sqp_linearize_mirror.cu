// The fused kernel's linearize entry under the "mirror" regularization, for
// Hopper (sm_90a), one warp per problem: the variant of sqp_fused.cu's
// sqp_fused_linearize entry for tables whose regularization is REG_MIRROR,
// compiled for each model of tmpc_ocp.cuh::with_model. It is its own source
// so that nvcc builds it beside sqp_fused.cu, not after it, and so that the
// fused solve carries none of its code.
//
// Replaces, on the per-iteration fleet path, the JAX package's build_qp
// under "mirror" (ops/sqp.py: the linearization and _mirror_regularize's
// eigh around the TPU kernel ops/qp_pallas.py). Lane t linearizes stage t
// (tmpc_ocp.cuh::linearize_stage with MIRROR) and, before the stage's
// Hessian is packed, replaces it by V max(|w|, reg_eps) V^T by cyclic
// Jacobi (mirror.cuh, the arithmetic the single-instance kernel runs): the
// whole block for t < N, the x block at N; a block with a non-finite entry
// becomes NaN. The QP fields go to a field-major (fields, Bt) buffer in
// global memory, which the QP kernel's field entry reads where it lies, and
// the iterate's (merit, cost, eq_res) to (3, Bt).
//
// Each lane keeps its dense stage Hessian and the Jacobi's two NZ x NZ
// blocks in local memory (3 * 81 reals at nz = 9); the reduction array of
// the merit is in shared memory, as in the sqp_fused entry.
//
// The kernel allocates nothing and does not synchronize. Each extern "C"
// entry returns cudaGetLastError() after the launch, -1 when a size is out
// of range, -2 when no block fits the card's shared memory, -3 for a model
// id with no instantiation, or -4 when the tables' regularization is not
// REG_MIRROR.

#include "sqp_fused.cuh"

extern "C" {

// The launch plan (warp.cuh plan_out, 6 ints) of the entry (f64: 0/1) for
// model id `model` at T stages; err -3 for a model with no instantiation.
void sqp_linearize_mirror_launch_info(int f64, int model, int T, int* out) {
  warp::LaunchPlan l{0, 0, 0, 0, 0, -3};
  tmpc::with_model(model, [&](auto mdl) {
    using M = decltype(mdl);
    l = f64 ? linearize_plan<double, M, true>(T)
            : linearize_plan<float, M, true>(T);
    return 0;
  });
  warp::plan_out(l, out);
}

// The arguments of sqp_fused.cu's sqp_fused_linearize entries; qp must not
// be null (the merit terms alone are that entry's).
#define MIRROR_ENTRY(NAME, REAL)                                              \
  int NAME(const void* P, const void* x0, const void* Z, void* qp,            \
           void* merit_out, const void* itab, const void* rtab, int Bt,       \
           int T, int m, int mh, int model, int reg, void* stream) {          \
    if (qp == nullptr) return -1;                                             \
    if (reg != tmpc::REG_MIRROR) return -4;                                   \
    return launch_linearize<REAL, true>(P, x0, Z, qp, merit_out, itab, rtab,  \
                                        Bt, T, m, mh, model, reg, stream);    \
  }

MIRROR_ENTRY(sqp_linearize_mirror_f32, float)
MIRROR_ENTRY(sqp_linearize_mirror_f64, double)

}  // extern "C"
