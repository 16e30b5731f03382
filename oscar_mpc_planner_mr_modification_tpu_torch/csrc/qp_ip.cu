// Batched stagewise Mehrotra predictor-corrector interior-point QP solver
// for Hopper (sm_90a).
//
// Replaces the TPU kernel of the JAX package, ops/qp_pallas.py::_qp_kernel
// -> _ip_solve, in its three configurations: cold and z-only (the entries
// qp_ip_solve_*, behind solve_qp_batched and solve_qp_lanes), and with the
// final multipliers out, optionally warm-started from given ones (the
// entries qp_ip_solve_duals_*, behind solve_qp_batched_duals). The
// algorithm is the same, step for step: cold start s0 = max(e, sqrt(mu0)),
// lam0 = mu0 / s0, or the warm start s0 = max(e, 10 sqrt(mu_min)),
// lam0 = clip(lam_given, mu_min, w_max), after which the freeze waits one
// iteration; one Riccati factorization of Hbar = H + D^T W D per
// iteration shared by the affine predictor and the corrector; closed-form SPD
// inverse of Quu (nu <= 3); separate primal/dual fraction-to-boundary steps;
// sigma = (comp_aff / comp)^3 clipped to [1e-8, 1]; a W clamp at w_max and a
// slack floor; a per-problem freeze once comp, feas and the equality residual
// are below tolerance, or when the step is NaN. Box rows (one +-1 entry) are
// analytic (diagonal Hbar update); generic rows contract their column support
// pairs. With no active row the QP is equality constrained and one exact
// Riccati solve from z = 0 finishes it.
//
// Mapping: one thread per problem, 32 threads per block, so that the fleet
// step's 4608 problems spread over all 132 SMs. Every per-problem array
// (inputs, output and scratch: s, lam, cached row residuals and steps, Hbar,
// the K / Linv / Qux / P factors) lives in global memory in a field-major
// (fields, B) layout, so that neighbouring threads touch neighbouring
// addresses and every load and store coalesces. Small per-stage temporaries
// of the Riccati sweep are thread-local arrays sized by QP_MAX_NX/QP_MAX_NU.
//
// What bounds it: occupancy and latency. 4608 threads are about one warp per
// SM, so there is little to hide the latency of the scratch traffic, which
// goes through L1/L2 (about 5k fields per problem). The next design
// (a warp or small thread group per problem, its state in shared memory,
// lanes sharing the stage- and row-parallel passes and the nx x nx blocks of
// the Riccati sweep) is the later step; this kernel is the simple, exact one.
//
// The per-problem solve, ip_solve_problem(), lives in qp_ip.cuh: this file's
// kernel is one thread per problem around it, and the fused whole-SQP kernel
// (sqp_fused.cu) calls it once per SQP iteration.
//
// The kernel allocates nothing and does not synchronize: the caller passes
// the scratch buffer (sized by qp_ip_scratch_fields) and the stream. Each
// extern "C" entry returns cudaGetLastError() after the launch, or -1 when a
// size is out of range.

#include "qp_ip.cuh"

namespace {

template <typename real, bool duals>
__global__ void __launch_bounds__(QP_THREADS)
qp_ip_kernel(const real* __restrict__ Htri, const real* __restrict__ g,
             const real* __restrict__ A, const real* __restrict__ Bm,
             const real* __restrict__ c, const real* __restrict__ D,
             const real* __restrict__ e, const real* __restrict__ r0,
             const real* __restrict__ mask, const int* __restrict__ rinfo,
             const int* __restrict__ pairs, real* __restrict__ z_out,
             const real* __restrict__ lam0, real* __restrict__ lam_out,
             real* __restrict__ scratch, Sizes sz, int any_active, int n_iters,
             real mu0, real mu_min, real tau, real w_max, real s_floor,
             real s_wfloor, real tol_freeze, real tol100, real n_act) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= sz.Bt) return;
  // Without `duals` the pointers are compile-time null: the cold z-only
  // kernel carries no code of the dual variants.
  ip_solve_problem<real>(Htri, g, A, Bm, c, D, e, r0, mask, rinfo, pairs,
                         z_out, duals ? lam0 : nullptr,
                         duals ? lam_out : nullptr, scratch, sz, b, any_active,
                         n_iters, mu0, mu_min, tau, w_max, s_floor, s_wfloor,
                         tol_freeze, tol100, n_act);
}

template <typename real, bool duals>
int launch(const void* H, const void* g, const void* A, const void* Bm,
           const void* c, const void* D, const void* e, const void* r0,
           const void* mask, const void* rinfo, const void* pairs, void* z,
           const void* lam0, void* lam_out, void* scratch, int Bt, int T,
           int nz, int nx, int nu, int m, int mhp, int nU, int any_active,
           int n_iters, double mu0, double mu_min, double tau, double w_max,
           double s_floor, double tol_freeze, double n_act, void* stream) {
  if (Bt < 1 || T < 2 || nx < 1 || nx > QP_MAX_NX || nu < 1 || nu > QP_MAX_NU ||
      nz != nx + nu || m < 1 || mhp < 1 || nU < 1 || (duals && !lam_out))
    return -1;
  Sizes sz{Bt, T, nz, nx, nu, m, mhp, nU, nz * (nz + 1) / 2};
  const int blocks = (Bt + QP_THREADS - 1) / QP_THREADS;
  qp_ip_kernel<real, duals><<<blocks, QP_THREADS, 0, (cudaStream_t)stream>>>(
      (const real*)H, (const real*)g, (const real*)A, (const real*)Bm,
      (const real*)c, (const real*)D, (const real*)e, (const real*)r0,
      (const real*)mask, (const int*)rinfo, (const int*)pairs, (real*)z,
      (const real*)lam0, (real*)lam_out, (real*)scratch, sz, any_active,
      n_iters, real(mu0), real(mu_min), real(tau), real(w_max), real(s_floor),
      real(10.0 * sqrt(mu_min)), real(tol_freeze), real(100.0 * tol_freeze),
      real(n_act));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int qp_ip_scratch_fields(int T, int nz, int nx, int nu, int m) {
  return Scratch(T, nz, nx, nu, m).total;
}

#define QP_ENTRY(NAME, REAL)                                                   \
  int NAME(const void* H, const void* g, const void* A, const void* Bm,        \
           const void* c, const void* D, const void* e, const void* r0,        \
           const void* mask, const void* rinfo, const void* pairs, void* z,    \
           void* scratch, int Bt, int T, int nz, int nx, int nu, int m,        \
           int mhp, int nU, int any_active, int n_iters, double mu0,           \
           double mu_min, double tau, double w_max, double s_floor,           \
           double tol_freeze, double n_act, void* stream) {                    \
    return launch<REAL, false>(H, g, A, Bm, c, D, e, r0, mask, rinfo, pairs,   \
                               z, nullptr, nullptr, scratch, Bt, T, nz, nx,    \
                               nu, m, mhp, nU, any_active, n_iters, mu0,       \
                               mu_min, tau, w_max, s_floor, tol_freeze, n_act, \
                               stream);                                        \
  }

// As QP_ENTRY, plus the final multipliers into lam_out (T*m, Bt) and, when
// lam0 (T*m, Bt) is not null, the warm start from it.
#define QP_DUALS_ENTRY(NAME, REAL)                                             \
  int NAME(const void* H, const void* g, const void* A, const void* Bm,        \
           const void* c, const void* D, const void* e, const void* r0,        \
           const void* mask, const void* rinfo, const void* pairs, void* z,    \
           const void* lam0, void* lam_out, void* scratch, int Bt, int T,      \
           int nz, int nx, int nu, int m, int mhp, int nU, int any_active,     \
           int n_iters, double mu0, double mu_min, double tau, double w_max,   \
           double s_floor, double tol_freeze, double n_act, void* stream) {    \
    return launch<REAL, true>(H, g, A, Bm, c, D, e, r0, mask, rinfo, pairs, z, \
                              lam0, lam_out, scratch, Bt, T, nz, nx, nu, m,    \
                              mhp, nU, any_active, n_iters, mu0, mu_min, tau,  \
                              w_max, s_floor, tol_freeze, n_act, stream);      \
  }

QP_ENTRY(qp_ip_solve_f32, float)
QP_ENTRY(qp_ip_solve_f64, double)
QP_DUALS_ENTRY(qp_ip_solve_duals_f32, float)
QP_DUALS_ENTRY(qp_ip_solve_duals_f64, double)

}  // extern "C"
