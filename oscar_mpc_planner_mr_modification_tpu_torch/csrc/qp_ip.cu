// Batched stagewise Mehrotra predictor-corrector interior-point QP solver
// for Hopper (sm_90a), one warp per problem.
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
// analytic (diagonal Hbar update); generic rows are dense over z. With no
// active row the QP is equality constrained and one exact Riccati solve from
// z = 0 finishes it.
//
// Mapping: one warp per problem, W warps per block (4, 2 or 1: the block
// size that keeps the most problems resident per SM, chosen at launch from
// the shared-memory footprint by the occupancy API). A block copies the row
// table and the stage mask into shared memory once; each warp copies its
// problem's columns of the field-major (fields, B) inputs into its own
// shared memory, runs qp_ip.cuh::ip_solve_problem there (how the lanes share
// the work is in its file comment), and writes z (and the multipliers) back
// into its column. Nothing of the iteration touches global memory. The state
// and input dimensions are template parameters, instantiated for
// (nx, nu) = (5, 2), (4, 2) and (6, 2), the port's three unicycle models
// (qp_ip.cuh::with_dims); the wrapper raises for any other.
//
// What bounds it: latency along each problem's sequential chain, not
// arithmetic (it runs at about 1% of the FP32 roof). An iteration runs the
// Riccati factorization and two vector sweeps stage after stage, and row
// passes whose lanes each loop the T stages, so a warp waits on
// shared-memory and division latency most of the time, with only 6 problems
// resident per SM at f32 (shared memory, about 34 KB each) to hide it. This
// replaces one thread per problem with all state in global memory, where
// every one of ~90k operations an iteration waited on an L1/L2 round trip
// with about one warp per SM to hide it. What is left to gain: more problems
// per SM (a smaller footprint), and shorter chains in the row passes and the
// factorization.
//
// The kernel allocates nothing and does not synchronize. Each extern "C"
// entry returns cudaGetLastError() after the launch, -1 when a size is out
// of range, -2 when no block fits the card's shared memory, and -3 for an
// (nx, nu) with no instantiation.

#include "qp_ip.cuh"

namespace {

constexpr int MAX_WARPS = 4;

template <typename real, int NX, int NU>
size_t block_bytes(const Sizes& sz, int W) {
  return sizeof(real) * ((size_t)sz.T * sz.m +
                         (size_t)W * qp_problem_reals<NX, NU>(sz)) +
         sizeof(int) * (size_t)sz.m * RK_W;
}

template <typename real, int NX, int NU, bool duals>
__global__ void __launch_bounds__(MAX_WARPS * WIDTH)
qp_ip_kernel(QpBatch<real> in, const real* __restrict__ mask,
             const int* __restrict__ rinfo, real* __restrict__ z_out,
             const real* __restrict__ lam0, real* __restrict__ lam_out,
             Sizes sz, int Bt, int any_active, int n_iters,
             IpParams<real> prm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  real* sm = reinterpret_cast<real*>(smem_raw);
  const int W = blockDim.x / WIDTH, per = qp_problem_reals<NX, NU>(sz);
  const int Tm = sz.T * sz.m;
  real* probs = sm + Tm;
  int* rinfo_s = reinterpret_cast<int*>(probs + (size_t)W * per);
  for (int i = threadIdx.x; i < Tm; i += blockDim.x) sm[i] = mask[i];
  for (int i = threadIdx.x; i < sz.m * RK_W; i += blockDim.x)
    rinfo_s[i] = rinfo[i];
  __syncthreads();
  const int wid = threadIdx.x / WIDTH, b = blockIdx.x * W + wid;
  if (b >= Bt) return;
  // Without `duals` the pointers are compile-time null: the cold z-only
  // kernel carries no code of the dual variants.
  qp_solve_column<real, NX, NU>(Lanes{(int)(threadIdx.x % WIDTH)}, in,
                                Rows<real>{sm, rinfo_s}, sz,
                                Bt, b,
                                probs + (size_t)wid * per, any_active,
                                n_iters, duals ? lam0 : nullptr, z_out,
                                duals ? lam_out : nullptr, prm);
}

template <typename real, int NX, int NU, bool duals>
warp::LaunchPlan plan(const Sizes& sz) {
  return warp::cached_plan(qp_ip_kernel<real, NX, NU, duals>, sz.T, sz.m,
                           sz.mhp, [&](int W) {
                             return block_bytes<real, NX, NU>(sz, W);
                           });
}

template <typename real, int NX, int NU, bool duals>
int launch_nxnu(const QpBatch<real>& in, const void* mask, const void* rinfo,
                void* z, const void* lam0, void* lam_out, const Sizes& sz,
                int Bt, int any_active, int n_iters,
                const IpParams<real>& prm, void* stream) {
  const warp::LaunchPlan p = plan<real, NX, NU, duals>(sz);
  if (p.err != 0) return p.err;
  const int blocks = (Bt + p.warps - 1) / p.warps;
  qp_ip_kernel<real, NX, NU, duals>
      <<<blocks, p.warps * WIDTH, p.bytes, (cudaStream_t)stream>>>(
          in, (const real*)mask, (const int*)rinfo, (real*)z,
          (const real*)lam0, (real*)lam_out, sz, Bt, any_active, n_iters,
          prm);
  return (int)cudaGetLastError();
}

template <typename real, bool duals>
int launch(const void* H, const void* g, const void* A, const void* Bm,
           const void* c, const void* D, const void* e, const void* r0,
           const void* mask, const void* rinfo, void* z, const void* lam0,
           void* lam_out, int Bt, int T, int nx, int nu, int m, int mhp,
           int any_active, int n_iters, double mu0, double mu_min, double tau,
           double w_max, double s_floor, double tol_freeze, double n_act,
           void* stream) {
  const QpBatch<real> in{(const real*)H, (const real*)g, (const real*)A,
                         (const real*)Bm, (const real*)c, (const real*)D,
                         (const real*)e, (const real*)r0};
  return qp_entry<real>(
      duals, lam_out, Bt, T, nx, nu, m, mhp, mu0, mu_min, tau, w_max, s_floor,
      tol_freeze, n_act,
      [&](auto dims, const Sizes& sz, const IpParams<real>& prm) {
        using Dim = decltype(dims);
        return launch_nxnu<real, Dim::NX, Dim::NU, duals>(
            in, mask, rinfo, z, lam0, lam_out, sz, Bt, any_active, n_iters,
            prm, stream);
      });
}

}  // namespace

extern "C" {

// The launch plan of an entry (f64: 0/1, duals: 0/1) at these sizes, as 6
// ints (warp.cuh plan_out); out[5] = -3 for an (nx, nu) with no instantiation.
void qp_ip_launch_info(int f64, int duals, int T, int m, int mhp, int nx,
                       int nu, int* out) {
  const Sizes sz{T, m, mhp};
  warp::LaunchPlan p{0, 0, 0, 0, 0, -3};
  with_dims(nx, nu, [&](auto dims) {
    using Dim = decltype(dims);
    constexpr int NX = Dim::NX, NU = Dim::NU;
    p = f64 ? (duals ? plan<double, NX, NU, true>(sz)
                     : plan<double, NX, NU, false>(sz))
            : (duals ? plan<float, NX, NU, true>(sz)
                     : plan<float, NX, NU, false>(sz));
    return 0;
  });
  warp::plan_out(p, out);
}

#define QP_ENTRY(NAME, REAL)                                                   \
  int NAME(const void* H, const void* g, const void* A, const void* Bm,        \
           const void* c, const void* D, const void* e, const void* r0,        \
           const void* mask, const void* rinfo, void* z, int Bt, int T,       \
           int nx, int nu, int m, int mhp, int any_active, int n_iters,        \
           double mu0, double mu_min, double tau, double w_max,                \
           double s_floor, double tol_freeze, double n_act, void* stream) {    \
    return launch<REAL, false>(H, g, A, Bm, c, D, e, r0, mask, rinfo, z,       \
                               nullptr, nullptr, Bt, T, nx, nu, m, mhp,        \
                               any_active, n_iters, mu0, mu_min, tau, w_max,   \
                               s_floor, tol_freeze, n_act, stream);            \
  }

// As QP_ENTRY, plus the final multipliers into lam_out (T*m, Bt) and, when
// lam0 (T*m, Bt) is not null, the warm start from it.
#define QP_DUALS_ENTRY(NAME, REAL)                                             \
  int NAME(const void* H, const void* g, const void* A, const void* Bm,        \
           const void* c, const void* D, const void* e, const void* r0,        \
           const void* mask, const void* rinfo, void* z, const void* lam0,    \
           void* lam_out, int Bt, int T, int nx, int nu, int m, int mhp,       \
           int any_active, int n_iters, double mu0, double mu_min, double tau, \
           double w_max, double s_floor, double tol_freeze, double n_act,      \
           void* stream) {                                                     \
    return launch<REAL, true>(H, g, A, Bm, c, D, e, r0, mask, rinfo, z, lam0,  \
                              lam_out, Bt, T, nx, nu, m, mhp, any_active,      \
                              n_iters, mu0, mu_min, tau, w_max, s_floor,       \
                              tol_freeze, n_act, stream);                      \
  }

QP_ENTRY(qp_ip_solve_f32, float)
QP_ENTRY(qp_ip_solve_f64, double)
QP_DUALS_ENTRY(qp_ip_solve_duals_f32, float)
QP_DUALS_ENTRY(qp_ip_solve_duals_f64, double)

}  // extern "C"
