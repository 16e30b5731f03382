// Fused whole-SQP solve of a fleet of OCPs in one launch, for Hopper
// (sm_90a), one warp per problem. Compiled for each model of
// tmpc_ocp.cuh::with_model (the T-MPC++, contouring and CC-MPC OCPs on
// ContouringSecondOrderUnicycleModel, the goal OCP on
// SecondOrderUnicycleModel, the SH-MPC OCP on
// ContouringSecondOrderUnicycleModelWithSlack, the bicycle OCPs on
// BicycleModel2ndOrder and its curvature-aware variant, the CA-MPC OCP on
// ContouringSecondOrderUnicycleModelCurvatureAware); the entries take the
// model id.
//
// Replaces the TPU kernel of the JAX package,
// ops/sqp_fused.py::_fused_kernel: per problem, every SQP iteration of every
// schedule phase linearizes the OCP in the kernel (tmpc_ocp.cuh, the lane
// linearizer's semantics), solves the QP with the interior-point iteration
// of the QP kernel (qp_ip.cuh, cold start, the phase's iteration count), and
// takes the full step, keeping the old iterate where the sum of the step is
// NaN. With track_best it keeps the best iterate by merit
// (cost + w * eq_res). It writes the returned iterate, its cost and its
// equality residual.
//
// Mapping: one warp per problem (sqp_fused.cuh::sqp_solve_column), W warps
// per block chosen at launch from the shared-memory footprint, as in
// qp_ip.cu. Everything a problem carries between passes lives in its shared
// memory: the QP fields, the iterate, the best iterate and the
// interior-point state; the row tables and stage mask are the block's. Lane
// t linearizes stage t (jets of value, gradient and nz (nz + 1) / 2
// Hessian entries, 28 at nz = 7, in each lane's registers and local
// memory), the interior-point iteration
// spreads its row, stage and matrix-entry work over the lanes, and the merit
// takes a stage per lane, summed in stage order. Global memory is read for
// the parameters and the initial iterate and written once at the end.
//
// What bounds it: the interior-point iteration's sequential chain, as in
// qp_ip.cu, and shared-memory residency (about 35 KB per problem at f32).
// This replaces one thread per problem with all state in global memory,
// where about one warp per SM waited on the scratch traffic. The
// linearization keeps one stage per lane, so 21 of 32 lanes work at the
// bench's T = 21, and the jets of the cost Hessian stay in local memory.
//
// The linearize entry (sqp_fused_linearize_*) runs the same per-stage code,
// a warp per problem, into a field-major (fields, Bt) buffer in global
// memory, for the lane path; under "mirror" (REG_MIRROR) the QP comes from
// sqp_linearize_mirror.cu's entry instead, and this one gives the merit
// terms alone.
//
// The kernels allocate nothing and do not synchronize. Each extern "C" entry
// returns cudaGetLastError() after the launch, -1 when a size is out of
// range, -2 when no block fits the card's shared memory, -3 for a model
// id with no instantiation, or -4 for a QP asked of the linearize entry
// under REG_MIRROR.

#include "parts.cuh"

#if !defined(TMPC_DISPATCH)
#include "sqp_fused.cuh"

namespace {

constexpr int MAX_WARPS = 4;

template <typename real, class M>
size_t solve_block_bytes(const FusedOffsets<M>& F, int W) {
  return sizeof(real) * ((size_t)F.sz.T * F.sz.m + (size_t)W * F.total) +
         sizeof(int) * (size_t)F.sz.m * RK_W;
}

template <typename real, class M>
__global__ void __launch_bounds__(MAX_WARPS * WIDTH)
sqp_fused_kernel(const real* __restrict__ P, const real* __restrict__ x0,
                 const real* __restrict__ Z0, real* __restrict__ out,
                 const real* __restrict__ mask, const int* __restrict__ rinfo,
                 const int* __restrict__ itab, const double* __restrict__ rtab,
                 const int* __restrict__ phases, int n_phases,
                 FusedOffsets<M> F,
                 int Bt, int any_active, int track_best, int reg,
                 IpParams<real> prm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  real* sm = reinterpret_cast<real*>(smem_raw);
  const int W = blockDim.x / WIDTH;
  const int Tm = F.sz.T * F.sz.m;
  real* probs = sm + Tm;
  int* rinfo_s = reinterpret_cast<int*>(probs + (size_t)W * F.total);
  for (int i = threadIdx.x; i < Tm; i += blockDim.x) sm[i] = mask[i];
  for (int i = threadIdx.x; i < F.sz.m * RK_W; i += blockDim.x)
    rinfo_s[i] = rinfo[i];
  __syncthreads();
  const int wid = threadIdx.x / WIDTH, b = blockIdx.x * W + wid;
  if (b >= Bt) return;
  sqp_solve_column<M, real>(Lanes{(int)(threadIdx.x % WIDTH)},
                         tmpc::Ocp{itab, rtab}, P, x0, Z0, out, Bt, b,
                         probs + (size_t)wid * F.total,
                         Rows<real>{sm, rinfo_s}, phases,
                         n_phases, F, any_active, track_best, reg, prm);
}

template <typename real, class M>
warp::LaunchPlan solve_plan(const FusedOffsets<M>& F) {
  return warp::cached_plan(sqp_fused_kernel<real, M>, F.L.T, F.L.m, F.L.mh,
                           [&](int W) { return solve_block_bytes<real>(F, W); });
}

template <typename real>
int launch_solve(const void* P, const void* x0, const void* Z, void* out,
                 const void* mask, const void* rinfo, const void* itab,
                 const void* rtab, const void* phases, int n_phases, int Bt,
                 int T, int m, int mh, int model,
                 int any_active, int track_best, int reg, double mu0,
                 double mu_min, double tau, double w_max, double s_floor,
                 double tol_freeze, double n_act, void* stream) {
  return fused_solve_entry<real>(
      model, Bt, T, m, mh, n_phases, mu0, mu_min, tau, w_max, s_floor,
      tol_freeze, n_act, [&](const auto& F, const IpParams<real>& prm) {
        using M = typename std::decay_t<decltype(F)>::Model;
        const warp::LaunchPlan p = solve_plan<real>(F);
        if (p.err != 0) return p.err;
        const int blocks = (Bt + p.warps - 1) / p.warps;
        sqp_fused_kernel<real, M>
            <<<blocks, p.warps * WIDTH, p.bytes, (cudaStream_t)stream>>>(
                (const real*)P, (const real*)x0, (const real*)Z, (real*)out,
                (const real*)mask, (const int*)rinfo, (const int*)itab,
                (const double*)rtab, (const int*)phases, n_phases, F, Bt,
                any_active, track_best, reg, prm);
        return (int)cudaGetLastError();
      });
}

}  // namespace

extern "C" {

// QpLayout<M>(T, m, mh) of model id `model` as 9 ints: H g A B c D e r0
// total. Returns 0, or -3 for a model with no instantiation.
int TMPC_ENTRY(tmpc_qp_layout)(int model, int T, int m, int mh, int* out) {
  return tmpc::with_model(model, [&](auto mdl) {
    tmpc::QpLayout<decltype(mdl)>(T, m, mh).offsets(out);
    return 0;
  });
}

// tmpc::table_layout: the tables' contract (6 ints).
#if TMPC_PART0
void tmpc_table_layout(int* out) { tmpc::table_layout(out); }
#endif

// The launch plans (warp.cuh plan_out, 6 ints each) of the solve and the
// linearize entry (f64: 0/1) of model id `model` at these sizes; err -3 for
// a model with no instantiation.
void TMPC_ENTRY(sqp_fused_launch_info)(int f64, int model, int T, int m,
                                       int mh, int* solve_out,
                                       int* linearize_out) {
  warp::LaunchPlan s{0, 0, 0, 0, 0, -3}, l{0, 0, 0, 0, 0, -3};
  tmpc::with_model(model, [&](auto mdl) {
    using M = decltype(mdl);
    const FusedOffsets<M> F(T, m, mh);
    s = f64 ? solve_plan<double>(F) : solve_plan<float>(F);
    l = f64 ? linearize_plan<double, M, false>(T)
            : linearize_plan<float, M, false>(T);
    return 0;
  });
  warp::plan_out(s, solve_out);
  warp::plan_out(l, linearize_out);
}

#define SOLVE_ENTRY(NAME, REAL)                                               \
  int TMPC_ENTRY(NAME)(                                                      \
           const void* P, const void* x0, const void* Z, void* out,           \
           const void* mask, const void* rinfo, const void* itab,             \
           const void* rtab, const void* phases, int n_phases, int Bt, int T, \
           int m, int mh, int model,                                          \
           int any_active, int track_best, int reg, double mu0,               \
           double mu_min, double tau, double w_max, double s_floor,           \
           double tol_freeze, double n_act, void* stream) {                   \
    return launch_solve<REAL>(P, x0, Z, out, mask, rinfo, itab, rtab, phases, \
                              n_phases, Bt, T, m, mh, model,                  \
                              any_active, track_best, reg, mu0, mu_min, tau,  \
                              w_max, s_floor, tol_freeze, n_act, stream);     \
  }

// The mirrored QP is sqp_linearize_mirror.cu's; the merit terms alone do
// not depend on the regularization.
#define LINEARIZE_ENTRY(NAME, REAL)                                           \
  int TMPC_ENTRY(NAME)(                                                      \
           const void* P, const void* x0, const void* Z, void* qp,            \
           void* merit_out, const void* itab, const void* rtab, int Bt,       \
           int T, int m, int mh, int model, int reg, void* stream) {          \
    if (reg == tmpc::REG_MIRROR && qp != nullptr) return -4;                  \
    return launch_linearize<REAL, false>(P, x0, Z, qp, merit_out, itab, rtab, \
                                         Bt, T, m, mh, model, reg, stream);   \
  }

SOLVE_ENTRY(sqp_fused_solve_f32, float)
SOLVE_ENTRY(sqp_fused_solve_f64, double)
LINEARIZE_ENTRY(sqp_fused_linearize_f32, float)
LINEARIZE_ENTRY(sqp_fused_linearize_f64, double)

}  // extern "C"

#else  // TMPC_DISPATCH: the entries, each calling its model's part

extern "C" {

#define SOLVE_PARAMS                                                         \
  (const void* P, const void* x0, const void* Z, void* out, const void* mask, \
   const void* rinfo, const void* itab, const void* rtab, const void* phases, \
   int n_phases, int Bt, int T, int m, int mh, int model, int any_active,    \
   int track_best, int reg, double mu0, double mu_min, double tau,           \
   double w_max, double s_floor, double tol_freeze, double n_act,            \
   void* stream)
#define SOLVE_ARGS                                                           \
  (P, x0, Z, out, mask, rinfo, itab, rtab, phases, n_phases, Bt, T, m, mh,    \
   model, any_active, track_best, reg, mu0, mu_min, tau, w_max, s_floor,     \
   tol_freeze, n_act, stream)
#define LINEARIZE_PARAMS                                                     \
  (const void* P, const void* x0, const void* Z, void* qp, void* merit_out,   \
   const void* itab, const void* rtab, int Bt, int T, int m, int mh,         \
   int model, int reg, void* stream)
#define LINEARIZE_ARGS \
  (P, x0, Z, qp, merit_out, itab, rtab, Bt, T, m, mh, model, reg, stream)

TMPC_DISPATCH_FN(int, tmpc_qp_layout, (int model, int T, int m, int mh,
                                       int* out),
                 (model, T, m, mh, out), model)
TMPC_DISPATCH_FN(void, sqp_fused_launch_info,
                 (int f64, int model, int T, int m, int mh, int* solve_out,
                  int* linearize_out),
                 (f64, model, T, m, mh, solve_out, linearize_out), model)
TMPC_DISPATCH_FN(int, sqp_fused_solve_f32, SOLVE_PARAMS, SOLVE_ARGS, model)
TMPC_DISPATCH_FN(int, sqp_fused_solve_f64, SOLVE_PARAMS, SOLVE_ARGS, model)
TMPC_DISPATCH_FN(int, sqp_fused_linearize_f32, LINEARIZE_PARAMS,
                 LINEARIZE_ARGS, model)
TMPC_DISPATCH_FN(int, sqp_fused_linearize_f64, LINEARIZE_PARAMS,
                 LINEARIZE_ARGS, model)

}  // extern "C"

#endif  // TMPC_DISPATCH
