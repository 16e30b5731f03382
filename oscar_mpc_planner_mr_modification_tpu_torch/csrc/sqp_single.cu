// S1: the single-instance SQP solve in one launch, for Hopper (sm_90a), one
// warp per problem. Compiled for each model of tmpc_ocp.cuh::with_model, in
// f32 and f64; the entry takes the model id.
//
// Replaces the JAX package's ops/sqp.py::make_sqp_solver over
// ops/qp.py::solve_qp: one jitted XLA program per ladder entry (autodiff
// linearization, build_qp with the "mirror" eigendecomposition, the
// interior-point QP under lax.scan), not a Pallas kernel. Per problem it
// runs that algorithm (sqp_single.cuh): every SQP iteration of every
// schedule phase linearizes the OCP in the kernel (tmpc_ocp.cuh), mirrors
// the Hessians by cyclic Jacobi where the regularization is "mirror"
// (sqp_single.cuh::mirror_stage; Gershgorin and Levenberg shift in the
// linearization), solves the QP by JAX's solve_qp (stationarity in the
// freeze, the best-merit iterate) and takes the full step, kept back where
// it has a NaN; with track_best it keeps the best SQP iterate by merit. It
// writes each problem's result as ops/sqp.py::pack_results lays it out:
// z, cost, eq_res, qp_comp, exit_code, success.
//
// Mapping: one warp per problem, W warps per block chosen at launch from
// the shared-memory footprint (warp::plan_launch / cached_plan), as in
// sqp_fused.cu. A problem's QP, iterate, best iterate and interior-point
// state (with the best-of copies; the Jacobi workspace overlays it between
// QP solves) live in its dynamic shared memory, about 104 KB at the
// configuration_basic OCP (T = 31, nz = 7, m = 18) in f64; the stage mask and
// row table are the block's. Global memory is read for the inputs and
// written once at the end.
//
// What bounds it: one warp's dependent chain. A single solve is one warp on
// one SM: the interior-point iteration's sequential Riccati sweeps, the
// lane-synchronized passes between them and shared-memory latency, not
// FLOPs (about 0.1 MFLOP per IP iteration at T = 31, ops/roofline.py's
// S1_* counts) nor bytes (tens of KB in and out per problem). The design keeps the whole solve in one launch, so the
// host's ~20-40 us per operation of the plain version's stream of launches
// is gone; it does not yet spread one problem over more than one warp.
//
// The kernel allocates nothing and does not synchronize. The extern "C"
// entry returns cudaGetLastError() after the launch, -1 when a size is out
// of range, -2 when no block fits the card's shared memory, or -3 for a
// model id with no instantiation.

#include "sqp_single.cuh"

namespace {

constexpr int MAX_WARPS = 4;

template <typename real, class M>
size_t single_block_bytes(const SingleOffsets<M>& F, int W) {
  return sizeof(real) * ((size_t)F.sz.T * F.sz.m + (size_t)W * F.total) +
         sizeof(int) * (size_t)F.sz.m * RK_W;
}

template <typename real, class M>
__global__ void __launch_bounds__(MAX_WARPS * WIDTH)
sqp_single_kernel(const real* __restrict__ in, real* __restrict__ out,
                  const real* __restrict__ mask, const int* __restrict__ rinfo,
                  const int* __restrict__ itab, const double* __restrict__ rtab,
                  const int* __restrict__ phases, int n_phases,
                  SingleOffsets<M> F, int Bt, int npar, int track_best,
                  int reg, SingleParams<real> prm, real res_eq_tol) {
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
  sqp_single_column<M, real>(Lanes{(int)(threadIdx.x % WIDTH)},
                             tmpc::Ocp{itab, rtab}, in, out, b, npar,
                             probs + (size_t)wid * F.total,
                             Rows<real>{sm, rinfo_s}, phases, n_phases, F,
                             track_best, reg, prm, res_eq_tol);
}

template <typename real, class M>
warp::LaunchPlan single_plan(const SingleOffsets<M>& F) {
  return warp::cached_plan(sqp_single_kernel<real, M>, F.L.T, F.L.m, F.L.mh,
                           [&](int W) { return single_block_bytes<real>(F, W); });
}

template <typename real>
int launch_single(const void* in, void* out, const void* mask,
                  const void* rinfo, const void* itab, const void* rtab,
                  const void* phases, int n_phases, int Bt, int T, int m,
                  int mh, int npar, int model, int track_best, int reg,
                  double mu0, double mu_min, double tau, double w_max,
                  double s_floor, double tol_freeze, double n_act,
                  double res_eq_tol, void* stream) {
  return single_solve_entry<real>(
      model, Bt, T, m, mh, npar, n_phases, mu0, mu_min, tau, w_max, s_floor,
      tol_freeze, n_act, [&](const auto& F, const SingleParams<real>& prm) {
        using M = typename std::decay_t<decltype(F)>::Model;
        const warp::LaunchPlan p = single_plan<real>(F);
        if (p.err != 0) return p.err;
        const int blocks = (Bt + p.warps - 1) / p.warps;
        sqp_single_kernel<real, M>
            <<<blocks, p.warps * WIDTH, p.bytes, (cudaStream_t)stream>>>(
                (const real*)in, (real*)out, (const real*)mask,
                (const int*)rinfo, (const int*)itab, (const double*)rtab,
                (const int*)phases, n_phases, F, Bt, npar, track_best, reg,
                prm, real(res_eq_tol));
        return (int)cudaGetLastError();
      });
}

}  // namespace

extern "C" {

// The launch plan (warp.cuh plan_out, 6 ints) of S1 (f64: 0/1) for model id
// `model` at these sizes; err -3 for a model with no instantiation.
void sqp_single_launch_info(int f64, int model, int T, int m, int mh,
                            int* out) {
  warp::LaunchPlan s{0, 0, 0, 0, 0, -3};
  tmpc::with_model(model, [&](auto mdl) {
    using M = decltype(mdl);
    const SingleOffsets<M> F(T, m, mh);
    s = f64 ? single_plan<double>(F) : single_plan<float>(F);
    return 0;
  });
  warp::plan_out(s, out);
}

#define SINGLE_ENTRY(NAME, REAL)                                              \
  int NAME(const void* in, void* out, const void* mask, const void* rinfo,    \
           const void* itab, const void* rtab, const void* phases,            \
           int n_phases, int Bt, int T, int m, int mh, int npar, int model,   \
           int track_best, int reg, double mu0, double mu_min, double tau,    \
           double w_max, double s_floor, double tol_freeze, double n_act,     \
           double res_eq_tol, void* stream) {                                 \
    return launch_single<REAL>(in, out, mask, rinfo, itab, rtab, phases,      \
                               n_phases, Bt, T, m, mh, npar, model,           \
                               track_best, reg, mu0, mu_min, tau, w_max,      \
                               s_floor, tol_freeze, n_act, res_eq_tol,        \
                               stream);                                       \
  }

SINGLE_ENTRY(sqp_single_solve_f32, float)
SINGLE_ENTRY(sqp_single_solve_f64, double)

}  // extern "C"
