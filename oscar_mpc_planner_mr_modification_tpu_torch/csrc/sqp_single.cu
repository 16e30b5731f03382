// S1: the single-instance SQP solve in one launch, for Hopper (sm_90a), one
// thread block per problem. Compiled for each model of
// tmpc_ocp.cuh::with_model, in f32 and f64; the entry takes the model id.
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
// Mapping: one block of W warps per problem (warp.cuh Block). W comes from
// the batch (sqp_single.cuh::block_warps): 8 while the problems fit one
// wave of 8-warp blocks (132 on an H100, one block per SM), narrower blocks
// (4, then 2 warps) above, where they keep more problems resident at once;
// the plan is remembered per device, sizes and batch. A problem's QP,
// iterate, best iterate and interior-point state (with the best-of copies
// and the warp partials; the Jacobi workspace overlays it between QP
// solves), its stage mask and row table live in the block's dynamic shared
// memory, about 105 KB at the configuration_basic OCP (T = 31, nz = 7,
// m = 18) in f64. Global memory is read for the inputs and written once at
// the end.
//
// What bounds it: the dependent chain of one problem, not FLOPs (about 0.1
// MFLOP per interior-point iteration at T = 31, ops/roofline.py's S1_*
// counts) nor bytes (tens of KB in and out per problem). With one warp per
// problem, a lane walked its row over all T stages and every pass ran on one
// warp; here the passes over (stage, row) entries, Hbar, gbar, the residuals
// and the update take every thread of the block, and only the sequential
// Riccati factor and vector sweeps stay on one warp each, in registers
// exchanged by shuffles: the factor beside the residuals and the affine
// gbar on the other warps, the affine sweep following the factor stage by
// stage on warp 1. The whole solve stays one
// launch, so the host's ~20-40 us per operation of the plain version's
// stream of launches is gone.
//
// The kernel allocates nothing and does not synchronize. The extern "C"
// entry returns cudaGetLastError() after the launch, -1 when a size is out
// of range, -2 when no block fits the card's shared memory, or -3 for a
// model id with no instantiation.

#include "parts.cuh"

#if !defined(TMPC_DISPATCH)
#include "sqp_single.cuh"

namespace {

template <typename real, class M>
size_t single_block_bytes(const SingleOffsets<M>& F) {
  return sizeof(real) * ((size_t)F.sz.T * F.sz.m + (size_t)F.total) +
         sizeof(int) * (size_t)F.sz.m * RK_W;
}

template <typename real, class M>
__global__ void __launch_bounds__(MAX_WARPS * WIDTH, 1)
sqp_single_kernel(const real* __restrict__ in, real* __restrict__ out,
                  const real* __restrict__ mask, const int* __restrict__ rinfo,
                  const int* __restrict__ itab, const double* __restrict__ rtab,
                  const int* __restrict__ phases, int n_phases,
                  SingleOffsets<M> F, int npar, int track_best, int reg,
                  SingleParams<real> prm, real res_eq_tol) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  real* sm = reinterpret_cast<real*>(smem_raw);
  const int Tm = F.sz.T * F.sz.m;
  real* prob = sm + Tm;
  int* rinfo_s = reinterpret_cast<int*>(prob + F.total);
  for (int i = threadIdx.x; i < Tm; i += blockDim.x) sm[i] = mask[i];
  for (int i = threadIdx.x; i < F.sz.m * RK_W; i += blockDim.x)
    rinfo_s[i] = rinfo[i];
#ifdef S1_SECTIONS
  if (threadIdx.x < SEC_COUNT) s1_sec_sm[threadIdx.x] = 0;
#endif
  __syncthreads();
  S1_CLOCK;
  sqp_single_column<M, real>(
      Block{(int)(blockDim.x / WIDTH), (int)threadIdx.x},
      tmpc::Ocp{itab, rtab}, in, out, blockIdx.x, npar, prob,
      Rows<real>{sm, rinfo_s}, phases, n_phases, F, track_best, reg, prm,
      res_eq_tol);
  S1_LAP(SEC_TOTAL);
#ifdef S1_SECTIONS
  if (S1_SEC_ON)
    for (int k = 0; k < SEC_COUNT; ++k) s1_sections[k] += s1_sec_sm[k];
#endif
}

#ifdef S1_SECTIONS
__global__ void take_sections(unsigned long long* out) {
  for (int k = 0; k < SEC_COUNT; ++k) {
    out[k] = s1_sections[k];
    s1_sections[k] = 0;
  }
}
#endif

// How S1 launches Bt problems at `bytes` of dynamic shared memory per block:
// blocks of block_warps(Bt, ...) warps, from the card's SMs and the blocks
// of each width resident per SM (the occupancy API); err -2 when no block
// fits. Sets the kernel's dynamic shared memory limit to bytes.
template <class Kernel>
warp::LaunchPlan block_plan(Kernel kern, size_t bytes, int Bt) {
  int dev = 0, optin = 0, sms = 0, per_sm[3] = {0, 0, 0};
  warp::LaunchPlan p{0, (int)bytes, 0, 0, 0, -2};
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && bytes <= (size_t)optin) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    for (int i = 0; i < 3 && err == cudaSuccess; ++i)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm[i], kern, BLOCK_WARPS[i] * WIDTH, bytes);
  }
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) {
    cudaGetLastError();
    p.err = (int)err;
    return p;
  }
  const int W = block_warps(Bt, sms, per_sm);
  if (W == 0) return p;
  for (int i = 0; i < 3; ++i)
    if (BLOCK_WARPS[i] == W) p.per_sm = per_sm[i];
  p.warps = W;
  p.regs = attr.numRegs;
  p.local_bytes = (int)attr.localSizeBytes;
  p.err = 0;
  return p;
}

template <typename real, class M>
warp::LaunchPlan single_plan(const SingleOffsets<M>& F, int Bt) {
  auto kern = sqp_single_kernel<real, M>;
  return warp::remembered_plan(kern, F.L.T, F.L.m, F.L.mh, Bt, [&] {
    return block_plan(kern, single_block_bytes<real>(F), Bt);
  });
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
        const warp::LaunchPlan p = single_plan<real>(F, Bt);
        if (p.err != 0) return p.err;
        sqp_single_kernel<real, M>
            <<<Bt, p.warps * WIDTH, p.bytes, (cudaStream_t)stream>>>(
                (const real*)in, (real*)out, (const real*)mask,
                (const int*)rinfo, (const int*)itab, (const double*)rtab,
                (const int*)phases, n_phases, F, npar, track_best, reg, prm,
                real(res_eq_tol));
        return (int)cudaGetLastError();
      });
}

}  // namespace

extern "C" {

// The launch plan (warp.cuh plan_out, 6 ints: warps per block, bytes,
// blocks (problems) per SM, registers, local bytes, err) of S1 (f64: 0/1)
// for model id `model` at these sizes and Bt problems; err -3 for a model
// with no instantiation.
void TMPC_ENTRY(sqp_single_launch_info)(int f64, int model, int T, int m,
                                        int mh, int Bt, int* out) {
  warp::LaunchPlan s{0, 0, 0, 0, 0, -3};
  tmpc::with_model(model, [&](auto mdl) {
    using M = decltype(mdl);
    const SingleOffsets<M> F(T, m, mh);
    s = f64 ? single_plan<double>(F, Bt) : single_plan<float>(F, Bt);
    return 0;
  });
  warp::plan_out(s, out);
}

// One launch: Bt blocks, one per problem, of the plan's warps.
#define SINGLE_ENTRY(NAME, REAL)                                              \
  int TMPC_ENTRY(NAME)(                                                      \
           const void* in, void* out, const void* mask, const void* rinfo,    \
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

#ifdef S1_SECTIONS
// The section counters (sqp_single.cuh SEC_*, SEC_COUNT of them) summed
// over the launches since the last call, copied into the device buffer
// `out` by a one-thread kernel on `stream`, then zeroed. Returns
// cudaGetLastError().
int sqp_single_sections(void* out, void* stream) {
  take_sections<<<1, 1, 0, (cudaStream_t)stream>>>(
      (unsigned long long*)out);
  return (int)cudaGetLastError();
}
#endif

}  // extern "C"

#else  // TMPC_DISPATCH: the entries, each calling its model's part

extern "C" {

#define SINGLE_PARAMS                                                        \
  (const void* in, void* out, const void* mask, const void* rinfo,           \
   const void* itab, const void* rtab, const void* phases, int n_phases,     \
   int Bt, int T, int m, int mh, int npar, int model, int track_best,        \
   int reg, double mu0, double mu_min, double tau, double w_max,             \
   double s_floor, double tol_freeze, double n_act, double res_eq_tol,       \
   void* stream)
#define SINGLE_ARGS                                                          \
  (in, out, mask, rinfo, itab, rtab, phases, n_phases, Bt, T, m, mh, npar,   \
   model, track_best, reg, mu0, mu_min, tau, w_max, s_floor, tol_freeze,     \
   n_act, res_eq_tol, stream)

TMPC_DISPATCH_FN(void, sqp_single_launch_info,
                 (int f64, int model, int T, int m, int mh, int Bt, int* out),
                 (f64, model, T, m, mh, Bt, out), model)
TMPC_DISPATCH_FN(int, sqp_single_solve_f32, SINGLE_PARAMS, SINGLE_ARGS, model)
TMPC_DISPATCH_FN(int, sqp_single_solve_f64, SINGLE_PARAMS, SINGLE_ARGS, model)

}  // extern "C"

#endif  // TMPC_DISPATCH
