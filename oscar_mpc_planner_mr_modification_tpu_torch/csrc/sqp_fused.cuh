// The per-problem code of the fused whole-SQP kernel (sqp_fused.cu) and of
// its linearize entry, one lane group (warp.cuh) per problem, shared with the
// host build (tmpc_ocp_host.cpp).
//
// sqp_solve_column() runs problem b's whole SQP with its state in `mem`
// (FusedOffsets<M>(T, m, mh).total reals, shared memory on the card): the QP
// that the lanes linearize into (lane t stage t, tmpc_ocp.cuh), the iterate,
// the best iterate, and the interior-point state of qp_ip.cuh. Inputs and
// outputs are columns of field-major (fields, Bt) arrays. The row structure
// (Rows) is the block's copy. Everything is a template on the model M
// (tmpc_ocp.cuh); fused_solve_entry() picks it from the model id.

#pragma once

#include <type_traits>

#include "qp_ip.cuh"
#include "tmpc_ocp.cuh"

namespace {

using tmpc::Col;

// Offsets, in reals, of one problem's memory in the fused kernel.
template <class M>
struct FusedOffsets {
  using Model = M;
  tmpc::QpLayout<M> L;
  Sizes sz;
  int qp, z, zbest, ip, total;
  __host__ __device__ FusedOffsets(int T, int m, int mh)
      : L(T, m, mh), sz{T, m, L.mhp} {
    qp = 0;
    z = L.total;
    zbest = z + T * M::NZ;
    ip = zbest + T * M::NZ;
    total = ip + Scratch<M::NX, M::NU>(sz).total;
  }
};

// Problem b's whole SQP: every phase (n_sqp, n_qp) of `phases` runs n_sqp
// linearizations, each followed by an n_qp-iteration cold QP solve and the
// full step (kept out where the step sums to NaN); with track_best the best
// iterate by merit is returned. out (T*NZ + 2, Bt): the iterate, its cost
// and its equality residual.
template <class M, typename real>
__device__ void sqp_solve_column(
    const Lanes& lanes, const tmpc::Ocp& o, const real* P, const real* x0,
    const real* Z0, real* out, int Bt, int b, real* mem, const Rows<real>& rw,
    const int* phases, int n_phases, const FusedOffsets<M>& F, int any_active,
    int track_best, int reg, const IpParams<real>& prm) {
  const size_t B = Bt;
  const int nzT = F.sz.T * M::NZ;
  const tmpc::QpLayout<M>& L = F.L;
  real* qp = mem + F.qp;
  real* z = mem + F.z;
  real* zbest = mem + F.zbest;
  const IpState<real> w = Scratch<M::NX, M::NU>(F.sz).state(mem + F.ip);
  const Col<const real> Pc{P, B, b}, xc{x0, B, b};
  const Col<const real> zc{z, 1, 0}, zbc{zbest, 1, 0};
  const QpView<real> q{qp + L.H, qp + L.g, qp + L.A, qp + L.B,
                       qp + L.c, qp + L.D, qp + L.e, qp + L.r0};

  lanes.run([&](int l) {
    for (int f = l; f < nzT; f += WIDTH) z[f] = Z0[(size_t)f * B + b];
  });
  real best = real(0), mv, cost, eq;
  if (track_best) {
    tmpc::merit_warp<M, real>(lanes, o, Pc, xc, zc, F.sz.T, w.red, w.R,
                              &best, &cost, &eq);
    lanes.run([&](int l) {
      for (int f = l; f < nzT; f += WIDTH) zbest[f] = z[f];
    });
  }
  for (int ph = 0; ph < n_phases; ++ph) {
    const int n_sqp = phases[2 * ph], n_qp = phases[2 * ph + 1];
    for (int it = 0; it < n_sqp; ++it) {
      tmpc::linearize_warp<M, real>(lanes, o, Pc, xc, zc, Col<real>{qp, 1, 0},
                                    L, reg);
      ip_solve_problem<real, M::NX, M::NU>(lanes, q, rw, F.sz, w, any_active,
                                           n_qp, false, prm);
      // A NaN step (failed QP) keeps the previous iterate.
      real acc = real(0);
      for (int f = 0; f < nzT; ++f) acc = acc + w.z[f];
      if (acc == acc)
        lanes.run([&](int l) {
          for (int f = l; f < nzT; f += WIDTH) z[f] = z[f] + w.z[f];
        });
      if (track_best) {
        tmpc::merit_warp<M, real>(lanes, o, Pc, xc, zc, F.sz.T, w.red, w.R,
                                  &mv, &cost, &eq);
        if (mv < best)
          lanes.run([&](int l) {
            for (int f = l; f < nzT; f += WIDTH) zbest[f] = z[f];
          });
        best = tmpc::nanmin(mv, best);
      }
    }
  }
  const Col<const real>& fin = track_best ? zbc : zc;
  tmpc::merit_warp<M, real>(lanes, o, Pc, xc, fin, F.sz.T, w.red, w.R, &mv,
                            &cost, &eq);
  lanes.run([&](int l) {
    for (int f = l; f < nzT; f += WIDTH) out[(size_t)f * B + b] = fin[f];
    if (l == 0) {
      out[(size_t)nzT * B + b] = cost;
      out[(size_t)(nzT + 1) * B + b] = eq;
    }
  });
}

// Sizes a fused entry takes: T >= 2 stages, m >= 1 rows of which
// 0 <= mh <= m generic.
inline bool fused_sizes_ok(int Bt, int T, int m, int mh) {
  return Bt >= 1 && T >= 2 && m >= 1 && mh >= 0 && mh <= m;
}

// The prologue of the fused solve entry (sqp_fused.cu) and of its host build
// (tmpc_ocp_host.cpp): -1 for sizes out of range, -3 for a model with no
// instantiation (tmpc::with_model), else the result of run(F, parameters),
// F the problem's memory layout (FusedOffsets<M>, which names the model).
// Every QP is a cold start, so there is no warm slack floor.
template <typename real, class Run>
int fused_solve_entry(int model, int Bt, int T, int m, int mh, int n_phases,
                      double mu0, double mu_min, double tau, double w_max,
                      double s_floor, double tol_freeze, double n_act,
                      Run&& run) {
  if (!fused_sizes_ok(Bt, T, m, mh) || n_phases < 1) return -1;
  const IpParams<real> prm{real(mu0),        real(mu_min),  real(tau),
                           real(w_max),      real(s_floor), real(0),
                           real(tol_freeze), real(100) * real(tol_freeze),
                           real(n_act)};
  return tmpc::with_model(model, [&](auto mdl) {
    return run(FusedOffsets<decltype(mdl)>(T, m, mh), prm);
  });
}

// Reals of the reduction array of one problem in the linearize entry.
__host__ __device__ inline int linearize_red(int T) {
  return 3 * (T > WIDTH ? T : WIDTH) + 1;
}

// The linearize entry's problem b: the QP fields into column b of qp
// (L.total, Bt) unless qp is null, and (merit, cost, eq_res) into column b
// of merit_out (3, Bt). `red`: linearize_red(T) reals. MIRROR: the
// Hessians mirrored (REG_MIRROR; tmpc::linearize_stage).
template <class M, typename real, bool MIRROR = false>
__device__ void linearize_column(const Lanes& lanes, const tmpc::Ocp& o,
                                 const real* P, const real* x0, const real* Z,
                                 real* qp, real* merit_out, int Bt, int b,
                                 const tmpc::QpLayout<M>& L, int reg,
                                 real* red) {
  const size_t B = Bt;
  const Col<const real> Pc{P, B, b}, xc{x0, B, b}, Zc{Z, B, b};
  if (qp != nullptr)
    tmpc::linearize_warp<M, real, MIRROR>(lanes, o, Pc, xc, Zc,
                                          Col<real>{qp, B, b}, L, reg);
  LIN_CLOCK;
  real mv, cost, eq;
  const int n = (linearize_red(L.T) - 1) / 3;
  tmpc::merit_warp<M, real>(lanes, o, Pc, xc, Zc, L.T, red, n, &mv, &cost,
                            &eq);
  if constexpr (MIRROR) LIN_LAP(tmpc::LIN_SEC_MERIT);
  lanes.run([&](int l) {
    if (l == 0) {
      merit_out[b] = mv;
      merit_out[B + b] = cost;
      merit_out[2 * B + b] = eq;
    }
  });
}

#if defined(__CUDACC__)
// The linearize entry's kernel, one warp per problem: the QP fields
// (L.total, Bt) and (merit, cost, eq_res) (3, Bt) at Z; with qp null, the
// merit terms alone. The variant without MIRROR is sqp_fused.cu's, the one
// with it sqp_linearize_mirror.cu's, so that each source compiles one.
constexpr int LINEARIZE_WARPS = 4;

template <typename real, class M, bool MIRROR>
__global__ void __launch_bounds__(LINEARIZE_WARPS * WIDTH)
sqp_fused_linearize_kernel(const real* __restrict__ P,
                           const real* __restrict__ x0,
                           const real* __restrict__ Z, real* __restrict__ qp,
                           real* __restrict__ merit_out,
                           const int* __restrict__ itab,
                           const double* __restrict__ rtab,
                           tmpc::QpLayout<M> L, int Bt, int reg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  real* sm = reinterpret_cast<real*>(smem_raw);
  const int wid = threadIdx.x / WIDTH, b = blockIdx.x * (blockDim.x / WIDTH) + wid;
  if (b >= Bt) return;
  LIN_INIT();
  LIN_CLOCK;
  linearize_column<M, real, MIRROR>(Lanes{(int)(threadIdx.x % WIDTH)},
                                    tmpc::Ocp{itab, rtab}, P, x0, Z, qp,
                                    merit_out, Bt, b, L, reg,
                                    sm + (size_t)wid * linearize_red(L.T));
  LIN_LAP(tmpc::LIN_SEC_TOTAL);
  LIN_FLUSH();
}

template <typename real, class M, bool MIRROR>
warp::LaunchPlan linearize_plan(int T) {
  return warp::cached_plan(sqp_fused_linearize_kernel<real, M, MIRROR>, T, 0,
                           0, [&](int W) {
                             return sizeof(real) * (size_t)W * linearize_red(T);
                           });
}

// One launch of the linearize kernel: -1 for sizes out of range, -3 for a
// model with no instantiation, else the plan's error or cudaGetLastError().
template <typename real, bool MIRROR>
int launch_linearize(const void* P, const void* x0, const void* Z, void* qp,
                     void* merit_out, const void* itab, const void* rtab,
                     int Bt, int T, int m, int mh, int model, int reg,
                     void* stream) {
  if (!fused_sizes_ok(Bt, T, m, mh)) return -1;
  return tmpc::with_model(model, [&](auto mdl) {
    using M = decltype(mdl);
    const tmpc::QpLayout<M> L(T, m, mh);
    const warp::LaunchPlan p = linearize_plan<real, M, MIRROR>(T);
    if (p.err != 0) return p.err;
    const int blocks = (Bt + p.warps - 1) / p.warps;
    sqp_fused_linearize_kernel<real, M, MIRROR>
        <<<blocks, p.warps * WIDTH, p.bytes, (cudaStream_t)stream>>>(
            (const real*)P, (const real*)x0, (const real*)Z, (real*)qp,
            (real*)merit_out, (const int*)itab, (const double*)rtab, L, Bt,
            reg);
    return (int)cudaGetLastError();
  });
}
#endif

}  // namespace
