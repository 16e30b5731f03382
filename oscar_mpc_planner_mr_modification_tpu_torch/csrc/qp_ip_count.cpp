// Operation counts of the kernels' per-problem code: the interior-point
// solve of qp_ip.cuh, the linearization and merit of tmpc_ocp.cuh, and the
// single-instance kernel's mirror pass and QP solve (sqp_single.cuh),
// compiled for the host with a scalar type that counts every floating-point
// operation it executes, by kind. The lane-group code runs with 32 emulated
// lanes (warp.cuh), S1's QP solve with MAX_WARPS emulated warps (warp.cuh
// Block), so each operation of the algorithm counts once. It is the
// witness for the counts that bound the kernels (ops/roofline.py):
// ip_iter_flops and IP_ITER_FLOPS, LIN_FLOPS and MERIT_FLOPS, the
// LIN_MIRROR counts of the mirror linearize entry and the S1_* counts.
//
//   g++ -std=c++17 -O1 -shared -fPIC -o libqp_ip_count.so qp_ip_count.cpp
//
// Counted: + and -, *, /, unary -, and one operation for each call of sqrt,
// exp, log, erf, sin, cos, tan, atan, atan2 and fmod (the transcendental
// kind). Not counted:
// comparisons, min, max, |.|, and the double arithmetic on the time step
// inside rk4 (three operations per call, on a constant).
//
// tests/test_torch_roofline.py builds it and calls qp_ip_count_ops on one
// problem in the kernel's field-major layout (Bt = 1) with the kernel's own
// row tables (ops/qp_cuda.py::_row_tables), and tmpc_count_ops on one
// problem of a fused OCP with its tables (ops/sqp_fused.py::ocp_tables).

#include <math.h>

namespace opcount {

// Operations executed so far: +/- , *, /, unary -, transcendental.
long long n_add, n_mul, n_div, n_neg, n_tr;

struct R {
  double v;
  R() = default;
  R(double x) : v(x) {}
};

inline R operator+(R a, R b) { ++n_add; return R(a.v + b.v); }
inline R operator-(R a, R b) { ++n_add; return R(a.v - b.v); }
inline R operator*(R a, R b) { ++n_mul; return R(a.v * b.v); }
inline R operator/(R a, R b) { ++n_div; return R(a.v / b.v); }
inline R operator-(R a) { ++n_neg; return R(-a.v); }
inline R sqrt(R a) { ++n_tr; return R(::sqrt(a.v)); }
inline R fabs(R a) { return R(::fabs(a.v)); }
inline bool operator<(R a, R b) { return a.v < b.v; }
inline bool operator>(R a, R b) { return a.v > b.v; }
inline bool operator>=(R a, R b) { return a.v >= b.v; }
inline bool operator<=(R a, R b) { return a.v <= b.v; }
inline bool operator!=(R a, R b) { return a.v != b.v; }
inline bool operator==(R a, R b) { return a.v == b.v; }

// tmpc_ocp.cuh's scalar math on the counting type.
inline R m_sin(R a) { ++n_tr; return R(::sin(a.v)); }
inline R m_cos(R a) { ++n_tr; return R(::cos(a.v)); }
inline R m_sqrt(R a) { return sqrt(a); }
inline R m_exp(R a) { ++n_tr; return R(::exp(a.v)); }
inline R m_log(R a) { ++n_tr; return R(::log(a.v)); }
inline R m_erf(R a) { ++n_tr; return R(::erf(a.v)); }
inline R m_atan2(R y, R x) { ++n_tr; return R(::atan2(y.v, x.v)); }
inline R m_tan(R a) { ++n_tr; return R(::tan(a.v)); }
inline R m_atan(R a) { ++n_tr; return R(::atan(a.v)); }
inline R m_fmod(R x, R y) { ++n_tr; return R(::fmod(x.v, y.v)); }
inline R m_abs(R a) { return fabs(a); }
inline R tsin(R a) { return m_sin(a); }
inline R tcos(R a) { return m_cos(a); }
inline R ttan(R a) { return m_tan(a); }
inline R tatan(R a) { return m_atan(a); }
inline R tatan2(R y, R x) { return m_atan2(y, x); }
inline R tsqrt(R a) { return m_sqrt(a); }
inline R trecip(R a) { return R(1.0) / a; }
inline R value(R a) { return a; }
inline R haar(R d) {
  const double pi = 3.14159265358979323846;
  return m_fmod(d + R(pi), R(2.0 * pi)) - R(pi);
}

}  // namespace opcount

#include "sqp_fused.cuh"
#include "sqp_single.cuh"

using opcount::R;

namespace {

R* lift(const double* x, int n) {
  R* y = new R[n];
  for (int i = 0; i < n; ++i) y[i] = R(x[i]);
  return y;
}

void reset() {
  opcount::n_add = opcount::n_mul = opcount::n_div = opcount::n_neg =
      opcount::n_tr = 0;
}

void report(long long* out) {
  out[0] = opcount::n_add;
  out[1] = opcount::n_mul;
  out[2] = opcount::n_div;
  out[3] = opcount::n_neg;
  out[4] = opcount::n_tr;
}

template <int NX, int NU>
void count_ip(R* const* in, const double* mask, const int* rinfo,
              int T, int m, int mhp, int n_iters,
              const IpParams<R>& prm, long long* out) {
  const Sizes sz{T, m, mhp};
  R* mask_r = lift(mask, T * m);
  R* z = new R[T * (NX + NU)];
  R* mem = new R[qp_problem_reals<NX, NU>(sz)];
  int any_active = 0;
  for (int r = 0; r < m; ++r) any_active |= rinfo[r * RK_W + RK_ACTIVE];
  const QpBatch<R> batch{in[0], in[1], in[2], in[3],
                         in[4], in[5], in[6], in[7]};
  reset();
  qp_solve_column<R, NX, NU>(Lanes{}, batch,
                             Rows<R>{mask_r, rinfo}, sz, 1, 0,
                             mem, any_active, n_iters, nullptr, z, nullptr,
                             prm);
  report(out);
  delete[] mask_r;
  delete[] z;
  delete[] mem;
}

}  // namespace

extern "C" {

// One problem's solve with n_iters iterations; inputs as the QP kernel takes
// them (f64, Bt = 1), the scalars as qp_ip.cu's launch derives them.
// (nx, nu) in {(5, 2), (4, 2), (6, 2), (6, 3), (3, 1), (4, 3)}. out[0..4]: additions and
// subtractions, multiplications, divisions, negations, transcendentals
// (square roots). Returns -3 for another (nx, nu).
int qp_ip_count_ops(const double* H, const double* g, const double* A,
                    const double* Bm, const double* c, const double* D,
                    const double* e, const double* r0, const double* mask,
                    const int* rinfo, int T, int nx, int nu,
                    int m, int mhp, int n_iters, double mu0, double mu_min,
                    double tau, double w_max, double s_floor,
                    double tol_freeze, double n_act, long long* out) {
  const int nz = nx + nu, ntri = nz * (nz + 1) / 2;
  R* in[] = {lift(H, T * ntri), lift(g, T * nz), lift(A, (T - 1) * nx * nx),
             lift(Bm, (T - 1) * nx * nu), lift(c, (T - 1) * nx),
             lift(D, T * mhp * nz), lift(e, T * m), lift(r0, nx)};
  const IpParams<R> prm = qp_params<R>(mu0, mu_min, tau, w_max, s_floor,
                                       tol_freeze, n_act);
  int ret = 0;
  if (nx == 5 && nu == 2)
    count_ip<5, 2>(in, mask, rinfo, T, m, mhp, n_iters, prm, out);
  else if (nx == 4 && nu == 2)
    count_ip<4, 2>(in, mask, rinfo, T, m, mhp, n_iters, prm, out);
  else if (nx == 6 && nu == 2)
    count_ip<6, 2>(in, mask, rinfo, T, m, mhp, n_iters, prm, out);
  else if (nx == 6 && nu == 3)
    count_ip<6, 3>(in, mask, rinfo, T, m, mhp, n_iters, prm, out);
  else if (nx == 3 && nu == 1)
    count_ip<3, 1>(in, mask, rinfo, T, m, mhp, n_iters, prm, out);
  else if (nx == 4 && nu == 3)
    count_ip<4, 3>(in, mask, rinfo, T, m, mhp, n_iters, prm, out);
  else
    ret = -3;
  for (R* p : in) delete[] p;
  return ret;
}

// The linearization (lin_out) and the merit terms (merit_out) of one
// problem of the fused kernel's OCP (model id `model`) at Z, as the kernel
// runs them (lane group, 32 emulated lanes); P (npar*T), x0 (nx), Z (T*nz)
// as the kernel's field-major columns with Bt = 1. Each out as
// qp_ip_count_ops'. Returns -3 for a model with no instantiation.
int tmpc_count_ops(const double* P, const double* x0, const double* Z,
                   const int* itab, const double* rtab, int T, int npar,
                   int m, int mh, int model, int reg, long long* lin_out,
                   long long* merit_out) {
  return tmpc::with_model(model, [&](auto mdl) {
    using M = decltype(mdl);
    const tmpc::QpLayout<M> L(T, m, mh);
    R* Pr = lift(P, npar * T);
    R* xr = lift(x0, M::NX);
    R* Zr = lift(Z, T * M::NZ);
    R* qp = new R[L.total];
    R* red = new R[linearize_red(T)];
    const tmpc::Ocp o{itab, rtab};
    const tmpc::Col<const R> Pc{Pr, 1, 0}, xc{xr, 1, 0}, Zc{Zr, 1, 0};
    reset();
    tmpc::linearize_warp<M, R>(Lanes{}, o, Pc, xc, Zc,
                               tmpc::Col<R>{qp, 1, 0}, L, reg);
    report(lin_out);
    R mv, cost, eq;
    reset();
    tmpc::merit_warp<M, R>(Lanes{}, o, Pc, xc, Zc, T, red,
                           (linearize_red(T) - 1) / 3, &mv, &cost, &eq);
    report(merit_out);
    delete[] Pr;
    delete[] xr;
    delete[] Zr;
    delete[] qp;
    delete[] red;
    return 0;
  });
}

// The mirror linearize entry (sqp_linearize_mirror.cu) at one problem of a
// fused OCP (model id `model`) at Z, as the kernel runs it (lane group, 32
// emulated lanes; its Jacobi sweeps as this Z needs them): its
// linearization with the mirror pass (lin_out; reg is REG_MIRROR), as
// tmpc_count_ops' lin_out. Returns -3 for a model with no instantiation.
int linearize_mirror_count_ops(const double* P, const double* x0,
                               const double* Z, const int* itab,
                               const double* rtab, int T, int npar, int m,
                               int mh, int model, long long* lin_out) {
  return tmpc::with_model(model, [&](auto mdl) {
    using M = decltype(mdl);
    const tmpc::QpLayout<M> L(T, m, mh);
    R* Pr = lift(P, npar * T);
    R* xr = lift(x0, M::NX);
    R* Zr = lift(Z, T * M::NZ);
    R* qp = new R[L.total];
    const tmpc::Ocp o{itab, rtab};
    const tmpc::Col<const R> Pc{Pr, 1, 0}, xc{xr, 1, 0}, Zc{Zr, 1, 0};
    reset();
    tmpc::linearize_warp<M, R, true>(Lanes{}, o, Pc, xc, Zc,
                                     tmpc::Col<R>{qp, 1, 0}, L, REG_MIRROR);
    report(lin_out);
    delete[] Pr;
    delete[] xr;
    delete[] Zr;
    delete[] qp;
    return 0;
  });
}

// S1 at one problem of a fused OCP (model id `model`) at Z, as the kernel
// runs it (lane group, 32 emulated lanes): the linearization (lin_out), the
// mirror pass (mirror_out; zeros unless reg is REG_MIRROR) and one QP
// solve of n_iters interior-point iterations on that QP (qp_out), with the
// stage mask and row table of ops/qp_cuda.py::_row_tables and the scalars as
// the S1 entry derives them. Each out as qp_ip_count_ops'. Returns -3 for a
// model with no instantiation.
int sqp_single_count_ops(const double* P, const double* x0, const double* Z,
                         const int* itab, const double* rtab,
                         const double* mask, const int* rinfo, int T,
                         int npar, int m, int mh, int model, int reg,
                         int n_iters, double mu0, double mu_min, double tau,
                         double w_max, double s_floor, double tol_freeze,
                         double n_act, long long* lin_out,
                         long long* mirror_out, long long* qp_out) {
  return tmpc::with_model(model, [&](auto mdl) {
    using M = decltype(mdl);
    const SingleOffsets<M> F(T, m, mh);
    const tmpc::QpLayout<M>& L = F.L;
    R* Pr = lift(P, npar * T);
    R* xr = lift(x0, M::NX);
    R* Zr = lift(Z, T * M::NZ);
    R* mask_r = lift(mask, T * m);
    R* mem = new R[F.total];
    R* qp = mem + F.qp;
    const tmpc::Ocp o{itab, rtab};
    const tmpc::Col<const R> Pc{Pr, 1, 0}, xc{xr, 1, 0}, Zc{Zr, 1, 0};
    reset();
    tmpc::linearize_warp<M, R>(Lanes{}, o, Pc, xc, Zc, tmpc::Col<R>{qp, 1, 0},
                               L, reg);
    report(lin_out);
    reset();
    if (reg == REG_MIRROR)
      mirror_pass<M::NX, M::NU>(Lanes{}, qp + L.H, T, R(rtab[tmpc::RT_REG_EPS]),
                                mem + F.ip);
    report(mirror_out);
    const SingleParams<R> prm{R(mu0),       R(mu_min),
                              R(tau),       R(w_max),
                              R(s_floor),   R(tol_freeze),
                              R(100.0 * tol_freeze), R(1e3 * tol_freeze),
                              R(n_act),     R(1e30)};
    const SingleState<R> st = SingleScratch<M::NX, M::NU>(F.sz).state(mem + F.ip);
    const QpView<R> q{qp + L.H, qp + L.g, qp + L.A, qp + L.B,
                      qp + L.c, qp + L.D, qp + L.e, qp + L.r0};
    R comp, eq;
    reset();
    solve_qp_problem<R, M::NX, M::NU>(Block{MAX_WARPS, 0}, q,
                                      Rows<R>{mask_r, rinfo},
                                      F.sz, st, n_iters, prm, &comp, &eq);
    report(qp_out);
    delete[] Pr;
    delete[] xr;
    delete[] Zr;
    delete[] mask_r;
    delete[] mem;
    return 0;
  });
}

}  // extern "C"
