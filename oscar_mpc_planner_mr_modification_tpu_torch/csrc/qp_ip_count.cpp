// Operation count of the interior-point solve: ip_solve_problem() of
// qp_ip.cuh compiled for the host with a scalar type that counts every
// floating-point operation it executes, by kind. It is the witness for the
// hand count ops/roofline.py::ip_iter_flops, which bounds the QP kernels.
//
//   g++ -std=c++17 -O1 -shared -fPIC -o libqp_ip_count.so qp_ip_count.cpp
//
// tests/test_torch_roofline.py builds it and calls qp_ip_count_ops on one
// problem in the kernel's field-major layout (Bt = 1) with the kernel's own
// row tables (ops/qp_cuda.py::_row_tables).

#include <math.h>

namespace opcount {

// Operations executed so far: +/- , *, /, unary -, sqrt.
long long n_add, n_mul, n_div, n_neg, n_sqrt;

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
inline R sqrt(R a) { ++n_sqrt; return R(::sqrt(a.v)); }
inline R fabs(R a) { return R(::fabs(a.v)); }
inline bool operator<(R a, R b) { return a.v < b.v; }
inline bool operator>(R a, R b) { return a.v > b.v; }
inline bool operator!=(R a, R b) { return a.v != b.v; }

}  // namespace opcount

#include "qp_ip.cuh"

using opcount::R;

extern "C" {

// One problem's solve with n_iters iterations; inputs as ip_solve_problem
// takes them (f64, Bt = 1), the scalars as qp_ip.cu's launch derives them.
// out[0..4]: additions and subtractions, multiplications, divisions,
// negations, square roots.
void qp_ip_count_ops(const double* H, const double* g, const double* A,
                     const double* Bm, const double* c, const double* D,
                     const double* e, const double* r0, const double* mask,
                     const int* rinfo, const int* pairs, int T, int nx,
                     int nu, int m, int mhp, int n_iters, double mu0,
                     double mu_min, double tau, double w_max, double s_floor,
                     double tol_freeze, double n_act, long long* out) {
  const int nz = nx + nu, ntri = nz * (nz + 1) / 2;
  const Sizes sz{1, T, nz, nx, nu, m, mhp, nz, ntri};
  auto lift = [](const double* x, int n) {
    R* y = new R[n];
    for (int i = 0; i < n; ++i) y[i] = R(x[i]);
    return y;
  };
  R* in[] = {lift(H, T * ntri), lift(g, T * nz), lift(A, (T - 1) * nx * nx),
             lift(Bm, (T - 1) * nx * nu), lift(c, (T - 1) * nx),
             lift(D, T * mhp * nz), lift(e, T * m), lift(r0, nx),
             lift(mask, T * m)};
  R* z = new R[T * nz];
  R* scratch = new R[Scratch(T, nz, nx, nu, m).total];
  int any_active = 0;
  for (int r = 0; r < m; ++r) any_active |= rinfo[r * RK_W + RK_ACTIVE];
  opcount::n_add = opcount::n_mul = opcount::n_div = opcount::n_neg =
      opcount::n_sqrt = 0;
  ip_solve_problem<R>(in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7],
                      in[8], rinfo, pairs, z, nullptr, nullptr, scratch, sz, 0,
                      any_active, n_iters, R(mu0), R(mu_min), R(tau),
                      R(w_max), R(s_floor), R(10.0 * ::sqrt(mu_min)),
                      R(tol_freeze), R(100.0 * tol_freeze), R(n_act));
  out[0] = opcount::n_add;
  out[1] = opcount::n_mul;
  out[2] = opcount::n_div;
  out[3] = opcount::n_neg;
  out[4] = opcount::n_sqrt;
  for (R* p : in) delete[] p;
  delete[] z;
  delete[] scratch;
}

}  // extern "C"
