// Host build of the kernels' per-problem code, compiled with a plain C++
// compiler so that the CPU tests can hold it against torch.func, JAX and the
// plain PyTorch versions without a card:
// - the in-kernel linearization (tmpc_ocp.cuh), in its serial form and in
//   the fused kernel's lane-group form;
// - the QP kernel's entries and the fused kernel's solve (qp_ip.cuh,
//   sqp_fused.cuh), each problem run by 32 emulated lanes (warp.cuh): the
//   card's partition of the work in the card's reduction order.
//
//   g++ -std=c++17 -O2 -shared -fPIC -o libtmpc_ocp_host.so tmpc_ocp_host.cpp
//
// ops/qp_cuda.py::build_host builds it. Arrays are field-major (fields,
// Bt), as in the kernels; the entries take the kernels' arguments (f64),
// and the stream argument is ignored.

#include <vector>

#include "sqp_fused.cuh"

namespace {

// qp_ip.cu's launch (the same prologue, qp_ip.cuh::qp_entry), problem
// after problem.
int host_qp_solve(bool duals, const double* H, const double* g,
                  const double* A, const double* Bm, const double* c,
                  const double* D, const double* e, const double* r0,
                  const double* mask, const int* rinfo, double* z,
                  const double* lam0, double* lam_out, int Bt, int T, int nx,
                  int nu, int m, int mhp, int any_active, int n_iters,
                  double mu0, double mu_min, double tau, double w_max,
                  double s_floor, double tol_freeze, double n_act) {
  const QpBatch<double> in{H, g, A, Bm, c, D, e, r0};
  const Rows<double> rw{mask, rinfo};
  return qp_entry<double>(
      duals, lam_out, Bt, T, nx, nu, m, mhp, mu0, mu_min, tau, w_max, s_floor,
      tol_freeze, n_act,
      [&](auto dims, const Sizes& sz, const IpParams<double>& prm) {
        using Dim = decltype(dims);
        std::vector<double> mem(qp_problem_reals<Dim::NX, Dim::NU>(sz));
        for (int b = 0; b < Bt; ++b)
          qp_solve_column<double, Dim::NX, Dim::NU>(
              Lanes{}, in, rw, sz, Bt, b, mem.data(), any_active, n_iters,
              lam0, z, lam_out, prm);
        return 0;
      });
}

}  // namespace

extern "C" {

// QpLayout<M>(T, m, mh) of model id `model` as 9 ints: H g A B c D e r0
// total. Returns 0, or -3 for a model with no instantiation.
int tmpc_qp_layout(int model, int T, int m, int mh, int* out) {
  return tmpc::with_model(model, [&](auto mdl) {
    tmpc::QpLayout<decltype(mdl)>(T, m, mh).offsets(out);
    return 0;
  });
}

// tmpc::table_layout: the tables' contract (6 ints).
void tmpc_table_layout(int* out) { tmpc::table_layout(out); }

// Linearize every problem at Z, stage after stage: the QP fields into qp
// (L.total, Bt) and (merit, cost, eq_res) into merit_out (3, Bt).
int tmpc_host_linearize_f64(const double* P, const double* x0,
                            const double* Z, double* qp, double* merit_out,
                            const int* itab, const double* rtab, int Bt,
                            int T, int m, int mh, int model, int reg) {
  const tmpc::Ocp o{itab, rtab};
  return tmpc::with_model(model, [&](auto mdl) {
    using M = decltype(mdl);
    const tmpc::QpLayout<M> L(T, m, mh);
    for (int b = 0; b < Bt; ++b) {
      const tmpc::Col<const double> Pc{P, (size_t)Bt, b},
          xc{x0, (size_t)Bt, b}, Zc{Z, (size_t)Bt, b};
      tmpc::linearize<M, double>(o, Pc, xc, Zc,
                                 tmpc::Col<double>{qp, (size_t)Bt, b}, L, reg);
      const tmpc::Col<double> mo{merit_out, (size_t)Bt, b};
      tmpc::merit<M, double>(o, Pc, xc, Zc, T, &mo[0], &mo[1], &mo[2]);
    }
    return 0;
  });
}

// The linearize entry of sqp_fused.cu (same arguments, qp may be null).
int sqp_fused_linearize_host_f64(const double* P, const double* x0,
                                 const double* Z, double* qp,
                                 double* merit_out, const int* itab,
                                 const double* rtab, int Bt, int T, int m,
                                 int mh, int model, int reg, void*) {
  if (!fused_sizes_ok(Bt, T, m, mh)) return -1;
  return tmpc::with_model(model, [&](auto mdl) {
    using M = decltype(mdl);
    const tmpc::QpLayout<M> L(T, m, mh);
    std::vector<double> red(linearize_red(T));
    for (int b = 0; b < Bt; ++b)
      linearize_column<M, double>(Lanes{}, tmpc::Ocp{itab, rtab}, P, x0, Z,
                                  qp, merit_out, Bt, b, L, reg, red.data());
    return 0;
  });
}

// The solve entry of sqp_fused.cu (same arguments).
int sqp_fused_solve_host_f64(const double* P, const double* x0,
                             const double* Z, double* out, const double* mask,
                             const int* rinfo, const int* itab,
                             const double* rtab, const int* phases,
                             int n_phases, int Bt, int T, int m, int mh,
                             int model, int any_active,
                             int track_best, int reg, double mu0,
                             double mu_min, double tau, double w_max,
                             double s_floor, double tol_freeze, double n_act,
                             void*) {
  const Rows<double> rw{mask, rinfo};
  return fused_solve_entry<double>(
      model, Bt, T, m, mh, n_phases, mu0, mu_min, tau, w_max, s_floor,
      tol_freeze, n_act, [&](const auto& F, const IpParams<double>& prm) {
        using M = typename std::decay_t<decltype(F)>::Model;
        std::vector<double> mem(F.total);
        for (int b = 0; b < Bt; ++b)
          sqp_solve_column<M, double>(Lanes{}, tmpc::Ocp{itab, rtab}, P, x0,
                                      Z, out, Bt, b, mem.data(), rw, phases,
                                      n_phases, F, any_active, track_best,
                                      reg, prm);
        return 0;
      });
}

// The cold entry of qp_ip.cu (same arguments).
int qp_ip_solve_host_f64(const double* H, const double* g, const double* A,
                         const double* Bm, const double* c, const double* D,
                         const double* e, const double* r0, const double* mask,
                         const int* rinfo, double* z, int Bt, int T, int nx,
                         int nu, int m, int mhp, int any_active, int n_iters, double mu0,
                         double mu_min, double tau, double w_max,
                         double s_floor, double tol_freeze, double n_act,
                         void*) {
  return host_qp_solve(false, H, g, A, Bm, c, D, e, r0, mask, rinfo, z,
                       nullptr, nullptr, Bt, T, nx, nu, m, mhp, any_active,
                       n_iters, mu0, mu_min, tau, w_max, s_floor, tol_freeze,
                       n_act);
}

// The duals entry of qp_ip.cu (same arguments).
int qp_ip_solve_duals_host_f64(const double* H, const double* g,
                               const double* A, const double* Bm,
                               const double* c, const double* D,
                               const double* e, const double* r0,
                               const double* mask, const int* rinfo,
                               double* z, const double* lam0, double* lam_out,
                               int Bt, int T, int nx, int nu, int m, int mhp,
                               int any_active,
                               int n_iters, double mu0, double mu_min,
                               double tau, double w_max, double s_floor,
                               double tol_freeze, double n_act, void*) {
  return host_qp_solve(true, H, g, A, Bm, c, D, e, r0, mask, rinfo, z, lam0,
                       lam_out, Bt, T, nx, nu, m, mhp, any_active,
                       n_iters, mu0, mu_min, tau, w_max, s_floor, tol_freeze,
                       n_act);
}

}  // extern "C"
