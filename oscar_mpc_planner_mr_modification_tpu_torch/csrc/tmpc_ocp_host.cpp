// Host build of the kernels' per-problem code, compiled with a plain C++
// compiler so that the CPU tests can hold it against torch.func, JAX and the
// plain PyTorch versions without a card:
// - the in-kernel linearization (tmpc_ocp.cuh), in its serial form and in
//   the fused kernel's lane-group form;
// - the QP kernel's entries and the fused kernel's solve (qp_ip.cuh,
//   sqp_fused.cuh), each problem run by 32 emulated lanes (warp.cuh): the
//   card's partition of the work in the card's reduction order;
// - the mirror linearize entry's block design (mirror_block.cuh), each
//   problem run by its block's threads in turn, and its parallel-ordered
//   Jacobi alone;
// - the single-instance kernel's solve (sqp_single.cuh, S1) and its two
//   parts alone: the "mirror" of symmetric blocks and the QP solve, each
//   problem run by W x 32 emulated threads (warp.cuh Block).
//
//   g++ -std=c++17 -O2 -shared -fPIC -o libtmpc_ocp_host.so tmpc_ocp_host.cpp
//
// ops/qp_cuda.py::build_host builds it. Arrays are field-major (fields,
// Bt), as in the kernels; the entries take the kernels' arguments (f64),
// and the stream argument is ignored.

#include <vector>

#include "mirror_block.cuh"
#include "sqp_fused.cuh"
#include "sqp_single.cuh"

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

// S1's QP dimensions on the host: qp_ip.cuh::with_dims and nx = 3 with
// nu = 1..4 (the random QPs of the JAX suite; nu = 4 factors Quu by
// Cholesky).
template <class F>
int host_single_dims(int nx, int nu, F&& f) {
  if (nx == 3 && nu == 1) return f(Dims<3, 1>{});
  if (nx == 3 && nu == 2) return f(Dims<3, 2>{});
  if (nx == 3 && nu == 3) return f(Dims<3, 3>{});
  if (nx == 3 && nu == 4) return f(Dims<3, 4>{});
  return with_dims(nx, nu, f);
}

template <int N>
void mirror_blocks(const double* H, int count, double eps, double* out) {
  constexpr int NTRI = N * (N + 1) / 2;
  std::vector<double> hp(NTRI), ws(2 * N * N);
  for (int b = 0; b < count; ++b) {
    const double* Hb = H + (size_t)b * N * N;
    for (int i = 0; i < N; ++i)
      for (int j = i; j < N; ++j) hp[tri_index(i, j, N)] = Hb[i * N + j];
    mirror_stage<N>(hp.data(), N, 0, eps, ws.data(), ws.data() + N * N);
    for (int i = 0; i < N; ++i)
      for (int j = 0; j < N; ++j)
        out[(size_t)b * N * N + i * N + j] = hp[tri_index(i, j, N)];
  }
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
// (L.total, Bt) and (merit, cost, eq_res) into merit_out (3, Bt); under
// REG_MIRROR with the Hessians mirrored.
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
      const tmpc::Col<double> qc{qp, (size_t)Bt, b};
      if (reg == tmpc::REG_MIRROR)
        tmpc::linearize<M, double, true>(o, Pc, xc, Zc, qc, L, reg);
      else
        tmpc::linearize<M, double>(o, Pc, xc, Zc, qc, L, reg);
      const tmpc::Col<double> mo{merit_out, (size_t)Bt, b};
      tmpc::merit<M, double>(o, Pc, xc, Zc, T, &mo[0], &mo[1], &mo[2]);
    }
    return 0;
  });
}

// The linearize entry of sqp_fused.cu (same arguments, qp may be null),
// and under REG_MIRROR that of sqp_linearize_mirror.cu.
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
    for (int b = 0; b < Bt; ++b) {
      const tmpc::Ocp o{itab, rtab};
      if (reg == tmpc::REG_MIRROR)  // sqp_linearize_mirror.cu's entry
        linearize_column<M, double, true>(Lanes{}, o, P, x0, Z, qp, merit_out,
                                          Bt, b, L, reg, red.data());
      else
        linearize_column<M, double>(Lanes{}, o, P, x0, Z, qp, merit_out, Bt,
                                    b, L, reg, red.data());
    }
    return 0;
  });
}

// The block design of sqp_linearize_mirror.cu (the same arguments; tables
// of REG_MIRROR), each problem on its block's threads in turn.
int sqp_linearize_mirror_block_host_f64(const double* P, const double* x0,
                                        const double* Z, double* qp,
                                        double* merit_out, const int* itab,
                                        const double* rtab, int Bt, int T,
                                        int m, int mh, int model, int reg,
                                        void*) {
  if (qp == nullptr || !fused_sizes_ok(Bt, T, m, mh)) return -1;
  if (reg != tmpc::REG_MIRROR) return -4;
  return tmpc::with_model(model, [&](auto mdl) {
    using M = decltype(mdl);
    const tmpc::QpLayout<M> L(T, m, mh);
    const MirrorBlockLayout<M> Y(T, m);
    if (Y.lin_threads > MIRROR_BLOCK_MAX) return -5;
    std::vector<double> sm((Y.template bytes<double>() + 7) / 8);
    for (int b = 0; b < Bt; ++b)
      mirror_block_column<M, double>(Block{Y.threads / WIDTH, 0},
                                     tmpc::Ocp{itab, rtab}, P, x0, Z, qp,
                                     merit_out, Bt, b, L, sm.data());
    return 0;
  });
}

// The block design's Jacobi (jacobi_stages, 16 lanes per block) on `count`
// symmetric n x n blocks H (count, n, n) at once: out (count, n, n) = V
// max(|w|, eps) V^T, all NaN for a block with a non-finite entry. Returns
// -1 for n outside 1..9.
int mirror_block_jacobi_host_f64(const double* H, int count, int n,
                                 double eps, double* out) {
  constexpr int NM = 9, G = 16, NN = NM * NM;
  if (n < 1 || n > NM || count < 1) return -1;
  const int threads = (count * G + WIDTH - 1) / WIDTH * WIDTH;
  std::vector<double> A(2 * (size_t)count * NN), V((size_t)count * NN);
  std::vector<double> rot(2 * (size_t)count * G), part(5 * (size_t)count * G);
  std::vector<unsigned char> st(threads);
  for (int b = 0; b < count; ++b)
    for (int i = 0; i < n; ++i)
      for (int j = 0; j < n; ++j)
        A[(size_t)b * NN + i * NM + j] = H[((size_t)b * n + i) * n + j];
  jacobi_stages<double, NM, G>(Block{threads / WIDTH, 0}, count,
                               [&](int) { return n; }, A.data(), V.data(),
                               rot.data(), part.data(), st.data(), eps);
  for (int b = 0; b < count; ++b) {
    const unsigned char s = st[(size_t)b * G];
    const double* a = A.data() + ((s & MB_BUF) ? (size_t)count * NN : 0) +
                      (size_t)b * NN;
    for (int i = 0; i < n; ++i)
      for (int k = 0; k < n; ++k)
        out[((size_t)b * n + i) * n + k] =
            (s & MB_BAD)
                ? NAN
                : mirror_entry<double, NM>(a, V.data() + (size_t)b * NN, n, i,
                                           k);
  }
  return 0;
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

// The card S1's blocks per SM at 8, 4 and 2 warps where registers bound
// them (255 per thread: 8 warps per SM), and an H100's 132 SMs: the host
// emulates the width block_warps picks there for a batch.
static const int HOST_PER_SM[3] = {1, 2, 4};
static const int HOST_SMS = 132;

// block_warps(Bt, sms, {p8, p4, p2}), the rule that picks S1's width.
int sqp_single_block_warps_host(int Bt, int sms, int p8, int p4, int p2) {
  const int per_sm[3] = {p8, p4, p2};
  return block_warps(Bt, sms, per_sm);
}

// The S1 entry of sqp_single.cu (same arguments), problem after problem,
// each on the warps block_warps picks for Bt problems on HOST_SMS SMs of
// HOST_PER_SM blocks.
int sqp_single_solve_host_f64(const double* in, double* out,
                              const double* mask, const int* rinfo,
                              const int* itab, const double* rtab,
                              const int* phases, int n_phases, int Bt, int T,
                              int m, int mh, int npar, int model,
                              int track_best, int reg, double mu0,
                              double mu_min, double tau, double w_max,
                              double s_floor, double tol_freeze, double n_act,
                              double res_eq_tol, void*) {
  const Rows<double> rw{mask, rinfo};
  const int W = block_warps(Bt, HOST_SMS, HOST_PER_SM);
  return single_solve_entry<double>(
      model, Bt, T, m, mh, npar, n_phases, mu0, mu_min, tau, w_max, s_floor,
      tol_freeze, n_act, [&](const auto& F, const SingleParams<double>& prm) {
        using M = typename std::decay_t<decltype(F)>::Model;
        std::vector<double> mem(F.total);
        for (int b = 0; b < Bt; ++b)
          sqp_single_column<M, double>(Block{W, 0}, tmpc::Ocp{itab, rtab}, in,
                                       out, b, npar, mem.data(), rw, phases,
                                       n_phases, F, track_best, reg, prm,
                                       res_eq_tol);
        return 0;
      });
}

// S1's mirror_stage on `count` symmetric n x n blocks H (count, n, n), read
// from their upper triangles: out (count, n, n) = V max(|w|, eps) V^T.
// Returns -1 for n outside 1..9.
int sqp_single_mirror_host_f64(const double* H, int count, int n, double eps,
                               double* out) {
  switch (n) {
    case 1: mirror_blocks<1>(H, count, eps, out); return 0;
    case 2: mirror_blocks<2>(H, count, eps, out); return 0;
    case 3: mirror_blocks<3>(H, count, eps, out); return 0;
    case 4: mirror_blocks<4>(H, count, eps, out); return 0;
    case 5: mirror_blocks<5>(H, count, eps, out); return 0;
    case 6: mirror_blocks<6>(H, count, eps, out); return 0;
    case 7: mirror_blocks<7>(H, count, eps, out); return 0;
    case 8: mirror_blocks<8>(H, count, eps, out); return 0;
    case 9: mirror_blocks<9>(H, count, eps, out); return 0;
    default: return -1;
  }
}

// S1's solve_qp_problem on one QP, on MAX_WARPS emulated warps, in its
// layout (tmpc::QpLayout's fields: H the upper triangles, D the generic
// rows dense over z, contiguous), with
// the stage mask and row table of ops/qp_cuda.py::_row_tables: the best
// iterate into z_out (T*nz), s_out and lam_out (T*m), its complementarity
// and equality residual into comp_eq (2). Returns -1 for sizes out of
// range, -3 for an (nx, nu) with no host instantiation.
int sqp_single_qp_host_f64(const double* H, const double* g, const double* A,
                           const double* Bm, const double* c, const double* D,
                           const double* e, const double* r0,
                           const double* mask, const int* rinfo, int T, int nx,
                           int nu, int m, int mhp, int n_iters, double mu0,
                           double mu_min, double tau, double w_max,
                           double s_floor, double tol_freeze, double n_act,
                           double* z_out, double* s_out, double* lam_out,
                           double* comp_eq) {
  if (T < 2 || m < 1 || mhp < 1 || n_iters < 0) return -1;
  const Sizes sz{T, m, mhp};
  const SingleParams<double> prm{mu0,       mu_min,         tau,
                                 w_max,     s_floor,        tol_freeze,
                                 100.0 * tol_freeze, 1e3 * tol_freeze,
                                 n_act,     1e30};
  return host_single_dims(nx, nu, [&](auto dims) {
    using Dim = decltype(dims);
    constexpr int NZ = Dim::NX + Dim::NU;
    const SingleScratch<Dim::NX, Dim::NU> sc(sz);
    std::vector<double> mem(sc.total);
    const SingleState<double> st = sc.state(mem.data());
    const QpView<double> q{H, g, A, Bm, c, D, e, r0};
    solve_qp_problem<double, Dim::NX, Dim::NU>(Block{MAX_WARPS, 0}, q,
                                               Rows<double>{mask, rinfo}, sz,
                                               st, n_iters, prm, &comp_eq[0],
                                               &comp_eq[1]);
    for (int f = 0; f < T * NZ; ++f) z_out[f] = st.bz[f];
    for (int f = 0; f < T * m; ++f) {
      s_out[f] = st.bs[f];
      lam_out[f] = st.blam[f];
    }
    return 0;
  });
}

}  // extern "C"
