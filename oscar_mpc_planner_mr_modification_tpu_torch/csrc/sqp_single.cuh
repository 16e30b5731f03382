// The per-problem code of the single-instance SQP kernel (sqp_single.cu,
// S1), one lane group (warp.cuh) per problem, shared with the host builds
// (tmpc_ocp_host.cpp, qp_ip_count.cpp).
//
// S1 runs the JAX package's single-instance algorithm
// (ops/sqp.py::make_sqp_solver over ops/qp.py::solve_qp), which differs from
// the fleet kernels' (qp_ip.cuh::ip_solve_problem):
// - solve_qp_problem(): the interior-point QP with the centred start, the
//   convergence freeze on complementarity, the inequality and equality
//   residuals AND the stationarity proxy (the affine step's size), an exact
//   NaN guard (any NaN in dz, ds or dlam), the best-merit iterate
//   (merit = comp + feas + eqr + stat of the pre-step iterate, with best-of
//   copies of z, s and lam), and the returned iterate's complementarity and
//   equality residual. spd_factor's closed-form inverse for nu <= 3 and a
//   Cholesky factor above, as the plain version (ops/qp.py) has them;
// - mirror_stage(): the "mirror" regularization, V max(|w|, eps) V^T of a
//   stage's Hessian block by cyclic Jacobi; JAX's eigh, whose V differs in
//   sign and order but not V |w| V^T;
// - sqp_single_column(): the SQP loop of make_sqp_solver.solve (every
//   schedule phase, the full step kept back where it has a NaN, the
//   best-merit SQP iterate with track_best, qp_comp the last QP's
//   complementarity, success from the final equality residual).
//
// Lanes take rows and stages as in qp_ip.cuh: row passes lane r over row r
// (every row, masked or not, so that a non-finite masked entry propagates
// as the plain version's masked products do), Hbar and gbar lane t over
// stage t, the Riccati sweeps uniform code; reductions are combined in row
// (or lane) order by uniform code. qp_ip.cuh's build_hbar and gbar_accum
// compute the plain version's sums and are reused; the factorization and
// the vector sweep are S1's own (the inverse divides by the determinant, as
// spd_factor does; the Cholesky branch for nu > 3).

#pragma once

#include <type_traits>

#include "mirror.cuh"
#include "qp_ip.cuh"
#include "tmpc_ocp.cuh"

namespace {

using tmpc::Col;

// The tables' regularization kind for "mirror" (ops/sqp_fused.py::
// ocp_tables(..., mirror=True)): S1's linearization stores the raw Hessian
// (tmpc::store_hessian shifts only for REG_GERSHGORIN and REG_LEVENBERG) and
// S1 mirrors it.
using tmpc::REG_MIRROR;

template <typename real>
struct SingleParams {
  // mu0, mu_min, tau, w_max, s_floor as JAX's solve_qp; tol_freeze and the
  // freeze's residual (100 tol) and stationarity (1e3 tol) thresholds;
  // n_act = max(unmasked entries, 1); big, the fraction-to-boundary's
  // "no limit" (1e30).
  real mu0, mu_min, tau, w_max, s_floor, tol_freeze, tol_res, tol_stat, n_act,
      big;
};

template <typename real>
struct SingleState {
  IpState<real> w;       // qp_ip.cuh's interior-point state
  real *bz, *bs, *blam;  // the best-merit iterate
  real* flags;           // one per lane
};

// Offsets, in reals, of the interior-point state of solve_qp_problem:
// qp_ip.cuh's Scratch, then the best-of copies of z, s and lam and a flag
// per lane.
template <int NX, int NU>
struct SingleScratch {
  static constexpr int NZ = NX + NU;
  Scratch<NX, NU> ip;
  int bz, bs, blam, flags, total;
  __host__ __device__ explicit SingleScratch(const Sizes& sz) : ip(sz) {
    bz = ip.total;
    bs = bz + sz.T * NZ;
    blam = bs + sz.T * sz.m;
    flags = blam + sz.T * sz.m;
    total = flags + WIDTH;
  }
  template <typename real>
  __host__ __device__ SingleState<real> state(real* b) const {
    return SingleState<real>{ip.state(b), b + bz, b + bs, b + blam,
                             b + flags};
  }
};

// Finite (neither NaN nor infinite), by comparisons alone.
template <typename real>
WARP_FN bool is_finite(real v) {
  return v == v && fabs(v) != real(INFINITY);
}

// ---- the Riccati sweeps (JAX ops/qp.py::riccati_factor, _solve_vec) -------
// Quu's factor into `Lf`: the inverse (adjugate over determinant) for
// N <= 3, the lower Cholesky factor above (NaN where a pivot is not
// positive).
template <typename real, int N>
WARP_FN void spd_factor(const real* M, real* Lf) {
  if constexpr (N == 1) {
    Lf[0] = real(1) / M[0];
  } else if constexpr (N == 2) {
    const real a = M[0], b = M[1], d = M[3];
    const real det = a * d - b * b;
    const real nb = -b;
    Lf[0] = d / det;
    Lf[1] = nb / det;
    Lf[2] = nb / det;
    Lf[3] = a / det;
  } else if constexpr (N == 3) {
    const real a = M[0], b = M[1], c = M[2];
    const real d = M[4], e = M[5], f = M[8];
    const real A00 = d * f - e * e;
    const real A01 = c * e - b * f;
    const real A02 = b * e - c * d;
    const real A11 = a * f - c * c;
    const real A12 = b * c - a * e;
    const real A22 = a * d - b * b;
    const real det = a * A00 + b * A01 + c * A02;
    const real adj[9] = {A00, A01, A02, A01, A11, A12, A02, A12, A22};
    for (int i = 0; i < 9; ++i) Lf[i] = adj[i] / det;
  } else {
    bool ok = true;
    for (int j = 0; j < N; ++j) {
      real d = M[j * N + j];
      for (int k = 0; k < j; ++k) d = d - Lf[j * N + k] * Lf[j * N + k];
      ok = ok && d > real(0);
      const real ljj = sqrt(d);
      Lf[j * N + j] = ljj;
      for (int i = j + 1; i < N; ++i) {
        real acc = M[i * N + j];
        for (int k = 0; k < j; ++k) acc = acc - Lf[i * N + k] * Lf[j * N + k];
        Lf[i * N + j] = acc / ljj;
      }
      for (int i = 0; i < j; ++i) Lf[i * N + j] = real(0);
    }
    if (!ok)
      for (int i = 0; i < N * N; ++i) Lf[i] = real(NAN);
  }
}

// x = -M^{-1} rhs for one right-hand side (stride rs between its entries)
// from spd_factor's Lf: the product by -inverse for N <= 3, two triangular
// solves above.
template <typename real, int N>
WARP_FN void spd_neg_solve(const real* Lf, const real* rhs, int rs, real* x) {
  if constexpr (N <= 3) {
    for (int i = 0; i < N; ++i) {
      real acc = Lf[i * N] * rhs[0];
      for (int c = 1; c < N; ++c) acc = acc + Lf[i * N + c] * rhs[c * rs];
      x[i] = -acc;
    }
  } else {
    real y[N];
    for (int i = 0; i < N; ++i) {
      real acc = rhs[i * rs];
      for (int k = 0; k < i; ++k) acc = acc - Lf[i * N + k] * y[k];
      y[i] = acc / Lf[i * N + i];
    }
    for (int i = N - 1; i >= 0; --i) {
      real acc = y[i];
      for (int k = i + 1; k < N; ++k) acc = acc - Lf[k * N + i] * x[k];
      x[i] = acc / Lf[i * N + i];
    }
    for (int i = 0; i < N; ++i) x[i] = -x[i];
  }
}

// Backward matrix sweep over Hbar: K, Quu's factor, Qux and P_{k+1} per
// stage; P_k = 0.5 (S + S^T) with S = Qxx + Qux^T K.
template <typename real, int NX, int NU>
WARP_FN void single_factor(const Lanes& L, const QpView<real>& q,
                           const IpState<real>& w, int T) {
  constexpr int NZ = NX + NU;
  real* const Pt = w.tmp;
  real* const PA = Pt + NX * NX;
  real* const PB = PA + NX * NX;
  real* const Quu = PB + NX * NU;
  real* const Qxx = Quu + NU * NU;
  const real* hbT = w.hbar + (T - 1) * NZ * NZ;
  L.run([&](int l) {
    for (int e = l; e < NX * NX; e += WIDTH)
      Pt[e] = hbT[(NU + e / NX) * NZ + NU + e % NX];
  });
  for (int k = T - 2; k >= 0; --k) {
    const real* A = q.A + k * NX * NX;
    const real* B = q.B + k * NX * NU;
    const real* hb = w.hbar + k * NZ * NZ;
    real* Pn = w.Pn + k * NX * NX;
    real* Qux = w.Qux + k * NU * NX;
    real* K = w.K + k * NU * NX;
    // PA = P A, PB = P B; P (= P_{k+1}) kept for the vector sweeps
    L.run([&](int l) {
      for (int e = l; e < NX * NX + NX * NU; e += WIDTH) {
        if (e < NX * NX) {
          const int i = e / NX, j = e % NX;
          real acc = Pt[i * NX] * A[j];
          for (int c = 1; c < NX; ++c) acc = acc + Pt[i * NX + c] * A[c * NX + j];
          PA[e] = acc;
          Pn[e] = Pt[e];
        } else {
          const int e2 = e - NX * NX, i = e2 / NU, j = e2 % NU;
          real acc = Pt[i * NX] * B[j];
          for (int c = 1; c < NX; ++c) acc = acc + Pt[i * NX + c] * B[c * NU + j];
          PB[e2] = acc;
        }
      }
    });
    // Quu = Hbar_uu + B^T PB, Qux = Hbar_ux + B^T PA, Qxx = Hbar_xx + A^T PA
    L.run([&](int l) {
      for (int e = l; e < NU * NU + NU * NX + NX * NX; e += WIDTH) {
        if (e < NU * NU) {
          const int i = e / NU, j = e % NU;
          real acc = B[i] * PB[j];
          for (int c = 1; c < NX; ++c) acc = acc + B[c * NU + i] * PB[c * NU + j];
          Quu[e] = hb[i * NZ + j] + acc;
        } else if (e < NU * NU + NU * NX) {
          const int e2 = e - NU * NU, i = e2 / NX, j = e2 % NX;
          real acc = B[i] * PA[j];
          for (int c = 1; c < NX; ++c) acc = acc + B[c * NU + i] * PA[c * NX + j];
          Qux[e2] = hb[i * NZ + NU + j] + acc;
        } else {
          const int e2 = e - NU * NU - NU * NX, i = e2 / NX, j = e2 % NX;
          real acc = A[i] * PA[j];
          for (int c = 1; c < NX; ++c) acc = acc + A[c * NX + i] * PA[c * NX + j];
          Qxx[e2] = hb[(NU + i) * NZ + NU + j] + acc;
        }
      }
    });
    // Uniform: Quu's factor, K = -Quu^{-1} Qux, S = Qxx + Qux^T K and
    // P_k = 0.5 (S + S^T), in registers; lane 0 stores K, the factor and P.
    real Lf[NU * NU], Kr[NU * NX], S[NX * NX];
    spd_factor<real, NU>(Quu, Lf);
    for (int j = 0; j < NX; ++j) {
      real col[NU];
      spd_neg_solve<real, NU>(Lf, Qux + j, NX, col);
      for (int i = 0; i < NU; ++i) Kr[i * NX + j] = col[i];
    }
    for (int e = 0; e < NX * NX; ++e) {
      const int i = e / NX, j = e % NX;
      real acc = Qux[i] * Kr[j];
      for (int c = 1; c < NU; ++c) acc = acc + Qux[c * NX + i] * Kr[c * NX + j];
      S[e] = Qxx[e] + acc;
    }
    real* Lk = w.Linv + k * NU * NU;
    L.one([&] {
      for (int e = 0; e < NU * NU; ++e) Lk[e] = Lf[e];
      for (int e = 0; e < NU * NX; ++e) K[e] = Kr[e];
      for (int e = 0; e < NX * NX; ++e) {
        const int i = e / NX, j = e % NX;
        Pt[e] = real(0.5) * (S[i * NX + j] + S[j * NX + i]);
      }
    });
  }
}

// Vector sweep + forward rollout: dz from gbar, the dynamics residuals rd
// and the initial residual r0 (qp_ip.cuh::solve_vec's partition, with
// kff = -Quu^{-1} qu from the factor). Uniform code; lane 0 stores.
template <typename real, int NX, int NU>
WARP_FN void single_solve_vec(const Lanes& L, const QpView<real>& q,
                              const IpState<real>& w, int T, const real* rd,
                              const real* r0) {
  constexpr int NZ = NX + NU;
  real p[NX];
  for (int i = 0; i < NX; ++i) p[i] = w.gbar[(T - 1) * NZ + NU + i];
  for (int k = T - 2; k >= 0; --k) {
    const real* A = q.A + k * NX * NX;
    const real* B = q.B + k * NX * NU;
    const real* Pn = w.Pn + k * NX * NX;
    const real* Lk = w.Linv + k * NU * NU;
    const real* Qux = w.Qux + k * NU * NX;
    const real* rdk = rd + k * NX;
    real beta[NX], qu[NU], qx[NX], kff[NU];
    for (int i = 0; i < NX; ++i) {
      real acc = Pn[i * NX] * rdk[0];
      for (int c = 1; c < NX; ++c) acc = acc + Pn[i * NX + c] * rdk[c];
      beta[i] = p[i] + acc;
    }
    for (int i = 0; i < NU; ++i) {
      real acc = B[i] * beta[0];
      for (int c = 1; c < NX; ++c) acc = acc + B[c * NU + i] * beta[c];
      qu[i] = w.gbar[k * NZ + i] + acc;
    }
    for (int i = 0; i < NX; ++i) {
      real acc = A[i] * beta[0];
      for (int c = 1; c < NX; ++c) acc = acc + A[c * NX + i] * beta[c];
      qx[i] = w.gbar[k * NZ + NU + i] + acc;
    }
    spd_neg_solve<real, NU>(Lk, qu, 1, kff);
    L.one([&] {
      for (int i = 0; i < NU; ++i) w.kff[k * NU + i] = kff[i];
    });
    for (int i = 0; i < NX; ++i) {
      real acc = Qux[i] * kff[0];
      for (int c = 1; c < NU; ++c) acc = acc + Qux[c * NX + i] * kff[c];
      p[i] = qx[i] + acc;
    }
  }
  L.run([](int) {});  // kff visible to every lane
  real dx[NX];
  for (int i = 0; i < NX; ++i) dx[i] = r0[i];
  for (int k = 0; k < T - 1; ++k) {
    const real* A = q.A + k * NX * NX;
    const real* B = q.B + k * NX * NU;
    const real* K = w.K + k * NU * NX;
    real du[NU], dxn[NX];
    for (int i = 0; i < NU; ++i) {
      real acc = K[i * NX] * dx[0];
      for (int c = 1; c < NX; ++c) acc = acc + K[i * NX + c] * dx[c];
      du[i] = acc + w.kff[k * NU + i];
    }
    for (int i = 0; i < NX; ++i) {
      real acc_a = A[i * NX] * dx[0];
      for (int c = 1; c < NX; ++c) acc_a = acc_a + A[i * NX + c] * dx[c];
      real acc_b = B[i * NU] * du[0];
      for (int c = 1; c < NU; ++c) acc_b = acc_b + B[i * NU + c] * du[c];
      dxn[i] = (acc_a + acc_b) + rd[k * NX + i];
    }
    L.one([&] {
      for (int i = 0; i < NU; ++i) w.dz[k * NZ + i] = du[i];
      for (int i = 0; i < NX; ++i) w.dz[k * NZ + NU + i] = dx[i];
    });
    for (int i = 0; i < NX; ++i) dx[i] = dxn[i];
  }
  L.one([&] {
    for (int i = 0; i < NU; ++i) w.dz[(T - 1) * NZ + i] = real(0);
    for (int i = 0; i < NX; ++i) w.dz[(T - 1) * NZ + NU + i] = dx[i];
  });
}

// rd_k = A dx_k + B du_k + c_k - dx_{k+1} of the iterate zv into rd, and
// r0 - dx_0 into r0res (lanes over entries).
template <typename real, int NX, int NU>
WARP_FN void dyn_residual(int l, const QpView<real>& q, const real* zv, int T,
                          real* rd, real* r0res) {
  constexpr int NZ = NX + NU;
  for (int e = l; e < (T - 1) * NX; e += WIDTH) {
    const int k = e / NX, i = e % NX;
    real ax = q.A[(k * NX + i) * NX] * zv[k * NZ + NU];
    for (int j = 1; j < NX; ++j)
      ax = ax + q.A[(k * NX + i) * NX + j] * zv[k * NZ + NU + j];
    real bu = q.B[(k * NX + i) * NU] * zv[k * NZ];
    for (int j = 1; j < NU; ++j) bu = bu + q.B[(k * NX + i) * NU + j] * zv[k * NZ + j];
    rd[e] = ((ax + bu) + q.c[e]) - zv[(k + 1) * NZ + NU + i];
  }
  if (l < NX) r0res[l] = q.r0[l] - zv[NU + l];
}

// One QP by JAX's solve_qp with n_iters interior-point iterations (see the
// file comment). Leaves the best-merit iterate in st.bz / st.bs / st.blam;
// every lane returns its complementarity and equality residual.
template <typename real, int NX, int NU>
__device__ void solve_qp_problem(const Lanes& L, const QpView<real>& q,
                                 const Rows<real>& rw, const Sizes& sz,
                                 const SingleState<real>& st, int n_iters,
                                 const SingleParams<real>& p, real* comp_out,
                                 real* eq_out) {
  constexpr int NZ = NX + NU, NTRI = NZ * (NZ + 1) / 2;
  const IpState<real>& w = st.w;
  const int T = sz.T, m = sz.m, mhp = sz.mhp;
  const real inf = real(INFINITY);
  const real* mask = rw.mask;
  const int* rinfo = rw.rinfo;
  real* const red0 = w.red;
  real* const red1 = red0 + w.R;
  real* const red2 = red1 + w.R;
  real* const red3 = red2 + w.R;
  real* const W = w.ds;      // the weights; ds is free until the corrector
  real* const dlam = w.rin;  // the corrector's dlam; rin is read just before

  // Centred start: s0 = max(e, sqrt(mu0)), lam0 = mu0 / s0; z0 = 0.
  const real v0 = sqrt(p.mu0);
  L.run([&](int l) {
    for (int r = l; r < m; r += WIDTH)
      for (int t = 0; t < T; ++t) {
        const int f = t * m + r;
        real sv = real(1), lv = real(0);
        if (mask[f] > real(0)) {
          sv = nmax(q.e[f], v0);
          lv = p.mu0 / sv;
        }
        w.s[f] = sv;
        w.lam[f] = lv;
        st.bs[f] = sv;
        st.blam[f] = lv;
      }
    for (int f = l; f < T * NZ; f += WIDTH) {
      w.z[f] = real(0);
      st.bz[f] = real(0);
    }
  });
  real best = inf;
  for (int it = 0; it < n_iters; ++it) {
    // ---- row residuals, W, comp, feas, max(mask lam) (lanes over rows) --
    L.run([&](int l) {
      for (int r = l; r < m; r += WIDTH) {
        const int* ri = rinfo + r * RK_W;
        real c_r = real(0), f_r = real(0), l_r = real(0);
        for (int t = 0; t < T; ++t) {
          const int f = t * m + r;
          const real mk = mask[f], sv = w.s[f], lv = w.lam[f];
          const real rin = row_dz<real, NZ>(ri, q.D, mhp, w.z, t) + q.e[f] - sv;
          w.rin[f] = rin;
          W[f] = nmin(mk * lv / sv, p.w_max);
          c_r = c_r + mk * sv * lv;
          f_r = nmax(f_r, fabs(mk * rin));
          l_r = nmax(l_r, mk * lv);
        }
        red0[r] = c_r;
        red1[r] = f_r;
        red2[r] = l_r;
      }
    });
    real comp = real(0), feas = real(0), lam_max = real(0);
    for (int r = 0; r < m; ++r) {
      comp = comp + red0[r];
      feas = nmax(feas, red1[r]);
      lam_max = nmax(lam_max, red2[r]);
    }
    comp = comp / p.n_act;
    build_hbar<real, NX, NU>(L, q, w, W, rw, sz);
    single_factor<real, NX, NU>(L, q, w, T);

    // ---- equality residuals, H z + g, max |z| -----------------------------
    L.run([&](int l) {
      dyn_residual<real, NX, NU>(l, q, w.z, T, w.rd, w.r0res);
      real zm = real(0);
      for (int e = l; e < T * NZ; e += WIDTH) {
        const int t = e / NZ, i = e % NZ;
        real acc = q.H[t * NTRI + tri_index(i, 0, NZ)] * w.z[t * NZ];
        for (int j = 1; j < NZ; ++j)
          acc = acc + q.H[t * NTRI + tri_index(i, j, NZ)] * w.z[t * NZ + j];
        w.hzg[e] = acc + q.g[e];
        zm = nmax(zm, fabs(w.z[e]));
      }
      red3[l] = zm;
    });
    real z_max = real(0);
    for (int l = 0; l < WIDTH; ++l) z_max = nmax(z_max, red3[l]);

    // ---- affine (predictor) step -----------------------------------------
    gbar_accum<real, NX, NU>(L, q, w, rw, sz, nullptr);
    single_solve_vec<real, NX, NU>(L, q, w, T, w.rd, w.r0res);
    L.run([&](int l) {
      for (int r = l; r < m; r += WIDTH) {
        const int* ri = rinfo + r * RK_W;
        real a_s = inf, a_l = inf, d_r = real(0);
        for (int t = 0; t < T; ++t) {
          const int f = t * m + r;
          const real mk = mask[f], sv = w.s[f], lv = w.lam[f];
          real dsa = real(0), dla = real(0);
          if (mk > real(0)) {
            dsa = row_dz<real, NZ>(ri, q.D, mhp, w.dz, t) + w.rin[f];
            dla = (real(0) - sv * lv) / sv - (lv / sv) * dsa;
          }
          w.dsa[f] = dsa;
          a_s = nmin(a_s, ftb(sv, dsa, mk, p.big));
          a_l = nmin(a_l, ftb(lv, dla, mk, p.big));
          d_r = nmax(d_r, fabs(mk * dla));
        }
        red0[r] = a_s;
        red1[r] = a_l;
        red2[r] = d_r;
      }
      real dm = real(0);
      for (int e = l; e < T * NZ; e += WIDTH) dm = nmax(dm, fabs(w.dz[e]));
      red3[l] = dm;
    });
    real ftb_s = inf, ftb_l = inf, dlam_max = real(0), dz_max = real(0);
    for (int r = 0; r < m; ++r) {
      ftb_s = nmin(ftb_s, red0[r]);
      ftb_l = nmin(ftb_l, red1[r]);
      dlam_max = nmax(dlam_max, red2[r]);
    }
    for (int l = 0; l < WIDTH; ++l) dz_max = nmax(dz_max, red3[l]);
    const real alpha_aff = nmin(real(1), nmin(ftb_s, ftb_l));
    L.run([&](int l) {
      for (int r = l; r < m; r += WIDTH) {
        real c_r = real(0);
        for (int t = 0; t < T; ++t) {
          const int f = t * m + r;
          const real mk = mask[f], sv = w.s[f], lv = w.lam[f];
          const real dsa = w.dsa[f];
          const real dla =
              mk > real(0) ? (real(0) - sv * lv) / sv - (lv / sv) * dsa : real(0);
          c_r = c_r + mk * (sv + alpha_aff * dsa) * (lv + alpha_aff * dla);
        }
        red1[r] = c_r;
      }
    });
    real comp_aff = real(0);
    for (int r = 0; r < m; ++r) comp_aff = comp_aff + red1[r];
    comp_aff = comp_aff / p.n_act;
    const real ratio = comp_aff / nmax(comp, real(1e-30));
    const real sigma = nmin(nmax(ratio * ratio * ratio, real(1e-8)), real(1));
    const real mu = nmax(sigma * comp, p.mu_min);

    // ---- corrector step: rhs3 = mu - ds_a dlam_a into dsa -----------------
    L.run([&](int l) {
      for (int r = l; r < m; r += WIDTH)
        for (int t = 0; t < T; ++t) {
          const int f = t * m + r;
          const real mk = mask[f], sv = w.s[f], lv = w.lam[f];
          const real dsa = w.dsa[f];
          const real dla =
              mk > real(0) ? (real(0) - sv * lv) / sv - (lv / sv) * dsa : real(0);
          w.dsa[f] = mu - dsa * dla;
        }
    });
    gbar_accum<real, NX, NU>(L, q, w, rw, sz, w.dsa);
    single_solve_vec<real, NX, NU>(L, q, w, T, w.rd, w.r0res);
    L.run([&](int l) {
      for (int r = l; r < m; r += WIDTH) {
        const int* ri = rinfo + r * RK_W;
        real a_p = inf, a_d = inf, bad_r = real(0);
        for (int t = 0; t < T; ++t) {
          const int f = t * m + r;
          const real mk = mask[f], sv = w.s[f], lv = w.lam[f];
          real dsv = real(0), dlv = real(0);
          if (mk > real(0)) {
            dsv = row_dz<real, NZ>(ri, q.D, mhp, w.dz, t) + w.rin[f];
            dlv = (w.dsa[f] - sv * lv) / sv - (lv / sv) * dsv;
          }
          w.ds[f] = dsv;
          dlam[f] = dlv;
          a_p = nmin(a_p, ftb(sv, dsv, mk, p.big));
          a_d = nmin(a_d, ftb(lv, dlv, mk, p.big));
          if (dsv != dsv || dlv != dlv) bad_r = real(1);
        }
        red0[r] = a_p;
        red1[r] = a_d;
        red2[r] = bad_r;
      }
      real e_l = real(0), bad_l = real(0);
      for (int e = l; e < (T - 1) * NX; e += WIDTH) e_l = nmax(e_l, fabs(w.rd[e]));
      if (l < NX) e_l = nmax(e_l, fabs(w.r0res[l]));
      for (int e = l; e < T * NZ; e += WIDTH)
        if (w.dz[e] != w.dz[e]) bad_l = real(1);
      red3[l] = e_l;
      st.flags[l] = bad_l;
    });
    real alpha_p = inf, alpha_d = inf, eqr = real(0);
    bool bad = false;
    for (int r = 0; r < m; ++r) {
      alpha_p = nmin(alpha_p, red0[r]);
      alpha_d = nmin(alpha_d, red1[r]);
      bad = bad || red2[r] > real(0);
    }
    for (int l = 0; l < WIDTH; ++l) {
      eqr = nmax(eqr, red3[l]);
      bad = bad || st.flags[l] > real(0);
    }
    alpha_p = nmin(real(1), p.tau * alpha_p);
    alpha_d = nmin(real(1), p.tau * alpha_d);

    // ---- the freeze, the NaN guard, the best-merit iterate ---------------
    const real stat = nmax(dz_max / (real(1) + z_max),
                           dlam_max / (real(1) + lam_max));
    const bool done = (comp < p.tol_freeze) && (feas < p.tol_res) &&
                      (eqr < p.tol_res) && (stat < p.tol_stat);
    const real scale = (done || bad) ? real(0) : real(1);
    alpha_p = alpha_p * scale;
    alpha_d = alpha_d * scale;
    const real merit = comp + feas + eqr + stat;
    const bool better = merit < best;
    if (better) best = merit;

    L.run([&](int l) {
      for (int f = l; f < T * NZ; f += WIDTH) {
        if (better) st.bz[f] = w.z[f];
        w.z[f] = w.z[f] + alpha_p * w.dz[f];
      }
      for (int r = l; r < m; r += WIDTH)
        for (int t = 0; t < T; ++t) {
          const int f = t * m + r;
          const real sv = w.s[f], lv = w.lam[f];
          if (better) {
            st.bs[f] = sv;
            st.blam[f] = lv;
          }
          if (mask[f] > real(0)) {
            w.s[f] = nmax(sv + alpha_p * w.ds[f], p.s_floor);
            w.lam[f] = nmax(lv + alpha_d * dlam[f], real(0));
          } else {
            w.s[f] = real(1);
            w.lam[f] = real(0);
          }
        }
    });
  }

  // ---- the returned (best) iterate's comp and equality residual ----------
  L.run([&](int l) {
    for (int r = l; r < m; r += WIDTH) {
      real c_r = real(0);
      for (int t = 0; t < T; ++t) {
        const int f = t * m + r;
        c_r = c_r + mask[f] * st.bs[f] * st.blam[f];
      }
      red0[r] = c_r;
    }
    dyn_residual<real, NX, NU>(l, q, st.bz, T, w.rd, w.r0res);
  });
  L.run([&](int l) {
    real e_l = real(0);
    for (int e = l; e < (T - 1) * NX; e += WIDTH) e_l = nmax(e_l, fabs(w.rd[e]));
    if (l < NX) e_l = nmax(e_l, fabs(w.r0res[l]));
    red3[l] = e_l;
  });
  real comp = real(0), eq = real(0);
  for (int r = 0; r < m; ++r) comp = comp + red0[r];
  for (int l = 0; l < WIDTH; ++l) eq = nmax(eq, red3[l]);
  *comp_out = comp / p.n_act;
  *eq_out = eq;
}

// ---- the "mirror" regularization ----------------------------------------
// The n x n block at (off, off) of one stage's packed upper triangle Hp
// (NZ x NZ, tmpc::QpLayout's H) replaced by V max(|w|, eps) V^T
// (mirror.cuh, shared with the linearize entry's mirror variant). A block
// with a non-finite entry comes out all NaN, as JAX's eigh gives it. A and
// V: n * n reals of workspace each.
template <int NZ, typename real>
WARP_FN void mirror_stage(real* Hp, int n, int off, real eps, real* A,
                          real* V) {
  bool finite_all = true;
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) {
      const real v = Hp[tri_index(off + i, off + j, NZ)];
      A[i * n + j] = v;
      finite_all = finite_all && mirror::is_finite(v);
    }
  if (!finite_all) {
    for (int i = 0; i < n; ++i)
      for (int j = i; j < n; ++j) Hp[tri_index(off + i, off + j, NZ)] = real(NAN);
    return;
  }
  mirror::jacobi(A, V, n, eps);
  for (int i = 0; i < n; ++i)
    for (int k = i; k < n; ++k)
      Hp[tri_index(off + i, off + k, NZ)] = mirror::entry(A, V, n, i, k);
}

// Workspace reals of the mirror pass: two NZ x NZ blocks per lane slot.
template <int NZ>
__host__ __device__ inline int mirror_reals(int T) {
  return (T < WIDTH ? T : WIDTH) * 2 * NZ * NZ;
}

// The mirror pass over one problem's linearized Hessians (JAX sqp.py's
// build_qp under "mirror"): lane t mirrors stage t's whole block, at stage
// N = T-1 only the x block (the u block is the identity, the u-x blocks 0).
template <int NX, int NU, typename real>
WARP_FN void mirror_pass(const Lanes& L, real* H, int T, real eps, real* ws) {
  constexpr int NZ = NX + NU, NTRI = NZ * (NZ + 1) / 2;
  L.run([&](int l) {
    real* A = ws + l * 2 * NZ * NZ;
    for (int t = l; t < T; t += WIDTH) {
      if (t < T - 1)
        mirror_stage<NZ>(H + t * NTRI, NZ, 0, eps, A, A + NZ * NZ);
      else
        mirror_stage<NZ>(H + t * NTRI, NX, NU, eps, A, A + NZ * NZ);
    }
  });
}

// ---- the SQP loop (JAX make_sqp_solver.solve) ----------------------------
// Offsets, in reals, of one problem's memory in S1: its QP, the iterate, the
// best iterate, and the interior-point state (which the mirror pass uses as
// its workspace between solves).
template <class M>
struct SingleOffsets {
  using Model = M;
  tmpc::QpLayout<M> L;
  Sizes sz;
  int qp, z, zbest, ip, total;
  __host__ __device__ SingleOffsets(int T, int m, int mh)
      : L(T, m, mh), sz{T, m, L.mhp} {
    qp = 0;
    z = L.total;
    zbest = z + T * M::NZ;
    ip = zbest + T * M::NZ;
    const int st = SingleScratch<M::NX, M::NU>(sz).total;
    const int ws = mirror_reals<M::NZ>(T);
    total = ip + (st > ws ? st : ws);
  }
};

// Reals of one problem's input block: P (npar * T, field p * T + t, stage
// N repeating N-1), x0 (NX), Z0 (T * NZ); and of its output block: z
// (T * NZ), cost, eq_res, qp_comp, exit_code, success (ops/sqp.py::
// pack_results' layout).
__host__ __device__ inline int single_in_reals(int npar, int T, int nx,
                                               int nz) {
  return npar * T + nx + T * nz;
}
__host__ __device__ inline int single_out_reals(int T, int nz) {
  return T * nz + 5;
}

// Problem b's whole solve: for every phase (n_sqp, n_qp) of `phases`, n_sqp
// times: linearize at the iterate, mirror (reg == REG_MIRROR), solve the QP
// with n_qp iterations, take the full step unless it has a NaN; with
// track_best keep the best iterate by merit (cost + w eq_res, the
// initial-condition residual included). Batch-major in / out blocks.
template <class M, typename real>
__device__ void sqp_single_column(
    const Lanes& lanes, const tmpc::Ocp& o, const real* in, real* out, int b,
    int npar, real* mem, const Rows<real>& rw, const int* phases,
    int n_phases, const SingleOffsets<M>& F, int track_best, int reg,
    const SingleParams<real>& prm, real res_eq_tol) {
  constexpr int NX = M::NX, NU = M::NU, NZ = M::NZ;
  const int T = F.sz.T, nzT = T * NZ;
  const tmpc::QpLayout<M>& L = F.L;
  const real* inb = in + (size_t)b * single_in_reals(npar, T, NX, NZ);
  real* outb = out + (size_t)b * single_out_reals(T, NZ);
  const real* Z0 = inb + npar * T + NX;
  real* qp = mem + F.qp;
  real* z = mem + F.z;
  real* zbest = mem + F.zbest;
  const SingleState<real> st = SingleScratch<NX, NU>(F.sz).state(mem + F.ip);
  const IpState<real>& w = st.w;
  const Col<const real> Pc{inb, 1, 0}, xc{inb + npar * T, 1, 0};
  const Col<const real> zc{z, 1, 0}, zbc{zbest, 1, 0};
  const QpView<real> q{qp + L.H, qp + L.g, qp + L.A, qp + L.B,
                       qp + L.c, qp + L.D, qp + L.e, qp + L.r0};
  const real reg_eps = real(o.rt[tmpc::RT_REG_EPS]);

  lanes.run([&](int l) {
    for (int f = l; f < nzT; f += WIDTH) z[f] = Z0[f];
  });
  real best = real(0), mv, cost, eq, qp_comp = real(0), qp_eq;
  if (track_best) {
    tmpc::merit_warp<M, real>(lanes, o, Pc, xc, zc, T, w.red, w.R, &best,
                              &cost, &eq);
    lanes.run([&](int l) {
      for (int f = l; f < nzT; f += WIDTH) zbest[f] = z[f];
    });
  }
  for (int ph = 0; ph < n_phases; ++ph) {
    const int n_sqp = phases[2 * ph], n_qp = phases[2 * ph + 1];
    for (int it = 0; it < n_sqp; ++it) {
      tmpc::linearize_warp<M, real>(lanes, o, Pc, xc, zc, Col<real>{qp, 1, 0},
                                    L, reg);
      if (reg == REG_MIRROR)
        mirror_pass<NX, NU>(lanes, qp + L.H, T, reg_eps, mem + F.ip);
      solve_qp_problem<real, NX, NU>(lanes, q, rw, F.sz, st, n_qp, prm,
                                     &qp_comp, &qp_eq);
      // A NaN step (failed QP) keeps the previous iterate.
      lanes.run([&](int l) {
        real bad = real(0);
        for (int f = l; f < nzT; f += WIDTH) {
          const real v = z[f] + st.bz[f];
          if (v != v) bad = real(1);
        }
        st.flags[l] = bad;
      });
      bool bad = false;
      for (int l = 0; l < WIDTH; ++l) bad = bad || st.flags[l] > real(0);
      if (!bad)
        lanes.run([&](int l) {
          for (int f = l; f < nzT; f += WIDTH) z[f] = z[f] + st.bz[f];
        });
      if (track_best) {
        tmpc::merit_warp<M, real>(lanes, o, Pc, xc, zc, T, w.red, w.R, &mv,
                                  &cost, &eq);
        if (mv < best) {
          best = mv;
          lanes.run([&](int l) {
            for (int f = l; f < nzT; f += WIDTH) zbest[f] = z[f];
          });
        }
      }
    }
  }
  const Col<const real>& fin = track_best ? zbc : zc;
  tmpc::merit_warp<M, real>(lanes, o, Pc, xc, fin, T, w.red, w.R, &mv, &cost,
                            &eq);
  bool finite_z = is_finite(cost);
  for (int f = 0; f < nzT; ++f) finite_z = finite_z && is_finite(fin[f]);
  const bool success = (eq <= res_eq_tol) && finite_z;
  lanes.run([&](int l) {
    for (int f = l; f < nzT; f += WIDTH) outb[f] = fin[f];
    if (l == 0) {
      outb[nzT] = cost;
      outb[nzT + 1] = eq;
      outb[nzT + 2] = qp_comp;
      outb[nzT + 3] = success ? real(1) : real(0);
      outb[nzT + 4] = success ? real(1) : real(0);
    }
  });
}

// Sizes S1 takes: T >= 2 stages, m >= 1 rows of which 0 <= mh <= m
// generic, npar >= 0.
inline bool single_sizes_ok(int Bt, int T, int m, int mh, int npar) {
  return Bt >= 1 && T >= 2 && m >= 1 && mh >= 0 && mh <= m && npar >= 0;
}

// The prologue of the S1 entry (sqp_single.cu) and of its host build: -1
// for sizes out of range, -3 for a model with no instantiation
// (tmpc::with_model), else run(F, parameters), F the problem's memory layout
// (SingleOffsets<M>, which names the model).
template <typename real, class Run>
int single_solve_entry(int model, int Bt, int T, int m, int mh, int npar,
                       int n_phases, double mu0, double mu_min, double tau,
                       double w_max, double s_floor, double tol_freeze,
                       double n_act, Run&& run) {
  if (!single_sizes_ok(Bt, T, m, mh, npar) || n_phases < 1) return -1;
  const SingleParams<real> prm{
      real(mu0),        real(mu_min),         real(tau),
      real(w_max),      real(s_floor),        real(tol_freeze),
      real(100.0 * tol_freeze), real(1e3 * tol_freeze), real(n_act),
      real(1e30)};
  return tmpc::with_model(model, [&](auto mdl) {
    return run(SingleOffsets<decltype(mdl)>(T, m, mh), prm);
  });
}

}  // namespace
