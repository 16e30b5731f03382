// Batched stagewise Mehrotra predictor-corrector interior-point QP: the
// per-problem device code shared by the QP kernel (qp_ip.cu) and the fused
// whole-SQP kernel (sqp_fused.cu).
//
// ip_solve_problem() solves ONE problem, the one in column `b` of field-major
// (fields, Bt) input arrays, with its scratch in column `b` of a (fields, Bt)
// scratch buffer sized by Scratch(T, nz, nx, nu, m).total. It writes z into
// column `b` of z_out. Two optional (T*m, Bt) arrays make the dual variants:
// with `lam0` it warm-starts from those multipliers, with `lam_out` it writes
// the final multipliers; null means the cold, z-only solve. The algorithm is
// described in qp_ip.cu.

#pragma once

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#else  // host build (qp_ip_count.cpp): the CUDA qualifiers mean nothing
#define __host__
#define __device__
#define __forceinline__ inline
#endif
#include <math.h>
#include <stddef.h>

#define QP_MAX_NX 8
#define QP_MAX_NU 3
#define QP_THREADS 32

namespace {

// NaN-propagating max/min, as jnp.maximum / jnp.minimum.
template <typename real>
__device__ __forceinline__ real nmax(real a, real b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
template <typename real>
__device__ __forceinline__ real nmin(real a, real b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}

// Row metadata, one int[6] per row: kind (0 box, 1 generic), active (any
// stage unmasked), box column or generic D slot, box sign (+1/-1), and the
// [begin, end) range of the row's (D column, z column) pairs.
enum { RK_KIND = 0, RK_ACTIVE, RK_COL, RK_SIGN, RK_PBEG, RK_PEND, RK_W };

struct Sizes {
  int Bt, T, nz, nx, nu, m, mhp, nU, ntri;
};

struct Scratch {
  // Field offsets into the (fields, Bt) scratch buffer.
  int s, lam, rin, dsa, ds, z, dz, hzg, gbar, hbar, K, Linv, Qux, Pn, rd, kff,
      r0res, total;
  __host__ __device__ Scratch(int T, int nz, int nx, int nu, int m) {
    int o = 0;
    s = o; o += T * m;
    lam = o; o += T * m;
    rin = o; o += T * m;
    dsa = o; o += T * m;  // affine ds, then rhs3 = mu - ds_a * dlam_a
    ds = o; o += T * m;
    z = o; o += T * nz;
    dz = o; o += T * nz;
    hzg = o; o += T * nz;
    gbar = o; o += T * nz;
    hbar = o; o += T * nz * nz;
    K = o; o += (T - 1) * nu * nx;
    Linv = o; o += (T - 1) * nu * nu;
    Qux = o; o += (T - 1) * nu * nx;
    Pn = o; o += (T - 1) * nx * nx;
    rd = o; o += (T - 1) * nx;
    kff = o; o += (T - 1) * nu;
    r0res = o; o += nx;
    total = o;
  }
};

template <typename real>
struct Problem {
  Sizes sz;
  int b;
  real* W;  // scratch base
  __device__ real& w(int f) const { return W[(size_t)f * sz.Bt + b]; }
  __device__ real rd_(const real* p, int f) const {
    return p[(size_t)f * sz.Bt + b];
  }
};

__device__ __forceinline__ int tri_index(int i, int q, int nz) {
  if (i > q) {
    int t = i;
    i = q;
    q = t;
  }
  return i * nz - (i * (i - 1)) / 2 + (q - i);
}

// Closed-form SPD inverse for n in {1, 2, 3} (row-major n x n).
template <typename real>
__device__ void spd_inv(const real* M, real* out, int n) {
  if (n == 1) {
    out[0] = real(1) / M[0];
  } else if (n == 2) {
    real a = M[0], b = M[1], d = M[3];
    real inv_det = real(1) / (a * d - b * b);
    out[0] = d * inv_det;
    out[1] = -b * inv_det;
    out[2] = -b * inv_det;
    out[3] = a * inv_det;
  } else {
    real a = M[0], b = M[1], c = M[2];
    real d = M[4], e = M[5], f = M[8];
    real A00 = d * f - e * e;
    real A01 = c * e - b * f;
    real A02 = b * e - c * d;
    real A11 = a * f - c * c;
    real A12 = b * c - a * e;
    real A22 = a * d - b * b;
    real inv_det = real(1) / (a * A00 + b * A01 + c * A02);
    out[0] = A00 * inv_det;
    out[1] = A01 * inv_det;
    out[2] = A02 * inv_det;
    out[3] = A01 * inv_det;
    out[4] = A11 * inv_det;
    out[5] = A12 * inv_det;
    out[6] = A02 * inv_det;
    out[7] = A12 * inv_det;
    out[8] = A22 * inv_det;
  }
}

// Backward matrix sweep over Hbar (scratch): K, Linv, Qux and P_{k+1} per stage.
template <typename real>
__device__ void factor(const Problem<real>& pr, const Scratch& sc,
                       const real* A, const real* Bm) {
  const Sizes& s = pr.sz;
  const int T = s.T, nz = s.nz, nx = s.nx, nu = s.nu;
  real P[QP_MAX_NX * QP_MAX_NX], PA[QP_MAX_NX * QP_MAX_NX],
      PB[QP_MAX_NX * QP_MAX_NU], Quu[QP_MAX_NU * QP_MAX_NU],
      Qux[QP_MAX_NU * QP_MAX_NX], Qxx[QP_MAX_NX * QP_MAX_NX],
      Linv[QP_MAX_NU * QP_MAX_NU], K[QP_MAX_NU * QP_MAX_NX],
      QK[QP_MAX_NX * QP_MAX_NX];
  const int hb_T = sc.hbar + (T - 1) * nz * nz;
  for (int i = 0; i < nx; ++i)
    for (int j = 0; j < nx; ++j)
      P[i * nx + j] = pr.w(hb_T + (nu + i) * nz + nu + j);
  for (int k = T - 2; k >= 0; --k) {
    const int a0 = k * nx * nx, b0 = k * nx * nu, hb = sc.hbar + k * nz * nz;
    for (int i = 0; i < nx; ++i) {
      for (int j = 0; j < nx; ++j) {
        real acc = P[i * nx] * pr.rd_(A, a0 + j);
        for (int l = 1; l < nx; ++l)
          acc = acc + P[i * nx + l] * pr.rd_(A, a0 + l * nx + j);
        PA[i * nx + j] = acc;
      }
      for (int j = 0; j < nu; ++j) {
        real acc = P[i * nx] * pr.rd_(Bm, b0 + j);
        for (int l = 1; l < nx; ++l)
          acc = acc + P[i * nx + l] * pr.rd_(Bm, b0 + l * nu + j);
        PB[i * nu + j] = acc;
      }
    }
    for (int i = 0; i < nu; ++i) {
      for (int j = 0; j < nu; ++j) {
        real acc = pr.rd_(Bm, b0 + i) * PB[j];
        for (int l = 1; l < nx; ++l)
          acc = acc + pr.rd_(Bm, b0 + l * nu + i) * PB[l * nu + j];
        Quu[i * nu + j] = pr.w(hb + i * nz + j) + acc;
      }
      for (int j = 0; j < nx; ++j) {
        real acc = pr.rd_(Bm, b0 + i) * PA[j];
        for (int l = 1; l < nx; ++l)
          acc = acc + pr.rd_(Bm, b0 + l * nu + i) * PA[l * nx + j];
        Qux[i * nx + j] = pr.w(hb + i * nz + nu + j) + acc;
      }
    }
    for (int i = 0; i < nx; ++i)
      for (int j = 0; j < nx; ++j) {
        real acc = pr.rd_(A, a0 + i) * PA[j];
        for (int l = 1; l < nx; ++l)
          acc = acc + pr.rd_(A, a0 + l * nx + i) * PA[l * nx + j];
        Qxx[i * nx + j] = pr.w(hb + (nu + i) * nz + nu + j) + acc;
      }
    spd_inv(Quu, Linv, nu);
    for (int i = 0; i < nu; ++i)
      for (int j = 0; j < nx; ++j) {
        real acc = Linv[i * nu] * Qux[j];
        for (int l = 1; l < nu; ++l) acc = acc + Linv[i * nu + l] * Qux[l * nx + j];
        K[i * nx + j] = -acc;
      }
    for (int i = 0; i < nx; ++i)
      for (int j = 0; j < nx; ++j) {
        real acc = Qux[i] * K[j];
        for (int l = 1; l < nu; ++l) acc = acc + Qux[l * nx + i] * K[l * nx + j];
        QK[i * nx + j] = acc;
      }
    for (int i = 0; i < nu; ++i) {
      for (int j = 0; j < nx; ++j) {
        pr.w(sc.K + (k * nu + i) * nx + j) = K[i * nx + j];
        pr.w(sc.Qux + (k * nu + i) * nx + j) = Qux[i * nx + j];
      }
      for (int j = 0; j < nu; ++j)
        pr.w(sc.Linv + (k * nu + i) * nu + j) = Linv[i * nu + j];
    }
    for (int i = 0; i < nx; ++i)
      for (int j = 0; j < nx; ++j) pr.w(sc.Pn + (k * nx + i) * nx + j) = P[i * nx + j];
    for (int i = 0; i < nx; ++i)
      for (int j = 0; j < nx; ++j)
        P[i * nx + j] = real(0.5) * (Qxx[i * nx + j] + QK[i * nx + j] +
                                     Qxx[j * nx + i] + QK[j * nx + i]);
  }
}

// Vector sweep + forward rollout: dz (scratch) from gbar (scratch), the
// dynamics residuals rd (field-major, (T-1)*nx fields of `rd_src`) and the
// initial residual (nx fields of `r0_src`).
template <typename real>
__device__ void solve_vec(const Problem<real>& pr, const Scratch& sc,
                          const real* A, const real* Bm, const real* rd_src,
                          const real* r0_src) {
  const Sizes& s = pr.sz;
  const int T = s.T, nz = s.nz, nx = s.nx, nu = s.nu;
  real p[QP_MAX_NX], beta[QP_MAX_NX], qu[QP_MAX_NU], qx[QP_MAX_NX],
      kff[QP_MAX_NU], dx[QP_MAX_NX], du[QP_MAX_NU], dxn[QP_MAX_NX];
  for (int i = 0; i < nx; ++i) p[i] = pr.w(sc.gbar + (T - 1) * nz + nu + i);
  for (int k = T - 2; k >= 0; --k) {
    const int a0 = k * nx * nx, b0 = k * nx * nu;
    for (int i = 0; i < nx; ++i) {
      real acc = pr.w(sc.Pn + (k * nx + i) * nx) * pr.rd_(rd_src, k * nx);
      for (int l = 1; l < nx; ++l)
        acc = acc + pr.w(sc.Pn + (k * nx + i) * nx + l) * pr.rd_(rd_src, k * nx + l);
      beta[i] = p[i] + acc;
    }
    for (int i = 0; i < nu; ++i) {
      real acc = pr.rd_(Bm, b0 + i) * beta[0];
      for (int l = 1; l < nx; ++l) acc = acc + pr.rd_(Bm, b0 + l * nu + i) * beta[l];
      qu[i] = pr.w(sc.gbar + k * nz + i) + acc;
    }
    for (int i = 0; i < nx; ++i) {
      real acc = pr.rd_(A, a0 + i) * beta[0];
      for (int l = 1; l < nx; ++l) acc = acc + pr.rd_(A, a0 + l * nx + i) * beta[l];
      qx[i] = pr.w(sc.gbar + k * nz + nu + i) + acc;
    }
    for (int i = 0; i < nu; ++i) {
      real acc = pr.w(sc.Linv + (k * nu + i) * nu) * qu[0];
      for (int l = 1; l < nu; ++l) acc = acc + pr.w(sc.Linv + (k * nu + i) * nu + l) * qu[l];
      kff[i] = -acc;
      pr.w(sc.kff + k * nu + i) = kff[i];
    }
    for (int i = 0; i < nx; ++i) {
      real acc = pr.w(sc.Qux + (k * nu) * nx + i) * kff[0];
      for (int l = 1; l < nu; ++l) acc = acc + pr.w(sc.Qux + (k * nu + l) * nx + i) * kff[l];
      p[i] = qx[i] + acc;
    }
  }
  for (int i = 0; i < nx; ++i) dx[i] = pr.rd_(r0_src, i);
  for (int k = 0; k < T - 1; ++k) {
    const int a0 = k * nx * nx, b0 = k * nx * nu;
    for (int i = 0; i < nu; ++i) {
      real acc = pr.w(sc.K + (k * nu + i) * nx) * dx[0];
      for (int l = 1; l < nx; ++l) acc = acc + pr.w(sc.K + (k * nu + i) * nx + l) * dx[l];
      du[i] = acc + pr.w(sc.kff + k * nu + i);
    }
    for (int i = 0; i < nu; ++i) pr.w(sc.dz + k * nz + i) = du[i];
    for (int i = 0; i < nx; ++i) pr.w(sc.dz + k * nz + nu + i) = dx[i];
    for (int i = 0; i < nx; ++i) {
      real acc_a = pr.rd_(A, a0 + i * nx) * dx[0];
      for (int l = 1; l < nx; ++l) acc_a = acc_a + pr.rd_(A, a0 + i * nx + l) * dx[l];
      real acc_b = pr.rd_(Bm, b0 + i * nu) * du[0];
      for (int l = 1; l < nu; ++l) acc_b = acc_b + pr.rd_(Bm, b0 + i * nu + l) * du[l];
      dxn[i] = (acc_a + acc_b) + pr.rd_(rd_src, k * nx + i);
    }
    for (int i = 0; i < nx; ++i) dx[i] = dxn[i];
  }
  for (int i = 0; i < nu; ++i) pr.w(sc.dz + (T - 1) * nz + i) = real(0);
  for (int i = 0; i < nx; ++i) pr.w(sc.dz + (T - 1) * nz + nu + i) = dx[i];
}

// (D z)[row r] at stage t for the z-like vector at scratch offset `zf`.
template <typename real>
__device__ __forceinline__ real row_dz(const Problem<real>& pr, const int* rinfo,
                                       const int* pairs, const real* D, int r,
                                       int t, int zf) {
  const Sizes& s = pr.sz;
  const int* ri = rinfo + r * RK_W;
  if (ri[RK_KIND] == 0)
    return real(ri[RK_SIGN]) * pr.w(zf + t * s.nz + ri[RK_COL]);
  const int pb = ri[RK_PBEG], pe = ri[RK_PEND];
  if (pb == pe) return real(0);
  const int d0 = (t * s.mhp + ri[RK_COL]) * s.nU;
  real acc = pr.rd_(D, d0 + pairs[2 * pb]) * pr.w(zf + t * s.nz + pairs[2 * pb + 1]);
  for (int q = pb + 1; q < pe; ++q)
    acc = acc + pr.rd_(D, d0 + pairs[2 * q]) * pr.w(zf + t * s.nz + pairs[2 * q + 1]);
  return acc;
}

// gbar = Hz+g + sum_r D_r^T w_r with w_r = mask (lam rin - rhs3) / s.
// `rhs3_field` < 0 means rhs3 = 0 (the affine predictor).
template <typename real>
__device__ void gbar_accum(const Problem<real>& pr, const Scratch& sc,
                           const int* rinfo, const int* pairs, const real* D,
                           const real* mask, int rhs3_field) {
  const Sizes& s = pr.sz;
  const int T = s.T, nz = s.nz, m = s.m;
  for (int f = 0; f < T * nz; ++f) pr.w(sc.gbar + f) = pr.w(sc.hzg + f);
  for (int r = 0; r < m; ++r) {
    const int* ri = rinfo + r * RK_W;
    if (!ri[RK_ACTIVE]) continue;
    for (int t = 0; t < T; ++t) {
      const int f = t * m + r;
      const real rhs3 = rhs3_field < 0 ? real(0) : pr.w(rhs3_field + f);
      const real wv =
          mask[f] * (pr.w(sc.lam + f) * pr.w(sc.rin + f) - rhs3) / pr.w(sc.s + f);
      if (ri[RK_KIND] == 0) {
        real& gb = pr.w(sc.gbar + t * nz + ri[RK_COL]);
        gb = gb + real(ri[RK_SIGN]) * wv;
      } else {
        const int d0 = (t * s.mhp + ri[RK_COL]) * s.nU;
        for (int q = ri[RK_PBEG]; q < ri[RK_PEND]; ++q) {
          real& gb = pr.w(sc.gbar + t * nz + pairs[2 * q + 1]);
          gb = gb + pr.rd_(D, d0 + pairs[2 * q]) * wv;
        }
      }
    }
  }
}

template <typename real>
__device__ __forceinline__ real ftb(real v, real dv, real mk, real big) {
  real ratio = dv < real(0) ? -v / nmin(dv, real(-1e-30)) : big;
  return mk > real(0) ? ratio : big;
}

// One problem's whole interior-point solve (see the file comment).
template <typename real>
__device__ void ip_solve_problem(
    const real* __restrict__ Htri, const real* __restrict__ g,
    const real* __restrict__ A, const real* __restrict__ Bm,
    const real* __restrict__ c, const real* __restrict__ D,
    const real* __restrict__ e, const real* __restrict__ r0,
    const real* __restrict__ mask, const int* __restrict__ rinfo,
    const int* __restrict__ pairs, real* __restrict__ z_out,
    const real* __restrict__ lam0, real* __restrict__ lam_out,
    real* __restrict__ scratch, const Sizes& sz, int b, int any_active,
    int n_iters, real mu0, real mu_min, real tau, real w_max, real s_floor,
    real s_wfloor, real tol_freeze, real tol100, real n_act) {
  const Scratch sc(sz.T, sz.nz, sz.nx, sz.nu, sz.m);
  const Problem<real> pr{sz, b, scratch};
  const int T = sz.T, nz = sz.nz, nx = sz.nx, nu = sz.nu, m = sz.m;
  const real big = real(3e38);
  const real inf = real(INFINITY);

  // Hbar = H (symmetric, from the packed upper triangle)
  auto load_hbar = [&]() {
    for (int t = 0; t < T; ++t)
      for (int i = 0; i < nz; ++i)
        for (int q = 0; q < nz; ++q)
          pr.w(sc.hbar + (t * nz + i) * nz + q) =
              pr.rd_(Htri, t * sz.ntri + tri_index(i, q, nz));
  };

  if (!any_active) {
    load_hbar();
    factor(pr, sc, A, Bm);
    for (int f = 0; f < T * nz; ++f) pr.w(sc.gbar + f) = pr.rd_(g, f);
    solve_vec(pr, sc, A, Bm, c, r0);
    for (int f = 0; f < T * nz; ++f) z_out[(size_t)f * sz.Bt + b] = pr.w(sc.dz + f);
    if (lam_out)
      for (int f = 0; f < T * m; ++f) lam_out[(size_t)f * sz.Bt + b] = real(0);
    return;
  }

  // Cold start: s = max(e, sqrt(mu0)), lam = mu0 / s. Warm start: slacks
  // from the new residuals, floored off the boundary, and the carried
  // multipliers clipped to [mu_min, w_max].
  const real v0 = sqrt(mu0);
  for (int r = 0; r < m; ++r) {
    const bool act = rinfo[r * RK_W + RK_ACTIVE] != 0;
    for (int t = 0; t < T; ++t) {
      const int f = t * m + r;
      real sv = real(1), lv = real(0);
      if (act && mask[f] > real(0)) {
        if (lam0) {
          sv = nmax(pr.rd_(e, f), s_wfloor);
          lv = nmin(nmax(pr.rd_(lam0, f), mu_min), w_max);
        } else {
          sv = nmax(pr.rd_(e, f), v0);
          lv = mu0 / sv;
        }
      }
      pr.w(sc.s + f) = sv;
      pr.w(sc.lam + f) = lv;
    }
  }
  for (int f = 0; f < T * nz; ++f) pr.w(sc.z + f) = real(0);

  for (int it = 0; it < n_iters; ++it) {
    // ---- Pass A: residuals, W, Hbar accumulation, comp, feas -----------
    load_hbar();
    real comp = real(0), feas = real(0);
    for (int r = 0; r < m; ++r) {
      const int* ri = rinfo + r * RK_W;
      if (!ri[RK_ACTIVE]) continue;
      real c_r = real(0);
      for (int t = 0; t < T; ++t) {
        const int f = t * m + r;
        const real mk = mask[f], sv = pr.w(sc.s + f), lv = pr.w(sc.lam + f);
        const real rin = row_dz(pr, rinfo, pairs, D, r, t, sc.z) + pr.rd_(e, f) - sv;
        pr.w(sc.rin + f) = rin;
        const real Wr = nmin(mk * lv / sv, w_max);
        const int hb = sc.hbar + t * nz * nz;
        if (ri[RK_KIND] == 0) {
          real& h = pr.w(hb + ri[RK_COL] * nz + ri[RK_COL]);
          h = h + Wr;
        } else {
          const int d0 = (t * sz.mhp + ri[RK_COL]) * sz.nU;
          for (int qa = ri[RK_PBEG]; qa < ri[RK_PEND]; ++qa) {
            const real DW = pr.rd_(D, d0 + pairs[2 * qa]) * Wr;
            const int ca = pairs[2 * qa + 1];
            for (int qb = ri[RK_PBEG]; qb < ri[RK_PEND]; ++qb) {
              real& h = pr.w(hb + ca * nz + pairs[2 * qb + 1]);
              h = h + DW * pr.rd_(D, d0 + pairs[2 * qb]);
            }
          }
        }
        c_r = c_r + mk * sv * lv;
        feas = nmax(feas, fabs(mk * rin));
      }
      comp = comp + c_r;
    }
    comp = comp / n_act;
    factor(pr, sc, A, Bm);

    // ---- equality residuals (dynamics defects + initial condition) -----
    for (int k = 0; k < T - 1; ++k)
      for (int i = 0; i < nx; ++i) {
        real acc = pr.rd_(c, k * nx + i) - pr.w(sc.z + (k + 1) * nz + nu + i);
        for (int j = 0; j < nx; ++j)
          acc = acc + pr.rd_(A, (k * nx + i) * nx + j) * pr.w(sc.z + k * nz + nu + j);
        for (int j = 0; j < nu; ++j)
          acc = acc + pr.rd_(Bm, (k * nx + i) * nu + j) * pr.w(sc.z + k * nz + j);
        pr.w(sc.rd + k * nx + i) = acc;
      }
    for (int i = 0; i < nx; ++i)
      pr.w(sc.r0res + i) = pr.rd_(r0, i) - pr.w(sc.z + nu + i);
    for (int t = 0; t < T; ++t)
      for (int i = 0; i < nz; ++i) {
        real acc = pr.rd_(g, t * nz + i);
        for (int j = 0; j < nz; ++j)
          acc = acc + pr.rd_(Htri, t * sz.ntri + tri_index(i, j, nz)) *
                          pr.w(sc.z + t * nz + j);
        pr.w(sc.hzg + t * nz + i) = acc;
      }

    // ---- affine (predictor) step -----------------------------------------
    gbar_accum(pr, sc, rinfo, pairs, D, mask, -1);
    solve_vec(pr, sc, A, Bm, scratch + (size_t)sc.rd * sz.Bt,
              scratch + (size_t)sc.r0res * sz.Bt);
    real alpha_aff = inf;
    for (int r = 0; r < m; ++r) {
      if (!rinfo[r * RK_W + RK_ACTIVE]) continue;
      real a_s = inf, a_l = inf;
      for (int t = 0; t < T; ++t) {
        const int f = t * m + r;
        const real mk = mask[f], sv = pr.w(sc.s + f), lv = pr.w(sc.lam + f);
        real dsa = real(0), dla = real(0);
        if (mk > real(0)) {
          dsa = row_dz(pr, rinfo, pairs, D, r, t, sc.dz) + pr.w(sc.rin + f);
          dla = (real(0) - sv * lv) / sv - (lv / sv) * dsa;
        }
        pr.w(sc.dsa + f) = dsa;
        a_s = nmin(a_s, ftb(sv, dsa, mk, big));
        a_l = nmin(a_l, ftb(lv, dla, mk, big));
      }
      alpha_aff = nmin(alpha_aff, nmin(a_s, a_l));
    }
    alpha_aff = nmin(real(1), alpha_aff);

    real comp_aff = real(0);
    for (int r = 0; r < m; ++r) {
      if (!rinfo[r * RK_W + RK_ACTIVE]) continue;
      real c_r = real(0);
      for (int t = 0; t < T; ++t) {
        const int f = t * m + r;
        const real mk = mask[f], sv = pr.w(sc.s + f), lv = pr.w(sc.lam + f);
        const real dsa = pr.w(sc.dsa + f);
        const real dla = mk > real(0) ? (real(0) - sv * lv) / sv - (lv / sv) * dsa : real(0);
        c_r = c_r + mk * (sv + alpha_aff * dsa) * (lv + alpha_aff * dla);
      }
      comp_aff = comp_aff + c_r;
    }
    comp_aff = comp_aff / n_act;
    const real ratio = comp_aff / nmax(comp, real(1e-30));
    const real sigma = nmin(nmax(ratio * ratio * ratio, real(1e-8)), real(1));
    const real mu = nmax(sigma * comp, mu_min);

    // ---- corrector step ----------------------------------------------------
    for (int r = 0; r < m; ++r) {
      if (!rinfo[r * RK_W + RK_ACTIVE]) continue;
      for (int t = 0; t < T; ++t) {
        const int f = t * m + r;
        const real mk = mask[f], sv = pr.w(sc.s + f), lv = pr.w(sc.lam + f);
        const real dsa = pr.w(sc.dsa + f);
        const real dla = mk > real(0) ? (real(0) - sv * lv) / sv - (lv / sv) * dsa : real(0);
        pr.w(sc.dsa + f) = mu - dsa * dla;  // rhs3
      }
    }
    gbar_accum(pr, sc, rinfo, pairs, D, mask, sc.dsa);
    solve_vec(pr, sc, A, Bm, scratch + (size_t)sc.rd * sz.Bt,
              scratch + (size_t)sc.r0res * sz.Bt);

    real nan_acc = real(0);
    for (int f = 0; f < T * nz; ++f) nan_acc = nan_acc + pr.w(sc.dz + f);
    real alpha_p = inf, alpha_d = inf;
    for (int r = 0; r < m; ++r) {
      if (!rinfo[r * RK_W + RK_ACTIVE]) continue;
      for (int t = 0; t < T; ++t) {
        const int f = t * m + r;
        const real mk = mask[f], sv = pr.w(sc.s + f), lv = pr.w(sc.lam + f);
        real dsv = real(0), dlv = real(0);
        if (mk > real(0)) {
          dsv = row_dz(pr, rinfo, pairs, D, r, t, sc.dz) + pr.w(sc.rin + f);
          dlv = (pr.w(sc.dsa + f) - sv * lv) / sv - (lv / sv) * dsv;
        }
        pr.w(sc.ds + f) = dsv;
        nan_acc = nan_acc + dlv;
        alpha_p = nmin(alpha_p, ftb(sv, dsv, mk, big));
        alpha_d = nmin(alpha_d, ftb(lv, dlv, mk, big));
      }
    }
    alpha_p = nmin(real(1), tau * alpha_p);
    alpha_d = nmin(real(1), tau * alpha_d);

    real eqr = real(0);
    for (int f = 0; f < (T - 1) * nx; ++f) eqr = nmax(eqr, fabs(pr.w(sc.rd + f)));
    for (int i = 0; i < nx; ++i) eqr = nmax(eqr, fabs(pr.w(sc.r0res + i)));
    // Carried duals make comp tiny at dz = 0 while the new QP is unsolved
    // (the freeze has no stationarity term): a warm start runs one full
    // iteration before it may freeze.
    const bool done = (comp < tol_freeze) && (feas < tol100) && (eqr < tol100) &&
                      (lam0 == nullptr || it >= 1);
    const bool bad = nan_acc != nan_acc;
    const real scale = (done || bad) ? real(0) : real(1);
    alpha_p = alpha_p * scale;
    alpha_d = alpha_d * scale;

    for (int f = 0; f < T * nz; ++f)
      pr.w(sc.z + f) = pr.w(sc.z + f) + alpha_p * pr.w(sc.dz + f);
    for (int r = 0; r < m; ++r) {
      if (!rinfo[r * RK_W + RK_ACTIVE]) continue;
      for (int t = 0; t < T; ++t) {
        const int f = t * m + r;
        const real mk = mask[f], sv = pr.w(sc.s + f), lv = pr.w(sc.lam + f);
        const real dsv = pr.w(sc.ds + f);
        if (mk > real(0)) {
          const real dlv = (pr.w(sc.dsa + f) - sv * lv) / sv - (lv / sv) * dsv;
          pr.w(sc.s + f) = nmax(sv + alpha_p * dsv, s_floor);
          pr.w(sc.lam + f) = nmax(lv + alpha_d * dlv, real(0));
        } else {
          pr.w(sc.s + f) = real(1);
          pr.w(sc.lam + f) = real(0);
        }
      }
    }
  }
  for (int f = 0; f < T * nz; ++f) z_out[(size_t)f * sz.Bt + b] = pr.w(sc.z + f);
  if (lam_out)
    for (int f = 0; f < T * m; ++f) lam_out[(size_t)f * sz.Bt + b] = pr.w(sc.lam + f);
}

}  // namespace
