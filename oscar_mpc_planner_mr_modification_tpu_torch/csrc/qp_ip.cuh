// Batched stagewise Mehrotra predictor-corrector interior-point QP: the
// per-problem code shared by the QP kernel (qp_ip.cu) and the fused
// whole-SQP kernel (sqp_fused.cu), one warp per problem.
//
// ip_solve_problem() solves ONE problem with one lane group (warp.cuh: the 32
// lanes of a warp on the card, 32 emulated lanes on the host). Every array it
// touches lies in the problem's own memory, shared memory on the card: the
// QP (QpView), the row tables and stage mask (one copy per block), and the
// interior-point state (Scratch: s, lam, cached row residuals and steps,
// Hbar, the K / Linv / Qux / P factors, temporaries and the reduction
// partials). It leaves z in IpState::z and the multipliers in IpState::lam.
// qp_solve_column() wraps it for the QP kernel: it copies problem b's
// columns of field-major (fields, Bt) inputs into the problem's memory,
// solves, and writes z (and lam) back into column b. The algorithm is
// described in qp_ip.cu.
//
// The state dimension NX and input dimension NU are template parameters, so
// every per-stage loop has a compile-time trip count; T, m and the row table
// are runtime data. A generic row is dense over z. The work is spread over
// the lanes so that every sum keeps the serial order of the plain version
// (ops/qp_cuda.py::ip_solve_reference) and of the JAX kernel:
// - row passes (residuals, weights, complementarity, fraction to the
//   boundary, corrector right-hand side, the s/lam update): lane r takes
//   row r and loops the stages in ascending order; the per-row partials are
//   combined in row order by uniform code;
// - Hbar and gbar accumulation: lane t takes stage t, holds the stage's
//   block (or vector) in registers and adds the rows in ascending order, so
//   no two lanes write one entry;
// - the Riccati factorization stays sequential over stages; inside a stage
//   the lanes take the entries of the two larger products (P A and P B, then
//   Quu, Qux and Qxx), each a serial dot product, and the small rest (the
//   closed-form inverse of Quu, K, Qux^T K, P) is uniform code;
// - the two vector sweeps are uniform code: a stage's vectors are a handful
//   of entries, cheaper computed alike by every lane than spread over lanes
//   with a sync between products;
// - the NaN guard sums dz, then dlam in (row, stage) order, serially, as the
//   serial code does. Max and min reductions do not depend on the order; a
//   NaN still propagates.

#pragma once

#include "warp.cuh"

#include <math.h>
#include <stddef.h>

namespace {

using warp::Lanes;
using warp::WIDTH;

// NaN-propagating max/min, as jnp.maximum / jnp.minimum.
template <typename real>
WARP_FN real nmax(real a, real b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
template <typename real>
WARP_FN real nmin(real a, real b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}

// Row metadata, one int[4] per row: kind (0 box, 1 generic), active (any
// stage unmasked), box column or generic D slot, box sign (+1/-1). A generic
// row is dense over z: its D slot holds one coefficient per z column.
enum { RK_KIND = 0, RK_ACTIVE, RK_COL, RK_SIGN, RK_W };

// The block's copy of the row structure: stage mask (T*m) and row table
// (m * RK_W).
template <typename real>
struct Rows {
  const real* mask;
  const int* rinfo;
};

// Runtime sizes of one QP: T stages, m rows per stage, mhp generic D slots.
struct Sizes {
  int T, m, mhp;
};

// Offsets, in reals, of one problem's QP fields in its memory, in the order
// of the kernel's field-major input arrays: H (each stage's upper triangle,
// row by row), g, A, B, c, the generic rows of D (dense over z), e, r0.
template <int NX, int NU>
struct QpOffsets {
  static constexpr int NZ = NX + NU, NTRI = NZ * (NZ + 1) / 2;
  int H, g, A, B, c, D, e, r0, total;
  __host__ __device__ explicit QpOffsets(const Sizes& s) {
    int o = 0;
    H = o; o += s.T * NTRI;
    g = o; o += s.T * NZ;
    A = o; o += (s.T - 1) * NX * NX;
    B = o; o += (s.T - 1) * NX * NU;
    c = o; o += (s.T - 1) * NX;
    D = o; o += s.T * s.mhp * NZ;
    e = o; o += s.T * s.m;
    r0 = o; o += NX;
    total = o;
  }
};

template <typename real>
struct QpView {
  const real *H, *g, *A, *B, *c, *D, *e, *r0;
};

template <typename real>
struct IpState {
  real *s, *lam, *rin, *dsa, *ds, *z, *dz, *hzg, *gbar, *hbar, *K, *Linv,
      *Qux, *Pn, *rd, *kff, *r0res, *tmp, *red;
  int R;  // length of each of the four reduction arrays at red
};

// Offsets, in reals, of one problem's interior-point state.
template <int NX, int NU>
struct Scratch {
  static constexpr int NZ = NX + NU;
  // factorization temporaries (P, PA, PB, Quu, Qxx)
  static constexpr int TMP = 3 * NX * NX + NX * NU + NU * NU;
  int s, lam, rin, dsa, ds, z, dz, hzg, gbar, hbar, K, Linv, Qux, Pn, rd, kff,
      r0res, tmp, red, R, total;
  __host__ __device__ explicit Scratch(const Sizes& sz) {
    const int T = sz.T, m = sz.m;
    R = m > T ? m : T;
    if (R < WIDTH) R = WIDTH;
    int o = 0;
    s = o; o += T * m;
    lam = o; o += T * m;
    rin = o; o += T * m;  // row residuals, then the corrector's dlam
    dsa = o; o += T * m;  // affine ds, then rhs3 = mu - ds_a * dlam_a
    ds = o; o += T * m;   // the weights W of pass A, then the corrector's ds
    z = o; o += T * NZ;
    dz = o; o += T * NZ;
    hzg = o; o += T * NZ;
    gbar = o; o += T * NZ;
    hbar = o; o += T * NZ * NZ;
    K = o; o += (T - 1) * NU * NX;
    Linv = o; o += (T - 1) * NU * NU;
    Qux = o; o += (T - 1) * NU * NX;
    Pn = o; o += (T - 1) * NX * NX;
    rd = o; o += (T - 1) * NX;
    kff = o; o += (T - 1) * NU;
    r0res = o; o += NX;
    tmp = o; o += TMP;
    red = o; o += 4 * R;
    total = o;
  }
  template <typename real>
  __host__ __device__ IpState<real> state(real* b) const {
    return IpState<real>{b + s,    b + lam,  b + rin,  b + dsa,   b + ds,
                         b + z,    b + dz,   b + hzg,  b + gbar,  b + hbar,
                         b + K,    b + Linv, b + Qux,  b + Pn,    b + rd,
                         b + kff,  b + r0res, b + tmp, b + red,   R};
  }
};

template <typename real>
struct IpParams {
  real mu0, mu_min, tau, w_max, s_floor, s_wfloor, tol_freeze, tol100, n_act;
};

WARP_FN constexpr int tri_index(int i, int q, int nz) {
  return i > q ? q * nz - (q * (q - 1)) / 2 + (i - q)
               : i * nz - (i * (i - 1)) / 2 + (q - i);
}

// Closed-form SPD inverse for n in {1, 2, 3} (row-major n x n).
template <typename real, int N>
WARP_FN void spd_inv(const real* M, real* out) {
  static_assert(N >= 1 && N <= 3, "closed-form SPD inverse covers nu <= 3");
  if constexpr (N == 1) {
    out[0] = real(1) / M[0];
  } else if constexpr (N == 2) {
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

// Hbar_t = H_t (symmetric, from the upper triangle), plus with `W` the
// rows' D_r^T W_r D_r: lane t holds stage t's block and adds the active rows
// in row order.
template <typename real, int NX, int NU>
WARP_FN void build_hbar(const Lanes& L, const QpView<real>& q,
                        const IpState<real>& w, const real* W,
                        const Rows<real>& rw, const Sizes& sz) {
  constexpr int NZ = NX + NU, NTRI = NZ * (NZ + 1) / 2;
  L.run([&](int l) {
    for (int t = l; t < sz.T; t += WIDTH) {
      // the stage's block in registers: every index is a compile-time one
      real h[NZ * NZ];
      const real* Ht = q.H + t * NTRI;
      WARP_UNROLL for (int i = 0; i < NZ; ++i)
        WARP_UNROLL for (int k = 0; k < NZ; ++k)
          h[i * NZ + k] = Ht[tri_index(i, k, NZ)];
      for (int r = 0; W != nullptr && r < sz.m; ++r) {
        const int* ri = rw.rinfo + r * RK_W;
        if (!ri[RK_ACTIVE]) continue;
        const real Wr = W[t * sz.m + r];
        if (ri[RK_KIND] == 0) {
          WARP_UNROLL for (int c = 0; c < NZ; ++c)
            if (c == ri[RK_COL]) h[c * NZ + c] = h[c * NZ + c] + Wr;
        } else {
          const real* Dr = q.D + (t * sz.mhp + ri[RK_COL]) * NZ;
          WARP_UNROLL for (int qa = 0; qa < NZ; ++qa) {
            const real DW = Dr[qa] * Wr;
            WARP_UNROLL for (int qb = 0; qb < NZ; ++qb)
              h[qa * NZ + qb] = h[qa * NZ + qb] + DW * Dr[qb];
          }
        }
      }
      real* hb = w.hbar + t * NZ * NZ;
      WARP_UNROLL for (int e = 0; e < NZ * NZ; ++e) hb[e] = h[e];
    }
  });
}

// Backward matrix sweep over Hbar: K, Linv, Qux and P_{k+1} per stage.
template <typename real, int NX, int NU>
WARP_FN void factor(const Lanes& L, const QpView<real>& q,
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
    // Uniform: the closed-form inverse of Quu, K = -Linv Qux, Qux^T K and
    // P_k = sym(Qxx + Qux^T K), a few dozen products each, in registers;
    // lane 0 stores K, Linv and P, which the next phase reads.
    real Li[NU * NU], Kr[NU * NX], QK[NX * NX];
    spd_inv<real, NU>(Quu, Li);
    for (int e = 0; e < NU * NX; ++e) {
      const int i = e / NX, j = e % NX;
      real acc = Li[i * NU] * Qux[j];
      for (int c = 1; c < NU; ++c) acc = acc + Li[i * NU + c] * Qux[c * NX + j];
      Kr[e] = -acc;
    }
    for (int e = 0; e < NX * NX; ++e) {
      const int i = e / NX, j = e % NX;
      real acc = Qux[i] * Kr[j];
      for (int c = 1; c < NU; ++c) acc = acc + Qux[c * NX + i] * Kr[c * NX + j];
      QK[e] = acc;
    }
    real* Linv = w.Linv + k * NU * NU;
    L.one([&] {
      for (int e = 0; e < NU * NU; ++e) Linv[e] = Li[e];
      for (int e = 0; e < NU * NX; ++e) K[e] = Kr[e];
      for (int e = 0; e < NX * NX; ++e) {
        const int i = e / NX, j = e % NX;
        Pt[e] = real(0.5) * (Qxx[i * NX + j] + QK[i * NX + j] +
                             Qxx[j * NX + i] + QK[j * NX + i]);
      }
    });
  }
}

// Vector sweep + forward rollout: dz from gbar, the dynamics residuals rd
// ((T-1)*nx) and the initial residual r0 (nx). Uniform code: a stage's
// vectors are a handful of entries, and every lane computing them alike in
// registers costs less than a lane sync between the products; lane 0 stores
// kff and dz.
template <typename real, int NX, int NU>
WARP_FN void solve_vec(const Lanes& L, const QpView<real>& q,
                       const IpState<real>& w, int T, const real* rd,
                       const real* r0) {
  constexpr int NZ = NX + NU;
  real p[NX];
  for (int i = 0; i < NX; ++i) p[i] = w.gbar[(T - 1) * NZ + NU + i];
  for (int k = T - 2; k >= 0; --k) {
    const real* A = q.A + k * NX * NX;
    const real* B = q.B + k * NX * NU;
    const real* Pn = w.Pn + k * NX * NX;
    const real* Linv = w.Linv + k * NU * NU;
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
    for (int i = 0; i < NU; ++i) {
      real acc = Linv[i * NU] * qu[0];
      for (int c = 1; c < NU; ++c) acc = acc + Linv[i * NU + c] * qu[c];
      kff[i] = -acc;
    }
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

// (D z)[row r] at stage t for the z-like vector zv.
template <typename real, int NZ>
WARP_FN real row_dz(const int* ri, const real* D, int mhp, const real* zv,
                    int t) {
  const real* z = zv + t * NZ;
  if (ri[RK_KIND] == 0) return real(ri[RK_SIGN]) * z[ri[RK_COL]];
  const real* Dr = D + (t * mhp + ri[RK_COL]) * NZ;
  real acc = Dr[0] * z[0];
  WARP_UNROLL for (int c = 1; c < NZ; ++c) acc = acc + Dr[c] * z[c];
  return acc;
}

// gbar = Hz+g + sum_r D_r^T w_r with w_r = mask (lam rin - rhs3) / s;
// rhs3 null means rhs3 = 0 (the affine predictor). Lane t holds stage t's
// entries and adds the active rows in row order.
template <typename real, int NX, int NU>
WARP_FN void gbar_accum(const Lanes& L, const QpView<real>& q,
                        const IpState<real>& w, const Rows<real>& rw,
                        const Sizes& sz, const real* rhs3) {
  constexpr int NZ = NX + NU;
  const int m = sz.m;
  L.run([&](int l) {
    for (int t = l; t < sz.T; t += WIDTH) {
      real g[NZ];
      WARP_UNROLL for (int i = 0; i < NZ; ++i) g[i] = w.hzg[t * NZ + i];
      for (int r = 0; r < m; ++r) {
        const int* ri = rw.rinfo + r * RK_W;
        if (!ri[RK_ACTIVE]) continue;
        const int f = t * m + r;
        const real r3 = rhs3 == nullptr ? real(0) : rhs3[f];
        const real wv = rw.mask[f] * (w.lam[f] * w.rin[f] - r3) / w.s[f];
        if (ri[RK_KIND] == 0) {
          WARP_UNROLL for (int c = 0; c < NZ; ++c)
            if (c == ri[RK_COL]) g[c] = g[c] + real(ri[RK_SIGN]) * wv;
        } else {
          const real* Dr = q.D + (t * sz.mhp + ri[RK_COL]) * NZ;
          WARP_UNROLL for (int c = 0; c < NZ; ++c) g[c] = g[c] + Dr[c] * wv;
        }
      }
      WARP_UNROLL for (int i = 0; i < NZ; ++i) w.gbar[t * NZ + i] = g[i];
    }
  });
}

template <typename real>
WARP_FN real ftb(real v, real dv, real mk, real big) {
  real ratio = dv < real(0) ? -v / nmin(dv, real(-1e-30)) : big;
  return mk > real(0) ? ratio : big;
}

// One problem's whole interior-point solve with n_iters iterations (see the
// file comment). `warm`: IpState::lam holds the multipliers to start from.
template <typename real, int NX, int NU>
__device__ void ip_solve_problem(const Lanes& L, const QpView<real>& q,
                                 const Rows<real>& rw, const Sizes& sz,
                                 const IpState<real>& w, int any_active,
                                 int n_iters, bool warm,
                                 const IpParams<real>& p) {
  constexpr int NZ = NX + NU, NTRI = NZ * (NZ + 1) / 2;
  const int T = sz.T, m = sz.m, mhp = sz.mhp;
  const real big = real(3e38);
  const real inf = real(INFINITY);
  const real* mask = rw.mask;
  const int* rinfo = rw.rinfo;
  auto active = [&](int r) { return rinfo[r * RK_W + RK_ACTIVE] != 0; };
  if (!any_active) {
    build_hbar<real, NX, NU>(L, q, w, nullptr, rw, sz);
    factor<real, NX, NU>(L, q, w, T);
    L.run([&](int l) {
      for (int f = l; f < T * NZ; f += WIDTH) w.gbar[f] = q.g[f];
      for (int f = l; f < T * m; f += WIDTH) w.lam[f] = real(0);
    });
    solve_vec<real, NX, NU>(L, q, w, T, q.c, q.r0);
    L.run([&](int l) {
      for (int f = l; f < T * NZ; f += WIDTH) w.z[f] = w.dz[f];
    });
    return;
  }

  real* const red0 = w.red;
  real* const red1 = red0 + w.R;
  real* const red2 = red1 + w.R;
  real* const W = w.ds;      // pass A's weights; ds is free until the corrector
  real* const dlam = w.rin;  // the corrector's dlam; rin is read just before

  // Cold start: s = max(e, sqrt(mu0)), lam = mu0 / s. Warm start: slacks
  // from the new residuals, floored off the boundary, and the carried
  // multipliers clipped to [mu_min, w_max].
  const real v0 = sqrt(p.mu0);
  L.run([&](int l) {
    for (int r = l; r < m; r += WIDTH) {
      const bool act = active(r);
      for (int t = 0; t < T; ++t) {
        const int f = t * m + r;
        real sv = real(1), lv = real(0);
        if (act && mask[f] > real(0)) {
          if (warm) {
            sv = nmax(q.e[f], p.s_wfloor);
            lv = nmin(nmax(w.lam[f], p.mu_min), p.w_max);
          } else {
            sv = nmax(q.e[f], v0);
            lv = p.mu0 / sv;
          }
        }
        w.s[f] = sv;
        w.lam[f] = lv;
      }
    }
    for (int f = l; f < T * NZ; f += WIDTH) w.z[f] = real(0);
  });
  for (int it = 0; it < n_iters; ++it) {
    // ---- pass A: residuals, W, comp, feas (lanes over rows) --------------
    L.run([&](int l) {
      for (int r = l; r < m; r += WIDTH) {
        if (!active(r)) continue;
        const int* ri = rinfo + r * RK_W;
        real c_r = real(0), f_r = real(0);
        for (int t = 0; t < T; ++t) {
          const int f = t * m + r;
          const real mk = mask[f], sv = w.s[f], lv = w.lam[f];
          const real rin =
              row_dz<real, NZ>(ri, q.D, mhp, w.z, t) + q.e[f] - sv;
          w.rin[f] = rin;
          W[f] = nmin(mk * lv / sv, p.w_max);
          c_r = c_r + mk * sv * lv;
          f_r = nmax(f_r, fabs(mk * rin));
        }
        red0[r] = c_r;
        red1[r] = f_r;
      }
    });
    real comp = real(0), feas = real(0);
    for (int r = 0; r < m; ++r)
      if (active(r)) {
        comp = comp + red0[r];
        feas = nmax(feas, red1[r]);
      }
    comp = comp / p.n_act;
    build_hbar<real, NX, NU>(L, q, w, W, rw, sz);
    factor<real, NX, NU>(L, q, w, T);

    // ---- equality residuals (dynamics defects + initial condition), Hz+g --
    L.run([&](int l) {
      for (int e = l; e < (T - 1) * NX; e += WIDTH) {
        const int k = e / NX, i = e % NX;
        real acc = q.c[e] - w.z[(k + 1) * NZ + NU + i];
        for (int j = 0; j < NX; ++j)
          acc = acc + q.A[(k * NX + i) * NX + j] * w.z[k * NZ + NU + j];
        for (int j = 0; j < NU; ++j)
          acc = acc + q.B[(k * NX + i) * NU + j] * w.z[k * NZ + j];
        w.rd[e] = acc;
      }
      if (l < NX) w.r0res[l] = q.r0[l] - w.z[NU + l];
      for (int e = l; e < T * NZ; e += WIDTH) {
        const int t = e / NZ, i = e % NZ;
        real acc = q.g[e];
        for (int j = 0; j < NZ; ++j)
          acc = acc + q.H[t * NTRI + tri_index(i, j, NZ)] * w.z[t * NZ + j];
        w.hzg[e] = acc;
      }
    });

    // ---- affine (predictor) step -----------------------------------------
    gbar_accum<real, NX, NU>(L, q, w, rw, sz, nullptr);
    solve_vec<real, NX, NU>(L, q, w, T, w.rd, w.r0res);
    L.run([&](int l) {
      for (int r = l; r < m; r += WIDTH) {
        if (!active(r)) continue;
        const int* ri = rinfo + r * RK_W;
        real a_s = inf, a_l = inf;
        for (int t = 0; t < T; ++t) {
          const int f = t * m + r;
          const real mk = mask[f], sv = w.s[f], lv = w.lam[f];
          real dsa = real(0), dla = real(0);
          if (mk > real(0)) {
            dsa = row_dz<real, NZ>(ri, q.D, mhp, w.dz, t) + w.rin[f];
            dla = (real(0) - sv * lv) / sv - (lv / sv) * dsa;
          }
          w.dsa[f] = dsa;
          a_s = nmin(a_s, ftb(sv, dsa, mk, big));
          a_l = nmin(a_l, ftb(lv, dla, mk, big));
        }
        red0[r] = nmin(a_s, a_l);
      }
    });
    real alpha_aff = inf;
    for (int r = 0; r < m; ++r)
      if (active(r)) alpha_aff = nmin(alpha_aff, red0[r]);
    alpha_aff = nmin(real(1), alpha_aff);
    L.run([&](int l) {
      for (int r = l; r < m; r += WIDTH) {
        if (!active(r)) continue;
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
    for (int r = 0; r < m; ++r)
      if (active(r)) comp_aff = comp_aff + red1[r];
    comp_aff = comp_aff / p.n_act;
    const real ratio = comp_aff / nmax(comp, real(1e-30));
    const real sigma = nmin(nmax(ratio * ratio * ratio, real(1e-8)), real(1));
    const real mu = nmax(sigma * comp, p.mu_min);

    // ---- corrector step ----------------------------------------------------
    L.run([&](int l) {
      for (int r = l; r < m; r += WIDTH) {
        if (!active(r)) continue;
        for (int t = 0; t < T; ++t) {
          const int f = t * m + r;
          const real mk = mask[f], sv = w.s[f], lv = w.lam[f];
          const real dsa = w.dsa[f];
          const real dla =
              mk > real(0) ? (real(0) - sv * lv) / sv - (lv / sv) * dsa : real(0);
          w.dsa[f] = mu - dsa * dla;  // rhs3
        }
      }
    });
    gbar_accum<real, NX, NU>(L, q, w, rw, sz, w.dsa);
    solve_vec<real, NX, NU>(L, q, w, T, w.rd, w.r0res);
    L.run([&](int l) {
      for (int r = l; r < m; r += WIDTH) {
        if (!active(r)) continue;
        const int* ri = rinfo + r * RK_W;
        real a_p = inf, a_d = inf;
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
          a_p = nmin(a_p, ftb(sv, dsv, mk, big));
          a_d = nmin(a_d, ftb(lv, dlv, mk, big));
        }
        red0[r] = a_p;
        red1[r] = a_d;
      }
      real e_l = real(0);
      for (int e = l; e < (T - 1) * NX; e += WIDTH) e_l = nmax(e_l, fabs(w.rd[e]));
      if (l < NX) e_l = nmax(e_l, fabs(w.r0res[l]));
      red2[l] = e_l;
    });
    real nan_acc = real(0);
    for (int f = 0; f < T * NZ; ++f) nan_acc = nan_acc + w.dz[f];
    real alpha_p = inf, alpha_d = inf;
    for (int r = 0; r < m; ++r) {
      if (!active(r)) continue;
      for (int t = 0; t < T; ++t) nan_acc = nan_acc + dlam[t * m + r];
      alpha_p = nmin(alpha_p, red0[r]);
      alpha_d = nmin(alpha_d, red1[r]);
    }
    alpha_p = nmin(real(1), p.tau * alpha_p);
    alpha_d = nmin(real(1), p.tau * alpha_d);
    real eqr = real(0);
    for (int l = 0; l < WIDTH; ++l) eqr = nmax(eqr, red2[l]);
    // Carried duals make comp tiny at dz = 0 while the new QP is unsolved
    // (the freeze has no stationarity term): a warm start runs one full
    // iteration before it may freeze.
    const bool done = (comp < p.tol_freeze) && (feas < p.tol100) &&
                      (eqr < p.tol100) && (!warm || it >= 1);
    const bool bad = nan_acc != nan_acc;
    const real scale = (done || bad) ? real(0) : real(1);
    alpha_p = alpha_p * scale;
    alpha_d = alpha_d * scale;

    L.run([&](int l) {
      for (int f = l; f < T * NZ; f += WIDTH) w.z[f] = w.z[f] + alpha_p * w.dz[f];
      for (int r = l; r < m; r += WIDTH) {
        if (!active(r)) continue;
        for (int t = 0; t < T; ++t) {
          const int f = t * m + r;
          const real mk = mask[f], sv = w.s[f], lv = w.lam[f];
          const real dsv = w.ds[f];
          if (mk > real(0)) {
            const real dlv = (w.dsa[f] - sv * lv) / sv - (lv / sv) * dsv;
            w.s[f] = nmax(sv + alpha_p * dsv, p.s_floor);
            w.lam[f] = nmax(lv + alpha_d * dlv, real(0));
          } else {
            w.s[f] = real(1);
            w.lam[f] = real(0);
          }
        }
      }
    });
  }
}

// Field-major (fields, Bt) QP inputs of a batch: problem b in column b.
template <typename real>
struct QpBatch {
  const real *H, *g, *A, *B, *c, *D, *e, *r0;
};

// Reals of one problem's memory in the QP kernel: its QP, then its state.
template <int NX, int NU>
__host__ __device__ int qp_problem_reals(const Sizes& sz) {
  return QpOffsets<NX, NU>(sz).total + Scratch<NX, NU>(sz).total;
}

// Problem b of a field-major batch: copy its columns into `mem`
// (qp_problem_reals long), solve, write z (and lam) into column b. `lam0`
// (T*m, Bt), when not null, is the warm start.
template <typename real, int NX, int NU>
__device__ void qp_solve_column(const Lanes& L, const QpBatch<real>& in,
                                const Rows<real>& rw, const Sizes& sz, int Bt,
                                int b, real* mem, int any_active, int n_iters,
                                const real* lam0, real* z_out, real* lam_out,
                                const IpParams<real>& p) {
  constexpr int NZ = NX + NU;
  const QpOffsets<NX, NU> o(sz);
  const IpState<real> w = Scratch<NX, NU>(sz).state(mem + o.total);
  const size_t B = Bt;
  const int Tm = sz.T * sz.m;
  L.run([&](int l) {
    auto column = [&](const real* src, int off, int n) {
      for (int f = l; f < n; f += WIDTH) mem[off + f] = src[(size_t)f * B + b];
    };
    column(in.H, o.H, o.g - o.H);
    column(in.g, o.g, o.A - o.g);
    column(in.A, o.A, o.B - o.A);
    column(in.B, o.B, o.c - o.B);
    column(in.c, o.c, o.D - o.c);
    column(in.D, o.D, o.e - o.D);
    column(in.e, o.e, o.r0 - o.e);
    column(in.r0, o.r0, o.total - o.r0);
    if (lam0 != nullptr)
      for (int f = l; f < Tm; f += WIDTH) w.lam[f] = lam0[(size_t)f * B + b];
  });
  const QpView<real> q{mem + o.H, mem + o.g, mem + o.A, mem + o.B,
                       mem + o.c, mem + o.D, mem + o.e, mem + o.r0};
  ip_solve_problem<real, NX, NU>(L, q, rw, sz, w, any_active, n_iters,
                                 lam0 != nullptr, p);
  L.run([&](int l) {
    for (int f = l; f < sz.T * NZ; f += WIDTH) z_out[(size_t)f * B + b] = w.z[f];
    if (lam_out != nullptr)
      for (int f = l; f < Tm; f += WIDTH) lam_out[(size_t)f * B + b] = w.lam[f];
  });
}

// The interior-point parameters as the QP entries derive them: the warm
// start's slack floor 10 sqrt(mu_min) and the freeze's residual tolerance
// 100 tol_freeze.
template <typename real>
IpParams<real> qp_params(double mu0, double mu_min, double tau, double w_max,
                         double s_floor, double tol_freeze, double n_act) {
  return IpParams<real>{real(mu0),          real(mu_min),
                        real(tau),          real(w_max),
                        real(s_floor),      real(10.0 * sqrt(mu_min)),
                        real(tol_freeze),   real(100.0 * tol_freeze),
                        real(n_act)};
}

// A compiled (nx, nu), as a type.
template <int NX_, int NU_>
struct Dims {
  static constexpr int NX = NX_, NU = NU_;
};

// The one place that decides which (nx, nu) the QP code is compiled for:
// f(Dims<NX, NU>{}) for an instantiated pair, -3 for any other. Instantiated
// for the port's ContouringSecondOrderUnicycleModel (nx 5, nu 2),
// SecondOrderUnicycleModel (nx 4, nu 2), the slack model (nx 6, nu 2) and
// the two bicycles (nx 6, nu 3); a model with other sizes adds a line here
// (ops/qp_cuda.py::INSTANTIATED names the same pairs, to raise before a
// launch).
template <class F>
int with_dims(int nx, int nu, F&& f) {
  if (nx == 5 && nu == 2) return f(Dims<5, 2>{});
  if (nx == 4 && nu == 2) return f(Dims<4, 2>{});
  if (nx == 6 && nu == 2) return f(Dims<6, 2>{});
  if (nx == 6 && nu == 3) return f(Dims<6, 3>{});
  return -3;
}

// The prologue of the QP kernel's entries (qp_ip.cu) and of their host
// build (tmpc_ocp_host.cpp): -1 for sizes out of range (a duals entry needs
// lam_out), -3 for an (nx, nu) with no instantiation, else the result of
// run(Dims<NX, NU>{}, sizes, parameters).
template <typename real, class Run>
int qp_entry(bool duals, const void* lam_out, int Bt, int T, int nx, int nu,
             int m, int mhp, double mu0, double mu_min, double tau,
             double w_max, double s_floor, double tol_freeze, double n_act,
             Run&& run) {
  if (Bt < 1 || T < 2 || m < 1 || mhp < 1 || (duals && lam_out == nullptr))
    return -1;
  const Sizes sz{T, m, mhp};
  const IpParams<real> prm = qp_params<real>(mu0, mu_min, tau, w_max, s_floor,
                                             tol_freeze, n_act);
  return with_dims(nx, nu, [&](auto dims) { return run(dims, sz, prm); });
}

}  // namespace
