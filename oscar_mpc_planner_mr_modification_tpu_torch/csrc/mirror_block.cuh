// The mirror linearize entry's block design: one problem on a thread block,
// each stage on a group of G lanes (G = 8, or 16 where nz = 9), shared with
// the host build (tmpc_ocp_host.cpp), which runs the block's threads in
// turn (warp.cuh Block).
//
// In the one-warp design (sqp_fused.cuh, linearize_stage with MIRROR) lane
// t runs all of stage t alone: the cost's triangle jets, the dynamics and
// row jets, then a cyclic Jacobi, one dependent chain through local memory.
// Here lane j of stage t's group seeds direction j:
// - the cost as a row jet (tmpc_ocp.cuh JetRow): its gradient and row j of
//   its Hessian, which the lane writes into the stage's dense block (row j
//   from the diagonal on, and the mirrored column, so the block is
//   symmetric bit for bit);
// - the dynamics and the generic rows as dual numbers along z_j: column j
//   of (B A) and entry j of each D row; lane 0 writes the values (g, c, e);
// and the merit terms of stage t run on the spare lane NZ where G > NZ,
// else on lane 0 after the rest. The Jacobi is parallel-ordered
// (round-robin, as Brent and Luk order it): per round, the group's n / 2
// disjoint rotations are computed one per lane, then applied row by row
// (A J and V J, lane i row i) and column by column (J^T A, lane k column
// k), with each pair's (p, q) entries set to 0 as the cyclic order does.
// Its stopping rule, sweep limit, NaN rule and eigenvalue floor are those
// of mirror.cuh: a stage stops when its off-diagonal norm^2 <= eps^2 norm^2
// (or after MAX_SWEEPS sweeps); a block with a non-finite entry becomes NaN
// and runs no sweep; the eigenvalues become max(|w|, reg_eps). Lane i then
// writes row i of V max(|w|, eps) V^T, packed, into the QP buffer. Every
// phase ends at a block barrier; a stage that has stopped idles through
// the others' sweeps (`any`: __syncthreads_or on the card).
//
// A problem's dense stage blocks, eigenvectors, rotations, partials, merit
// partials and per-thread state live in the block's dynamic shared memory
// (MirrorBlockLayout); the jets live in the lanes' registers.

#pragma once

#include "sqp_fused.cuh"

namespace {

// Lanes per stage: 8 for nz <= 8, else 16 (one lane per direction, row and
// column of the stage's block; n / 2 rotations per round).
template <class M>
constexpr int mirror_group() {
  return M::NZ <= 8 ? 8 : 16;
}

// The block design's threads at most (its __launch_bounds__): T * G must
// fit, else the entry keeps the one-warp design.
constexpr int MIRROR_BLOCK_MAX = 512;
// Reals of a problem's parameters (npar T) and ints of the int table staged
// in shared memory at most; larger ones are read where they lie.
constexpr int MB_P_CAP = 4096, MB_IT_CAP = 1024;

// Per-thread state bits of the Jacobi (MirrorBlockLayout::st): the stage
// still sweeping, the stage's block not finite, which of the two copies of
// its block is current.
enum { MB_LIVE = 1, MB_BAD = 2, MB_BUF = 4 };

// One problem's shared memory in the block design, in reals: its
// parameters (MB_P_CAP), iterate, initial state; per stage two copies of
// the dense block A and one of V (NZ x NZ each), two of the round's
// rotations (G reals) and of the row partials (2 G), and the rows'
// finiteness (G); the merit partials
// (3 T + 1); then the double table (RT_BOUNDS + m), the int table
// (MB_IT_CAP) and one state byte per thread. Threads: G per stage, then,
// where they fit MIRROR_BLOCK_MAX, a warp per 32 stages for the merit.
template <class M>
struct MirrorBlockLayout {
  static constexpr int G = mirror_group<M>(), NN = M::NZ * M::NZ;
  int T, lin_threads, merit_threads, threads, P, Z, x0, A, V, rot, part, red,
      reals, n_rt;
  __host__ __device__ MirrorBlockLayout(int T_, int m) : T(T_) {
    lin_threads = (T * G + warp::WIDTH - 1) / warp::WIDTH * warp::WIDTH;
    const int mw = (T + warp::WIDTH - 1) / warp::WIDTH * warp::WIDTH;
    merit_threads = lin_threads + mw <= MIRROR_BLOCK_MAX ? mw : 0;
    threads = lin_threads + merit_threads;
    P = 0;
    Z = P + MB_P_CAP;
    x0 = Z + T * M::NZ;
    A = x0 + M::NX;
    V = A + 2 * T * NN;
    rot = V + T * NN;
    part = rot + 2 * T * G;
    red = part + 5 * T * G;
    reals = red + 3 * T + 1;
    n_rt = tmpc::RT_BOUNDS + m;
  }
  // Bytes to the double table: the reals, rounded up to 8.
  template <typename real>
  __host__ __device__ size_t rt_bytes() const {
    return (sizeof(real) * (size_t)reals + 7) / 8 * 8;
  }
  template <typename real>
  __host__ __device__ size_t bytes() const {
    return rt_bytes<real>() + sizeof(double) * (size_t)n_rt +
           sizeof(int) * (size_t)MB_IT_CAP + (size_t)threads;
  }
};

// The round-robin order on n2 (even) indices, n2 - 1 rounds: round r pairs
// r with n2 - 1 (pair 0) and r + k with r - k, mod m = n2 - 1 (pair k).
// Pair k's (p, q), p < q; a pair with q >= n (an odd size's dummy index)
// is skipped. The indices wrap by a compare, not a division.
WARP_FN int rr_wrap(int x, int m) {
  return x < 0 ? x + m : (x >= m ? x - m : x);
}
WARP_FN void rr_pair(int r, int k, int n2, int* p, int* q) {
  const int m = n2 - 1;
  const int a = k == 0 ? r : rr_wrap(r + k, m);
  const int b = k == 0 ? m : rr_wrap(r - k, m);
  *p = a < b ? a : b;
  *q = a < b ? b : a;
}
// Index i's partner and pair in round r.
WARP_FN void rr_of(int r, int i, int n2, int* partner, int* k) {
  const int m = n2 - 1;
  if (i == m || i == r) {
    *partner = i == m ? r : m;
    *k = 0;
    return;
  }
  const int d = rr_wrap(i - r, m);
  *partner = rr_wrap(2 * r - i, m);
  *k = d <= (m - 1) / 2 ? d : m - d;
}

// The Jacobi rotation (c, s) that zeroes (p, q) of a symmetric block with
// entries app, aqq, apq (mirror.cuh's); c = 0 marks a pair to skip (apq is
// 0, as the cyclic order skips it).
template <typename real>
WARP_FN void rotation(real app, real aqq, real apq, real* c, real* s) {
  if (apq == real(0)) {
    *c = real(0);
    *s = real(0);
    return;
  }
  const real theta = (aqq - app) / (real(2) * apq);
  const real at = mirror::m_abs(theta);
  real t;
  if (at > real(1e18)) {
    t = real(0.5) / theta;
  } else {
    t = real(1) / (at + mirror::m_sqrt(theta * theta + real(1)));
    if (theta < real(0)) t = -t;
  }
  *c = real(1) / mirror::m_sqrt(t * t + real(1));
  *s = t * *c;
}

// Row i of J^T A after round r's rotations on the rows (A: rows NM apart),
// at column col, i's partner j and their rotation (c, s) given (c = 0, or
// j >= n: no rotation).
template <typename real, int NM>
WARP_FN real rotated_row(const real* a, int n, int i, int j, real c, real s,
                         int col) {
  if (j >= n || c == real(0)) return a[i * NM + col];
  return i < j ? c * a[i * NM + col] - s * a[j * NM + col]
               : s * a[j * NM + col] + c * a[i * NM + col];
}

// The "mirror" eigendecomposition of S symmetric blocks at once, stage s
// on threads s G .. s G + G - 1 of the block: block s has size(s) rows,
// row i at A + s * NM * NM + i * NM (NM >= size(s)), a second copy of A
// S * NM * NM further, its eigenvectors go to V at the same offsets. rot:
// G reals per block, then the second copy; part: 2 G per block, then the
// second copy, then G per block; st: one byte per thread.
//
// A round takes one barrier: lane i forms its row of J^T A J from the
// current copy (its row and its partner's), writes it to the other copy,
// sets its pair's (p, q) entry to 0, rotates its row of V in place and, as
// the lower index of a pair of the next round, that pair's rotation (the
// partner's new diagonal entry is four old entries away); the last round of
// a sweep also writes the row's partials of the off-diagonal and whole
// norms, which the next sweep's first round reads to decide (every lane of
// the stage alike) whether the stage sweeps again. The next sweep's first
// barrier is the block's `any`: the sweeps end when no stage goes on.
//
// On return a block that had a non-finite entry is marked MB_BAD in its
// threads' st; every other block has V its eigenvectors and its current
// copy's (MB_BUF) diagonal max(|w|, eps).
template <typename real, int NM, int G, class Blk, class Size>
TMPC_WARP void jacobi_stages(const Blk& blk, int S, Size size, real* A,
                             real* V, real* rot, real* part,
                             unsigned char* st, real eps) {
  constexpr int NN = NM * NM;
  constexpr int ROUNDS = NM + (NM & 1) - 1;
  const real tol = real(sizeof(real) == sizeof(float) ? 1.1920929e-07
                                                       : 2.220446049250313e-16);
  const size_t A2 = (size_t)S * NN;
  const int R2 = S * G, P2 = 2 * S * G;
  real* fin_of = part + 2 * P2;  // a row's finiteness, G per block
  // the next round's rotation, where lane i is its pair's lower index;
  // `next` the new rows' copy, `cur` the old one and its round r (-1: none)
  auto next_rotation = [&](int i, int n, int r, const real* cur,
                           const real* next, const real* rc, real* rn) {
    const int n2 = n + (n & 1);
    const int r1 = r + 1 == n2 - 1 ? 0 : r + 1;
    int j, k;
    rr_of(r1, i, n2, &j, &k);
    if (i > j) return;
    real c = real(0), sn = real(0);
    if (j < n) {
      // A'[j][j]: row j of J^T A at columns j and its round-r partner jj
      real ajj;
      if (r < 0) {
        ajj = cur[j * NM + j];
      } else {
        int jj, kk;
        rr_of(r, j, n2, &jj, &kk);
        const real cc = rc[2 * kk], ss = rc[2 * kk + 1];
        const real x_j = rotated_row<real, NM>(cur, n, j, jj, cc, ss, j);
        if (jj >= n || cc == real(0)) {
          ajj = x_j;
        } else {
          const real x_p = rotated_row<real, NM>(cur, n, j, jj, cc, ss, jj);
          ajj = j < jj ? cc * x_j - ss * x_p : ss * x_p + cc * x_j;
        }
      }
      rotation(next[i * NM + i], ajj, next[i * NM + j], &c, &sn);
    }
    rn[2 * k] = c;
    rn[2 * k + 1] = sn;
  };
  // V = I; finiteness of each row; the first round's rotations; the norms
  blk.run([&](int tid) {
    const int s = tid / G, l = tid % G;
    if (s >= S) return;
    const int n = size(s);
    real* a = A + s * NN;
    bool fin = true;
    real off = real(0), nrm = real(0);
    if (l < n) {
      for (int j = 0; j < n; ++j) {
        V[s * NN + l * NM + j] = l == j ? real(1) : real(0);
        const real v = a[l * NM + j];
        fin = fin && mirror::is_finite(v);
        nrm = nrm + v * v;
        if (j != l) off = off + v * v;
      }
      next_rotation(l, n, -1, a, a, nullptr, rot + s * G);
    }
    part[s * 2 * G + l] = off;
    part[s * 2 * G + G + l] = nrm;
    fin_of[s * G + l] = fin ? real(1) : real(0);
  });
  for (int sweep = 0;; ++sweep) {
    bool pending = false;
    for (int r = 0; r < ROUNDS; ++r) {
      auto round = [&](int tid) -> bool {
        const int s = tid / G, i = tid % G;
        if (s >= S) return false;
        if (sweep == 0 && r == 0) {
          bool fin = true;
          for (int k = 0; k < G; ++k)
            fin = fin && fin_of[s * G + k] != real(0);
          st[tid] = fin ? MB_LIVE : MB_BAD;
        }
        if (!(st[tid] & MB_LIVE)) return false;
        const int buf = (st[tid] & MB_BUF) ? 1 : 0;
        if (r == 0) {  // the sweep's decision, alike on every lane
          bool go = false;
          if (sweep < mirror::MAX_SWEEPS) {
            real off = real(0), nrm = real(0);
            const real* pt = part + buf * P2 + s * 2 * G;
            for (int k = 0; k < G; ++k) {
              off = off + pt[k];
              nrm = nrm + pt[G + k];
            }
            go = off > tol * tol * nrm;
          }
          if (!go) {
            st[tid] &= MB_BUF;
            return false;
          }
        }
        const int n = size(s), n2 = n + (n & 1);
        if (r >= n2 - 1) return true;
        const real* cur = A + buf * A2 + s * NN;
        real* nxt = A + (1 - buf) * A2 + s * NN;
        const real* rc = rot + buf * R2 + s * G;
        if (i < n) {
          // row i of J^T A J into the other copy
          int j, kk;
          rr_of(r, i, n2, &j, &kk);
          const real ci = rc[2 * kk], si = rc[2 * kk + 1];
          real* row = nxt + i * NM;
          TMPC_UNROLL for (int col = 0; col < NM; ++col)
            if (col < n)
              row[col] = rotated_row<real, NM>(cur, n, i, j, ci, si, col);
          real* v = V + s * NN + i * NM;
          TMPC_UNROLL for (int k = 0; k < (NM + 1) / 2; ++k) {
            int p, q;
            rr_pair(r, k, n2, &p, &q);
            const real c = rc[2 * k], sn = rc[2 * k + 1];
            if (k >= n2 / 2 || q >= n || c == real(0)) continue;
            const real xp = row[p], xq = row[q];
            row[p] = c * xp - sn * xq;
            row[q] = sn * xp + c * xq;
            const real vp = v[p], vq = v[q];
            v[p] = c * vp - sn * vq;
            v[q] = sn * vp + c * vq;
          }
          if (j < n && ci != real(0)) row[j] = real(0);
          next_rotation(i, n, r, cur, nxt, rc, rot + (1 - buf) * R2 + s * G);
          if (r == n2 - 2) {  // the sweep's last round: the norms' partials
            real off = real(0), nrm = real(0);
            TMPC_UNROLL for (int col = 0; col < NM; ++col) {
              if (col >= n) continue;
              const real a2 = row[col] * row[col];
              nrm = nrm + a2;
              if (col != i) off = off + a2;
            }
            real* pt = part + (1 - buf) * P2 + s * 2 * G;
            pt[i] = off;
            pt[G + i] = nrm;
          }
        } else if (r == n2 - 2) {
          real* pt = part + (1 - buf) * P2 + s * 2 * G;
          pt[i] = real(0);
          pt[G + i] = real(0);
        }
        st[tid] ^= MB_BUF;
        return true;
      };
      if (r == 0) {
        pending = blk.any(round);
        if (!pending) break;
      } else {
        blk.run([&](int tid) { round(tid); });
      }
    }
    if (!pending) break;
  }
  // the diagonal -> max(|w|, eps), NaN-propagating
  blk.run([&](int tid) {
    const int s = tid / G, l = tid % G;
    if (s >= S || (st[tid] & MB_BAD) || l >= size(s)) return;
    real* a = A + ((st[tid] & MB_BUF) ? A2 : 0) + s * NN;
    const real w = mirror::m_abs(a[l * NM + l]);
    a[l * NM + l] = (w != w) ? w : ((eps != eps) ? eps : (w > eps ? w : eps));
  });
}

// Entry (i, k) of V max(|w|, eps) V^T after jacobi_stages, rows NM apart.
template <typename real, int NM>
TMPC_HD real mirror_entry(const real* A, const real* V, int n, int i, int k) {
  real acc = V[i * NM] * A[0] * V[k * NM];
  TMPC_UNROLL for (int j = 1; j < NM; ++j)
    if (j < n) acc = acc + V[i * NM + j] * A[j * NM + j] * V[k * NM + j];
  return acc;
}

// Stage t's cost and dynamics along direction j (lane j of its group): the
// stage's dense Hessian block (rows NZ apart; at stage N its x block) into
// a, column j of (B A); lane 0 writes the values, g and c.
template <class M, typename real>
TMPC_WARP void lin_direction(const tmpc::Ocp& o, const Col<const real>& P,
                             const Col<const real>& Z, const Col<real>& qp,
                             const tmpc::QpLayout<M>& L, int t, int j,
                             real* a) {
  using namespace tmpc;
  constexpr int NU = M::NU, NX = M::NX, NZ = M::NZ;
  const int T = L.T, N = T - 1;
  const Par<real> p = stage_params(P, t, T);
  const bool body_terminal = (o.it[TB_FLAGS] & FL_BODY_TERMINAL) != 0;
  LIN_CLOCK;
  real z[NZ];
  TMPC_UNROLL for (int i = 0; i < NZ; ++i)
    z[i] = (t == N && i < NU) ? real(0) : Z[t * NZ + i];

  {  // the cost's gradient and Hessian row j
    using JR = JetRow<real, NZ>;
    JR zj[NZ];
    TMPC_UNROLL for (int i = 0; i < NZ; ++i)
      zj[i] = row_seed<real, NZ>(z[i], i, j);
    const JR cost = stage_cost<M>(o, p, zj, t < N ? body_terminal : true);
    if (t < N) {
      TMPC_UNROLL for (int k = 0; k < NZ; ++k)
        if (k >= j) {
          a[j * NZ + k] = cost.h[k];
          a[k * NZ + j] = cost.h[k];
        }
    } else if (j >= NU) {
      TMPC_UNROLL for (int k = NU; k < NZ; ++k)
        if (k >= j) {
          a[(j - NU) * NZ + k - NU] = cost.h[k];
          a[(k - NU) * NZ + j - NU] = cost.h[k];
        }
    }
    if (j == 0)
      TMPC_UNROLL for (int i = 0; i < NZ; ++i)
        qp[L.g + t * NZ + i] = (t == N && i < NU) ? real(0) : cost.g[i];
  }
  LIN_LAP(LIN_SEC_COST);

  if (t == N) return;

  using J1 = Jet<real, 1, 0>;
  J1 zd[NZ];
  TMPC_UNROLL for (int i = 0; i < NZ; ++i) {
    zd[i] = jet_const<real, 1, 0>(z[i]);
    zd[i].g[0] = i == j ? real(1) : real(0);
  }
  {  // dynamics: column j of (B A), and c
    J1 F[NX];
    dynamics<M>(o, p, zd + NU, zd, o.rt[RT_DT], F);
    TMPC_UNROLL for (int i = 0; i < NX; ++i) {
      if (j < NU)
        qp[L.B + (t * NX + i) * NU + j] = F[i].g[0];
      else
        qp[L.A + (t * NX + i) * NX + (j - NU)] = F[i].g[0];
      if (j == 0) qp[L.c + t * NX + i] = F[i].v - Z[(t + 1) * NZ + NU + i];
    }
  }
  LIN_LAP(LIN_SEC_DYN);
}

// Stage t's inequality rows D z + e >= 0 in the OCP's row order, lane l of
// its G taking rows l, l + G, ...: a generic row's gradient by first-order
// jets over z (its D slot, the generic rows before it counted), its e; at
// stage N the masked placeholders (generic D rows 0, e 1).
template <class M, typename real, int G>
TMPC_WARP void lin_rows(const tmpc::Ocp& o, const Col<const real>& P,
                        const Col<const real>& Z, const Col<real>& qp,
                        const tmpc::QpLayout<M>& L, int t, int l) {
  using namespace tmpc;
  constexpr int NZ = M::NZ;
  const int T = L.T, N = T - 1, m = L.m;
  LIN_CLOCK;
  if (t == N) {
    for (int f = l; f < L.mhp * NZ; f += G)
      qp[L.D + t * L.mhp * NZ + f] = real(0);
    for (int r = l; r < m; r += G) qp[L.e + t * m + r] = real(1);
    return;
  }
  const Par<real> p = stage_params(P, t, T);
  using J1 = Jet<real, NZ, 0>;
  J1 zd[NZ];
  TMPC_UNROLL for (int i = 0; i < NZ; ++i)
    zd[i] = jet_seed<real, NZ, 0>(Z[t * NZ + i], i);
  const int* rows = o.it + o.it[TB_OFF_ROWS];
  int slot = 0;
  for (int r = 0; r < m; ++r) {
    const int kind = rows[2 * r], idx = rows[2 * r + 1];
    const bool generic = kind == ROW_HL || kind == ROW_HU;
    if (r % G == l) {
      const real bound = real(o.rt[RT_BOUNDS + r]);
      real e;
      if (generic) {
        const J1 h = h_row<M>(o, p, zd, idx);
        const int d0 = L.D + (t * L.mhp + slot) * NZ;
        TMPC_UNROLL for (int k = 0; k < NZ; ++k)
          qp[d0 + k] = kind == ROW_HL ? h.g[k] : -h.g[k];
        e = kind == ROW_HL ? h.v - bound : bound - h.v;
      } else {
        const real zi = Z[t * NZ + idx];
        e = kind == ROW_ZL ? zi - bound : bound - zi;
      }
      qp[L.e + t * m + r] = e;
    }
    slot += generic;
  }
  if (L.mh == 0)
    for (int k = l; k < NZ; k += G) qp[L.D + t * L.mhp * NZ + k] = real(0);
  LIN_LAP(LIN_SEC_ROWS);
}

// Problem b on the block: the QP fields into column b of qp (L.total, Bt)
// and (merit, cost, eq_res) into column b of merit_out (3, Bt); sm: the
// layout's reals, then its tables and state bytes (MirrorBlockLayout).
// The problem's parameters, iterate, initial state and the two tables are
// first copied into shared memory (where they fit), so that the stage
// functions' chains of dependent loads wait on shared memory, not on L2.
template <class M, typename real, class Blk>
TMPC_WARP void mirror_block_column(const Blk& blk, const tmpc::Ocp& og,
                                   const real* P, const real* x0,
                                   const real* Z, real* qp, real* merit_out,
                                   int Bt, int b, const tmpc::QpLayout<M>& L,
                                   real* sm) {
  using namespace tmpc;
  constexpr int NU = M::NU, NX = M::NX, NZ = M::NZ, NTRI = M::NTRI;
  const MirrorBlockLayout<M> Y(L.T, L.m);
  constexpr int G = MirrorBlockLayout<M>::G, NN = MirrorBlockLayout<M>::NN;
  const size_t B = Bt;
  const int T = L.T, N = T - 1, m = L.m;
  double* rt_s = reinterpret_cast<double*>(
      reinterpret_cast<unsigned char*>(sm) + Y.template rt_bytes<real>());
  int* it_s = reinterpret_cast<int*>(rt_s + Y.n_rt);
  unsigned char* st = reinterpret_cast<unsigned char*>(it_s + MB_IT_CAP);
  const int n_it = og.it[TB_OFF_ROWS] + 2 * m + 1;
  const int npar = og.it[n_it - 1];
  const bool p_in = npar * T <= MB_P_CAP, it_in = n_it <= MB_IT_CAP;
  const Ocp o{it_in ? it_s : og.it, rt_s};
  const Col<const real> Pc = p_in ? Col<const real>{sm + Y.P, 1, 0}
                                  : Col<const real>{P, B, b};
  const Col<const real> xc{sm + Y.x0, 1, 0}, Zc{sm + Y.Z, 1, 0};
  const Col<real> qc{qp, B, b};
  real* A = sm + Y.A;
  real* V = sm + Y.V;
  real* red = sm + Y.red;
  const size_t A2 = (size_t)T * NN;

  blk.run([&](int tid) {
    const int n = blk.threads();
    if (p_in)
      for (int f = tid; f < npar * T; f += n) sm[Y.P + f] = P[f * B + b];
    for (int f = tid; f < T * NZ; f += n) sm[Y.Z + f] = Z[f * B + b];
    for (int f = tid; f < NX; f += n) sm[Y.x0 + f] = x0[f * B + b];
    for (int f = tid; f < Y.n_rt; f += n) rt_s[f] = og.rt[f];
    if (it_in)
      for (int f = tid; f < n_it; f += n) it_s[f] = og.it[f];
  });
  LIN_CLOCK;
  auto merit_of = [&](int t) {
    merit_stage<M>(o, Pc, Zc, T, t, red + t, red + T + t, red + 2 * T + t);
  };
  blk.run([&](int tid) {
    const int t = tid / G, l = tid % G;
    if (tid < Y.lin_threads) {
      if (t < T && l < NZ)
        lin_direction<M, real>(o, Pc, Zc, qc, L, t, l, A + t * NN);
      if (t < T) lin_rows<M, real, G>(o, Pc, Zc, qc, L, t, l);
    } else if (tid - Y.lin_threads < T) {
      merit_of(tid - Y.lin_threads);
    }
    if (tid == 0) {
      linearize_r0(xc, Zc, qc, L);
      red[3 * T] = initial_defect<M>(xc, Zc);
    }
  });
  LIN_SKIP();
  jacobi_stages<real, NZ, G>(
      blk, T, [&](int s) { return s < N ? NZ : NX; }, A, V, sm + Y.rot,
      sm + Y.part, st, real(o.rt[RT_REG_EPS]));
  LIN_LAP(LIN_SEC_JACOBI);
  // V max(|w|, eps) V^T packed, lane i row i; at stage N the u block the
  // identity, the u-x blocks 0; the merit terms where no warp took them
  blk.run([&](int tid) {
    const int t = tid / G, i = tid % G;
    if (Y.merit_threads == 0 && tid < T) merit_of(tid);
    if (t >= T || i >= NZ) return;
    const bool bad = (st[tid] & MB_BAD) != 0;
    const real* a = A + ((st[tid] & MB_BUF) ? A2 : 0) + t * NN;
    const real* v = V + t * NN;
    const int f0 = L.H + t * NTRI + i * NZ - i * (i - 1) / 2;
    for (int k = i; k < NZ; ++k) {
      real h;
      if (t < N)
        h = bad ? real(NAN) : mirror_entry<real, NZ>(a, v, NZ, i, k);
      else if (i < NU)
        h = k == i ? real(1) : real(0);
      else
        h = bad ? real(NAN) : mirror_entry<real, NZ>(a, v, NX, i - NU, k - NU);
      qc[f0 + k - i] = h;
    }
  });
  LIN_LAP(LIN_SEC_STORE);
  blk.run([&](int tid) {
    if (tid != 0) return;
    MeritSum<real> sum;
    for (int t = 0; t < T; ++t) sum.add(red[t], red[T + t], red[2 * T + t]);
    real mv, cost, eq;
    sum.finish(o, red[3 * T], &mv, &cost, &eq);
    merit_out[b] = mv;
    merit_out[B + b] = cost;
    merit_out[2 * B + b] = eq;
  });
  LIN_LAP(LIN_SEC_MERIT);
}

#if defined(__CUDACC__)
// The block design's kernel: block b problem b.
template <typename real, class M>
__global__ void __launch_bounds__(MIRROR_BLOCK_MAX)
mirror_block_kernel(const real* __restrict__ P, const real* __restrict__ x0,
                    const real* __restrict__ Z, real* __restrict__ qp,
                    real* __restrict__ merit_out, const int* __restrict__ itab,
                    const double* __restrict__ rtab, tmpc::QpLayout<M> L,
                    int Bt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  LIN_INIT();
  LIN_CLOCK;
  mirror_block_column<M, real>(
      warp::Block{(int)(blockDim.x / WIDTH), (int)threadIdx.x},
      tmpc::Ocp{itab, rtab}, P, x0, Z, qp, merit_out, Bt, blockIdx.x, L,
      reinterpret_cast<real*>(smem_raw));
  LIN_LAP(tmpc::LIN_SEC_TOTAL);
  LIN_FLUSH();
}
#endif

}  // namespace
