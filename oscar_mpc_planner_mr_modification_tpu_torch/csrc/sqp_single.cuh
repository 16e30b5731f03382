// The per-problem code of the single-instance SQP kernel (sqp_single.cu,
// S1), one block of threads (warp.cuh Block) per problem, shared with the
// host builds (tmpc_ocp_host.cpp, qp_ip_count.cpp).
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
// How the block shares the work: the row passes take the (stage, row)
// entries over every thread (every row, masked or not, so that a non-finite
// masked entry propagates as the plain version's masked products do), Hbar
// one thread per row of a stage's block, gbar one thread per (stage,
// column) after a pass over the entries for the rows' terms, the residuals,
// H z + g and the update their entries; the Riccati factor and the vector
// sweeps stay sequential over stages, in JAX's order, on one warp each
// (a stage's matrices one entry per lane in registers, Dist, moved between
// lanes by shuffles; small products as uniform code): the factor on warp 0
// while the other warps compute the residuals, H z + g and the affine gbar
// and warp 1 then follows the factor stage by stage with the affine vector
// sweep (Progress); the corrector's sweep on warp 0.
// Every sum keeps the serial code's order (qp_ip.cuh's: rows in order for
// Hbar and gbar, a stage-order chain per row then rows in order for the
// complementarities), whatever the number of warps; max and min reduce by
// warp shuffles, then across warps. The factorization and the vector sweep
// are S1's own (the inverse divides the adjugate by the determinant, as the
// plain version does; the Cholesky factor for nu > 3).

#pragma once

#include <type_traits>

#include "mirror.cuh"
#include "qp_ip.cuh"
#include "tmpc_ocp.cuh"

namespace {

using tmpc::Col;
using warp::Block;

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

// The warps per block S1 runs with (warp.cuh Block), widest first, and the
// kinds of warp partials its reductions keep (NPART x MAX_WARPS reals).
constexpr int BLOCK_WARPS[3] = {8, 4, 2};
constexpr int MAX_WARPS = BLOCK_WARPS[0];
constexpr int NPART = 8;

// The warps per block for Bt problems: of BLOCK_WARPS[i] with per_sm[i]
// blocks resident per SM on `sms` SMs, the width with the most problems
// resident at once, min(Bt, sms per_sm[i]), the widest on a tie; 0 when no
// block fits. So 8 warps while the problems fit one wave of 8-warp blocks,
// and above it the narrower blocks that keep more problems in flight.
inline int block_warps(int Bt, int sms, const int* per_sm) {
  long long best = 0;
  int W = 0;
  for (int i = 0; i < 3; ++i) {
    const long long cap = (long long)sms * per_sm[i];
    const long long res = cap < Bt ? cap : Bt;
    if (res > best) {
      best = res;
      W = BLOCK_WARPS[i];
    }
  }
  return W;
}

template <typename real>
struct SingleState {
  IpState<real> w;       // qp_ip.cuh's interior-point state
  real *bz, *bs, *blam;  // the best-merit iterate
  real* part;            // the warp partials
  real* prd;             // P_{k+1} rd_k of the corrector's vector sweep
  real* prog;            // the factor's progress (one real)
};

// Offsets, in reals, of the interior-point state of solve_qp_problem:
// qp_ip.cuh's Scratch, then the best-of copies of z, s and lam, the warp
// partials, the corrector sweep's P_{k+1} rd_k and the factor's progress.
template <int NX, int NU>
struct SingleScratch {
  static constexpr int NZ = NX + NU;
  Scratch<NX, NU> ip;
  int bz, bs, blam, part, prd, prog, total;
  __host__ __device__ explicit SingleScratch(const Sizes& sz) : ip(sz) {
    bz = ip.total;
    bs = bz + sz.T * NZ;
    blam = bs + sz.T * sz.m;
    part = blam + sz.T * sz.m;
    prd = part + NPART * MAX_WARPS;
    prog = prd + sz.T * NX;
    total = prog + 1;
  }
  template <typename real>
  __host__ __device__ SingleState<real> state(real* b) const {
    return SingleState<real>{ip.state(b), b + bz,  b + bs,  b + blam,
                             b + part,    b + prd, b + prog};
  }
};

// ---- section counters (tools/s1_sections.py) -----------------------------
// Built with -DS1_SECTIONS, S1 adds the clock64() cycles that thread 0 of
// block 0 (problem 0) spends in each section of the solve into a shared
// array, and the kernel adds it to s1_sections at its end
// (sqp_single_sections reads it). Without the switch the macros are empty:
// the default build is the same kernel, and the host builds never see them.
enum {
  SEC_QP = 0,  // a QP's start and its returned iterate's comp and eq_res
  SEC_ROWS,    // the row passes (residuals and W, affine, comp_aff, rhs3,
               // corrector)
  SEC_RED,     // the reductions of their partials and the scalar logic
  SEC_HBAR,    // Hbar
  SEC_FACTOR,  // the Riccati factor
  SEC_RESID,   // the dynamics residuals, H z + g, max |z|
  SEC_GBAR,    // gbar (affine and corrector)
  SEC_VEC,     // the two vector sweeps and forward rollouts
  SEC_UPDATE,  // the z / s / lam update and the best-merit copies
  SEC_LIN,     // per SQP iteration: the linearization
  SEC_MIRROR,  // the mirror pass
  SEC_MERIT,   // the merit evaluations
  SEC_STEP,    // the NaN test and the full step, the output
  SEC_F_PAB,   // inside the factor: P A and P B,
  SEC_F_Q,     // Quu and Qux,
  SEC_F_LF,    // Quu's factor,
  SEC_F_K,     // K,
  SEC_F_SP,    // Qxx, S and P (with the progress published)
  SEC_V_BWD,   // inside the corrector's vector sweep: backward,
  SEC_V_FWD,   // forward
  SEC_N_IP,    // interior-point iterations run
  SEC_N_SQP,   // SQP iterations run
  SEC_TOTAL,   // the whole solve
  SEC_COUNT
};

#if defined(S1_SECTIONS) && defined(__CUDACC__)
__device__ unsigned long long s1_sections[SEC_COUNT];
__shared__ unsigned long long s1_sec_sm[SEC_COUNT];
#define S1_SEC_ON (blockIdx.x == 0 && threadIdx.x == 0)
#define S1_CLOCK long long s1_t = clock64()
#define S1_LAP(k)                                  \
  do {                                             \
    const long long s1_n = clock64();              \
    if (S1_SEC_ON) s1_sec_sm[k] += s1_n - s1_t;    \
    s1_t = clock64();                              \
  } while (0)
#define S1_SKIP() (s1_t = clock64())
// A second clock, for sections inside another section's span.
#define S1_SUBCLOCK long long s1_u = clock64()
#define S1_SUBLAP(k)                               \
  do {                                             \
    const long long s1_n = clock64();              \
    if (S1_SEC_ON) s1_sec_sm[k] += s1_n - s1_u;    \
    s1_u = clock64();                              \
  } while (0)
#define S1_COUNT(k)                    \
  do {                                 \
    if (S1_SEC_ON) s1_sec_sm[k] += 1;  \
  } while (0)
#else
#define S1_CLOCK
#define S1_LAP(k)
#define S1_SKIP()
#define S1_SUBCLOCK
#define S1_SUBLAP(k)
#define S1_COUNT(k)
#endif

// Finite (neither NaN nor infinite), by comparisons alone.
template <typename real>
WARP_FN bool is_finite(real v) {
  return v == v && fabs(v) != real(INFINITY);
}

// ---- the Riccati sweeps (JAX ops/qp.py::riccati_factor, _solve_vec) -------
// Quu's inverse for N <= 3 as the adjugate `adj` over the determinant
// `det` (the factor's lanes divide entry by entry).
template <typename real, int N>
WARP_FN void spd_adjugate(const real* M, real* adj, real& det) {
  if constexpr (N == 1) {
    adj[0] = real(1);
    det = M[0];
  } else if constexpr (N == 2) {
    const real a = M[0], b = M[1], d = M[3];
    det = a * d - b * b;
    const real nb = -b;
    adj[0] = d;
    adj[1] = nb;
    adj[2] = nb;
    adj[3] = a;
  } else {
    static_assert(N == 3, "the adjugate for N <= 3");
    const real a = M[0], b = M[1], c = M[2];
    const real d = M[4], e = M[5], f = M[8];
    const real A00 = d * f - e * e;
    const real A01 = c * e - b * f;
    const real A02 = b * e - c * d;
    const real A11 = a * f - c * c;
    const real A12 = b * c - a * e;
    const real A22 = a * d - b * b;
    det = a * A00 + b * A01 + c * A02;
    const real v[9] = {A00, A01, A02, A01, A11, A12, A02, A12, A22};
    for (int i = 0; i < 9; ++i) adj[i] = v[i];
  }
}

// Quu's factor for N > 3: the lower Cholesky factor (NaN where a pivot is
// not positive).
template <typename real, int N>
WARP_FN void spd_factor(const real* M, real* Lf) {
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

// x = -M^{-1} rhs for one right-hand side (stride rs between its entries)
// from Quu's factor Lf: the product by -inverse for N <= 3, two triangular
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

// The chain warp's progress through the factor, for the warp that follows
// it stage by stage (the affine vector sweep): after stage k's stores,
// lane 0 publishes k; the follower awaits k before it reads stage k. The
// slot holds T (nothing out) until the factor's first stage; the follower
// sleeps between looks, so that its polling does not slow the factor's
// shared-memory traffic. On the host, where the factor has run to its end
// before the follower starts, both do nothing.
template <typename real>
struct Progress {
  real* slot;
#if defined(__CUDACC__)
  __device__ __forceinline__ void publish(int k) const {
    __threadfence_block();
    *(volatile real*)slot = real(k);
  }
  __device__ __forceinline__ void await(int k) const {
    while (*(volatile real*)slot > real(k)) __nanosleep(64);
    __threadfence_block();
  }
#else
  void publish(int) const {}
  void await(int) const {}
#endif
};

// N values spread over the lanes of the chain warp, entry e on lane
// e % WIDTH in slot e / WIDTH: registers on the card, where D(e) reads an
// entry across lanes by __shfl_sync (every lane of the warp calls it, each
// with its own e), and an array of the N entries on the host. A lane phase
// writes one Dist and reads others, so that on the host, where the lanes
// run in turn, no lane reads what another wrote in the same phase.
template <typename real, int N>
struct Dist {
  static constexpr int R = (N + WIDTH - 1) / WIDTH;
#if defined(__CUDACC__)
  real v[R];
  __device__ __forceinline__ real operator()(int e) const {
    real out = __shfl_sync(0xffffffffu, v[0], e % WIDTH);
    WARP_UNROLL for (int r = 1; r < R; ++r) {
      const real x = __shfl_sync(0xffffffffu, v[r], e % WIDTH);
      if (e / WIDTH == r) out = x;
    }
    return out;
  }
#else
  real v[N];
  real operator()(int e) const { return v[e]; }
#endif
};

// Lane l's entries e = l + r WIDTH of D set to f(e, r). On the card every
// lane computes all R slots in one code path, a lane past the end
// repeating entry N - 1, so that the shuffles inside f see every lane; on
// the host only the real entries run, so that each operation counts once.
template <typename real, int N, class F>
WARP_FN void dist_set(Dist<real, N>& D, int l, F&& f) {
  WARP_UNROLL for (int r = 0; r < Dist<real, N>::R; ++r) {
    const int e = l + r * WIDTH;
#if defined(__CUDACC__)
    D.v[r] = f(e < N ? e : N - 1, r);
#else
    if (e < N) D.v[e] = f(e, r);
#endif
  }
}

// a[e] of a register array by selects (no local memory for a lane's e).
template <int N, typename real>
WARP_FN real pick(const real* a, int e) {
  real v = a[0];
  WARP_UNROLL for (int q = 1; q < N; ++q)
    if (q == e) v = a[q];
  return v;
}

WARP_FN int clamp_entry(int e, int n) { return e < n ? e : n - 1; }

// Lane l's own entry l + r WIDTH of D: its register on the card.
template <typename real, int N>
WARP_FN real own(const Dist<real, N>& D, int l, int r = 0) {
#if defined(__CUDACC__)
  return D.v[r];
#else
  const int e = l + r * WIDTH;
  return D.v[e < N ? e : 0];
#endif
}

// The stage operands of lane l in the factor (they do not depend on P):
// the columns of A or B and the Hbar entries its P A, P B, Quu, Qux and S
// entries take, loaded at the stage's start. (Loading stage k - 1's while
// stage k ran, in registers, spilled and was slower on the card.)
template <typename real, int NX, int NU>
struct FactorOps {
  static constexpr int NZ = NX + NU;
  static constexpr int RA = (NX * NX + WIDTH - 1) / WIDTH;
  real pa[RA][NX];    // A's column j of each P A entry (i, j)
  real sa[RA][NX];    // A's column i of each S entry (i, j)
  real hs[RA];        // Hbar_xx(i, j) of each S entry (i, j)
  real pb[NX];        // B's column j of the P B entry (i, j)
  real uu[NX], huu;   // B's column i and Hbar_uu(i, j) of the Quu entry
  real ux[NX], hux;   // B's column i and Hbar_ux(i, j) of the Qux entry
  WARP_FN FactorOps(const QpView<real>& q, const real* hbar, int k, int l) {
    const real* A = q.A + k * NX * NX;
    const real* B = q.B + k * NX * NU;
    const real* hb = hbar + k * NZ * NZ;
    WARP_UNROLL for (int r = 0; r < RA; ++r) {
      const int e = clamp_entry(l + r * WIDTH, NX * NX);
      const int i = e / NX, j = e % NX;
      WARP_UNROLL for (int c = 0; c < NX; ++c) {
        pa[r][c] = A[c * NX + j];
        sa[r][c] = A[c * NX + i];
      }
      hs[r] = hb[(NU + i) * NZ + NU + j];
    }
    const int eb = clamp_entry(l, NX * NU), eu = clamp_entry(l, NU * NU);
    const int ex = clamp_entry(l, NU * NX);
    WARP_UNROLL for (int c = 0; c < NX; ++c) {
      pb[c] = B[c * NU + eb % NU];
      uu[c] = B[c * NU + eu / NU];
      ux[c] = B[c * NU + ex / NX];
    }
    huu = hb[(eu / NU) * NZ + eu % NU];
    hux = hb[(ex / NX) * NZ + NU + ex % NX];
  }
};

// Backward matrix sweep over Hbar on the chain warp (JAX's riccati_factor
// order): per stage P A and P B, then Quu = Hbar_uu + B^T P B and Qux =
// Hbar_ux + B^T P A, Quu's factor (the inverse entry by entry over NU x NU
// lanes; Cholesky, uniform, above NU = 3), K = -Quu^{-1} Qux entry by
// entry (each lane of K dividing its row of the inverse itself on the
// card), S = Hbar_xx + A^T P A + Qux^T K entry by entry and P_k = 0.5 (S +
// S^T). Every quantity lives in the lanes' registers (Dist), one entry
// (i, j) per lane, and moves between phases by shuffles, with no
// synchronization and no shared memory on the chain. The lanes store K,
// Quu's factor, Qux and P_{k+1} for the vector sweeps off the chain, and
// each stage ends by publishing its index to `prog`.
template <typename real, int NX, int NU>
WARP_FN void single_factor(const Lanes& L, const QpView<real>& q,
                           const IpState<real>& w, int T,
                           const Progress<real>& prog) {
  constexpr int NZ = NX + NU, NXX = NX * NX, NUU = NU * NU, NUX = NU * NX;
  static_assert(NX * NU <= WIDTH && NUU <= WIDTH, "one entry per lane");
  using Ops = FactorOps<real, NX, NU>;
  const real* hbT = w.hbar + (T - 1) * NZ * NZ;
  Dist<real, NXX> P, PA, S;  // P_{k+1}, P A, S
  Dist<real, NX * NU> PB;
  Dist<real, NUU> Quu, Lf;
  Dist<real, NUX> Qux, K;
  S1_CLOCK;
  // P_{T-1}: Hbar's x block, also the sweeps' P_{T-1}
  L.regs([&](int l) {
    dist_set(P, l, [&](int e, int) {
      return hbT[(NU + e / NX) * NZ + NU + e % NX];
    });
    WARP_UNROLL for (int r = 0; r < Dist<real, NXX>::R; ++r)
      if (l + r * WIDTH < NXX)
        w.Pn[(T - 2) * NXX + l + r * WIDTH] = own(P, l, r);
  });
  for (int k = T - 2; k >= 0; --k) {
#if defined(__CUDACC__)
    const Ops cur(q, w.hbar, k, L.lane);
    auto ops = [&](int) -> const Ops& { return cur; };
#else
    auto ops = [&](int l) { return Ops(q, w.hbar, k, l); };
#endif
    auto Pt = [&](int i, int c) { return P(i * NX + c); };
    L.regs([&](int l) {
      const Ops& o = ops(l);
      dist_set(PA, l, [&](int e, int r) {
        const int i = e / NX;
        real acc = Pt(i, 0) * o.pa[r][0];
        WARP_UNROLL for (int c = 1; c < NX; ++c)
          acc = acc + Pt(i, c) * o.pa[r][c];
        return acc;
      });
      dist_set(PB, l, [&](int e, int) {
        const int i = e / NU;
        real acc = Pt(i, 0) * o.pb[0];
        WARP_UNROLL for (int c = 1; c < NX; ++c) acc = acc + Pt(i, c) * o.pb[c];
        return acc;
      });
    });
    S1_LAP(SEC_F_PAB);
    L.regs([&](int l) {
      const Ops& o = ops(l);
      dist_set(Quu, l, [&](int e, int) {
        const int j = e % NU;
        real acc = o.uu[0] * PB(j);
        WARP_UNROLL for (int c = 1; c < NX; ++c)
          acc = acc + o.uu[c] * PB(c * NU + j);
        return o.huu + acc;
      });
      dist_set(Qux, l, [&](int e, int) {
        const int j = e % NX;
        real acc = o.ux[0] * PA(j);
        WARP_UNROLL for (int c = 1; c < NX; ++c)
          acc = acc + o.ux[c] * PA(c * NX + j);
        return o.hux + acc;
      });
    });
    S1_LAP(SEC_F_Q);
    // Quu's factor: the adjugate and determinant uniform, then lane e
    // divides entry e; the Cholesky factor, uniform, above NU = 3.
    real Mq[NUU], F[NUU], det = real(1);
    WARP_UNROLL for (int e = 0; e < NUU; ++e) Mq[e] = Quu(e);
    if constexpr (NU <= 3) {
      spd_adjugate<real, NU>(Mq, F, det);
    } else {
      spd_factor<real, NU>(Mq, F);
    }
    L.regs([&](int l) {
      dist_set(Lf, l, [&](int e, int) {
        if constexpr (NU <= 3)
          return pick<NUU>(F, e) / det;
        else
          return pick<NUU>(F, e);
      });
    });
    S1_LAP(SEC_F_LF);
    L.regs([&](int l) {
      dist_set(K, l, [&](int e, int) {
        const int i = e / NX, j = e % NX;
        if constexpr (NU <= 3) {
#if defined(__CUDACC__)
          // row i of the inverse divided here, as lane i NU + c divides it
          auto lf = [&](int c) { return pick<NUU>(F, i * NU + c) / det; };
#else
          auto lf = [&](int c) { return Lf(i * NU + c); };
#endif
          real acc = lf(0) * Qux(j);
          WARP_UNROLL for (int c = 1; c < NU; ++c)
            acc = acc + lf(c) * Qux(c * NX + j);
          return -acc;
        } else {
          real rhs[NU], x[NU];
          WARP_UNROLL for (int c = 0; c < NU; ++c) rhs[c] = Qux(c * NX + j);
          spd_neg_solve<real, NU>(F, rhs, 1, x);
          return pick<NU>(x, i);
        }
      });
    });
    S1_LAP(SEC_F_K);
    // S = Hbar_xx + A^T P A + Qux^T K, then P_k = 0.5 (S + S^T); the lanes
    // store P_k, K, Qux and Quu's factor for the sweeps
    L.regs([&](int l) {
      const Ops& o = ops(l);
      dist_set(S, l, [&](int e, int r) {
        const int i = e / NX, j = e % NX;
        real qxx = o.sa[r][0] * PA(j);
        WARP_UNROLL for (int c = 1; c < NX; ++c)
          qxx = qxx + o.sa[r][c] * PA(c * NX + j);
        qxx = o.hs[r] + qxx;
        real acc = Qux(i) * K(j);
        WARP_UNROLL for (int c = 1; c < NU; ++c)
          acc = acc + Qux(c * NX + i) * K(c * NX + j);
        return qxx + acc;
      });
    });
    L.regs([&](int l) {
      dist_set(P, l, [&](int e, int) {
        const int i = e / NX, j = e % NX;
        return real(0.5) * (S(e) + S(j * NX + i));
      });
      if (k > 0)
        WARP_UNROLL for (int r = 0; r < Dist<real, NXX>::R; ++r)
          if (l + r * WIDTH < NXX)
            w.Pn[(k - 1) * NXX + l + r * WIDTH] = own(P, l, r);
      if (l < NUX) {
        w.K[k * NUX + l] = own(K, l);
        w.Qux[k * NUX + l] = own(Qux, l);
      }
      if (l < NUU) w.Linv[k * NUU + l] = own(Lf, l);
    });
    L.sync();
    L.one([&] { prog.publish(k); });
    S1_LAP(SEC_F_SP);
  }
}

// The vector sweep's stage operands of lane l (i = l, clamped to NX - 1):
// uniform B, gbar_u and Quu's factor, and the lane's column of A and of
// Qux and gbar_x entry; with `prd`, (P_{k+1} rd_k)_i from it.
template <typename real, int NX, int NU>
struct VecOps {
  static constexpr int NZ = NX + NU;
  real B[NX * NU], gu[NU], Lk[NU * NU], a[NX], qux[NU], gx, pr;
  WARP_FN VecOps(const QpView<real>& q, const IpState<real>& w,
                 const real* prd, int k, int l) {
    const int i = clamp_entry(l, NX);
    WARP_UNROLL for (int e = 0; e < NX * NU; ++e) B[e] = q.B[k * NX * NU + e];
    WARP_UNROLL for (int e = 0; e < NU; ++e) {
      gu[e] = w.gbar[k * NZ + e];
      qux[e] = w.Qux[k * NU * NX + e * NX + i];
    }
    WARP_UNROLL for (int e = 0; e < NU * NU; ++e) Lk[e] = w.Linv[k * NU * NU + e];
    WARP_UNROLL for (int c = 0; c < NX; ++c) a[c] = q.A[k * NX * NX + c * NX + i];
    gx = w.gbar[k * NZ + NU + i];
    pr = prd != nullptr ? prd[k * NX + i] : real(0);
  }
};

// (P_{k+1} rd_k)_i of the vector sweep, entry e = k NX + i: computed for
// every stage by the block before each sweep, off the chain.
template <typename real, int NX>
WARP_FN real pn_rd(const IpState<real>& w, const real* rd, int e) {
  const int k = e / NX, i = e % NX;
  const real* Pn = w.Pn + k * NX * NX;
  const real* rdk = rd + k * NX;
  real acc = Pn[i * NX] * rdk[0];
  for (int c = 1; c < NX; ++c) acc = acc + Pn[i * NX + c] * rdk[c];
  return acc;
}

// The vector sweep (qp_ip.cuh::solve_vec's arithmetic, with kff =
// -Quu^{-1} qu from the factor), backward, in registers: lane i holds p_i
// and forms beta_i = p_i + (P_{k+1} rd_k)_i (from `prd`, or, following the
// factor (FOLLOW), from pn_rd once the factor has published stage k);
// every lane takes beta by shuffles and forms qu and kff (uniform); lane i
// forms qx_i and the next p_i; lane 0 stores kff. Each stage loads its
// operands (VecOps) at its start.
template <bool FOLLOW, typename real, int NX, int NU>
WARP_FN void vec_backward(const Lanes& L, const QpView<real>& q,
                          const IpState<real>& w, int T, const real* prd,
                          const real* rd, const Progress<real>& prog) {
  constexpr int NZ = NX + NU;
  using Ops = VecOps<real, NX, NU>;
  Dist<real, NX> p, beta;
  L.regs([&](int l) {
    dist_set(p, l, [&](int e, int) { return w.gbar[(T - 1) * NZ + NU + e]; });
  });
  for (int k = T - 2; k >= 0; --k) {
    if (FOLLOW) prog.await(k);
#if defined(__CUDACC__)
    const Ops cur(q, w, prd, k, L.lane);
    auto ops = [&](int) -> const Ops& { return cur; };
#else
    auto ops = [&](int l) { return Ops(q, w, prd, k, l); };
#endif
    L.regs([&](int l) {
      dist_set(beta, l, [&](int e, int) {
        return p(e) + (FOLLOW ? pn_rd<real, NX>(w, rd, k * NX + e)
                              : ops(l).pr);
      });
    });
    const Ops& u = ops(0);
    real b[NX], qu[NU], kff[NU];
    WARP_UNROLL for (int c = 0; c < NX; ++c) b[c] = beta(c);
    WARP_UNROLL for (int i = 0; i < NU; ++i) {
      real acc = u.B[i] * b[0];
      WARP_UNROLL for (int c = 1; c < NX; ++c) acc = acc + u.B[c * NU + i] * b[c];
      qu[i] = u.gu[i] + acc;
    }
    spd_neg_solve<real, NU>(u.Lk, qu, 1, kff);
    L.regs([&](int l) {
      const Ops& o = ops(l);
      dist_set(p, l, [&](int, int) {
        real acc = o.a[0] * b[0];
        WARP_UNROLL for (int c = 1; c < NX; ++c) acc = acc + o.a[c] * b[c];
        const real qx = o.gx + acc;
        real acc2 = o.qux[0] * kff[0];
        WARP_UNROLL for (int c = 1; c < NU; ++c) acc2 = acc2 + o.qux[c] * kff[c];
        return qx + acc2;
      });
      if (l == 0)
        WARP_UNROLL for (int i = 0; i < NU; ++i) w.kff[k * NU + i] = kff[i];
    });
  }
  L.sync();  // lane 0's kff before the rollout reads it
}

// The forward rollout's stage operands: uniform K and kff, the lane's rows
// of A and B and its dynamics residual (i = l, clamped to NX - 1).
template <typename real, int NX, int NU>
struct FwdOps {
  real K[NU * NX], kff[NU], a[NX], b[NU], rd;
  WARP_FN FwdOps(const QpView<real>& q, const IpState<real>& w,
                 const real* rdv, int k, int l) {
    const int i = clamp_entry(l, NX);
    WARP_UNROLL for (int e = 0; e < NU * NX; ++e) K[e] = w.K[k * NU * NX + e];
    WARP_UNROLL for (int e = 0; e < NU; ++e) {
      kff[e] = w.kff[k * NU + e];
      b[e] = q.B[(k * NX + i) * NU + e];
    }
    WARP_UNROLL for (int c = 0; c < NX; ++c) a[c] = q.A[(k * NX + i) * NX + c];
    rd = rdv[k * NX + i];
  }
};

// The forward rollout: dz from K, kff, the dynamics residuals rd and the
// initial residual r0; every lane holds dx and forms du (uniform), lane i
// forms dx_{k+1, i}, and every lane takes dx_{k+1} by shuffles; lane 0
// stores dz.
template <typename real, int NX, int NU>
WARP_FN void vec_forward(const Lanes& L, const QpView<real>& q,
                         const IpState<real>& w, int T, const real* rd,
                         const real* r0) {
  constexpr int NZ = NX + NU;
  using Ops = FwdOps<real, NX, NU>;
  Dist<real, NX> x;
  real dx[NX];
  WARP_UNROLL for (int i = 0; i < NX; ++i) dx[i] = r0[i];
  for (int k = 0; k < T - 1; ++k) {
#if defined(__CUDACC__)
    const Ops cur(q, w, rd, k, L.lane);
    auto ops = [&](int) -> const Ops& { return cur; };
#else
    auto ops = [&](int l) { return Ops(q, w, rd, k, l); };
#endif
    const Ops& u = ops(0);
    real du[NU];
    WARP_UNROLL for (int i = 0; i < NU; ++i) {
      real acc = u.K[i * NX] * dx[0];
      WARP_UNROLL for (int c = 1; c < NX; ++c) acc = acc + u.K[i * NX + c] * dx[c];
      du[i] = acc + u.kff[i];
    }
    L.regs([&](int l) {
      const Ops& o = ops(l);
      dist_set(x, l, [&](int, int) {
        real acc_a = o.a[0] * dx[0];
        WARP_UNROLL for (int c = 1; c < NX; ++c) acc_a = acc_a + o.a[c] * dx[c];
        real acc_b = o.b[0] * du[0];
        WARP_UNROLL for (int c = 1; c < NU; ++c) acc_b = acc_b + o.b[c] * du[c];
        return (acc_a + acc_b) + o.rd;
      });
      if (l == 0) {
        WARP_UNROLL for (int i = 0; i < NU; ++i) w.dz[k * NZ + i] = du[i];
        WARP_UNROLL for (int i = 0; i < NX; ++i) w.dz[k * NZ + NU + i] = dx[i];
      }
    });
    WARP_UNROLL for (int i = 0; i < NX; ++i) dx[i] = x(i);
  }
  L.one([&] {
    for (int i = 0; i < NU; ++i) w.dz[(T - 1) * NZ + i] = real(0);
    for (int i = 0; i < NX; ++i) w.dz[(T - 1) * NZ + NU + i] = dx[i];
  });
}

// ---- the block's passes ---------------------------------------------------
// Warp partials of the max and min reductions: NPART kinds of MAX_WARPS
// slots (SingleScratch::part). A phase folds each thread's value into its
// warp's slot of a kind; uniform code after the phase's barrier combines
// the slots. A kind is written again only in a phase after the next
// barrier, so that no thread still reads it.
enum { PK_FEAS = 0, PK_LAM, PK_ZMAX, PK_AS, PK_AL, PK_DLAM, PK_DZ, PK_EQ };
enum { PK_AP = PK_FEAS, PK_AD = PK_LAM, PK_BAD = PK_ZMAX, PK_STEP = PK_AS };

// Folds v into kind k's slot of the thread's warp by nmax (nmin): on the
// card a butterfly of shuffles over the warp's lanes, lane 0 stores; on the
// host the lanes in order. Every lane of the warp calls it. Max and min do
// not depend on the order; a NaN propagates.
template <typename real>
WARP_FN void fold_max(int tid, real* part, int k, real v) {
  real* slot = part + k * MAX_WARPS + tid / WIDTH;
#if defined(__CUDACC__)
  WARP_UNROLL for (int o = WIDTH / 2; o > 0; o /= 2)
    v = nmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (tid % WIDTH == 0) *slot = v;
#else
  *slot = tid % WIDTH == 0 ? v : nmax(*slot, v);
#endif
}
template <typename real>
WARP_FN void fold_min(int tid, real* part, int k, real v) {
  real* slot = part + k * MAX_WARPS + tid / WIDTH;
#if defined(__CUDACC__)
  WARP_UNROLL for (int o = WIDTH / 2; o > 0; o /= 2)
    v = nmin(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (tid % WIDTH == 0) *slot = v;
#else
  *slot = tid % WIDTH == 0 ? v : nmin(*slot, v);
#endif
}

// Uniform: kind k's slots of warps w0..W-1, combined.
template <typename real>
WARP_FN real slots_max(const real* part, int k, int w0, int W) {
  real v = part[k * MAX_WARPS + w0];
  for (int i = w0 + 1; i < W; ++i) v = nmax(v, part[k * MAX_WARPS + i]);
  return v;
}
template <typename real>
WARP_FN real slots_min(const real* part, int k, int W) {
  real v = part[k * MAX_WARPS];
  for (int i = 1; i < W; ++i) v = nmin(v, part[k * MAX_WARPS + i]);
  return v;
}

// Row r's terms v (T x m, stage-major) summed in stage order, from 0: the
// serial code's per-row sum.
template <typename real>
WARP_FN real row_sum(const real* v, int r, int T, int m) {
  real acc = real(0);
  for (int t = 0; t < T; ++t) acc = acc + v[t * m + r];
  return acc;
}

// Row qa of stage t's Hbar: H_t's row (symmetric, from the upper triangle)
// plus the active rows' D_r^T W_r D_r in row order (qp_ip.cuh::build_hbar's
// sums, one thread per row of a stage's block instead of one lane per
// stage).
template <typename real, int NX, int NU>
WARP_FN void hbar_row(const QpView<real>& q, real* hbar, const real* W,
                      const Rows<real>& rw, const Sizes& sz, int t, int qa) {
  constexpr int NZ = NX + NU, NTRI = NZ * (NZ + 1) / 2;
  real h[NZ];
  const real* Ht = q.H + t * NTRI;
  WARP_UNROLL for (int k = 0; k < NZ; ++k) h[k] = Ht[tri_index(qa, k, NZ)];
  for (int r = 0; r < sz.m; ++r) {
    const int* ri = rw.rinfo + r * RK_W;
    if (!ri[RK_ACTIVE]) continue;
    const real Wr = W[t * sz.m + r];
    if (ri[RK_KIND] == 0) {
      if (qa == ri[RK_COL]) {
        WARP_UNROLL for (int c = 0; c < NZ; ++c)
          if (c == qa) h[c] = h[c] + Wr;
      }
    } else {
      const real* Dr = q.D + (t * sz.mhp + ri[RK_COL]) * NZ;
      const real DW = Dr[qa] * Wr;
      WARP_UNROLL for (int qb = 0; qb < NZ; ++qb) h[qb] = h[qb] + DW * Dr[qb];
    }
  }
  real* hb = hbar + (t * NZ + qa) * NZ;
  WARP_UNROLL for (int k = 0; k < NZ; ++k) hb[k] = h[k];
}

// gbar's row term of entry f (an active row): mask (lam rin - rhs3) / s.
template <typename real>
WARP_FN real gbar_term(const IpState<real>& w, const Rows<real>& rw, int f,
                       real r3) {
  return rw.mask[f] * (w.lam[f] * w.rin[f] - r3) / w.s[f];
}

// gbar entry (t, c) = (H z + g)_(t, c) plus the active rows' terms `wv` in
// row order (qp_ip.cuh::gbar_accum's sums, one thread per entry instead of
// one lane per stage).
template <typename real, int NX, int NU>
WARP_FN void gbar_entry(const QpView<real>& q, const IpState<real>& w,
                        const real* wv, const Rows<real>& rw, const Sizes& sz,
                        int t, int c) {
  constexpr int NZ = NX + NU;
  real g = w.hzg[t * NZ + c];
  for (int r = 0; r < sz.m; ++r) {
    const int* ri = rw.rinfo + r * RK_W;
    if (!ri[RK_ACTIVE]) continue;
    const real v = wv[t * sz.m + r];
    if (ri[RK_KIND] == 0) {
      if (c == ri[RK_COL]) g = g + real(ri[RK_SIGN]) * v;
    } else {
      g = g + q.D[(t * sz.mhp + ri[RK_COL]) * NZ + c] * v;
    }
  }
  w.gbar[t * NZ + c] = g;
}

// Entry e of the dynamics residuals of the iterate zv:
// rd_k = A dx_k + B du_k + c_k - dx_{k+1}, e = k NX + i.
template <typename real, int NX, int NU>
WARP_FN real dyn_entry(const QpView<real>& q, const real* zv, int e) {
  constexpr int NZ = NX + NU;
  const int k = e / NX, i = e % NX;
  real ax = q.A[(k * NX + i) * NX] * zv[k * NZ + NU];
  for (int j = 1; j < NX; ++j)
    ax = ax + q.A[(k * NX + i) * NX + j] * zv[k * NZ + NU + j];
  real bu = q.B[(k * NX + i) * NU] * zv[k * NZ];
  for (int j = 1; j < NU; ++j) bu = bu + q.B[(k * NX + i) * NU + j] * zv[k * NZ + j];
  return ((ax + bu) + q.c[e]) - zv[(k + 1) * NZ + NU + i];
}

// The affine step's dlam of entry f from its slack, multiplier and ds.
template <typename real>
WARP_FN real affine_dlam(real mk, real sv, real lv, real dsa) {
  return mk > real(0) ? (real(0) - sv * lv) / sv - (lv / sv) * dsa : real(0);
}

// One QP by JAX's solve_qp with n_iters interior-point iterations (see the
// file comment), on the block B. Leaves the best-merit iterate in st.bz /
// st.bs / st.blam; every thread returns its complementarity and equality
// residual.
//
// Per iteration: the row passes, Hbar, gbar and the update take entries
// (stage, row), (stage, row of the block) or (stage, column) over every
// thread; the sums over entries keep the serial order (a stage-order chain
// per row, then rows in order); max and min go through the warp slots. The
// Riccati factor runs on the chain warp while the rest computes the
// dynamics residuals, H z + g, max |z| and the affine gbar, and warp 1
// follows the factor stage by stage with the affine vector sweep; the
// corrector's vector sweep runs on the chain warp alone.
template <typename real, int NX, int NU>
__device__ void solve_qp_problem(const Block& B, const QpView<real>& q,
                                 const Rows<real>& rw, const Sizes& sz,
                                 const SingleState<real>& st, int n_iters,
                                 const SingleParams<real>& p, real* comp_out,
                                 real* eq_out) {
  constexpr int NZ = NX + NU, NTRI = NZ * (NZ + 1) / 2;
  const IpState<real>& w = st.w;
  const int T = sz.T, m = sz.m, mhp = sz.mhp;
  const int Tm = T * m, nzT = T * NZ, nrd = (T - 1) * NX;
  const int NT = B.threads(), NR = NT - WIDTH, nW = B.W;
  const real inf = real(INFINITY);
  const real* mask = rw.mask;
  const int* rinfo = rw.rinfo;
  real* const red0 = w.red;
  real* const red1 = red0 + w.R;
  real* const part = st.part;
  real* const W = w.ds;      // the weights; ds is free until the corrector
  real* const dlam = w.rin;  // the corrector's dlam; rin is read just before
  const Lanes L = B.lanes();

  // Centred start: s0 = max(e, sqrt(mu0)), lam0 = mu0 / s0; z0 = 0.
  S1_CLOCK;
  const real v0 = sqrt(p.mu0);
  B.run([&](int i) {
    for (int f = i; f < Tm; f += NT) {
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
    for (int f = i; f < nzT; f += NT) {
      w.z[f] = real(0);
      st.bz[f] = real(0);
    }
  });
  S1_LAP(SEC_QP);
  real best = inf;
  for (int it = 0; it < n_iters; ++it) {
    // ---- row residuals, W, comp's terms, feas, max(mask lam) -------------
    B.run([&](int i) {
      real f_i = real(0), l_i = real(0);
      for (int f = i; f < Tm; f += NT) {
        const int t = f / m;
        const int* ri = rinfo + (f - t * m) * RK_W;
        const real mk = mask[f], sv = w.s[f], lv = w.lam[f];
        const real rin = row_dz<real, NZ>(ri, q.D, mhp, w.z, t) + q.e[f] - sv;
        w.rin[f] = rin;
        W[f] = nmin(mk * lv / sv, p.w_max);
        w.dsa[f] = mk * sv * lv;
        f_i = nmax(f_i, fabs(mk * rin));
        l_i = nmax(l_i, mk * lv);
      }
      fold_max(i, part, PK_FEAS, f_i);
      fold_max(i, part, PK_LAM, l_i);
    });
    S1_LAP(SEC_ROWS);
    // ---- Hbar, with comp's row sums --------------------------------------
    B.run([&](int i) {
      for (int r = i; r < m; r += NT) red0[r] = row_sum(w.dsa, r, T, m);
      for (int e = i; e < nzT; e += NT)
        hbar_row<real, NX, NU>(q, w.hbar, W, rw, sz, e / NZ, e % NZ);
      if (i == 0) *st.prog = real(T);
    });
    S1_LAP(SEC_HBAR);
    real comp = real(0);
    for (int r = 0; r < m; ++r) comp = comp + red0[r];
    comp = comp / p.n_act;
    const real feas = slots_max(part, PK_FEAS, 0, nW);
    const real lam_max = slots_max(part, PK_LAM, 0, nW);
    S1_LAP(SEC_RED);

    // ---- the factor on the chain warp; the rest: the equality residuals,
    // H z + g, max |z| and the affine gbar, then warp 1 follows the factor
    // stage by stage with the affine vector sweep and rolls it forward -----
    const Progress<real> prog{st.prog};
    if (B.chain()) single_factor<real, NX, NU>(L, q, w, T, prog);
    S1_LAP(SEC_FACTOR);
    if (B.rest()) {
      B.run_rest([&](int i) {
        real zm = real(0);
        for (int e = i - WIDTH; e < nrd; e += NR)
          w.rd[e] = dyn_entry<real, NX, NU>(q, w.z, e);
        const int ir = i - WIDTH;
        if (ir < NX) w.r0res[ir] = q.r0[ir] - w.z[NU + ir];
        for (int e = i - WIDTH; e < nzT; e += NR) {
          const int t = e / NZ, k = e % NZ;
          real acc = q.H[t * NTRI + tri_index(k, 0, NZ)] * w.z[t * NZ];
          for (int j = 1; j < NZ; ++j)
            acc = acc + q.H[t * NTRI + tri_index(k, j, NZ)] * w.z[t * NZ + j];
          w.hzg[e] = acc + q.g[e];
          zm = nmax(zm, fabs(w.z[e]));
        }
        for (int f = i - WIDTH; f < Tm; f += NR)
          if (rinfo[(f % m) * RK_W + RK_ACTIVE])
            W[f] = gbar_term(w, rw, f, real(0));
        fold_max(i, part, PK_ZMAX, zm);
      });
      B.run_rest([&](int i) {
        for (int e = i - WIDTH; e < nzT; e += NR)
          gbar_entry<real, NX, NU>(q, w, W, rw, sz, e / NZ, e % NZ);
      });
      if (B.follower()) {
        vec_backward<true, real, NX, NU>(L, q, w, T, nullptr, w.rd, prog);
        vec_forward<real, NX, NU>(L, q, w, T, w.rd, w.r0res);
      }
    }
    B.sync();
    S1_LAP(SEC_VEC);
    const real z_max = slots_max(part, PK_ZMAX, 1, nW);

    // ---- affine (predictor) step -----------------------------------------
    B.run([&](int i) {
      real a_s = inf, a_l = inf, d_i = real(0), dm = real(0);
      for (int f = i; f < Tm; f += NT) {
        const int t = f / m;
        const int* ri = rinfo + (f - t * m) * RK_W;
        const real mk = mask[f], sv = w.s[f], lv = w.lam[f];
        real dsa = real(0), dla = real(0);
        if (mk > real(0)) {
          dsa = row_dz<real, NZ>(ri, q.D, mhp, w.dz, t) + w.rin[f];
          dla = (real(0) - sv * lv) / sv - (lv / sv) * dsa;
        }
        w.dsa[f] = dsa;
        a_s = nmin(a_s, ftb(sv, dsa, mk, p.big));
        a_l = nmin(a_l, ftb(lv, dla, mk, p.big));
        d_i = nmax(d_i, fabs(mk * dla));
      }
      for (int e = i; e < nzT; e += NT) dm = nmax(dm, fabs(w.dz[e]));
      fold_min(i, part, PK_AS, a_s);
      fold_min(i, part, PK_AL, a_l);
      fold_max(i, part, PK_DLAM, d_i);
      fold_max(i, part, PK_DZ, dm);
    });
    S1_LAP(SEC_ROWS);
    const real ftb_s = slots_min(part, PK_AS, nW);
    const real ftb_l = slots_min(part, PK_AL, nW);
    const real dlam_max = slots_max(part, PK_DLAM, 0, nW);
    const real dz_max = slots_max(part, PK_DZ, 0, nW);
    const real alpha_aff = nmin(real(1), nmin(ftb_s, ftb_l));
    S1_LAP(SEC_RED);
    B.run([&](int i) {
      for (int f = i; f < Tm; f += NT) {
        const real mk = mask[f], sv = w.s[f], lv = w.lam[f];
        const real dsa = w.dsa[f];
        const real dla = affine_dlam(mk, sv, lv, dsa);
        w.ds[f] = mk * (sv + alpha_aff * dsa) * (lv + alpha_aff * dla);
      }
    });
    B.run([&](int i) {
      for (int r = i; r < m; r += NT) red1[r] = row_sum(w.ds, r, T, m);
    });
    S1_LAP(SEC_ROWS);
    real comp_aff = real(0);
    for (int r = 0; r < m; ++r) comp_aff = comp_aff + red1[r];
    comp_aff = comp_aff / p.n_act;
    const real ratio = comp_aff / nmax(comp, real(1e-30));
    const real sigma = nmin(nmax(ratio * ratio * ratio, real(1e-8)), real(1));
    const real mu = nmax(sigma * comp, p.mu_min);
    S1_LAP(SEC_RED);

    // ---- corrector step: rhs3 = mu - ds_a dlam_a into dsa, gbar's terms
    // into ds --------------------------------------------------------------
    B.run([&](int i) {
      for (int f = i; f < Tm; f += NT) {
        const real mk = mask[f], sv = w.s[f], lv = w.lam[f];
        const real dsa = w.dsa[f];
        const real r3 = mu - dsa * affine_dlam(mk, sv, lv, dsa);
        w.dsa[f] = r3;
        if (rinfo[(f % m) * RK_W + RK_ACTIVE]) W[f] = gbar_term(w, rw, f, r3);
      }
    });
    S1_LAP(SEC_ROWS);
    B.run([&](int i) {
      for (int e = i; e < nzT; e += NT)
        gbar_entry<real, NX, NU>(q, w, W, rw, sz, e / NZ, e % NZ);
      for (int e = i; e < nrd; e += NT) st.prd[e] = pn_rd<real, NX>(w, w.rd, e);
    });
    S1_LAP(SEC_GBAR);
    if (B.chain()) {
      S1_SUBCLOCK;
      vec_backward<false, real, NX, NU>(L, q, w, T, st.prd, w.rd, prog);
      S1_SUBLAP(SEC_V_BWD);
      vec_forward<real, NX, NU>(L, q, w, T, w.rd, w.r0res);
      S1_SUBLAP(SEC_V_FWD);
    }
    B.sync();
    S1_LAP(SEC_VEC);
    B.run([&](int i) {
      real a_p = inf, a_d = inf, bad_i = real(0), e_i = real(0);
      for (int f = i; f < Tm; f += NT) {
        const int t = f / m;
        const int* ri = rinfo + (f - t * m) * RK_W;
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
        if (dsv != dsv || dlv != dlv) bad_i = real(1);
      }
      for (int e = i; e < nrd; e += NT) e_i = nmax(e_i, fabs(w.rd[e]));
      if (i < NX) e_i = nmax(e_i, fabs(w.r0res[i]));
      for (int e = i; e < nzT; e += NT)
        if (w.dz[e] != w.dz[e]) bad_i = real(1);
      fold_min(i, part, PK_AP, a_p);
      fold_min(i, part, PK_AD, a_d);
      fold_max(i, part, PK_BAD, bad_i);
      fold_max(i, part, PK_EQ, e_i);
    });
    S1_LAP(SEC_ROWS);
    real alpha_p = slots_min(part, PK_AP, nW);
    real alpha_d = slots_min(part, PK_AD, nW);
    const real eqr = slots_max(part, PK_EQ, 0, nW);
    const bool bad = slots_max(part, PK_BAD, 0, nW) > real(0);
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
    S1_LAP(SEC_RED);

    B.run([&](int i) {
      for (int f = i; f < nzT; f += NT) {
        if (better) st.bz[f] = w.z[f];
        w.z[f] = w.z[f] + alpha_p * w.dz[f];
      }
      for (int f = i; f < Tm; f += NT) {
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
    S1_LAP(SEC_UPDATE);
    S1_COUNT(SEC_N_IP);
  }

  // ---- the returned (best) iterate's comp and equality residual ----------
  B.run([&](int i) {
    for (int f = i; f < Tm; f += NT) w.dsa[f] = mask[f] * st.bs[f] * st.blam[f];
    for (int e = i; e < nrd; e += NT) w.rd[e] = dyn_entry<real, NX, NU>(q, st.bz, e);
    if (i < NX) w.r0res[i] = q.r0[i] - st.bz[NU + i];
  });
  B.run([&](int i) {
    real e_i = real(0);
    for (int r = i; r < m; r += NT) red0[r] = row_sum(w.dsa, r, T, m);
    for (int e = i; e < nrd; e += NT) e_i = nmax(e_i, fabs(w.rd[e]));
    if (i < NX) e_i = nmax(e_i, fabs(w.r0res[i]));
    fold_max(i, part, PK_EQ, e_i);
  });
  real comp = real(0);
  for (int r = 0; r < m; ++r) comp = comp + red0[r];
  *comp_out = comp / p.n_act;
  *eq_out = slots_max(part, PK_EQ, 0, nW);
  S1_LAP(SEC_QP);
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

// Problem b's whole solve on the block B: for every phase (n_sqp, n_qp) of
// `phases`, n_sqp times: linearize at the iterate, mirror (reg ==
// REG_MIRROR), solve the QP with n_qp iterations, take the full step unless
// it has a NaN; with track_best keep the best iterate by merit (cost + w
// eq_res, the initial-condition residual included). Batch-major in / out
// blocks. The linearization, the mirror pass, the merits and the best
// iterate's copies run on the chain warp (lane t on stage t), the QP and the
// step on the block.
template <class M, typename real>
__device__ void sqp_single_column(
    const Block& B, const tmpc::Ocp& o, const real* in, real* out, int b,
    int npar, real* mem, const Rows<real>& rw, const int* phases,
    int n_phases, const SingleOffsets<M>& F, int track_best, int reg,
    const SingleParams<real>& prm, real res_eq_tol) {
  constexpr int NX = M::NX, NU = M::NU, NZ = M::NZ;
  const int T = F.sz.T, nzT = T * NZ, NT = B.threads();
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
  const Lanes lanes = B.lanes();

  S1_CLOCK;
  B.run([&](int i) {
    for (int f = i; f < nzT; f += NT) z[f] = Z0[f];
  });
  // best and mv live on the chain warp, which alone writes zbest
  real best = real(0), mv, cost, eq, qp_comp = real(0), qp_eq;
  if (track_best && B.chain()) {
    tmpc::merit_warp<M, real>(lanes, o, Pc, xc, zc, T, w.red, w.R, &best,
                              &cost, &eq);
    lanes.run([&](int l) {
      for (int f = l; f < nzT; f += WIDTH) zbest[f] = z[f];
    });
  }
  S1_LAP(SEC_MERIT);
  for (int ph = 0; ph < n_phases; ++ph) {
    const int n_sqp = phases[2 * ph], n_qp = phases[2 * ph + 1];
    for (int it = 0; it < n_sqp; ++it) {
      if (B.chain())
        tmpc::linearize_warp<M, real>(lanes, o, Pc, xc, zc,
                                      Col<real>{qp, 1, 0}, L, reg);
      S1_LAP(SEC_LIN);
      if (reg == REG_MIRROR && B.chain())
        mirror_pass<NX, NU>(lanes, qp + L.H, T, reg_eps, mem + F.ip);
      B.sync();
      S1_LAP(SEC_MIRROR);
      solve_qp_problem<real, NX, NU>(B, q, rw, F.sz, st, n_qp, prm, &qp_comp,
                                     &qp_eq);
      S1_SKIP();
      // A NaN step (failed QP) keeps the previous iterate.
      B.run([&](int i) {
        real bad = real(0);
        for (int f = i; f < nzT; f += NT) {
          const real v = z[f] + st.bz[f];
          if (v != v) bad = real(1);
        }
        fold_max(i, st.part, PK_STEP, bad);
      });
      if (!(slots_max(st.part, PK_STEP, 0, B.W) > real(0)))
        B.run([&](int i) {
          for (int f = i; f < nzT; f += NT) z[f] = z[f] + st.bz[f];
        });
      S1_LAP(SEC_STEP);
      if (track_best && B.chain()) {
        tmpc::merit_warp<M, real>(lanes, o, Pc, xc, zc, T, w.red, w.R, &mv,
                                  &cost, &eq);
        if (mv < best) {
          best = mv;
          lanes.run([&](int l) {
            for (int f = l; f < nzT; f += WIDTH) zbest[f] = z[f];
          });
        }
      }
      S1_LAP(SEC_MERIT);
      S1_COUNT(SEC_N_SQP);
    }
  }
  if (!B.chain()) return;
  const Col<const real>& fin = track_best ? zbc : zc;
  tmpc::merit_warp<M, real>(lanes, o, Pc, xc, fin, T, w.red, w.R, &mv, &cost,
                            &eq);
  S1_LAP(SEC_MERIT);
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
  S1_LAP(SEC_STEP);
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
