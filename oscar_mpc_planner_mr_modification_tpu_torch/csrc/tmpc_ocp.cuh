// The bench OCP's stage functions and their derivatives, for the fused
// whole-SQP kernel (sqp_fused.cu) and its host build (tmpc_ocp_host.cpp).
//
// Transcribes, from the package's torch modules (the JAX package's
// counterparts carry the same names):
// - models/dynamics.py: ContouringSecondOrderUnicycleModel, RK4 x 3 sub-steps;
// - ops/spline.py: sigmoid-blended cubic segments and the normalized tangent;
// - modules/contouring.py: contour and lag error, and at the terminal stage
//   the path-angle error through utils/math.py::haar_difference_without_abs
//   (fmod passes a derivative of 1);
// - modules/mpc_base.py: w_a a^2, w_w w^2 and w_v (v - v_ref)^2;
// - modules/consistency_module.py;
// - modules/guidance_constraints.py: the topology halfspaces of
//   linearized_constraints.py and the ellipsoid rows of
//   ellipsoid_constraints.py with base.py::ego_disc_position.
// and the lane linearizer of the JAX package's ops/linearize.py
// (make_lane_linearizer, make_lane_merit): stage conventions of
// solver/ocp.py (body stages at stage_idx 1, the terminal cost at
// stage_idx N-1 and u = 0), the terminal block (identity on u, H_T on x), the
// Gershgorin / Levenberg shift, and masked placeholder rows at stage N
// (generic D rows 0, e 1).
//
// A kernel has no autodiff. Every function is a template on its scalar type
// S and runs with S = real for values, S = Jet<real, 7, 0> (value and
// gradient: forward mode) for the dynamics and constraint Jacobians, and
// S = Jet<real, 7, 28> (value, gradient and packed upper-triangular Hessian:
// second-order forward mode) for the cost's gradient and Hessian. Functions
// of the spline progress s alone (the path point, its normalized tangent and
// angle) run in the one-variable Jet<real, 1, 1> and are lifted onto z by the
// chain rule.
//
// Only the model is compiled in: z = (a, w, x, y, psi, v, s). Everything else
// (parameter indices, segment, obstacle, disc and halfspace counts, the QP row
// order, bounds, dt) comes from two small tables that
// ops/sqp_fused.py::ocp_tables builds; the layout below is the contract.
//
// Field-major arrays: every per-problem array is (fields, Bt), problem b in
// column b (Col). P holds field par * T + t, Z field t * NZ + i.

#pragma once

#include <math.h>
#include <stddef.h>

// TMPC_HD: small helpers, always inlined; TMPC_FN: the stage functions;
// TMPC_ONCE: linearize() and merit(), compiled once and called, so that the
// kernels that share them do not each carry a copy.
#if defined(__CUDACC__)
#define TMPC_HD __host__ __device__ __forceinline__
#define TMPC_FN __host__ __device__
#define TMPC_ONCE __host__ __device__ __noinline__
#define TMPC_UNROLL _Pragma("unroll")
#else
#define TMPC_HD inline
#define TMPC_FN inline
#define TMPC_ONCE inline
#define TMPC_UNROLL
#endif

namespace tmpc {

constexpr int NU = 2, NX = 5, NZ = 7, NTRI = NZ * (NZ + 1) / 2;
enum { Z_A = 0, Z_W, Z_X, Z_Y, Z_PSI, Z_V, Z_S };
constexpr double PI = 3.14159265358979323846;

// ---- int table ------------------------------------------------------------
enum {
  TB_FLAGS = 0, TB_NSEG,
  TB_ACC, TB_ANGVEL, TB_VEL, TB_VREF,          // MPCBase weights
  TB_CONTOUR, TB_LAG, TB_TANGLE, TB_TCONT,     // contouring weights
  TB_CONS_W, TB_PREV_X, TB_PREV_Y,             // consistency
  TB_DISC_R,                                   // ego_disc_radius
  TB_OFF_SPLINE,  // -> n_seg x 9: x_a x_b x_c x_d y_a y_b y_c y_d start
  TB_OFF_H,       // -> nh x 9: one constraint h_i each (HK_* below)
  TB_OFF_ROWS,    // -> m x 2: QP row kind (ROW_*), h or z index
  TB_HEADER
};
enum { FL_BASE = 1, FL_CONTOUR = 2, FL_CONSIST = 4, FL_BODY_TERMINAL = 8 };
// h rows: HK_HALFSPACE a1 a2 b | HK_ELLIPSOID x y psi major minor chi r offset
enum { HK_HALFSPACE = 0, HK_ELLIPSOID = 1, H_W = 9 };
enum { ROW_HL = 0, ROW_HU, ROW_ZL, ROW_ZU };
// ---- double table: scalars, then one bound per QP row ---------------------
enum { RT_DT = 0, RT_REG_EPS, RT_LEVENBERG, RT_MERIT_W, RT_BOUNDS };
enum { REG_NONE = 0, REG_GERSHGORIN, REG_LEVENBERG };

struct Ocp {
  const int* it;
  const double* rt;
};

// ---- scalar math (float and double) -----------------------------------------
TMPC_HD float m_sin(float x) { return sinf(x); }
TMPC_HD double m_sin(double x) { return sin(x); }
TMPC_HD float m_cos(float x) { return cosf(x); }
TMPC_HD double m_cos(double x) { return cos(x); }
TMPC_HD float m_sqrt(float x) { return sqrtf(x); }
TMPC_HD double m_sqrt(double x) { return sqrt(x); }
TMPC_HD float m_exp(float x) { return expf(x); }
TMPC_HD double m_exp(double x) { return exp(x); }
TMPC_HD float m_atan2(float y, float x) { return atan2f(y, x); }
TMPC_HD double m_atan2(double y, double x) { return atan2(y, x); }
TMPC_HD float m_fmod(float x, float y) { return fmodf(x, y); }
TMPC_HD double m_fmod(double x, double y) { return fmod(x, y); }
TMPC_HD float m_abs(float x) { return fabsf(x); }
TMPC_HD double m_abs(double x) { return fabs(x); }

// NaN-propagating max / min, as torch.maximum / torch.amax.
template <typename R>
TMPC_HD R nanmax(R a, R b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
template <typename R>
TMPC_HD R nanmin(R a, R b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}
template <typename R>
TMPC_HD bool finite(R x) {
  return (x - x) == R(0);
}

// ---- forward-mode jets ----------------------------------------------------
// Value v, gradient g over N seeds, and (NH = N (N + 1) / 2) the Hessian's
// upper triangle, row-major: h[k] for (i, j), i <= j, k counting up.
template <typename R, int N, int NH>
struct Jet {
  using real = R;
  R v;
  R g[N];
  R h[NH > 0 ? NH : 1];
};

template <typename S>
struct Real {
  using type = S;
};
template <typename R, int N, int NH>
struct Real<Jet<R, N, NH>> {
  using type = R;
};

#define TMPC_JET template <typename R, int N, int NH>
#define TMPC_J Jet<R, N, NH>
#define TMPC_S typename TMPC_J::real  // a plain real (not deduced)

TMPC_JET TMPC_HD TMPC_J jet_const(TMPC_S c) {
  TMPC_J r;
  r.v = c;
  TMPC_UNROLL for (int i = 0; i < N; ++i) r.g[i] = R(0);
  TMPC_UNROLL for (int k = 0; k < NH; ++k) r.h[k] = R(0);
  return r;
}
TMPC_JET TMPC_HD TMPC_J jet_seed(TMPC_S x, int i) {
  TMPC_J r = jet_const<R, N, NH>(x);
  r.g[i] = R(1);
  return r;
}

// A constant of scalar type S (a jet with zero derivatives).
template <typename S>
struct Make {
  static TMPC_HD S constant(S c) { return c; }
};
template <typename R, int N, int NH>
struct Make<Jet<R, N, NH>> {
  static TMPC_HD Jet<R, N, NH> constant(R c) { return jet_const<R, N, NH>(c); }
};

TMPC_HD float value(float x) { return x; }
TMPC_HD double value(double x) { return x; }
TMPC_JET TMPC_HD R value(const TMPC_J& x) { return x.v; }

// f(a) from f, f' and f'' at a.v (the chain rule).
TMPC_JET TMPC_HD TMPC_J lift(const TMPC_J& a, R f, R f1, R f2) {
  TMPC_J r;
  r.v = f;
  TMPC_UNROLL for (int i = 0; i < N; ++i) r.g[i] = f1 * a.g[i];
  if constexpr (NH > 0) {
    int k = 0;
    TMPC_UNROLL for (int i = 0; i < N; ++i)
      TMPC_UNROLL for (int j = i; j < N; ++j, ++k)
        r.h[k] = f1 * a.h[k] + f2 * a.g[i] * a.g[j];
  }
  return r;
}

TMPC_JET TMPC_HD TMPC_J operator+(const TMPC_J& a, const TMPC_J& b) {
  TMPC_J r;
  r.v = a.v + b.v;
  TMPC_UNROLL for (int i = 0; i < N; ++i) r.g[i] = a.g[i] + b.g[i];
  TMPC_UNROLL for (int k = 0; k < NH; ++k) r.h[k] = a.h[k] + b.h[k];
  return r;
}
TMPC_JET TMPC_HD TMPC_J operator-(const TMPC_J& a, const TMPC_J& b) {
  TMPC_J r;
  r.v = a.v - b.v;
  TMPC_UNROLL for (int i = 0; i < N; ++i) r.g[i] = a.g[i] - b.g[i];
  TMPC_UNROLL for (int k = 0; k < NH; ++k) r.h[k] = a.h[k] - b.h[k];
  return r;
}
TMPC_JET TMPC_HD TMPC_J operator-(const TMPC_J& a) {
  TMPC_J r;
  r.v = -a.v;
  TMPC_UNROLL for (int i = 0; i < N; ++i) r.g[i] = -a.g[i];
  TMPC_UNROLL for (int k = 0; k < NH; ++k) r.h[k] = -a.h[k];
  return r;
}
TMPC_JET TMPC_HD TMPC_J operator+(const TMPC_J& a, TMPC_S c) {
  TMPC_J r = a;
  r.v = a.v + c;
  return r;
}
TMPC_JET TMPC_HD TMPC_J operator-(const TMPC_J& a, TMPC_S c) {
  TMPC_J r = a;
  r.v = a.v - c;
  return r;
}
TMPC_JET TMPC_HD TMPC_J operator-(TMPC_S c, const TMPC_J& a) {
  TMPC_J r = -a;
  r.v = c - a.v;
  return r;
}
TMPC_JET TMPC_HD TMPC_J operator*(const TMPC_J& a, TMPC_S c) {
  TMPC_J r;
  r.v = a.v * c;
  TMPC_UNROLL for (int i = 0; i < N; ++i) r.g[i] = a.g[i] * c;
  TMPC_UNROLL for (int k = 0; k < NH; ++k) r.h[k] = a.h[k] * c;
  return r;
}
TMPC_JET TMPC_HD TMPC_J operator*(TMPC_S c, const TMPC_J& a) { return a * c; }
TMPC_JET TMPC_HD TMPC_J operator/(const TMPC_J& a, TMPC_S c) {
  TMPC_J r;
  r.v = a.v / c;
  TMPC_UNROLL for (int i = 0; i < N; ++i) r.g[i] = a.g[i] / c;
  TMPC_UNROLL for (int k = 0; k < NH; ++k) r.h[k] = a.h[k] / c;
  return r;
}
TMPC_JET TMPC_HD TMPC_J operator*(const TMPC_J& a, const TMPC_J& b) {
  TMPC_J r;
  r.v = a.v * b.v;
  TMPC_UNROLL for (int i = 0; i < N; ++i) r.g[i] = a.v * b.g[i] + b.v * a.g[i];
  if constexpr (NH > 0) {
    int k = 0;
    TMPC_UNROLL for (int i = 0; i < N; ++i)
      TMPC_UNROLL for (int j = i; j < N; ++j, ++k)
        r.h[k] = (a.v * b.h[k] + b.v * a.h[k]) +
                 (a.g[i] * b.g[j] + a.g[j] * b.g[i]);
  }
  return r;
}
TMPC_JET TMPC_HD TMPC_J recip(const TMPC_J& a) {
  const R f = R(1) / a.v;
  return lift(a, f, -f * f, R(2) * f * f * f);
}
TMPC_JET TMPC_HD TMPC_J operator/(const TMPC_J& a, const TMPC_J& b) {
  return a * recip(b);
}

TMPC_HD float tsin(float x) { return m_sin(x); }
TMPC_HD double tsin(double x) { return m_sin(x); }
TMPC_JET TMPC_HD TMPC_J tsin(const TMPC_J& a) {
  const R s = m_sin(a.v);
  return lift(a, s, m_cos(a.v), -s);
}
TMPC_HD float tcos(float x) { return m_cos(x); }
TMPC_HD double tcos(double x) { return m_cos(x); }
TMPC_JET TMPC_HD TMPC_J tcos(const TMPC_J& a) {
  const R c = m_cos(a.v);
  return lift(a, c, -m_sin(a.v), -c);
}
TMPC_JET TMPC_HD TMPC_J tsqrt(const TMPC_J& a) {
  const R f = m_sqrt(a.v);
  return lift(a, f, R(0.5) / f, R(-0.25) / (a.v * f));
}
// torch.sigmoid: 1 / (1 + exp(-x)).
TMPC_JET TMPC_HD TMPC_J tsigmoid(const TMPC_J& a) {
  const R s = R(1) / (R(1) + m_exp(-a.v));
  const R d = s * (R(1) - s);
  return lift(a, s, d, d * (R(1) - R(2) * s));
}
// atan2(y, x) with the chain rule over both arguments.
TMPC_JET TMPC_HD TMPC_J tatan2(const TMPC_J& y, const TMPC_J& x) {
  TMPC_J r;
  const R r2 = x.v * x.v + y.v * y.v;
  const R fy = x.v / r2, fx = -y.v / r2;
  const R r4 = r2 * r2;
  const R fyy = R(-2) * x.v * y.v / r4, fxx = R(2) * x.v * y.v / r4;
  const R fxy = (y.v * y.v - x.v * x.v) / r4;
  r.v = m_atan2(y.v, x.v);
  TMPC_UNROLL for (int i = 0; i < N; ++i) r.g[i] = fy * y.g[i] + fx * x.g[i];
  if constexpr (NH > 0) {
    int k = 0;
    TMPC_UNROLL for (int i = 0; i < N; ++i)
      TMPC_UNROLL for (int j = i; j < N; ++j, ++k)
        r.h[k] = (fy * y.h[k] + fx * x.h[k]) +
                 (fyy * y.g[i] * y.g[j] + fxx * x.g[i] * x.g[j]) +
                 fxy * (y.g[i] * x.g[j] + x.g[i] * y.g[j]);
  }
  return r;
}

// haar_difference_without_abs(d) = fmod(d + pi, 2 pi) - pi in the working
// precision; fmod's derivative is 1.
TMPC_HD float haar(float d) {
  const float pi = float(PI);
  return m_fmod(d + pi, 2.0f * pi) - pi;
}
TMPC_HD double haar(double d) { return m_fmod(d + PI, 2.0 * PI) - PI; }
TMPC_JET TMPC_HD TMPC_J haar(const TMPC_J& d) {
  TMPC_J r = d;
  r.v = haar(d.v);
  return r;
}

// A function of s, given as the one-variable jet (f, f', f''), at the s of z.
template <typename R>
TMPC_HD R lift_s(const Jet<R, 1, 1>& f, R) {
  return f.v;
}
TMPC_JET TMPC_HD TMPC_J lift_s(const Jet<R, 1, 1>& f, const TMPC_J& s) {
  return lift(s, f.v, f.g[0], f.h[0]);
}

// ---- field-major columns ----------------------------------------------------
template <typename T>
struct Col {
  T* p;
  size_t Bt;
  int b;
  TMPC_HD T& operator[](int f) const { return p[(size_t)f * Bt + b]; }
};

// One stage's parameters: p[idx] is field idx * T + t of P.
template <typename R>
struct Par {
  const R* p;
  size_t stride;
  TMPC_HD R operator[](int idx) const { return p[(size_t)idx * stride]; }
};
template <typename R>
TMPC_HD Par<R> stage_params(const Col<const R>& P, int t, int T) {
  return Par<R>{P.p + (size_t)t * P.Bt + P.b, (size_t)T * P.Bt};
}

// ---- spline path (ops/spline.py, contouring.py) ---------------------------
// Segment i at s: value and first derivative of x(s) and y(s).
template <typename R>
TMPC_HD void spline_segment(const int* q, const Par<R>& p,
                            const Jet<R, 1, 1>& s, Jet<R, 1, 1>* v) {
  const Jet<R, 1, 1> ds = s - p[q[8]];
  v[0] = ((p[q[0]] * ds + p[q[1]]) * ds + p[q[2]]) * ds + p[q[3]];
  v[1] = ((p[q[4]] * ds + p[q[5]]) * ds + p[q[6]]) * ds + p[q[7]];
  v[2] = (R(3) * p[q[0]] * ds + R(2) * p[q[1]]) * ds + p[q[2]];
  v[3] = (R(3) * p[q[4]] * ds + R(2) * p[q[5]]) * ds + p[q[6]];
}

// The path point, normalized tangent and (when `angle`) tangent angle at s,
// as jets in s: out = (x, y, dx_n, dy_n, angle).
template <typename R>
TMPC_FN void path_at(const Ocp& o, const Par<R>& p, R s_val, bool angle,
                     Jet<R, 1, 1>* out) {
  using J1 = Jet<R, 1, 1>;
  const J1 s = jet_seed<R, 1, 1>(s_val, 0);
  const int M = o.it[TB_NSEG];
  const int* sp = o.it + o.it[TB_OFF_SPLINE];
  // Blend back to front: out = lam_k v_{k-1} + (1 - lam_k) out, with
  // lam_k = sigmoid(-(s - start_k + 0.02) / 0.1).
  J1 acc[4], v[4];
  spline_segment(sp + 9 * (M - 1), p, s, acc);
  for (int k = M - 1; k >= 1; --k) {
    spline_segment(sp + 9 * (k - 1), p, s, v);
    const J1 lam = tsigmoid(-((s - p[sp[9 * k + 8]]) + R(0.02)) / R(0.1));
    const J1 rest = R(1) - lam;
    TMPC_UNROLL for (int q = 0; q < 4; ++q) acc[q] = lam * v[q] + rest * acc[q];
  }
  const J1 norm = tsqrt(acc[2] * acc[2] + acc[3] * acc[3]);
  out[0] = acc[0];
  out[1] = acc[1];
  out[2] = acc[2] / norm;
  out[3] = acc[3] / norm;
  if (angle) out[4] = tatan2(out[3], out[2]);
}

// ---- objective (modules' get_value, summed as ModuleManager.objective) ----
template <typename S, typename R>
TMPC_FN S stage_cost(const Ocp& o, const Par<R>& p, const S* z, bool terminal) {
  const int* it = o.it;
  const int flags = it[TB_FLAGS];
  S cost = Make<S>::constant(R(0));
  if (flags & FL_BASE) {
    const S dv = z[Z_V] - p[it[TB_VREF]];
    cost = cost + p[it[TB_ACC]] * (z[Z_A] * z[Z_A]);
    cost = cost + p[it[TB_ANGVEL]] * (z[Z_W] * z[Z_W]);
    cost = cost + p[it[TB_VEL]] * (dv * dv);
  }
  if (flags & FL_CONTOUR) {
    Jet<R, 1, 1> q[5];
    path_at(o, p, value(z[Z_S]), terminal, q);
    const S ex = z[Z_X] - lift_s(q[0], z[Z_S]);
    const S ey = z[Z_Y] - lift_s(q[1], z[Z_S]);
    const S dxn = lift_s(q[2], z[Z_S]), dyn = lift_s(q[3], z[Z_S]);
    const S contour = dyn * ex - dxn * ey;
    const S lag = dxn * ex + dyn * ey;
    const R cw = p[it[TB_CONTOUR]], lw = p[it[TB_LAG]];
    const S lag2 = lag * lag, contour2 = contour * contour;
    S c = lw * lag2;
    c = c + cw * contour2;
    if (terminal) {
      const R tc = p[it[TB_TCONT]];
      const S err = haar(z[Z_PSI] - lift_s(q[4], z[Z_S]));
      c = c + p[it[TB_TANGLE]] * (err * err);
      c = c + (tc * lw) * lag2;
      c = c + (tc * cw) * contour2;
    }
    cost = cost + c;
  }
  if (flags & FL_CONSIST) {
    const S ex = z[Z_X] - p[it[TB_PREV_X]];
    const S ey = z[Z_Y] - p[it[TB_PREV_Y]];
    cost = cost + p[it[TB_CONS_W]] * (ex * ex + ey * ey);
  }
  return cost;
}

// ---- dynamics: continuous unicycle, RK4 x 3 over dt ----------------------
template <typename S>
TMPC_FN void continuous(const S* x, const S* u, S* dx) {
  dx[0] = x[3] * tcos(x[2]);
  dx[1] = x[3] * tsin(x[2]);
  dx[2] = u[1];
  dx[3] = u[0];
  dx[4] = x[3];
}

template <typename S>
TMPC_FN void rk4(const S* x, const S* u, double dt, S* out) {
  using R = typename Real<S>::type;
  const double h = dt / 3.0;
  const R half_h = R(0.5 * h), full_h = R(h), sixth_h = R(h / 6.0);
  S xi[NX], k1[NX], k2[NX], k3[NX], k4[NX], tmp[NX];
  TMPC_UNROLL for (int i = 0; i < NX; ++i) xi[i] = x[i];
  for (int step = 0; step < 3; ++step) {
    continuous(xi, u, k1);
    TMPC_UNROLL for (int i = 0; i < NX; ++i) tmp[i] = xi[i] + half_h * k1[i];
    continuous(tmp, u, k2);
    TMPC_UNROLL for (int i = 0; i < NX; ++i) tmp[i] = xi[i] + half_h * k2[i];
    continuous(tmp, u, k3);
    TMPC_UNROLL for (int i = 0; i < NX; ++i) tmp[i] = xi[i] + full_h * k3[i];
    continuous(tmp, u, k4);
    TMPC_UNROLL for (int i = 0; i < NX; ++i)
      xi[i] = xi[i] +
              sixth_h * (((k1[i] + R(2) * k2[i]) + R(2) * k3[i]) + k4[i]);
  }
  TMPC_UNROLL for (int i = 0; i < NX; ++i) out[i] = xi[i];
}

// ---- constraints: h_i(z) ----------------------------------------------------
template <typename S, typename R>
TMPC_FN S h_row(const Ocp& o, const Par<R>& p, const S* z, int i) {
  const int* q = o.it + o.it[TB_OFF_H] + H_W * i;
  if (q[0] == HK_HALFSPACE)
    return (p[q[1]] * z[Z_X] + p[q[2]] * z[Z_Y]) - p[q[3]];
  // Ellipsoid: (p - c)^T R^T diag(a11, a22) R (p - c), semi-axes inflated by
  // sqrt(chi) plus the disc and obstacle radii.
  const R root_chi = m_sqrt(p[q[6]]);
  const R r_sum = p[o.it[TB_DISC_R]];
  const R t1 = (p[q[4]] * root_chi + r_sum) + p[q[7]];
  const R t2 = (p[q[5]] * root_chi + r_sum) + p[q[7]];
  const R a11 = R(1) / (t1 * t1), a22 = R(1) / (t2 * t2);
  const R c = m_cos(p[q[3]]), s = m_sin(p[q[3]]);
  const R e11 = a11 * c * c + a22 * s * s;
  const R e22 = a11 * s * s + a22 * c * c;
  const R e12 = (a22 - a11) * c * s;
  const R offset = p[q[8]];
  const S dx = (z[Z_X] + tcos(z[Z_PSI]) * offset) - p[q[1]];
  const S dy = (z[Z_Y] + tsin(z[Z_PSI]) * offset) - p[q[2]];
  return ((e11 * dx) * dx + ((R(2) * e12) * dx) * dy) + (e22 * dy) * dy;
}

// ---- the QP fields ----------------------------------------------------------
// Field offsets of one problem's QP, in the (fields, Bt) layout of the IP
// solve (qp_ip.cuh): H upper triangle (T, NTRI), g (T, NZ), A (T-1, NX, NX),
// B (T-1, NX, NU), c (T-1, NX), generic D rows (T, max(mh, 1), NZ), e (T, m),
// r0 (NX).
struct QpLayout {
  int T, m, mh, mhp, H, g, A, B, c, D, e, r0, total;
  TMPC_HD QpLayout(int T_, int m_, int mh_) : T(T_), m(m_), mh(mh_) {
    mhp = mh > 0 ? mh : 1;
    int o = 0;
    H = o; o += T * NTRI;
    g = o; o += T * NZ;
    A = o; o += (T - 1) * NX * NX;
    B = o; o += (T - 1) * NX * NU;
    c = o; o += (T - 1) * NX;
    D = o; o += T * mhp * NZ;
    e = o; o += T * m;
    r0 = o; o += NX;
    total = o;
  }
  // The offsets as 9 ints: H g A B c D e r0 total.
  TMPC_HD void offsets(int* out) const {
    const int v[9] = {H, g, A, B, c, D, e, r0, total};
    for (int i = 0; i < 9; ++i) out[i] = v[i];
  }
};

// Regularize the symmetric (NZ, NZ) block and store its upper triangle.
template <typename R>
TMPC_FN void store_hessian(R* Hs, int reg, double reg_eps, double levenberg,
                           const Col<R>& qp, int f0) {
  if (reg == REG_GERSHGORIN) {
    R bound = R(0);
    TMPC_UNROLL for (int i = 0; i < NZ; ++i) {
      R row = R(0);
      TMPC_UNROLL for (int q = 0; q < NZ; ++q) row = row + m_abs(Hs[i * NZ + q]);
      const R d = Hs[i * NZ + i];
      const R lo = d - (row - m_abs(d));
      bound = i == 0 ? lo : nanmin(bound, lo);
    }
    const R shift = nanmax(R(reg_eps) - bound, R(0));
    TMPC_UNROLL for (int i = 0; i < NZ; ++i) Hs[i * NZ + i] = Hs[i * NZ + i] + shift;
  } else if (reg == REG_LEVENBERG) {
    TMPC_UNROLL for (int i = 0; i < NZ; ++i)
      Hs[i * NZ + i] = Hs[i * NZ + i] + R(levenberg);
  }
  int k = 0;
  TMPC_UNROLL for (int i = 0; i < NZ; ++i)
    TMPC_UNROLL for (int j = i; j < NZ; ++j, ++k) qp[f0 + k] = Hs[i * NZ + j];
}

// Linearize problem b at its iterate Z: every field of QpLayout.
template <typename R>
TMPC_ONCE void linearize(const Ocp& o, const Col<const R>& P,
                       const Col<const R>& x0, const Col<const R>& Z,
                       const Col<R>& qp, const QpLayout& L, int reg) {
  using J2 = Jet<R, NZ, NTRI>;
  using J1 = Jet<R, NZ, 0>;
  const int T = L.T, N = T - 1, m = L.m;
  const double reg_eps = o.rt[RT_REG_EPS], lev = o.rt[RT_LEVENBERG];
  const double dt = o.rt[RT_DT];
  const bool body_terminal = (o.it[TB_FLAGS] & FL_BODY_TERMINAL) != 0;
  const int* rows = o.it + o.it[TB_OFF_ROWS];
  for (int t = 0; t < T; ++t) {
    const Par<R> p = stage_params(P, t, T);
    R z[NZ];
    TMPC_UNROLL for (int i = 0; i < NZ; ++i)
      z[i] = (t == N && i < NU) ? R(0) : Z[t * NZ + i];

    // Cost gradient and Hessian. Stage N: terminal cost at u = 0; its block
    // is the identity on u and the cost's x block on x.
    {
      J2 zj[NZ];
      TMPC_UNROLL for (int i = 0; i < NZ; ++i) zj[i] = jet_seed<R, NZ, NTRI>(z[i], i);
      const J2 cost = stage_cost(o, p, zj, t < N ? body_terminal : true);
      R Hs[NZ * NZ];
      int k = 0;
      TMPC_UNROLL for (int i = 0; i < NZ; ++i)
        TMPC_UNROLL for (int j = i; j < NZ; ++j, ++k) {
          Hs[i * NZ + j] = cost.h[k];
          Hs[j * NZ + i] = cost.h[k];
        }
      if (t == N) {
        TMPC_UNROLL for (int i = 0; i < NU; ++i)
          TMPC_UNROLL for (int j = 0; j < NZ; ++j) {
            const R v = (i == j) ? R(1) : R(0);
            Hs[i * NZ + j] = v;
            Hs[j * NZ + i] = v;
          }
      }
      TMPC_UNROLL for (int i = 0; i < NZ; ++i)
        qp[L.g + t * NZ + i] = (t == N && i < NU) ? R(0) : cost.g[i];
      store_hessian(Hs, reg, reg_eps, lev, qp, L.H + t * NTRI);
    }

    if (t == N) {
      // Stage N: masked placeholder rows.
      for (int f = 0; f < L.mhp * NZ; ++f) qp[L.D + t * L.mhp * NZ + f] = R(0);
      for (int r = 0; r < m; ++r) qp[L.e + t * m + r] = R(1);
      continue;
    }

    J1 zd[NZ];
    TMPC_UNROLL for (int i = 0; i < NZ; ++i) zd[i] = jet_seed<R, NZ, 0>(z[i], i);

    // Dynamics: A = dF/dx, B = dF/du, c = F(z_t) - x_{t+1}.
    {
      J1 F[NX];
      rk4(zd + NU, zd, dt, F);
      TMPC_UNROLL for (int i = 0; i < NX; ++i) {
        TMPC_UNROLL for (int j = 0; j < NX; ++j)
          qp[L.A + (t * NX + i) * NX + j] = F[i].g[NU + j];
        TMPC_UNROLL for (int j = 0; j < NU; ++j)
          qp[L.B + (t * NX + i) * NU + j] = F[i].g[j];
        qp[L.c + t * NX + i] = F[i].v - Z[(t + 1) * NZ + NU + i];
      }
    }

    // Inequality rows D z + e >= 0 in the OCP's row order.
    int slot = 0;
    for (int r = 0; r < m; ++r) {
      const int kind = rows[2 * r], idx = rows[2 * r + 1];
      const R bound = R(o.rt[RT_BOUNDS + r]);
      R e;
      if (kind == ROW_HL || kind == ROW_HU) {
        const J1 h = h_row(o, p, zd, idx);
        const int d0 = L.D + (t * L.mhp + slot) * NZ;
        TMPC_UNROLL for (int j = 0; j < NZ; ++j) qp[d0 + j] = kind == ROW_HL ? h.g[j] : -h.g[j];
        e = kind == ROW_HL ? h.v - bound : bound - h.v;
        ++slot;
      } else {
        e = kind == ROW_ZL ? z[idx] - bound : bound - z[idx];
      }
      qp[L.e + t * m + r] = e;
    }
    if (slot == 0) {
      for (int j = 0; j < NZ; ++j) qp[L.D + t * L.mhp * NZ + j] = R(0);
    }
  }
  TMPC_UNROLL for (int i = 0; i < NX; ++i) qp[L.r0 + i] = x0[i] - Z[NU + i];
}

// make_lane_merit: merit = cost + w eq_res (inf unless cost and Z are
// finite); eq_res = max(|F(z_t) - x_{t+1}|, |x0 - x_0|).
template <typename R>
TMPC_ONCE void merit(const Ocp& o, const Col<const R>& P, const Col<const R>& x0,
                   const Col<const R>& Z, int T, R* merit_out, R* cost_out,
                   R* eq_out) {
  const int N = T - 1;
  const double dt = o.rt[RT_DT];
  const bool body_terminal = (o.it[TB_FLAGS] & FL_BODY_TERMINAL) != 0;
  R eq_dyn = R(0), eq_init = R(0), cost = R(0);
  bool z_finite = true;
  for (int t = 0; t < T; ++t) {
    const Par<R> p = stage_params(P, t, T);
    R z[NZ];
    TMPC_UNROLL for (int i = 0; i < NZ; ++i) {
      z[i] = Z[t * NZ + i];
      z_finite = z_finite && finite(z[i]);
    }
    if (t == N) {
      z[Z_A] = R(0);
      z[Z_W] = R(0);
      cost = cost + stage_cost(o, p, z, true);
      break;
    }
    R F[NX];
    rk4(z + NU, z, dt, F);
    TMPC_UNROLL for (int i = 0; i < NX; ++i)
      eq_dyn = nanmax(eq_dyn, m_abs(F[i] - Z[(t + 1) * NZ + NU + i]));
    cost = cost + stage_cost(o, p, z, body_terminal);
  }
  TMPC_UNROLL for (int i = 0; i < NX; ++i)
    eq_init = nanmax(eq_init, m_abs(x0[i] - Z[NU + i]));
  const R eq = nanmax(eq_dyn, eq_init);
  const bool ok = finite(cost) && z_finite;
  *merit_out = ok ? cost + R(o.rt[RT_MERIT_W]) * eq : R(INFINITY);
  *cost_out = cost;
  *eq_out = eq;
}

#undef TMPC_JET
#undef TMPC_J
#undef TMPC_S

}  // namespace tmpc
