// The stage functions and their derivatives of the OCPs that the fused
// whole-SQP kernel (sqp_fused.cu) and its host build (tmpc_ocp_host.cpp)
// cover.
//
// Transcribes, from the package's torch modules (the JAX package's
// counterparts carry the same names):
// - models/dynamics.py: ContouringSecondOrderUnicycleModel,
//   SecondOrderUnicycleModel, ContouringSecondOrderUnicycleModelWithSlack,
//   BicycleModel2ndOrder, and the curvature-aware
//   ContouringSecondOrderUnicycleModelCurvatureAware and
//   BicycleModel2ndOrderCurvatureAware, RK4 x 3 sub-steps (on the first
//   nx_integrate states, then the curvature-aware progress update
//   _ca_spline_update, its curvature floored on the squared curvature);
// - ops/spline.py: sigmoid-blended cubic segments, the normalized tangent and
//   the blended second derivative;
// - modules/curvature_aware_contouring.py: the squared distance to the path
//   and the projected progress rate against the reference velocity
//   (FL_CA_CONTOUR);
// - modules/contouring_constraints.py: the two road-width rows on the width
//   splines (HK_ROADWIDTH);
// - modules/decomp_constraints.py: the free-space halfspaces, softened by
//   the model's slack where it has one (HK_DECOMP);
// - modules/contouring.py: contour and lag error, with
//   dynamic_velocity_reference w_v (v - v_ref(s))^2 on the velocity spline of
//   modules/path_reference_velocity.py (FL_VSPLINE), and at the terminal
//   stage the path-angle error through
//   utils/math.py::haar_difference_without_abs (fmod passes a derivative of
//   1);
// - modules/mpc_base.py: w_a a^2, w_w w^2 and (where weighed) w_s slack^2 and
//   w_v (v - v_ref)^2, in that order;
// - modules/consistency_module.py;
// - modules/goal_module.py: w_g |p - g|^2 / (|g|^2 + 0.01);
// - modules/guidance_constraints.py: the topology halfspaces of
//   linearized_constraints.py and the ellipsoid rows of
//   ellipsoid_constraints.py with base.py::ego_disc_position, any number of
//   prediction modes;
// - modules/gaussian_constraints.py: the CC-MPC chance constraint, its
//   inverse error function by utils/math.py::erfinv_newton (a rational guess
//   and two Newton steps on the native erf, in the working precision, not on
//   jets: it depends on parameters only);
// - modules/scenario_constraints.py: the SH-MPC halfspaces softened by the
//   slack state.
// and the lane linearizer of the JAX package's ops/linearize.py
// (make_lane_linearizer, make_lane_merit): stage conventions of
// solver/ocp.py (body stages at stage_idx 1, the terminal cost at
// stage_idx N-1 and u = 0), the terminal block (identity on u, H_T on x), the
// Gershgorin / Levenberg shift or (the MIRROR variant) the "mirror" of
// mirror.cuh, and masked placeholder rows at stage N (generic D rows 0,
// e 1).
//
// A kernel has no autodiff. Every function is a template on its scalar type
// S and runs with S = real for values, S = Jet<real, NZ, 0> (value and
// gradient: forward mode) for the dynamics and constraint Jacobians, and
// S = Jet<real, NZ, NZ (NZ + 1) / 2> (value, gradient and packed
// upper-triangular Hessian: second-order forward mode) for the cost's
// gradient and Hessian. Functions
// of the spline progress s alone (the path point, its normalized tangent and
// angle) run in the one-variable Jet<real, 1, 1> and are lifted onto z by the
// chain rule.
//
// Only the model is compiled in, as a template parameter M (a struct below:
// its sizes, the z index of each named variable, -1 where it has none, and
// its vector field); with_model() is the one switch from the model id of the
// int table (TB_MODEL) to the type. Everything else (parameter indices,
// segment, obstacle, disc and halfspace counts, the QP row order, bounds, dt)
// comes from two small tables that ops/sqp_fused.py::ocp_tables builds; the
// layout below is the contract.
//
// Field-major arrays: every per-problem array is (fields, Bt), problem b in
// column b (Col). P holds field par * T + t, Z field t * NZ + i.

#pragma once

#include "mirror.cuh"
#include "warp.cuh"

#include <math.h>
#include <stddef.h>

// TMPC_HD: small helpers, always inlined; TMPC_FN: the stage functions;
// TMPC_ONCE: linearize_stage() and merit_stage(), compiled once and called,
// so that the kernels that share them do not each carry a copy; TMPC_WARP:
// the lane-group forms (warp.cuh), device code on the card.
#if defined(__CUDACC__)
#define TMPC_HD __host__ __device__ __forceinline__
#define TMPC_FN __host__ __device__
#define TMPC_ONCE __host__ __device__ __noinline__
#define TMPC_WARP __device__
#define TMPC_UNROLL _Pragma("unroll")
#else
#define TMPC_HD inline
#define TMPC_FN inline
#define TMPC_ONCE inline
#define TMPC_WARP inline
#define TMPC_UNROLL
#endif

namespace tmpc {

// ---- section counters of the mirror linearize entry (tools/lin_sections.py)
// Built with -DLIN_SECTIONS, sqp_linearize_mirror.cu adds the clock64()
// cycles that thread 0 of block 0 (problem 0's stage 0, lane 0 of its
// group) spends in each section into a shared array, which the kernel adds
// to lin_sections at its end (sqp_linearize_mirror_sections reads it).
// Without the switch the macros are empty: the default build is the same
// kernel, and the other kernels and the host builds never see them.
enum {
  LIN_SEC_COST = 0,  // the cost's gradient and Hessian jets
  LIN_SEC_DYN,       // the dynamics jets (A, B, c)
  LIN_SEC_ROWS,      // the inequality rows (D, e)
  LIN_SEC_JACOBI,    // the Jacobi of the stage's Hessian block
  LIN_SEC_STORE,     // V max(|w|, eps) V^T and the packed store
  LIN_SEC_MERIT,     // the merit terms
  LIN_SEC_TOTAL,     // the whole problem
  LIN_SEC_N,         // launches counted
  LIN_SEC_COUNT
};

#if defined(LIN_SECTIONS) && defined(__CUDACC__)
__device__ unsigned long long lin_sections[LIN_SEC_COUNT];
__shared__ unsigned long long lin_sec_sm[LIN_SEC_COUNT];
// The clock and the counters of thread 0 of block 0; the laps sit in
// __host__ __device__ functions, whose host side counts nothing.
__host__ __device__ __forceinline__ long long lin_clock() {
#if defined(__CUDA_ARCH__)
  return clock64();
#else
  return 0;
#endif
}
__host__ __device__ __forceinline__ void lin_add(int k, long long cycles) {
#if defined(__CUDA_ARCH__)
  if (blockIdx.x == 0 && threadIdx.x == 0) lin_sec_sm[k] += cycles;
#endif
}
__device__ __forceinline__ void lin_init() {
  if (blockIdx.x == 0 && threadIdx.x == 0)
    for (int k = 0; k < LIN_SEC_COUNT; ++k) lin_sec_sm[k] = 0;
}
__device__ __forceinline__ void lin_flush() {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    lin_sec_sm[LIN_SEC_N] += 1;
    for (int k = 0; k < LIN_SEC_COUNT; ++k) lin_sections[k] += lin_sec_sm[k];
  }
}
#define LIN_CLOCK long long lin_t = ::tmpc::lin_clock()
#define LIN_LAP(k)                                  \
  do {                                              \
    const long long lin_n = ::tmpc::lin_clock();    \
    ::tmpc::lin_add(k, lin_n - lin_t);              \
    lin_t = ::tmpc::lin_clock();                    \
  } while (0)
#define LIN_SKIP() (lin_t = ::tmpc::lin_clock())
#define LIN_INIT() ::tmpc::lin_init()
#define LIN_FLUSH() ::tmpc::lin_flush()
#else
#define LIN_CLOCK
#define LIN_LAP(k) \
  do {             \
  } while (0)
#define LIN_SKIP() \
  do {             \
  } while (0)
#define LIN_INIT() \
  do {             \
  } while (0)
#define LIN_FLUSH() \
  do {              \
  } while (0)
#endif

constexpr double PI = 3.14159265358979323846;

// ---- int table ------------------------------------------------------------
enum {
  TB_FLAGS = 0, TB_NSEG,
  TB_ACC, TB_ANGVEL, TB_VEL, TB_VREF,          // MPCBase weights
  TB_CONTOUR, TB_LAG, TB_TANGLE, TB_TCONT,     // contouring weights
  TB_CONS_W, TB_PREV_X, TB_PREV_Y,             // consistency
  TB_DISC_R,                                   // ego_disc_radius
  TB_MODEL,                                    // MODEL_* below
  TB_GOAL_W, TB_GOAL_X, TB_GOAL_Y,             // goal
  TB_SLACK,                                    // MPCBase slack weight, or -1
  TB_VREF_W,      // contouring's velocity weight (FL_VSPLINE, FL_CA_CONTOUR)
  TB_CA_VREF,     // the CA cost's constant reference velocity, or -1
  TB_OFF_SPLINE,  // -> n_seg x SP_W: x_a..x_d y_a..y_d start v_a..v_d
                  //    wl_a..wl_d wr_a..wr_d
  TB_OFF_H,       // -> nh x 9: one constraint h_i each (HK_* below)
  TB_OFF_ROWS,    // -> m x 2: QP row kind (ROW_*), h or z index; then
                  //    npar, the parameters per stage (the table's last)
  TB_HEADER
};
enum {
  FL_BASE = 1, FL_CONTOUR = 2, FL_CONSIST = 4, FL_BODY_TERMINAL = 8,
  FL_GOAL = 16, FL_VSPLINE = 32, FL_CA_CONTOUR = 64
};
// Entries per spline segment row: the path's x and y coefficients, the
// segment start, then the velocity reference's coefficients (read under
// FL_VSPLINE only) and the left and right road widths' (read by
// HK_ROADWIDTH rows only). SP_V, SP_WL, SP_WR: where each group starts.
enum { SP_V = 9, SP_WL = 13, SP_WR = 17, SP_W = 21 };
enum {
  MODEL_CONTOURING_UNICYCLE = 0, MODEL_UNICYCLE = 1,
  MODEL_CONTOURING_UNICYCLE_SLACK = 2, MODEL_BICYCLE = 3,
  MODEL_BICYCLE_CA = 4, MODEL_CONTOURING_UNICYCLE_CA = 5
};
// h rows, parameter indices after the kind:
//   HK_HALFSPACE a1 a2 b | HK_ELLIPSOID x y psi major minor chi r offset |
//   HK_GAUSSIAN x y major minor risk r offset | HK_SCENARIO a1 a2 b offset |
//   HK_ROADWIDTH side (0 right, 1 left; the widths in the spline rows) |
//   HK_DECOMP a1 a2 b offset
enum { HK_HALFSPACE = 0, HK_ELLIPSOID = 1, HK_GAUSSIAN = 2, HK_SCENARIO = 3,
       HK_ROADWIDTH = 4, HK_DECOMP = 5, H_W = 9 };
enum { ROW_HL = 0, ROW_HU, ROW_ZL, ROW_ZU };
// ---- double table: scalars, then one bound per QP row ---------------------
// RT_HALF_WIDTH: half the vehicle width of the road-width rows.
enum { RT_DT = 0, RT_REG_EPS, RT_LEVENBERG, RT_MERIT_W, RT_HALF_WIDTH,
       RT_BOUNDS };
// The squared-curvature floor of the curvature-aware progress update
// (models/dynamics.py::CURVATURE2_FLOOR).
constexpr double CURVATURE2_FLOOR = 1e-10;
// REG_MIRROR: the "mirror" regularization, which the linearization runs
// only in its MIRROR variant (linearize_stage); elsewhere the Hessian is
// stored raw and the single-instance kernel mirrors it.
enum { REG_NONE = 0, REG_GERSHGORIN, REG_LEVENBERG, REG_MIRROR };

struct Ocp {
  const int* it;
  const double* rt;
};

// The table contract as 6 ints, which ops/sqp_fused.py checks against its
// own copy when it loads a library: TB_HEADER, SP_W, H_W, FL_VSPLINE,
// FL_CA_CONTOUR, RT_BOUNDS.
inline void table_layout(int* out) {
  out[0] = TB_HEADER;
  out[1] = SP_W;
  out[2] = H_W;
  out[3] = FL_VSPLINE;
  out[4] = FL_CA_CONTOUR;
  out[5] = RT_BOUNDS;
}

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
TMPC_HD float m_log(float x) { return logf(x); }
TMPC_HD double m_log(double x) { return log(x); }
TMPC_HD float m_erf(float x) { return erff(x); }
TMPC_HD double m_erf(double x) { return erf(x); }
TMPC_HD float m_tan(float x) { return tanf(x); }
TMPC_HD double m_tan(double x) { return tan(x); }
TMPC_HD float m_atan(float x) { return atanf(x); }
TMPC_HD double m_atan(double x) { return atan(x); }

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
TMPC_HD float tsqrt(float x) { return m_sqrt(x); }
TMPC_HD double tsqrt(double x) { return m_sqrt(x); }
TMPC_JET TMPC_HD TMPC_J tsqrt(const TMPC_J& a) {
  const R f = m_sqrt(a.v);
  return lift(a, f, R(0.5) / f, R(-0.25) / (a.v * f));
}
TMPC_HD float trecip(float x) { return 1.0f / x; }
TMPC_HD double trecip(double x) { return 1.0 / x; }
TMPC_JET TMPC_HD TMPC_J trecip(const TMPC_J& a) { return recip(a); }
TMPC_HD float ttan(float x) { return m_tan(x); }
TMPC_HD double ttan(double x) { return m_tan(x); }
TMPC_JET TMPC_HD TMPC_J ttan(const TMPC_J& a) {
  const R t = m_tan(a.v);
  const R d = R(1) + t * t;
  return lift(a, t, d, R(2) * t * d);
}
TMPC_HD float tatan(float x) { return m_atan(x); }
TMPC_HD double tatan(double x) { return m_atan(x); }
TMPC_JET TMPC_HD TMPC_J tatan(const TMPC_J& a) {
  const R d = R(1) / (R(1) + a.v * a.v);
  return lift(a, m_atan(a.v), d, R(-2) * a.v * d * d);
}
// torch.sigmoid: 1 / (1 + exp(-x)).
TMPC_JET TMPC_HD TMPC_J tsigmoid(const TMPC_J& a) {
  const R s = R(1) / (R(1) + m_exp(-a.v));
  const R d = s * (R(1) - s);
  return lift(a, s, d, d * (R(1) - R(2) * s));
}
// atan2(y, x) with the chain rule over both arguments.
TMPC_HD float tatan2(float y, float x) { return m_atan2(y, x); }
TMPC_HD double tatan2(double y, double x) { return m_atan2(y, x); }
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

// ---- row jets -------------------------------------------------------------
// One row of the Hessian by second-order forward mode: value v, gradient g
// over N seeds, d the derivative along seed j (g[j], kept apart so that no
// code indexes g by a lane's j), and h[k] = d^2 f / dz_j dz_k. A group of
// lanes that each seed another j computes the whole Hessian, each lane
// 2 N + 2 reals where the triangle jet carries N (N + 3) / 2 + 1
// (mirror_block.cuh, the block design of the mirror linearize entry).
template <typename R, int N>
struct JetRow {
  using real = R;
  R v, d;
  R g[N];
  R h[N];
};
template <typename R, int N>
struct Real<JetRow<R, N>> {
  using type = R;
};

#define TMPC_RJ template <typename R, int N>
#define TMPC_W JetRow<R, N>
#define TMPC_WS typename TMPC_W::real  // a plain real (not deduced)

TMPC_RJ TMPC_HD TMPC_W row_const(TMPC_WS c) {
  TMPC_W r;
  r.v = c;
  r.d = R(0);
  TMPC_UNROLL for (int i = 0; i < N; ++i) r.g[i] = R(0);
  TMPC_UNROLL for (int k = 0; k < N; ++k) r.h[k] = R(0);
  return r;
}
// Variable i at value x, the row's seed being j.
TMPC_RJ TMPC_HD TMPC_W row_seed(TMPC_WS x, int i, int j) {
  TMPC_W r = row_const<R, N>(x);
  r.g[i] = R(1);
  r.d = i == j ? R(1) : R(0);
  return r;
}
template <typename R, int N>
struct Make<JetRow<R, N>> {
  static TMPC_HD JetRow<R, N> constant(R c) { return row_const<R, N>(c); }
};
TMPC_RJ TMPC_HD R value(const TMPC_W& x) { return x.v; }

TMPC_RJ TMPC_HD TMPC_W lift(const TMPC_W& a, R f, R f1, R f2) {
  TMPC_W r;
  r.v = f;
  r.d = f1 * a.d;
  TMPC_UNROLL for (int i = 0; i < N; ++i) r.g[i] = f1 * a.g[i];
  TMPC_UNROLL for (int k = 0; k < N; ++k)
    r.h[k] = f1 * a.h[k] + f2 * (a.d * a.g[k]);
  return r;
}
TMPC_RJ TMPC_HD TMPC_W operator+(const TMPC_W& a, const TMPC_W& b) {
  TMPC_W r;
  r.v = a.v + b.v;
  r.d = a.d + b.d;
  TMPC_UNROLL for (int i = 0; i < N; ++i) r.g[i] = a.g[i] + b.g[i];
  TMPC_UNROLL for (int k = 0; k < N; ++k) r.h[k] = a.h[k] + b.h[k];
  return r;
}
TMPC_RJ TMPC_HD TMPC_W operator-(const TMPC_W& a, const TMPC_W& b) {
  TMPC_W r;
  r.v = a.v - b.v;
  r.d = a.d - b.d;
  TMPC_UNROLL for (int i = 0; i < N; ++i) r.g[i] = a.g[i] - b.g[i];
  TMPC_UNROLL for (int k = 0; k < N; ++k) r.h[k] = a.h[k] - b.h[k];
  return r;
}
TMPC_RJ TMPC_HD TMPC_W operator-(const TMPC_W& a) {
  TMPC_W r;
  r.v = -a.v;
  r.d = -a.d;
  TMPC_UNROLL for (int i = 0; i < N; ++i) r.g[i] = -a.g[i];
  TMPC_UNROLL for (int k = 0; k < N; ++k) r.h[k] = -a.h[k];
  return r;
}
TMPC_RJ TMPC_HD TMPC_W operator+(const TMPC_W& a, TMPC_WS c) {
  TMPC_W r = a;
  r.v = a.v + c;
  return r;
}
TMPC_RJ TMPC_HD TMPC_W operator-(const TMPC_W& a, TMPC_WS c) {
  TMPC_W r = a;
  r.v = a.v - c;
  return r;
}
TMPC_RJ TMPC_HD TMPC_W operator-(TMPC_WS c, const TMPC_W& a) {
  TMPC_W r = -a;
  r.v = c - a.v;
  return r;
}
TMPC_RJ TMPC_HD TMPC_W operator*(const TMPC_W& a, TMPC_WS c) {
  TMPC_W r;
  r.v = a.v * c;
  r.d = a.d * c;
  TMPC_UNROLL for (int i = 0; i < N; ++i) r.g[i] = a.g[i] * c;
  TMPC_UNROLL for (int k = 0; k < N; ++k) r.h[k] = a.h[k] * c;
  return r;
}
TMPC_RJ TMPC_HD TMPC_W operator*(TMPC_WS c, const TMPC_W& a) { return a * c; }
TMPC_RJ TMPC_HD TMPC_W operator/(const TMPC_W& a, TMPC_WS c) {
  TMPC_W r;
  r.v = a.v / c;
  r.d = a.d / c;
  TMPC_UNROLL for (int i = 0; i < N; ++i) r.g[i] = a.g[i] / c;
  TMPC_UNROLL for (int k = 0; k < N; ++k) r.h[k] = a.h[k] / c;
  return r;
}
TMPC_RJ TMPC_HD TMPC_W operator*(const TMPC_W& a, const TMPC_W& b) {
  TMPC_W r;
  r.v = a.v * b.v;
  r.d = a.v * b.d + b.v * a.d;
  TMPC_UNROLL for (int i = 0; i < N; ++i) r.g[i] = a.v * b.g[i] + b.v * a.g[i];
  TMPC_UNROLL for (int k = 0; k < N; ++k)
    r.h[k] = (a.v * b.h[k] + b.v * a.h[k]) + (a.d * b.g[k] + a.g[k] * b.d);
  return r;
}
TMPC_RJ TMPC_HD TMPC_W recip(const TMPC_W& a) {
  const R f = R(1) / a.v;
  return lift(a, f, -f * f, R(2) * f * f * f);
}
TMPC_RJ TMPC_HD TMPC_W trecip(const TMPC_W& a) { return recip(a); }
TMPC_RJ TMPC_HD TMPC_W operator/(const TMPC_W& a, const TMPC_W& b) {
  return a * recip(b);
}
TMPC_RJ TMPC_HD TMPC_W tsin(const TMPC_W& a) {
  const R s = m_sin(a.v);
  return lift(a, s, m_cos(a.v), -s);
}
TMPC_RJ TMPC_HD TMPC_W tcos(const TMPC_W& a) {
  const R c = m_cos(a.v);
  return lift(a, c, -m_sin(a.v), -c);
}
TMPC_RJ TMPC_HD TMPC_W tsqrt(const TMPC_W& a) {
  const R f = m_sqrt(a.v);
  return lift(a, f, R(0.5) / f, R(-0.25) / (a.v * f));
}
TMPC_RJ TMPC_HD TMPC_W ttan(const TMPC_W& a) {
  const R t = m_tan(a.v);
  const R d = R(1) + t * t;
  return lift(a, t, d, R(2) * t * d);
}
TMPC_RJ TMPC_HD TMPC_W tatan(const TMPC_W& a) {
  const R d = R(1) / (R(1) + a.v * a.v);
  return lift(a, m_atan(a.v), d, R(-2) * a.v * d * d);
}
TMPC_RJ TMPC_HD TMPC_W tsigmoid(const TMPC_W& a) {
  const R s = R(1) / (R(1) + m_exp(-a.v));
  const R d = s * (R(1) - s);
  return lift(a, s, d, d * (R(1) - R(2) * s));
}
TMPC_RJ TMPC_HD TMPC_W tatan2(const TMPC_W& y, const TMPC_W& x) {
  TMPC_W r;
  const R r2 = x.v * x.v + y.v * y.v;
  const R fy = x.v / r2, fx = -y.v / r2;
  const R r4 = r2 * r2;
  const R fyy = R(-2) * x.v * y.v / r4, fxx = R(2) * x.v * y.v / r4;
  const R fxy = (y.v * y.v - x.v * x.v) / r4;
  r.v = m_atan2(y.v, x.v);
  r.d = fy * y.d + fx * x.d;
  TMPC_UNROLL for (int i = 0; i < N; ++i) r.g[i] = fy * y.g[i] + fx * x.g[i];
  TMPC_UNROLL for (int k = 0; k < N; ++k)
    r.h[k] = (fy * y.h[k] + fx * x.h[k]) +
             (fyy * (y.d * y.g[k]) + fxx * (x.d * x.g[k])) +
             fxy * (y.d * x.g[k] + x.d * y.g[k]);
  return r;
}
TMPC_RJ TMPC_HD TMPC_W haar(const TMPC_W& d) {
  TMPC_W r = d;
  r.v = haar(d.v);
  return r;
}
TMPC_RJ TMPC_HD TMPC_W lift_s(const Jet<R, 1, 1>& f, const TMPC_W& s) {
  return lift(s, f.v, f.g[0], f.h[0]);
}

#undef TMPC_RJ
#undef TMPC_W
#undef TMPC_WS

// ---- the models: sizes, named z indices, the vector field ------------------
// NXI: the states RK4 integrates (the first NXI; continuous() writes those
// and reads no other); CA: the spline state then follows the
// curvature-aware progress update (ca_update below). SL: the z index of
// slack, a state or an input, -1 where the model has none.
// z = (a, w, x, y, psi, v, s): ContouringSecondOrderUnicycleModel.
struct ContouringUnicycle {
  static constexpr int NU = 2, NX = 5, NZ = NU + NX, NTRI = NZ * (NZ + 1) / 2;
  static constexpr int A = 0, W = 1, X = 2, Y = 3, PSI = 4, V = 5, S = 6;
  static constexpr int SL = -1, NXI = NX;
  static constexpr bool CA = false;
  template <typename T>
  static TMPC_FN void continuous(const T* x, const T* u, T* dx) {
    dx[0] = x[3] * tcos(x[2]);
    dx[1] = x[3] * tsin(x[2]);
    dx[2] = u[1];
    dx[3] = u[0];
    dx[4] = x[3];
  }
};

// z = (a, w, x, y, psi, v): SecondOrderUnicycleModel, no spline state.
struct Unicycle {
  static constexpr int NU = 2, NX = 4, NZ = NU + NX, NTRI = NZ * (NZ + 1) / 2;
  static constexpr int A = 0, W = 1, X = 2, Y = 3, PSI = 4, V = 5, S = -1;
  static constexpr int SL = -1, NXI = NX;
  static constexpr bool CA = false;
  template <typename T>
  static TMPC_FN void continuous(const T* x, const T* u, T* dx) {
    dx[0] = x[3] * tcos(x[2]);
    dx[1] = x[3] * tsin(x[2]);
    dx[2] = u[1];
    dx[3] = u[0];
  }
};

// z = (a, w, x, y, psi, v, s, slack):
// ContouringSecondOrderUnicycleModelWithSlack; slack has zero derivative.
struct ContouringUnicycleSlack {
  static constexpr int NU = 2, NX = 6, NZ = NU + NX, NTRI = NZ * (NZ + 1) / 2;
  static constexpr int A = 0, W = 1, X = 2, Y = 3, PSI = 4, V = 5, S = 6;
  static constexpr int SL = 7, NXI = NX;
  static constexpr bool CA = false;
  template <typename T>
  static TMPC_FN void continuous(const T* x, const T* u, T* dx) {
    dx[0] = x[3] * tcos(x[2]);
    dx[1] = x[3] * tsin(x[2]);
    dx[2] = u[1];
    dx[3] = u[0];
    dx[4] = x[3];
    dx[5] = Make<T>::constant(typename Real<T>::type(0));
  }
};

// The bicycles' vector field (BicycleModel2ndOrder and its curvature-aware
// variant), both with lr = lf = 1.395 m: x' = v cos(psi + beta), y' = v
// sin(psi + beta), psi' = (v / lr) sin(beta), v' = a, delta' = w, with
// beta = atan(lr / (lr + lf) tan(delta)); the plain bicycle adds s' = v.
template <typename T>
TMPC_FN void bicycle_field(const T* x, const T* u, T* dx, bool spline) {
  using R = typename Real<T>::type;
  const R lr = R(2.79 / 2.0), ratio = R(0.5);
  const T beta = tatan(ratio * ttan(x[4]));
  const T heading = x[2] + beta;
  dx[0] = x[3] * tcos(heading);
  dx[1] = x[3] * tsin(heading);
  dx[2] = (x[3] / lr) * tsin(beta);
  dx[3] = u[0];
  dx[4] = u[1];
  if (spline) dx[5] = x[3];
}

// z = (a, w, slack, x, y, psi, v, delta, s): BicycleModel2ndOrder; slack is
// an input.
struct Bicycle {
  static constexpr int NU = 3, NX = 6, NZ = NU + NX, NTRI = NZ * (NZ + 1) / 2;
  static constexpr int A = 0, W = 1, X = 3, Y = 4, PSI = 5, V = 6, S = 8;
  static constexpr int SL = 2, NXI = NX;
  static constexpr bool CA = false;
  template <typename T>
  static TMPC_FN void continuous(const T* x, const T* u, T* dx) {
    bicycle_field(x, u, dx, true);
  }
};

// BicycleModel2ndOrderCurvatureAware: RK4 on (x, y, psi, v, delta), then
// the progress update.
struct BicycleCA {
  static constexpr int NU = 3, NX = 6, NZ = NU + NX, NTRI = NZ * (NZ + 1) / 2;
  static constexpr int A = 0, W = 1, X = 3, Y = 4, PSI = 5, V = 6, S = 8;
  static constexpr int SL = 2, NXI = 5;
  static constexpr bool CA = true;
  template <typename T>
  static TMPC_FN void continuous(const T* x, const T* u, T* dx) {
    bicycle_field(x, u, dx, false);
  }
};

// ContouringSecondOrderUnicycleModelCurvatureAware: RK4 on (x, y, psi, v),
// then the progress update.
struct ContouringUnicycleCA {
  static constexpr int NU = 2, NX = 5, NZ = NU + NX, NTRI = NZ * (NZ + 1) / 2;
  static constexpr int A = 0, W = 1, X = 2, Y = 3, PSI = 4, V = 5, S = 6;
  static constexpr int SL = -1, NXI = 4;
  static constexpr bool CA = true;
  template <typename T>
  static TMPC_FN void continuous(const T* x, const T* u, T* dx) {
    dx[0] = x[3] * tcos(x[2]);
    dx[1] = x[3] * tsin(x[2]);
    dx[2] = u[1];
    dx[3] = u[0];
  }
};

// The one place that decides which models the kernels are compiled for:
// f(M{}) for the model id `model` (TB_MODEL), -3 for any other. A model adds
// its struct above and a line here (ops/sqp_fused.py::MODELS names the same
// ids).
// In a library built in parts (parts.cuh) part TMPC_PART instantiates the
// models whose id % TMPC_PARTS is TMPC_PART, and answers -3 for the rest.
#if defined(TMPC_PARTS) && !defined(TMPC_DISPATCH)
#define TMPC_IN_PART(id) ((id) % TMPC_PARTS == TMPC_PART)
#else
#define TMPC_IN_PART(id) true
#endif
template <class F>
int with_model(int model, F&& f) {
  if constexpr (TMPC_IN_PART(MODEL_CONTOURING_UNICYCLE))
    if (model == MODEL_CONTOURING_UNICYCLE) return f(ContouringUnicycle{});
  if constexpr (TMPC_IN_PART(MODEL_UNICYCLE))
    if (model == MODEL_UNICYCLE) return f(Unicycle{});
  if constexpr (TMPC_IN_PART(MODEL_CONTOURING_UNICYCLE_SLACK))
    if (model == MODEL_CONTOURING_UNICYCLE_SLACK)
      return f(ContouringUnicycleSlack{});
  if constexpr (TMPC_IN_PART(MODEL_BICYCLE))
    if (model == MODEL_BICYCLE) return f(Bicycle{});
  if constexpr (TMPC_IN_PART(MODEL_BICYCLE_CA))
    if (model == MODEL_BICYCLE_CA) return f(BicycleCA{});
  if constexpr (TMPC_IN_PART(MODEL_CONTOURING_UNICYCLE_CA))
    if (model == MODEL_CONTOURING_UNICYCLE_CA)
      return f(ContouringUnicycleCA{});
  return -3;
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
// Segment i at s: value and first derivative of x(s) and y(s); (when
// `extra` is SP_V, SP_WL or SP_WR, not 0) the value of the spline whose
// coefficients start there (the velocity reference, the left or the right
// road width), local in the same s - start as the path (the modules
// evaluate Spline(params, name, ...) on the path's segment starts); (when
// `curv`) the second derivatives of x(s) and y(s).
template <typename R>
TMPC_HD void spline_segment(const int* q, const Par<R>& p,
                            const Jet<R, 1, 1>& s, int extra, bool curv,
                            Jet<R, 1, 1>* v) {
  const Jet<R, 1, 1> ds = s - p[q[8]];
  v[0] = ((p[q[0]] * ds + p[q[1]]) * ds + p[q[2]]) * ds + p[q[3]];
  v[1] = ((p[q[4]] * ds + p[q[5]]) * ds + p[q[6]]) * ds + p[q[7]];
  v[2] = (R(3) * p[q[0]] * ds + R(2) * p[q[1]]) * ds + p[q[2]];
  v[3] = (R(3) * p[q[4]] * ds + R(2) * p[q[5]]) * ds + p[q[6]];
  if (extra)
    v[4] = ((p[q[extra]] * ds + p[q[extra + 1]]) * ds + p[q[extra + 2]]) * ds +
           p[q[extra + 3]];
  if (curv) {
    v[5] = (R(6) * p[q[0]]) * ds + R(2) * p[q[1]];
    v[6] = (R(6) * p[q[4]]) * ds + R(2) * p[q[5]];
  }
}

// The path point, normalized tangent, (when `angle`) tangent angle, (when
// `extra`) the extra spline's value and (when `curv`) the second
// derivatives at s, as jets in s:
// out = (x, y, dx_n, dy_n, angle, extra, ddx, ddy).
template <typename R>
TMPC_FN void path_at(const Ocp& o, const Par<R>& p, R s_val, bool angle,
                     int extra, bool curv, Jet<R, 1, 1>* out) {
  using J1 = Jet<R, 1, 1>;
  const J1 s = jet_seed<R, 1, 1>(s_val, 0);
  const int M = o.it[TB_NSEG];
  const int* sp = o.it + o.it[TB_OFF_SPLINE];
  // Blend back to front: out = lam_k v_{k-1} + (1 - lam_k) out, with
  // lam_k = sigmoid(-(s - start_k + 0.02) / 0.1).
  J1 acc[7], v[7];
  spline_segment(sp + SP_W * (M - 1), p, s, extra, curv, acc);
  for (int k = M - 1; k >= 1; --k) {
    spline_segment(sp + SP_W * (k - 1), p, s, extra, curv, v);
    const J1 lam =
        tsigmoid(-((s - p[sp[SP_W * k + 8]]) + R(0.02)) / R(0.1));
    const J1 rest = R(1) - lam;
    TMPC_UNROLL for (int q = 0; q < 4; ++q) acc[q] = lam * v[q] + rest * acc[q];
    if (extra) acc[4] = lam * v[4] + rest * acc[4];
    if (curv) {
      acc[5] = lam * v[5] + rest * acc[5];
      acc[6] = lam * v[6] + rest * acc[6];
    }
  }
  const J1 norm = tsqrt(acc[2] * acc[2] + acc[3] * acc[3]);
  out[0] = acc[0];
  out[1] = acc[1];
  out[2] = acc[2] / norm;
  out[3] = acc[3] / norm;
  if (angle) out[4] = tatan2(out[3], out[2]);
  if (extra) out[5] = acc[4];
  if (curv) {
    out[6] = acc[5];
    out[7] = acc[6];
  }
}

// ---- objective (modules' get_value, summed as ModuleManager.objective) ----
// MPCBase weighs a and w, then slack where TB_SLACK is a parameter index (not
// -1; only on a model with a slack state), then v where TB_VEL is one.
// Contouring needs the model's spline state; ocp_tables sets FL_CONTOUR only
// for a model that has one.
template <class M, typename S, typename R>
TMPC_FN S stage_cost(const Ocp& o, const Par<R>& p, const S* z, bool terminal) {
  const int* it = o.it;
  const int flags = it[TB_FLAGS];
  S cost = Make<S>::constant(R(0));
  if (flags & FL_BASE) {
    cost = cost + p[it[TB_ACC]] * (z[M::A] * z[M::A]);
    cost = cost + p[it[TB_ANGVEL]] * (z[M::W] * z[M::W]);
    if constexpr (M::SL >= 0) if (it[TB_SLACK] >= 0)
      cost = cost + p[it[TB_SLACK]] * (z[M::SL] * z[M::SL]);
    if (it[TB_VEL] >= 0) {
      const S dv = z[M::V] - p[it[TB_VREF]];
      cost = cost + p[it[TB_VEL]] * (dv * dv);
    }
  }
  if constexpr (M::S >= 0) if (flags & FL_CONTOUR) {
    const bool vref = flags & FL_VSPLINE;
    Jet<R, 1, 1> q[8];
    path_at(o, p, value(z[M::S]), terminal, vref ? int(SP_V) : 0, false, q);
    const S ex = z[M::X] - lift_s(q[0], z[M::S]);
    const S ey = z[M::Y] - lift_s(q[1], z[M::S]);
    const S dxn = lift_s(q[2], z[M::S]), dyn = lift_s(q[3], z[M::S]);
    const S contour = dyn * ex - dxn * ey;
    const S lag = dxn * ex + dyn * ey;
    const R cw = p[it[TB_CONTOUR]], lw = p[it[TB_LAG]];
    const S lag2 = lag * lag, contour2 = contour * contour;
    S c = lw * lag2;
    c = c + cw * contour2;
    if (vref) {
      const S dv = z[M::V] - lift_s(q[5], z[M::S]);
      c = c + p[it[TB_VREF_W]] * (dv * dv);
    }
    if (terminal) {
      const R tc = p[it[TB_TCONT]];
      const S err = haar(z[M::PSI] - lift_s(q[4], z[M::S]));
      c = c + p[it[TB_TANGLE]] * (err * err);
      c = c + (tc * lw) * lag2;
      c = c + (tc * cw) * contour2;
    }
    cost = cost + c;
  }
  if constexpr (M::S >= 0) if (flags & FL_CA_CONTOUR) {
    // curvature_aware_contouring.py: w_c |p - path|^2 + w_v (s_dot -
    // v_ref)^2, s_dot = v (cos psi, sin psi) . t_hat / (1 - (p - path) .
    // path''); at the terminal stage the angle error and the terminal
    // multiplier on both terms.
    const bool vref = flags & FL_VSPLINE;
    Jet<R, 1, 1> q[8];
    path_at(o, p, value(z[M::S]), terminal, vref ? int(SP_V) : 0, true, q);
    const S ex = z[M::X] - lift_s(q[0], z[M::S]);
    const S ey = z[M::Y] - lift_s(q[1], z[M::S]);
    const S dxn = lift_s(q[2], z[M::S]), dyn = lift_s(q[3], z[M::S]);
    const S ddx = lift_s(q[6], z[M::S]), ddy = lift_s(q[7], z[M::S]);
    const S ratio = trecip(R(1) - (ex * ddx + ey * ddy));
    const S s_dot =
        (z[M::V] * (tcos(z[M::PSI]) * dxn + tsin(z[M::PSI]) * dyn)) * ratio;
    const S e2 = ex * ex + ey * ey;
    const S dv = vref ? s_dot - lift_s(q[5], z[M::S])
                      : s_dot - p[it[TB_CA_VREF]];
    const S dv2 = dv * dv;
    const R cw = p[it[TB_CONTOUR]], vw = p[it[TB_VREF_W]];
    S c = cw * e2;
    c = c + vw * dv2;
    if (terminal) {
      const R tc = p[it[TB_TCONT]];
      const S err = haar(z[M::PSI] - lift_s(q[4], z[M::S]));
      c = c + p[it[TB_TANGLE]] * (err * err);
      c = c + (tc * cw) * e2;
      c = c + (tc * vw) * dv2;
    }
    cost = cost + c;
  }
  if (flags & FL_CONSIST) {
    const S ex = z[M::X] - p[it[TB_PREV_X]];
    const S ey = z[M::Y] - p[it[TB_PREV_Y]];
    cost = cost + p[it[TB_CONS_W]] * (ex * ex + ey * ey);
  }
  if (flags & FL_GOAL) {
    const R gx = p[it[TB_GOAL_X]], gy = p[it[TB_GOAL_Y]];
    const S ex = z[M::X] - gx;
    const S ey = z[M::Y] - gy;
    const R norm = (gx * gx + gy * gy) + R(0.01);
    cost = cost + (p[it[TB_GOAL_W]] * (ex * ex + ey * ey)) / norm;
  }
  return cost;
}

// ---- dynamics: the model's vector field, RK4 x 3 over dt ------------------
// RK4 on the first M::NXI states of x; out receives those.
template <class M, typename S>
TMPC_FN void rk4(const S* x, const S* u, double dt, S* out) {
  using R = typename Real<S>::type;
  constexpr int NI = M::NXI;
  const double h = dt / 3.0;
  const R half_h = R(0.5 * h), full_h = R(h), sixth_h = R(h / 6.0);
  S xi[NI], k1[NI], k2[NI], k3[NI], k4[NI], tmp[NI];
  TMPC_UNROLL for (int i = 0; i < NI; ++i) xi[i] = x[i];
  for (int step = 0; step < 3; ++step) {
    M::continuous(xi, u, k1);
    TMPC_UNROLL for (int i = 0; i < NI; ++i) tmp[i] = xi[i] + half_h * k1[i];
    M::continuous(tmp, u, k2);
    TMPC_UNROLL for (int i = 0; i < NI; ++i) tmp[i] = xi[i] + half_h * k2[i];
    M::continuous(tmp, u, k3);
    TMPC_UNROLL for (int i = 0; i < NI; ++i) tmp[i] = xi[i] + full_h * k3[i];
    M::continuous(tmp, u, k4);
    TMPC_UNROLL for (int i = 0; i < NI; ++i)
      xi[i] = xi[i] +
              sixth_h * (((k1[i] + R(2) * k2[i]) + R(2) * k3[i]) + k4[i]);
  }
  TMPC_UNROLL for (int i = 0; i < NI; ++i) out[i] = xi[i];
}

// models/dynamics.py::_ca_spline_update: the spline state (the last of x)
// advances by s + R atan2(vt, R - contour_error - vn), the step's tangential
// and normal parts vt, vn and the contour error taken against the path's
// point and unit tangent at the current s, and R = 1 / sqrt(max(ddx^2 +
// ddy^2, CURVATURE2_FLOOR)) from the path's second derivatives there (its
// derivative 0 on the floored branch). xi: the integrated (x, y, ...).
template <class M, typename S, typename R>
TMPC_FN S ca_progress(const Ocp& o, const Par<R>& p, const S* x, const S* xi) {
  constexpr int XS = M::S - M::NU;
  Jet<R, 1, 1> q[8];
  path_at(o, p, value(x[XS]), false, 0, true, q);
  const S s = x[XS];
  const S ex = x[0] - lift_s(q[0], s), ey = x[1] - lift_s(q[1], s);
  const S tx = lift_s(q[2], s), ty = lift_s(q[3], s);
  const S ddx = lift_s(q[6], s), ddy = lift_s(q[7], s);
  const S contour = ty * ex - tx * ey;
  const S dpx = xi[0] - x[0], dpy = xi[1] - x[1];
  const S vt = dpx * tx + dpy * ty;
  const S vn = dpx * ty - dpy * tx;
  const S k2 = ddx * ddx + ddy * ddy;
  const S radius =
      value(k2) >= R(CURVATURE2_FLOOR)
          ? trecip(tsqrt(k2))
          : Make<S>::constant(R(1) / m_sqrt(R(CURVATURE2_FLOOR)));
  const S theta = tatan2(vt, (radius - contour) - vn);
  return s + radius * theta;
}

// x_{k+1} = F(x_k, u_k) at stage parameters p: RK4 on the integrated
// states, then (CA models) the progress update of the spline state.
template <class M, typename S, typename R>
TMPC_FN void dynamics(const Ocp& o, const Par<R>& p, const S* x, const S* u,
                      double dt, S* out) {
  rk4<M>(x, u, dt, out);
  if constexpr (M::CA) out[M::NX - 1] = ca_progress<M>(o, p, x, out);
}

// ---- constraints: h_i(z), over the model's x, y, psi (and slack) ----------
// utils/math.py::erfinv_newton: a rational initial guess, then two Newton
// steps on erf(y) = x.
template <typename R>
TMPC_HD R erfinv_newton(R x) {
  const R z = m_sqrt(-m_log((R(1) - x) / R(2)));
  R y = (((R(1.641345311) * z + R(3.429567803)) * z - R(1.624906493)) * z -
         R(1.970840454)) /
        ((R(1.637067800) * z + R(3.543889200)) * z + R(1));
  const R two_over_sqrt_pi = R(1.1283791670955126);  // 2 / sqrt(pi)
  for (int k = 0; k < 2; ++k)
    y = y - (m_erf(y) - x) / (two_over_sqrt_pi * m_exp(-y * y));
  return y;
}

// Ego disc position: the model's (x, y) plus offset along its heading.
template <class M, typename S, typename R>
TMPC_HD void disc_position(const S* z, R offset, S* px, S* py) {
  *px = z[M::X] + tcos(z[M::PSI]) * offset;
  *py = z[M::Y] + tsin(z[M::PSI]) * offset;
}

template <class M, typename S, typename R>
TMPC_FN S h_row(const Ocp& o, const Par<R>& p, const S* z, int i) {
  const int* q = o.it + o.it[TB_OFF_H] + H_W * i;
  if (q[0] == HK_HALFSPACE)
    return (p[q[1]] * z[M::X] + p[q[2]] * z[M::Y]) - p[q[3]];
  if (q[0] == HK_GAUSSIAN) {
    // a^T d - (r_ego + r_obs) - erfinv(1 - 2 risk) sqrt(2 a^T Sigma a),
    // a = d / |d|, Sigma = diag(major^2, minor^2).
    S dx, dy;
    disc_position<M>(z, p[q[7]], &dx, &dy);
    dx = dx - p[q[1]];
    dy = dy - p[q[2]];
    const S dist = tsqrt(dx * dx + dy * dy);
    const S ax = dx / dist, ay = dy / dist;
    const R y_erfinv = erfinv_newton(R(1) - R(2) * p[q[5]]);
    const R sx = p[q[3]], sy = p[q[4]];
    const S a_sigma_a = (ax * ax) * (sx * sx) + (ay * ay) * (sy * sy);
    const R combined = p[o.it[TB_DISC_R]] + p[q[6]];
    return ((ax * dx + ay * dy) - combined) - y_erfinv * tsqrt(R(2) * a_sigma_a);
  }
  if (q[0] == HK_SCENARIO || q[0] == HK_DECOMP) {
    // a1 px + a2 py - (b + slack); ocp_tables admits a scenario row on a
    // model with slack only, a decomp row takes 0 where the model has none.
    S px, py;
    disc_position<M>(z, p[q[4]], &px, &py);
    if constexpr (M::SL >= 0)
      return (p[q[1]] * px + p[q[2]] * py) - (z[M::SL] + p[q[3]]);
    return (p[q[1]] * px + p[q[2]] * py) - p[q[3]];
  }
  if (q[0] == HK_ROADWIDTH) {
    // +-contour_error + w/2 - width_{right,left}(s) - slack; ocp_tables
    // admits it on a model with a spline state only.
    if constexpr (M::S >= 0) {
      const bool left = q[1] != 0;
      Jet<R, 1, 1> w[8];
      path_at(o, p, value(z[M::S]), false, left ? int(SP_WL) : int(SP_WR),
              false, w);
      const S ex = z[M::X] - lift_s(w[0], z[M::S]);
      const S ey = z[M::Y] - lift_s(w[1], z[M::S]);
      const S contour = lift_s(w[3], z[M::S]) * ex - lift_s(w[2], z[M::S]) * ey;
      const S side = left ? -contour : contour;
      const S h = (side + R(o.rt[RT_HALF_WIDTH])) - lift_s(w[5], z[M::S]);
      if constexpr (M::SL >= 0) return h - z[M::SL];
      return h;
    }
    return Make<S>::constant(R(0));
  }
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
  S dx, dy;
  disc_position<M>(z, p[q[8]], &dx, &dy);
  dx = dx - p[q[1]];
  dy = dy - p[q[2]];
  return ((e11 * dx) * dx + ((R(2) * e12) * dx) * dy) + (e22 * dy) * dy;
}

// ---- the QP fields ----------------------------------------------------------
// Field offsets of one problem's QP, in the (fields, Bt) layout of the IP
// solve (qp_ip.cuh): H upper triangle (T, NTRI), g (T, NZ), A (T-1, NX, NX),
// B (T-1, NX, NU), c (T-1, NX), generic D rows (T, max(mh, 1), NZ), e (T, m),
// r0 (NX), for model M.
template <class M>
struct QpLayout {
  static constexpr int NU = M::NU, NX = M::NX, NZ = M::NZ, NTRI = M::NTRI;
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
template <int NZ, typename R>
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

// The "mirror" regularization of the dense symmetric (NZ, NZ) stage block
// Hs (mirror.cuh): for t < N the whole block, at stage N only the x block
// (the u block stays the identity, the u-x blocks 0), as JAX's build_qp
// under "mirror"; a block with a non-finite entry becomes all NaN. A and V:
// NZ * NZ reals each.
template <int NZ, typename R>
TMPC_FN void mirror_hessian(R* Hs, int n, int off, R eps, R* A, R* V) {
  bool finite_all = true;
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) {
      const R v = Hs[(off + i) * NZ + off + j];
      A[i * n + j] = v;
      finite_all = finite_all && mirror::is_finite(v);
    }
  LIN_CLOCK;
  if (!finite_all) {
    for (int i = 0; i < n; ++i)
      for (int j = 0; j < n; ++j) Hs[(off + i) * NZ + off + j] = R(NAN);
    return;
  }
  mirror::jacobi(A, V, n, eps);
  LIN_LAP(LIN_SEC_JACOBI);
  for (int i = 0; i < n; ++i)
    for (int k = i; k < n; ++k) {
      const R v = mirror::entry(A, V, n, i, k);
      Hs[(off + i) * NZ + off + k] = v;
      Hs[(off + k) * NZ + off + i] = v;
    }
  LIN_LAP(LIN_SEC_STORE);
}

// Linearize stage t of one problem at its iterate Z: the stage's fields of
// QpLayout (all but r0). MIRROR (the linearize entry's variant for
// REG_MIRROR) mirrors the stage's Hessian before it is stored; without it
// the code and workspace of the mirror are not compiled in, so the fused
// solve, which calls this too, does not carry them.
template <class M, typename R, bool MIRROR = false>
TMPC_ONCE void linearize_stage(const Ocp& o, const Col<const R>& P,
                               const Col<const R>& Z, const Col<R>& qp,
                               const QpLayout<M>& L, int reg, int t) {
  constexpr int NU = M::NU, NX = M::NX, NZ = M::NZ, NTRI = M::NTRI;
  using J2 = Jet<R, NZ, NTRI>;
  using J1 = Jet<R, NZ, 0>;
  const int T = L.T, N = T - 1, m = L.m;
  const double reg_eps = o.rt[RT_REG_EPS], lev = o.rt[RT_LEVENBERG];
  const double dt = o.rt[RT_DT];
  const bool body_terminal = (o.it[TB_FLAGS] & FL_BODY_TERMINAL) != 0;
  const int* rows = o.it + o.it[TB_OFF_ROWS];
  const Par<R> p = stage_params(P, t, T);
  LIN_CLOCK;
  R z[NZ];
  TMPC_UNROLL for (int i = 0; i < NZ; ++i)
    z[i] = (t == N && i < NU) ? R(0) : Z[t * NZ + i];

  // Cost gradient and Hessian. Stage N: terminal cost at u = 0; its block
  // is the identity on u and the cost's x block on x.
  {
    J2 zj[NZ];
    TMPC_UNROLL for (int i = 0; i < NZ; ++i) zj[i] = jet_seed<R, NZ, NTRI>(z[i], i);
    const J2 cost = stage_cost<M>(o, p, zj, t < N ? body_terminal : true);
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
    if constexpr (MIRROR) {
      LIN_LAP(LIN_SEC_COST);
      R A[NZ * NZ], V[NZ * NZ];
      if (t < N)
        mirror_hessian<NZ>(Hs, NZ, 0, R(reg_eps), A, V);
      else
        mirror_hessian<NZ>(Hs, NX, NU, R(reg_eps), A, V);
      LIN_SKIP();
    }
    store_hessian<NZ>(Hs, reg, reg_eps, lev, qp, L.H + t * NTRI);
    if constexpr (MIRROR) LIN_LAP(LIN_SEC_STORE);
  }

  if (t == N) {
    // Stage N: masked placeholder rows.
    for (int f = 0; f < L.mhp * NZ; ++f) qp[L.D + t * L.mhp * NZ + f] = R(0);
    for (int r = 0; r < m; ++r) qp[L.e + t * m + r] = R(1);
    return;
  }

  J1 zd[NZ];
  TMPC_UNROLL for (int i = 0; i < NZ; ++i) zd[i] = jet_seed<R, NZ, 0>(z[i], i);

  // Dynamics: A = dF/dx, B = dF/du, c = F(z_t) - x_{t+1}.
  {
    J1 F[NX];
    dynamics<M>(o, p, zd + NU, zd, dt, F);
    TMPC_UNROLL for (int i = 0; i < NX; ++i) {
      TMPC_UNROLL for (int j = 0; j < NX; ++j)
        qp[L.A + (t * NX + i) * NX + j] = F[i].g[NU + j];
      TMPC_UNROLL for (int j = 0; j < NU; ++j)
        qp[L.B + (t * NX + i) * NU + j] = F[i].g[j];
      qp[L.c + t * NX + i] = F[i].v - Z[(t + 1) * NZ + NU + i];
    }
  }
  if constexpr (MIRROR) LIN_LAP(LIN_SEC_DYN);

  // Inequality rows D z + e >= 0 in the OCP's row order.
  int slot = 0;
  for (int r = 0; r < m; ++r) {
    const int kind = rows[2 * r], idx = rows[2 * r + 1];
    const R bound = R(o.rt[RT_BOUNDS + r]);
    R e;
    if (kind == ROW_HL || kind == ROW_HU) {
      const J1 h = h_row<M>(o, p, zd, idx);
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
  if constexpr (MIRROR) LIN_LAP(LIN_SEC_ROWS);
}

// The initial-condition residual r0 = x0 - x_0.
template <class M, typename R>
TMPC_HD void linearize_r0(const Col<const R>& x0, const Col<const R>& Z,
                          const Col<R>& qp, const QpLayout<M>& L) {
  TMPC_UNROLL for (int i = 0; i < M::NX; ++i)
    qp[L.r0 + i] = x0[i] - Z[M::NU + i];
}

// Every field of QpLayout, stage after stage: the host's serial form.
template <class M, typename R, bool MIRROR = false>
TMPC_HD void linearize(const Ocp& o, const Col<const R>& P,
                       const Col<const R>& x0, const Col<const R>& Z,
                       const Col<R>& qp, const QpLayout<M>& L, int reg) {
  for (int t = 0; t < L.T; ++t)
    linearize_stage<M, R, MIRROR>(o, P, Z, qp, L, reg, t);
  linearize_r0(x0, Z, qp, L);
}

// Every field of QpLayout with one lane group: lane t linearizes stage t,
// lane 0 writes r0.
template <class M, typename R, bool MIRROR = false>
TMPC_WARP void linearize_warp(const warp::Lanes& lanes, const Ocp& o,
                              const Col<const R>& P, const Col<const R>& x0,
                              const Col<const R>& Z, const Col<R>& qp,
                              const QpLayout<M>& L, int reg) {
  lanes.run([&](int l) {
    for (int t = l; t < L.T; t += warp::WIDTH)
      linearize_stage<M, R, MIRROR>(o, P, Z, qp, L, reg, t);
    if (l == 0) linearize_r0(x0, Z, qp, L);
  });
}

// Stage t's merit terms: its cost, its largest dynamics defect
// max_i |F(z_t) - x_{t+1}| (0 at stage N) and whether its z is finite (1/0).
template <class M, typename R>
TMPC_ONCE void merit_stage(const Ocp& o, const Col<const R>& P,
                           const Col<const R>& Z, int T, int t, R* cost_out,
                           R* eq_out, R* finite_out) {
  constexpr int NU = M::NU, NX = M::NX, NZ = M::NZ;
  const int N = T - 1;
  const Par<R> p = stage_params(P, t, T);
  const bool body_terminal = (o.it[TB_FLAGS] & FL_BODY_TERMINAL) != 0;
  R z[NZ];
  bool z_finite = true;
  TMPC_UNROLL for (int i = 0; i < NZ; ++i) {
    z[i] = Z[t * NZ + i];
    z_finite = z_finite && finite(z[i]);
  }
  R eq = R(0);
  if (t == N) {
    TMPC_UNROLL for (int i = 0; i < NU; ++i) z[i] = R(0);
    *cost_out = stage_cost<M>(o, p, z, true);
  } else {
    R F[NX];
    dynamics<M>(o, p, z + NU, z, o.rt[RT_DT], F);
    TMPC_UNROLL for (int i = 0; i < NX; ++i)
      eq = nanmax(eq, m_abs(F[i] - Z[(t + 1) * NZ + NU + i]));
    *cost_out = stage_cost<M>(o, p, z, body_terminal);
  }
  *eq_out = eq;
  *finite_out = z_finite ? R(1) : R(0);
}

// |x0 - x_0| at its largest.
template <class M, typename R>
TMPC_HD R initial_defect(const Col<const R>& x0, const Col<const R>& Z) {
  R eq = R(0);
  TMPC_UNROLL for (int i = 0; i < M::NX; ++i)
    eq = nanmax(eq, m_abs(x0[i] - Z[M::NU + i]));
  return eq;
}

// make_lane_merit's combination of the stage terms, in stage order: merit =
// cost + w eq_res (inf unless cost and Z are finite), eq_res = max(dynamics
// defects, initial defect).
template <typename R>
struct MeritSum {
  R cost = R(0), eq_dyn = R(0);
  bool z_finite = true;
  TMPC_HD void add(R cost_t, R eq_t, R finite_t) {
    cost = cost + cost_t;
    eq_dyn = nanmax(eq_dyn, eq_t);
    z_finite = z_finite && finite_t != R(0);
  }
  TMPC_HD void finish(const Ocp& o, R eq_init, R* merit_out, R* cost_out,
                      R* eq_out) const {
    const R eq = nanmax(eq_dyn, eq_init);
    const bool ok = finite(cost) && z_finite;
    *merit_out = ok ? cost + R(o.rt[RT_MERIT_W]) * eq : R(INFINITY);
    *cost_out = cost;
    *eq_out = eq;
  }
};

// The merit terms at Z, stage after stage: the host's serial form.
template <class M, typename R>
TMPC_HD void merit(const Ocp& o, const Col<const R>& P, const Col<const R>& x0,
                   const Col<const R>& Z, int T, R* merit_out, R* cost_out,
                   R* eq_out) {
  MeritSum<R> sum;
  for (int t = 0; t < T; ++t) {
    R c, e, f;
    merit_stage<M>(o, P, Z, T, t, &c, &e, &f);
    sum.add(c, e, f);
  }
  sum.finish(o, initial_defect<M>(x0, Z), merit_out, cost_out, eq_out);
}

// The merit terms with one lane group: lane t takes stage t, lane 0 the
// initial defect; `red` holds 3 n + 1 reals (n >= T) for the partials,
// which uniform code combines in stage order. Every lane returns the terms.
template <class M, typename R>
TMPC_WARP void merit_warp(const warp::Lanes& lanes, const Ocp& o,
                          const Col<const R>& P, const Col<const R>& x0,
                          const Col<const R>& Z, int T, R* red, int n,
                          R* merit_out, R* cost_out, R* eq_out) {
  lanes.run([&](int l) {
    for (int t = l; t < T; t += warp::WIDTH)
      merit_stage<M>(o, P, Z, T, t, red + t, red + n + t, red + 2 * n + t);
    if (l == 0) red[3 * n] = initial_defect<M>(x0, Z);
  });
  MeritSum<R> sum;
  for (int t = 0; t < T; ++t) sum.add(red[t], red[n + t], red[2 * n + t]);
  sum.finish(o, red[3 * n], merit_out, cost_out, eq_out);
}

#undef TMPC_JET
#undef TMPC_J
#undef TMPC_S

}  // namespace tmpc
