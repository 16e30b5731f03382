// The "mirror" regularization (JAX ops/sqp.py::_mirror_regularize): a
// symmetric n x n block replaced by V max(|w|, eps) V^T, w and V its
// eigenvalues and eigenvectors by cyclic Jacobi. One copy of the arithmetic
// for the two kernels that run it on one lane's stage block:
// - the single-instance kernel's mirror pass (sqp_single.cuh::mirror_stage,
//   on the packed upper triangle of its QP in shared memory);
// - the linearize entry's mirror variant (tmpc_ocp.cuh::linearize_stage
//   with MIRROR, on the dense stage Hessian in the lane's local memory,
//   before store_hessian packs it).
// Both load the block into A (n * n, row-major; a non-finite entry makes
// the whole block NaN, as JAX's eigh gives it), call jacobi(), and store
// entry(i, k) for i <= k. A and V: n * n reals of workspace each.

#pragma once

#include "warp.cuh"

#include <math.h>

namespace mirror {

#if defined(__CUDACC__)
#define MIRROR_FN __host__ __device__ __forceinline__
#else
#define MIRROR_FN inline
#endif

// Jacobi sweeps at most; a 9 x 9 block converges in fewer.
constexpr int MAX_SWEEPS = 24;

MIRROR_FN float m_abs(float x) { return fabsf(x); }
MIRROR_FN double m_abs(double x) { return fabs(x); }
MIRROR_FN float m_sqrt(float x) { return sqrtf(x); }
MIRROR_FN double m_sqrt(double x) { return sqrt(x); }

// Finite (neither NaN nor infinite), by comparisons alone.
template <typename real>
MIRROR_FN bool is_finite(real v) {
  return v == v && m_abs(v) != real(INFINITY);
}

// The eigendecomposition of the symmetric n x n block in A by cyclic
// Jacobi: sweeps of rotations over every (p, q) until the off-diagonal
// Frobenius norm is at most the real type's epsilon times the block's (or
// MAX_SWEEPS sweeps). On return V holds the eigenvectors (columns) and A's
// diagonal max(|w|, eps); A's off-diagonal entries are left as the sweeps
// leave them.
template <typename real>
MIRROR_FN void jacobi(real* A, real* V, int n, real eps) {
  const real tol =
      real(sizeof(real) == sizeof(float) ? 1.1920929e-07 : 2.220446049250313e-16);
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) V[i * n + j] = i == j ? real(1) : real(0);
  for (int sweep = 0; sweep < MAX_SWEEPS; ++sweep) {
    real offd = real(0), nrm = real(0);
    for (int i = 0; i < n; ++i)
      for (int j = 0; j < n; ++j) {
        const real a2 = A[i * n + j] * A[i * n + j];
        nrm = nrm + a2;
        if (i != j) offd = offd + a2;
      }
    if (!(offd > tol * tol * nrm)) break;
    for (int pp = 0; pp < n - 1; ++pp)
      for (int qq = pp + 1; qq < n; ++qq) {
        const real apq = A[pp * n + qq];
        if (apq == real(0)) continue;
        const real theta = (A[qq * n + qq] - A[pp * n + pp]) / (real(2) * apq);
        const real at = m_abs(theta);
        real t;
        if (at > real(1e18)) {
          t = real(0.5) / theta;
        } else {
          t = real(1) / (at + m_sqrt(theta * theta + real(1)));
          if (theta < real(0)) t = -t;
        }
        const real c = real(1) / m_sqrt(t * t + real(1));
        const real s = t * c;
        for (int k = 0; k < n; ++k) {  // A <- A J
          const real akp = A[k * n + pp], akq = A[k * n + qq];
          A[k * n + pp] = c * akp - s * akq;
          A[k * n + qq] = s * akp + c * akq;
        }
        for (int k = 0; k < n; ++k) {  // A <- J^T A
          const real apk = A[pp * n + k], aqk = A[qq * n + k];
          A[pp * n + k] = c * apk - s * aqk;
          A[qq * n + k] = s * apk + c * aqk;
        }
        A[pp * n + qq] = real(0);
        A[qq * n + pp] = real(0);
        for (int k = 0; k < n; ++k) {  // V <- V J
          const real vkp = V[k * n + pp], vkq = V[k * n + qq];
          V[k * n + pp] = c * vkp - s * vkq;
          V[k * n + qq] = s * vkp + c * vkq;
        }
      }
  }
  // the diagonal -> max(|w|, eps), NaN-propagating
  for (int j = 0; j < n; ++j) {
    const real w = m_abs(A[j * n + j]);
    A[j * n + j] = (w != w) ? w : ((eps != eps) ? eps : (w > eps ? w : eps));
  }
}

// Entry (i, k) of V max(|w|, eps) V^T after jacobi().
template <typename real>
MIRROR_FN real entry(const real* A, const real* V, int n, int i, int k) {
  real acc = V[i * n] * A[0] * V[k * n];
  for (int j = 1; j < n; ++j) acc = acc + V[i * n + j] * A[j * n + j] * V[k * n + j];
  return acc;
}

}  // namespace mirror
