// Fused whole-SQP solve of a fleet of T-MPC++ OCPs in one launch, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel of the JAX package,
// ops/sqp_fused.py::_fused_kernel: per problem, every SQP iteration of every
// schedule phase linearizes the OCP in the kernel (tmpc_ocp.cuh, the lane
// linearizer's semantics), solves the QP with the interior-point iteration
// of the QP kernel (qp_ip.cuh, cold start, the phase's iteration count), and
// takes the full step, keeping the old iterate where the sum of the step is
// NaN. With track_best it keeps the best iterate by merit
// (cost + w * eq_res). It writes the returned iterate, its cost and its
// equality residual.
//
// Mapping: one thread per problem, 32 threads per block, as in qp_ip.cu.
// Everything a problem carries between passes lives in global memory in the
// field-major (fields, Bt) layout: the QP fields, the step, the iterate, the
// best iterate and the IP scratch (sqp_fused_scratch_fields), so that
// neighbouring threads touch neighbouring addresses. The linearization's
// jets (value, gradient and 28 Hessian entries each) are thread-local.
//
// What bounds it: latency, as in qp_ip.cu. 4608 threads are about one warp
// per SM, and the jets of the cost Hessian do not fit the register file, so
// they spill to local memory (ptxas reports the bytes). What the fused design
// removes is the host: one launch replaces, per SQP iteration, a torch.func
// linearization of about 4k small kernels and an IP launch. A warp per
// problem (stages of the linearization and the row passes across lanes) is
// the later step; this kernel is the simple, exact one.
//
// The kernel allocates nothing and does not synchronize: the caller passes
// the scratch buffer and the stream. Each extern "C" entry returns
// cudaGetLastError() after the launch, or -1 when a size is out of range.

#include "qp_ip.cuh"
#include "tmpc_ocp.cuh"

namespace {

using tmpc::Col;
using tmpc::NTRI;
using tmpc::NU;
using tmpc::NX;
using tmpc::NZ;

// Per-problem fields of the scratch buffer.
struct FusedLayout {
  tmpc::QpLayout L;
  int qp, dz, z, zbest, ip, total;
  __host__ __device__ FusedLayout(int T, int m, int mh) : L(T, m, mh) {
    qp = 0;
    dz = L.total;
    z = dz + T * NZ;
    zbest = z + T * NZ;
    ip = zbest + T * NZ;
    total = ip + Scratch(T, NZ, NX, NU, m).total;
  }
};

template <typename real>
__global__ void __launch_bounds__(QP_THREADS)
sqp_fused_kernel(const real* __restrict__ P, const real* __restrict__ x0,
                 const real* __restrict__ Z0, real* __restrict__ out,
                 real* __restrict__ scratch, const real* __restrict__ mask,
                 const int* __restrict__ rinfo, const int* __restrict__ pairs,
                 const int* __restrict__ itab, const double* __restrict__ rtab,
                 const int* __restrict__ phases, int n_phases, FusedLayout F,
                 Sizes sz, int any_active, int track_best, int reg, real mu0,
                 real mu_min, real tau, real w_max, real s_floor,
                 real tol_freeze, real n_act) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= sz.Bt) return;
  const size_t Bt = sz.Bt;
  const int T = sz.T, nzT = T * NZ;
  const tmpc::Ocp o{itab, rtab};
  const tmpc::QpLayout& L = F.L;
  const Col<const real> Pc{P, Bt, b}, xc{x0, Bt, b};
  real* qp = scratch + (size_t)F.qp * Bt;
  const Col<real> dz{scratch + (size_t)F.dz * Bt, Bt, b};
  const Col<real> z{scratch + (size_t)F.z * Bt, Bt, b};
  const Col<real> zbest{scratch + (size_t)F.zbest * Bt, Bt, b};
  const Col<const real> zc{z.p, Bt, b}, zbc{zbest.p, Bt, b};

  for (int f = 0; f < nzT; ++f) z[f] = Z0[(size_t)f * Bt + b];
  real best = real(0), mv, cost, eq;
  if (track_best) {
    tmpc::merit<real>(o, Pc, xc, zc, T, &best, &cost, &eq);
    for (int f = 0; f < nzT; ++f) zbest[f] = z[f];
  }
  for (int ph = 0; ph < n_phases; ++ph) {
    const int n_sqp = phases[2 * ph], n_qp = phases[2 * ph + 1];
    for (int it = 0; it < n_sqp; ++it) {
      tmpc::linearize<real>(o, Pc, xc, zc, Col<real>{qp, Bt, b}, L, reg);
      ip_solve_problem<real>(
          qp + (size_t)L.H * Bt, qp + (size_t)L.g * Bt, qp + (size_t)L.A * Bt,
          qp + (size_t)L.B * Bt, qp + (size_t)L.c * Bt, qp + (size_t)L.D * Bt,
          qp + (size_t)L.e * Bt, qp + (size_t)L.r0 * Bt, mask, rinfo, pairs,
          dz.p, nullptr, nullptr, scratch + (size_t)F.ip * Bt, sz, b,
          any_active, n_qp, mu0, mu_min, tau, w_max, s_floor, real(0),
          tol_freeze, real(100) * tol_freeze, n_act);
      // A NaN step (failed QP) keeps the previous iterate.
      real acc = real(0);
      for (int f = 0; f < nzT; ++f) acc = acc + dz[f];
      if (acc == acc)
        for (int f = 0; f < nzT; ++f) z[f] = z[f] + dz[f];
      if (track_best) {
        tmpc::merit<real>(o, Pc, xc, zc, T, &mv, &cost, &eq);
        if (mv < best)
          for (int f = 0; f < nzT; ++f) zbest[f] = z[f];
        best = tmpc::nanmin(mv, best);
      }
    }
  }
  const Col<const real>& fin = track_best ? zbc : zc;
  tmpc::merit<real>(o, Pc, xc, fin, T, &mv, &cost, &eq);
  for (int f = 0; f < nzT; ++f) out[(size_t)f * Bt + b] = fin[f];
  out[(size_t)nzT * Bt + b] = cost;
  out[(size_t)(nzT + 1) * Bt + b] = eq;
}

// The linearization alone, at Z: QP fields (L.total, Bt) and
// (merit, cost, eq_res) (3, Bt); with qp null, the merit terms alone.
template <typename real>
__global__ void __launch_bounds__(QP_THREADS)
sqp_fused_linearize_kernel(const real* __restrict__ P,
                           const real* __restrict__ x0,
                           const real* __restrict__ Z, real* __restrict__ qp,
                           real* __restrict__ merit_out,
                           const int* __restrict__ itab,
                           const double* __restrict__ rtab, tmpc::QpLayout L,
                           int Bt_, int reg) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= Bt_) return;
  const size_t Bt = Bt_;
  const tmpc::Ocp o{itab, rtab};
  const Col<const real> Pc{P, Bt, b}, xc{x0, Bt, b}, Zc{Z, Bt, b};
  if (qp != nullptr)
    tmpc::linearize<real>(o, Pc, xc, Zc, Col<real>{qp, Bt, b}, L, reg);
  const Col<real> mo{merit_out, Bt, b};
  tmpc::merit<real>(o, Pc, xc, Zc, L.T, &mo[0], &mo[1], &mo[2]);
}

bool sizes_ok(int Bt, int T, int m, int mh) {
  return Bt >= 1 && T >= 2 && m >= 1 && mh >= 0 && mh <= m;
}

template <typename real>
int launch_solve(const void* P, const void* x0, const void* Z, void* out,
                 void* scratch, const void* mask, const void* rinfo,
                 const void* pairs, const void* itab, const void* rtab,
                 const void* phases, int n_phases, int Bt, int T, int m,
                 int mh, int any_active, int track_best, int reg, double mu0,
                 double mu_min, double tau, double w_max, double s_floor,
                 double tol_freeze, double n_act, void* stream) {
  if (!sizes_ok(Bt, T, m, mh) || n_phases < 1) return -1;
  const FusedLayout F(T, m, mh);
  const Sizes sz{Bt, T, NZ, NX, NU, m, F.L.mhp, NZ, NTRI};
  const int blocks = (Bt + QP_THREADS - 1) / QP_THREADS;
  sqp_fused_kernel<real><<<blocks, QP_THREADS, 0, (cudaStream_t)stream>>>(
      (const real*)P, (const real*)x0, (const real*)Z, (real*)out,
      (real*)scratch, (const real*)mask, (const int*)rinfo, (const int*)pairs,
      (const int*)itab, (const double*)rtab, (const int*)phases, n_phases, F,
      sz, any_active, track_best, reg, real(mu0), real(mu_min), real(tau),
      real(w_max), real(s_floor), real(tol_freeze), real(n_act));
  return (int)cudaGetLastError();
}

template <typename real>
int launch_linearize(const void* P, const void* x0, const void* Z, void* qp,
                     void* merit_out, const void* itab, const void* rtab,
                     int Bt, int T, int m, int mh, int reg, void* stream) {
  if (!sizes_ok(Bt, T, m, mh)) return -1;
  const tmpc::QpLayout L(T, m, mh);
  const int blocks = (Bt + QP_THREADS - 1) / QP_THREADS;
  sqp_fused_linearize_kernel<real>
      <<<blocks, QP_THREADS, 0, (cudaStream_t)stream>>>(
          (const real*)P, (const real*)x0, (const real*)Z, (real*)qp,
          (real*)merit_out, (const int*)itab, (const double*)rtab, L, Bt, reg);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// QpLayout(T, m, mh) as 9 ints: H g A B c D e r0 total.
void tmpc_qp_layout(int T, int m, int mh, int* out) {
  tmpc::QpLayout(T, m, mh).offsets(out);
}

int sqp_fused_scratch_fields(int T, int m, int mh) {
  return FusedLayout(T, m, mh).total;
}

#define SOLVE_ENTRY(NAME, REAL)                                               \
  int NAME(const void* P, const void* x0, const void* Z, void* out,           \
           void* scratch, const void* mask, const void* rinfo,                \
           const void* pairs, const void* itab, const void* rtab,             \
           const void* phases, int n_phases, int Bt, int T, int m, int mh,    \
           int any_active, int track_best, int reg, double mu0,               \
           double mu_min, double tau, double w_max, double s_floor,           \
           double tol_freeze, double n_act, void* stream) {                   \
    return launch_solve<REAL>(P, x0, Z, out, scratch, mask, rinfo, pairs,     \
                              itab, rtab, phases, n_phases, Bt, T, m, mh,     \
                              any_active, track_best, reg, mu0, mu_min, tau,  \
                              w_max, s_floor, tol_freeze, n_act, stream);     \
  }

#define LINEARIZE_ENTRY(NAME, REAL)                                           \
  int NAME(const void* P, const void* x0, const void* Z, void* qp,            \
           void* merit_out, const void* itab, const void* rtab, int Bt,       \
           int T, int m, int mh, int reg, void* stream) {                     \
    return launch_linearize<REAL>(P, x0, Z, qp, merit_out, itab, rtab, Bt, T, \
                                  m, mh, reg, stream);                        \
  }

SOLVE_ENTRY(sqp_fused_solve_f32, float)
SOLVE_ENTRY(sqp_fused_solve_f64, double)
LINEARIZE_ENTRY(sqp_fused_linearize_f32, float)
LINEARIZE_ENTRY(sqp_fused_linearize_f64, double)

}  // extern "C"
