// Host build of tmpc_ocp.cuh (the in-kernel linearization of the fused SQP
// kernel), compiled with a plain C++ compiler so that the CPU tests can hold
// the header's derivatives against torch.func and JAX without a card.
//
//   g++ -std=c++17 -O2 -shared -fPIC -o libtmpc_ocp_host.so tmpc_ocp_host.cpp
//
// ops/sqp_fused.py::host_linearize builds and calls it. Arrays are
// field-major (fields, Bt), as in the kernel.

#include "tmpc_ocp.cuh"

extern "C" {

// QpLayout(T, m, mh) as 9 ints: H g A B c D e r0 total.
void tmpc_qp_layout(int T, int m, int mh, int* out) {
  tmpc::QpLayout(T, m, mh).offsets(out);
}

// Linearize every problem at Z: the QP fields into qp (L.total, Bt) and
// (merit, cost, eq_res) into merit_out (3, Bt).
void tmpc_host_linearize_f64(const double* P, const double* x0,
                             const double* Z, double* qp, double* merit_out,
                             const int* itab, const double* rtab, int Bt,
                             int T, int m, int mh, int reg) {
  const tmpc::Ocp o{itab, rtab};
  const tmpc::QpLayout L(T, m, mh);
  for (int b = 0; b < Bt; ++b) {
    const tmpc::Col<const double> Pc{P, (size_t)Bt, b}, xc{x0, (size_t)Bt, b},
        Zc{Z, (size_t)Bt, b};
    tmpc::linearize<double>(o, Pc, xc, Zc, tmpc::Col<double>{qp, (size_t)Bt, b},
                            L, reg);
    const tmpc::Col<double> mo{merit_out, (size_t)Bt, b};
    tmpc::merit<double>(o, Pc, xc, Zc, T, &mo[0], &mo[1], &mo[2]);
  }
}

}  // extern "C"
