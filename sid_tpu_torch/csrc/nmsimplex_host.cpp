// Host build of nmsimplex.cuh, the nmsimplex2 step machine that the fit's
// kernel (lynch.cu lynch_fit_lanes_kernel) runs, so the CPU tests can drive
// it one evaluation at a time against exact/nmsimplex.py and sid_tpu's
// minimize_nmsimplex2_jax, and hold theta_scalars against the host's logs.
//
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC \
//       -o libnmsimplex_host.so nmsimplex_host.cpp
#include "nmsimplex.cuh"

namespace {

template <int N>
sid::NmState<N>& as(void* state) {
  return *static_cast<sid::NmState<N>*>(state);
}

template <int N>
const sid::NmState<N>& as(const void* state) {
  return *static_cast<const sid::NmState<N>*>(state);
}

}  // namespace

extern "C" {

int sid_nm_state_bytes(int dims) {
  return dims == 1 ? static_cast<int>(sizeof(sid::NmState<1>))
                   : dims == 2 ? static_cast<int>(sizeof(sid::NmState<2>)) : -1;
}

void sid_nm_start(int dims, void* state, const double* x0, const double* step, double tol, int max_iterations,
                  int dot_mode) {
  if (dims == 1) {
    sid::nm_start(as<1>(state), x0, step, tol, max_iterations, dot_mode);
  } else {
    sid::nm_start(as<2>(state), x0, step, tol, max_iterations, dot_mode);
  }
}

// the pending point into x (dims values); returns the phase (5: done)
int sid_nm_pending(int dims, const void* state, double* x) {
  if (dims == 1) {
    x[0] = as<1>(state).xc[0];
    return as<1>(state).phase;
  }
  x[0] = as<2>(state).xc[0];
  x[1] = as<2>(state).xc[1];
  return as<2>(state).phase;
}

void sid_nm_take(int dims, void* state, double val) {
  if (dims == 1) {
    sid::nm_take(as<1>(state), val);
  } else {
    sid::nm_take(as<2>(state), val);
  }
}

// the best corner (dims values), its value, converged and iterations
void sid_nm_result(int dims, const void* state, double* x, double* fval, int* converged, int* iterations) {
  if (dims == 1) {
    const sid::NmState<1>& s = as<1>(state);
    x[0] = s.x1[s.best][0];
    *fval = s.y1[s.best];
    *converged = s.converged;
    *iterations = s.iterations;
    return;
  }
  const sid::NmState<2>& s = as<2>(state);
  x[0] = s.x1[s.best][0];
  x[1] = s.x1[s.best][1];
  *fval = s.y1[s.best];
  *converged = s.converged;
  *iterations = s.iterations;
}

double sid_nm_dot(int dims, const double* a, const double* b, int dot_mode) {
  return dims == 1 ? sid::nm_dot<1>(a, b, dot_mode) : sid::nm_dot<2>(a, b, dot_mode);
}

// theta_scalars over n points (pis[i], epss[i]) into out (n, 5)
void sid_theta_scalars_many(const double* pis, const double* epss, long long n, double* out) {
  for (long long i = 0; i < n; ++i) sid::theta_scalars(pis[i], epss[i], out + 5 * i);
}

}  // extern "C"
