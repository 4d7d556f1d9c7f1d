// The nmsimplex2 Nelder-Mead of sid_tpu/ops/nmsimplex.py (B3,
// minimize_nmsimplex2_jax :287, its lean state :244-506) as plain
// __host__ __device__ functions, so the fit's loop runs on the card (the
// last block of lynch.cu's lynch_fit_lanes_kernel advances a lane one
// evaluation) and in a g++ host build (nmsimplex_host.cpp) that the CPU
// tests drive point by point against exact/nmsimplex.py and sid_tpu.
//
// One evaluation at a time: nm_start builds the initial simplex and sets the
// first pending point; nm_take takes the objective's value at the pending
// point and advances to the next one (phase INIT, REFLECT, EXPAND, CONTRACT
// or CONTRACT_ALL) or to DONE, where nm_result reads the best corner. The
// operations, their order and their operands are those of the host loop
// (exact/nmsimplex.py _minimize, the generator that is sid_tpu's NumPy spec
// bitwise): the running center of all corners, the corner moves
// alpha * center + beta * x_corner, GSL's highest / second-highest / lowest
// scan with its quirk, the incremental RMS size, size < tol or
// max_iterations, and numpy's argmin (the first NaN, else the first least
// value). Every operation is one IEEE f64 operation (nvcc --fmad=false, g++
// -ffp-contract=off), but for numpy's dot of two vectors, which BLAS takes:
// dot_mode 1 is the fused sum 0.0 + fma(a1, b1, fma(a0, b0, 0.0)) of
// OpenBLAS's short-vector loop, dot_mode 0 the plain one; the host probes
// which one its numpy takes (exact/nmsimplex.py dot_mode) and passes it in.
//
// theta_scalars computes the five theta-dependent logs of an evaluation
// (ops/likelihoods.py lynch_scalars: log1p(-e), log(e/3),
// log((1 - 2e/3)/2), log1p(-pi), log pi) with the wrappers' conventions; the
// eleven that depend on the base composition stay fixed for a fit.
#pragma once

#include <math.h>
#include <stdint.h>

#ifndef SID_HD
#ifdef __CUDACC__
#define SID_HD __host__ __device__ __forceinline__
#else
#define SID_HD inline
#endif
#endif

namespace sid {

constexpr double kDblMax = 1.7976931348623157e308;

enum NmPhase : int32_t {
  kNmInit = 0,
  kNmReflect = 1,
  kNmExpand = 2,
  kNmContract = 3,
  kNmContractAll = 4,
  kNmDone = 5,
};

// One minimization in N dimensions (N = 2 for (pi, epsilon), 1 for pi at a
// fixed epsilon). xc is the pending point; hi, s_hi and lo are the scan's
// of the current iteration; pend holds the reflection while EXPAND decides;
// idx is the corner INIT and CONTRACT_ALL evaluate.
template <int N>
struct NmState {
  static constexpr int P = N + 1;
  double x1[P][N];
  double y1[P];
  double center[N];
  double s2;
  double xc[N];
  double pend_x[N];
  double pend_val;
  double tol;
  int32_t phase;
  int32_t idx;
  int32_t hi;
  int32_t s_hi;
  int32_t lo;
  int32_t iterations;
  int32_t max_iterations;
  int32_t converged;
  int32_t dot_mode;
  int32_t best;  // numpy's argmin of y1, set at DONE
};

// numpy's dot of two N-vectors: 0.0 + BLAS ddot
template <int N>
SID_HD double nm_dot(const double* a, const double* b, int dot_mode) {
  double d = 0.0;
  for (int j = 0; j < N; ++j) d = dot_mode ? fma(a[j], b[j], d) : d + a[j] * b[j];
  return 0.0 + d;
}

// the center of all corners (summed from 0.0 in corner order, times 1/P)
template <int N>
SID_HD void nm_center(NmState<N>& s) {
  for (int j = 0; j < N; ++j) {
    double c = 0.0;
    for (int i = 0; i < NmState<N>::P; ++i) c = c + s.x1[i][j];
    s.center[j] = c * (1.0 / NmState<N>::P);
  }
}

// the mean squared corner-to-center distance into s2, each corner's
// distance rooted and squared (GSL's order); returns the size sqrt(s2)
template <int N>
SID_HD double nm_size(NmState<N>& s) {
  double ss = 0.0;
  for (int i = 0; i < NmState<N>::P; ++i) {
    double d[N];
    for (int j = 0; j < N; ++j) d[j] = s.x1[i][j] - s.center[j];
    const double t = sqrt(nm_dot<N>(d, d, s.dot_mode));
    ss = ss + t * t;
  }
  s.s2 = ss / NmState<N>::P;
  return sqrt(s.s2);
}

// xc = alpha center + beta x_corner, alpha = (1 - coeff) P / (P - 1),
// beta = (coeff P - 1) / (P - 1)
template <int N>
SID_HD void nm_corner_move(NmState<N>& s, double coeff, int corner) {
  constexpr int P = NmState<N>::P;
  const double alpha = (1.0 - coeff) * P / (P - 1.0);
  const double beta = (coeff * P - 1.0) / (P - 1.0);
  for (int j = 0; j < N; ++j) s.xc[j] = alpha * s.center[j] + beta * s.x1[corner][j];
}

// corner i moves to x with value val: the size and the center updated
// incrementally
template <int N>
SID_HD void nm_update_point(NmState<N>& s, int i, const double* x_in, double val) {
  constexpr int P = NmState<N>::P;
  double x[N], delta[N], xmc[N];
  for (int j = 0; j < N; ++j) {
    x[j] = x_in[j];
    delta[j] = x[j] - s.x1[i][j];
    xmc[j] = s.x1[i][j] - s.center[j];
  }
  const double d = sqrt(nm_dot<N>(delta, delta, s.dot_mode));
  const double xmcd = nm_dot<N>(xmc, delta, s.dot_mode);
  s.s2 = s.s2 + ((2.0 / P) * xmcd + ((P - 1.0) / P) * (d * d / P));
  for (int j = 0; j < N; ++j) {
    s.center[j] = (s.center[j] - (1.0 / P) * s.x1[i][j]) + (1.0 / P) * x[j];
    s.x1[i][j] = x[j];
  }
  s.y1[i] = val;
}

SID_HD bool nm_finite(double v) { return isfinite(v); }

// numpy's argmin: the first NaN, else the first least value
template <int N>
SID_HD int nm_argmin(const NmState<N>& s) {
  int best = 0;
  for (int i = 1; i < NmState<N>::P; ++i) {
    if (s.y1[best] != s.y1[best]) break;
    if (s.y1[i] != s.y1[i] || s.y1[i] < s.y1[best]) best = i;
  }
  return best;
}

template <int N>
SID_HD void nm_finish(NmState<N>& s) {
  s.best = nm_argmin(s);
  s.phase = kNmDone;
}

// the start of an iteration, or DONE at max_iterations: count it, scan the
// corners (GSL's quirk: dhi and dlo start at y[0], ds_hi at y[1], the scan
// from 1), set the reflection of the highest corner pending
template <int N>
SID_HD void nm_begin_iteration(NmState<N>& s) {
  if (s.iterations >= s.max_iterations) {
    nm_finish(s);
    return;
  }
  s.iterations = s.iterations + 1;
  double dhi = s.y1[0];
  double dlo = s.y1[0];
  int hi = 0;
  int lo = 0;
  double ds_hi = s.y1[1];
  int s_hi = 1;
  for (int i = 1; i < NmState<N>::P; ++i) {
    const double val = s.y1[i];
    if (val < dlo) {
      dlo = val;
      lo = i;
    } else if (val > dhi) {
      ds_hi = dhi;
      s_hi = hi;
      dhi = val;
      hi = i;
    } else if (val > ds_hi) {
      ds_hi = val;
      s_hi = i;
    }
  }
  s.hi = hi;
  s.s_hi = s_hi;
  s.lo = lo;
  nm_corner_move(s, -1.0, hi);
  s.phase = kNmReflect;
}

// the end of an iteration: the size test, then the next iteration
template <int N>
SID_HD void nm_end_iteration(NmState<N>& s) {
  const double size = s.s2 > 0 ? sqrt(s.s2) : nm_size(s);
  if (size < s.tol) {
    s.converged = 1;
    nm_finish(s);
    return;
  }
  nm_begin_iteration(s);
}

// the simplex x0, x0 + step_i e_i, its first corner pending
template <int N>
SID_HD void nm_start(NmState<N>& s, const double* x0, const double* step, double tol, int max_iterations,
                     int dot_mode) {
  for (int i = 0; i < NmState<N>::P; ++i) {
    for (int j = 0; j < N; ++j) s.x1[i][j] = x0[j];
    s.y1[i] = 0.0;
  }
  for (int i = 0; i < N; ++i) s.x1[i + 1][i] = x0[i] + step[i];
  for (int j = 0; j < N; ++j) {
    s.center[j] = 0.0;
    s.pend_x[j] = 0.0;
    s.xc[j] = s.x1[0][j];
  }
  s.s2 = 0.0;
  s.pend_val = 0.0;
  s.tol = tol;
  s.phase = kNmInit;
  s.idx = 0;
  s.hi = s.s_hi = s.lo = 0;
  s.iterations = 0;
  s.max_iterations = max_iterations;
  s.converged = 0;
  s.dot_mode = dot_mode;
  s.best = 0;
}

// the next corner of CONTRACT_ALL after idx (skipping the best), moved
// halfway to the best and pending; false past the last
template <int N>
SID_HD bool nm_next_shrunk(NmState<N>& s, int from) {
  int i = from;
  if (i == s.lo) ++i;
  if (i >= NmState<N>::P) return false;
  for (int j = 0; j < N; ++j) {
    s.x1[i][j] = 0.5 * (s.x1[i][j] + s.x1[s.lo][j]);
    s.xc[j] = s.x1[i][j];
  }
  s.idx = i;
  return true;
}

// The objective's value at the pending point: advance to the next pending
// point, or to DONE.
template <int N>
SID_HD void nm_take(NmState<N>& s, double val) {
  constexpr int P = NmState<N>::P;
  switch (s.phase) {
    case kNmInit:
      s.y1[s.idx] = val;
      s.idx = s.idx + 1;
      if (s.idx < P) {
        for (int j = 0; j < N; ++j) s.xc[j] = s.x1[s.idx][j];
        return;
      }
      nm_center(s);
      nm_size(s);
      nm_begin_iteration(s);
      return;
    case kNmReflect:
      if (nm_finite(val) && val < s.y1[s.lo]) {
        // a new best: try the expansion
        for (int j = 0; j < N; ++j) s.pend_x[j] = s.xc[j];
        s.pend_val = val;
        nm_corner_move(s, -2.0, s.hi);
        s.phase = kNmExpand;
        return;
      }
      if (!nm_finite(val) || val > s.y1[s.s_hi]) {
        // not good enough: keep it if it beats the highest, then contract
        if (nm_finite(val) && val <= s.y1[s.hi]) nm_update_point(s, s.hi, s.xc, val);
        nm_corner_move(s, 0.5, s.hi);
        s.phase = kNmContract;
        return;
      }
      nm_update_point(s, s.hi, s.xc, val);
      nm_end_iteration(s);
      return;
    case kNmExpand:
      if (nm_finite(val) && val < s.y1[s.lo]) {
        nm_update_point(s, s.hi, s.xc, val);
      } else {
        nm_update_point(s, s.hi, s.pend_x, s.pend_val);
      }
      nm_end_iteration(s);
      return;
    case kNmContract:
      if (nm_finite(val) && val <= s.y1[s.hi]) {
        nm_update_point(s, s.hi, s.xc, val);
        nm_end_iteration(s);
        return;
      }
      // contract every corner but the best toward it, one per evaluation
      nm_next_shrunk(s, 0);
      s.phase = kNmContractAll;
      return;
    case kNmContractAll:
      s.y1[s.idx] = val;
      if (nm_next_shrunk(s, s.idx + 1)) return;
      nm_center(s);
      nm_size(s);
      nm_end_iteration(s);
      return;
    default:
      return;
  }
}

// The five theta-dependent scalars of an evaluation at (pi, eps) in the
// box, into out[0..4] (csrc/lynch.cuh LynchScalars): log1p(-e), log(e/3),
// log((1 - 2/3 e)/2), log1p(-pi), log pi; a log of 0 is -inf, of a negative
// NaN (ops/likelihoods.py _glibc_log, _glibc_log1p).
SID_HD double theta_log(double x) {
  if (x > 0) return log(x);
  return x == 0 ? -INFINITY : NAN;
}

SID_HD double theta_log1p(double x) {
  if (x > -1) return log1p(x);
  return x == -1 ? -INFINITY : NAN;
}

SID_HD void theta_scalars(double pi, double eps, double* out) {
  out[0] = theta_log1p(-eps);
  out[1] = theta_log(eps / 3.0);
  out[2] = theta_log((1.0 - 2.0 / 3.0 * eps) / 2.0);
  out[3] = theta_log1p(-pi);
  out[4] = theta_log(pi);
}

// theta's place: inside the box [0, 1]^2 (NaN is outside)
SID_HD bool theta_in_box(double pi, double eps) {
  return pi >= 0.0 && pi <= 1.0 && eps >= 0.0 && eps <= 1.0;
}

}  // namespace sid
