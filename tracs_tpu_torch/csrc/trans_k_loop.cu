// The transmission model's k loop on Hopper (sm_90a): one thread a lane runs
// the lane's recurrence in registers, in float64, to its own exit.
//
// Replaces no Pallas kernel: the JAX package's k loop is XLA code
// (tracs_tpu/models/transcluster.py), and the port ran it as PyTorch
// elementwise operations in blocks of 8, 16, ... 512 steps with the active
// lanes gathered and scattered between blocks
// (models/transcluster.py::_k_loop_blocked, the plain version).  A step there
// is some 75 launches, so a lookup of a few thousand lanes took tens of
// thousands of launches for a few microseconds of card work each.
//
// The recurrence is _k_step_fast's, expression for expression and in the same
// order, so each operation rounds as the plain path's one-operation kernels
// do: every product that feeds a sum is written with __dmul_rn and every sum
// with __dadd_rn / __dsub_rn, which nvcc never contracts into an FMA (the
// shared build flags keep -fmad on for the other kernels); exp, log and log1p
// are the CUDA math library's, as in PyTorch's kernels; the constants
// log(lamb), log(beta), log(lamb + beta) and lamb + beta come from the host,
// computed there as the plain path computes them.  Per step, with M = N + k:
//
//   log_I  <- logaddexp(M log delta - lgamma(M+1) - log lb, log_I - log lb)
//   base    = (N+1) log lamb + k log beta + lgamma(M+1) - lgamma(N+1) - lgamma(k+1)
//   lp, lhs = base - delta beta - log_pois (+ log_I)   where delta > 0
//           = base - (M+1) log lb                      where delta == 0
//   e_sum  += exp(lp + log k)
//   b_sum  += exp(lhs + log k + delta lb - (M+1) log lb)
//   lgamma(M+1), lgamma(k+1), log k by their recurrences (+ log(M+1), + log(k+1))
//
// and the exit is _exit_rule's: the bound test where the bound is usable
// (!(upper 1e-12 >= threshold)), so a NaN bound (delta == 0) exits after k = 1;
// the tiny-term exit (e_sum > 0 and the term <= e_sum 1e-19) where it is not;
// and the k cap.  A lane writes E(K) = e_sum and its exit k (the k after its
// last step).
//
// What bounds it on an H100.  Not bytes (a lane reads 8 doubles and writes 2)
// and not the f64 rate (a lookup of ~3,400 lanes is ~27 blocks of 4 warps, on
// ~27 of the 132 SMs, a warp to each of their schedulers): the time is the
// longest lane's chain of dependent f64 operations, some 250-500 steps of a
// log, two exps and a log1p each, whose latencies the step's branch on the exit
// cannot hide.  So the design keeps that chain short and alone: the lane's
// state lives in registers, there are no blocks of steps, no compaction and
// no host read inside the loop, and all of a lookup's lanes go in one launch.
// The lanes arrive sorted by (delta, N), so the 32 lanes of a warp have close
// exit k and a warp idles little behind its slowest lane.  A block is 128
// threads: small, so more SMs share a lookup's few thousand lanes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// the bound test is skipped where upper * kUnusable >= threshold (the tail
// cannot be resolved below the threshold in f64): _exit_rule's 1e-12
constexpr double kUnusable = 1e-12;
// the tiny-term exit: a term at most kTiny of e_sum adds nothing in f64
constexpr double kTiny = 1e-19;

struct Constants {
  double log_lamb, log_beta, log_lb, lamb_beta, beta, threshold, k_cap;
};

// log(e^a + e^b) by the plain path's _logaddexp: NaN difference (a NaN
// operand, or two infinities of one sign) gives a + b.
__device__ __forceinline__ double logaddexp(double a, double b) {
  const double d = __dsub_rn(a, b);
  if (isnan(d)) return __dadd_rn(a, b);
  return __dadd_rn(a > b ? a : b, log1p(exp(-fabs(d))));
}

__global__ void __launch_bounds__(kThreads)
trans_k_loop_kernel(const double* __restrict__ N, const double* __restrict__ delta,
                    const double* __restrict__ log_delta, const double* __restrict__ log_pois,
                    const double* __restrict__ upper, const double* __restrict__ lg_N1,
                    const double* __restrict__ log_I0, const double* __restrict__ lg_N2,
                    long long m, Constants c, double* __restrict__ e_out,
                    double* __restrict__ k_out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= m) return;
  const double n = N[i], dl = delta[i], ldl = log_delta[i], lpois = log_pois[i];
  const double ub = upper[i], lgn1 = lg_N1[i];
  const bool pos = dl > 0.0;
  const bool usable = !(__dmul_rn(ub, kUnusable) >= c.threshold);
  // the step's terms that do not change with k, rounded as the plain path's
  const double n_term = __dmul_rn(__dadd_rn(n, 1.0), c.log_lamb);
  const double d_beta = __dmul_rn(dl, c.beta);
  const double d_lb = __dmul_rn(dl, c.lamb_beta);

  double k = 1.0, e_sum = 0.0, b_sum = 0.0, log_I = log_I0[i], lg_M1 = lg_N2[i];
  double lg_k1 = 0.0, log_k = 0.0;
  for (;;) {
    const double M = __dadd_rn(n, k);
    const double M1 = __dadd_rn(M, 1.0);
    const double lb_M1 = __dmul_rn(M1, c.log_lb);
    const double log_I_next = logaddexp(
        __dsub_rn(__dsub_rn(__dmul_rn(M, ldl), lg_M1), c.log_lb), __dsub_rn(log_I, c.log_lb));
    const double base = __dsub_rn(
        __dsub_rn(__dadd_rn(__dadd_rn(n_term, __dmul_rn(k, c.log_beta)), lg_M1), lgn1), lg_k1);
    double lp, lhs;
    if (pos) {
      lhs = __dsub_rn(__dsub_rn(base, d_beta), lpois);
      lp = __dadd_rn(lhs, log_I_next);
    } else {
      lp = lhs = __dsub_rn(base, lb_M1);
    }
    const double e_term = exp(__dadd_rn(lp, log_k));
    const double e_next = __dadd_rn(e_sum, e_term);
    const double b_next = __dadd_rn(
        b_sum, exp(__dsub_rn(__dadd_rn(__dadd_rn(lhs, log_k), d_lb), lb_M1)));
    const bool tiny = e_sum > 0.0 && e_term <= __dmul_rn(e_sum, kTiny);
    const double k1 = __dadd_rn(k, 1.0);
    const bool done = (usable && !(__dsub_rn(ub, b_next) > c.threshold)) || k1 >= c.k_cap ||
                      (!usable && tiny);
    const double log_k1 = log(k1);
    k = k1;
    e_sum = e_next;
    b_sum = b_next;
    log_I = log_I_next;
    lg_M1 = __dadd_rn(lg_M1, log(M1));
    lg_k1 = __dadd_rn(lg_k1, log_k1);
    log_k = log_k1;
    if (done) break;
  }
  e_out[i] = e_sum;
  k_out[i] = k;
}

}  // namespace

// The k loop of m lanes on ``stream``: each of the eight inputs is float64
// [m] (N, delta, log delta, the Poisson log-sum, the E(K) bound, lgamma(N+1),
// the seeded log I(N), lgamma(N+2)); writes E(K) and the exit k, float64 [m].
// Returns the CUDA error of the launch (0 when it was accepted).
extern "C" int tracs_trans_k_loop(const void* N, const void* delta, const void* log_delta,
                                  const void* log_pois, const void* upper, const void* lg_N1,
                                  const void* log_I0, const void* lg_N2, long long m,
                                  double log_lamb, double log_beta, double log_lb,
                                  double lamb_beta, double beta, double threshold, double k_cap,
                                  void* e_out, void* k_out, void* stream) {
  if (m < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  const long long blocks = (m + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const Constants c{log_lamb, log_beta, log_lb, lamb_beta, beta, threshold, k_cap};
  trans_k_loop_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(N), static_cast<const double*>(delta),
      static_cast<const double*>(log_delta), static_cast<const double*>(log_pois),
      static_cast<const double*>(upper), static_cast<const double*>(lg_N1),
      static_cast<const double*>(log_I0), static_cast<const double*>(lg_N2), m, c,
      static_cast<double*>(e_out), static_cast<double*>(k_out));
  return static_cast<int>(cudaGetLastError());
}

// The build's facts of the kernel: registers a thread, local memory a thread
// (spills), shared memory a block.
extern "C" int tracs_trans_k_loop_attributes(int* registers, int* local_bytes,
                                             int* shared_bytes) {
  cudaFuncAttributes attr{};
  const cudaError_t rc = cudaFuncGetAttributes(&attr, trans_k_loop_kernel);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *shared_bytes = static_cast<int>(attr.sharedSizeBytes);
  return 0;
}
