// A population of reduced flight-sim shots -- R/Z/beta plant, two PID loops,
// safety envelope -- for every tick in ONE launch.
//
// Replaces no Pallas kernel: scpn_fusion_tpu/control/flight_sim.py:114-192
// (run_shot_reduced_gains, one lax.scan, vmapped over a population of gains
// by control/tuning.py:61) and the tick of control/stress.py:77-128 (the same
// plant and PID without the delay line, plus ELM kicks, a ramp drift and
// sensor noise, vmapped over 1000 shots).  JAX runs each as one compiled
// program; eager PyTorch runs a tick as ~60 small launches over the
// population (the plain version: the batched tick loop of
// ops/cuda_reduced_shot.py:reduced_shot_plain); this kernel is the one
// program again.
//
// Design: one thread a shot, the tick loop inside the kernel, the whole state
// (r, z, beta, heating, two PID states, two enforced commands, the actuator
// delay line) in registers.  The delay line is a FIFO of at most MAX_DELAY
// values a channel, shifted with fully unrolled predicated moves so that it
// stays in registers.  Each tick reads the schedule (heating request, ramp
// drift: the same address for every thread) and, in the stress variant, the
// shot's four draws (u, ELM amplitude, two sensor-noise normals), laid out
// tick-major (n, P, 4); it writes r and z (and beta and heating in the
// reduced variant) tick-major (n, P), so a warp's loads and stores coalesce.
// The next tick's draws are loaded before the current tick's arithmetic.  No
// shared memory and no barriers.
//
// Arithmetic: every product, sum and difference is rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn and the double forms), in the plain
// version's association order, so that the kernel equals the plain loop bit
// for bit.  Constants arrive as doubles computed on the host as the plain
// code computes them, and are cast to T as PyTorch casts a Python scalar.
// Clamps are torch.clamp's: a NaN operand, then a NaN bound, passes
// through, else fmin(fmax(x, lo), hi).  The PID keeps its isfinite guards
// (control/pid.py).
//
// What bounds it on an H100: the draws read and the traces written (for 1000
// shots x 10,000 ticks in float32, 160 MB in and 80 MB out: ~0.07 ms at
// 3.35 TB/s).  A shot is a dependent chain of ~70 rounded operations a tick,
// so the latency of that chain times the ticks, not the bytes, sets the time:
// a few milliseconds a launch.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_DELAY = 8;

struct ReducedShotArgs {
  const void* gains;        // (P or 1, 6): kp, ki, kd of R, then of Z, scaled to dt
  const void* heating_req;  // (n,) the heating request of each tick
  const void* drift;        // (n,) the ramp drift of each tick (stress variant)
  const void* draws;        // (n, P, 4): u, ELM amplitude, noise R, noise Z (stress)
  void* trace_r;            // (n, P)
  void* trace_z;            // (n, P)
  void* trace_beta;         // (n, P), reduced variant only
  void* trace_heating;      // (n, P), reduced variant only
  int n_shots, n_ticks;
  int gain_stride;          // 6, or 0 for one set of gains for every shot
  int n_delay;              // actuator delay in ticks, <= MAX_DELAY (reduced variant)
  int stress;               // 0 reduced variant, 1 stress variant
  double dt, target_r, target_z, r0, z0, beta0, heating0;
  double heat_slew, heat_max;   // heating_rate_limit * dt, heating_abs_max
  double pf_slew, pf_max;       // pf_rate_limit * dt, pf_abs_max
  double z_step;                // 0.02 * dt
  double p_elm, elm_kick, sensor_noise;   // stress variant
};

template <typename T> struct Arith;

template <> struct Arith<float> {
  static __device__ __forceinline__ float mul(float x, float y) { return __fmul_rn(x, y); }
  static __device__ __forceinline__ float add(float x, float y) { return __fadd_rn(x, y); }
  static __device__ __forceinline__ float sub(float x, float y) { return __fsub_rn(x, y); }
  static __device__ __forceinline__ float lo_hi(float x, float lo, float hi) {
    return fminf(fmaxf(x, lo), hi);
  }
};

template <> struct Arith<double> {
  static __device__ __forceinline__ double mul(double x, double y) { return __dmul_rn(x, y); }
  static __device__ __forceinline__ double add(double x, double y) { return __dadd_rn(x, y); }
  static __device__ __forceinline__ double sub(double x, double y) { return __dsub_rn(x, y); }
  static __device__ __forceinline__ double lo_hi(double x, double lo, double hi) {
    return fmin(fmax(x, lo), hi);
  }
};

// torch.clamp: a NaN input, then a NaN bound, is the result
template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {
  if (x != x) return x;
  if (lo != lo) return lo;
  if (hi != hi) return hi;
  return Arith<T>::lo_hi(x, lo, hi);
}

// _envelope: slew limit around prev, then the absolute limit
template <typename T>
__device__ __forceinline__ T envelope(T req, T prev, T slew, T abs_max) {
  using A = Arith<T>;
  return clip(clip(req, A::sub(prev, slew), A::add(prev, slew)), -abs_max, abs_max);
}

// control/pid.py:pid_step
template <typename T>
__device__ __forceinline__ T pid(T kp, T ki, T kd, T& err_sum, T& last_err, T error) {
  using A = Arith<T>;
  const bool ok = isfinite(error);
  const T err = ok ? error : T(0);
  const T sum = A::add(err_sum, err);
  const T d_err = A::sub(err, last_err);
  const T cmd = A::add(A::add(A::mul(kp, err), A::mul(ki, sum)), A::mul(kd, d_err));
  if (ok) {
    err_sum = sum;
    last_err = err;
  }
  return ok ? cmd : T(0);
}

// The actuator delay line: returns the command of n_delay ticks ago (0 before
// the first n_delay ticks) and pushes v.
template <typename T>
__device__ __forceinline__ T delay_line(T (&fifo)[MAX_DELAY + 1], int n_delay, T v) {
  const T out = n_delay > 0 ? fifo[0] : v;
#pragma unroll
  for (int i = 0; i < MAX_DELAY; ++i) {
    if (i < n_delay) fifo[i] = (i + 1 < n_delay) ? fifo[i + 1] : v;
  }
  return out;
}

template <typename T>
__global__ void reduced_shot_kernel(const ReducedShotArgs a) {
  using A = Arith<T>;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= a.n_shots) return;
  const long long n_shots = a.n_shots;

  const T* g = static_cast<const T*>(a.gains) + static_cast<long long>(p) * a.gain_stride;
  const T kp_r = g[0], ki_r = g[1], kd_r = g[2], kp_z = g[3], ki_z = g[4], kd_z = g[5];
  const T* heating_req = static_cast<const T*>(a.heating_req);
  const T* drift = static_cast<const T*>(a.drift);
  const T* draws = static_cast<const T*>(a.draws);
  T* tr_r = static_cast<T*>(a.trace_r);
  T* tr_z = static_cast<T*>(a.trace_z);
  T* tr_beta = static_cast<T*>(a.trace_beta);
  T* tr_heat = static_cast<T*>(a.trace_heating);

  const T dt = T(a.dt), target_r = T(a.target_r), target_z = T(a.target_z);
  const T heat_slew = T(a.heat_slew), heat_max = T(a.heat_max);
  const T pf_slew = T(a.pf_slew), pf_max = T(a.pf_max), z_step = T(a.z_step);
  const T p_elm = T(a.p_elm), elm_kick = T(a.elm_kick), sensor_noise = T(a.sensor_noise);
  const T c_beta0 = T(0.6), c_beta1 = T(0.03), c_half = T(0.5), c_drift = T(0.01);
  const T beta_lo = T(0.2), beta_hi = T(10.0), r_lo = T(2.0), r_hi = T(10.0);
  const T z_lim = T(6.0);

  T r = T(a.r0), z = T(a.z0), beta = T(a.beta0), heat = T(a.heating0);
  T sum_r = T(0), last_r = T(0), sum_z = T(0), last_z = T(0);
  T pf_r = T(0), pf_z = T(0);
  T fifo_r[MAX_DELAY + 1], fifo_z[MAX_DELAY + 1];
#pragma unroll
  for (int i = 0; i <= MAX_DELAY; ++i) {
    fifo_r[i] = T(0);
    fifo_z[i] = T(0);
  }

  T d_u = T(0), d_elm = T(0), d_nr = T(0), d_nz = T(0);
  if (a.stress) {
    const T* d0 = draws + static_cast<long long>(p) * 4;
    d_u = d0[0];
    d_elm = d0[1];
    d_nr = d0[2];
    d_nz = d0[3];
  }

  for (int k = 0; k < a.n_ticks; ++k) {
    const long long at = static_cast<long long>(k) * n_shots + p;
    // 1. plant: heating through its envelope, beta relaxing toward its target
    heat = envelope(heating_req[k], heat, heat_slew, heat_max);
    heat = clip(heat, T(0), heat_max);
    const T beta_t = A::add(A::mul(heat, c_beta1), c_beta0);
    beta = clip(A::add(beta, A::mul(A::mul(A::sub(beta_t, beta), c_half), dt)), beta_lo,
                beta_hi);
    if (a.stress) {
      const T u = d_u, amp = d_elm, nr = d_nr, nz = d_nz;
      if (k + 1 < a.n_ticks) {   // the next tick's draws, ahead of this tick's arithmetic
        const T* dn = draws + (at + n_shots) * 4;
        d_u = dn[0];
        d_elm = dn[1];
        d_nr = dn[2];
        d_nz = dn[3];
      }
      const T flag = u < p_elm ? T(1) : T(0);
      const T elm = A::mul(A::mul(flag, elm_kick), amp);
      r = clip(A::add(A::add(r, A::mul(A::add(A::mul(beta, c_drift), drift[k]), dt)), elm),
               r_lo, r_hi);
      z = clip(A::add(A::add(z, z_step), A::mul(elm, c_half)), -z_lim, z_lim);
      // 2. control on noisy measurements, 3. enforcement, 4. apply
      const T cmd_r = pid(kp_r, ki_r, kd_r, sum_r, last_r,
                          A::sub(target_r, A::add(r, A::mul(nr, sensor_noise))));
      const T cmd_z = pid(kp_z, ki_z, kd_z, sum_z, last_z,
                          A::sub(target_z, A::add(z, A::mul(nz, sensor_noise))));
      pf_r = envelope(cmd_r, pf_r, pf_slew, pf_max);
      pf_z = envelope(cmd_z, pf_z, pf_slew, pf_max);
      r = clip(A::add(r, A::mul(pf_r, dt)), r_lo, r_hi);
      z = clip(A::add(z, A::mul(pf_z, dt)), -z_lim, z_lim);
    } else {
      r = clip(A::add(r, A::mul(A::mul(beta, c_drift), dt)), r_lo, r_hi);
      z = clip(A::add(z, z_step), -z_lim, z_lim);
      // 2. control, 2b. enforcement, 3. the delay line, 4. apply
      const T cmd_r = pid(kp_r, ki_r, kd_r, sum_r, last_r, A::sub(target_r, r));
      const T cmd_z = pid(kp_z, ki_z, kd_z, sum_z, last_z, A::sub(target_z, z));
      pf_r = envelope(cmd_r, pf_r, pf_slew, pf_max);
      pf_z = envelope(cmd_z, pf_z, pf_slew, pf_max);
      const T applied_r = delay_line(fifo_r, a.n_delay, pf_r);
      const T applied_z = delay_line(fifo_z, a.n_delay, pf_z);
      r = clip(A::add(r, A::mul(applied_r, dt)), r_lo, r_hi);
      z = clip(A::add(z, A::mul(applied_z, dt)), -z_lim, z_lim);
      tr_beta[at] = beta;
      tr_heat[at] = heat;
    }
    tr_r[at] = r;
    tr_z[at] = z;
  }
}

template <typename T>
int launch_reduced_shot(const ReducedShotArgs* args, void* stream) {
  if (args->n_delay < 0 || args->n_delay > MAX_DELAY) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = 128;
  const int blocks = (args->n_shots + threads - 1) / threads;
  reduced_shot_kernel<T><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int scpn_reduced_shot_f32(const void* args, void* stream) {
  return launch_reduced_shot<float>(static_cast<const ReducedShotArgs*>(args), stream);
}

extern "C" int scpn_reduced_shot_f64(const void* args, void* stream) {
  return launch_reduced_shot<double>(static_cast<const ReducedShotArgs*>(args), stream);
}
