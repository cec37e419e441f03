// The disturbance-rejection ladder's linear controllers -- PID, the H-inf
// observer controller and the DARE-LQR (MPC) law -- closed around the
// linearised vertical-stability plant, every lane in ONE launch.
//
// Replaces no Pallas kernel: scpn_fusion_tpu/control/disturbance_ladder.py:
// _run_loop (:92-113) is one lax.scan of a controller step (run_pid :116-131,
// run_hinf :136-168 with control/hinf.py:hinf_step :116-132, run_mpc
// :192-208) and the plant's Euler step, a single compiled XLA program with no
// host round-trip a tick.  Eager PyTorch runs a tick as ~60 small launches
// (the plain version: ops/cuda_ladder.py:ladder_plain, the batched tick
// loop); this kernel is the one program again.
//
// Design: one thread a lane (a controller on a scenario; the ladder has
// nine), each lane in a warp (a block) of its own, since the three
// controllers branch apart every tick; each lane with its own tick count (20,000, 40,000 or 30,000 at
// dt = 1e-4).  The plant state [z, dz/dt] and the controller's state (PID:
// integral and last z; H-inf: the observer's x_hat; MPC: last z) live in
// registers and the tick loop runs inside the kernel.  Each tick takes the
// lane's disturbance d(t), loaded CHUNK ticks ahead into registers (a load
// a tick on the chain would cost its latency every tick), and writes the z
// the controller saw and the clipped command u; the metrics (ISE, settling,
// overshoot, effort) stay PyTorch on those traces.
//
// Arithmetic: every product, sum, difference and quotient is rounded on its
// own (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn and the double forms)
// in the plain code's order, the 2x2 products spelled out as
// (a00 x0 + a01 x1), so that the kernel equals the plain loop bit for bit.
// Constants arrive as doubles and are cast to T as PyTorch casts a Python
// scalar; the per-lane gains arrive in T.  Clamps are torch.clamp's (a NaN
// operand, then a NaN bound, passes through; else max then min).
//
// What bounds it on an H100: the bytes are the disturbance traces read and
// the z and u traces written (90,000 ticks x 3 values x 3 controllers: ~3 MB
// in float32, ~1 us at 3.35 TB/s).  A lane is a dependent chain of ~30
// rounded operations a tick (one an IEEE division) over up to 40,000 ticks,
// and the nine lanes run side by side on nine SMs: the latency of that chain
// (~4 cycles an operation, ~5 million cycles, ~2.6 ms at 1.98 GHz), not the
// bytes, sets the time; the ticks of a lane are a recurrence.  So no load
// may sit on the chain: a global load costs its latency (~0.5 us) every
// tick.  The gains go to registers once and the disturbance CHUNK ticks ahead.

#include <cuda_runtime.h>

namespace {

constexpr int N_PARAMS = 16;   // ops/cuda_ladder.py:N_PARAMS
constexpr int CHUNK = 8;       // ticks of disturbance a thread holds ahead
enum Kind { PID = 0, HINF = 1, MPC = 2 };

struct LadderArgs {
  const void* params;          // (L, N_PARAMS) the lane's gains, in T
  const void* x0;              // (L, 2) the initial plant state
  const void* plant;           // (8,) a00 a01 a10 a11 b0 b1 bd0 bd1, in T
  const void* d;               // the disturbance traces, packed
  const long long* d_off;      // (L,) offset of the lane's trace in d
  const long long* out_off;    // (L,) offset of the lane's traces in trace_z / trace_u
  const int* kind;             // (L,) Kind
  const int* n_ticks;          // (L,)
  void* trace_z;               // packed: z seen by the controller each tick
  void* trace_u;               // packed: the clipped command each tick
  int n_lanes;
  double dt;                   // the plant's (and PID / MPC's) step
  double u_max;                // the loop's command clip
  double integ_max;            // the PID's anti-windup clip
};

template <typename T> struct Arith;

template <> struct Arith<float> {
  static __device__ __forceinline__ float mul(float x, float y) { return __fmul_rn(x, y); }
  static __device__ __forceinline__ float add(float x, float y) { return __fadd_rn(x, y); }
  static __device__ __forceinline__ float sub(float x, float y) { return __fsub_rn(x, y); }
  static __device__ __forceinline__ float div(float x, float y) { return __fdiv_rn(x, y); }
  static __device__ __forceinline__ float lo_hi(float x, float lo, float hi) {
    return fminf(fmaxf(x, lo), hi);
  }
};

template <> struct Arith<double> {
  static __device__ __forceinline__ double mul(double x, double y) { return __dmul_rn(x, y); }
  static __device__ __forceinline__ double add(double x, double y) { return __dadd_rn(x, y); }
  static __device__ __forceinline__ double sub(double x, double y) { return __dsub_rn(x, y); }
  static __device__ __forceinline__ double div(double x, double y) { return __ddiv_rn(x, y); }
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

template <typename T>
__global__ void ladder_kernel(const LadderArgs a) {
  using A = Arith<T>;
  // one warp a lane, its first thread working: the lanes' controllers take
  // different branches, which one warp would run one after another each tick
  const int lane = blockIdx.x;
  if (threadIdx.x != 0 || lane >= a.n_lanes) return;

  // the lane's gains in registers: read through the pointer, each tick would
  // reload them after the trace stores (which may alias), on the chain
  const T* g_p = static_cast<const T*>(a.params) + static_cast<long long>(lane) * N_PARAMS;
  T p[14];
#pragma unroll
  for (int j = 0; j < 14; ++j) p[j] = g_p[j];
  const T* pl = static_cast<const T*>(a.plant);
  const T a00 = pl[0], a01 = pl[1], a10 = pl[2], a11 = pl[3];
  const T b0 = pl[4], b1 = pl[5], bd0 = pl[6], bd1 = pl[7];
  const T dt = T(a.dt), u_max = T(a.u_max), integ_max = T(a.integ_max);
  const int kind = a.kind[lane];
  const int n = a.n_ticks[lane];
  const T* d = static_cast<const T*>(a.d) + a.d_off[lane];
  T* tr_z = static_cast<T*>(a.trace_z) + a.out_off[lane];
  T* tr_u = static_cast<T*>(a.trace_u) + a.out_off[lane];

  const T* x_init = static_cast<const T*>(a.x0) + 2LL * lane;
  T x0 = x_init[0], x1 = x_init[1];
  // controller state: PID (integral s0, last z s1); H-inf (x_hat s0, s1);
  // MPC (last z s1)
  T s0 = T(0), s1 = T(0);

  // the disturbance runs CHUNK ticks ahead in registers: the loads of the
  // next chunk are in flight while this chunk's ticks run
  T cur[CHUNK], nxt[CHUNK];
#pragma unroll
  for (int j = 0; j < CHUNK; ++j) cur[j] = j < n ? d[j] : T(0);
  for (int k0 = 0; k0 < n; k0 += CHUNK) {
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) nxt[j] = k0 + CHUNK + j < n ? d[k0 + CHUNK + j] : T(0);
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const int k = k0 + j;
      if (k >= n) break;
      const T z = x0;
      T u;
      if (kind == PID) {             // p: kp, ki, kd
        const T err = -z;
        s0 = clip(A::add(s0, A::mul(err, dt)), -integ_max, integ_max);
        const T deriv = A::div(-A::sub(z, s1), dt);
        u = A::add(A::add(A::mul(p[0], err), A::mul(p[1], s0)), A::mul(p[2], deriv));
        s1 = z;
      } else if (kind == HINF) {     // p: f0 f1 l0 l1 a00 a01 a10 a11 b2_0 b2_1 c0 c1 dt u_max
        const T uh = clip(A::add(A::mul(p[0], s0), A::mul(p[1], s1)), -p[13], p[13]);
        const T innov = A::sub(z, A::add(A::mul(p[10], s0), A::mul(p[11], s1)));
        const T dx0 = A::add(A::add(A::add(A::mul(p[4], s0), A::mul(p[5], s1)),
                                    A::mul(p[8], uh)), A::mul(p[2], innov));
        const T dx1 = A::add(A::add(A::add(A::mul(p[6], s0), A::mul(p[7], s1)),
                                    A::mul(p[9], uh)), A::mul(p[3], innov));
        s0 = A::add(s0, A::mul(p[12], dx0));
        s1 = A::add(s1, A::mul(p[12], dx1));
        u = uh;
      } else {                       // MPC, p: k0 k1
        const T dz = A::div(A::sub(z, s1), dt);
        u = -A::add(A::mul(p[0], z), A::mul(p[1], dz));
        s1 = z;
      }
      u = clip(u, -u_max, u_max);
      const T dk = cur[j];
      const T dx0 = A::add(A::add(A::add(A::mul(a00, x0), A::mul(a01, x1)), A::mul(b0, u)),
                           A::mul(bd0, dk));
      const T dx1 = A::add(A::add(A::add(A::mul(a10, x0), A::mul(a11, x1)), A::mul(b1, u)),
                           A::mul(bd1, dk));
      tr_z[k] = z;
      tr_u[k] = u;
      x0 = A::add(x0, A::mul(dt, dx0));
      x1 = A::add(x1, A::mul(dt, dx1));
    }
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) cur[j] = nxt[j];
  }
}

template <typename T>
int launch_ladder(const LadderArgs* args, void* stream) {
  if (args->n_lanes < 1) return static_cast<int>(cudaErrorInvalidValue);
  ladder_kernel<T><<<args->n_lanes, 32, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int scpn_ladder_f32(const void* args, void* stream) {
  return launch_ladder<float>(static_cast<const LadderArgs*>(args), stream);
}

extern "C" int scpn_ladder_f64(const void* args, void* stream) {
  return launch_ladder<double>(static_cast<const LadderArgs*>(args), stream);
}
