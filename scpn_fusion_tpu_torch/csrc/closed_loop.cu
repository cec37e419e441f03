// The SCPN neuro-symbolic closed loop -- controller tick + a reduced plant
// -- for a whole shot in ONE launch.
//
// Replaces no Pallas kernel: scpn_fusion_tpu/control/neuro_closed_loop.py:
// run_neuro_closed_loop is one lax.scan of scpn/controller.py:controller_step
// and reduced_plant_step, a single compiled XLA program with no host
// round-trip a tick.  Eager PyTorch runs a tick as ~40-60 small launches
// (the plain version: the per-tick loop of the port's controller_step and
// reduced_plant_step); this kernel is the one program again.
//
// Design: one CTA a shot, one thread a place / transition / injection /
// action (at most 1024 of each).  The net's dense matrices, the marking, the
// firing vector and the delay ring live in shared memory; the plant state
// and the ring's cursor live in every thread's registers.  The tick loop
// runs inside the kernel, four stages a tick separated by __syncthreads():
//   1. features + injection: thread i < nI writes m[inj_place[i]];
//   2. transition j: a_j = sum_p w_in[j,p] m_p, the firing probability
//      (fractional / binary with margin / hard binary), the delay ring
//      (thread j owns column j of the ring), f_timed_j;
//   3. place p: m_p = clip(m_p - sum_j w_in[j,p] f_j + sum_j w_out[p,j] f_j);
//   4. action i: gain (m[pos] - m[neg]), slew clamp, absolute clamp;
// then every thread advances the plant itself (the same arithmetic in each,
// so no fifth barrier) and thread 0 writes the tick's plant trace.  Four
// plant kinds:
//   0. the reduced R/Z plant (actions 0 and 1 move r and z; the trace holds
//      r and z after the tick);
//   1. the linear vertical plant of control/disturbance_ladder.py (x = [z,
//      dz/dt], dx/dt = A x + B u + B_d d, one Euler step a tick; the one
//      action, clipped to +-u_max, is u; the observed axis is z; the trace
//      holds the z seen and the clipped u; the disturbance d is read each
//      tick);
//   2. the 0-D density model of control/fueling_torax.py:run_fueling_mode
//      (state: density and the PI integral; the observation is the density
//      error mapped onto the axis channel, 6.2 - 0.25 clip(error, -1, 1);
//      error and integral are formed before stage 1 and used after stage 4
//      by the PI path, the gate and the density update; the trace holds
//      density, command and error);
//   3. the reduced TORAX-style plant of run_torax_hybrid_campaign (state:
//      beta_N, q95, li3, W_th; the policy head, the SCPN corrector on the
//      beta_N error channel, a disturbance and two noise draws a tick read
//      from the inputs; the trace holds beta_N, q95 and the risk signal).
//      Kind 3 runs one episode a CTA: blockIdx.x offsets every per-shot
//      pointer (controller state, plant, traces, disturbance, noise).  Kinds
//      0-2 launch one CTA, so their offsets are 0.
// Only deterministic configurations come here: the wrapper
// (ops/cuda_closed_loop.py) raises on one that draws random numbers.
//
// Arithmetic: every product, sum and quotient is rounded on its own
// (__fmul_rn / __fadd_rn / __fdiv_rn and the double forms), as PyTorch's
// separate elementwise ops are; sums over places and transitions run in
// index order.  Clamps are max-then-min, as jnp.clip and torch.clamp.
//
// What bounds it on an H100: the traces (a few hundred kilobytes for 10,000
// ticks) are all the device memory it touches; the bound from bytes is
// ~0.1 us.  The shot is a dependent chain of ticks x 4 barrier-separated
// stages, so the latency of a stage (a barrier and a few shared-memory round
// trips, ~0.1-0.3 us) times 4 x ticks is the floor this design sits on.

#include <cuda_runtime.h>

namespace {

struct ClosedLoopArgs {
  const void* w_in;          // (nT, nP)
  const void* w_out;         // (nP, nT)
  const void* thresholds;    // (nT,)
  const int* delays;         // (nT,)
  const void* axis_targets;  // (2,)
  const void* axis_scales;   // (2,)
  const int* inj_place;      // (nI,)
  const int* inj_axis;       // (nI,)
  const unsigned char* inj_is_pos;  // (nI,) bool
  const void* inj_scale;     // (nI,)
  const void* inj_offset;    // (nI,)
  const int* act_pos;        // (nAct,)
  const int* act_neg;        // (nAct,)
  const void* act_gain;      // (nAct,)
  const void* act_abs_max;   // (nAct,)
  const void* act_slew;      // (nAct,)
  void* marking;             // (nP,) in: the start marking; out: the final one
  void* pending;             // (n_slots, nT) in/out
  int* cursor;               // (1,) in/out
  void* prev_actions;        // (nAct,) in/out
  void* plant;               // (2,) in/out: r, z
  void* trace_r;             // (n_ticks,)
  void* trace_z;             // (n_ticks,)
  void* trace_actions;       // (n_ticks, nAct)
  void* trace_firing;        // (n_ticks, nT)
  const void* lin_plant;     // linear kind: (8,) a00 a01 a10 a11 b0 b1 bd0 bd1
  const void* lin_d;         // kinds 1, 3: (n_shots, n_ticks) the disturbance of each tick
  const void* noise;         // kind 3: (n_shots, n_ticks, 2) the two normals of each tick
  void* trace_c;             // kinds 2, 3: (n_shots, n_ticks) the error / the risk signal
  int n_p, n_t, n_i, n_act, n_slots, n_ticks;
  int mode;                  // 0 fractional, 1 binary with margin, 2 hard binary
  int plant_kind;            // 0 reduced R/Z, 1 linear vertical, 2 fueling, 3 TORAX-style
  int n_shots;               // CTAs: the episodes of kind 3, else 1
  double margin;             // the firing margin of mode 0 or 1
  double ctrl_dt;            // cfg.dt (the slew limit's period)
  double plant_dt;           // the plant's dt
  double drift_r;            // 0.01 * beta of the reduced plant
  double u_max;              // linear kind: the command clip
  double target;             // fueling kind: the density setpoint
  double baseline;           // fueling kind: leak x setpoint, the fueling that holds it
};

template <typename T> struct Arith;

template <> struct Arith<float> {
  static __device__ __forceinline__ float mul(float x, float y) { return __fmul_rn(x, y); }
  static __device__ __forceinline__ float add(float x, float y) { return __fadd_rn(x, y); }
  static __device__ __forceinline__ float sub(float x, float y) { return __fsub_rn(x, y); }
  static __device__ __forceinline__ float div(float x, float y) { return __fdiv_rn(x, y); }
  static __device__ __forceinline__ float mag(float x) { return fabsf(x); }
};

template <> struct Arith<double> {
  static __device__ __forceinline__ double mul(double x, double y) { return __dmul_rn(x, y); }
  static __device__ __forceinline__ double add(double x, double y) { return __dadd_rn(x, y); }
  static __device__ __forceinline__ double sub(double x, double y) { return __dsub_rn(x, y); }
  static __device__ __forceinline__ double div(double x, double y) { return __ddiv_rn(x, y); }
  static __device__ __forceinline__ double mag(double x) { return fabs(x); }
};

// max(x, lo) then min(., hi), NaN passing through as in torch.clamp
template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {
  const T y = x < lo ? lo : x;
  return y > hi ? hi : y;
}

// max(x, 0), NaN passing through as in torch.clamp(x, min=0)
template <typename T>
__device__ __forceinline__ T relu(T x) {
  return x < T(0) ? T(0) : x;
}

template <typename T>
__global__ void closed_loop_kernel(const ClosedLoopArgs args) {
  using A = Arith<T>;
  extern __shared__ unsigned char smem_raw[];
  T* s_win = reinterpret_cast<T*>(smem_raw);        // nT * nP
  T* s_wout = s_win + args.n_t * args.n_p;          // nP * nT
  T* s_m = s_wout + args.n_p * args.n_t;            // nP
  T* s_f = s_m + args.n_p;                          // nT
  T* s_pend = s_f + args.n_t;                       // n_slots * nT
  T* s_act = s_pend + args.n_slots * args.n_t;      // nAct

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int n_p = args.n_p, n_t = args.n_t, n_i = args.n_i, n_act = args.n_act;
  const int n_slots = args.n_slots;
  const int kind = args.plant_kind;
  // this CTA's shot: every per-shot pointer below is offset by it
  const long long shot = blockIdx.x;
  const long long tick0 = shot * args.n_ticks;

  const T* g_win = static_cast<const T*>(args.w_in);
  const T* g_wout = static_cast<const T*>(args.w_out);
  for (int i = tid; i < n_t * n_p; i += nthreads) {
    s_win[i] = g_win[i];
    s_wout[i] = g_wout[i];
  }
  T* g_m = static_cast<T*>(args.marking) + shot * n_p;
  T* g_pend = static_cast<T*>(args.pending) + shot * n_slots * n_t;
  T* g_prev = static_cast<T*>(args.prev_actions) + shot * n_act;
  for (int i = tid; i < n_p; i += nthreads) s_m[i] = g_m[i];
  for (int i = tid; i < n_slots * n_t; i += nthreads) s_pend[i] = g_pend[i];
  for (int i = tid; i < n_act; i += nthreads) s_act[i] = g_prev[i];

  // per-thread constants of its injection, transition and action
  const T* targets = static_cast<const T*>(args.axis_targets);
  const T* scales = static_cast<const T*>(args.axis_scales);
  T inj_target = T(0), inj_scale_axis = T(1), inj_scale = T(0), inj_offset = T(0);
  int inj_place = 0;
  bool inj_pos = false;
  if (tid < n_i) {
    const int ax = args.inj_axis[tid];
    inj_target = targets[ax];
    const T s = scales[ax];
    inj_scale_axis = A::mag(s) > T(1e-12) ? s : T(1e-12);
    inj_scale = static_cast<const T*>(args.inj_scale)[tid];
    inj_offset = static_cast<const T*>(args.inj_offset)[tid];
    inj_place = args.inj_place[tid];
    inj_pos = args.inj_is_pos[tid] != 0;
  }
  const int inj_ax = tid < n_i ? args.inj_axis[tid] : 0;
  T thr = T(0);
  int delay = 0;
  if (tid < n_t) {
    thr = static_cast<const T*>(args.thresholds)[tid];
    delay = args.delays[tid];
  }
  T gain = T(0), abs_max = T(0), max_delta = T(0);
  int a_pos = 0, a_neg = 0;
  if (tid < n_act) {
    gain = static_cast<const T*>(args.act_gain)[tid];
    abs_max = static_cast<const T*>(args.act_abs_max)[tid];
    max_delta = A::mul(static_cast<const T*>(args.act_slew)[tid], static_cast<T>(args.ctrl_dt));
    a_pos = args.act_pos[tid];
    a_neg = args.act_neg[tid];
  }
  const T margin = static_cast<T>(args.margin);
  const T plant_dt = static_cast<T>(args.plant_dt);
  const T drift_r = static_cast<T>(args.drift_r);
  const T drift_z = static_cast<T>(0.02);
  // the plant's state: (r, z) of the reduced plant, (z, dz/dt) of the linear
  // one, (density, integral) of the fueling one; (beta_N, q95, li3, W_th) of
  // the TORAX-style one in r, z, p2, p3
  const int stride = kind == 3 ? 4 : 2;
  T* plant = static_cast<T*>(args.plant) + shot * stride;
  T r = plant[0], z = plant[1];
  T p2 = kind == 3 ? plant[2] : T(0), p3 = kind == 3 ? plant[3] : T(0);
  const bool linear = kind == 1;
  T la00 = T(0), la01 = T(0), la10 = T(0), la11 = T(0), lb0 = T(0), lb1 = T(0);
  T lbd0 = T(0), lbd1 = T(0);
  if (linear) {
    const T* lp = static_cast<const T*>(args.lin_plant);
    la00 = lp[0]; la01 = lp[1]; la10 = lp[2]; la11 = lp[3];
    lb0 = lp[4]; lb1 = lp[5]; lbd0 = lp[6]; lbd1 = lp[7];
  }
  const T* lin_d = static_cast<const T*>(args.lin_d) + (kind == 1 || kind == 3 ? tick0 : 0);
  const T* noise = static_cast<const T*>(args.noise) + (kind == 3 ? 2 * tick0 : 0);
  const T u_max = static_cast<T>(args.u_max);
  const T target = static_cast<T>(args.target);
  const T baseline = static_cast<T>(args.baseline);
  int cursor = args.cursor[shot];
  T* tr_r = static_cast<T*>(args.trace_r) + tick0;
  T* tr_z = static_cast<T*>(args.trace_z) + tick0;
  T* tr_c = static_cast<T*>(args.trace_c) + (kind >= 2 ? tick0 : 0);
  T* tr_act = static_cast<T*>(args.trace_actions) + tick0 * n_act;
  T* tr_fire = static_cast<T*>(args.trace_firing) + tick0 * n_t;
  __syncthreads();

  for (int tick = 0; tick < args.n_ticks; ++tick) {
    // the tick's disturbance and noise, loaded before the four stages so
    // that their latency overlaps them
    const T dk = (linear || kind == 3) ? lin_d[tick] : T(0);
    const T n1_raw = kind == 3 ? noise[2 * tick] : T(0);
    const T n2_raw = kind == 3 ? noise[2 * tick + 1] : T(0);
    // kinds 2 and 3: what the plant feeds the controller, formed before the
    // controller's tick (run_fueling_mode's error and integral, the TORAX
    // policy head)
    T err = T(0), obs_k = T(0), policy = T(0);
    if (kind == 2) {
      err = A::sub(target, r);
      z = clip(A::add(z, A::mul(err, plant_dt)), T(-0.5), T(0.5));
      obs_k = A::sub(T(6.2), A::mul(T(0.25), clip(err, T(-1), T(1))));
    } else if (kind == 3) {
      policy = clip(A::sub(A::mul(T(1.10), A::sub(T(1.85), r)),
                           A::mul(T(0.32), A::sub(z, T(4.9)))), T(-1.6), T(1.6));
      obs_k = A::sub(T(6.2), A::mul(T(0.25), clip(A::sub(T(1.85), r), T(-1), T(1))));
    }
    // 1. features and injection
    if (tid < n_i) {
      const T obs = kind >= 2 ? obs_k : (inj_ax == 0 ? r : z);
      const T e = clip(A::div(A::sub(inj_target, obs), inj_scale_axis), T(-1), T(1));
      const T pos = clip(e < T(0) ? T(0) : e, T(0), T(1));
      const T neg_e = -e;
      const T neg = clip(neg_e < T(0) ? T(0) : neg_e, T(0), T(1));
      const T v = inj_pos ? pos : neg;
      s_m[inj_place] = clip(A::add(A::mul(v, inj_scale), inj_offset), T(0), T(1));
    }
    __syncthreads();

    // 2. firing and the delay ring
    if (tid < n_t) {
      T a = T(0);
      const T* row = s_win + tid * n_p;
      for (int p = 0; p < n_p; ++p) a = A::add(a, A::mul(row[p], s_m[p]));
      T f;
      if (args.mode == 0) {
        f = clip(A::div(A::sub(a, thr), margin), T(0), T(1));
      } else if (args.mode == 1) {
        f = clip(A::add(T(0.5), A::div(A::mul(T(0.5), A::sub(a, thr)), margin)), T(0), T(1));
      } else {
        f = a >= thr ? T(1) : T(0);
      }
      if (n_slots > 1) {
        T* col = s_pend + tid;
        T fired = col[cursor * n_t];
        col[cursor * n_t] = T(0);
        const bool immediate = delay == 0;
        fired = clip(A::add(fired, immediate ? f : T(0)), T(0), T(1));
        const int slot = (cursor + delay) % n_slots;
        col[slot * n_t] = A::add(col[slot * n_t], immediate ? T(0) : f);
        for (int s = 0; s < n_slots; ++s) col[s * n_t] = clip(col[s * n_t], T(0), T(1));
        f = fired;
      }
      s_f[tid] = f;
      tr_fire[static_cast<long long>(tick) * n_t + tid] = f;
    }
    if (n_slots > 1) cursor = (cursor + 1) % n_slots;
    __syncthreads();

    // 3. the marking
    if (tid < n_p) {
      T consumed = T(0), produced = T(0);
      const T* wrow = s_wout + tid * n_t;
      for (int j = 0; j < n_t; ++j) {
        consumed = A::add(consumed, A::mul(s_win[j * n_p + tid], s_f[j]));
        produced = A::add(produced, A::mul(wrow[j], s_f[j]));
      }
      s_m[tid] = clip(A::add(A::sub(s_m[tid], consumed), produced), T(0), T(1));
    }
    __syncthreads();

    // 4. actions
    if (tid < n_act) {
      const T prev = s_act[tid];
      T raw = A::mul(A::sub(s_m[a_pos], s_m[a_neg]), gain);
      raw = clip(raw, A::sub(prev, max_delta), A::add(prev, max_delta));
      const T act = clip(raw, -abs_max, abs_max);
      s_act[tid] = act;
      tr_act[static_cast<long long>(tick) * n_act + tid] = act;
    }
    __syncthreads();

    // the plant, in every thread
    if (linear) {
      const T u = clip(s_act[0], -u_max, u_max);
      const T dx0 = A::add(A::add(A::add(A::mul(la00, r), A::mul(la01, z)), A::mul(lb0, u)),
                           A::mul(lbd0, dk));
      const T dx1 = A::add(A::add(A::add(A::mul(la10, r), A::mul(la11, z)), A::mul(lb1, u)),
                           A::mul(lbd1, dk));
      if (tid == 0) {
        tr_r[tick] = r;
        tr_z[tick] = u;
      }
      r = A::add(r, A::mul(plant_dt, dx0));
      z = A::add(z, A::mul(plant_dt, dx1));
    } else if (kind == 2) {
      // run_fueling_mode :103-113: the gated SCPN term, the PI path, the
      // clipped command and the density update
      const T u_raw = A::div(s_act[0], T(5000));
      const T gate = clip(A::div(A::mag(err), T(0.05)), T(0), T(1));
      const T u_snn = A::mul(A::mul(T(0.25), gate), u_raw);
      const T u_pi = A::add(A::mul(T(1.95), err), A::mul(T(7.2), z));
      const T cmd = clip(A::add(u_pi, u_snn), T(-2), T(2));
      r = relu(A::add(r, A::mul(plant_dt, A::sub(A::add(baseline, A::mul(T(1.15), cmd)),
                                                 A::mul(T(1.15), r)))));
      if (tid == 0) {
        tr_r[tick] = r;
        tr_z[tick] = cmd;
        tr_c[tick] = err;
      }
    } else if (kind == 3) {
      // run_torax_hybrid_campaign :179-196: command, the 4-state update,
      // the clips and the risk signal
      const T cmd = clip(A::add(policy, A::div(A::mul(T(0.2), s_act[0]), T(5000))), T(-2), T(2));
      const T n1 = A::mul(T(0.004), n1_raw);
      const T n2 = A::mul(T(0.006), n2_raw);
      const T db = A::add(A::sub(A::sub(A::mul(T(0.85), cmd), A::sub(r, T(1.85))),
                                 A::mul(T(0.52), dk)), n1);
      const T dq = A::add(A::sub(A::add(A::sub(T(0.18), A::mul(T(0.33), cmd)), A::mul(T(0.62), dk)),
                                 A::mul(T(0.16), A::sub(z, T(4.9)))), n2);
      const T dl = A::sub(A::sub(A::mul(T(0.06), cmd), A::mul(T(0.11), dk)),
                          A::mul(T(0.09), A::sub(p2, T(0.95))));
      const T dw = A::sub(A::sub(A::mul(T(10.0), cmd), A::mul(T(5.0), dk)),
                          A::mul(T(0.06), A::sub(p3, T(140.0))));
      r = clip(A::add(r, A::mul(T(0.045), db)), T(0.6), T(3.2));
      z = clip(A::add(z, A::mul(T(0.060), dq)), T(2.8), T(7.5));
      p2 = clip(A::add(p2, A::mul(T(0.050), dl)), T(0.45), T(1.8));
      p3 = clip(A::add(p3, A::mul(T(0.110), dw)), T(50.0), T(260.0));
      const T risk = A::add(A::add(A::add(A::add(T(0.40), A::mul(T(0.42), relu(A::sub(r, T(2.05))))),
                                          A::mul(T(0.38), relu(A::sub(T(4.4), z)))),
                                   A::mul(T(0.22), relu(A::sub(p2, T(1.25))))),
                            A::mul(T(0.30), dk));
      if (tid == 0) {
        tr_r[tick] = r;
        tr_z[tick] = z;
        tr_c[tick] = risk;
      }
    } else {
      r = clip(A::add(r, A::mul(A::add(drift_r, s_act[0]), plant_dt)), T(2), T(10));
      z = clip(A::add(z, A::mul(A::add(drift_z, s_act[1]), plant_dt)), T(-6), T(6));
      if (tid == 0) {
        tr_r[tick] = r;
        tr_z[tick] = z;
      }
    }
    // stage 1 of the next tick writes only the marking, which stage 4 read
    // before the barrier above; stage 4's next writes come after three more
  }

  for (int i = tid; i < n_p; i += nthreads) g_m[i] = s_m[i];
  for (int i = tid; i < n_slots * n_t; i += nthreads) g_pend[i] = s_pend[i];
  for (int i = tid; i < n_act; i += nthreads) g_prev[i] = s_act[i];
  if (tid == 0) {
    plant[0] = r;
    plant[1] = z;
    if (kind == 3) {
      plant[2] = p2;
      plant[3] = p3;
    }
    args.cursor[shot] = cursor;
  }
}

template <typename T>
int launch_closed_loop(const ClosedLoopArgs* args, int threads, void* stream) {
  const size_t smem = sizeof(T) * (2 * static_cast<size_t>(args->n_t) * args->n_p + args->n_p +
                                   args->n_t + static_cast<size_t>(args->n_slots) * args->n_t +
                                   args->n_act);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(closed_loop_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  closed_loop_kernel<T><<<args->n_shots, threads, smem, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int scpn_closed_loop_f32(const void* args, int threads, void* stream) {
  return launch_closed_loop<float>(static_cast<const ClosedLoopArgs*>(args), threads, stream);
}

extern "C" int scpn_closed_loop_f64(const void* args, int threads, void* stream) {
  return launch_closed_loop<double>(static_cast<const ClosedLoopArgs*>(args), threads, stream);
}
