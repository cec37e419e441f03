// The monitored UPDE run (row U): every tick of a multi-layer UPDE
// trajectory -- the tick, the Lyapunov guard and the recorder -- in ONE
// launch of one CTA.
//
// Replaces no Pallas kernel: scpn_fusion_tpu/models/phase/upde.py:run_upde
// (:113-147) and models/phase/monitor.py:run_monitor (:155-175) are each one
// lax.scan of upde_tick (:56-104), for the monitor with guard_check
// (guard.py:56-74) and the recorder, one compiled XLA program.  Eager PyTorch
// runs a tick as ~70 small launches (the plain twin: the loop of the port's
// models/phase/upde._tick and, for the monitor, guard.guard_update).
//
// Design: one CTA; the phases live padded in an (L, n_pad) array, n_pad the
// power of two at or above n, one thread an oscillator (a thread takes
// several, tid, tid + blockDim, ..., where L n_pad exceeds the block, which
// the registers cap at 512 threads in float32, 384 in float64).  The thread
// count changes no bit of the result: every sum pairs fixed indices.  The
// phases, frequencies and mask, two (L, n_pad) work arrays, K, alpha, zeta,
// the per-layer values and the guard's ring live in shared memory (in a
// global work array the wrapper allocates where they do not fit).  A tick:
//   A  cos(theta) mask and sin(theta) mask into the work arrays;
//   a halving tree over each layer's n_pad entries (one barrier a level);
//   B  per layer: R_m, Psi_m (the sums divided by the layer's count), and
//      the layer sums and R_m sin / cos Psi_m for the trees over layers;
//   a halving tree over the l_pad layers;
//   C  thread 0: R_global, and Psi (the external driver or, in mean-field
//      mode, atan2 of the layer tree); one thread a target layer: the gate,
//      the weights and S_m, C_m summed over the sources in index order;
//   D  dtheta, the Euler step, wrap_phase, the mask; 1 - cos(theta1 - Psi)
//      times the mask and times the oscillator's validity into the work
//      arrays; the phase trace;
//   the layer trees again, E the V per layer, the layer trees again;
//   F  thread 0: V_global, the guard's V (the sum over every oscillator
//      times 1 / (L n), rounded once), its ring (a head index, not a roll),
//      lambda and the consecutive-violation latch.
// 6 + 2 log2(n_pad) + 2 log2(l_pad) barrier stages a tick (24 at the
// monitor's 8 x 50).
//
// Arithmetic: every product, sum and quotient is an _rn intrinsic (never
// contracted into an FMA), in the plain twin's order; a quotient by a count
// is a division by the count, as the twin divides by a tensor; pi and 2 pi
// are rounded to T once; wrap_phase takes fmod and adds the divisor where the
// signs differ, as torch.remainder does; sin, cos, atan2, log are the CUDA
// math library's, as torch's own elementwise kernels.  So the kernel equals
// its plain twin on the card bit for bit, in float32 and float64.
//
// What bounds it on an H100: the bytes are the inputs once and the traces
// once (77 kB for the monitor's 1000 ticks at 8 x 50 in float32); the
// operations ~40 an oscillator a tick.  Neither: the n_ticks x ~24 dependent
// barrier stages on one SM.

#include <cuda_runtime.h>

#include <math.h>

namespace {

struct PhaseArgs {
  const void* theta0;        // (L, n_pad) phases, zero beyond n
  const void* omega;         // (L, n_pad)
  const void* mask;          // (L, n_pad), zero beyond n
  const void* k;             // (L, L) coupling, source row -> target column
  const void* alpha;         // (L, L) Sakaguchi lag
  const void* zeta;          // (L,) global-driver gain
  const void* ring0;         // (ring_len,) the guard's V samples, oldest first
  const int* guard0;         // [n_seen, consecutive]
  void* theta_trace;         // (n_ticks, L, n), or null
  void* theta_final;         // (L, n)
  void* r_layer;             // (n_ticks, L)
  void* r_global;            // (n_ticks,)
  void* v_layer;             // (n_ticks, L)
  void* v_global;            // (n_ticks,)
  void* lambda_exp;          // (n_ticks,), the guard's (with_guard)
  unsigned char* approved;   // (n_ticks,)
  int* violations;           // (n_ticks,)
  void* ring;                // (ring_len,) the guard's final ring, oldest first
  int* guard;                // [n_seen, consecutive] after the run
  void* scratch;             // global work array of `work` values, or null: shared memory
  int L, n, n_pad, l_pad, n_ticks, window, ring_len, max_violations, mean_field, wrap, with_guard;
  int work;
  double dt, psi, gain, pac_gamma, guard_dt, lambda_threshold;
};

template <typename T> struct Math;

template <> struct Math<float> {
  static __device__ __forceinline__ float mul(float x, float y) { return __fmul_rn(x, y); }
  static __device__ __forceinline__ float add(float x, float y) { return __fadd_rn(x, y); }
  static __device__ __forceinline__ float sub(float x, float y) { return __fsub_rn(x, y); }
  static __device__ __forceinline__ float div(float x, float y) { return __fdiv_rn(x, y); }
  static __device__ __forceinline__ float sqrt(float x) { return __fsqrt_rn(x); }
  static __device__ __forceinline__ float sin(float x) { return ::sinf(x); }
  static __device__ __forceinline__ float cos(float x) { return ::cosf(x); }
  static __device__ __forceinline__ float atan2(float y, float x) { return ::atan2f(y, x); }
  static __device__ __forceinline__ float log(float x) { return ::logf(x); }
  static __device__ __forceinline__ float fmod(float x, float y) { return ::fmodf(x, y); }
};

template <> struct Math<double> {
  static __device__ __forceinline__ double mul(double x, double y) { return __dmul_rn(x, y); }
  static __device__ __forceinline__ double add(double x, double y) { return __dadd_rn(x, y); }
  static __device__ __forceinline__ double sub(double x, double y) { return __dsub_rn(x, y); }
  static __device__ __forceinline__ double div(double x, double y) { return __ddiv_rn(x, y); }
  static __device__ __forceinline__ double sqrt(double x) { return __dsqrt_rn(x); }
  static __device__ __forceinline__ double sin(double x) { return ::sin(x); }
  static __device__ __forceinline__ double cos(double x) { return ::cos(x); }
  static __device__ __forceinline__ double atan2(double y, double x) { return ::atan2(y, x); }
  static __device__ __forceinline__ double log(double x) { return ::log(x); }
  static __device__ __forceinline__ double fmod(double x, double y) { return ::fmod(x, y); }
};

// torch.clamp(x, min=lo): lo where x < lo, else x (a NaN stays)
template <typename T>
__device__ __forceinline__ T floor_at(T x, T lo) { return x < lo ? lo : x; }

// (x + pi) % 2pi - pi, the remainder as torch.remainder takes it
template <typename T>
__device__ __forceinline__ T wrap_phase(T x, T pi, T two_pi) {
  using M = Math<T>;
  T mod = M::fmod(M::add(x, pi), two_pi);
  if (mod != T(0) && ((two_pi < T(0)) != (mod < T(0)))) mod = M::add(mod, two_pi);
  return M::sub(mod, pi);
}

// halve each of the L rows of n_pad entries of a and b in place: row sums at
// a[m n_pad], b[m n_pad]
template <typename T>
__device__ void tree_rows(T* a, T* b, int L, int n_pad) {
  for (int h = n_pad >> 1; h > 0; h >>= 1) {
    for (int idx = threadIdx.x; idx < L * h; idx += blockDim.x) {
      const int m = idx / h;
      const int j = m * n_pad + (idx - m * h);
      a[j] = Math<T>::add(a[j], a[j + h]);
      b[j] = Math<T>::add(b[j], b[j + h]);
    }
    __syncthreads();
  }
}

// halve the l_pad entries of each of the `count` vectors v[0..count) in place
template <typename T>
__device__ void tree_layers(T* const* v, int count, int l_pad) {
  for (int h = l_pad >> 1; h > 0; h >>= 1) {
    for (int idx = threadIdx.x; idx < count * h; idx += blockDim.x) {
      const int c = idx / h, m = idx - c * h;
      v[c][m] = Math<T>::add(v[c][m], v[c][m + h]);
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void phase_kernel(const PhaseArgs a) {
  using M = Math<T>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int s_head, s_seen, s_consec;
  T* base = a.scratch ? static_cast<T*>(a.scratch) : reinterpret_cast<T*>(smem_raw);
  const int L = a.L, n = a.n, np = a.n_pad, lp = a.l_pad, N = L * np, W = a.window;
  const int B = a.ring_len;
  const int tid = threadIdx.x, nt = blockDim.x;
  T* th = base;
  T* om = th + N;
  T* mk = om + N;
  T* wa = mk + N;
  T* wb = wa + N;
  T* kk = wb + N;
  T* al = kk + L * L;
  T* ze = al + L * L;
  T* cnt = ze + L;
  T* rm = cnt + lp;
  T* pm = rm + lp;
  T* sm = pm + lp;
  T* cm = sm + lp;
  T* g0 = cm + lp;
  T* g1 = g0 + lp;
  T* g2 = g1 + lp;
  T* g3 = g2 + lp;
  T* ring = g3 + lp;
  T* scal = ring + B;       // [0] Psi of the tick, [1] the total count
  T* const four[4] = {g0, g1, g2, g3};

  const T zero = T(0), one = T(1), tiny = static_cast<T>(1e-15);
  const T pi = static_cast<T>(3.141592653589793), two_pi = static_cast<T>(6.283185307179586);
  const T dt = static_cast<T>(a.dt), psi_ext = static_cast<T>(a.psi);
  const T gain = static_cast<T>(a.gain), pac = static_cast<T>(a.pac_gamma);
  const T guard_dt = static_cast<T>(a.guard_dt), threshold = static_cast<T>(a.lambda_threshold);
  const T inv_flat = M::div(one, static_cast<T>(L * n));

  for (int j = tid; j < N; j += nt) {
    th[j] = static_cast<const T*>(a.theta0)[j];
    om[j] = static_cast<const T*>(a.omega)[j];
    mk[j] = static_cast<const T*>(a.mask)[j];
    wa[j] = mk[j];
    wb[j] = zero;
  }
  for (int j = tid; j < L * L; j += nt) {
    kk[j] = static_cast<const T*>(a.k)[j];
    al[j] = static_cast<const T*>(a.alpha)[j];
  }
  for (int j = tid; j < L; j += nt) ze[j] = static_cast<const T*>(a.zeta)[j];
  if (a.with_guard) {
    for (int j = tid; j < B; j += nt) ring[j] = static_cast<const T*>(a.ring0)[j];
  }
  if (tid == 0) {
    s_head = 0;
    s_seen = a.with_guard ? a.guard0[0] : 0;
    s_consec = a.with_guard ? a.guard0[1] : 0;
  }
  __syncthreads();
  // the counts: each layer's mask sum, and their sum over the layers
  tree_rows(wa, wb, L, np);
  for (int m = tid; m < lp; m += nt) {
    const T c = m < L ? wa[m * np] : zero;
    g0[m] = c;
    cnt[m] = floor_at(c, tiny);
  }
  __syncthreads();
  tree_layers(four, 1, lp);
  if (tid == 0) scal[1] = floor_at(g0[0], tiny);
  __syncthreads();
  const T total = scal[1];

  for (int t = 0; t < a.n_ticks; ++t) {
    // A: the layer sums of e^{i theta}
    for (int j = tid; j < N; j += nt) {
      wa[j] = M::mul(M::cos(th[j]), mk[j]);
      wb[j] = M::mul(M::sin(th[j]), mk[j]);
    }
    __syncthreads();
    tree_rows(wa, wb, L, np);
    // B: the layer order parameters
    for (int m = tid; m < lp; m += nt) {
      if (m < L) {
        const T c = wa[m * np], s = wb[m * np];
        const T zr = M::div(c, cnt[m]), zi = M::div(s, cnt[m]);
        const T r = M::sqrt(M::add(M::mul(zr, zr), M::mul(zi, zi)));
        const T p = M::atan2(zi, zr);
        rm[m] = r;
        pm[m] = p;
        g0[m] = c;
        g1[m] = s;
        g2[m] = M::mul(r, M::sin(p));
        g3[m] = M::mul(r, M::cos(p));
        static_cast<T*>(a.r_layer)[static_cast<long long>(t) * L + m] = r;
      } else {
        g0[m] = g1[m] = g2[m] = g3[m] = zero;
      }
    }
    __syncthreads();
    tree_layers(four, 4, lp);
    // C: the global order parameter, the driver phase, the coupling sums
    if (tid == 0) {
      const T zr = M::div(g0[0], total), zi = M::div(g1[0], total);
      static_cast<T*>(a.r_global)[t] = M::sqrt(M::add(M::mul(zr, zr), M::mul(zi, zi)));
      scal[0] = a.mean_field ? M::atan2(g2[0], g3[0]) : psi_ext;
    }
    for (int m = tid; m < L; m += nt) {
      T s_sum = zero, c_sum = zero;
      for (int src = 0; src < L; ++src) {
        const T off = src == m ? zero : one;
        const T gate = M::add(one, M::mul(M::mul(pac, M::sub(one, rm[src])), off));
        const T w = M::mul(M::mul(M::mul(gain, gate), kk[src * L + m]), rm[src]);
        const T beta = M::sub(pm[src], al[src * L + m]);
        const T ts = M::mul(w, M::sin(beta)), tc = M::mul(w, M::cos(beta));
        s_sum = src == 0 ? ts : M::add(s_sum, ts);
        c_sum = src == 0 ? tc : M::add(c_sum, tc);
      }
      sm[m] = s_sum;
      cm[m] = c_sum;
    }
    __syncthreads();
    // D: the Euler step and the V terms
    const T psi = scal[0];
    for (int j = tid; j < N; j += nt) {
      const int m = j / np, i = j - m * np;
      const T x = th[j];
      const T d = M::add(M::sub(M::add(om[j], M::mul(sm[m], M::cos(x))), M::mul(cm[m], M::sin(x))),
                         M::mul(ze[m], M::sin(M::sub(psi, x))));
      T x1 = M::add(x, M::mul(dt, d));
      if (a.wrap) x1 = wrap_phase(x1, pi, two_pi);
      x1 = mk[j] > zero ? x1 : zero;
      th[j] = x1;
      const T v = M::sub(one, M::cos(M::sub(x1, psi)));
      wa[j] = M::mul(v, mk[j]);
      wb[j] = i < n ? v : zero;
      if (a.theta_trace && i < n) {
        static_cast<T*>(a.theta_trace)[(static_cast<long long>(t) * L + m) * n + i] = x1;
      }
    }
    __syncthreads();
    tree_rows(wa, wb, L, np);
    // E: V per layer
    for (int m = tid; m < lp; m += nt) {
      if (m < L) {
        static_cast<T*>(a.v_layer)[static_cast<long long>(t) * L + m] = M::div(wa[m * np], cnt[m]);
        g0[m] = wa[m * np];
        g1[m] = wb[m * np];
      } else {
        g0[m] = g1[m] = zero;
      }
    }
    __syncthreads();
    tree_layers(four, 2, lp);
    // F: V_global and the guard
    if (tid == 0) {
      static_cast<T*>(a.v_global)[t] = M::div(g0[0], total);
      if (a.with_guard) {
        const T v = M::mul(g1[0], inv_flat);
        const int head = s_head;
        ring[head] = v;                       // the roll by one, v the newest
        s_head = head + 1 == B ? 0 : head + 1;
        const int seen = s_seen + 1;
        const int valid = seen < W ? seen : W;
        const int back = W - valid < B - 1 ? W - valid : B - 1;   // a gather clamps its index
        const T oldest = ring[(s_head + back) % B];
        T lam = zero;
        if (valid >= 2) {
          lam = M::div(M::log(M::div(floor_at(v, tiny), floor_at(oldest, tiny))),
                       M::mul(static_cast<T>(valid), guard_dt));
        }
        const int consec = (valid >= 2 && lam > threshold) ? s_consec + 1 : 0;
        s_seen = seen;
        s_consec = consec;
        static_cast<T*>(a.lambda_exp)[t] = lam;
        a.approved[t] = consec < a.max_violations;
        a.violations[t] = consec;
      }
    }
    __syncthreads();
  }

  T* theta_final = static_cast<T*>(a.theta_final);
  for (int j = tid; j < N; j += nt) {
    const int m = j / np, i = j - m * np;
    if (i < n) theta_final[m * n + i] = th[j];
  }
  if (a.with_guard) {
    for (int j = tid; j < B; j += nt) static_cast<T*>(a.ring)[j] = ring[(s_head + j) % B];
    if (tid == 0) {
      a.guard[0] = s_seen;
      a.guard[1] = s_consec;
    }
  }
}

template <typename T>
int launch_phase(const PhaseArgs* args, int threads, void* stream) {
  size_t smem = 0;
  if (!args->scratch) {
    smem = sizeof(T) * static_cast<size_t>(args->work);
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(phase_kernel<T>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  phase_kernel<T><<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int phase_max_threads() {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, phase_kernel<T>) != cudaSuccess) return 0;
  return attr.maxThreadsPerBlock;
}

}  // namespace

// The most threads a block of the kernel can have with its registers (the
// float64 instantiation holds more): the wrapper launches no more.
extern "C" int scpn_phase_max_threads(int f64) {
  return f64 ? phase_max_threads<double>() : phase_max_threads<float>();
}

extern "C" int scpn_phase_run_f32(const void* args, int threads, void* stream) {
  return launch_phase<float>(static_cast<const PhaseArgs*>(args), threads, stream);
}

extern "C" int scpn_phase_run_f64(const void* args, int threads, void* stream) {
  return launch_phase<double>(static_cast<const PhaseArgs*>(args), threads, stream);
}
