// The SOC sandpile's drive-and-relax loop (row S): every drive and every
// toppling sweep of a run in ONE launch of one CTA.
//
// Replaces no Pallas kernel: scpn_fusion_tpu/models/physics/sandpile.py:
// run_sandpile (:64-84) is a lax.scan over the drives with relax_sweeps (64)
// synchronous sweeps an inner lax.scan (:44-61), one compiled XLA program.
// Eager PyTorch runs a sweep as ~13 launches (the plain version: the loop of
// the port's models/physics/sandpile.drive and .sweep), ~1.7 M launches for
// the default 128 cells x 2000 drives.
//
// Design: one CTA; a thread holds cells tid, tid + blockDim, ... (one cell a
// thread up to 1024 cells).  The heights live in shared memory, double
// buffered: a sweep reads one buffer and writes the other, so ONE barrier a
// sweep is enough.  The new height of cell i needs move[i] (from h[i] and
// h[i+1]) and move[i-1] (from h[i-1] and h[i]); the thread computes both from
// the three heights.  A drive adds its grain (thread 0) behind one barrier,
// runs the sweeps, and then reduces once: the topples (counted in a register
// a thread over the drive's sweeps), the edge flux (summed by the last cell's
// thread) and the sum of h[i] - h[i+1] times 1 / (n - 1) (the reciprocal
// rounded once: XLA turns jnp.mean's division by a constant into that
// product, and so does torch.mean on a CUDA tensor).
//
// Arithmetic: the slope, the two moves and the new height are rounded one by
// one in the plain version's order ((h - move[i]) + move[i-1]).  With the
// default drive 1 and topple 2 every height, count and flux is an integer, so
// any order of the per-drive sums gives the same bits; the kernel then equals
// its plain version bit for bit in float32 and float64.
//
// What bounds it on an H100: the bytes are the drive cells in, three values a
// drive and the final heights out; the operations ~7 a cell and a sweep.
// Neither: n_steps x relax_sweeps dependent barrier stages on one SM.

#include <cuda_runtime.h>

namespace {

struct SandpileArgs {
  const void* h0;          // (n,) the starting heights
  const long long* idx;    // (n_steps,) the drive cell of each drive
  void* h_final;           // (n,)
  void* sizes;             // (n_steps,) topples a drive
  void* flux;              // (n_steps,) grains off the edge a drive
  void* slope;             // (n_steps,) mean slope after a drive
  int n, n_steps, sweeps;
  double critical, topple, drive;
};

template <typename T> struct Arith;

template <> struct Arith<float> {
  static __device__ __forceinline__ float mul(float x, float y) { return __fmul_rn(x, y); }
  static __device__ __forceinline__ float add(float x, float y) { return __fadd_rn(x, y); }
  static __device__ __forceinline__ float sub(float x, float y) { return __fsub_rn(x, y); }
  static __device__ __forceinline__ float div(float x, float y) { return __fdiv_rn(x, y); }
};

template <> struct Arith<double> {
  static __device__ __forceinline__ double mul(double x, double y) { return __dmul_rn(x, y); }
  static __device__ __forceinline__ double add(double x, double y) { return __dadd_rn(x, y); }
  static __device__ __forceinline__ double sub(double x, double y) { return __dsub_rn(x, y); }
  static __device__ __forceinline__ double div(double x, double y) { return __ddiv_rn(x, y); }
};

constexpr int kMaxWarps = 32;

template <typename T>
__global__ void sandpile_kernel(const SandpileArgs a) {
  using A = Arith<T>;
  extern __shared__ unsigned char smem_raw[];
  T* cur = reinterpret_cast<T*>(smem_raw);
  T* nxt = cur + a.n;
  __shared__ int warp_count[kMaxWarps];
  __shared__ T warp_sum[kMaxWarps];
  __shared__ T edge_flux;
  const int n = a.n, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  const T critical = static_cast<T>(a.critical), topple = static_cast<T>(a.topple);
  const T drive = static_cast<T>(a.drive);
  const T* h0 = static_cast<const T*>(a.h0);
  for (int i = tid; i < n; i += blockDim.x) cur[i] = h0[i];
  __syncthreads();

  for (int k = 0; k < a.n_steps; ++k) {
    if (tid == 0) {
      const long long c = a.idx[k];
      cur[c] = A::add(cur[c], drive);
    }
    __syncthreads();
    int count = 0;
    T out = T(0);
    for (int s = 0; s < a.sweeps; ++s) {
      for (int i = tid; i < n; i += blockDim.x) {
        const T h = cur[i];
        const T right = i + 1 < n ? cur[i + 1] : T(0);
        const bool unstable = A::sub(h, right) > critical;
        const T move = unstable ? topple : T(0);
        T move_in = T(0);
        if (i > 0) move_in = A::sub(cur[i - 1], h) > critical ? topple : T(0);
        nxt[i] = A::add(A::sub(h, move), move_in);
        count += unstable;
        if (i == n - 1) out = A::add(out, move);
      }
      __syncthreads();
      T* t = cur;
      cur = nxt;
      nxt = t;
    }
    // the drive's reductions: topples, edge flux, sum of h[i] - h[i + 1]
    T diff = T(0);
    for (int i = tid; i < n - 1; i += blockDim.x) diff = A::add(diff, A::sub(cur[i], cur[i + 1]));
    if ((n - 1) % blockDim.x == tid) edge_flux = out;
    for (int off = 16; off > 0; off >>= 1) {
      count += __shfl_down_sync(0xffffffffu, count, off);
      diff = A::add(diff, __shfl_down_sync(0xffffffffu, diff, off));
    }
    if (lane == 0) {
      warp_count[warp] = count;
      warp_sum[warp] = diff;
    }
    __syncthreads();
    if (tid == 0) {
      int total = 0;
      T sum = T(0);
      for (int w = 0; w < n_warps; ++w) {
        total += warp_count[w];
        sum = A::add(sum, warp_sum[w]);
      }
      static_cast<T*>(a.sizes)[k] = static_cast<T>(total);
      static_cast<T*>(a.flux)[k] = edge_flux;
      static_cast<T*>(a.slope)[k] = A::mul(sum, A::div(T(1), static_cast<T>(n - 1)));
    }
  }
  T* h_final = static_cast<T*>(a.h_final);
  for (int i = tid; i < n; i += blockDim.x) h_final[i] = cur[i];
}

template <typename T>
int launch_sandpile(const SandpileArgs* args, int threads, void* stream) {
  const size_t smem = 2 * sizeof(T) * static_cast<size_t>(args->n);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(sandpile_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sandpile_kernel<T><<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int scpn_sandpile_f32(const void* args, int threads, void* stream) {
  return launch_sandpile<float>(static_cast<const SandpileArgs*>(args), threads, stream);
}

extern "C" int scpn_sandpile_f64(const void* args, int threads, void* stream) {
  return launch_sandpile<double>(static_cast<const SandpileArgs*>(args), threads, stream);
}
