// Fused topology + Grad-Shafranov source, as one cooperative launch.
//
// Replaces: scpn_fusion_tpu/ops/pallas_source.py:59 _fused_source_kernel
// (entry fused_topology_source).
//
// source_fused_kernel runs three phases with a grid-wide barrier between
// them:
//
//   1. block partials of max psi, min psi and the masked first-row-major
//      argmin of |grad psi| over the divertor mask;
//   2. every block finishes pass 1 from the partials (psi_axis floored at
//      1e-6; psi_b = psi at the X-point, or min psi when the mask is empty;
//      the |axis - b| < 0.1 snap), block 0 writes the scalar readout, then
//      every block sums its share of the unnormalised J_phi for the Ip
//      renormalisation;
//   3. every block finishes the Ip sum from the partials and writes
//      -mu0 R J_phi * scale elementwise.
//
// What bounds it on an H100: bytes.  psi, the mask and R are read once and
// src written once (3 n^2 + n floats: 3.2 MB at 513^2, under a microsecond at
// 3.35 TB/s), and the two reductions each need a grid-wide result before the
// next phase can start, so two grid barriers of a few microseconds are the
// floor in practice.
//
// What the design does about it: the at most 264 blocks of 256 threads (two
// a SM on 132 SMs) are all resident at once, so a cooperative launch can put
// grid.sync() where launch boundaries used to be: one launch, not three.
// Each thread keeps the psi values of its points in registers across the
// phases (up to kKeep = 16 a thread, which covers 1025^2; points beyond are
// read again, from L2), so psi comes from memory once.  The small finishing
// reductions are done redundantly by every block (a few hundred partials), so
// there is no one-block phase and no atomics, and every sum is taken in a
// fixed order (deterministic).  The argmin keeps (value, index) pairs and
// breaks ties toward the lower linear index, which is exactly the "first
// row-major minimum" of the JAX path.  |grad psi| is computed with
// round-to-nearest intrinsics (no contraction into FMA), in the operation
// order of the plain PyTorch version, so both pick the same X-point site.
//
// The same three phases as three launches (source_reduce_kernel,
// source_ipsum_kernel, source_apply_kernel; entry scpn_fused_source_staged)
// stay below as the reference that the one-launch kernel must equal bit for
// bit: same partials, combined in the same order.
//
// Batched (entry scpn_fused_source_batched; the ensemble of
// parallel/ensemble.py, the counterpart of vmap over pallas_call): B grids
// of one shape, each with its own I_target, as the same three kernels on a
// (blocks, B) grid.  blockIdx.y is the element: it offsets psi, src, the
// partials, the readout and the parameters, and nothing else changes, so an
// element's partials are the unbatched call's, combined in the same order,
// and element b equals the unbatched launch on element b bit for bit.  Why
// three launches and not one: the cooperative kernel needs every block of
// the grid resident, and B elements need B times the blocks (4352 at 129^2
// and B = 256, where the device holds 264); a cluster a element would cap an
// element at 8 (16) blocks of its own and change its block partition, and so
// its sums.  The staged kernels need no grid-wide barrier: the launch
// boundaries are the element's barriers.

#include <climits>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  return v1 < v2 || (v1 == v2 && i1 < i2);
}

__device__ __forceinline__ float grad_mag(const float* __restrict__ p, int i, int j, int nz,
                                          int nr, float d_r, float d_z) {
  const int idx = i * nr + j;
  float gz, gr;
  if (i == 0) gz = __fdiv_rn(__fsub_rn(p[idx + nr], p[idx]), d_z);
  else if (i == nz - 1) gz = __fdiv_rn(__fsub_rn(p[idx], p[idx - nr]), d_z);
  else gz = __fdiv_rn(__fmul_rn(__fsub_rn(p[idx + nr], p[idx - nr]), 0.5f), d_z);
  if (j == 0) gr = __fdiv_rn(__fsub_rn(p[idx + 1], p[idx]), d_r);
  else if (j == nr - 1) gr = __fdiv_rn(__fsub_rn(p[idx], p[idx - 1]), d_r);
  else gr = __fdiv_rn(__fmul_rn(__fsub_rn(p[idx + 1], p[idx - 1]), 0.5f), d_r);
  return __fsqrt_rn(__fadd_rn(__fmul_rn(gr, gr), __fmul_rn(gz, gz)));
}

struct Red {
  float mx, mn, b;
  int bi;
};

__device__ __forceinline__ void combine(Red& a, const Red& o) {
  a.mx = fmaxf(a.mx, o.mx);
  a.mn = fminf(a.mn, o.mn);
  if (better(o.b, o.bi, a.b, a.bi)) {
    a.b = o.b;
    a.bi = o.bi;
  }
}

// Block-wide reduction; the result is valid in every thread.
__device__ Red block_reduce(Red v) {
  __shared__ Red warp_res[kWarps];
  __shared__ Red total;
  for (int off = 16; off > 0; off >>= 1) {
    Red o;
    o.mx = __shfl_down_sync(0xffffffffu, v.mx, off);
    o.mn = __shfl_down_sync(0xffffffffu, v.mn, off);
    o.b = __shfl_down_sync(0xffffffffu, v.b, off);
    o.bi = __shfl_down_sync(0xffffffffu, v.bi, off);
    combine(v, o);
  }
  if ((threadIdx.x & 31) == 0) warp_res[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    Red t = warp_res[0];
    for (int w = 1; w < kWarps; ++w) combine(t, warp_res[w]);
    total = t;
  }
  __syncthreads();
  return total;
}

__device__ float block_sum(float v) {
  __shared__ float warp_sum[kWarps];
  __shared__ float total;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = warp_sum[0];
    for (int w = 1; w < kWarps; ++w) t += warp_sum[w];
    total = t;
  }
  __syncthreads();
  return total;
}

__device__ __forceinline__ float mtanh(float pn, const float* __restrict__ c) {
  // c = (ped_top, ped_width, ped_height, core_alpha)
  // pedestal + core_alpha * core adds two products, and 1 - q^2 follows one:
  // which product the compiler folds into an FMA differed from kernel to
  // kernel, so the roundings are spelled out (one FMA over the pedestal
  // product, the others rounded on their own) and every kernel agrees.
  const bool inside = (pn >= 0.0f) && (pn < 1.0f);
  const float y = fminf(fmaxf((c[0] - pn) / c[1], -20.0f), 20.0f);
  const float q = pn / c[0];
  const float core = (pn < c[0]) ? fmaxf(0.0f, __fsub_rn(1.0f, __fmul_rn(q, q))) : 0.0f;
  return inside ? __fmaf_rn(0.5f * c[2], 1.0f + tanhf(y), __fmul_rn(c[3], core)) : 0.0f;
}

// Unnormalised J_phi = 0.5 R p' + 0.5 FF' / (mu0 R) at one point.
__device__ __forceinline__ float j_raw(float psi, float r, float axis, float psi_b,
                                       const float* __restrict__ par, float mu0, int h_mode) {
  float denom = psi_b - axis;
  if (fabsf(denom) < 1e-9f) denom = 1e-9f;
  const float pn = (psi - axis) / denom;
  float pp, ff;
  if (h_mode) {
    pp = mtanh(pn, par);
    ff = mtanh(pn, par + 4);
  } else {
    pp = ((pn >= 0.0f) && (pn < 1.0f)) ? 1.0f - pn : 0.0f;
    ff = pp;
  }
  // Each rounding spelled out, so that no kernel folds either product into
  // an FMA: the fused, staged and batched launches agree bit for bit.
  return __fadd_rn(__fmul_rn(0.5f, __fmul_rn(r, pp)),
                   __fmul_rn(0.5f, __fdiv_rn(ff, __fmul_rn(mu0, r))));
}

__global__ void source_reduce_kernel(const float* __restrict__ psi,
                                     const float* __restrict__ mask, int nz, int nr, float d_r,
                                     float d_z, float* __restrict__ part,
                                     int* __restrict__ part_idx) {
  const int n = nz * nr;
  const size_t e = blockIdx.y;   // the element of a batched call
  psi += e * n;
  part += e * 3 * gridDim.x;
  part_idx += e * gridDim.x;
  Red v{-INFINITY, INFINITY, INFINITY, INT_MAX};
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < n; k += gridDim.x * blockDim.x) {
    const float x = psi[k];
    v.mx = fmaxf(v.mx, x);
    v.mn = fminf(v.mn, x);
    if (mask[k] > 0.0f) {
      const int i = k / nr;
      const float b = grad_mag(psi, i, k - i * nr, nz, nr, d_r, d_z);
      if (better(b, k, v.b, v.bi)) {
        v.b = b;
        v.bi = k;
      }
    }
  }
  const Red t = block_reduce(v);
  if (threadIdx.x == 0) {
    part[3 * blockIdx.x + 0] = t.mx;
    part[3 * blockIdx.x + 1] = t.mn;
    part[3 * blockIdx.x + 2] = t.b;
    part_idx[blockIdx.x] = t.bi;
  }
}

// psi_axis and psi_b from the pass-1 partials (same result in every block).
__device__ void finish_topology(const float* __restrict__ psi, const float* part,
                                const int* part_idx, int n_part, float& axis,
                                float& psi_b, int& x_idx) {
  Red v{-INFINITY, INFINITY, INFINITY, INT_MAX};
  for (int b = threadIdx.x; b < n_part; b += blockDim.x) {
    const Red o{part[3 * b], part[3 * b + 1], part[3 * b + 2], part_idx[b]};
    combine(v, o);
  }
  const Red t = block_reduce(v);
  axis = (fabsf(t.mx) < 1e-6f) ? 1e-6f : t.mx;
  const bool any = t.bi != INT_MAX;
  float b = any ? psi[t.bi] : t.mn;
  if (fabsf(axis - b) < 0.1f) b = axis * 0.1f;
  psi_b = b;
  x_idx = any ? t.bi : 0;
}

__global__ void source_ipsum_kernel(const float* __restrict__ psi, const float* __restrict__ r,
                                    const float* __restrict__ part,
                                    const int* __restrict__ part_idx, int n_part, int nz, int nr,
                                    const float* __restrict__ par, int par_stride, float mu0,
                                    int h_mode, float* __restrict__ scal,
                                    int* __restrict__ x_out, float* __restrict__ ip_part) {
  const size_t e = blockIdx.y;   // the element of a batched call
  psi += e * nz * nr;
  part += e * 3 * n_part;
  part_idx += e * n_part;
  par += e * par_stride;
  scal += e * 3;
  x_out += e;
  ip_part += e * n_part;
  float axis, psi_b;
  int x_idx;
  finish_topology(psi, part, part_idx, n_part, axis, psi_b, x_idx);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    scal[0] = axis;
    scal[1] = psi_b;
    x_out[0] = x_idx;
  }
  const int n = nz * nr;
  float acc = 0.0f;
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < n; k += gridDim.x * blockDim.x) {
    acc += j_raw(psi[k], r[k % nr], axis, psi_b, par, mu0, h_mode);
  }
  const float s = block_sum(acc);
  if (threadIdx.x == 0) ip_part[blockIdx.x] = s;
}

__global__ void source_apply_kernel(const float* __restrict__ psi, const float* __restrict__ r,
                                    const float* __restrict__ ip_part, int n_part, int nz, int nr,
                                    const float* __restrict__ par, int par_stride, float mu0,
                                    int h_mode, float d_r, float d_z, float* __restrict__ scal,
                                    float* __restrict__ src) {
  const size_t e = blockIdx.y;   // the element of a batched call
  psi += e * nz * nr;
  ip_part += e * n_part;
  par += e * par_stride;
  scal += e * 3;
  src += e * nz * nr;
  float acc = 0.0f;
  for (int b = threadIdx.x; b < n_part; b += blockDim.x) acc += ip_part[b];
  const float i_current = block_sum(acc) * d_r * d_z;
  const float scale = (fabsf(i_current) > 1e-9f) ? par[8] / i_current : 0.0f;
  const float axis = scal[0];
  const float psi_b = scal[1];
  if (blockIdx.x == 0 && threadIdx.x == 0) scal[2] = i_current;
  const int n = nz * nr;
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < n; k += gridDim.x * blockDim.x) {
    const float rk = r[k % nr];
    src[k] = (-mu0 * rk) * (j_raw(psi[k], rk, axis, psi_b, par, mu0, h_mode) * scale);
  }
}

// The three phases in one cooperative launch.  A thread's k-th point is
// k0 + c * stride in every phase, as in the three kernels above, so every
// partial is the same sum in the same order.
constexpr int kKeep = 16;

__global__ void __launch_bounds__(kThreads, 2) source_fused_kernel(
    const float* __restrict__ psi, const float* __restrict__ r, const float* __restrict__ mask,
    const float* __restrict__ par, int nz, int nr, float d_r, float d_z, float mu0, int h_mode,
    float* part, int* part_idx, float* ip_part, float* __restrict__ scal,
    int* __restrict__ x_out, float* __restrict__ src) {
  // part, part_idx and ip_part are written by one block and read by all after
  // a grid barrier: plain pointers, so that no load of them is a cached
  // read-only one.
  cg::grid_group grid = cg::this_grid();
  const int n = nz * nr;
  const int stride = gridDim.x * blockDim.x;
  const int k0 = blockIdx.x * blockDim.x + threadIdx.x;
  const int n_part = gridDim.x;
  float keep[kKeep];

  Red v{-INFINITY, INFINITY, INFINITY, INT_MAX};
  auto look = [&](int k, float x) {
    v.mx = fmaxf(v.mx, x);
    v.mn = fminf(v.mn, x);
    if (mask[k] > 0.0f) {
      const int i = k / nr;
      const float b = grad_mag(psi, i, k - i * nr, nz, nr, d_r, d_z);
      if (better(b, k, v.b, v.bi)) {
        v.b = b;
        v.bi = k;
      }
    }
  };
#pragma unroll
  for (int c = 0; c < kKeep; ++c) {
    const int k = k0 + c * stride;
    keep[c] = k < n ? psi[k] : 0.0f;
    if (k < n) look(k, keep[c]);
  }
  for (int k = k0 + kKeep * stride; k < n; k += stride) look(k, psi[k]);
  const Red t = block_reduce(v);
  if (threadIdx.x == 0) {
    part[3 * blockIdx.x + 0] = t.mx;
    part[3 * blockIdx.x + 1] = t.mn;
    part[3 * blockIdx.x + 2] = t.b;
    part_idx[blockIdx.x] = t.bi;
  }
  grid.sync();

  float axis, psi_b;
  int x_idx;
  finish_topology(psi, part, part_idx, n_part, axis, psi_b, x_idx);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    scal[0] = axis;
    scal[1] = psi_b;
    x_out[0] = x_idx;
  }
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < kKeep; ++c) {
    const int k = k0 + c * stride;
    if (k < n) acc += j_raw(keep[c], r[k % nr], axis, psi_b, par, mu0, h_mode);
  }
  for (int k = k0 + kKeep * stride; k < n; k += stride) {
    acc += j_raw(psi[k], r[k % nr], axis, psi_b, par, mu0, h_mode);
  }
  const float s = block_sum(acc);
  if (threadIdx.x == 0) ip_part[blockIdx.x] = s;
  grid.sync();

  float total = 0.0f;
  for (int b = threadIdx.x; b < n_part; b += blockDim.x) total += ip_part[b];
  const float i_current = block_sum(total) * d_r * d_z;
  const float scale = (fabsf(i_current) > 1e-9f) ? par[8] / i_current : 0.0f;
  if (blockIdx.x == 0 && threadIdx.x == 0) scal[2] = i_current;
  auto apply = [&](int k, float x) {
    const float rk = r[k % nr];
    src[k] = (-mu0 * rk) * (j_raw(x, rk, axis, psi_b, par, mu0, h_mode) * scale);
  };
#pragma unroll
  for (int c = 0; c < kKeep; ++c) {
    const int k = k0 + c * stride;
    if (k < n) apply(k, keep[c]);
  }
  for (int k = k0 + kKeep * stride; k < n; k += stride) apply(k, psi[k]);
}

int n_blocks(int n) {
  const int b = (n + 4 * kThreads - 1) / (4 * kThreads);
  return b < 1 ? 1 : (b > 264 ? 264 : b);
}

}  // namespace

extern "C" int scpn_source_blocks(int n) { return n_blocks(n); }

// How many blocks of source_fused_kernel the device holds at once (a
// cooperative launch needs every block resident), or minus the CUDA error.
extern "C" int scpn_source_resident_blocks() {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, source_fused_kernel, kThreads,
                                                        0);
  }
  return err != cudaSuccess ? -static_cast<int>(err) : per_sm * sms;
}

// par = (p' ped_top, ped_width, ped_height, core_alpha, FF' same four, I_target).
// Workspace (allocated by the caller): part[3*B], part_idx[B], ip_part[B],
// with B = scpn_source_blocks(nz*nr).  Readout: scal = (psi_axis, psi_b,
// I_current), x_out = X-point linear index.  One cooperative launch.
extern "C" int scpn_fused_source(const void* psi, const void* r, const void* mask, const void* par,
                                 int nz, int nr, float d_r, float d_z, float mu0, int h_mode,
                                 void* part, void* part_idx, void* ip_part, void* scal,
                                 void* x_out, void* src, void* stream) {
  static int resident = 0;
  if (resident == 0) resident = scpn_source_resident_blocks();
  if (resident < 0) return -resident;
  const int nb = n_blocks(nz * nr);
  if (nb > resident) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&psi, &r, &mask, &par, &nz, &nr, &d_r, &d_z, &mu0, &h_mode,
                  &part, &part_idx, &ip_part, &scal, &x_out, &src};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(source_fused_kernel), dim3(nb), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? static_cast<int>(err) : static_cast<int>(cudaGetLastError());
}

namespace {

// The three kernels on a (blocks, n_batch) grid; element e reads its
// parameters at par + e * par_stride.
int launch_staged(const void* psi, const void* r, const void* mask, const void* par,
                  int par_stride, int nz, int nr, int n_batch, float d_r, float d_z, float mu0,
                  int h_mode, void* part, void* part_idx, void* ip_part, void* scal, void* x_out,
                  void* src, void* stream) {
  const int nb = n_blocks(nz * nr);
  const dim3 grid(nb, n_batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  source_reduce_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(psi), static_cast<const float*>(mask), nz, nr, d_r, d_z,
      static_cast<float*>(part), static_cast<int*>(part_idx));
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  source_ipsum_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(psi), static_cast<const float*>(r),
      static_cast<const float*>(part), static_cast<const int*>(part_idx), nb, nz, nr,
      static_cast<const float*>(par), par_stride, mu0, h_mode, static_cast<float*>(scal),
      static_cast<int*>(x_out), static_cast<float*>(ip_part));
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  source_apply_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(psi), static_cast<const float*>(r),
      static_cast<const float*>(ip_part), nb, nz, nr, static_cast<const float*>(par),
      par_stride, mu0, h_mode, d_r, d_z, static_cast<float*>(scal), static_cast<float*>(src));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The same function as three launches (arguments as scpn_fused_source).
extern "C" int scpn_fused_source_staged(const void* psi, const void* r, const void* mask,
                                        const void* par, int nz, int nr, float d_r, float d_z,
                                        float mu0, int h_mode, void* part, void* part_idx,
                                        void* ip_part, void* scal, void* x_out, void* src,
                                        void* stream) {
  return launch_staged(psi, r, mask, par, 0, nz, nr, 1, d_r, d_z, mu0, h_mode, part, part_idx,
                       ip_part, scal, x_out, src, stream);
}

// n_batch grids of one shape in three launches: psi and src (n_batch, nz, nr),
// par (n_batch, par_stride) with the layout of scpn_fused_source's par, r and
// mask shared.  Workspace: part[3*B*nb], part_idx[B*nb], ip_part[B*nb],
// scal[3*B], x_out[B], with nb = scpn_source_blocks(nz*nr), element-major.
extern "C" int scpn_fused_source_batched(const void* psi, const void* r, const void* mask,
                                         const void* par, int par_stride, int nz, int nr,
                                         int n_batch, float d_r, float d_z, float mu0,
                                         int h_mode, void* part, void* part_idx, void* ip_part,
                                         void* scal, void* x_out, void* src, void* stream) {
  if (n_batch < 1 || n_batch > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  return launch_staged(psi, r, mask, par, par_stride, nz, nr, n_batch, d_r, d_z, mu0, h_mode,
                       part, part_idx, ip_part, scal, x_out, src, stream);
}
