// Fused topology + Grad-Shafranov source, as three launches.
//
// Replaces: scpn_fusion_tpu/ops/pallas_source.py:_fused_source_kernel (entry
// fused_topology_source).
//
//   1. source_reduce_kernel: block partials of max psi, min psi and the
//      masked first-row-major argmin of |grad psi| over the divertor mask.
//   2. source_ipsum_kernel: every block finishes pass 1 from the partials
//      (psi_axis floored at 1e-6; psi_b = psi at the X-point, or min psi when
//      the mask is empty; the |axis - b| < 0.1 snap), block 0 writes the
//      scalar readout, then every block sums its share of the unnormalised
//      J_phi for the Ip renormalisation.
//   3. source_apply_kernel: every block finishes the Ip sum from the
//      partials and writes -mu0 R J_phi * scale elementwise.
//
// What bounds it on an H100: psi is read three times (~3 MB at 513^2, L2
// resident) and src written once; the reductions need a grid-wide result
// before the elementwise pass, which on Hopper means separate launches
// (blocks run in no order and share nothing).  Launch latency dominates.
//
// What the design does about it: the small finishing reductions are done
// redundantly by every block of the next launch (a few hundred partials), so
// there is no extra one-block launch and no atomics, and every sum is taken
// in a fixed order (deterministic).  The argmin keeps (value, index) pairs
// and breaks ties toward the lower linear index, which is exactly the
// "first row-major minimum" of the JAX path.  |grad psi| is computed with
// round-to-nearest intrinsics (no contraction into FMA), in the operation
// order of the plain PyTorch version, so both pick the same X-point site.

#include <climits>

#include "common.cuh"

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
  const bool inside = (pn >= 0.0f) && (pn < 1.0f);
  const float y = fminf(fmaxf((c[0] - pn) / c[1], -20.0f), 20.0f);
  const float pedestal = 0.5f * c[2] * (1.0f + tanhf(y));
  const float q = pn / c[0];
  const float core = (pn < c[0]) ? fmaxf(0.0f, 1.0f - q * q) : 0.0f;
  return inside ? pedestal + c[3] * core : 0.0f;
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
  return 0.5f * (r * pp) + 0.5f * (ff / (mu0 * r));
}

__global__ void source_reduce_kernel(const float* __restrict__ psi,
                                     const float* __restrict__ mask, int nz, int nr, float d_r,
                                     float d_z, float* __restrict__ part,
                                     int* __restrict__ part_idx) {
  const int n = nz * nr;
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
__device__ void finish_topology(const float* __restrict__ psi, const float* __restrict__ part,
                                const int* __restrict__ part_idx, int n_part, float& axis,
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
                                    const float* __restrict__ par, float mu0, int h_mode,
                                    float* __restrict__ scal, int* __restrict__ x_out,
                                    float* __restrict__ ip_part) {
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
                                    const float* __restrict__ par, float mu0, int h_mode,
                                    float d_r, float d_z, float* __restrict__ scal,
                                    float* __restrict__ src) {
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

int n_blocks(int n) {
  const int b = (n + 4 * kThreads - 1) / (4 * kThreads);
  return b < 1 ? 1 : (b > 264 ? 264 : b);
}

}  // namespace

extern "C" int scpn_source_blocks(int n) { return n_blocks(n); }

// par = (p' ped_top, ped_width, ped_height, core_alpha, FF' same four, I_target).
// Workspace (allocated by the caller): part[3*B], part_idx[B], ip_part[B],
// with B = scpn_source_blocks(nz*nr).  Readout: scal = (psi_axis, psi_b,
// I_current), x_out = X-point linear index.
extern "C" int scpn_fused_source(const void* psi, const void* r, const void* mask, const void* par,
                                 int nz, int nr, float d_r, float d_z, float mu0, int h_mode,
                                 void* part, void* part_idx, void* ip_part, void* scal,
                                 void* x_out, void* src, void* stream) {
  const int nb = n_blocks(nz * nr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  source_reduce_kernel<<<nb, kThreads, 0, st>>>(
      static_cast<const float*>(psi), static_cast<const float*>(mask), nz, nr, d_r, d_z,
      static_cast<float*>(part), static_cast<int*>(part_idx));
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  source_ipsum_kernel<<<nb, kThreads, 0, st>>>(
      static_cast<const float*>(psi), static_cast<const float*>(r),
      static_cast<const float*>(part), static_cast<const int*>(part_idx), nb, nz, nr,
      static_cast<const float*>(par), mu0, h_mode, static_cast<float*>(scal),
      static_cast<int*>(x_out), static_cast<float*>(ip_part));
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  source_apply_kernel<<<nb, kThreads, 0, st>>>(
      static_cast<const float*>(psi), static_cast<const float*>(r),
      static_cast<const float*>(ip_part), nb, nz, nr, static_cast<const float*>(par), mu0,
      h_mode, d_r, d_z, static_cast<float*>(scal), static_cast<float*>(src));
  return static_cast<int>(cudaGetLastError());
}
