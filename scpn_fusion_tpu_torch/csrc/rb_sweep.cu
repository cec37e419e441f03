// Red-black SOR sweeps of the toroidal GS* stencil.
//
// Replaces: scpn_fusion_tpu/ops/pallas_stencil.py:_sor_kernel (entry
// sor_sweeps_pallas), and the smoothing stages inside
// scpn_fusion_tpu/ops/pallas_mg.py:_fused_vcycle_kernel, _fine_pre_kernel and
// _fine_post_kernel.
//
// What bounds it on an H100: a half-sweep reads psi (5 points, mostly from
// L1/L2), src and the R row and writes psi once per updated point, about
// 12 bytes of DRAM traffic per updated point, so a 513^2 half-sweep moves
// ~1.6 MB, under a microsecond at 3.35 TB/s and resident in the 50 MB L2 in
// any case.  At 513^2 and 257^2 the launch (a few microseconds) costs more
// than the work; on the small levels the launch is all of the cost.
//
// What the design does about it: the Pallas kernel kept the whole grid in
// VMEM; a Hopper SM has at most 227 KB of shared memory, so large levels use
// one global-memory launch per half-sweep (rb_half_sweep_kernel, one thread
// per point, red points read only black neighbours so the update is in
// place).  Levels whose psi and src fit in 48 KB of shared memory (up to
// 65^2) run every sweep of the stage in ONE single-block launch
// (rb_sweeps_smem_kernel) with __syncthreads() between half-sweeps, which
// turns the 100 launches of the 50 coarsest-level sweeps into one.

#include "common.cuh"

namespace {

__global__ void rb_half_sweep_kernel(float* psi, const float* __restrict__ src,
                                     const float* __restrict__ r, int r_stride, int nz, int nr,
                                     float inv_dr2, float dr, float a_ns, float inv_ac,
                                     float omega, int parity) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i < 1 || i > nz - 2 || j < 1 || j > nr - 2 || ((i + j) & 1) != parity) return;
  float a_e, a_w;
  scpn::stencil_ew(r, r_stride, j, inv_dr2, dr, a_e, a_w);
  const int idx = i * nr + j;
  psi[idx] = scpn::rb_update(psi, src, idx, nr, a_e, a_w, a_ns, inv_ac, omega);
}

__global__ void rb_sweeps_smem_kernel(float* psi, const float* __restrict__ src,
                                      const float* __restrict__ r, int r_stride, int nz, int nr,
                                      float inv_dr2, float dr, float a_ns, float inv_ac,
                                      float omega, int n_sweeps) {
  extern __shared__ float sm[];
  const int n = nz * nr;
  float* p = sm;
  float* s = sm + n;
  float* ae = s + n;
  float* aw = ae + nr;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    p[k] = psi[k];
    s[k] = src[k];
  }
  for (int j = threadIdx.x; j < nr; j += blockDim.x) {
    scpn::stencil_ew(r, r_stride, j, inv_dr2, dr, ae[j], aw[j]);
  }
  __syncthreads();
  for (int sweep = 0; sweep < n_sweeps; ++sweep) {
    for (int parity = 0; parity < 2; ++parity) {
      for (int k = threadIdx.x; k < n; k += blockDim.x) {
        const int i = k / nr;
        const int j = k - i * nr;
        if (i >= 1 && i <= nz - 2 && j >= 1 && j <= nr - 2 && ((i + j) & 1) == parity) {
          p[k] = scpn::rb_update(p, s, k, nr, ae[j], aw[j], a_ns, inv_ac, omega);
        }
      }
      __syncthreads();
    }
  }
  for (int k = threadIdx.x; k < n; k += blockDim.x) psi[k] = p[k];
}

}  // namespace

extern "C" int scpn_rb_half_sweep(void* psi, const void* src, const void* r, int r_stride,
                                  int nz, int nr, float inv_dr2, float dr, float a_ns,
                                  float inv_ac, float omega, int parity, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((nr + block.x - 1) / block.x, (nz + block.y - 1) / block.y);
  rb_half_sweep_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(psi), static_cast<const float*>(src), static_cast<const float*>(r),
      r_stride, nz, nr, inv_dr2, dr, a_ns, inv_ac, omega, parity);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int scpn_rb_sweeps_smem(void* psi, const void* src, const void* r, int r_stride,
                                   int nz, int nr, float inv_dr2, float dr, float a_ns,
                                   float inv_ac, float omega, int n_sweeps, void* stream) {
  const size_t smem =
      (2 * static_cast<size_t>(nz) * nr + 2 * static_cast<size_t>(nr)) * sizeof(float);
  rb_sweeps_smem_kernel<<<1, 1024, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(psi), static_cast<const float*>(src), static_cast<const float*>(r),
      r_stride, nz, nr, inv_dr2, dr, a_ns, inv_ac, omega, n_sweeps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* scpn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
