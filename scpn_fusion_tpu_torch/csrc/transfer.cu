// Multigrid transfer legs on compacted levels.
//
// defect_restrict_kernel replaces the defect + full-weighting part of
// scpn_fusion_tpu/ops/pallas_mg.py:_fine_pre_kernel (and the MXU compaction
// plus zeroed coarse ring at pallas_mg.py:374-381), and the restriction step
// of _fused_vcycle_kernel.  prolong_correct_kernel replaces the
// upsample_even_mxu + conv9 bilinear prolongation of _fine_post_kernel
// (pallas_mg.py:313-314) and the prolongation step of _fused_vcycle_kernel.
//
// What bounds them on an H100: memory and launches.  defect_restrict reads
// the fine psi and src (8 bytes a fine point, the 9-point footprint is
// served from L1/L2) and writes a quarter as many coarse points;
// prolong_correct reads psi_s and a quarter-size error and writes psi
// (about 9 bytes a fine point).  At 513^2 that is ~2 MB a leg, well under
// the launch cost.
//
// What the design does about it: the defect s - L[psi] is never stored; each
// coarse thread recomputes it at its nine fine points (zero on the fine
// ring) and writes the compact coarse array with a zero ring, so no
// fine-size intermediate and no separate compaction pass exist.  The
// prolongation reads the compact coarse error directly by phase (coincident
// copy, edge mid-points average 2, centres average 4) instead of embedding it
// at stride 2 first.

#include "common.cuh"

namespace {

__device__ __forceinline__ float defect_at(const float* __restrict__ p, const float* __restrict__ s,
                                           const float* __restrict__ r, int r_stride, int i, int j,
                                           int nz, int nr, float inv_dr2, float dr, float a_ns,
                                           float a_c) {
  if (i < 1 || i > nz - 2 || j < 1 || j > nr - 2) return 0.0f;
  float a_e, a_w;
  scpn::stencil_ew(r, r_stride, j, inv_dr2, dr, a_e, a_w);
  return scpn::gs_defect(p, s, i * nr + j, nr, a_e, a_w, a_ns, a_c);
}

__global__ void defect_restrict_kernel(const float* __restrict__ psi,
                                       const float* __restrict__ src,
                                       const float* __restrict__ r, int r_stride, int nz, int nr,
                                       int nzc, int nrc, float inv_dr2, float dr, float a_ns,
                                       float a_c, float* __restrict__ d_c) {
  const int jc = blockIdx.x * blockDim.x + threadIdx.x;
  const int ic = blockIdx.y * blockDim.y + threadIdx.y;
  if (ic >= nzc || jc >= nrc) return;
  float out = 0.0f;
  if (ic >= 1 && ic <= nzc - 2 && jc >= 1 && jc <= nrc - 2) {
    const int i = 2 * ic;
    const int j = 2 * jc;
    out = scpn::full_weight([&](int di, int dj) {
      return defect_at(psi, src, r, r_stride, i + di, j + dj, nz, nr, inv_dr2, dr, a_ns, a_c);
    });
  }
  d_c[ic * nrc + jc] = out;
}

__global__ void prolong_correct_kernel(const float* __restrict__ psi_s,
                                       const float* __restrict__ e, int nz, int nr, int nzc,
                                       int nrc, float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nz || j >= nr) return;
  const int idx = i * nr + j;
  float v = psi_s[idx];
  if (i >= 1 && i <= nz - 2 && j >= 1 && j <= nr - 2) v = v + scpn::prolong_at(e, nrc, i, j);
  out[idx] = v;
}

}  // namespace

extern "C" int scpn_defect_restrict(const void* psi, const void* src, const void* r, int r_stride,
                                    int nz, int nr, int nzc, int nrc, float inv_dr2, float dr,
                                    float a_ns, float a_c, void* d_c, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((nrc + block.x - 1) / block.x, (nzc + block.y - 1) / block.y);
  defect_restrict_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(psi), static_cast<const float*>(src),
      static_cast<const float*>(r), r_stride, nz, nr, nzc, nrc, inv_dr2, dr, a_ns, a_c,
      static_cast<float*>(d_c));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int scpn_prolong_correct(const void* psi_s, const void* e, int nz, int nr, int nzc,
                                    int nrc, void* out, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((nr + block.x - 1) / block.x, (nz + block.y - 1) / block.y);
  prolong_correct_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(psi_s), static_cast<const float*>(e), nz, nr, nzc, nrc,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
