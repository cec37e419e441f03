// Tiled fine-level V-cycle legs, first design: one launch per leg, every stage
// of the leg in shared memory, every thread striding over the slab's points.
//
// These are the predecessors of tiled_legs.cu's kernels (the same functions,
// pallas_mg_tiled.py:_tiled_pre_kernel and :_tiled_post_kernel).  No solver
// path calls them: they stay as the reference the redesigned kernels must
// equal bit for bit and as the earlier time measured beside them.
//
// One CTA per TILE x TILE output tile (tile origin even).  It loads the
// (TILE + 2H)^2 slab of psi and src, with zeros outside the grid, and the
// east/west coefficients of its columns into shared memory, runs every
// half-sweep over the whole slab but its edge with __syncthreads() between
// them, and writes only the tile's core.  H = 2 * sweeps + 2 on both legs;
// red/black parity and the interior mask come from GLOBAL indices
// (pallas_mg_tiled.py:21-36).  The down leg computes the defect at the nine
// fine points of each coarse core point from the slab; the up leg adds the
// prolonged compact coarse error, read from global memory, while it loads
// the slab.  What holds them back on an H100: eight shared-memory words and
// an integer division a point update, 2-way bank conflicts on the stride-2
// reads, a (64 + 16)^2 slab swept whole in every half-sweep, and a 33rd tile
// row and column that sweep a full slab for a one-point core.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct Slab {
  int row0, col0;  // global index of slab point (0, 0): tile origin minus the halo
  int n;           // slab edge, TILE + 2H
};

__device__ __forceinline__ void load_slab(const Slab& sl, const float* __restrict__ psi,
                                          const float* __restrict__ src,
                                          const float* __restrict__ e, int nrc,
                                          const float* __restrict__ r, int r_stride, int nz,
                                          int nr, float inv_dr2, float dr, float* p, float* s,
                                          float* ae, float* aw) {
  const int n2 = sl.n * sl.n;
  for (int k = threadIdx.x; k < n2; k += blockDim.x) {
    const int h = k / sl.n;
    const int w = k - h * sl.n;
    const int i = sl.row0 + h;
    const int j = sl.col0 + w;
    float pv = 0.0f, sv = 0.0f;
    if (i >= 0 && i < nz && j >= 0 && j < nr) {
      const int g = i * nr + j;
      pv = psi[g];
      sv = src[g];
      if (e != nullptr && i >= 1 && i <= nz - 2 && j >= 1 && j <= nr - 2) {
        pv = pv + scpn::prolong_at(e, nrc, i, j);
      }
    }
    p[k] = pv;
    s[k] = sv;
  }
  for (int w = threadIdx.x; w < sl.n; w += blockDim.x) {
    const int j = sl.col0 + w;
    float a_e = 0.0f, a_w = 0.0f;
    if (j >= 0 && j < nr) scpn::stencil_ew(r, r_stride, j, inv_dr2, dr, a_e, a_w);
    ae[w] = a_e;
    aw[w] = a_w;
  }
  __syncthreads();
}

// n_sweeps red-black sweeps over the slab points that are inside the global
// interior and off the slab edge.
__device__ __forceinline__ void sweep_slab(const Slab& sl, float* p, const float* s,
                                           const float* ae, const float* aw, int nz, int nr,
                                           float a_ns, float inv_ac, float omega,
                                           int n_sweeps) {
  const int h_lo = max(1, 1 - sl.row0), h_hi = min(sl.n - 2, nz - 2 - sl.row0);
  const int w_lo = max(1, 1 - sl.col0), w_hi = min(sl.n - 2, nr - 2 - sl.col0);
  const int rows = max(0, h_hi - h_lo + 1);
  const int per_row = max(0, (w_hi - w_lo + 2) / 2);  // points of one colour a row, at most
  for (int sweep = 0; sweep < n_sweeps; ++sweep) {
    for (int parity = 0; parity < 2; ++parity) {
      for (int k = threadIdx.x; k < rows * per_row; k += blockDim.x) {
        const int q = k / per_row;
        const int h = h_lo + q;
        // first column of this colour in the row: (i + j) % 2 == parity, global i, j
        const int w = w_lo + ((sl.row0 + h + sl.col0 + w_lo + parity) & 1) + 2 * (k - q * per_row);
        if (w <= w_hi) {
          const int idx = h * sl.n + w;
          p[idx] = scpn::rb_update(p, s, idx, sl.n, ae[w], aw[w], a_ns, inv_ac, omega);
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ void store_core(const Slab& sl, const float* p, int tile, int halo,
                                           int nz, int nr, float* __restrict__ out) {
  const int z0 = sl.row0 + halo, r0 = sl.col0 + halo;
  const int rows = min(tile, nz - z0), cols = min(tile, nr - r0);
  for (int k = threadIdx.x; k < rows * cols; k += blockDim.x) {
    const int h = k / cols;
    const int w = k - h * cols;
    out[(z0 + h) * nr + r0 + w] = p[(halo + h) * sl.n + halo + w];
  }
}

// Defect at global fine point (i, j) = slab point (h, w); zero off the interior.
__device__ __forceinline__ float slab_defect(const Slab& sl, const float* p, const float* s,
                                             const float* ae, const float* aw, int h, int w,
                                             int nz, int nr, float a_ns, float a_c) {
  const int i = sl.row0 + h, j = sl.col0 + w;
  if (i < 1 || i > nz - 2 || j < 1 || j > nr - 2) return 0.0f;
  return scpn::gs_defect(p, s, h * sl.n + w, sl.n, ae[w], aw[w], a_ns, a_c);
}

__global__ void __launch_bounds__(kThreads) tiled_pre_slab_kernel(
    const float* __restrict__ psi, const float* __restrict__ src, const float* __restrict__ r,
    int r_stride, int nz, int nr, int tile, int halo, int n_sweeps, float inv_dr2, float dr,
    float a_ns, float a_c, float inv_ac, float omega, float* __restrict__ psi_out,
    float* __restrict__ d_c) {
  extern __shared__ float sm[];
  const Slab sl{static_cast<int>(blockIdx.y) * tile - halo,
                static_cast<int>(blockIdx.x) * tile - halo, tile + 2 * halo};
  float* p = sm;
  float* s = p + sl.n * sl.n;
  float* ae = s + sl.n * sl.n;
  float* aw = ae + sl.n;
  load_slab(sl, psi, src, nullptr, 0, r, r_stride, nz, nr, inv_dr2, dr, p, s, ae, aw);
  sweep_slab(sl, p, s, ae, aw, nz, nr, a_ns, inv_ac, omega, n_sweeps);
  store_core(sl, p, tile, halo, nz, nr, psi_out);

  // Coarse points of the core: fine rows/columns 2*ic in [z0, z0 + tile).
  const int nzc = (nz + 1) / 2, nrc = (nr + 1) / 2;
  const int ic0 = (sl.row0 + halo) / 2, jc0 = (sl.col0 + halo) / 2;
  const int crows = min(tile / 2, nzc - ic0), ccols = min(tile / 2, nrc - jc0);
  for (int k = threadIdx.x; k < crows * ccols; k += blockDim.x) {
    const int ic = ic0 + k / ccols;
    const int jc = jc0 + k % ccols;
    float out = 0.0f;
    if (ic >= 1 && ic <= nzc - 2 && jc >= 1 && jc <= nrc - 2) {
      const int h = 2 * ic - sl.row0;
      const int w = 2 * jc - sl.col0;
      out = scpn::full_weight([&](int di, int dj) {
        return slab_defect(sl, p, s, ae, aw, h + di, w + dj, nz, nr, a_ns, a_c);
      });
    }
    d_c[ic * nrc + jc] = out;
  }
}

__global__ void __launch_bounds__(kThreads) tiled_post_slab_kernel(
    const float* __restrict__ psi_s, const float* __restrict__ src,
    const float* __restrict__ e, const float* __restrict__ r, int r_stride, int nz, int nr,
    int tile, int halo, int n_sweeps, float inv_dr2, float dr, float a_ns, float inv_ac,
    float omega, float* __restrict__ out) {
  extern __shared__ float sm[];
  const Slab sl{static_cast<int>(blockIdx.y) * tile - halo,
                static_cast<int>(blockIdx.x) * tile - halo, tile + 2 * halo};
  float* p = sm;
  float* s = p + sl.n * sl.n;
  float* ae = s + sl.n * sl.n;
  float* aw = ae + sl.n;
  load_slab(sl, psi_s, src, e, (nr + 1) / 2, r, r_stride, nz, nr, inv_dr2, dr, p, s, ae, aw);
  sweep_slab(sl, p, s, ae, aw, nz, nr, a_ns, inv_ac, omega, n_sweeps);
  store_core(sl, p, tile, halo, nz, nr, out);
}

size_t slab_bytes(int tile, int halo) {
  const size_t n = static_cast<size_t>(tile) + 2 * static_cast<size_t>(halo);
  return (2 * n * n + 2 * n) * sizeof(float);
}

// Opt in to more than 48 KB of dynamic shared memory once per kernel and size.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  allowed = bytes;
  return 0;
}

}  // namespace

extern "C" int scpn_tiled_pre_slab(const void* psi, const void* src, const void* r, int r_stride,
                              int nz, int nr, int tile, int halo, int n_sweeps, float inv_dr2,
                              float dr, float a_ns, float a_c, float inv_ac, float omega,
                              void* psi_out, void* d_c, void* stream) {
  static size_t allowed = 48 * 1024;
  const size_t smem = slab_bytes(tile, halo);
  const int err = allow_smem(tiled_pre_slab_kernel, smem, allowed);
  if (err != 0) return err;
  const dim3 grid((nr + tile - 1) / tile, (nz + tile - 1) / tile);
  tiled_pre_slab_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(psi), static_cast<const float*>(src),
      static_cast<const float*>(r), r_stride, nz, nr, tile, halo, n_sweeps, inv_dr2, dr, a_ns,
      a_c, inv_ac, omega, static_cast<float*>(psi_out), static_cast<float*>(d_c));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int scpn_tiled_post_slab(const void* psi_s, const void* src, const void* e, const void* r,
                               int r_stride, int nz, int nr, int tile, int halo, int n_sweeps,
                               float inv_dr2, float dr, float a_ns, float inv_ac, float omega,
                               void* out, void* stream) {
  static size_t allowed = 48 * 1024;
  const size_t smem = slab_bytes(tile, halo);
  const int err = allow_smem(tiled_post_slab_kernel, smem, allowed);
  if (err != 0) return err;
  const dim3 grid((nr + tile - 1) / tile, (nz + tile - 1) / tile);
  tiled_post_slab_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(psi_s), static_cast<const float*>(src),
      static_cast<const float*>(e), static_cast<const float*>(r), r_stride, nz, nr, tile, halo,
      n_sweeps, inv_dr2, dr, a_ns, inv_ac, omega, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
