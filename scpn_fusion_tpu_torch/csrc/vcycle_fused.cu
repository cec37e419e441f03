// The whole multigrid V-cycle tail in one launch.
//
// Replaces: scpn_fusion_tpu/ops/pallas_mg.py:52 _fused_vcycle_kernel (entry
// fused_coarse_vcycle): pre-smooth, full-weighted defect, recurse, bilinear
// correction, post-smooth on every level from the entry (at most 257^2) down
// to the coarsest, which gets coarse_sweeps red-black sweeps.
//
// What bounds it on an H100: neither bytes nor operations (the entry level's
// fields are under 1 MB and the whole cycle a few Mflop) but the chain of
// dependent stages.  From 257^2 with (1,2) smoothing and min_grid 5 there are
// 48 half-sweep and transfer stages on the six upper levels plus the 100
// half-sweeps of the 5^2 solve, each of which needs the one before it
// finished everywhere.  The time is the number of stages times the cost of
// one barrier; as separate launches a barrier costs a launch (and the host's
// time to enqueue it).
//
// What the design does about it: one launch of one thread-block cluster, with
// every level resident in shared memory for the whole cycle and the cheapest
// barrier that covers a stage's threads between stages.
//
//  * Levels of 129^2 and more do not fit one SM beside the levels below
//    (257^2: 2 x 264 KB).  They are cut into row bands over the 8 CTAs of the
//    cluster: a CTA holds 32 (16) rows of psi and of the right-hand side of
//    the 257^2 (129^2) level, reads the edge rows of its neighbours through
//    distributed shared memory, and cluster.sync() stands between stages.
//    In a red-black half-sweep a CTA writes only points of one colour and
//    reads only the other, so the remote reads race with nothing.
//  * Levels of 65^2 and 33^2 live in CTA 0 alone, a __syncthreads() apart.
//    The restriction from a banded level is computed by the CTAs that own the
//    fine rows and written into CTA 0's shared memory; the prolongation back
//    reads CTA 0's rows remotely.
//  * Levels of 17^2 and less (at most 225 interior points) are swept by one
//    warp with __syncwarp() between half-sweeps: the 100 dependent
//    half-sweeps of the 5^2 solve never wait for a block-wide barrier.
//  * Threads are laid out by shifts and masks over the level's width
//    (n - 1 = 2^k), so no index inside a sweep costs an integer division, and
//    a thread keeps the coefficients of its columns in registers.  Levels of
//    5^2 and less give each interior point a lane that keeps everything but
//    psi in registers.
//
// What is left (NVIDIA H100 80GB HBM3, torch.profiler): a stage costs about
// 0.5 us a block barrier apart and 1.2 us a cluster barrier apart
// (cluster.sync() carries a device-wide fence), a half-sweep of a 257^2 band
// about 2 us: its stride-2 accesses are two-way bank conflicts, and the 9
// shared-memory accesses of an update, not the arithmetic, fill the time.
//
// Batched (entry scpn_fused_vcycle_batched; the ensemble of
// parallel/ensemble.py, the counterpart of vmap over pallas_call): B
// clusters in one grid of (n_cta, B) blocks, cluster c the V-cycle of
// element c = blockIdx.y.  The element only offsets the entry level's psi,
// rhs and output; every other instruction is the unbatched launch's, so
// element b equals the unbatched launch on element b bit for bit.  The
// device holds scpn_fused_vcycle_clusters() clusters at once; the rest run
// in waves.
//
// Same numbers as the staged launches (rb_sweep.cu + transfer.cu): levels
// are compact, parity is (i + j) & 1 on the level's own indices, the
// Dirichlet ring is never written, the coarse defect ring and the coarse
// first guess are zero, nothing is clipped, and the arithmetic is the
// helpers of common.cuh (stencil_ew, rb_value, defect_value, full_weight,
// prolong_rows) with the level constants rounded to float exactly as the
// staged launchers pass them.  The layout of levels in shared memory (the
// Plan below) is made by ops/cuda_mg.py:vcycle_launch_plan, which the CPU
// tests check.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kMaxLevels = 8;

enum Scope { kWarp = 0, kBlock = 1, kCluster = 2 };

// Mirrors ops/cuda_mg.py:_PlanStruct field for field (4-byte members only).
struct Plan {
  int n_levels, n_cta, pre, post, coarse_sweeps, smem_bytes;
  float omega;
  int n[kMaxLevels];           // level sizes, entry first
  int log_half[kMaxLevels];    // log2((n - 1) / 2)
  int band_shift[kMaxLevels];  // log2(rows a CTA) of a banded level, else 31
  int scope[kMaxLevels];       // the threads that work on the level
  int rows[kMaxLevels];        // rows a CTA holds of the level
  int off[kMaxLevels];         // float offset of the level in shared memory
  float inv_dr2[kMaxLevels], dr[kMaxLevels], a_ns[kMaxLevels], a_c[kMaxLevels],
      inv_ac[kMaxLevels];
};

// One level as this CTA sees it: where its own rows [lo, hi) of psi (p) and of
// the right-hand side (s) and the level's coefficient rows (ae, aw) start in
// shared memory, as float indices (the same in every CTA).
struct Level {
  int p, s, ae, aw;
  int n, log_half, band_shift, lo, hi;
  float a_ns, a_c, inv_ac;
};

// Who works on a level, as seen by one thread.
struct Team {
  int rank, last;   // this CTA and the last CTA of the cluster
  int scope;
  bool active;      // this thread takes part
  int tid, size;    // its index among the CTA's threads that do, and their number
};

__device__ __forceinline__ Level level_of(const Plan& pl, int l, int rank) {
  Level lv;
  lv.n = pl.n[l];
  lv.log_half = pl.log_half[l];
  lv.band_shift = pl.band_shift[l];
  const int size = pl.rows[l] * lv.n;
  lv.p = pl.off[l];
  lv.s = lv.p + size;
  lv.ae = lv.s + size;
  lv.aw = lv.ae + lv.n;
  if (pl.scope[l] == kCluster) {
    lv.lo = rank << lv.band_shift;
    lv.hi = (rank == pl.n_cta - 1) ? lv.n : lv.lo + (1 << lv.band_shift);
  } else {
    lv.lo = 0;
    lv.hi = lv.n;
  }
  lv.a_ns = pl.a_ns[l];
  lv.a_c = pl.a_c[l];
  lv.inv_ac = pl.inv_ac[l];
  return lv;
}

__device__ __forceinline__ Team team_of(const Plan& pl, int l, int rank) {
  Team tm;
  tm.rank = rank;
  tm.last = pl.n_cta - 1;
  tm.scope = pl.scope[l];
  const int t = threadIdx.x;
  if (tm.scope == kWarp) {
    tm.active = rank == 0 && t < 32;
    tm.tid = t & 31;
    tm.size = 32;
  } else {
    tm.active = tm.scope == kCluster || rank == 0;
    tm.tid = t;
    tm.size = kThreads;
  }
  return tm;
}

__device__ __forceinline__ void team_sync(cg::cluster_group& cl, int scope) {
  if (scope == kCluster) cl.sync();
  else if (scope == kBlock) __syncthreads();
  else __syncwarp();
}

// Row i of a level's field (field: lv.p or lv.s) wherever it lives: in this
// CTA's shared memory or in the owner's, through the cluster's distributed
// shared memory.  Every CTA lays its shared memory out alike.
__device__ __forceinline__ float* row_ptr(cg::cluster_group& cl, float* sm, int field,
                                          const Level& lv, int i, const Team& tm) {
  int owner = i >> lv.band_shift;
  owner = owner > tm.last ? tm.last : owner;
  float* row = sm + field + (i - (owner << lv.band_shift)) * lv.n;
  return owner == tm.rank ? row : cl.map_shared_rank(row, owner);
}

// The east/west coefficients of the two columns a thread sweeps (1 + 2 tx,
// odd, and 2 + 2 tx, even), held in registers over a stage's half-sweeps.
struct Coeffs {
  float ae_odd, aw_odd, ae_even, aw_even;
};

// One colour of one red-black sweep over this CTA's rows.  up / dn are rows
// lo - 1 and hi of psi (in the neighbours' shared memory), where they exist;
// everything else is this CTA's own shared memory.
__device__ __forceinline__ void half_sweep(float* sm, const Level& lv, const Coeffs& co,
                                           const float* up, const float* dn, int parity,
                                           float omega, const Team& tm) {
  const int tx = tm.tid & ((1 << lv.log_half) - 1);
  const int step = tm.size >> lv.log_half;
  const int i0 = lv.lo > 1 ? lv.lo : 1;
  const int i1 = lv.hi < lv.n - 1 ? lv.hi : lv.n - 1;
  for (int i = i0 + (tm.tid >> lv.log_half); i < i1; i += step) {
    const int even = (i + 1 + parity) & 1;
    const int j = 1 + even + 2 * tx;   // (i + j) & 1 == parity
    if (j > lv.n - 2) continue;
    const int at = lv.p + (i - lv.lo) * lv.n + j;
    const float north = (i + 1 == lv.hi) ? dn[j] : sm[at + lv.n];
    const float south = (i == lv.lo) ? up[j] : sm[at - lv.n];
    sm[at] = scpn::rb_value(sm[at], sm[at + 1], sm[at - 1], north, south,
                            sm[at + (lv.s - lv.p)], even ? co.ae_even : co.ae_odd,
                            even ? co.aw_even : co.aw_odd, lv.a_ns, lv.inv_ac, omega);
  }
}

// count red-black sweeps of a level of at most 5^2 (9 interior points) by one
// warp: a lane owns one point and keeps its address, coefficients and
// right-hand side in registers, so a half-sweep is four loads, the update and
// a store.  This is the coarsest solve's 100 dependent half-sweeps.
__device__ __forceinline__ void tiny_sweeps(float* sm, const Level& lv, int count, float omega,
                                            const Team& tm) {
  const int m = lv.n - 2;
  const int i = 1 + tm.tid / m;
  const int j = 1 + tm.tid % m;
  const bool mine = tm.active && tm.tid < m * m;
  const int at = lv.p + i * lv.n + j;
  const int colour = (i + j) & 1;
  float a_e = 0.0f, a_w = 0.0f, rhs = 0.0f;
  if (mine) {
    a_e = sm[lv.ae + j];
    a_w = sm[lv.aw + j];
    rhs = sm[lv.s + i * lv.n + j];
  }
  for (int k = 0; k < 2 * count; ++k) {
    if (mine && colour == (k & 1)) {
      sm[at] = scpn::rb_value(sm[at], sm[at + 1], sm[at - 1], sm[at + lv.n], sm[at - lv.n], rhs,
                              a_e, a_w, lv.a_ns, lv.inv_ac, omega);
    }
    __syncwarp();
  }
}

// count red-black sweeps of a level, a barrier of its team after each colour.
__device__ __forceinline__ void sweeps(cg::cluster_group& cl, float* sm, const Level& lv,
                                       int count, float omega, const Team& tm) {
  if (tm.scope == kWarp && lv.n <= 5) {
    tiny_sweeps(sm, lv, count, omega, tm);
    return;
  }
  const float* up = nullptr;
  const float* dn = nullptr;
  if (tm.active && lv.lo > 0) up = row_ptr(cl, sm, lv.p, lv, lv.lo - 1, tm);
  if (tm.active && lv.hi < lv.n) dn = row_ptr(cl, sm, lv.p, lv, lv.hi, tm);
  const int j_odd = 1 + 2 * (tm.tid & ((1 << lv.log_half) - 1));   // j_odd + 1 <= n - 1
  const Coeffs co{sm[lv.ae + j_odd], sm[lv.aw + j_odd], sm[lv.ae + j_odd + 1],
                  sm[lv.aw + j_odd + 1]};
  for (int k = 0; k < count; ++k) {
    if (tm.active) half_sweep(sm, lv, co, up, dn, 0, omega, tm);
    team_sync(cl, tm.scope);
    if (tm.active) half_sweep(sm, lv, co, up, dn, 1, omega, tm);
    team_sync(cl, tm.scope);
  }
}

// The full-weighted defect around fine point (i, j), i and j even and at
// least 2 from the ring, so all nine defects are interior ones.  psi_row(d)
// and rhs_row(d) give row i + d of the fine psi and right-hand side.
template <typename PsiRow, typename RhsRow>
__device__ __forceinline__ float weighted_defect(PsiRow psi_row, RhsRow rhs_row, const float* ae,
                                                 const float* aw, int j, float a_ns, float a_c) {
  return scpn::full_weight([&](int di, int dj) {
    const float* row = psi_row(di);
    const int c = j + dj;
    return scpn::defect_value(row[c], row[c + 1], row[c - 1], psi_row(di + 1)[c],
                              psi_row(di - 1)[c], rhs_row(di)[c], ae[c], aw[c], a_ns, a_c);
  });
}

// Full-weighted defect of the fine level into the coarse level's right-hand
// side (zero ring), and the coarse first guess zero.  A CTA computes the
// coarse rows I whose fine row 2 I it owns and writes them to their owner.
__device__ __forceinline__ void restrict_to(cg::cluster_group& cl, float* sm, const Level& fine,
                                            const Level& coarse, const Team& tm) {
  const int w_shift = fine.log_half + 1;   // fine.n - 1 >= coarse.n columns
  const int jc = tm.tid & ((1 << w_shift) - 1);
  const int step = tm.size >> w_shift;
  const int nc = coarse.n;
  if (jc >= nc) return;
  const float* ae = sm + fine.ae;
  const float* aw = sm + fine.aw;
  for (int ic = ((fine.lo + 1) >> 1) + (tm.tid >> w_shift); ic < ((fine.hi + 1) >> 1);
       ic += step) {
    float out = 0.0f;
    if (ic >= 1 && ic <= nc - 2 && jc >= 1 && jc <= nc - 2) {
      const int i = 2 * ic;
      if (i - 2 >= fine.lo && i + 2 < fine.hi) {   // all five rows are this CTA's
        const float* psi0 = sm + fine.p + (i - fine.lo) * fine.n;
        const float* rhs0 = sm + fine.s + (i - fine.lo) * fine.n;
        out = weighted_defect([&](int d) { return psi0 + d * fine.n; },
                              [&](int d) { return rhs0 + d * fine.n; }, ae, aw, 2 * jc,
                              fine.a_ns, fine.a_c);
      } else {
        const float* psi_rows[5];
        const float* rhs_rows[3];
#pragma unroll
        for (int d = -2; d <= 2; ++d) psi_rows[d + 2] = row_ptr(cl, sm, fine.p, fine, i + d, tm);
#pragma unroll
        for (int d = -1; d <= 1; ++d) rhs_rows[d + 1] = row_ptr(cl, sm, fine.s, fine, i + d, tm);
        out = weighted_defect([&](int d) { return psi_rows[d + 2]; },
                              [&](int d) { return rhs_rows[d + 1]; }, ae, aw, 2 * jc,
                              fine.a_ns, fine.a_c);
      }
    }
    row_ptr(cl, sm, coarse.s, coarse, ic, tm)[jc] = out;
    row_ptr(cl, sm, coarse.p, coarse, ic, tm)[jc] = 0.0f;
  }
}

// psi of the fine level plus the bilinear prolongation of the coarse psi, on
// the interior of this CTA's rows.
__device__ __forceinline__ void prolong_add(cg::cluster_group& cl, float* sm, const Level& fine,
                                            const Level& coarse, const Team& tm) {
  const int w_shift = fine.log_half + 1;
  const int j = 1 + (tm.tid & ((1 << w_shift) - 1));
  const int step = tm.size >> w_shift;
  if (j > fine.n - 2) return;
  const int i0 = fine.lo > 1 ? fine.lo : 1;
  const int i1 = fine.hi < fine.n - 1 ? fine.hi : fine.n - 1;
  for (int i = i0 + (tm.tid >> w_shift); i < i1; i += step) {
    const float* c0 = row_ptr(cl, sm, coarse.p, coarse, i >> 1, tm);
    const float* c1 = row_ptr(cl, sm, coarse.p, coarse, (i >> 1) + (i & 1), tm);
    const int at = fine.p + (i - fine.lo) * fine.n + j;
    sm[at] = sm[at] + scpn::prolong_rows(c0, c1, i, j);
  }
}

__global__ void __launch_bounds__(kThreads) fused_vcycle_kernel(
    const float* __restrict__ psi, const float* __restrict__ src, const float* __restrict__ r,
    int r_stride, const __grid_constant__ Plan pl, float* __restrict__ out) {
  extern __shared__ float sm[];
  const size_t element = blockIdx.y;   // 0 for an unbatched launch
  const size_t field = static_cast<size_t>(pl.n[0]) * pl.n[0];
  psi += element * field;
  src += element * field;
  out += element * field;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const int t = threadIdx.x;

  // The coefficient rows of every level (R of level l is every 2^l-th entry
  // of the entry level's row), and this CTA's rows of the entry level.
  for (int l = 0; l < pl.n_levels; ++l) {
    const Level lv = level_of(pl, l, rank);
    for (int j = t; j < lv.n; j += kThreads) {
      scpn::stencil_ew(r, r_stride << l, j, pl.inv_dr2[l], pl.dr[l], sm[lv.ae + j],
                       sm[lv.aw + j]);
    }
  }
  const Level top = level_of(pl, 0, rank);
  const bool holds_top = pl.scope[0] == kCluster || rank == 0;
  const int top_count = holds_top ? (top.hi - top.lo) * top.n : 0;
  for (int k = t; k < top_count; k += kThreads) {
    sm[top.p + k] = psi[top.lo * top.n + k];
    sm[top.s + k] = src[top.lo * top.n + k];
  }
  cl.sync();

  const int coarsest = pl.n_levels - 1;
  for (int l = 0; l < coarsest; ++l) {
    const Level fine = level_of(pl, l, rank);
    const Level coarse = level_of(pl, l + 1, rank);
    const Team tm = team_of(pl, l, rank);
    sweeps(cl, sm, fine, pl.pre, pl.omega, tm);
    if (tm.active) restrict_to(cl, sm, fine, coarse, tm);
    team_sync(cl, tm.scope);
  }
  sweeps(cl, sm, level_of(pl, coarsest, rank), pl.coarse_sweeps, pl.omega,
         team_of(pl, coarsest, rank));
  for (int l = coarsest - 1; l >= 0; --l) {
    const Level fine = level_of(pl, l, rank);
    const Level coarse = level_of(pl, l + 1, rank);
    const Team tm = team_of(pl, l, rank);
    // a wider team waits for the narrower one that finished the level below
    if (tm.scope != pl.scope[l + 1]) team_sync(cl, tm.scope);
    if (tm.active) prolong_add(cl, sm, fine, coarse, tm);
    team_sync(cl, tm.scope);
    sweeps(cl, sm, fine, pl.post, pl.omega, tm);
  }

  // Every remote read lies before the last barrier of a banded entry level,
  // so a CTA may store its rows and leave.
  __syncthreads();
  for (int k = t; k < top_count; k += kThreads) out[top.lo * top.n + k] = sm[top.p + k];
}

cudaLaunchConfig_t launch_config(const Plan& pl, cudaLaunchAttribute* attr, cudaStream_t st,
                                 int n_batch = 1) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.n_cta, n_batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = pl.smem_bytes;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = pl.n_cta;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Opt in to the plan's dynamic shared memory (once per size).
int allow_smem(const Plan& pl) {
  static int allowed = 48 * 1024;
  if (pl.smem_bytes <= allowed) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      fused_vcycle_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  allowed = pl.smem_bytes;
  return 0;
}

}  // namespace

// How many clusters of the plan's shape the device can hold at once (0: the
// launch would be refused), or minus the CUDA error.
extern "C" int scpn_fused_vcycle_clusters(const void* plan) {
  const Plan& pl = *static_cast<const Plan*>(plan);
  int err = allow_smem(pl);
  if (err != 0) return -err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(pl, &attr, nullptr);
  int clusters = 0;
  err = static_cast<int>(cudaOccupancyMaxActiveClusters(&clusters, fused_vcycle_kernel, &cfg));
  return err != 0 ? -err : clusters;
}

namespace {

int launch_vcycle(const void* psi, const void* src, const void* r, int r_stride,
                  const void* plan, void* out, int n_batch, void* stream) {
  const Plan& pl = *static_cast<const Plan*>(plan);
  // The occupancy query once per shape: a cluster that fits nowhere is an
  // error here, not a reason to take another route.
  static int checked_smem = -1, checked_cta = -1;
  if (pl.smem_bytes != checked_smem || pl.n_cta != checked_cta) {
    const int clusters = scpn_fused_vcycle_clusters(plan);
    if (clusters < 0) return -clusters;
    if (clusters == 0) return static_cast<int>(cudaErrorLaunchOutOfResources);
    checked_smem = pl.smem_bytes;
    checked_cta = pl.n_cta;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(pl, &attr, static_cast<cudaStream_t>(stream), n_batch);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, fused_vcycle_kernel, static_cast<const float*>(psi), static_cast<const float*>(src),
      static_cast<const float*>(r), r_stride, pl, static_cast<float*>(out));
  return err != cudaSuccess ? static_cast<int>(err) : static_cast<int>(cudaGetLastError());
}

}  // namespace

// One V-cycle from the entry level of the plan: one launch of one cluster of
// plan.n_cta CTAs.  psi, src and out are the entry level's (n, n) fields, r
// its R row with stride r_stride.
extern "C" int scpn_fused_vcycle(const void* psi, const void* src, const void* r, int r_stride,
                                 const void* plan, void* out, void* stream) {
  return launch_vcycle(psi, src, r, r_stride, plan, out, 1, stream);
}

// n_batch V-cycles of one plan in one launch of n_batch clusters: psi, src
// and out are (n_batch, n, n), r is shared.
extern "C" int scpn_fused_vcycle_batched(const void* psi, const void* src, const void* r,
                                         int r_stride, const void* plan, int n_batch, void* out,
                                         void* stream) {
  if (n_batch < 1 || n_batch > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  return launch_vcycle(psi, src, r, r_stride, plan, out, n_batch, stream);
}
