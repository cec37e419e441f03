"""Multigrid V-cycle legs as hand-written CUDA kernels (port of
``scpn_fusion_tpu/ops/pallas_mg.py``).

The Pallas kernels keep whole levels in VMEM, embedded at stride 2^k in the
entry-level array.  Here every level is compacted (the ``x[::2, ::2]`` grid
of the level above, so level-local red/black parity is plain ``(i+j) % 2``)
and each dependent stage is one launch of a global-memory stencil kernel:

* ``fine_presmooth_restrict`` = ``pre_smooth`` SOR sweeps
  (``csrc/rb_sweep.cu``) + one ``defect_restrict`` launch
  (``csrc/transfer.cu``): the 9-point full weighting of ``s - L[psi]``,
  written compact with a zero ring.
* ``fine_prolong_smooth`` = one ``prolong_correct`` launch (bilinear
  prolongation of the compact coarse error, added on the interior) +
  ``post_smooth`` sweeps.
* ``fused_coarse_vcycle`` = a host loop over the compacted levels
  ``[n ... min_grid]`` calling the two legs, with ``coarse_sweeps`` sweeps at
  the coarsest level.

Each wrapper takes the JAX signature minus ``interpret``: on CUDA float32
tensors it launches the kernels, on CPU tensors it runs the ``*_plain``
version beside it, which does the same arithmetic with PyTorch ops.
"""

from __future__ import annotations

import torch

from scpn_fusion_tpu_torch.ops import _cuda_build as cb
from scpn_fusion_tpu_torch.ops.cuda_stencil import (
    ew_rows,
    level_scalars,
    sor_sweeps,
    sor_sweeps_plain,
    sweeps_in_place,
)


def level_plan(n: int, min_grid: int) -> list[int]:
    """Grid sizes visited by the V-cycle, entry first, coarsest last."""
    ns = [n]
    while min_grid < ns[-1]:
        ns.append((ns[-1] + 1) // 2)
    return ns


def is_pow2_plus1_square(shape) -> bool:
    nz, nr = shape
    return nz == nr and nz >= 3 and ((nz - 1) & (nz - 2)) == 0


# ── plain versions ──


def _coarse_slices(nc: int, off: int) -> slice:
    """Fine indices 2*I + off for the coarse interior I = 1 .. nc-2."""
    return slice(2 + off, 2 * (nc - 2) + 1 + off, 2)


def defect_restrict_plain(psi: torch.Tensor, source: torch.Tensor, r_1d: torch.Tensor,
                          d_r: float, d_z: float) -> torch.Tensor:
    """Full-weighted defect ``s - L[psi]``, compact, zero coarse ring."""
    nz, nr = psi.shape
    nzc, nrc = (nz + 1) // 2, (nr + 1) // 2
    _, a_ns, a_c, _ = level_scalars(d_r, d_z)
    a_e, a_w = ew_rows(r_1d, d_r)
    lap = (a_e[None, 1:-1] * psi[1:-1, 2:] + a_w[None, 1:-1] * psi[1:-1, :-2]
           + a_ns * (psi[2:, 1:-1] + psi[:-2, 1:-1]) - a_c * psi[1:-1, 1:-1])
    d = torch.zeros_like(psi)
    d[1:-1, 1:-1] = source[1:-1, 1:-1] - lap

    def at(di: int, dj: int) -> torch.Tensor:
        return d[_coarse_slices(nzc, di), _coarse_slices(nrc, dj)]

    edge = at(0, 1) + at(0, -1) + at(1, 0) + at(-1, 0)
    diag = at(1, 1) + at(1, -1) + at(-1, 1) + at(-1, -1)
    d_c = torch.zeros((nzc, nrc), dtype=psi.dtype, device=psi.device)
    d_c[1:-1, 1:-1] = 0.25 * at(0, 0) + 0.125 * edge + 0.0625 * diag
    return d_c


def prolong_correct_plain(psi_s: torch.Tensor, e_coarse: torch.Tensor) -> torch.Tensor:
    """``psi_s`` plus the bilinear prolongation of ``e_coarse`` on the interior."""
    nz, nr = psi_s.shape
    e = e_coarse
    corr = torch.zeros((2 * e.shape[0], 2 * e.shape[1]), dtype=psi_s.dtype,
                       device=psi_s.device)
    corr[0::2, 0::2] = e
    corr[0::2, 1:-2:2] = 0.5 * (e[:, 1:] + e[:, :-1])
    corr[1:-2:2, 0::2] = 0.5 * (e[1:, :] + e[:-1, :])
    corr[1:-2:2, 1:-2:2] = 0.25 * (((e[1:, 1:] + e[1:, :-1]) + e[:-1, 1:]) + e[:-1, :-1])
    out = psi_s.clone()
    out[1:-1, 1:-1] = psi_s[1:-1, 1:-1] + corr[1:nz - 1, 1:nr - 1]
    return out


def fine_presmooth_restrict_plain(psi, source, r_1d, d_r, d_z, omega, *, pre_smooth=3):
    """Plain version of :func:`fine_presmooth_restrict`."""
    psi_s = sor_sweeps_plain(psi, source, r_1d, d_r, d_z, omega, pre_smooth)
    return psi_s, defect_restrict_plain(psi_s, source, r_1d, d_r, d_z)


def fine_prolong_smooth_plain(psi_s, source, e_coarse, r_1d, d_r, d_z, omega, *,
                              post_smooth=3):
    """Plain version of :func:`fine_prolong_smooth`."""
    p = prolong_correct_plain(psi_s, e_coarse)
    return sor_sweeps_plain(p, source, r_1d, d_r, d_z, omega, post_smooth)


def _compact_vcycle(psi, source, r_1d, d_r, d_z, omega, pre_smooth, post_smooth,
                    min_grid, coarse_sweeps, down, up, sweeps):
    nz, nr = psi.shape
    if not is_pow2_plus1_square((nz, nr)):
        raise ValueError(f"fused V-cycle needs a square 2^k+1 grid; got {tuple(psi.shape)}")
    saved = []
    p, s, r, dr, dz = psi, source, r_1d, d_r, d_z
    for _ in level_plan(nz, min_grid)[:-1]:
        p_s, d_c = down(p, s, r, dr, dz, omega, pre_smooth=pre_smooth)
        saved.append((p_s, s, r, dr, dz))
        p, s, r, dr, dz = torch.zeros_like(d_c), d_c, r[::2], dr * 2.0, dz * 2.0
    p = sweeps(p, s, r, dr, dz, omega, coarse_sweeps)
    for p_s, s_f, r_f, dr_f, dz_f in reversed(saved):
        p = up(p_s, s_f, p, r_f, dr_f, dz_f, omega, post_smooth=post_smooth)
    return p


def fused_coarse_vcycle_plain(psi, source, r_1d, d_r, d_z, omega, *, pre_smooth=3,
                              post_smooth=3, min_grid=5, coarse_sweeps=50):
    """Plain version of :func:`fused_coarse_vcycle`."""
    return _compact_vcycle(psi, source, r_1d, d_r, d_z, omega, pre_smooth, post_smooth,
                           min_grid, coarse_sweeps, fine_presmooth_restrict_plain,
                           fine_prolong_smooth_plain, sor_sweeps_plain)


# ── kernel wrappers ──
#
# Each public wrapper adds one to ``cb.CALLS[<its name>]`` per call in which
# it launched.  ``fused_coarse_vcycle`` runs its per-level legs through the
# private launchers below, so the fine-leg counts come only from the fine
# route of ``ops/multigrid._vcycle_impl``; its coarsest solve is one call of
# ``sor_sweeps`` and counts there.


def _presmooth_restrict_launch(psi, source, r_1d, d_r, d_z, omega, *, pre_smooth):
    nz, nr = psi.shape
    nzc, nrc = (nz + 1) // 2, (nr + 1) // 2
    psi_s = psi.clone()
    sweeps_in_place(psi_s, source, r_1d, d_r, d_z, omega, pre_smooth)
    inv_dr2, a_ns, a_c, _ = level_scalars(d_r, d_z)
    d_c = torch.empty((nzc, nrc), dtype=psi.dtype, device=psi.device)
    cb.launch("scpn_defect_restrict", psi_s.data_ptr(), source.data_ptr(), r_1d.data_ptr(),
              r_1d.stride(0), nz, nr, nzc, nrc, inv_dr2, d_r, a_ns, a_c, d_c.data_ptr())
    return psi_s, d_c


def _prolong_smooth_launch(psi_s, source, e_coarse, r_1d, d_r, d_z, omega, *, post_smooth):
    cb.check_f32_cuda("fine_prolong_smooth", psi_s=psi_s, e_coarse=e_coarse)
    nz, nr = psi_s.shape
    nzc, nrc = e_coarse.shape
    if (nzc, nrc) != ((nz + 1) // 2, (nr + 1) // 2):
        raise ValueError(f"fine_prolong_smooth: coarse shape {(nzc, nrc)} does not match "
                         f"fine {(nz, nr)}")
    out = torch.empty_like(psi_s)
    cb.launch("scpn_prolong_correct", psi_s.data_ptr(), e_coarse.data_ptr(), nz, nr, nzc, nrc,
              out.data_ptr())
    sweeps_in_place(out, source, r_1d, d_r, d_z, omega, post_smooth)
    return out


def fine_presmooth_restrict(psi: torch.Tensor, source: torch.Tensor, r_1d: torch.Tensor,
                            d_r: float, d_z: float, omega: float, *,
                            pre_smooth: int = 3) -> tuple[torch.Tensor, torch.Tensor]:
    """Fine-level down leg: ``(psi_smoothed, d_coarse)``, the coarse defect
    compact with a zero ring."""
    if not psi.is_cuda:
        return fine_presmooth_restrict_plain(psi, source, r_1d, d_r, d_z, omega,
                                             pre_smooth=pre_smooth)
    out = _presmooth_restrict_launch(psi, source, r_1d, d_r, d_z, omega,
                                     pre_smooth=pre_smooth)
    cb.CALLS["fine_presmooth_restrict"] += 1
    return out


def fine_prolong_smooth(psi_s: torch.Tensor, source: torch.Tensor, e_coarse: torch.Tensor,
                        r_1d: torch.Tensor, d_r: float, d_z: float, omega: float, *,
                        post_smooth: int = 3) -> torch.Tensor:
    """Fine-level up leg: bilinear prolongation of the compact coarse error,
    correction on the interior, then ``post_smooth`` sweeps."""
    if not psi_s.is_cuda:
        return fine_prolong_smooth_plain(psi_s, source, e_coarse, r_1d, d_r, d_z, omega,
                                         post_smooth=post_smooth)
    out = _prolong_smooth_launch(psi_s, source, e_coarse, r_1d, d_r, d_z, omega,
                                 post_smooth=post_smooth)
    cb.CALLS["fine_prolong_smooth"] += 1
    return out


def fused_coarse_vcycle(psi: torch.Tensor, source: torch.Tensor, r_1d: torch.Tensor,
                        d_r: float, d_z: float, omega: float, *, pre_smooth: int = 3,
                        post_smooth: int = 3, min_grid: int = 5,
                        coarse_sweeps: int = 50) -> torch.Tensor:
    """One V-cycle on a square 2^k+1 grid down to ``min_grid`` and back."""
    if not psi.is_cuda:
        return fused_coarse_vcycle_plain(psi, source, r_1d, d_r, d_z, omega,
                                         pre_smooth=pre_smooth, post_smooth=post_smooth,
                                         min_grid=min_grid, coarse_sweeps=coarse_sweeps)
    out = _compact_vcycle(psi, source, r_1d, d_r, d_z, omega, pre_smooth, post_smooth,
                          min_grid, coarse_sweeps, _presmooth_restrict_launch,
                          _prolong_smooth_launch, sor_sweeps)
    cb.CALLS["fused_coarse_vcycle"] += 1
    return out
