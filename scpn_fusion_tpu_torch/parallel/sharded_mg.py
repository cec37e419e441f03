"""Distributed geometric multigrid: the convergent sharded elliptic solve
(port of ``scpn_fusion_tpu/parallel/sharded_mg.py``).

One V-cycle whose fine level runs Z-slab sharded over the mesh
(halo-exchanged red-black smoothing and a halo-exchanged defect, the
global-checkerboard machinery of ``parallel/halo.py``) while the coarse
levels run replicated: the fine defect is gathered once a V-cycle
(``all_gather(tiled=True)``: ``torch.cat`` on a shard's device), restricted,
and the error equation of the next level is solved by the plain
``ops.multigrid._vcycle_impl``, as JAX runs its XLA ``_vcycle_impl``
(``use_pallas=False``) on every shard.  JAX computes the coarse cycle on
every device of the mesh; here it is computed once on each *distinct*
device of the mesh (once in all on a mesh that places every shard on one
card), and each shard takes its rows of the prolonged correction.

Numerics are the single-device ``ops.multigrid.vcycle``'s: global parity,
the same transfer stencils.  Grids whose rows do not divide (513 rows over 8
shards) are padded with zero rows to a shard multiple; the padded rows are
masked out of every update by the ``nz_total`` interior mask and sliced off
on exit.  Plain PyTorch ops only: no kernel runs on a sharded path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from scpn_fusion_tpu_torch.ops.multigrid import (
    _vcycle_impl,
    prolongate_bilinear,
    restrict_full_weight,
)
from scpn_fusion_tpu_torch.ops.stencil import gs_residual, stencil_coeffs
from scpn_fusion_tpu_torch.parallel.halo import _half_sweeps, _halo_pad, _row_offsets
from scpn_fusion_tpu_torch.parallel.mesh import Mesh, gather_rows, shard_rows


def _sharded_smooth(shards, sources, coeffs, omega, nz_total, n_sweeps):
    """``n_sweeps`` red-black sweeps over the slabs, a halo exchange before
    each half-sweep (global Gauss-Seidel ordering kept)."""
    for _ in range(n_sweeps):
        for parity in (0, 1):
            shards = _half_sweeps(shards, sources, coeffs, omega, parity, nz_total)
    return shards


def _local_defect(shards, sources, coeffs, nz_total):
    """Residual ``r = S - L[psi]`` on every slab (halo-exchanged neighbours),
    zero outside the global interior: ``ops.stencil.gs_residual`` by rows."""
    a_e, a_w, a_ns, a_c = coeffs
    out = []
    for p, src, off in zip(_halo_pad(shards), sources, _row_offsets(shards)):
        ae, aw = a_e.to(p.device), a_w.to(p.device)
        lap = (ae[None, :] * p[1:-1, 2:] + aw[None, :] * p[1:-1, :-2]
               + a_ns * (p[:-2, 1:-1] + p[2:, 1:-1]) - a_c * p[1:-1, 1:-1])
        res_int = src[:, 1:-1] - lap
        iz = torch.arange(res_int.shape[0], device=p.device)[:, None] + off
        res_int = torch.where((iz >= 1) & (iz <= nz_total - 2), res_int,
                              torch.zeros_like(res_int))
        d = torch.zeros_like(src)
        d[:, 1:-1] = res_int
        out.append(d)
    return out


def _replicated_coarse(mesh: Mesh, gather, coarse_solve):
    """``coarse_solve(gathered field)`` on every distinct device of the mesh,
    keyed by device: JAX's replicated coarse levels, computed once a device."""
    out = {}
    for d in mesh.devices:
        if d not in out:
            out[d] = coarse_solve(gather(d))
    return out


def sharded_vcycle(psi: torch.Tensor, source: torch.Tensor, r_1d: torch.Tensor,
                   omega: float | torch.Tensor, *, mesh: Mesh, axis: str = "z", d_r: float,
                   d_z: float, pre_smooth: int = 3, post_smooth: int = 3, min_grid: int = 5,
                   coarse_sweeps: int = 50) -> torch.Tensor:
    """One distributed V-cycle for ``Delta* psi = source`` on the global
    (NZ, NR) fields.  Fine level: Z slabs over ``mesh[axis]``; coarse
    levels: the plain ``_vcycle_impl`` on the gathered defect, replicated.
    Returns the global field on the mesh's first device."""
    n_shards = mesh.shape[axis]
    if n_shards != mesh.size:
        raise ValueError(f"sharded_vcycle: {mesh} is not a mesh over {axis!r} alone")
    nz, nr = psi.shape
    pad = (-nz) % n_shards
    omega = float(omega)
    coeffs = stencil_coeffs(r_1d[1:-1], d_r, d_z)
    p = shard_rows(F.pad(psi, (0, 0, 0, pad)), mesh)
    srcs = shard_rows(F.pad(source, (0, 0, 0, pad)), mesh)

    # 1) pre-smooth, sharded; 2) local defect; 3) gathered, 4) the coarse
    # error equation replicated, 5) each slab's rows of the correction
    p = _sharded_smooth(p, srcs, coeffs, omega, nz, pre_smooth)
    d_local = _local_defect(p, srcs, coeffs, nz)
    nz_c, nr_c = (nz + 1) // 2, (nr + 1) // 2

    def coarse(d_full):
        d_c = restrict_full_weight(d_full[:nz])
        r_c = r_1d.to(d_full.device)[::2]
        e_c = _vcycle_impl(torch.zeros((nz_c, nr_c), dtype=psi.dtype, device=d_full.device), d_c,
                           r_c, d_r * 2.0, d_z * 2.0, 1.0, pre_smooth, post_smooth, min_grid,
                           coarse_sweeps)
        return F.pad(prolongate_bilinear(e_c, nz, nr), (0, 0, 0, pad))

    corr = _replicated_coarse(mesh, lambda d: gather_rows(d_local, d), coarse)
    p = [s + corr[s.device][off:off + s.shape[0]] for s, off in zip(p, _row_offsets(p))]

    # 6) post-smooth, sharded
    p = _sharded_smooth(p, srcs, coeffs, omega, nz, post_smooth)
    return gather_rows(p, mesh.first)[:nz]


def _res_rms(p: torch.Tensor, source, r_1d, d_r, d_z, n_int: int) -> torch.Tensor:
    r = gs_residual(p, source, r_1d, d_r, d_z)
    return torch.sqrt((r * r).sum() / n_int)


def mg_solve_gated(vcycle, psi, source, r_1d, d_r, d_z, tol, max_cycles):
    """V-cycles ``vcycle(psi)`` until the interior GS-residual RMS is below
    ``tol`` or ``max_cycles`` ran (one host read a cycle); returns ``(psi,
    res_rms, n_cycles)``."""
    nz, nr = psi.shape
    n_int = (nz - 2) * (nr - 2)
    tol = float(torch.tensor(float(tol), dtype=psi.dtype))
    res = _res_rms(psi, source, r_1d, d_r, d_z, n_int)
    k = 0
    while k < max_cycles and res.item() > tol:
        psi = vcycle(psi)
        res = _res_rms(psi, source, r_1d, d_r, d_z, n_int)
        k += 1
    return psi, res, k


def sharded_mg_solve(psi: torch.Tensor, source: torch.Tensor, r_1d: torch.Tensor, *,
                     mesh: Mesh, axis: str = "z", d_r: float, d_z: float,
                     tol: float = 1e-8, max_cycles: int = 50):
    """Converged distributed linear solve: :func:`sharded_vcycle` until the
    interior GS-residual RMS drops below ``tol`` (or ``max_cycles``).
    Returns ``(psi, res_rms, n_cycles)``, the field and the residual on the
    mesh's first device."""
    dev = mesh.first
    psi, source, r_1d = psi.to(dev), source.to(dev), r_1d.to(dev)
    return mg_solve_gated(
        lambda p: sharded_vcycle(p, source, r_1d, 1.0, mesh=mesh, axis=axis, d_r=d_r, d_z=d_z),
        psi, source, r_1d, d_r, d_z, tol, max_cycles)
