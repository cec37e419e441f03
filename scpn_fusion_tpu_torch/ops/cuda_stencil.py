"""Red-black SOR sweeps as a hand-written CUDA kernel (port of
``scpn_fusion_tpu/ops/pallas_stencil.py``).

``sor_sweeps`` runs ``n_sweeps`` red-black sweeps of the toroidal GS*
stencil: on a CUDA float32 tensor it launches ``csrc/sor_band.cu`` once, on
the route ``ops/leg_plan.sor_launch_plan`` picks; on a CPU tensor it runs
:func:`sor_sweeps_plain`.  Both do the same arithmetic as the Pallas kernel:
``gs`` times the reciprocal of ``a_C``, no 1e12 clip, the Dirichlet ring
untouched.  ``_sor_sweeps_staged`` is the route it replaced (a copy, then one
launch of ``csrc/rb_sweep.cu`` a half-sweep, or one single-block launch up to
65^2): the reference it must equal bit for bit, used by ``chip_smoke.py`` and
the profiler alone.
"""

from __future__ import annotations

import functools

import torch

from scpn_fusion_tpu_torch.ops import _cuda_build as cb

SMEM_BYTES = 48 * 1024   # shared-memory budget of the staged single-block sweep


def level_scalars(d_r: float, d_z: float) -> tuple[float, float, float, float]:
    """(1/dR^2, a_NS, a_C, 1/a_C) of a level, as Python floats."""
    inv_dr2 = 1.0 / (d_r * d_r)
    a_ns = 1.0 / (d_z * d_z)
    a_c = 2.0 * inv_dr2 + 2.0 / (d_z * d_z)
    return inv_dr2, a_ns, a_c, 1.0 / a_c


def ew_rows(r_1d: torch.Tensor, d_r: float) -> tuple[torch.Tensor, torch.Tensor]:
    """East/west coefficient rows over the level's R (same order as the kernel)."""
    inv_dr2 = 1.0 / (d_r * d_r)
    t = 1.0 / (2.0 * torch.clamp(r_1d, min=1e-10) * d_r)
    return inv_dr2 - t, inv_dr2 + t


def _half_sweep_plain(p, src, a_e, a_w, a_ns, inv_ac, omega, parity):
    gs = (a_e[None, 1:-1] * p[1:-1, 2:] + a_w[None, 1:-1] * p[1:-1, :-2]
          + a_ns * (p[2:, 1:-1] + p[:-2, 1:-1]) - src[1:-1, 1:-1]) * inv_ac
    old = p[1:-1, 1:-1]
    nz, nr = p.shape
    iz = torch.arange(1, nz - 1, device=p.device)[:, None]
    ir = torch.arange(1, nr - 1, device=p.device)[None, :]
    out = p.clone()
    out[1:-1, 1:-1] = torch.where((iz + ir) % 2 == parity, old + omega * (gs - old), old)
    return out


def sor_sweeps_plain(psi: torch.Tensor, source: torch.Tensor, r_1d: torch.Tensor,
                     d_r: float, d_z: float, omega: float, n_sweeps: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`sor_sweeps` (same arithmetic)."""
    _, a_ns, _, inv_ac = level_scalars(d_r, d_z)
    a_e, a_w = ew_rows(r_1d, d_r)
    p = psi
    for _ in range(n_sweeps):
        p = _half_sweep_plain(p, source, a_e, a_w, a_ns, inv_ac, omega, 0)
        p = _half_sweep_plain(p, source, a_e, a_w, a_ns, inv_ac, omega, 1)
    return p.clone() if p is psi else p


def check_level(name: str, psi: torch.Tensor, source: torch.Tensor,
                r_1d: torch.Tensor) -> None:
    """Raise unless ``psi`` and ``source`` are contiguous float32 CUDA fields
    of one shape and ``r_1d`` a 1D float32 CUDA row of their width."""
    cb.check_f32_cuda(name, psi=psi, source=source)
    if r_1d.dtype != torch.float32 or not r_1d.is_cuda or r_1d.dim() != 1:
        raise ValueError(f"{name}: r_1d must be a 1D float32 CUDA tensor")
    if source.shape != psi.shape or r_1d.shape[0] != psi.shape[1]:
        raise ValueError(f"{name}: shapes {tuple(psi.shape)}, {tuple(source.shape)}, "
                         f"{tuple(r_1d.shape)} do not match")


def sweeps_in_place(p: torch.Tensor, source: torch.Tensor, r_1d: torch.Tensor,
                    d_r: float, d_z: float, omega: float, n_sweeps: int) -> None:
    """Launch ``n_sweeps`` sweeps on the CUDA tensor ``p`` in place, staged
    (the launcher the staged legs and V-cycle share; it adds to no wrapper's
    count)."""
    check_level("sor_sweeps", p, source, r_1d)
    nz, nr = p.shape
    if n_sweeps <= 0:
        return
    inv_dr2, a_ns, _, inv_ac = level_scalars(d_r, d_z)
    args = (p.data_ptr(), source.data_ptr(), r_1d.data_ptr(), r_1d.stride(0), nz, nr,
            inv_dr2, d_r, a_ns, inv_ac, float(omega))
    if (2 * nz * nr + 2 * nr) * 4 <= SMEM_BYTES:
        cb.launch("scpn_rb_sweeps_smem", *args, n_sweeps)
    else:
        for _ in range(n_sweeps):
            cb.launch("scpn_rb_half_sweep", *args, 0)
            cb.launch("scpn_rb_half_sweep", *args, 1)


def _sor_sweeps_staged(psi, source, r_1d, d_r, d_z, omega, n_sweeps):
    """The route :func:`sor_sweeps` replaced: a copy, then one launch a
    half-sweep (one single-block launch up to 65^2).  What the one-launch
    routes must equal bit for bit; adds to no wrapper's count."""
    out = psi.clone()
    sweeps_in_place(out, source, r_1d, d_r, d_z, omega, n_sweeps)
    return out


def _sweeps_route_d(psi, source, r_1d, d_r, d_z, omega, n_sweeps):
    """Route D: the staged half-sweeps without the copy, the first reading
    ``psi`` and writing every point of the output (2 * n launches)."""
    inv_dr2, a_ns, _, inv_ac = level_scalars(d_r, d_z)
    nz, nr = psi.shape
    out = torch.empty_like(psi)
    cb.launch("scpn_rb_half_sweep_into", psi.data_ptr(), out.data_ptr(), source.data_ptr(),
              r_1d.data_ptr(), r_1d.stride(0), nz, nr, inv_dr2, d_r, a_ns, inv_ac,
              float(omega), 0)
    args = (out.data_ptr(), source.data_ptr(), r_1d.data_ptr(), r_1d.stride(0), nz, nr,
            inv_dr2, d_r, a_ns, inv_ac, float(omega))
    cb.launch("scpn_rb_half_sweep", *args, 1)
    for _ in range(n_sweeps - 1):
        cb.launch("scpn_rb_half_sweep", *args, 0)
        cb.launch("scpn_rb_half_sweep", *args, 1)
    return out


@functools.lru_cache(maxsize=256)
def _sor_plan_ints(nz: int, nr: int, n_sweeps: int):
    """The band kernel's plan as the C entry reads it (routes A and B), or
    None (route D); made once a shape."""
    from scpn_fusion_tpu_torch.ops import leg_plan
    plan = leg_plan.sor_launch_plan(nz, nr, n_sweeps)
    return None if plan.launch is None else plan.launch.as_ints()


def sor_sweeps(psi: torch.Tensor, source: torch.Tensor, r_1d: torch.Tensor,
               d_r: float, d_z: float, omega: float, n_sweeps: int) -> torch.Tensor:
    """``n_sweeps`` red-black SOR sweeps (kernel on CUDA, plain on the CPU).

    Signature of ``sor_sweeps_pallas`` minus ``interpret``; ``omega`` is a
    Python float.  On a CUDA float32 tensor, by ``ops/leg_plan.sor_launch_plan``:

    * route B, one launch of a tiled grid, halo ``2 * n_sweeps``: any level
      for ``n_sweeps`` <= 4 (the multigrid smoothing, the default ``sor``
      method's single sweep);
    * route A, one launch of one CTA that holds the level: more sweeps on a
      level whose bands fit one CTA of 1024 threads and 227 KB of shared
      memory (at most 133 columns; 129^2, 129 x 65 and every coarser level:
      the ``anderson`` path's 50 sweeps, the 50 sweeps of a coarsest level);
    * route D, ``2 * n_sweeps`` launches of the staged half-sweep kernel:
      more than 4 sweeps on a level too large for A.

    No route has a size limit beyond the device's memory, so the port has no
    counterpart of the JAX package's 12 MB VMEM gate.  Raises for a level
    without an interior; ``n_sweeps`` <= 0 returns a copy and launches
    nothing.
    """
    if not psi.is_cuda:
        return sor_sweeps_plain(psi, source, r_1d, d_r, d_z, omega, n_sweeps)
    check_level("sor_sweeps", psi, source, r_1d)
    if n_sweeps <= 0:
        return psi.clone()
    ints = _sor_plan_ints(psi.shape[0], psi.shape[1], int(n_sweeps))
    if ints is None:
        out = _sweeps_route_d(psi, source, r_1d, d_r, d_z, omega, n_sweeps)
    else:
        from scpn_fusion_tpu_torch.ops import leg_plan
        out = leg_plan.launch_sweeps("scpn_sor_band", ints, psi, source, r_1d, d_r, d_z, omega)
    cb.CALLS["sor_sweeps"] += 1
    return out
