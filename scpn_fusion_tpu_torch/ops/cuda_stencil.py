"""Red-black SOR sweeps as a hand-written CUDA kernel (port of
``scpn_fusion_tpu/ops/pallas_stencil.py``).

``sor_sweeps`` runs ``n_sweeps`` red-black sweeps of the toroidal GS*
stencil: on a CUDA float32 tensor it launches ``csrc/rb_sweep.cu`` (one
launch per half-sweep, or one single-block launch for a level that fits in
shared memory); on a CPU tensor it runs :func:`sor_sweeps_plain`.  Both do
the same arithmetic as the Pallas kernel: ``gs`` times the reciprocal of
``a_C``, no 1e12 clip, the Dirichlet ring untouched.
"""

from __future__ import annotations

import torch

from scpn_fusion_tpu_torch.ops import _cuda_build as cb

SMEM_BYTES = 48 * 1024   # static shared-memory budget of the single-block sweep


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


def sweeps_in_place(p: torch.Tensor, source: torch.Tensor, r_1d: torch.Tensor,
                    d_r: float, d_z: float, omega: float, n_sweeps: int) -> None:
    """Launch ``n_sweeps`` sweeps on the CUDA tensor ``p`` in place (the
    launcher the kernel wrappers share; it adds to no wrapper's count)."""
    cb.check_f32_cuda("sor_sweeps", psi=p, source=source)
    if r_1d.dtype != torch.float32 or not r_1d.is_cuda or r_1d.dim() != 1:
        raise ValueError("sor_sweeps: r_1d must be a 1D float32 CUDA tensor")
    nz, nr = p.shape
    if source.shape != p.shape or r_1d.shape[0] != nr:
        raise ValueError(f"sor_sweeps: shapes {tuple(p.shape)}, {tuple(source.shape)}, "
                         f"{tuple(r_1d.shape)} do not match")
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


def sor_sweeps(psi: torch.Tensor, source: torch.Tensor, r_1d: torch.Tensor,
               d_r: float, d_z: float, omega: float, n_sweeps: int) -> torch.Tensor:
    """``n_sweeps`` red-black SOR sweeps (kernel on CUDA, plain on the CPU).

    Signature of ``sor_sweeps_pallas`` minus ``interpret``; ``omega`` is a
    Python float.
    """
    if not psi.is_cuda:
        return sor_sweeps_plain(psi, source, r_1d, d_r, d_z, omega, n_sweeps)
    out = psi.clone()
    sweeps_in_place(out, source, r_1d, d_r, d_z, omega, n_sweeps)
    if n_sweeps > 0:
        cb.CALLS["sor_sweeps"] += 1
    return out
