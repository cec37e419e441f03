"""Fused topology + Grad-Shafranov source as a hand-written CUDA kernel
(port of ``scpn_fusion_tpu/ops/pallas_source.py``).

Per Picard iteration: psi_axis = max psi (floored at 1e-6); the X-point as
the first row-major minimum of |grad psi| over the divertor mask (the global
psi minimum when the mask is empty); the |axis - boundary| < 0.1 snap; the
L/H-mode profiles, the Ip renormalisation and ``-mu0 R J_phi``.  On a CUDA
float32 tensor this launches ``csrc/source.cu`` (grid-wide reductions, then
an elementwise pass); on a CPU tensor it runs
:func:`fused_topology_source_plain`, the same chain in PyTorch ops.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.models.equilibrium.profiles import (
    ProfileCoeffs,
    raw_current_density,
)
from scpn_fusion_tpu_torch.models.equilibrium.topology import grad_magnitude
from scpn_fusion_tpu_torch.ops import _cuda_build as cb


class SourceScalars(NamedTuple):
    """Debug readout of one source evaluation (0-dim tensors)."""

    psi_axis: torch.Tensor
    psi_boundary: torch.Tensor
    x_index: torch.Tensor   # linear (row-major) index of the X-point site
    i_current: torch.Tensor  # Ip of the unnormalised J_phi


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(dtype=like.dtype, device=like.device).reshape(())
    return torch.full((), float(v), dtype=like.dtype, device=like.device)


def fused_topology_source_plain(psi, r_1d, divertor_mask, p_coeffs, ff_coeffs, i_target, *,
                                d_r, d_z, mu0, h_mode, with_scalars=False):
    """Plain PyTorch version of :func:`fused_topology_source`."""
    psi_axis = psi.max()
    psi_axis = torch.where(psi_axis.abs() < 1e-6, torch.full_like(psi_axis, 1e-6), psi_axis)
    mask = divertor_mask > 0
    masked_b = torch.where(mask, grad_magnitude(psi, d_r, d_z),
                           torch.full_like(psi, float("inf")))
    idx = torch.argmin(masked_b)
    psi_b = torch.where(mask.any(), psi.reshape(-1)[idx], psi.min())
    psi_b = torch.where((psi_axis - psi_b).abs() < 0.1, psi_axis * 0.1, psi_b)

    rr = r_1d.to(psi.dtype)[None, :].expand_as(psi)
    j_raw = raw_current_density(psi, psi_axis, psi_b, rr, h_mode=h_mode,
                                p_coeffs=p_coeffs, ff_coeffs=ff_coeffs, mu0=mu0)
    i_current = j_raw.sum() * d_r * d_z
    i_t = _scalar(i_target, psi)
    scale = torch.where(i_current.abs() > 1e-9, i_t / i_current, torch.zeros_like(i_current))
    src = -mu0 * rr * (j_raw * scale)
    if with_scalars:
        return src, SourceScalars(psi_axis, psi_b, idx, i_current)
    return src


def fused_topology_source(psi: torch.Tensor, r_1d: torch.Tensor, divertor_mask: torch.Tensor,
                          p_coeffs: ProfileCoeffs, ff_coeffs: ProfileCoeffs, i_target, *,
                          d_r: float, d_z: float, mu0: float, h_mode: bool,
                          with_scalars: bool = False):
    """GS source ``-mu0 R J_phi`` from psi (signature of the JAX entry minus
    ``interpret``).  ``divertor_mask`` is the float mask ``ZZ < Z_min/2``.
    With ``with_scalars`` also returns a :class:`SourceScalars` readout."""
    if not psi.is_cuda:
        return fused_topology_source_plain(psi, r_1d, divertor_mask, p_coeffs, ff_coeffs,
                                           i_target, d_r=d_r, d_z=d_z, mu0=mu0,
                                           h_mode=h_mode, with_scalars=with_scalars)
    cb.check_f32_cuda("fused_topology_source", psi=psi, r_1d=r_1d,
                      divertor_mask=divertor_mask)
    nz, nr = psi.shape
    if divertor_mask.shape != psi.shape or r_1d.shape != (nr,):
        raise ValueError("fused_topology_source: psi, r_1d and divertor_mask shapes differ")
    par = torch.stack([_scalar(v, psi) for v in (*p_coeffs, *ff_coeffs, i_target)])
    nb = cb.source_blocks(nz * nr)
    part = torch.empty(3 * nb, dtype=torch.float32, device=psi.device)
    part_idx = torch.empty(nb, dtype=torch.int32, device=psi.device)
    ip_part = torch.empty(nb, dtype=torch.float32, device=psi.device)
    scal = torch.empty(3, dtype=torch.float32, device=psi.device)
    x_idx = torch.empty(1, dtype=torch.int32, device=psi.device)
    src = torch.empty_like(psi)
    cb.launch("scpn_fused_source", psi.data_ptr(), r_1d.data_ptr(), divertor_mask.data_ptr(),
              par.data_ptr(), nz, nr, d_r, d_z, mu0, int(h_mode), part.data_ptr(),
              part_idx.data_ptr(), ip_part.data_ptr(), scal.data_ptr(), x_idx.data_ptr(),
              src.data_ptr(), kernels=3)
    cb.CALLS["fused_topology_source"] += 1
    if with_scalars:
        return src, SourceScalars(scal[0], scal[1], x_idx[0].long(), scal[2])
    return src
