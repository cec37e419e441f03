"""Fused topology + Grad-Shafranov source as a hand-written CUDA kernel
(port of ``scpn_fusion_tpu/ops/pallas_source.py``).

Per Picard iteration: psi_axis = max psi (floored at 1e-6); the X-point as
the first row-major minimum of |grad psi| over the divertor mask (the global
psi minimum when the mask is empty); the |axis - boundary| < 0.1 snap; the
L/H-mode profiles, the Ip renormalisation and ``-mu0 R J_phi``.  On a CUDA
float32 tensor this is one cooperative launch of ``csrc/source.cu`` (two
grid-wide reductions and an elementwise pass, a grid barrier apart); on a CPU
tensor it runs :func:`fused_topology_source_plain`, the same chain in PyTorch
ops.

What a solve fixes once is paid once: :func:`pack_source_params` packs the
nine profile and current parameters for the kernel before the Picard loop,
and the kernel's scratch is one workspace cached per device and size, so a
call allocates only its output.  The workspace is shared by every call on
the device: calls must be ordered on one stream, as a solve's are.

Batches (the ensembles of ``parallel/ensemble.py``):
:func:`fused_topology_source_batched` computes the source of every element
of a (B, nz, nr) batch, each with its own target current
(:func:`pack_source_params_batched`), in three launches of the staged
kernels on a (blocks, B) grid (entry ``scpn_fused_source_batched``):
element b equals :func:`fused_topology_source` on element b bit for bit.
Its plain twin, :func:`fused_topology_source_batched_plain`, is the loop of
the plain version over the batch.

Sizes: the port runs the kernel at every float32 size, where the JAX solver
takes its fused source only while psi, mask and source fit 12 MB of VMEM
(513^2) and XLA ops above.  Nothing on the card needs that gate: the kernel
streams the grid from device memory with a cooperative grid of at most
``cb.source_blocks`` blocks (264), which the device holds at once at every
size, and its reductions are exact (max, first arg-min) or a fixed-order
block sum.  ``chip_smoke.py`` holds it against the plain version at 513^2,
1025^2, 2049^2, 4097^2 and on the rectangular 257 x 129 grid.  A launch
that fails raises; nothing falls back to the plain version on a CUDA tensor.
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


class SourceParams(NamedTuple):
    """The parameters a solve fixes, packed once (:func:`pack_source_params`)."""

    packed: torch.Tensor   # (9,): p' coefficients, FF' coefficients, I_target
    p_coeffs: ProfileCoeffs
    ff_coeffs: ProfileCoeffs
    i_target: torch.Tensor


def pack_source_params(p_coeffs: ProfileCoeffs, ff_coeffs: ProfileCoeffs, i_target, *,
                       like: torch.Tensor | None = None) -> SourceParams:
    """Pack the profile coefficients and the target current in the order
    ``csrc/source.cu`` reads them, in the dtype and on the device of ``like``
    (by default those of the first tensor among the values)."""
    if like is None:
        tensors = [v for v in (*p_coeffs, *ff_coeffs, i_target) if isinstance(v, torch.Tensor)]
        like = tensors[0] if tensors else torch.zeros((), dtype=torch.float32)
    packed = torch.stack([_scalar(v, like) for v in (*p_coeffs, *ff_coeffs, i_target)])
    return SourceParams(packed, p_coeffs, ff_coeffs, packed[8])


_WORKSPACES: dict[tuple[int, int], tuple[torch.Tensor, ...]] = {}


def _workspace(device: torch.device, n_blocks: int) -> tuple[torch.Tensor, ...]:
    """The kernel's scratch for ``n_blocks`` blocks on ``device``: block
    partials ``part`` (3 a block), ``part_idx`` and ``ip_part`` (1 a block),
    and the readout ``scal`` (3) and ``x_idx`` (1), as views of one buffer
    (the index views as int32), made once and cached."""
    key = (device.index if device.index is not None else torch.cuda.current_device(), n_blocks)
    views = _WORKSPACES.get(key)
    if views is None:
        nb = n_blocks
        buf = torch.empty(5 * nb + 4, dtype=torch.float32, device=device)
        ints = buf.view(torch.int32)
        views = _WORKSPACES[key] = (buf[:3 * nb], ints[3 * nb:4 * nb], buf[4 * nb:5 * nb],
                                    buf[5 * nb:5 * nb + 3], ints[5 * nb + 3:])
    return views


def _launch_source(entry, kernels, workspace, psi, r_1d, divertor_mask, params, d_r, d_z, mu0,
                   h_mode, with_scalars):
    part, part_idx, ip_part, scal, x_idx = workspace
    src = torch.empty_like(psi)
    cb.launch(entry, psi.data_ptr(), r_1d.data_ptr(), divertor_mask.data_ptr(),
              params.packed.data_ptr(), psi.shape[0], psi.shape[1], d_r, d_z, mu0, int(h_mode),
              part.data_ptr(), part_idx.data_ptr(), ip_part.data_ptr(), scal.data_ptr(),
              x_idx.data_ptr(), src.data_ptr(), kernels=kernels)
    if with_scalars:
        scal = scal.clone()
        return src, SourceScalars(scal[0], scal[1], x_idx[0].long(), scal[2])
    return src


def _check_source(psi, r_1d, divertor_mask, params) -> None:
    cb.check_f32_cuda("fused_topology_source", psi=psi, r_1d=r_1d,
                      divertor_mask=divertor_mask, params=params.packed)
    if divertor_mask.shape != psi.shape or r_1d.shape != (psi.shape[1],):
        raise ValueError("fused_topology_source: psi, r_1d and divertor_mask shapes differ")


def _as_params(p_coeffs, ff_coeffs, i_target, like: torch.Tensor) -> SourceParams:
    if isinstance(p_coeffs, SourceParams):
        if ff_coeffs is not None or i_target is not None:
            raise TypeError("fused_topology_source: packed parameters take the place of "
                            "p_coeffs, ff_coeffs and i_target")
        return p_coeffs
    return pack_source_params(p_coeffs, ff_coeffs, i_target, like=like)


def _fused_topology_source_staged(psi, r_1d, divertor_mask, p_coeffs, ff_coeffs=None,
                                  i_target=None, *, d_r, d_z, mu0, h_mode, with_scalars=False):
    """The same function as three launches (reduce, Ip sum, apply) with the
    scratch allocated anew in every call: what :func:`fused_topology_source`
    must equal bit for bit, and what a call cost before it became one launch.
    Off every solver path; adds to no wrapper's count."""
    params = _as_params(p_coeffs, ff_coeffs, i_target, psi)
    _check_source(psi, r_1d, divertor_mask, params)
    nb = cb.source_blocks(psi.numel())
    f32, i32 = dict(dtype=torch.float32, device=psi.device), dict(dtype=torch.int32,
                                                                  device=psi.device)
    workspace = (torch.empty(3 * nb, **f32), torch.empty(nb, **i32), torch.empty(nb, **f32),
                 torch.empty(3, **f32), torch.empty(1, **i32))
    return _launch_source("scpn_fused_source_staged", 3, workspace, psi, r_1d, divertor_mask,
                          params, d_r, d_z, mu0, h_mode, with_scalars)


def fused_topology_source(psi: torch.Tensor, r_1d: torch.Tensor, divertor_mask: torch.Tensor,
                          p_coeffs: ProfileCoeffs | SourceParams,
                          ff_coeffs: ProfileCoeffs | None = None, i_target=None, *,
                          d_r: float, d_z: float, mu0: float, h_mode: bool,
                          with_scalars: bool = False):
    """GS source ``-mu0 R J_phi`` from psi (signature of the JAX entry minus
    ``interpret``).  ``divertor_mask`` is the float mask ``ZZ < Z_min/2``.
    The result of :func:`pack_source_params` may stand in place of
    ``p_coeffs, ff_coeffs, i_target``; given those three, the call packs them
    itself.  With ``with_scalars`` also returns a :class:`SourceScalars`
    readout (fresh tensors)."""
    if not psi.is_cuda:
        if isinstance(p_coeffs, SourceParams):
            _, p_coeffs, ff_coeffs, i_target = _as_params(p_coeffs, ff_coeffs, i_target, psi)
        return fused_topology_source_plain(psi, r_1d, divertor_mask, p_coeffs, ff_coeffs,
                                           i_target, d_r=d_r, d_z=d_z, mu0=mu0,
                                           h_mode=h_mode, with_scalars=with_scalars)
    params = _as_params(p_coeffs, ff_coeffs, i_target, psi)
    _check_source(psi, r_1d, divertor_mask, params)
    out = _launch_source("scpn_fused_source", 1,
                         _workspace(psi.device, cb.source_blocks(psi.numel())), psi, r_1d,
                         divertor_mask, params, d_r, d_z, mu0, h_mode, with_scalars)
    cb.CALLS["fused_topology_source"] += 1
    return out


class BatchedSourceParams(NamedTuple):
    """The parameters of a batch, packed once (:func:`pack_source_params_batched`)."""

    packed: torch.Tensor     # (B, 9): the shared coefficients, then each element's I_target
    p_coeffs: ProfileCoeffs
    ff_coeffs: ProfileCoeffs
    i_targets: torch.Tensor  # (B,)


def pack_source_params_batched(p_coeffs: ProfileCoeffs, ff_coeffs: ProfileCoeffs,
                               i_targets: torch.Tensor, *,
                               like: torch.Tensor) -> BatchedSourceParams:
    """Pack the shared profile coefficients and the per-element target
    currents ``i_targets`` (B,) in the dtype and on the device of ``like``,
    one row of :func:`pack_source_params`'s layout an element."""
    coeffs = torch.stack([_scalar(v, like) for v in (*p_coeffs, *ff_coeffs)])
    i_t = i_targets.to(dtype=like.dtype, device=like.device).reshape(-1)
    packed = torch.cat([coeffs.expand(i_t.shape[0], 8), i_t[:, None]], 1).contiguous()
    return BatchedSourceParams(packed, p_coeffs, ff_coeffs, packed[:, 8])


def fused_topology_source_batched_plain(psi, r_1d, divertor_mask, params: BatchedSourceParams,
                                        *, d_r, d_z, mu0, h_mode, with_scalars=False):
    """Plain version of :func:`fused_topology_source_batched`: the plain
    version on each element, stacked."""
    outs = [fused_topology_source_plain(p, r_1d, divertor_mask, params.p_coeffs,
                                        params.ff_coeffs, i_t, d_r=d_r, d_z=d_z, mu0=mu0,
                                        h_mode=h_mode, with_scalars=True)
            for p, i_t in zip(psi, params.i_targets)]
    src = torch.stack([o[0] for o in outs])
    if with_scalars:
        return src, SourceScalars(*(torch.stack([o[1][f] for o in outs]) for f in range(4)))
    return src


_BATCH_WORKSPACES: dict[tuple[int, int, int], tuple[torch.Tensor, ...]] = {}


def _batch_workspace(device: torch.device, n_blocks: int,
                     n_batch: int) -> tuple[torch.Tensor, ...]:
    """The batched kernels' scratch, element-major, cached per device, block
    count and batch size (the layout of :func:`_workspace` for ``n_batch``
    elements)."""
    key = (device.index if device.index is not None else torch.cuda.current_device(), n_blocks,
           n_batch)
    views = _BATCH_WORKSPACES.get(key)
    if views is None:
        nb, b = n_blocks, n_batch
        buf = torch.empty(5 * nb * b + 4 * b, dtype=torch.float32, device=device)
        ints = buf.view(torch.int32)
        views = _BATCH_WORKSPACES[key] = (
            buf[:3 * nb * b], ints[3 * nb * b:4 * nb * b], buf[4 * nb * b:5 * nb * b],
            buf[5 * nb * b:5 * nb * b + 3 * b], ints[5 * nb * b + 3 * b:])
    return views


def fused_topology_source_batched(psi: torch.Tensor, r_1d: torch.Tensor,
                                  divertor_mask: torch.Tensor, params: BatchedSourceParams, *,
                                  d_r: float, d_z: float, mu0: float, h_mode: bool,
                                  with_scalars: bool = False):
    """GS source of every element of the (B, nz, nr) batch ``psi``, element
    b with target current ``params.i_targets[b]``; ``r_1d`` and
    ``divertor_mask`` are shared.  On CUDA tensors: three launches and one
    allocation, the output's.  With ``with_scalars`` also returns a
    :class:`SourceScalars` readout of (B,) tensors (fresh tensors)."""
    if not psi.is_cuda:
        return fused_topology_source_batched_plain(psi, r_1d, divertor_mask, params, d_r=d_r,
                                                   d_z=d_z, mu0=mu0, h_mode=h_mode,
                                                   with_scalars=with_scalars)
    cb.check_f32_cuda("fused_topology_source_batched", psi=psi, r_1d=r_1d,
                      divertor_mask=divertor_mask, params=params.packed)
    if (psi.dim() != 3 or params.packed.shape != (psi.shape[0], 9)
            or divertor_mask.shape != psi.shape[1:] or r_1d.shape != (psi.shape[2],)):
        raise ValueError(f"fused_topology_source_batched: psi {tuple(psi.shape)}, params "
                         f"{tuple(params.packed.shape)}, divertor_mask "
                         f"{tuple(divertor_mask.shape)} and r_1d {tuple(r_1d.shape)} do not "
                         f"make a batch")
    n_batch, nz, nr = psi.shape
    part, part_idx, ip_part, scal, x_idx = _batch_workspace(
        psi.device, cb.source_blocks(nz * nr), n_batch)
    src = torch.empty_like(psi)
    cb.launch("scpn_fused_source_batched", psi.data_ptr(), r_1d.data_ptr(),
              divertor_mask.data_ptr(), params.packed.data_ptr(), 9, nz, nr, n_batch, d_r, d_z,
              mu0, int(h_mode), part.data_ptr(), part_idx.data_ptr(), ip_part.data_ptr(),
              scal.data_ptr(), x_idx.data_ptr(), src.data_ptr(), kernels=3)
    cb.CALLS["fused_topology_source_batched"] += 1
    if with_scalars:
        s = scal.view(n_batch, 3).clone()
        return src, SourceScalars(s[:, 0], s[:, 1], x_idx.long(), s[:, 2])
    return src
