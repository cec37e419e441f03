"""Spatial domain decomposition over a device mesh: Z-slab halo exchange
(port of ``scpn_fusion_tpu/parallel/halo.py``).

The psi grid is cut into Z slabs, one a shard of a :class:`~.mesh.Mesh`
axis; every red-black half-sweep first exchanges one halo row with each Z
neighbour (``_halo_exchange``: the neighbour's edge row copied to this
shard's device, zeros at the global ends, as JAX's ``ppermute`` gives), and
the update norm of a sweep is a :func:`~.mesh.psum` of the shards' partial
sums.  Each shard keeps *global* checkerboard parity from its row offset, so
the distributed sweep is the single-device sweep's arithmetic, row for row.

The mesh is single-controller (see ``parallel/mesh.py``): this process
runs every shard's operations, on the shard's device.  These are plain
PyTorch ops; no hand-written kernel runs on a sharded path, as no Pallas
kernel runs inside JAX's ``shard_map``.
"""

from __future__ import annotations

import functools

import torch

from scpn_fusion_tpu_torch.ops.stencil import stencil_coeffs
from scpn_fusion_tpu_torch.parallel.mesh import Mesh, gather_rows, make_mesh, psum, shard_rows


def make_z_mesh(n_devices: int | None = None, axis: str = "z", *,
                device: torch.device | str = "cuda") -> Mesh:
    """1D mesh over the Z (slab) axis: the first ``n_devices`` CUDA devices
    (all of them by default), raising when the host has fewer, as the JAX
    function does; ``device="cpu"`` gives ``n_devices`` CPU shards."""
    return make_mesh(n_devices, (axis,), None, device)


def _halo_exchange(shards: list[torch.Tensor]) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """One halo row from each Z neighbour: ``(top_halo, bot_halo)`` for every
    shard, on its device.  The first shard's top and the last shard's bottom
    halo are zeros (the global boundary rows are Dirichlet and never read
    them)."""
    out = []
    for i, s in enumerate(shards):
        top = shards[i - 1][-1].to(s.device) if i > 0 else torch.zeros_like(s[0])
        bot = shards[i + 1][0].to(s.device) if i + 1 < len(shards) else torch.zeros_like(s[0])
        out.append((top, bot))
    return out


def _halo_pad(shards: list[torch.Tensor]) -> list[torch.Tensor]:
    """Every local slab with its exchanged halo rows: (L + 2, NR) each."""
    return [torch.cat([top[None], s, bot[None]], 0)
            for s, (top, bot) in zip(shards, _halo_exchange(shards))]


@functools.lru_cache(maxsize=512)
def _sweep_mask(l_rows: int, nr: int, parity: int, row_offset: int, nz_total: int,
               device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The points of a slab's interior columns that a half-sweep updates, as
    0/1 weights: global checkerboard parity and a global interior row.  Made
    once a slab (a plain sweep is launch-bound)."""
    iz = torch.arange(l_rows, device=device)[:, None] + row_offset
    ir = torch.arange(1, nr - 1, device=device)[None, :]
    return ((((iz + ir) % 2) == parity) & (iz >= 1) & (iz <= nz_total - 2)).to(dtype)


def _local_half_sweep(psi_pad: torch.Tensor, source_local: torch.Tensor, a_e: torch.Tensor,
                      a_w: torch.Tensor, a_ns: float, a_c: float, omega: float, parity: int,
                      row_offset: int, nz_total: int) -> torch.Tensor:
    """One red/black half-sweep on a halo-padded local slab ``(L + 2, NR)``;
    returns the updated local block ``(L, NR)``.  Points take part where
    ``(global row + column) % 2 == parity`` and the global row is interior."""
    local = psi_pad[1:-1]
    l_rows, nr = local.shape
    gs = (a_e[None, :] * psi_pad[1:-1, 2:] + a_w[None, :] * psi_pad[1:-1, :-2]
          + a_ns * (psi_pad[:-2, 1:-1] + psi_pad[2:, 1:-1]) - source_local[:, 1:-1]) / a_c
    mask = _sweep_mask(l_rows, nr, parity, row_offset, nz_total, local.device, local.dtype)
    old = local[:, 1:-1]
    out = local.clone()
    out[:, 1:-1] = old + mask * omega * (gs - old)
    return out


def _row_offsets(shards: list[torch.Tensor]) -> list[int]:
    """Each slab's first global row."""
    offs = [0]
    for s in shards[:-1]:
        offs.append(offs[-1] + s.shape[0])
    return offs


def _half_sweeps(shards, sources, coeffs, omega, parity, nz_total):
    """One half-sweep on every shard, after a halo exchange."""
    a_e, a_w, a_ns, a_c = coeffs
    return [_local_half_sweep(p, src, a_e.to(p.device), a_w.to(p.device), a_ns, a_c, omega,
                              parity, off, nz_total)
            for p, src, off in zip(_halo_pad(shards), sources, _row_offsets(shards))]


def sharded_sor_solve(psi: torch.Tensor, source: torch.Tensor, r_1d: torch.Tensor,
                      omega: float | torch.Tensor, *, mesh: Mesh, axis: str, d_r: float,
                      d_z: float, n_sweeps: int, nz_total: int):
    """Distributed red-black SOR: ``n_sweeps`` sweeps on Z slabs over
    ``mesh[axis]`` with two halo exchanges a sweep.

    ``psi`` and ``source`` are global (NZ, NR) tensors whose rows divide
    into the shards; ``r_1d`` the R row.  Returns ``(psi_out, res_l2)``: the
    global field and the L2 norm of the last sweep's update (psum over the
    shards), both on the mesh's first device."""
    if mesh.shape[axis] != mesh.size:
        raise ValueError(f"sharded_sor_solve: {mesh} is not a mesh over {axis!r} alone")
    omega = float(omega)
    coeffs = stencil_coeffs(r_1d[1:-1], d_r, d_z)
    p = shard_rows(psi, mesh)
    srcs = shard_rows(source, mesh)
    res = torch.zeros((), dtype=psi.dtype, device=mesh.first)
    for _ in range(n_sweeps):
        prev = p
        for parity in (0, 1):
            p = _half_sweeps(p, srcs, coeffs, omega, parity, nz_total)
        res = torch.sqrt(psum([((a - b) ** 2).sum() for a, b in zip(p, prev)])[0])
    return gather_rows(p, mesh.first), res
