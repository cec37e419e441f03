"""Vacuum (external coil) poloidal flux via toroidal Green's functions
(port of ``scpn_fusion_tpu/models/equilibrium/vacuum.py``).

The coil loop is a batch dimension: ``coil_response_table`` evaluates every
coil on the whole grid at once, and the vacuum field for a set of currents
is one contraction of that table.
"""

from __future__ import annotations

import torch

from scpn_fusion_tpu_torch.core.config import ReactorConfig
from scpn_fusion_tpu_torch.core.grid import Grid
from scpn_fusion_tpu_torch.core.special import green_coil_psi


def coil_response_table(grid: Grid, coil_r: torch.Tensor, coil_z: torch.Tensor,
                        mu0: float) -> torch.Tensor:
    """Per-coil unit-current flux response, shape ``(n_coils, NZ, NR)``."""
    rr, zz = grid.RR[None], grid.ZZ[None]
    return green_coil_psi(coil_r[:, None, None], coil_z[:, None, None], rr, zz, mu0)


def vacuum_psi_from_table(table: torch.Tensor, currents_eff: torch.Tensor) -> torch.Tensor:
    """Vacuum flux as the table contracted with (current * turns) currents."""
    return (currents_eff[:, None, None] * table).sum(0)


def vacuum_psi(grid: Grid, coil_r: torch.Tensor, coil_z: torch.Tensor,
               currents_eff: torch.Tensor, mu0: float) -> torch.Tensor:
    """Vacuum poloidal flux on the (NZ, NR) grid from an arbitrary coil set."""
    return vacuum_psi_from_table(coil_response_table(grid, coil_r, coil_z, mu0), currents_eff)


def coil_arrays_from_config(cfg: ReactorConfig, dtype: torch.dtype = torch.float32,
                            device: torch.device | str = "cpu"):
    """The static coil list as (r, z, I*turns) tensors."""
    coils = cfg.coils
    r = torch.tensor([c.r for c in coils], dtype=dtype, device=device)
    z = torch.tensor([c.z for c in coils], dtype=dtype, device=device)
    i_eff = torch.tensor([c.current * c.turns for c in coils], dtype=dtype, device=device)
    return r, z, i_eff


def vacuum_psi_from_config(grid: Grid, cfg: ReactorConfig) -> torch.Tensor:
    """Vacuum field for the config's coil set (zero if no coils), on the
    grid's device and dtype."""
    if not cfg.coils:
        return grid.zeros()
    r, z, i_eff = coil_arrays_from_config(cfg, grid.dtype, grid.device)
    return vacuum_psi(grid, r, z, i_eff, float(cfg.physics.vacuum_permeability))
