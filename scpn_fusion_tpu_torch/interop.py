"""Carry the JAX package's state across to the port.

The JAX package cannot be imported here (the GPU host has no jax), so the
hand-over is plain data: arrays as numpy (``np.asarray`` of a JAX array) and a
configuration as ``dataclasses.asdict(cfg)``.  These helpers turn that data
into the port's tensors and frozen config on a given device and dtype, so the
two packages can compute on the same inputs.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from scpn_fusion_tpu_torch.core.config import (
    Coil,
    Dimensions,
    PhysicsParams,
    ProfileParams,
    ReactorConfig,
    SolverParams,
)
from scpn_fusion_tpu_torch.models.equilibrium.profiles import ProfileCoeffs


def tensor(x, *, dtype: torch.dtype, device: torch.device | str) -> torch.Tensor:
    """A numpy array (or anything ``np.asarray`` takes) as a tensor."""
    return torch.from_numpy(np.array(x, copy=True)).to(dtype=dtype, device=device)


def config_from_asdict(d: Mapping[str, Any]) -> ReactorConfig:
    """Rebuild a ``ReactorConfig`` from ``dataclasses.asdict`` of the JAX
    package's config (field names are identical)."""
    phys = dict(d["physics"])
    phys["p_prime"] = ProfileParams(**phys["p_prime"])
    phys["ff_prime"] = ProfileParams(**phys["ff_prime"])
    return ReactorConfig(
        dimensions=Dimensions(**d["dimensions"]),
        reactor_name=d["reactor_name"],
        grid_resolution=tuple(int(v) for v in d["grid_resolution"]),
        coils=tuple(Coil(**c) for c in d["coils"]),
        physics=PhysicsParams(**phys),
        solver=SolverParams(**d["solver"]),
    )


def profile_coeffs(fields, *, dtype: torch.dtype, device: torch.device | str) -> ProfileCoeffs:
    """``ProfileCoeffs`` from the four JAX fields (ped_top, ped_width,
    ped_height, core_alpha), each anything ``np.asarray`` takes."""
    return ProfileCoeffs(*(tensor(f, dtype=dtype, device=device).reshape(()) for f in fields))


def coil_arrays(r, z, i_eff, *, dtype: torch.dtype, device: torch.device | str):
    """The JAX ``coil_arrays_from_config`` triple as tensors."""
    return tuple(tensor(a, dtype=dtype, device=device) for a in (r, z, i_eff))
