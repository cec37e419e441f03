"""Carry the JAX package's state across to the port.

The JAX package cannot be imported here (the GPU host has no jax), so the
hand-over is plain data: arrays as numpy (``np.asarray`` of a JAX array) and a
configuration as ``dataclasses.asdict(cfg)``.  These helpers turn that data
into the port's tensors and frozen config on a given device and dtype, so the
two packages can compute on the same inputs.
"""

from __future__ import annotations

import dataclasses
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
from scpn_fusion_tpu_torch.core.grid import Grid
from scpn_fusion_tpu_torch.models.equilibrium.differentiable import (
    PredictiveModel,
    PredictiveTheta,
)
from scpn_fusion_tpu_torch.models.equilibrium.fieldline import FieldModel
from scpn_fusion_tpu_torch.models.equilibrium.force_balance_3d import (
    ForceBalanceConfig,
    Geometry3D,
)
from scpn_fusion_tpu_torch.models.equilibrium.free_boundary import CoilSet
from scpn_fusion_tpu_torch.models.equilibrium.profiles import ProfileCoeffs
from scpn_fusion_tpu_torch.models.equilibrium.reconstruction import ReconCase
from scpn_fusion_tpu_torch.models.equilibrium.shape_control import ShapeTargets
from scpn_fusion_tpu_torch.models.equilibrium.solovev import SolovevParams
from scpn_fusion_tpu_torch.models.equilibrium.vmec_lite import SpectralBasis
from scpn_fusion_tpu_torch.models.surrogates.mlp import MLPParams
from scpn_fusion_tpu_torch.models.surrogates.pretrained import TransportSurrogate
from scpn_fusion_tpu_torch.models.transport.solver import TransportParams, TransportState


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


def _arrays(fields: Mapping[str, Any], *, dtype: torch.dtype, device: torch.device | str,
            keep: tuple[str, ...] = ()) -> dict[str, Any]:
    return {k: v if v is None or k in keep else tensor(v, dtype=dtype, device=device)
            for k, v in fields.items()}


def coilset(fields: Mapping[str, Any], *, dtype: torch.dtype,
            device: torch.device | str) -> CoilSet:
    """A ``CoilSet`` from the JAX ``CoilSet``'s fields (``coils._asdict()``,
    arrays as anything ``np.asarray`` takes; None stays None)."""
    return CoilSet(**_arrays(fields, dtype=dtype, device=device))


def shape_targets(fields: Mapping[str, Any], *, dtype: torch.dtype,
                  device: torch.device | str) -> ShapeTargets:
    """``ShapeTargets`` from the JAX ``ShapeTargets``' fields
    (``targets._asdict()``); the family weights stay Python floats."""
    return ShapeTargets(**_arrays(fields, dtype=dtype, device=device, keep=("weights",)))


def grid(fields: Mapping[str, Any], *, dtype: torch.dtype, device: torch.device | str) -> Grid:
    """A ``Grid`` from the JAX ``Grid``'s fields (``dataclasses.asdict``;
    its numpy dtype is replaced by ``dtype``)."""
    keys = ("NR", "NZ", "R_min", "R_max", "Z_min", "Z_max")
    return Grid(**{k: fields[k] for k in keys}, dtype=dtype, device=torch.device(device))


def predictive_theta(fields: Mapping[str, Any], *, dtype: torch.dtype,
                     device: torch.device | str) -> PredictiveTheta:
    """``PredictiveTheta`` from the JAX ``PredictiveTheta``'s fields
    (``theta._asdict()``)."""
    return PredictiveTheta(**_arrays(fields, dtype=dtype, device=device))


def predictive_model(fields: Mapping[str, Any], *, dtype: torch.dtype,
                     device: torch.device | str) -> PredictiveModel:
    """``PredictiveModel`` from the JAX ``PredictiveModel``'s fields
    (``model._asdict()`` with ``grid`` as ``dataclasses.asdict(model.grid)``);
    the coil table is carried over, not rebuilt."""
    return PredictiveModel(
        grid=grid(fields["grid"], dtype=dtype, device=device),
        coil_table=tensor(fields["coil_table"], dtype=dtype, device=device),
        relax=float(fields["relax"]), sweeps_per_iter=int(fields["sweeps_per_iter"]),
        use_vcycle=bool(fields["use_vcycle"]))


def _same_fields(cls, fields: Mapping[str, Any]):
    """A frozen dataclass of the port from the JAX twin's
    ``dataclasses.asdict`` (identical field names, plain values)."""
    return cls(**{f.name: fields[f.name] for f in dataclasses.fields(cls)})


def recon_case(fields: Mapping[str, Any]) -> ReconCase:
    """``ReconCase`` (host numpy) from ``dataclasses.asdict`` of the JAX one."""
    return _same_fields(ReconCase, fields)


def spectral_basis(fields: Mapping[str, Any]) -> SpectralBasis:
    return _same_fields(SpectralBasis, fields)


def geometry_3d(fields: Mapping[str, Any]) -> Geometry3D:
    return _same_fields(Geometry3D, fields)


def force_balance_config(fields: Mapping[str, Any]) -> ForceBalanceConfig:
    return _same_fields(ForceBalanceConfig, fields)


def field_model(fields: Mapping[str, Any]) -> FieldModel:
    return _same_fields(FieldModel, fields)


def solovev_params(fields: Mapping[str, Any]) -> SolovevParams:
    return _same_fields(SolovevParams, fields)


def transport_params(fields: Mapping[str, Any]) -> TransportParams:
    """``TransportParams`` from ``dataclasses.asdict`` of the JAX one."""
    return _same_fields(TransportParams, fields)


def transport_state(fields: Mapping[str, Any], *, dtype: torch.dtype,
                    device: torch.device | str) -> TransportState:
    """``TransportState`` from the JAX ``TransportState``'s fields
    (``state._asdict()``)."""
    return TransportState(**_arrays(fields, dtype=dtype, device=device))


def transport_surrogate(fields: Mapping[str, Any], *,
                        device: torch.device | str) -> TransportSurrogate:
    """``TransportSurrogate`` from the JAX one's fields (``sur._asdict()``,
    ``params`` with ``weights`` and ``biases``); every array keeps its dtype."""
    def t(x):
        return torch.from_numpy(np.array(x, copy=True)).to(device)

    params = fields["params"]
    return TransportSurrogate(
        params=MLPParams(weights=tuple(t(w) for w in params.weights),
                         biases=tuple(t(b) for b in params.biases)),
        **{k: t(fields[k]) for k in ("x_mean", "x_std", "y_mean", "y_std")})


# ── the learned controllers' parameters ──


def _as(a, dtype: torch.dtype | None, device) -> torch.Tensor:
    """An array as a tensor on ``device``, in ``dtype`` (None: its own)."""
    x = torch.from_numpy(np.array(a, copy=True))
    return x.to(device=device, dtype=dtype or x.dtype)


def mlp_params(params, *, dtype: torch.dtype | None = None,
               device: torch.device | str = "cuda") -> MLPParams:
    """The JAX package's ``MLPParams`` (its arrays as numpy) as the port's;
    ``dtype`` None keeps each array's own."""
    def t(a):
        return _as(a, dtype, device)

    return MLPParams(tuple(t(w) for w in params.weights), tuple(t(b) for b in params.biases))


def seq_predictor_params(params, *, dtype: torch.dtype | None = None,
                         device: torch.device | str = "cuda"):
    """The JAX package's ``SeqPredictorParams`` (per-layer ``LayerParams``)
    as the port's."""
    from scpn_fusion_tpu_torch.control.disruption_seq import LayerParams, SeqPredictorParams

    def t(a):
        return _as(a, dtype, device)

    layers = tuple(LayerParams(*(t(getattr(lp, f)) for f in LayerParams._fields))
                   for lp in params.layers)
    return SeqPredictorParams(**{f: t(getattr(params, f)) for f in SeqPredictorParams._fields
                                 if f != "layers"}, layers=layers)


def policy_params(params, *, dtype: torch.dtype | None = None,
                  device: torch.device | str = "cuda"):
    """The JAX package's safe-RL ``PolicyParams`` as the port's."""
    from scpn_fusion_tpu_torch.control.safe_rl import PolicyParams

    return PolicyParams(*(_as(getattr(params, f), dtype, device) for f in PolicyParams._fields))


def nef_channel(channel, *, dtype: torch.dtype | None = None,
                device: torch.device | str = "cuda"):
    """The JAX package's ``NefChannel`` (two ``LIFParams`` and the
    decoders) as the port's."""
    from scpn_fusion_tpu_torch.control.nef_snn import LIFParams, NefChannel

    def t(a):
        return _as(a, dtype, device)

    def pop(p):
        return LIFParams(*(t(getattr(p, f)) for f in LIFParams._fields))

    return NefChannel(pop(channel.error_pop), pop(channel.control_pop), t(channel.d_gain),
                      t(channel.d_id))


def equilibrium_surrogate(sur, *, device: torch.device | str = "cuda"):
    """The JAX package's ``EquilibriumSurrogate`` as the port's, dtypes kept."""
    from scpn_fusion_tpu_torch.models.surrogates.equilibrium_surrogate import (
        EquilibriumSurrogate,
    )

    def t(a):
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    return EquilibriumSurrogate(
        mlp=mlp_params(sur.mlp, device=device),
        **{f: t(getattr(sur, f)) for f in ("components", "psi_mean", "x_mean", "x_std",
                                           "coeff_scale")},
        shape=tuple(sur.shape))


# ── the phase monitor and the polynomial chaos ──


def _fields_of(x) -> Mapping[str, Any]:
    """A NamedTuple's fields (``_asdict()``), or the mapping itself."""
    return x._asdict() if hasattr(x, "_asdict") else x


def guard_state(fields, *, dtype: torch.dtype = torch.float32,
                device: torch.device | str = "cuda"):
    """The JAX package's ``GuardState`` (or its fields) as the port's: the
    ring in ``dtype``, the two counters int32."""
    from scpn_fusion_tpu_torch.models.phase.guard import GuardState

    f = _fields_of(fields)
    return GuardState(_as(f["v_buffer"], dtype, device),
                      *(_as(f[k], torch.int32, device) for k in ("n_seen", "consecutive")))


def monitor_state(fields, *, dtype: torch.dtype = torch.float32,
                  device: torch.device | str = "cuda"):
    """The JAX package's ``MonitorState`` (or its fields, the guard a
    ``GuardState`` or its fields) as the port's."""
    from scpn_fusion_tpu_torch.models.phase.monitor import MonitorState

    f = _fields_of(fields)
    return MonitorState(theta=_as(f["theta"], dtype, device),
                        guard=guard_state(f["guard"], dtype=dtype, device=device),
                        tick=_as(f["tick"], torch.int32, device))


def monitor_arrays(arrays: Mapping[str, Any], *, dtype: torch.dtype = torch.float32,
                   device: torch.device | str = "cuda") -> dict:
    """The monitor's static arrays (``omega``, ``mask``, ``k_matrix``,
    ``alpha``, ``zeta``) of ``init_monitor`` as the port's."""
    return {k: _as(v, dtype, device) for k, v in arrays.items()}


def pce_model(model, *, dtype: torch.dtype | None = None,
              device: torch.device | str = "cuda"):
    """The JAX package's ``PCEModel`` as the port's: the coefficients a
    tensor (``dtype`` None keeps theirs), the multi-index as it is."""
    from scpn_fusion_tpu_torch.models.uq.pce import PCEModel

    f = _fields_of(model)
    return PCEModel(_as(f["coefficients"], dtype, device),
                    tuple(tuple(int(a) for a in alpha) for alpha in f["multi_index"]))
