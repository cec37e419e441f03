"""The committed surrogates (port of the loaders of
``scpn_fusion_tpu/models/surrogates/pretrained.py``): the neural-transport
closure and the equilibrium surrogate.

``weights/neural_transport.npz`` (an MLP 7 -> 64 -> 64 -> 3 with its input and
output normalisation) maps the local dimensionless inputs [R/L_Ti, R/L_Te,
R/L_ne, q, s_hat, Te/Ti, nu_star] to [chi_i, chi_e, D_e] in gyro-Bohm units.
Loading is fail-closed as in the JAX package: the sha256 of the NPZ must
equal the one in ``weights/neural_transport.metrics.json``, or nothing loads.
``weights/neural_equilibrium.npz`` (PCA basis + MLP: 6 coil currents -> a
psi map) loads the same way (:func:`load_equilibrium_artifact`).  Training
the artifacts stays with the JAX package.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from scpn_fusion_tpu_torch.models.surrogates.mlp import MLPParams, mlp_apply

WEIGHTS_DIR = Path(__file__).resolve().parents[3] / "weights"
N_IN, N_OUT = 7, 3


class TransportSurrogate(NamedTuple):
    """The neural-transport closure the transport stepper takes."""

    params: MLPParams
    x_mean: torch.Tensor
    x_std: torch.Tensor
    y_mean: torch.Tensor
    y_std: torch.Tensor

    def fluxes_gb(self, x: torch.Tensor) -> torch.Tensor:
        """(n, 7) local inputs -> (n, 3) gyro-Bohm fluxes, non-negative.  The
        normalised inputs are cast to the artifact's float32, also inside a
        float64 step, as in JAX."""
        xn = (x - self.x_mean) / self.x_std
        y = mlp_apply(self.params, xn.to(self.x_mean.dtype)) * self.y_std + self.y_mean
        return torch.clamp(y, min=0.0)

    def max_abs_z(self, x: torch.Tensor) -> torch.Tensor:
        """Per-row max |z-score| against the TRAINING envelope: the OOD index."""
        return torch.amax(((x - self.x_mean) / self.x_std).abs(), dim=-1)


def _load_artifact(name: str, weights_dir: Path | None = None) -> tuple[dict, dict]:
    """Fail-closed NPZ + metrics load (the sha256 must match): (arrays, metrics)."""
    out = weights_dir or WEIGHTS_DIR
    npz_path = out / f"{name}.npz"
    metrics_path = out / f"{name}.metrics.json"
    if not npz_path.exists() or not metrics_path.exists():
        raise FileNotFoundError(f"missing artifact pair for {name!r} under {out}")
    metrics = json.loads(metrics_path.read_text())
    actual = hashlib.sha256(npz_path.read_bytes()).hexdigest()
    if metrics.get("sha256") != actual:
        raise RuntimeError(
            f"surrogate artifact checksum mismatch for {name!r}: "
            "refusing to load (retrain with train_transport_surrogate)")
    with np.load(npz_path) as data:
        return {k: np.asarray(data[k]) for k in data.files}, metrics


def _mlp_from(arrays: dict, device) -> MLPParams:
    n_layers = sum(1 for k in arrays if k.startswith("w"))

    def t(a):
        return torch.from_numpy(np.array(a)).to(device)

    return MLPParams(weights=tuple(t(arrays[f"w{i}"]) for i in range(n_layers)),
                     biases=tuple(t(arrays[f"b{i}"]) for i in range(n_layers)))


def load_transport_surrogate_pytree(
    name: str = "neural_transport",
    weights_dir: Path | None = None,
    *,
    device: torch.device | str = "cuda",
) -> tuple[TransportSurrogate, dict]:
    """Fail-closed load of the artifact as a :class:`TransportSurrogate` on
    ``device``; returns it and the metrics."""
    arrays, metrics = _load_artifact(name, weights_dir)
    surrogate = TransportSurrogate(
        params=_mlp_from(arrays, device),
        **{k: torch.from_numpy(np.array(arrays[k], dtype=np.float32)).to(device)
           for k in ("x_mean", "x_std", "y_mean", "y_std")})
    return surrogate, metrics


def load_equilibrium_artifact(name: str = "neural_equilibrium", weights_dir: Path | None = None,
                              *, device: torch.device | str = "cuda"):
    """Fail-closed load of the committed equilibrium surrogate (PCA basis +
    MLP, ``weights/neural_equilibrium.npz``) on ``device``; returns
    (surrogate, metrics)."""
    from scpn_fusion_tpu_torch.models.surrogates.equilibrium_surrogate import (
        EquilibriumSurrogate,
    )

    arrays, metrics = _load_artifact(name, weights_dir)
    n = int(metrics["grid"])
    sur = EquilibriumSurrogate(
        mlp=_mlp_from(arrays, device),
        **{k: torch.from_numpy(np.array(arrays[k])).to(device)
           for k in ("components", "psi_mean", "x_mean", "x_std", "coeff_scale")},
        shape=(n, n))
    return sur, metrics
