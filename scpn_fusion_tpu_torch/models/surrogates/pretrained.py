"""The committed neural-transport surrogate (port of the transport part of
``scpn_fusion_tpu/models/surrogates/pretrained.py``).

``weights/neural_transport.npz`` (an MLP 7 -> 64 -> 64 -> 3 with its input and
output normalisation) maps the local dimensionless inputs [R/L_Ti, R/L_Te,
R/L_ne, q, s_hat, Te/Ti, nu_star] to [chi_i, chi_e, D_e] in gyro-Bohm units.
Loading is fail-closed as in the JAX package: the sha256 of the NPZ must
equal the one in ``weights/neural_transport.metrics.json``, or nothing loads.
Training (``train_transport_surrogate``) stays with the JAX package.
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


def load_transport_surrogate_pytree(
    name: str = "neural_transport",
    weights_dir: Path | None = None,
    *,
    device: torch.device | str = "cuda",
) -> tuple[TransportSurrogate, dict]:
    """Fail-closed load of the artifact as a :class:`TransportSurrogate` on
    ``device``; returns it and the metrics."""
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
        arrays = {k: np.asarray(data[k]) for k in data.files}
    n_layers = sum(1 for k in arrays if k.startswith("w"))

    def t(a, dtype=None):
        return torch.from_numpy(np.array(a, dtype=dtype)).to(device)

    params = MLPParams(weights=tuple(t(arrays[f"w{i}"]) for i in range(n_layers)),
                       biases=tuple(t(arrays[f"b{i}"]) for i in range(n_layers)))
    surrogate = TransportSurrogate(
        params=params,
        **{k: t(arrays[k], np.float32) for k in ("x_mean", "x_std", "y_mean", "y_std")})
    return surrogate, metrics
