"""Neural equilibrium surrogate: O(1) psi prediction from scalar inputs
(port of the forward pass of
``scpn_fusion_tpu/models/surrogates/equilibrium_surrogate.py``).

A PCA basis + an MLP on the coefficients + input/output standardisation:
one MLP and one product per prediction.  The committed artifact loads with
``pretrained.load_equilibrium_artifact``; ``pretrained.train_equilibrium_artifact``
trains one on the port's own free-boundary solves.

The draws rule: :func:`train_equilibrium_surrogate` draws the He
initialisation and the minibatch indices from a ``torch.Generator``; its
twin :func:`_train_equilibrium_surrogate` takes the PCA basis, the initial
parameters and the indices (SVD signs are arbitrary, so a test hands it
JAX's basis).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.models.surrogates.mlp import (
    MLPParams,
    _train_mlp,
    batch_indices,
    init_mlp,
    mlp_apply,
)


class EquilibriumSurrogate(NamedTuple):
    """PCA basis + MLP coefficients + input/output standardisation."""

    mlp: MLPParams
    components: torch.Tensor   # (n_modes, NZ*NR)
    psi_mean: torch.Tensor     # (NZ*NR,)
    x_mean: torch.Tensor
    x_std: torch.Tensor
    coeff_scale: torch.Tensor  # (n_modes,)
    shape: tuple

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """x: (n_inputs,) -> psi (NZ, NR). O(1) — one MLP + one matmul."""
        xn = (x - self.x_mean) / self.x_std
        coeffs = mlp_apply(self.mlp, xn[None, :])[0] * self.coeff_scale
        psi_flat = self.psi_mean + coeffs @ self.components
        return psi_flat.reshape(self.shape)


def _pca(psi_batch: torch.Tensor, n_modes: int):
    """Truncated PCA via SVD: psi_batch (N, D) -> (components, mean); each
    component's sign is the SVD's."""
    mean = psi_batch.mean(dim=0)
    _, _, vt = torch.linalg.svd(psi_batch - mean, full_matrices=False)
    return vt[:n_modes], mean


def train_equilibrium_surrogate(inputs: torch.Tensor, psi_maps: torch.Tensor,
                                generator: torch.Generator, *, n_modes: int = 16,
                                hidden: tuple = (64, 64), n_steps: int = 3000,
                                lr: float = 1e-3) -> EquilibriumSurrogate:
    """Fit PCA + MLP on (N, n_inputs) inputs (e.g. coil currents) and their
    (N, NZ, NR) solved equilibria, on their device; the MLP in the inputs'
    dtype, minibatches of min(256, N)."""
    n, nz, nr = psi_maps.shape
    components, psi_mean = _pca(psi_maps.reshape(n, nz * nr), n_modes)
    params0 = init_mlp(generator, (inputs.shape[1], *hidden, n_modes), dtype=inputs.dtype,
                       device=inputs.device)
    idx = batch_indices(generator, n_steps, min(256, n), n, inputs.device)
    return _train_equilibrium_surrogate(components, psi_mean, inputs, psi_maps, params0, idx,
                                        lr=lr)


def _train_equilibrium_surrogate(components: torch.Tensor, psi_mean: torch.Tensor,
                                 inputs: torch.Tensor, psi_maps: torch.Tensor,
                                 params0: MLPParams, batch_idx: torch.Tensor, *,
                                 lr: float = 1e-3) -> EquilibriumSurrogate:
    """:func:`train_equilibrium_surrogate` on the given PCA basis and mean,
    initial parameters and (n_steps, batch) minibatch indices."""
    n, nz, nr = psi_maps.shape
    coeffs = (psi_maps.reshape(n, nz * nr) - psi_mean) @ components.T    # (N, n_modes)
    coeff_scale = torch.clamp(coeffs.std(dim=0, correction=0), min=1e-12)
    x_mean = inputs.mean(dim=0)
    x_std = torch.clamp(inputs.std(dim=0, correction=0), min=1e-12)
    result = _train_mlp(params0, (inputs - x_mean) / x_std, coeffs / coeff_scale, batch_idx,
                        lr=lr)
    return EquilibriumSurrogate(mlp=result.params, components=components, psi_mean=psi_mean,
                                x_mean=x_mean, x_std=x_std, coeff_scale=coeff_scale,
                                shape=(nz, nr))
