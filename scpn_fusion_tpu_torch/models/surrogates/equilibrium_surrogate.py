"""Neural equilibrium surrogate: O(1) psi prediction from scalar inputs
(port of the forward pass of
``scpn_fusion_tpu/models/surrogates/equilibrium_surrogate.py``).

A PCA basis + an MLP on the coefficients + input/output standardisation:
one MLP and one product per prediction.  The committed artifact loads with
``pretrained.load_equilibrium_artifact``; training stays with the JAX
package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.models.surrogates.mlp import MLPParams, mlp_apply


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
