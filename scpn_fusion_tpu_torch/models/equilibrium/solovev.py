"""Solov'ev analytic Grad-Shafranov equilibria (port of
``scpn_fusion_tpu/models/equilibrium/solovev.py``; exact-solution parity lane).

For constant profile gradients ``p'(psi) = const`` and ``FF'(psi) = const``
the GS equation ``Delta* psi = -mu0 R^2 p' - FF'`` has exact polynomial
solutions.  With the operator ``Delta* = d_RR - (1/R) d_R + d_ZZ``:

    Delta*(R^4) = 8 R^2,  Delta*(R^2 Z^2) = 2 R^2,  Delta*(Z^2) = 2,
    Delta*(R^2) = Delta*(1) = 0   (homogeneous)

so ``psi = a R^4 + b R^2 Z^2 + e Z^2 + c R^2 + d`` solves
``Delta* psi = (8a + 2b) R^2 + 2e`` exactly.  This module provides the
family and its exact source, used by the analytic parity gates
(the reference's manufactured-source Solov'ev lane,
``validation/benchmark_vs_freegs.py:189-332`` / RESULTS.md
"Manufactured-Source Equilibrium Parity"): solver output must converge to
the analytic psi at O(h^2) with grid refinement.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SolovevParams:
    """psi = a R^4 + b R^2 Z^2 + e Z^2 + c R^2 + d."""

    a: float = -0.00625
    b: float = -0.025
    e: float = 0.3
    c: float = 0.5
    d: float = 0.0

    @property
    def source_r2_coeff(self) -> float:
        """Coefficient A in Delta* psi = A R^2 + B."""
        return 8.0 * self.a + 2.0 * self.b

    @property
    def source_const(self) -> float:
        """Coefficient B in Delta* psi = A R^2 + B."""
        return 2.0 * self.e

    def psi(self, rr: torch.Tensor, zz: torch.Tensor) -> torch.Tensor:
        return (self.a * rr**4 + self.b * rr**2 * zz**2
                + self.e * zz**2 + self.c * rr**2 + self.d)

    def source(self, rr: torch.Tensor) -> torch.Tensor:
        """Exact continuous Delta* psi."""
        return self.source_r2_coeff * rr**2 + self.source_const

    def p_prime(self, mu0: float = 1.0) -> float:
        """Constant p' implied by the source split (A = -mu0 p')."""
        return -self.source_r2_coeff / mu0

    def ff_prime(self) -> float:
        """Constant FF' implied by the source split (B = -FF')."""
        return -self.source_const
