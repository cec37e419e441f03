"""Neural equilibrium kernel: the O(1) surrogate as the in-loop plant
(port of ``scpn_fusion_tpu/control/neural_kernel.py``).

The PCA+MLP equilibrium surrogate (``models/surrogates/
equilibrium_surrogate.py``) replaces the Grad-Shafranov solve inside a
closed-loop shape controller: every control tick is one MLP, one PCA
product, a softmax axis locator and the PI update, a Python loop of ticks
where JAX runs one ``lax.scan``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def soft_axis_position(psi: torch.Tensor, r_1d: torch.Tensor, z_1d: torch.Tensor, *,
                       temperature=200.0):
    """Differentiable magnetic-axis locator: softmax-weighted (R, Z) of the
    flux map.  Sharp temperature => argmax within a cell."""
    span = torch.clamp(psi.max() - psi.min(), min=1e-30)
    scale = torch.div(torch.as_tensor(temperature, dtype=psi.dtype, device=psi.device), span)
    w = torch.softmax(scale * psi.reshape(-1), dim=0)
    zz, rr = torch.meshgrid(z_1d, r_1d, indexing="ij")
    return (w * rr.reshape(-1)).sum(), (w * zz.reshape(-1)).sum()


class NeuralShapeTrace(NamedTuple):
    axis_r: torch.Tensor          # (n_ticks,)
    axis_z: torch.Tensor
    currents: torch.Tensor        # (n_ticks, n_coils)
    err_r: torch.Tensor
    final_psi: torch.Tensor


def run_neural_shape_loop(surrogate, currents0: torch.Tensor, r_1d: torch.Tensor,
                          z_1d: torch.Tensor, *, target_r, steer: torch.Tensor,
                          n_ticks: int = 100, kp=4.0, ki=0.6,
                          current_limit=20.0) -> NeuralShapeTrace:
    """Closed-loop radial-position control with the surrogate as plant: PI
    on the axis-R error steering a coil-current direction; the per-tick cost
    is ``surrogate.predict`` (O(1)), not a GS solve."""
    dtype = currents0.dtype
    target_r = torch.as_tensor(target_r, dtype=dtype, device=currents0.device)
    currents = currents0
    integ = torch.zeros((), dtype=dtype, device=currents0.device)
    rows = []
    for _ in range(n_ticks):
        psi = surrogate.predict(currents)
        ax_r, ax_z = soft_axis_position(psi, r_1d, z_1d)
        err = (target_r - ax_r).to(dtype)
        integ = integ + err
        delta = kp * err + ki * integ
        currents = torch.clamp(currents + delta * steer, -current_limit, current_limit)
        rows.append((ax_r, ax_z, currents, err))
    ax_r, ax_z, cur, err = (torch.stack(col) for col in zip(*rows))
    return NeuralShapeTrace(ax_r, ax_z, cur, err, surrogate.predict(currents))
