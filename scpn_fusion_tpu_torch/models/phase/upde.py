"""Multi-layer UPDE (unified phase-dynamics equation) system (port of
``scpn_fusion_tpu/models/phase/upde.py``).

L plasma-process layers of Kuramoto oscillators coupled through an (L, L)
matrix K (source row -> target column) with Sakaguchi lags alpha, per-layer
global-driver gains zeta, and PAC gating that boosts inter-layer coupling
from incoherent sources.  Layers live in a dense padded (L, n) array with a
validity mask, so one tick is:

    z_m   = masked mean of e^{i theta}  per layer
    w     = gain * (1 + gamma (1 - R_n)(1 - delta_nm)) * K * R_n
    S_m, C_m = sum_n w[n, m] sin / cos(Psi_n - alpha[n, m])
    dtheta = omega + S_m cos(theta) - C_m sin(theta) + zeta_m sin(Psi - theta)

Every sum over oscillators is a fixed halving tree (:func:`tree_sum`: the
axis padded with zeros to a power of two, then its halves added until one
value is left); a sum over layers is the same tree over the layers' sums;
the coupling sums run over the sources in index order.  That is the order
of row U (``csrc/phase.cu``), which runs a whole trajectory in ONE launch:
on a CUDA tensor :func:`run_upde` goes there (``ops/cuda_phase.upde_run``),
on a CPU tensor it is the loop of :func:`upde_tick` (the kernel's plain
twin).  JAX sums in XLA's order, so the port agrees with it to rounding.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.models.phase.kuramoto import lyapunov_exponent, wrap_phase


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as a halving tree: padded with zeros to a
    power of two, then ``x[..., :h] + x[..., h:]`` until one value is left."""
    n = x.shape[-1]
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        x = torch.cat([x, x.new_zeros(*x.shape[:-1], p - n)], dim=-1)
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _order(c_sum: torch.Tensor, s_sum: torch.Tensor, counts: torch.Tensor):
    zr = c_sum / counts
    zi = s_sum / counts
    return torch.sqrt(zr * zr + zi * zi), torch.atan2(zi, zr)


def _counts(mask: torch.Tensor):
    """(per-layer counts, total), each floored at 1e-15 after the tree."""
    per_layer = tree_sum(mask)
    return torch.clamp(per_layer, min=1e-15), torch.clamp(tree_sum(per_layer), min=1e-15)


def _layer_sums(theta: torch.Tensor, mask: torch.Tensor):
    return tree_sum(torch.cos(theta) * mask), tree_sum(torch.sin(theta) * mask)


def layer_order_parameters(theta: torch.Tensor, mask: torch.Tensor):
    """Per-layer (R_m, Psi_m) for padded (L, n) phases with validity mask."""
    return _order(*_layer_sums(theta, mask), _counts(mask)[0])


def global_order_parameter(theta: torch.Tensor, mask: torch.Tensor):
    c_sum, s_sum = _layer_sums(theta, mask)
    return _order(tree_sum(c_sum), tree_sum(s_sum), _counts(mask)[1])


def mean_field_psi(r_m: torch.Tensor, psi_m: torch.Tensor) -> torch.Tensor:
    """The global mean-field phase from the layer order parameters."""
    return torch.atan2(tree_sum(r_m * torch.sin(psi_m)), tree_sum(r_m * torch.cos(psi_m)))


def _tick(theta, omega, mask, k_matrix, alpha, zeta, *, dt, psi_global, actuation_gain,
          pac_gamma, wrap, counts, total, layer):
    """One tick from the layer sums ``layer`` = (cos sum, sin sum) of
    ``theta``: (theta1, aux, the unmasked sum of 1 - cos(theta1 - Psi) over
    every oscillator, the monitor guard's V times the count)."""
    c_sum, s_sum = layer
    r_m, psi_m = _order(c_sum, s_sum, counts)
    r_glob, psi_r_glob = _order(tree_sum(c_sum), tree_sum(s_sum), total)

    # Coupling weight from source n to target m, with PAC gate on
    # inter-layer terms: (1 + gamma (1 - R_n)) for n != m.
    el = torch.eye(k_matrix.shape[0], dtype=theta.dtype, device=theta.device)
    gate = 1.0 + pac_gamma * (1.0 - r_m)[:, None] * (1.0 - el)
    w = actuation_gain * gate * k_matrix * r_m[:, None]    # (L_src, L_tgt)
    beta = psi_m[:, None] - alpha
    ts, tc = w * torch.sin(beta), w * torch.cos(beta)
    s_m, c_m = ts[0], tc[0]
    for src in range(1, ts.shape[0]):     # over the sources in index order
        s_m = s_m + ts[src]
        c_m = c_m + tc[src]

    dtheta = (omega
              + s_m[:, None] * torch.cos(theta)
              - c_m[:, None] * torch.sin(theta)
              + zeta[:, None] * torch.sin(psi_global - theta))
    theta1 = theta + dt * dtheta
    if wrap:
        theta1 = wrap_phase(theta1)
    theta1 = torch.where(mask > 0, theta1, 0.0)

    v_terms = 1.0 - torch.cos(theta1 - psi_global)
    v_sum = tree_sum(v_terms * mask)
    aux = {"R_layer": r_m, "Psi_layer": psi_m, "R_global": r_glob, "Psi_r_global": psi_r_glob,
           "V_layer": v_sum / counts, "V_global": tree_sum(v_sum) / total, "dtheta": dtheta}
    return theta1, aux, tree_sum(tree_sum(v_terms))


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def upde_tick(theta, omega, mask, k_matrix, alpha, zeta, *, dt, psi_global,
              actuation_gain=1.0, pac_gamma=0.0, wrap: bool = True):
    """One Euler tick of all layers; returns (theta1, aux)."""
    counts, total = _counts(mask)
    theta1, aux, _ = _tick(theta, omega, mask, k_matrix, alpha, zeta, dt=dt,
                           psi_global=_scalar(psi_global, theta), actuation_gain=actuation_gain,
                           pac_gamma=pac_gamma, wrap=wrap, counts=counts, total=total,
                           layer=_layer_sums(theta, mask))
    return theta1, aux


class UPDETrace(NamedTuple):
    theta: torch.Tensor        # (T, L, n)
    r_layer: torch.Tensor      # (T, L)
    r_global: torch.Tensor     # (T,)
    v_layer: torch.Tensor      # (T, L)
    v_global: torch.Tensor     # (T,)
    lambda_exp: torch.Tensor   # scalar: global Lyapunov exponent


def upde_steps(theta0, omega, mask, k_matrix, alpha, zeta, *, dt, psi_external=0.0,
               psi_mode: str = "external", actuation_gain=1.0, pac_gamma=0.0,
               n_steps: int = 1000, wrap: bool = True):
    """The tick loop of :func:`run_upde` in plain ops (row U's twin):
    (thetas, r_layer, r_global, v_layer, v_global), stacked over the ticks."""
    if psi_mode not in ("external", "mean_field"):
        raise ValueError(f"unknown psi mode {psi_mode!r}")
    counts, total = _counts(mask)
    theta, rows = theta0, []
    for _ in range(n_steps):
        layer = _layer_sums(theta, mask)
        if psi_mode == "external":
            psi = _scalar(psi_external, theta)
        else:   # global mean field from layer order parameters
            psi = mean_field_psi(*_order(*layer, counts))
        theta, aux, _ = _tick(theta, omega, mask, k_matrix, alpha, zeta, dt=dt, psi_global=psi,
                              actuation_gain=actuation_gain, pac_gamma=pac_gamma, wrap=wrap,
                              counts=counts, total=total, layer=layer)
        rows.append((theta, aux["R_layer"], aux["R_global"], aux["V_layer"], aux["V_global"]))
    return tuple(torch.stack(col) for col in zip(*rows))


def run_upde(theta0, omega, mask, k_matrix, alpha, zeta, *, dt, psi_external=0.0,
             psi_mode: str = "external", actuation_gain=1.0, pac_gamma=0.0,
             n_steps: int = 1000, wrap: bool = True) -> UPDETrace:
    """Whole multi-layer trajectory (reference ``run`` / ``run_lyapunov``):
    one launch of row U on a CUDA tensor, :func:`upde_steps` on a CPU one."""
    from scpn_fusion_tpu_torch.ops.cuda_phase import upde_run

    thetas, r_l, r_g, v_l, v_g = upde_run(
        theta0, omega, mask, k_matrix, alpha, zeta, dt=dt, psi_external=psi_external,
        psi_mode=psi_mode, actuation_gain=actuation_gain, pac_gamma=pac_gamma,
        n_steps=n_steps, wrap=wrap)
    return UPDETrace(thetas, r_l, r_g, v_l, v_g, lyapunov_exponent(v_g, dt))
