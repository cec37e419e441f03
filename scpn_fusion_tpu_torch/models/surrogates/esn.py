"""Echo-state network (reservoir computing) oracle for chaotic forecasting
(port of ``scpn_fusion_tpu/models/surrogates/esn.py``).

A fixed random reservoir ``x' = tanh(W_in u + W_res x)`` harvested over a
training sequence, a ridge-regression readout and closed-loop
autoregressive prediction.  The sparse reservoir is a dense masked matrix,
its spectral radius normalised by a 200-step power iteration, as in JAX.

The draws rule: :func:`init_esn` draws from a ``torch.Generator``; its twin
:func:`_init_esn` takes ``w_in``, the unmasked ``w`` (both uniform in
[-1, 1)) and the mask's uniforms in [0, 1).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class ESNParams(NamedTuple):
    w_in: torch.Tensor    # (reservoir, input)
    w_res: torch.Tensor   # (reservoir, reservoir), spectral radius scaled


class ESNReadout(NamedTuple):
    w_out: torch.Tensor   # (output, reservoir)


def _spectral_radius(a: torch.Tensor, iters: int = 200) -> torch.Tensor:
    """Dominant |eigenvalue| by power iteration (deterministic start)."""
    v = torch.ones((a.shape[0],), dtype=a.dtype, device=a.device) / math.sqrt(a.shape[0])
    for _ in range(iters):
        w = a @ v
        v = w / torch.clamp(torch.linalg.vector_norm(w), min=1e-30)
    return torch.linalg.vector_norm(a @ v)


def init_esn(generator: torch.Generator, input_dim: int, reservoir_size: int = 500,
             spectral_radius: float = 0.95, density: float = 0.1, dtype=torch.float32,
             device: torch.device | str = "cuda") -> ESNParams:
    """Random input weights and a sparse-masked reservoir, drawn from
    ``generator``."""
    def uniform(*shape):
        return torch.rand(shape, generator=generator, dtype=dtype,
                          device=generator.device).to(device)

    w_in = 2.0 * uniform(reservoir_size, input_dim) - 1.0
    w = 2.0 * uniform(reservoir_size, reservoir_size) - 1.0
    mask_u = uniform(reservoir_size, reservoir_size)
    return _init_esn(w_in, w, mask_u, spectral_radius, density)


def _init_esn(w_in: torch.Tensor, w: torch.Tensor, mask_u: torch.Tensor,
              spectral_radius: float = 0.95, density: float = 0.1) -> ESNParams:
    """:func:`init_esn` on the given draws."""
    w = w * (mask_u < density).to(w.dtype)
    radius = _spectral_radius(w)
    w = torch.where(radius > 1e-12, w * (spectral_radius / radius), w)
    return ESNParams(w_in=w_in, w_res=w)


def harvest_states(params: ESNParams, inputs: torch.Tensor,
                   x0: torch.Tensor | None = None) -> torch.Tensor:
    """Run the reservoir over (T, input) rows; return (T, reservoir) states."""
    dtype = params.w_in.dtype
    inputs = inputs.to(dtype)
    x = (torch.zeros((params.w_in.shape[0],), dtype=dtype, device=params.w_in.device)
         if x0 is None else x0.to(dtype))
    states = []
    for u in inputs:
        x = torch.tanh(params.w_in @ u + params.w_res @ x)
        states.append(x)
    return torch.stack(states)


def train_readout(states: torch.Tensor, targets: torch.Tensor,
                  reg: float = 1e-4) -> ESNReadout:
    """Ridge readout: W_out (S^T S + reg I) = Y^T S."""
    n = states.shape[1]
    targets = targets.to(states.dtype)
    system = states.T @ states + reg * torch.eye(n, dtype=states.dtype, device=states.device)
    rhs = targets.T @ states
    return ESNReadout(w_out=torch.linalg.solve(system.T, rhs.T).T)


def fit_esn(params: ESNParams, inputs: torch.Tensor, targets: torch.Tensor,
            reg: float = 1e-4) -> tuple[ESNReadout, torch.Tensor]:
    """Harvest and train; returns the readout and the final reservoir state
    (the state to continue closed-loop prediction from)."""
    states = harvest_states(params, inputs)
    return train_readout(states, targets, reg), states[-1]


def predict_closed_loop(params: ESNParams, readout: ESNReadout, x: torch.Tensor,
                        u0: torch.Tensor, steps: int) -> torch.Tensor:
    """Autoregressive rollout feeding the predictions back: (steps, output)."""
    dtype = params.w_in.dtype
    x, u = x.to(dtype), u0.to(dtype)
    w_out = readout.w_out.to(dtype)
    preds = []
    for _ in range(steps):
        x = torch.tanh(params.w_in @ u + params.w_res @ x)
        u = w_out @ x
        preds.append(u)
    return torch.stack(preds)


def trust_horizon(truth: torch.Tensor, prediction: torch.Tensor,
                  threshold_frac: float = 0.5) -> tuple[torch.Tensor, torch.Tensor]:
    """Steps until the per-step MSE exceeds ``threshold_frac * var(truth)``:
    (horizon, mse); the horizon is len(mse) when it never does."""
    mse = torch.mean((truth - prediction) ** 2, dim=1)
    threshold = threshold_frac * torch.var(truth, correction=0)
    exceeded = mse > threshold
    # the first True (argmax returns the first of equal maxima), or len(mse)
    idx = torch.argmax(exceeded.to(torch.int32))
    horizon = torch.where(exceeded.any(), idx, torch.full_like(idx, mse.shape[0]))
    return horizon, mse
