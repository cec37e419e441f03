"""The surrogates' MLP and its Adam training loop (port of
``scpn_fusion_tpu/models/surrogates/mlp.py``).

Hidden layers take the tanh form of GELU (``jax.nn.gelu``'s default), the
head is linear, in the weights' dtype (float32 for the committed
artifacts).  Each layer is one ``addmm``, as JAX's ``h @ w + b``: its sums
run in an order of the backend's choosing, so the card, the CPU and JAX
agree to float32 rounding, not bit for bit.

Training is optax's Adam written out (``control/mpc._adam_update``) over a
Python loop of minibatch steps, where JAX runs one ``lax.scan``.  The draws
rule: :func:`init_mlp` and :func:`train_mlp` draw from a ``torch.Generator``
(He normals; the minibatch indices of every step); :func:`_train_mlp` takes
the indices as a tensor, so a test can feed it JAX's
``randint(fold_in(key, k), (batch,), 0, n)``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F


class MLPParams(NamedTuple):
    weights: tuple
    biases: tuple


class TrainResult(NamedTuple):
    params: MLPParams
    loss_history: torch.Tensor


def init_mlp(generator: torch.Generator, sizes: Sequence[int], dtype=torch.float32,
             device: torch.device | str = "cuda") -> MLPParams:
    """He-initialised MLP with the given layer sizes, the normals drawn from
    ``generator`` (which must live on ``device``'s type, or on the CPU)."""
    ws, bs = [], []
    for i in range(len(sizes) - 1):
        normal = torch.randn((sizes[i], sizes[i + 1]), generator=generator, dtype=dtype,
                             device=generator.device).to(device)
        ws.append(math.sqrt(2.0 / sizes[i]) * normal)
        bs.append(torch.zeros((sizes[i + 1],), dtype=dtype, device=device))
    return MLPParams(tuple(ws), tuple(bs))


def mlp_apply(params: MLPParams, x: torch.Tensor) -> torch.Tensor:
    """Forward pass of an (n, in) batch (GELU hidden activations, linear head),
    in the promoted dtype of the input and the weights, as JAX's ``h @ w``."""
    h = x
    n = len(params.weights)
    for i, (w, b) in enumerate(zip(params.weights, params.biases)):
        dt = torch.promote_types(h.dtype, w.dtype)
        h = torch.addmm(b.to(dt), h.to(dt), w.to(dt))
        if i < n - 1:
            h = F.gelu(h, approximate="tanh")
    return h


def leaves(params: MLPParams) -> list:
    """The parameters in ``jax.tree.leaves`` order: the weights, then the biases."""
    return [*params.weights, *params.biases]


def from_leaves(flat, n_layers: int) -> MLPParams:
    return MLPParams(tuple(flat[:n_layers]), tuple(flat[n_layers:]))


def batch_indices(generator: torch.Generator, n_steps: int, batch_size: int, n: int,
                  device) -> torch.Tensor:
    """(n_steps, batch_size) uniform minibatch indices in [0, n)."""
    return torch.randint(0, n, (n_steps, batch_size), generator=generator,
                         device=generator.device).to(device)


def train_mlp(params: MLPParams, x: torch.Tensor, y: torch.Tensor,
              generator: torch.Generator, *, n_steps: int = 2000, batch_size: int = 256,
              lr: float = 1e-3) -> TrainResult:
    """Full MSE training run: ``n_steps`` Adam steps on minibatches drawn
    from ``generator``."""
    idx = batch_indices(generator, n_steps, batch_size, x.shape[0], x.device)
    return _train_mlp(params, x, y, idx, lr=lr)


def _train_mlp(params: MLPParams, x: torch.Tensor, y: torch.Tensor, batch_idx: torch.Tensor,
               *, lr: float = 1e-3) -> TrainResult:
    """:func:`train_mlp` with the minibatch indices given, (n_steps, batch)."""
    from scpn_fusion_tpu_torch.control.mpc import _adam_update

    n_layers = len(params.weights)
    flat = [p.detach() for p in leaves(params)]
    mu = [torch.zeros_like(p) for p in flat]
    nu = [torch.zeros_like(p) for p in flat]
    losses = []
    for k in range(batch_idx.shape[0]):
        idx = batch_idx[k]
        xb, yb = x[idx], y[idx]
        live = [p.requires_grad_(True) for p in flat]
        loss = ((mlp_apply(from_leaves(live, n_layers), xb) - yb) ** 2).mean()
        grads = torch.autograd.grad(loss, live)
        new = []
        for i, (p, g) in enumerate(zip(flat, grads)):
            upd, mu[i], nu[i], _ = _adam_update(g, mu[i], nu[i], k, lr)
            new.append(p.detach() + upd)
        flat = new
        losses.append(loss.detach())
    return TrainResult(from_leaves(flat, n_layers), torch.stack(losses))
