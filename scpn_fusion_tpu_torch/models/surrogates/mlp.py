"""The surrogates' MLP forward pass (port of ``mlp_apply`` and ``MLPParams``
of ``scpn_fusion_tpu/models/surrogates/mlp.py``; training is not ported).

Hidden layers take the tanh form of GELU (``jax.nn.gelu``'s default), the
head is linear, in the weights' dtype (float32 for the committed
artifacts).  Each layer is one ``addmm``, as JAX's ``h @ w + b``: its sums
run in an order of the backend's choosing, so the card, the CPU and JAX
agree to float32 rounding, not bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class MLPParams(NamedTuple):
    weights: tuple
    biases: tuple


def mlp_apply(params: MLPParams, x: torch.Tensor) -> torch.Tensor:
    """Forward pass of an (n, in) batch (GELU hidden activations, linear head)."""
    h = x
    n = len(params.weights)
    for i, (w, b) in enumerate(zip(params.weights, params.biases)):
        h = torch.addmm(b, h, w)
        if i < n - 1:
            h = F.gelu(h, approximate="tanh")
    return h
