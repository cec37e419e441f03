"""The array functions the carried-over ``io/imas_ids.py`` and
``models/gyrokinetics/tglf_benchmark.py`` call, in torch.

``core_profiles_to_transport_state`` and the benchmark's
``case_to_closure_inputs`` are the JAX package's text with ``jnp`` bound to
``on(device)``: ``asarray(x, dtype)``, ``zeros_like``, ``ones_like``
and ``float32`` keep their meaning and make tensors on ``device``, so the
readers return tensors where the caller asked (the card by default, as JAX puts them on its default device).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch


def on(device: torch.device | str) -> SimpleNamespace:
    """``jnp``'s ``asarray``, ``zeros_like``, ``ones_like`` and ``float32``,
    with ``asarray`` making tensors on ``device``."""

    def asarray(x, dtype: torch.dtype | None = None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return SimpleNamespace(asarray=asarray, zeros_like=torch.zeros_like,
                           ones_like=torch.ones_like, float32=torch.float32)
