"""Order statistics without ``torch.quantile``'s size limit, and JAX's median.

``torch.quantile`` refuses an input of more than 2^24 elements, and it
interpolates with ``torch.lerp``, which rounds otherwise than
``jnp.percentile``.  :func:`percentile` sorts once and interpolates linearly
as ``jnp.percentile`` does (``method="linear"``): with ``h = q/100 (n-1)``,
the result is ``v[floor h] (1 - w) + v[ceil h] w``, ``w = h - floor h``.  The
position and the weights are float64 and so is the interpolation, as in JAX
with x64 on (its ``q`` is float64 there); the result has the input's type.
A NaN anywhere along the reduced axis makes that result NaN, as in JAX.
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import torch


def percentile(x: torch.Tensor, q: float | Sequence[float], dim: int | None = None
               ) -> torch.Tensor:
    """The ``q``-th percentiles of ``x`` along ``dim`` (all of ``x`` when
    ``dim`` is None).  ``q`` a number gives the reduced shape; a sequence of
    ``m`` numbers puts a leading axis of ``m`` in front of it."""
    if dim is None:
        x, dim = x.reshape(-1), 0
    dim = dim % x.dim()
    n = x.shape[dim]
    if n == 0:
        raise ValueError("percentile of an empty axis")
    values = torch.sort(x, dim=dim).values
    has_nan = torch.isnan(x).any(dim=dim)
    qs = [float(q)] if isinstance(q, (int, float)) else [float(v) for v in q]
    out = []
    for qv in qs:
        h = (qv / 100.0) * (n - 1)
        lo, hi = math.floor(h), math.ceil(h)
        w_hi = h - lo
        w_lo = 1.0 - w_hi
        lo, hi = min(max(lo, 0), n - 1), min(max(hi, 0), n - 1)
        v_lo = values.select(dim, lo).to(torch.float64)
        v_hi = values.select(dim, hi).to(torch.float64)
        res = (v_lo * w_lo + v_hi * w_hi).to(x.dtype)
        out.append(torch.where(has_nan, torch.full_like(res, math.nan), res))
    return out[0] if isinstance(q, (int, float)) else torch.stack(out)


def median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` of all of ``x``: the sorted middle pair's sum times
    one half (``method="midpoint"``; an odd count's middle value twice,
    which gives that value), where ``torch.median`` returns the lower of an
    even count's pair.  A NaN anywhere makes it NaN, as in JAX."""
    v = torch.sort(x.reshape(-1)).values
    n = v.shape[0]
    if n == 0:
        raise ValueError("median of an empty tensor")
    res = (v[(n - 1) // 2] + v[n // 2]) * 0.5
    return torch.where(torch.isnan(x).any(), torch.full_like(res, math.nan), res)
