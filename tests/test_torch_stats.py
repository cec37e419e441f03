"""Port parity: the sort-based percentile (``core/stats.percentile``)
against ``jnp.percentile``'s linear interpolation, on seeded data of both
float types, along an axis and over everything, with ties and a NaN, and on
one input of more than 2^24 elements (``torch.quantile`` refuses those).
The port interpolates in float64 with the weight ``q/100 (n-1)``; compiled
XLA turns ``q / 100`` into a product with 0.01 and may fuse the
interpolation into an FMA, so its weight can differ in the last bits: the
bar is 1e-12 of the data's span, plus 2 ulp of the input's type."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rng

from scpn_fusion_tpu_torch.core.stats import percentile

QS = (0.0, 1.0, 33.3, 50.0, 95.0, 99.0, 100.0)


def _ulps(ours, ref, span=1.0) -> bool:
    ours, ref = np.asarray(ours), np.asarray(ref)
    eps = np.finfo(ref.dtype).eps
    bar = 1e-12 * span + 2 * eps * np.abs(ref)
    return bool(np.all(np.abs(ours.astype(np.float64) - ref) <= bar))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(1,), (7,), (250,), (4, 1001)])
def test_matches_jnp_percentile(dtype, shape):
    x = rng(len(shape) + shape[-1]).standard_normal(shape).astype(dtype)
    x.reshape(-1)[::5] = 0.25          # ties
    t = torch.from_numpy(x)
    span = float(x.max() - x.min())
    for q in QS:
        ref = np.asarray(jnp.percentile(jnp.asarray(x), q))
        ours = percentile(t, q)
        assert ours.dtype == t.dtype and ours.shape == ()
        assert _ulps(ours.numpy(), ref, span), (q, ours.item(), ref.item())
        ref_ax = np.asarray(jnp.percentile(jnp.asarray(x), q, axis=-1))
        assert _ulps(percentile(t, q, dim=-1).numpy(), ref_ax, span)
    both = percentile(t, (50.0, 95.0))
    assert both.shape == (2,) and both[1].item() == percentile(t, 95.0).item()


def test_nan_propagates_along_its_row():
    x = rng(3).standard_normal((3, 20))
    x[1, 4] = np.nan
    ref = np.asarray(jnp.percentile(jnp.asarray(x), 90.0, axis=1))
    ours = percentile(torch.from_numpy(x), 90.0, dim=1).numpy()
    assert np.isnan(ours[1]) and np.isnan(ref[1])
    assert _ulps(ours[[0, 2]], ref[[0, 2]], float(np.nanmax(x) - np.nanmin(x)))


def test_more_than_2_to_the_24_elements():
    n = (1 << 24) + 3
    x = rng(11).random(n, dtype=np.float32)
    t = torch.from_numpy(x)
    ref = np.asarray(jnp.percentile(jnp.asarray(x), jnp.asarray([50.0, 99.0])))
    assert _ulps(percentile(t, (50.0, 99.0)).numpy(), ref)
