"""Multi-regime FNO training data: one-step spectral evolution pairs (port of
``scpn_fusion_tpu/models/surrogates/fno_multi_regime.py``).

Training pairs spanning the SPARC ITG / TEM / ETG turbulence regimes, each
sample drawn from a regime's parameter box (drive ``alpha``, gradient
``kappa``, viscosity ``nu``, damping, spectral cutoff) and evolved one step
under the modified Hasegawa-Wakatani dispersion (``omega = alpha k_y /
(alpha + k^2)``, growth ``gamma = kappa k_y k^2/(alpha+k^2)^2 - nu k^4``)
with low-k forcing; the whole batch in one batched spectral program.  The
wavenumber grid is ``meshgrid(k, k)`` in ``"xy"`` order, as ``jnp.meshgrid``.

The draws rule: the public functions draw from a ``torch.Generator``; their
twins take the draws (:func:`_sample_regime_params` the (n, 5) uniforms,
:func:`_multi_regime_pairs` the regime indices, the uniforms and the three
normal fields, :func:`_train_fno_multi_regime` the pairs, the initial
parameters and the minibatch indices).
"""

from __future__ import annotations

import torch

from scpn_fusion_tpu_torch.models.surrogates.fno import (
    FNOParams,
    _train_fno,
    fno_apply_batched,
    init_fno,
)

# Regime parameter boxes: (alpha, kappa, nu, damp, k_cut) bounds a regime.
SPARC_REGIMES = {
    "itg": {"alpha": (0.5, 2.0), "kappa": (0.5, 3.0), "nu": (0.005, 0.05),
            "damp": (0.05, 0.15), "k_cut": (4.0, 8.0)},
    "tem": {"alpha": (1.0, 2.5), "kappa": (1.5, 6.0), "nu": (0.01, 0.08),
            "damp": (0.10, 0.20), "k_cut": (6.0, 12.0)},
    "etg": {"alpha": (1.0, 3.0), "kappa": (3.0, 12.0), "nu": (0.01, 0.1),
            "damp": (0.15, 0.30), "k_cut": (10.0, 20.0)},
}
REGIME_NAMES = tuple(SPARC_REGIMES.keys())
_PARAM_KEYS = ("alpha", "kappa", "nu", "damp", "k_cut")


def _sample_regime_params(u: torch.Tensor, regime_idx: torch.Tensor) -> dict[str, torch.Tensor]:
    """:func:`sample_regime_params` on the given (n, 5) uniforms in [0, 1)."""
    lo = torch.tensor([[SPARC_REGIMES[r][k][0] for k in _PARAM_KEYS] for r in REGIME_NAMES],
                      dtype=u.dtype, device=u.device)
    hi = torch.tensor([[SPARC_REGIMES[r][k][1] for k in _PARAM_KEYS] for r in REGIME_NAMES],
                      dtype=u.dtype, device=u.device)
    vals = lo[regime_idx] + u * (hi[regime_idx] - lo[regime_idx])
    return {k: vals[:, i] for i, k in enumerate(_PARAM_KEYS)}


def sample_regime_params(generator: torch.Generator, regime_idx: torch.Tensor, *,
                         dtype=torch.float32) -> dict[str, torch.Tensor]:
    """A parameter vector a sample from its regime's box (batched)."""
    u = torch.rand((regime_idx.shape[0], len(_PARAM_KEYS)), generator=generator, dtype=dtype,
                   device=generator.device).to(regime_idx.device)
    return _sample_regime_params(u, regime_idx)


def generate_multi_regime_pairs(generator: torch.Generator, *, n_samples: int, grid_size: int,
                                regime_probs: tuple[float, float, float] = (1 / 3, 1 / 3, 1 / 3),
                                dt: float = 0.01, dtype=torch.float32,
                                device: torch.device | str = "cuda"):
    """``(x, y, regime_idx)`` with ``x, y`` of shape (n_samples, grid, grid) in
    ``dtype`` on ``device``: the full batch in one spectral program."""
    probs = torch.tensor(regime_probs, dtype=torch.float64) / sum(regime_probs)
    regime_idx = torch.multinomial(probs, n_samples, replacement=True, generator=generator)

    def draw(fn, shape):
        return fn(shape, generator=generator, dtype=dtype, device=generator.device).to(device)

    u = draw(torch.rand, (n_samples, len(_PARAM_KEYS)))
    shape = (n_samples, grid_size, grid_size)
    field, f_re, f_im = draw(torch.randn, shape), draw(torch.randn, shape), draw(torch.randn, shape)
    return _multi_regime_pairs(regime_idx.to(device), u, field, f_re, f_im, dt=dt)


def _fftfreq_times_n(n: int, dtype, device) -> torch.Tensor:
    """``fftfreq(n) * n``: the integer wavenumbers 0, 1, ..., -1."""
    return torch.fft.fftfreq(n, dtype=dtype, device=device) * n


def _multi_regime_pairs(regime_idx: torch.Tensor, u: torch.Tensor, field_noise: torch.Tensor,
                        forcing_re: torch.Tensor, forcing_im: torch.Tensor, *, dt: float = 0.01):
    """:func:`generate_multi_regime_pairs` on the given draws: the regime
    indices (n,), the (n, 5) uniforms and the three standard-normal
    (n, grid, grid) fields (the initial field, the forcing's real and
    imaginary parts)."""
    params = _sample_regime_params(u, regime_idx)
    alpha, kappa, nu, damp, k_cut = (params[k][:, None, None] for k in _PARAM_KEYS)
    grid_size = field_noise.shape[-1]

    k1 = _fftfreq_times_n(grid_size, u.dtype, u.device)
    kx, ky = torch.meshgrid(k1, k1, indexing="xy")
    k2 = (kx**2 + ky**2)[None, :, :]
    k4 = k2**2
    k2_safe = k2.clone()
    k2_safe[:, 0, 0] = 1.0

    denom = alpha + k2_safe
    omega = alpha * ky[None] / denom
    growth = kappa * ky[None] * k2 / denom**2 - nu * k4
    spectral_filter = torch.exp(-((k2 / k_cut**2) ** 2))
    phase_shift = torch.exp(-1j * omega * dt)
    amplitude = torch.exp(growth * dt) * spectral_filter * (1.0 - damp)
    mask_low_k = (k2 < (k_cut * 0.5) ** 2).to(spectral_filter.dtype)

    field = 0.1 * field_noise
    field_k = torch.fft.fft2(field) * spectral_filter

    forcing = torch.complex(forcing_re, forcing_im)
    forcing_k = torch.fft.fft2(forcing) * mask_low_k * kappa * 0.5

    next_k = field_k * phase_shift * amplitude + forcing_k * dt
    x = torch.fft.ifft2(field_k).real
    y = torch.fft.ifft2(next_k).real
    return x, y, regime_idx


def train_fno_multi_regime(generator: torch.Generator, *, n_samples: int = 256,
                           grid_size: int = 32, modes: int = 8, width: int = 16,
                           n_layers: int = 3, n_steps: int = 600, lr: float = 2e-3,
                           dtype=torch.float32, device: torch.device | str = "cuda"):
    """Train the shared FNO backbone on multi-regime one-step pairs (the
    pairs in ``dtype``, the FNO in float32; batches of 8).  Returns
    ``(params, val_rel_l2, regime_idx)``."""
    x, y, regime_idx = generate_multi_regime_pairs(
        generator, n_samples=n_samples, grid_size=grid_size, dtype=dtype, device=device)
    xv, yv, _ = generate_multi_regime_pairs(
        generator, n_samples=max(n_samples // 4, 8), grid_size=grid_size, dtype=dtype,
        device=device)
    params = init_fno(generator, width=width, modes=modes, n_layers=n_layers, device=device)
    idx = torch.randint(0, n_samples, (n_steps, 8), generator=generator,
                        device=generator.device).to(device)
    params, val = _train_fno_multi_regime(x, y, xv, yv, params, idx, lr=lr)
    return params, val, regime_idx


def _train_fno_multi_regime(x: torch.Tensor, y: torch.Tensor, xv: torch.Tensor,
                            yv: torch.Tensor, params: FNOParams, batch_idx: torch.Tensor, *,
                            lr: float = 2e-3) -> tuple[FNOParams, float]:
    """:func:`train_fno_multi_regime` on the given training and validation
    pairs, initial parameters and (n_steps, 8) minibatch indices: (params,
    val_rel_l2)."""
    scale = torch.clamp(y.std(correction=0), min=1e-9)
    x_b = (x / scale)[..., None].to(torch.float32)
    y_b = (y / scale)[..., None].to(torch.float32)
    result = _train_fno(params, x_b, y_b, batch_idx, lr=lr)
    pred = fno_apply_batched(result.params, (xv / scale)[..., None].to(torch.float32))
    yv_b = (yv / scale)[..., None].to(torch.float32)
    num = torch.sqrt(((pred - yv_b) ** 2).sum(dim=(1, 2, 3)))
    den = torch.clamp(torch.sqrt((yv_b**2).sum(dim=(1, 2, 3))), min=1e-12)
    return result.params, float((num / den).mean())
