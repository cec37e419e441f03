"""Spectral turbulence generator and suppression controller closed loop (port
of ``scpn_fusion_tpu/models/surrogates/turbulence_suppressor.py``).

A Fourier-space drift-wave turbulence generator with predator-prey
zonal-flow coupling, a suppression controller (the reduced-order
field-statistics backend, or an FNO surrogate through ``fno.py``) and the
seeded closed loop, differentiable in the controller's gain by autograd.
The wavenumber grid is ``meshgrid(k, k)`` in ``"xy"`` order, as
``jnp.meshgrid``.

The draws rule: the state carries a ``torch.Generator`` (or None) where JAX
carries a key.  :func:`init_turbulence`, :func:`turbulence_step` and
:func:`run_suppression_loop` draw from it; their twins take the draws
(:func:`_init_turbulence` the initial normal field, :func:`_turbulence_step`
the step's two forcing normals, :func:`_run_suppression_loop` the initial
field and the (n_steps, 2, N, N) forcing normals).

The FNO backend calls ``fno_apply`` on a (1, N, N, 1) field, where
``fno_apply`` takes (H, W, C): it raises, in JAX as here, so
``run_suppression_loop(use_fno=True)`` cannot run (a fault of the JAX
package that the port keeps).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

GRID_SIZE = 64


class TurbulenceState(NamedTuple):
    field_k: torch.Tensor       # complex spectrum (N, N)
    zonal_flow: torch.Tensor    # predator state (scalar)
    generator: torch.Generator | None = None


def _normal(generator: torch.Generator, shape, dtype, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=generator.device).to(device)


def init_turbulence(generator: torch.Generator, size: int = GRID_SIZE, *,
                    dtype=torch.float32, device: torch.device | str = "cuda") -> TurbulenceState:
    """A 0.1-scaled normal field's spectrum, no zonal flow; the state keeps
    ``generator`` for the forcing."""
    state = _init_turbulence(_normal(generator, (size, size), dtype, device))
    return state._replace(generator=generator)


def _init_turbulence(field_noise: torch.Tensor) -> TurbulenceState:
    """:func:`init_turbulence` on the given standard-normal (N, N) field."""
    return TurbulenceState(torch.fft.fft2(0.1 * field_noise),
                           torch.zeros((), dtype=field_noise.dtype, device=field_noise.device))


def _wavenumbers(size: int, dtype=torch.float32, device: torch.device | str = "cuda"):
    k = torch.fft.fftfreq(size, dtype=dtype, device=device) * size
    kx, ky = torch.meshgrid(k, k, indexing="xy")
    k2 = kx**2 + ky**2
    k2[0, 0] = 1.0
    return kx, ky, k2


def turbulence_step(state: TurbulenceState, damping, *, dt: float = 0.01) -> TurbulenceState:
    """One drift-wave spectral step, its forcing drawn from the state's
    generator."""
    size = state.field_k.shape[0]
    real = state.zonal_flow.dtype
    forcing = _normal(state.generator, (2, size, size), real, state.field_k.device)
    return _turbulence_step(state, damping, forcing, dt=dt)


def _turbulence_step(state: TurbulenceState, damping, forcing: torch.Tensor, *,
                     dt: float = 0.01) -> TurbulenceState:
    """:func:`turbulence_step` on the given (2, N, N) standard-normal forcing
    (real and imaginary parts): predator-prey zonal flow, the dispersion's
    phase rotation omega = ky/(1+k^2), the band-limited stochastic forcing, k^2
    dissipation and the (zonal-shear-augmented) suppression factor."""
    size = state.field_k.shape[0]
    _, ky, k2 = _wavenumbers(size, state.zonal_flow.dtype, state.field_k.device)

    field = torch.fft.ifft2(state.field_k).real
    turb_intensity = torch.mean(field**2)
    zf = torch.clamp(state.zonal_flow + (5.0 * turb_intensity - 0.5 * state.zonal_flow) * dt,
                     min=0.0)
    total_damping = damping + 0.2 * zf

    omega = ky / (1.0 + k2)
    phase = torch.exp(-1j * omega * dt)

    forcing_k = torch.fft.fft2(torch.complex(forcing[0], forcing[1])) * (k2 < 25.0) * 5.0

    fk = (state.field_k * phase + forcing_k * dt) \
        * torch.exp(-0.001 * k2 * dt) \
        * (1.0 - torch.clamp(total_damping, 0.0, 1.0))
    return TurbulenceState(fk, zf, state.generator)


def compat_suppression(field: torch.Tensor, gain=1.6) -> torch.Tensor:
    """Reduced-order suppression command from field statistics: a bounded
    tanh of the RMS and the gradient RMS."""
    f = torch.nan_to_num(field)
    rms = torch.sqrt(torch.mean(f**2))
    gr = torch.gradient(f, dim=0)[0]
    gz = torch.gradient(f, dim=1)[0]
    grad_rms = torch.sqrt(torch.mean(gr**2 + gz**2))
    signal = 0.9 * rms + 0.35 * grad_rms
    return torch.clamp(torch.tanh(gain * signal), 0.0, 0.98)


def fno_suppression(field: torch.Tensor, fno_params) -> torch.Tensor:
    """FNO-surrogate suppression command: a bounded tanh of the surrogate's
    mean response to ``field[None, :, :, None]``, as in JAX (which raises:
    ``fno_apply`` takes (H, W, C))."""
    from scpn_fusion_tpu_torch.models.surrogates.fno import fno_apply

    pred = fno_apply(fno_params, field[None, :, :, None])
    return torch.clamp(torch.tanh(2.0 * torch.mean(pred)), 0.0, 0.98)


def postprocess_suppressed_field(field: torch.Tensor, suppression) -> torch.Tensor:
    """Suppressed field with the non-physical DC mode removed."""
    out = field * (1.0 - torch.clamp(torch.as_tensor(suppression, dtype=field.dtype,
                                                     device=field.device), 0.0, 0.98))
    fk = torch.fft.fft2(out)
    fk[0, 0] = 0.0
    return torch.nan_to_num(torch.fft.ifft2(fk).real)


class SuppressionRun(NamedTuple):
    energy: torch.Tensor            # (n_steps,) turbulence energy history
    suppression: torch.Tensor       # (n_steps,) applied commands
    zonal_flow: torch.Tensor        # (n_steps,)
    final_field: torch.Tensor
    mean_energy_last20: torch.Tensor
    max_energy: torch.Tensor


def run_suppression_loop(seed: int = 42, *, n_steps: int = 200, control_on_step: int = 50,
                         size: int = GRID_SIZE, gain=1.6, use_fno: bool = False,
                         fno_params=None, dtype=torch.float32,
                         device: torch.device | str = "cuda") -> SuppressionRun:
    """Seeded closed-loop suppression run: free turbulence growth until
    ``control_on_step``, then the controller damps the drive each step.  The
    draws come from ``torch.Generator().manual_seed(seed)`` (the initial
    field, then the forcing of every step); differentiable in ``gain``."""
    generator = torch.Generator().manual_seed(seed)
    field0 = torch.randn((size, size), generator=generator, dtype=dtype)
    forcing = torch.randn((n_steps, 2, size, size), generator=generator, dtype=dtype)
    return _run_suppression_loop(field0.to(device), forcing.to(device),
                                 control_on_step=control_on_step, gain=gain, use_fno=use_fno,
                                 fno_params=fno_params)


def _run_suppression_loop(field_noise: torch.Tensor, forcing: torch.Tensor, *,
                          control_on_step: int = 50, gain=1.6, use_fno: bool = False,
                          fno_params=None) -> SuppressionRun:
    """:func:`run_suppression_loop` on the given standard-normal initial
    (N, N) field and (n_steps, 2, N, N) forcing."""
    state = _init_turbulence(field_noise)
    energies, controls, zonal = [], [], []
    for k in range(forcing.shape[0]):
        field = torch.fft.ifft2(state.field_k).real
        if use_fno:
            cmd = fno_suppression(field, fno_params)
        else:
            cmd = compat_suppression(field, gain)
        control = cmd if k > control_on_step else torch.zeros_like(cmd)
        state = _turbulence_step(state, control, forcing[k])
        energies.append(torch.mean(torch.fft.ifft2(state.field_k).real ** 2))
        controls.append(control)
        zonal.append(state.zonal_flow)
    energy = torch.stack(energies)
    return SuppressionRun(
        energy=energy, suppression=torch.stack(controls), zonal_flow=torch.stack(zonal),
        final_field=torch.fft.ifft2(state.field_k).real,
        mean_energy_last20=torch.mean(energy[-20:]),
        max_energy=torch.max(energy))
