"""Port parity: the spectral turbulence generator and the suppression closed
loop (``models/surrogates/turbulence_suppressor.py``).

JAX's key chain is rebuilt to feed the port's twin: ``split(PRNGKey(seed))``
for the initial field, then ``split(key, 3)`` a step for the two forcing
normals.  On those draws, in float64, 20 steps of the closed loop (the
controller engaging after step 5) are within 1e-10 of JAX's energies,
commands, zonal flow and final field, and the gradient of the late-time
energy in the gain by autograd is within 1e-8 of ``jax.grad``'s.  The FNO
backend raises in both packages (``fno_apply`` takes (H, W, C), the backend
hands it (1, N, N, 1)).  The JAX tests' gates hold for the port's own draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import crel, rel

from scpn_fusion_tpu.models.surrogates import fno as jf
from scpn_fusion_tpu.models.surrogates import turbulence_suppressor as jts
from scpn_fusion_tpu_torch import interop
from scpn_fusion_tpu_torch.models.surrogates import fno as tf
from scpn_fusion_tpu_torch.models.surrogates import turbulence_suppressor as tts

TOL = 1e-10
F64 = torch.float64
CPU = dict(dtype=F64, device="cpu")


def jax_draws(seed: int, n_steps: int, size: int = 64):
    """The initial normal field and the (n_steps, 2, N, N) forcing normals
    ``run_suppression_loop`` draws from its key chain."""
    key, sub = jax.random.split(jax.random.PRNGKey(seed))
    field = np.array(jax.random.normal(sub, (size, size)))
    forcing = []
    for _ in range(n_steps):
        key, k1, k2 = jax.random.split(key, 3)
        forcing.append([np.asarray(jax.random.normal(k, (size, size))) for k in (k1, k2)])
    return torch.from_numpy(field), torch.from_numpy(np.array(forcing))


def test_closed_loop_matches_jax_on_its_draws():
    ref = jts.run_suppression_loop(seed=7, n_steps=20, control_on_step=5)
    got = tts._run_suppression_loop(*jax_draws(7, 20), control_on_step=5)
    for name in ("energy", "suppression", "zonal_flow", "final_field", "mean_energy_last20",
                 "max_energy"):
        assert rel(getattr(got, name), getattr(ref, name)) <= TOL, name
    assert float(got.suppression[:6].abs().max()) == 0.0 < float(got.suppression[6:].min())


def test_gain_gradient_matches_jax():
    def late_energy(gain):
        return jts.run_suppression_loop(seed=3, n_steps=80, control_on_step=20,
                                        gain=gain).mean_energy_last20

    g_ref = float(jax.grad(late_energy)(jnp.asarray(1.6)))
    gain = torch.tensor(1.6, dtype=F64, requires_grad=True)
    run = tts._run_suppression_loop(*jax_draws(3, 80), control_on_step=20, gain=gain)
    (g,) = torch.autograd.grad(run.mean_energy_last20, gain)
    assert abs(float(g) - g_ref) <= 1e-8 * abs(g_ref)
    assert float(g) < 0.0


def test_fno_backend_raises_in_both_packages():
    ref_params = jf.init_fno(jax.random.PRNGKey(0), width=4, modes=2, n_layers=1)
    with pytest.raises(ValueError):
        jts.run_suppression_loop(seed=1, n_steps=2, size=8, use_fno=True, fno_params=ref_params)
    params = tf.init_fno(torch.Generator().manual_seed(0), width=4, modes=2, n_layers=1,
                         device="cpu")
    with pytest.raises(ValueError, match="fno_apply"):
        tts.run_suppression_loop(seed=1, n_steps=2, size=8, use_fno=True, fno_params=params,
                                 **CPU)
    with pytest.raises(ValueError, match="fno_apply"):
        tts.fno_suppression(torch.zeros((8, 8)), params)


def test_step_pieces_match_jax():
    g = np.random.default_rng(2)
    field = g.standard_normal((64, 64))
    assert rel(tts.compat_suppression(torch.from_numpy(field), 1.3),
               jts.compat_suppression(jnp.asarray(field), 1.3)) <= 1e-12
    assert rel(tts.postprocess_suppressed_field(torch.from_numpy(field), 0.4),
               jts.postprocess_suppressed_field(jnp.asarray(field), 0.4)) <= 1e-12
    for a, b in zip(tts._wavenumbers(16, F64, "cpu"), jts._wavenumbers(16)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    state = jts.init_turbulence(jax.random.PRNGKey(5))
    _, k1, k2 = jax.random.split(state.key, 3)
    forcing = torch.from_numpy(np.array([jax.random.normal(k, (64, 64)) for k in (k1, k2)]))
    ref = jts.turbulence_step(state, 0.3)
    ours = interop.turbulence_state(state, device="cpu")
    got = tts._turbulence_step(ours, 0.3, forcing)
    assert crel(got.field_k, ref.field_k) <= 1e-12 and rel(got.zonal_flow, ref.zonal_flow) <= 1e-12


def test_the_jax_tests_gates_hold():
    controlled = tts.run_suppression_loop(seed=42, n_steps=200, control_on_step=50, **CPU)
    free = tts.run_suppression_loop(seed=42, n_steps=200, control_on_step=10_000, **CPU)
    e_ctrl, e_free = float(controlled.mean_energy_last20), float(free.mean_energy_last20)
    assert e_ctrl < 0.5 * e_free, (e_ctrl, e_free)
    assert float(controlled.suppression.max()) > 0.1
    again = tts.run_suppression_loop(seed=42, n_steps=200, control_on_step=50, **CPU)
    assert float(again.mean_energy_last20) == e_ctrl

    gain = torch.tensor(1.6, dtype=F64, requires_grad=True)
    run = tts.run_suppression_loop(seed=3, n_steps=80, control_on_step=20, gain=gain, **CPU)
    (g,) = torch.autograd.grad(run.mean_energy_last20, gain)
    assert np.isfinite(float(g)) and float(g) < 0.0


def test_free_turbulence_saturates_and_commands_are_bounded():
    state = tts.init_turbulence(torch.Generator().manual_seed(0), **CPU)
    energy = []
    for _ in range(150):
        state = tts.turbulence_step(state, 0.0)
        energy.append(float(torch.mean(torch.fft.ifft2(state.field_k).real ** 2)))
    e = np.asarray(energy)
    assert np.all(np.isfinite(e)) and float(state.zonal_flow) > 0.0
    assert e[-1] < 10.0 * np.median(e[50:])
    small = float(tts.compat_suppression(0.01 * torch.ones((64, 64), dtype=F64)))
    big = float(tts.compat_suppression(2.0 * torch.ones((64, 64), dtype=F64)))
    assert 0.0 <= small < big <= 0.98
    field = torch.ones((64, 64), dtype=F64) + 0.1 * torch.randn(
        (64, 64), generator=torch.Generator().manual_seed(1), dtype=F64)
    out = tts.postprocess_suppressed_field(field, 0.5)
    assert abs(float(out.mean())) < 1e-10 and bool(torch.isfinite(out).all())


def test_interop_state_round_trip():
    state = jts.init_turbulence(jax.random.PRNGKey(2), 16)
    ours = interop.turbulence_state(state, torch.Generator(), device="cpu")
    assert ours.field_k.dtype == torch.complex128
    assert np.array_equal(ours.field_k.numpy(), np.asarray(state.field_k))
    back = interop.turbulence_state(ours, device="cpu")
    assert torch.equal(back.field_k, ours.field_k) and back.generator is None


def test_default_device_is_the_card():
    """With no ``device`` the entry points run on CUDA; without a card they
    raise instead of falling back to the CPU."""
    calls = (lambda: tts.run_suppression_loop(seed=1, n_steps=2, size=8).energy,
             lambda: tts.init_turbulence(torch.Generator().manual_seed(0), 8).field_k)
    for call in calls:
        if torch.cuda.is_available():
            assert call().is_cuda
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                call()
