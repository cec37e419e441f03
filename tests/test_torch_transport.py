"""Port parity: the 1.5D transport stepper (``models/transport/solver.py``).

The port against JAX on the CPU at nr 25 (the coupled example's width):
the initial state, one step and a 10-step run for both ``multi_ion``
values in float64 (state within 1e-12, the same Picard iteration count at
every step), and a short float32 run within 1e-5.  JAX's stepper does not
return its Picard count; it is read from the jitted step itself: a step took
k iterations iff it stops where ``picard_max_iter = k`` stops it and not
where ``k - 1`` does.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import span_rel

from scpn_fusion_tpu.models.transport import solver as js
from scpn_fusion_tpu_torch import interop
from scpn_fusion_tpu_torch.models.transport import solver as ts

DT, P_AUX = 0.02, 30.0


def _params(**kw):
    ref = js.TransportParams(nr=25, **kw)
    return ref, interop.transport_params(dataclasses.asdict(ref))


def _same_state(ref, ours, tol):
    for name in ref._fields:
        a, b = np.asarray(getattr(ref, name), np.float64), getattr(ours, name).double().numpy()
        scale = max(float(np.max(np.abs(a))), 1e-300)
        assert float(np.max(np.abs(a - b))) <= tol * scale, name


def _jax_step(state, params, dtype):
    return js.evolve_profiles(state, jnp.asarray(DT, dtype), jnp.asarray(P_AUX, dtype), params)


def _jax_took(state, params, k, dtype):
    """True iff JAX's step from ``state`` takes exactly k Picard iterations."""
    full = _jax_step(state, params, dtype)

    def same(cap):
        out = _jax_step(state, dataclasses.replace(params, picard_max_iter=cap), dtype)
        return all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(out, full))

    if k == params.picard_max_iter:
        return not same(k - 1)
    return same(k) and (k == 1 or not same(k - 1))


def test_params_and_initial_state_match_jax():
    ref_p, p = _params()
    assert p == interop.transport_params(dataclasses.asdict(ref_p))
    assert np.array_equal(p.rho(torch.float64, "cpu").numpy(), np.asarray(ref_p.rho(jnp.float64)))
    for jd, td in ((jnp.float64, torch.float64), (jnp.float32, torch.float32)):
        ref = js.initial_state(ref_p, jd)
        ours = ts.initial_state(p, td, device="cpu")
        _same_state(ref, ours, 1e-15)
        _same_state(ref, interop.transport_state(ref._asdict(), dtype=td, device="cpu"), 0.0)


@pytest.mark.parametrize("multi_ion", [True, False])
def test_one_step_f64(multi_ion):
    ref_p, p = _params(multi_ion=multi_ion)
    s0 = js.initial_state(ref_p, jnp.float64)
    ref = _jax_step(s0, ref_p, jnp.float64)
    ours, k = ts._evolve(interop.transport_state(s0._asdict(), dtype=torch.float64,
                                                 device="cpu"), DT, P_AUX, p)
    _same_state(ref, ours, 1e-12)
    assert _jax_took(s0, ref_p, k, jnp.float64), f"port took {k} Picard iterations"


@pytest.mark.parametrize("multi_ion", [True, False])
def test_ten_steps_f64_same_picard_counts(multi_ion):
    ref_p, p = _params(multi_ion=multi_ion)
    s0 = js.initial_state(ref_p, jnp.float64)
    ref, ref_tr = js.run_transport(s0, jnp.asarray(DT), jnp.asarray(P_AUX), ref_p, 10)
    ours, tr = ts.run_transport(ts.initial_state(p, torch.float64, "cpu"), DT, P_AUX, p, 10)
    _same_state(ref, ours, 1e-12)
    for key in ("ti0", "te0", "ne0", "n_he0"):
        assert span_rel(tr[key], ref_tr[key]) <= 1e-12, key
    counts = tr["picard"].tolist()
    state = s0
    for step, k in enumerate(counts):
        assert _jax_took(state, ref_p, k, jnp.float64), f"step {step}: port took {k}"
        state = _jax_step(state, ref_p, jnp.float64)
    if not multi_ion:
        assert max(counts) > 2      # the single-ion start is where the corrector works


def test_short_f32_run():
    """float32 within 1e-5 span-relative of JAX's float32 run (which departs
    from its own float64 run: the gyro-Bohm channel underflows in f32)."""
    ref_p, p = _params()
    s0 = js.initial_state(ref_p, jnp.float32)
    ref, ref_tr = js.run_transport(s0, jnp.float32(DT), jnp.float32(P_AUX), ref_p, 5)
    ours, tr = ts.run_transport(ts.initial_state(p, torch.float32, "cpu"), DT, P_AUX, p, 5)
    assert ours.ti.dtype == torch.float32
    for name in ("ti", "te", "ne", "n_d", "n_t"):
        assert span_rel(getattr(ours, name), getattr(ref, name)) <= 1e-5, name
    ref64, _ = js.run_transport(js.initial_state(ref_p, jnp.float64), jnp.asarray(DT),
                                jnp.asarray(P_AUX), ref_p, 5)
    assert span_rel(ours.ti, ref64.ti) > 1e-3      # the float32 departure, kept


def test_explicit_rhs_and_cn_matrix_batch_rows():
    """The species' batched assembly does each row's arithmetic."""
    _, p = _params()
    rho = p.rho(torch.float64, "cpu")
    g = np.random.default_rng(4)
    t = torch.from_numpy(g.random((3, 25)))
    chi = torch.from_numpy(0.3 + g.random(25))
    batch = ts.explicit_diffusion_rhs(t, chi, rho, p.drho)
    for k in range(3):
        assert torch.equal(batch[k], ts.explicit_diffusion_rhs(t[k], chi, rho, p.drho))
    ref = js.explicit_diffusion_rhs(jnp.asarray(t[0].numpy()), jnp.asarray(chi.numpy()),
                                    jnp.asarray(rho.numpy()), p.drho)
    assert span_rel(batch[0], ref) <= 1e-13
    a, b, c = ts.build_cn_tridiag(chi, torch.tensor(0.5, dtype=torch.float64), rho, p.drho)
    ja, jb, jc = js.build_cn_tridiag(jnp.asarray(chi.numpy()), jnp.float64(0.5),
                                     jnp.asarray(rho.numpy()), p.drho)
    for x, y in ((a, ja), (b, jb), (c, jc)):
        assert span_rel(x, y) <= 1e-14


def test_default_device_is_the_card():
    """With no ``device`` the state lives on CUDA; without a card it raises
    instead of falling back to the CPU."""
    _, p = _params()
    if torch.cuda.is_available():
        assert ts.initial_state(p).ti.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            ts.initial_state(p)
