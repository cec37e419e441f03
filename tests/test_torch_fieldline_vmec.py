"""Port parity: field-line tracing (``models/equilibrium/fieldline.py``) and
VMEC-lite (``models/equilibrium/vmec_lite.py``).

On the CPU in float64 against the JAX package: three lines traced through a
peaked psi with a helical perturbation (RK4, 4 turns of 64 steps) within
1e-10 relative, their Poincaré punctures, q from line-following and the
connection length to a wall surface; VMEC-lite on a shaped tokamak boundary
(differentiable and not): the same iteration count and flag, the spectral
coefficients within 1e-10 relative, a flux surface, and the gradient of a
coefficient functional with respect to the boundary (autograd through 20
iterations against ``jax.grad``) within 1e-10.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel

from scpn_fusion_tpu.models.equilibrium import fieldline as jf
from scpn_fusion_tpu.models.equilibrium import vmec_lite as jv
from scpn_fusion_tpu_torch import interop
from scpn_fusion_tpu_torch.models.equilibrium import fieldline as tf
from scpn_fusion_tpu_torch.models.equilibrium import vmec_lite as tv

TOL = 1e-10
R0, Z0 = np.array([6.6, 7.0, 7.4]), np.zeros(3)


def field_models(pert_eps=1e-3):
    r, z = np.linspace(4.0, 8.4, 33), np.linspace(-2.2, 2.2, 33)
    rr, zz = np.meshgrid(r, z)
    psi = np.exp(-((rr - 6.2) ** 2 + zz ** 2) / 2.0)
    ref = jf.FieldModel(r_1d=tuple(r), z_1d=tuple(z), psi=tuple(psi.ravel()), pert_eps=pert_eps)
    return ref, interop.field_model(dataclasses.asdict(ref))


@pytest.mark.parametrize("pert_eps", [0.0, 1e-3])
def test_trace_and_q_match_jax(pert_eps):
    ref_m, model = field_models(pert_eps)
    ref = jf.trace_field_lines(ref_m, jnp.asarray(R0), jnp.asarray(Z0), n_turns=4,
                               steps_per_turn=64)
    ours = tf.trace_field_lines(model, R0, Z0, n_turns=4, steps_per_turn=64, device="cpu")
    for name in ref._fields:
        assert rel(getattr(ours, name), getattr(ref, name)) <= TOL, name
    for a, b in zip(tf.poincare_section(ours, 64), jf.poincare_section(ref, 64)):
        assert rel(a, b) <= TOL
    assert rel(tf.safety_factor_from_trace(ours, 6.2, 0.0, 64),
               jf.safety_factor_from_trace(ref, 6.2, 0.0, 64)) <= TOL
    b_ref = jf.b_field_at(ref_m, jnp.asarray(R0), jnp.asarray(Z0), 0.3)
    b_ours = tf.b_field_at(model, torch.tensor(R0), torch.tensor(Z0), 0.3)
    for a, b in zip(b_ours, b_ref):
        assert rel(a, b) <= TOL


def test_connection_length_matches_jax():
    ref_m, model = field_models()
    ref = jf.connection_length(ref_m, jnp.asarray(R0), jnp.asarray(Z0), wall_psi=0.5, n_turns=3)
    ours = tf.connection_length(model, R0, Z0, wall_psi=0.5, n_turns=3, device="cpu")
    assert rel(ours, ref) <= TOL


def vmec_inputs():
    basis = jv.SpectralBasis()
    ours_basis = interop.spectral_basis(dataclasses.asdict(basis))
    s = np.linspace(0.0, 1.0, 21)
    return basis, ours_basis, 1e5 * (1 - s ** 2), 0.5 + 0.5 * s


@pytest.mark.parametrize("differentiable", [False, True])
def test_vmec_lite_matches_jax(differentiable):
    basis, ours_basis, p, io = vmec_inputs()
    rb, zb = jv.tokamak_boundary(6.2, 2.0, 1.7, 0.33, basis)
    rbt, zbt = tv.tokamak_boundary(6.2, 2.0, 1.7, 0.33, ours_basis, device="cpu")
    assert np.array_equal(rbt.numpy(), np.asarray(rb)) and np.array_equal(zbt.numpy(), np.asarray(zb))
    ref = jv.solve_vmec_lite(basis, rb, zb, jnp.asarray(p), jnp.asarray(io), max_iter=60,
                             differentiable=differentiable)
    ours = tv.solve_vmec_lite(ours_basis, rbt, zbt, torch.tensor(p), torch.tensor(io),
                              max_iter=60, differentiable=differentiable)
    assert ours.iterations == int(ref.iterations)
    assert bool(ours.converged) == bool(ref.converged)
    for name in ("r_mn", "z_mn", "b_mn", "residual"):
        assert rel(getattr(ours, name), getattr(ref, name)) <= TOL, name
    for a, b in zip(tv.flux_surface_rz(ours_basis, ours, 10), jv.flux_surface_rz(basis, ref, 10)):
        assert rel(a, b) <= TOL


def test_vmec_lite_converges_like_jax():
    basis, ours_basis, p, io = vmec_inputs()
    rb, zb = jv.tokamak_boundary(6.2, 2.0, 1.0, 0.0, basis)
    rbt, zbt = tv.tokamak_boundary(6.2, 2.0, 1.0, 0.0, ours_basis, device="cpu")
    ref = jv.solve_vmec_lite(basis, rb, zb, jnp.asarray(p), jnp.asarray(io), max_iter=400,
                             tol=1e-2)
    ours = tv.solve_vmec_lite(ours_basis, rbt, zbt, torch.tensor(p), torch.tensor(io),
                              max_iter=400, tol=1e-2)
    assert bool(ref.converged) and bool(ours.converged)
    assert ours.iterations == int(ref.iterations) < 400
    assert rel(ours.r_mn, ref.r_mn) <= TOL


def test_vmec_lite_gradient_matches_jax():
    basis, ours_basis, p, io = vmec_inputs()
    rb, zb = jv.tokamak_boundary(6.2, 2.0, 1.7, 0.33, basis)
    rbt, zbt = tv.tokamak_boundary(6.2, 2.0, 1.7, 0.33, ours_basis, device="cpu")

    def ref_loss(r_b, pr):
        res = jv.solve_vmec_lite(basis, r_b, zb, pr, jnp.asarray(io), max_iter=20,
                                 differentiable=True)
        return jnp.sum(res.r_mn[10] ** 2) + jnp.sum(res.z_mn[5])

    ref = jax.grad(ref_loss, argnums=(0, 1))(rb, jnp.asarray(p))
    r_b = rbt.clone().requires_grad_(True)
    pr = torch.tensor(p, requires_grad=True)
    res = tv.solve_vmec_lite(ours_basis, r_b, zbt, pr, torch.tensor(io), max_iter=20,
                             differentiable=True)
    ours = torch.autograd.grad((res.r_mn[10] ** 2).sum() + res.z_mn[5].sum(), [r_b, pr])
    for a, b in zip(ours, ref):
        assert rel(a, b) <= TOL
