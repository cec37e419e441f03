"""Port parity: the IFT fixed point of ``models/equilibrium/differentiable.py``.

``fixed_point_ift`` is a ``torch.autograd.Function`` whose backward is the
adjoint iteration at the fixed point.  On the CPU in float64: the linear and
vector fixed points of ``tests/test_differentiable.py`` against their closed
forms and against ``jax.grad`` of the JAX package's ``fixed_point_ift``
(within 1e-12 relative); ``torch.autograd.gradcheck`` of the axis flux and
the flux energy of the predictive forward on a 9 x 9 grid (eight SOR sweeps
a step at relaxation 0.5, 60 steps: the finite differences of the forward
see the fixed point's own derivative); the
forward never records a graph over its steps; and every new entry point
runs on the card by default, raising where there is none.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel

from scpn_fusion_tpu.models.equilibrium import differentiable as jd
from scpn_fusion_tpu_torch.core.grid import Grid as TGrid
from scpn_fusion_tpu_torch.models.equilibrium import differentiable as td

TOL = 1e-12


def test_linear_fixed_point_gradient_exact():
    a, b = 0.5, 2.0

    def step(theta, psi):
        return theta[0] * psi + theta[1]

    theta = torch.tensor([a, b], dtype=torch.float64, requires_grad=True)
    psi = td.fixed_point_ift(step, theta, torch.tensor(0.0, dtype=torch.float64), 200, 200)
    (g,) = torch.autograd.grad(psi, theta)
    assert float(psi.detach()) == pytest.approx(b / (1 - a), rel=1e-14)
    assert float(g[1]) == pytest.approx(1.0 / (1 - a), rel=1e-14)
    assert float(g[0]) == pytest.approx(b / (1 - a) ** 2, rel=1e-14)
    ref = jax.grad(lambda th: jd.fixed_point_ift(
        lambda t, p: t[0] * p + t[1], th, jnp.asarray(0.0), 200, 200))(jnp.asarray([a, b]))
    assert rel(g, ref) <= TOL


def test_vector_fixed_point_gradient_matches_jax():
    m_np = np.array([[0.3, 0.1], [0.0, 0.4]])
    m_t = torch.tensor(m_np)

    def ref_loss(theta):
        psi = jd.fixed_point_ift(lambda t, p: jnp.asarray(m_np) @ p + t, theta,
                                 jnp.zeros(2), 300, 300)
        return jnp.sum(psi ** 2)

    theta = torch.tensor([1.0, -0.5], dtype=torch.float64, requires_grad=True)
    psi = td.fixed_point_ift(lambda t, p: m_t @ p + t, theta,
                             torch.zeros(2, dtype=torch.float64), 300, 300)
    (g,) = torch.autograd.grad((psi ** 2).sum(), theta)
    ref = jax.grad(ref_loss)(jnp.asarray([1.0, -0.5]))
    assert rel(g, ref) <= TOL
    # closed form: psi* = (I - M)^-1 theta, dL/dtheta = 2 (I - M)^-T psi*
    inv = np.linalg.inv(np.eye(2) - m_np)
    assert rel(g, 2.0 * inv.T @ (inv @ np.array([1.0, -0.5]))) <= 1e-13


def test_named_theta_gradients_and_zero_psi0_gradient():
    """A NamedTuple theta gets one gradient a leaf; psi0 gets zero."""
    def step(theta, psi):
        return 0.5 * psi + theta.coil_currents.sum() * theta.p_coeffs[0] + theta.ip_target

    theta = td.PredictiveTheta(*(torch.tensor(v, dtype=torch.float64, requires_grad=True)
                                 for v in ([1.0, 2.0], [3.0, 0.0, 0.0, 0.0], 0.5)))
    psi0 = torch.tensor(7.0, dtype=torch.float64, requires_grad=True)
    psi = td.fixed_point_ift(step, theta, psi0, 100, 100)
    grads = torch.autograd.grad(psi, [*theta, psi0])
    assert float(psi.detach()) == pytest.approx(2.0 * (9.0 + 0.5), rel=1e-14)
    assert grads[0].tolist() == pytest.approx([6.0, 6.0], rel=1e-14)
    assert float(grads[1][0]) == pytest.approx(6.0, rel=1e-14)
    assert float(grads[2]) == pytest.approx(2.0, rel=1e-14)
    assert float(grads[3]) == 0.0


def _tiny_model():
    grid = TGrid.from_bounds(9, 9, 2.0, 10.0, -4.0, 4.0, dtype=torch.float64, device="cpu")
    return td.build_predictive_model(grid, [3.5, 8.0, 10.8, 8.0, 3.5, 10.8],
                                     [4.8, 4.8, 0.0, -4.8, -4.8, 2.5], relax=0.5)


def test_gradcheck_of_the_predictive_forward():
    model = _tiny_model()
    p_coeffs = torch.tensor([1.0, 0.4, 0.08, 0.02], dtype=torch.float64)

    def forward(currents, ip):
        theta = td.PredictiveTheta(currents, p_coeffs, ip)
        psi = td.solve_predictive_diff(model, theta, n_fwd=60, n_bwd=60) * 1e6
        return torch.stack([td.soft_axis_flux(psi), (psi * psi).mean()])

    currents = torch.tensor([-1.0, 4.0, 6.0, 4.0, -1.0, 3.0], dtype=torch.float64,
                            requires_grad=True)
    ip = torch.tensor(15.0, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(forward, (currents, ip), eps=1e-6, atol=1e-8, rtol=1e-5)


def test_forward_records_no_graph_over_its_steps():
    model = _tiny_model()
    theta = td.PredictiveTheta(torch.tensor([-1.0, 4.0, 6.0, 4.0, -1.0, 3.0], dtype=torch.float64,
                                            requires_grad=True),
                               torch.tensor([1.0, 0.4, 0.08, 0.02], dtype=torch.float64),
                               torch.tensor(15.0, dtype=torch.float64))
    psi = td.solve_predictive_diff(model, theta, n_fwd=5)
    assert type(psi.grad_fn).__name__ == "_FixedPointIFTBackward"
    assert psi.grad_fn.next_functions[0][0] is None   # psi0 is detached


DEFAULT_DEVICE_CALLS = ("build_predictive_model", "reconstruct", "refit_profiles",
                        "operator_residual", "tokamak_boundary", "trace_field_lines",
                        "solve_force_balance_3d")


def _default_device_call(name):
    """The entry point ``name`` called without a device."""
    from pathlib import Path

    from scpn_fusion_tpu_torch.core.grid import Grid
    from scpn_fusion_tpu_torch.io.geqdsk import read_geqdsk
    from scpn_fusion_tpu_torch.models.equilibrium import (
        fieldline, force_balance_3d, reconstruction, vmec_lite,
    )
    if name in ("reconstruct", "refit_profiles", "operator_residual"):
        case = reconstruction.prepare_case(read_geqdsk(
            Path(__file__).resolve().parent.parent / "fuzz" / "seeds" / "geqdsk"
            / "sparc_lmode_hv.geqdsk"))
        kw = {"reconstruct": dict(max_iter=1), "refit_profiles": dict(n_outer=1, n_cycles=1),
              "operator_residual": {}}[name]
        return getattr(reconstruction, name)(case, **kw)
    if name == "build_predictive_model":
        return td.build_predictive_model(Grid.from_bounds(9, 9, 2.0, 10.0, -4.0, 4.0),
                                         [3.5], [4.8])
    if name == "tokamak_boundary":
        return vmec_lite.tokamak_boundary(6.2, 2.0, 1.7, 0.3, vmec_lite.SpectralBasis())
    if name == "trace_field_lines":
        model = fieldline.FieldModel(r_1d=(4.0, 5.0, 6.0), z_1d=(-1.0, 0.0, 1.0),
                                     psi=(0.0,) * 9)
        return fieldline.trace_field_lines(model, 5.0, 0.0, n_turns=0.1, steps_per_turn=10)
    return force_balance_3d.solve_force_balance_3d(force_balance_3d.Geometry3D())


@pytest.mark.parametrize("name", DEFAULT_DEVICE_CALLS)
def test_default_device_is_the_card(name):
    """With no ``device`` an entry point runs on CUDA; without a card it
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        _default_device_call(name)
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            _default_device_call(name)
