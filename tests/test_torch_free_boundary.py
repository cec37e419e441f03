"""Port parity: the free-boundary solve (``models/equilibrium/free_boundary``).

The port against ``scpn_fusion_tpu.models.equilibrium.free_boundary`` on the
CPU, in float64 (x64 on in JAX) unless a test says otherwise: the Green's
tables (within 1e-12 of JAX, relative to the largest entry), the bilinear
interpolation (float64 within 1e-12; float32 equal to JAX's, its edge clip
included), and ``solve_free_boundary`` at 33^2 (65^2 in
``tests/test_torch_free_boundary_65.py``) under the free-boundary
forward's solver (``bench_config.free_boundary_config``) in three
configurations -- fixed currents and ``optimize_shape`` with current limits
here, ``use_wall_response`` in ``tests/test_torch_free_boundary_mixed.py``
with the mixed-precision solve (the files are kept apart so each stays
short) -- each with the same outer and last inner iteration counts as JAX,
psi within 1e-9 span-relative and the coil currents within 1e-8 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np, free_boundary_cfgs, rel, rng, span_rel, to_torch

from scpn_fusion_tpu.core.grid import Grid as JGrid
from scpn_fusion_tpu.models.equilibrium import free_boundary as jfb
from scpn_fusion_tpu_torch import interop
from scpn_fusion_tpu_torch.bench_config import FREE_BOUNDARY_MU0_GREEN
from scpn_fusion_tpu_torch.core.grid import Grid as TGrid
from scpn_fusion_tpu_torch.models.equilibrium import free_boundary as tfb

PSI_TOL = 1e-9
CURRENT_TOL = 1e-8


def grids(n, dt=np.float64):
    tdt = torch.float64 if dt == np.float64 else torch.float32
    return (JGrid.from_bounds(n, n, 2.0, 10.0, -4.0, 4.0, dtype=dt),
            TGrid.from_bounds(n, n, 2.0, 10.0, -4.0, 4.0, dtype=tdt, device="cpu"))


def test_green_tables_match_jax():
    ref_cfg, cfg = free_boundary_cfgs(33)
    jgrid, tgrid = grids(33)
    jcoils = jfb.coilset_from_config(ref_cfg, jnp.float64)
    tcoils = tfb.coilset_from_config(cfg, torch.float64, "cpu")
    assert rel(tfb.external_flux_table(tgrid, tcoils, 1.0),
               jfb.external_flux_table(jgrid, jcoils, 1.0)) <= 1e-12
    pts = np.stack([rng(7).uniform(2.0, 10.0, 40), rng(8).uniform(-4.0, 4.0, 40)], 1)
    pts[0] = (3.5, 4.8)      # on a coil: the regularised self term
    ref = jfb.mutual_inductance_matrix(jcoils.r, jcoils.z, jcoils.turns, jnp.asarray(pts))
    ours = tfb.mutual_inductance_matrix(tcoils.r, tcoils.z, tcoils.turns, to_torch(pts))
    assert ours.shape == (6, 40)
    assert rel(ours, ref) <= 1e-12
    assert float(ours[0, 0]) == 0.0


@pytest.mark.parametrize("n,dt", [(33, np.float64), (33, np.float32), (65, np.float32)])
def test_interp_psi_matches_jax(n, dt):
    """Random points and the four corners of the domain: at the far corners
    the float32 clip bound ``N - 1 - 1e-6`` is 32 - 2^-19 at 33^2 and rounds
    to 64 at 65^2, as in JAX."""
    jgrid, tgrid = grids(n, dt)
    psi = rng(9).standard_normal((n, n)).astype(dt)
    pts = np.stack([rng(10).uniform(2.0, 10.0, 50), rng(11).uniform(-4.0, 4.0, 50)], 1)
    pts = np.concatenate([pts, [[2.0, -4.0], [10.0, 4.0], [2.0, 4.0], [10.0, -4.0]]]).astype(dt)
    ref = np.asarray(jfb.interp_psi_at_points(jnp.asarray(psi), jgrid, jnp.asarray(pts)))
    ours = tfb.interp_psi_at_points(to_torch(psi, dt), tgrid, to_torch(pts, dt))
    assert ours.dtype == (torch.float64 if dt == np.float64 else torch.float32)
    if dt == np.float64:
        assert rel(ours, ref) <= 1e-12
    else:
        assert np.array_equal(as_np(ours), ref.astype(np.float64))
    if (n, dt) == (65, np.float32):     # the far corner reads the last node itself
        assert float(ours[-3]) == float(psi[-1, -1])


def _shape_coils(coils, limits=8.0):
    theta = np.linspace(0, 2 * np.pi, 16, endpoint=False)
    pts = np.stack([6.0 + 2.0 * np.cos(theta), 2.4 * np.sin(theta)], axis=1)
    return coils._replace(target_flux_points=jnp.asarray(pts),
                          current_limits=jnp.full(coils.currents.shape, limits))


def solve_both(n, case, **kw):
    """The JAX and the port's ``solve_free_boundary`` on the same coils at
    n x n (float64 on the CPU); the coils get 16 isoflux points and limits of
    8 when ``case`` is "optimize_shape"."""
    ref_cfg, cfg = free_boundary_cfgs(n)
    kw = dict(kw, mu0_green=FREE_BOUNDARY_MU0_GREEN)
    jcoils = jfb.coilset_from_config(ref_cfg, jnp.float64)
    if case == "optimize_shape":
        jcoils = _shape_coils(jcoils)
    ref = jfb.solve_free_boundary(ref_cfg, jcoils, dtype=jnp.float64, **kw)
    tcoils = interop.coilset(jcoils._asdict(), dtype=torch.float64, device="cpu")
    ours = tfb.solve_free_boundary(cfg, tcoils, dtype=torch.float64, device="cpu", **kw)
    return jcoils, ref, ours


def assert_parity(ref, ours, psi_tol=PSI_TOL):
    assert ours.outer_iterations == int(ref.outer_iterations)
    assert ours.converged == bool(ref.converged)
    assert ours.equilibrium.iterations == int(ref.equilibrium.iterations)
    assert ours.psi.dtype == torch.float64
    assert span_rel(ours.psi, ref.psi) <= psi_tol
    assert rel(ours.coil_currents, ref.coil_currents) <= CURRENT_TOL
    # the last max |dpsi| of two iterates that each lie within psi_tol of JAX's
    span = float(np.ptp(as_np(ref.psi)))
    assert abs(float(ours.final_diff) - float(ref.final_diff)) <= 2 * psi_tol * span


def test_fixed_currents_match_jax():
    _, ref, ours = solve_both(33, "fixed_currents", max_outer_iter=16, tol=1e-4)
    assert bool(ref.converged)
    assert_parity(ref, ours)


def test_optimize_shape_matches_jax():
    jcoils, ref, ours = solve_both(33, "optimize_shape", max_outer_iter=6, tol=1e-5,
                                   optimize_shape=True, tikhonov_alpha=1e-4)
    assert_parity(ref, ours)
    assert np.all(np.abs(as_np(ours.coil_currents)) <= 8.0)
    assert rel(ours.coil_currents, jcoils.currents) > 1e-3   # the fit moved them


def test_default_device_is_the_card():
    """With no ``device`` the solve runs on CUDA; without a card it raises
    instead of falling back to the CPU."""
    _, cfg = free_boundary_cfgs(17)
    if torch.cuda.is_available():
        assert tfb.solve_free_boundary(cfg, max_outer_iter=1).psi.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            tfb.solve_free_boundary(cfg, max_outer_iter=1)
