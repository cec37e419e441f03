"""Port parity: the radial force balance (``models/equilibrium/force_balance.py``)
and the reduced 3D force balance (``models/equilibrium/force_balance_3d.py``).

On the CPU in float64 against the JAX package, on the six-coil set of
``tests/test_force_balance_gyroswin.py``: the Shafranov field, B_z, the
radial force and the closed-form balance within 1e-10 relative (the same
convergence flag); the autograd Newton on the paired-coil knob the same
root within 1e-10.  The 3D map and force residual within 1e-12 relative, and
``solve_force_balance_3d`` in float64 with the same iteration count,
amplitudes and residual history within 1e-10 relative: the default geometry
from seeded amplitudes, a shaped non-axisymmetric one from zero.  (From
zero amplitudes the default circular geometry is a stationary point: its
gradient there is rounding noise, ~1e-18 of the residual, and the descent
follows the noise.)
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel, rng

from scpn_fusion_tpu.core.config import (
    Coil, Dimensions, PhysicsParams, ReactorConfig, SolverParams,
)
from scpn_fusion_tpu.models.equilibrium import force_balance as jfb
from scpn_fusion_tpu.models.equilibrium import force_balance_3d as jb3
from scpn_fusion_tpu.models.equilibrium.free_boundary import coilset_from_config
from scpn_fusion_tpu_torch import interop
from scpn_fusion_tpu_torch.models.equilibrium import force_balance as tfb
from scpn_fusion_tpu_torch.models.equilibrium import force_balance_3d as tb3

TOL = 1e-10


def coil_sets():
    cfg = ReactorConfig(
        reactor_name="fb-test", grid_resolution=(33, 33),
        dimensions=Dimensions(R_min=2.0, R_max=10.0, Z_min=-4.0, Z_max=4.0),
        coils=(Coil(r=3.5, z=4.8, current=-1e6), Coil(r=8.0, z=4.8, current=4e6),
               Coil(r=10.8, z=0.0, current=6e6), Coil(r=8.0, z=-4.8, current=4e6),
               Coil(r=3.5, z=-4.8, current=-1e6), Coil(r=10.8, z=2.5, current=3e6)),
        physics=PhysicsParams(plasma_current_target=15e6),
        solver=SolverParams(max_iterations=10, convergence_threshold=1e-4,
                            relaxation_factor=0.1))
    ref = coilset_from_config(cfg, jnp.float64)
    return ref, interop.coilset(ref._asdict(), dtype=torch.float64, device="cpu")


def test_fields_and_force_match_jax():
    ref, ours = coil_sets()
    assert tfb.shafranov_vertical_field(6.2, 2.0, 15e6) == pytest.approx(
        float(jfb.shafranov_vertical_field(6.2, 2.0, 15e6)), rel=1e-14)
    b_ours, row_ours = tfb.external_bz_at(ours, 6.5, 0.3)
    b_ref, row_ref = jfb.external_bz_at(ref, 6.5, 0.3)
    assert rel(b_ours, b_ref) <= TOL and rel(row_ours, row_ref) <= TOL
    assert rel(tfb.radial_force(ours, 6.2, 15e6, 2.0), jfb.radial_force(ref, 6.2, 15e6, 2.0)) <= TOL


@pytest.mark.parametrize("pair", [(2, 5), (1, 3), (2, 3)])
def test_closed_form_balance_matches_jax(pair):
    ref_coils, coils = coil_sets()
    ref = jfb.solve_force_balance(ref_coils, control_indices=pair, ip_a=15e6)
    ours = tfb.solve_force_balance(coils, control_indices=pair, ip_a=15e6)
    for name in ("currents", "delta_i", "initial_force_n"):
        assert rel(getattr(ours, name), getattr(ref, name)) <= TOL, name
    # the residual is a cancellation: hold it to the initial force's scale
    assert abs(float(ours.residual_force_n) - float(ref.residual_force_n)) <= TOL * abs(
        float(ref.initial_force_n))
    assert bool(ours.converged) == bool(ref.converged)


def test_newton_matches_jax():
    ref_coils, coils = coil_sets()
    i, j = 2, 5

    def ref_force(delta):
        c = ref_coils._replace(currents=ref_coils.currents.at[i].add(delta).at[j].add(delta))
        return jfb.radial_force(c, 6.2, 15e6, 2.0)

    def force(delta):
        bump = torch.zeros(6, dtype=torch.float64)
        bump[i] = bump[j] = 1.0
        return tfb.radial_force(coils._replace(currents=coils.currents + bump * delta), 6.2,
                                15e6, 2.0)

    x_r, f_r, ok_r = jfb.solve_force_balance_newton(ref_force, jnp.float64(0.0))
    x, f, ok = tfb.solve_force_balance_newton(force, torch.tensor(0.0, dtype=torch.float64))
    assert bool(ok) and bool(ok_r)
    assert rel(x, x_r) <= TOL


GEOMETRIES = [dict(), dict(kappa=1.6, triangularity=0.3, nfp=2, modes_m=(1, 2, 2),
                           modes_n=(1, 0, 1))]


@pytest.mark.parametrize("gkw", GEOMETRIES)
def test_map_and_residual_match_jax(gkw):
    ref_g = jb3.Geometry3D(**gkw)
    geom = interop.geometry_3d(dataclasses.asdict(ref_g))
    amps = 0.05 * rng(4).standard_normal((geom.n_modes, 4))
    rho, theta, phi = (rng(5 + k).random(40) * s for k, s in enumerate((1.2, 6.3, 6.3)))
    ref = jb3.flux_to_cartesian(ref_g, jnp.asarray(amps), *map(jnp.asarray, (rho, theta, phi)))
    ours = tb3.flux_to_cartesian(geom, torch.tensor(amps), *map(torch.tensor, (rho, theta, phi)))
    for a, b in zip(ours, ref):
        assert rel(a, b) <= 1e-12
    cfg = jb3.ForceBalanceConfig()
    assert rel(tb3.force_residual(torch.tensor(amps), geom, interop.force_balance_config(
        dataclasses.asdict(cfg))), jb3.force_residual(jnp.asarray(amps), ref_g, cfg)) <= 1e-12


@pytest.mark.parametrize("gkw,amp", zip(GEOMETRIES, (0.05, 0.0)))
def test_solve_force_balance_3d_matches_jax(gkw, amp):
    ref_g = jb3.Geometry3D(**gkw)
    geom = interop.geometry_3d(dataclasses.asdict(ref_g))
    cfg = jb3.ForceBalanceConfig(max_iterations=12)
    amps0 = amp * rng(9).standard_normal((geom.n_modes, 4))
    ref = jb3.solve_force_balance_3d(ref_g, cfg, jnp.asarray(amps0))
    ours = tb3.solve_force_balance_3d(geom, interop.force_balance_config(dataclasses.asdict(cfg)),
                                      torch.tensor(amps0))
    assert ours.iterations == int(ref.iterations)
    assert rel(ours.amplitudes, ref.amplitudes) <= TOL
    assert rel(ours.residual, ref.residual) <= TOL
    assert np.allclose(ours.history.numpy(), np.asarray(ref.history), rtol=TOL, atol=0,
                       equal_nan=True)
    assert bool(ours.converged) == bool(ref.converged)
    assert float(ours.residual) < float(ours.initial_residual)
