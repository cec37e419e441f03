"""Port parity: GK species, geometry, the linear eigenvalue lanes and the
quasilinear fluxes (``models/gyrokinetics/{species, geometry, linear,
quasilinear}.py``).

The Bessel J0 polynomial, the velocity quadrature, the collision rates and
the circular and Miller geometries match the JAX functions to round-off; the
dispersion matrix (with and without the drift diagonal, with and without the
adiabatic response) within 1e-12; the initial-value lane's eigenvalue and
mode, one k_y or a batch of them, within 1e-10; the ``eig`` lane's
eigenvalues within 1e-10 (the parity matrix is Hermitian, so its growth
rates are round-off: the selected mode's gamma is held absolutely, as both
are ~1e-16); ``solve_linear_gk`` on the initial-value lane equal to JAX's
within 1e-10, and ``method="auto"`` takes ``eig`` on the CPU, with the
initial-value gamma within 1e-3 of it (``tests/test_gyrokinetics.py:83-92``).
``quasilinear.py`` is a copy of the JAX module (held equal in
``test_torch_gk_copies.py``); its fluxes equal JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import crel as rel

from scpn_fusion_tpu.models.gyrokinetics import geometry as jgeo
from scpn_fusion_tpu.models.gyrokinetics import linear as jlin
from scpn_fusion_tpu.models.gyrokinetics import quasilinear as jql
from scpn_fusion_tpu.models.gyrokinetics import species as jsp
from scpn_fusion_tpu_torch.models.gyrokinetics import geometry as tgeo
from scpn_fusion_tpu_torch.models.gyrokinetics import linear as tlin
from scpn_fusion_tpu_torch.models.gyrokinetics import quasilinear as tql
from scpn_fusion_tpu_torch.models.gyrokinetics import species as tsp

TOL = 1e-10
SHAPED = dict(kappa=1.6, delta=0.3, s_kappa=0.1, s_delta=0.2, alpha_mhd=0.2, dr_dr=0.1,
              n_theta=32)


def test_bessel_j0_matches():
    x = np.linspace(-25.0, 25.0, 801)
    assert rel(tsp.bessel_j0(torch.from_numpy(x)), jsp.bessel_j0(jnp.asarray(x))) <= 1e-15


def test_velocity_grid_nodes_match():
    for grid in ((16, 24), (6, 8), (24, 16)):
        ours = tsp.VelocityGrid(*grid).nodes(device="cpu")
        ref = jsp.VelocityGrid(*grid).nodes()
        assert all(np.array_equal(a.numpy(), np.asarray(b)) for a, b in zip(ours, ref))
    with pytest.raises(ValueError, match="n_energy"):
        tsp.VelocityGrid(n_energy=1)
    with pytest.raises(ValueError, match="n_lambda"):
        tsp.VelocityGrid(n_lambda=2)


def test_species_and_collision_rates_match():
    for make in ("deuterium_ion", "electron"):
        ours, ref = getattr(tsp, make)(), getattr(jsp, make)()
        assert ours.thermal_speed == ref.thermal_speed and ours.mass_kg == ref.mass_kg
        assert tsp.collision_frequencies(ours, 10.0, 8.0, z_eff=1.7) == \
            jsp.collision_frequencies(ref, 10.0, 8.0, z_eff=1.7)
    with pytest.raises(ValueError, match="temperature_kev"):
        tsp.GKSpecies(2.0, 1.0, -1.0, 10.0, 6.9, 2.2)
    with pytest.raises(ValueError, match="charge_e"):
        tsp.GKSpecies(2.0, 0.0, 8.0, 10.0, 6.9, 2.2)


@pytest.mark.parametrize("kind", ["circular", "shaped"])
def test_geometry_matches(kind):
    if kind == "circular":
        ours, ref = tgeo.circular_geometry(n_theta=24, device="cpu"), jgeo.circular_geometry(n_theta=24)
    else:
        ours, ref = tgeo.miller_geometry(**SHAPED, device="cpu"), jgeo.miller_geometry(**SHAPED)
    for name in ref._fields:
        assert rel(getattr(ours, name), getattr(ref, name)) <= 1e-14, name


def _geoms(n_theta=24):
    return jgeo.circular_geometry(n_theta=n_theta), tgeo.circular_geometry(n_theta=n_theta,
                                                                           device="cpu")


VG = dict(n_energy=6, n_lambda=8)


@pytest.mark.parametrize("include_drifts", [False, True])
@pytest.mark.parametrize("adiabatic", [True, False])
def test_dispersion_matrix_matches(include_drifts, adiabatic):
    jg, tg = _geoms()
    kw = dict(include_drifts=include_drifts, adiabatic_electrons=adiabatic, nu_star=0.05)
    ref = jlin.assemble_dispersion_matrix(0.5, jsp.deuterium_ion(), jg, jsp.VelocityGrid(**VG),
                                          **kw)
    ours = tlin.assemble_dispersion_matrix(0.5, tsp.deuterium_ion(), tg, tsp.VelocityGrid(**VG),
                                           **kw)
    assert ours.dtype == torch.complex128 and ours.shape == (24, 24)
    assert rel(ours, ref) <= 1e-12


def test_streaming_matrix_matches():
    jg, tg = _geoms(16)
    assert rel(tlin._streaming_matrix(tg.theta), jlin._streaming_matrix(jg.theta)) <= 1e-15


def test_initial_value_lane_matches():
    jg, tg = _geoms()
    mj = jlin.assemble_dispersion_matrix(0.5, jsp.deuterium_ion(), jg, jsp.VelocityGrid(**VG))
    mt = tlin.assemble_dispersion_matrix(0.5, tsp.deuterium_ion(), tg, tsp.VelocityGrid(**VG))
    ref = jlin.most_unstable_mode_initial_value(mj, dt=0.01, n_steps=1500)
    ours = tlin.most_unstable_mode_initial_value(mt, dt=0.01, n_steps=1500)
    assert rel(ours.omega_r, ref.omega_r) <= TOL
    assert abs(float(ours.gamma) - float(ref.gamma)) <= TOL * abs(float(ref.omega_r))
    assert rel(ours.phi, ref.phi) <= TOL
    # a batch of matrices steps each on its own
    batch = tlin.most_unstable_mode_initial_value(torch.stack([mt, 2.0 * mt]), dt=0.01,
                                                  n_steps=1500)
    assert rel(batch.omega_r[0], ref.omega_r) <= TOL and batch.phi.shape == (2, 24)
    one = tlin.most_unstable_mode_initial_value(2.0 * mt, dt=0.01, n_steps=1500)
    assert rel(batch.omega_r[1], one.omega_r) <= 1e-13


def test_eig_lane_eigenvalues_match():
    jg, tg = _geoms()
    mj = jlin.assemble_dispersion_matrix(0.5, jsp.deuterium_ion(), jg, jsp.VelocityGrid(**VG))
    mt = tlin.assemble_dispersion_matrix(0.5, tsp.deuterium_ion(), tg, tsp.VelocityGrid(**VG))
    ref = np.sort_complex(np.linalg.eigvals(np.asarray(mj)))
    ours = np.sort_complex(torch.linalg.eigvals(mt).numpy())
    assert np.max(np.abs(ours - ref)) <= TOL * np.max(np.abs(ref))
    mode = tlin.solve_eigenvalue_single_ky(0.5, [tsp.deuterium_ion()], tg,
                                           tsp.VelocityGrid(**VG), method="eig")
    ref_mode = jlin.solve_eigenvalue_single_ky(0.5, [jsp.deuterium_ion()], jg,
                                               jsp.VelocityGrid(**VG), method="eig")
    # both growth rates are round-off of a Hermitian matrix
    assert abs(mode.gamma - ref_mode.gamma) <= TOL and 0.0 <= mode.gamma < 1e-10
    assert mode.mode_type in ("ITG", "TEM", "stable")


def test_solve_linear_gk_initial_value_matches():
    jg, tg = _geoms()
    kys = np.linspace(0.2, 0.8, 4)
    ref = jlin.solve_linear_gk(k_y_values=kys, vgrid=jsp.VelocityGrid(**VG), geom=jg,
                               method="initial_value")
    ours = tlin.solve_linear_gk(k_y_values=kys, vgrid=tsp.VelocityGrid(**VG), geom=tg,
                                method="initial_value")
    assert np.array_equal(ours.k_y, ref.k_y) and ours.mode_type == ref.mode_type
    assert np.max(np.abs(ours.omega_r - ref.omega_r)) <= TOL * np.max(np.abs(ref.omega_r))
    assert np.max(np.abs(ours.gamma - ref.gamma)) <= TOL * np.max(np.abs(ref.omega_r))
    assert ours.gamma_max == pytest.approx(ref.gamma_max, rel=1e-9)
    assert ours.k_y_max == ref.k_y_max


def test_auto_takes_eig_on_the_cpu_and_the_lanes_agree():
    jg, tg = _geoms()
    kys = np.linspace(0.2, 0.8, 3)
    auto = tlin.solve_linear_gk(k_y_values=kys, vgrid=tsp.VelocityGrid(**VG), geom=tg)
    assert np.all(auto.gamma < 1e-10)       # eig: round-off growth rates
    iv = tlin.solve_linear_gk(k_y_values=kys, vgrid=tsp.VelocityGrid(**VG), geom=tg,
                              method="initial_value")
    assert np.max(np.abs(iv.gamma - auto.gamma)) < 1e-3
    assert tlin._resolve("auto", torch.zeros(1)) == "eig"
    assert tlin._resolve("auto", torch.zeros(1, device="meta")) == "initial_value"


def test_default_scan_makes_its_geometry_on_the_device():
    ours = tlin.solve_linear_gk(k_y_values=np.asarray([0.4]), vgrid=tsp.VelocityGrid(**VG),
                                device="cpu", method="initial_value")
    ref = jlin.solve_linear_gk(k_y_values=np.asarray([0.4]), vgrid=jsp.VelocityGrid(**VG),
                               method="initial_value")
    assert abs(ours.omega_r[0] - ref.omega_r[0]) <= TOL * abs(ref.omega_r[0])


def test_quasilinear_fluxes_match():
    res_j = jlin.LinearGKResult(k_y=np.asarray([0.3, 0.5, 0.7, 0.9]),
                                gamma=np.asarray([0.1, 0.25, 0.0, 0.15]),
                                omega_r=np.asarray([-0.4, 0.6, -0.7, -0.8]),
                                mode_type=["ITG", "TEM", "stable", "ETG"])
    res_t = tlin.LinearGKResult(*(getattr(res_j, f) for f in ("k_y", "gamma", "omega_r",
                                                             "mode_type")))
    ours = tql.quasilinear_fluxes_from_spectrum(res_t, tsp.deuterium_ion())
    ref = jql.quasilinear_fluxes_from_spectrum(res_j, jsp.deuterium_ion())
    assert tuple(ours) == tuple(ref)
    assert np.array_equal(tql.mixing_length_saturation(res_t.gamma, res_t.omega_r, res_t.k_y),
                          jql.mixing_length_saturation(res_j.gamma, res_j.omega_r, res_j.k_y))
