"""Port parity: the quasi-3D physics contracts (``models/physics/quasi3d``).

float64 on the CPU.  Randomness: the force-balance samples and the Hall-MHD
perturbation come from JAX's keys (split as JAX splits them) through the
private twins.  Force balance within 1e-13 of JAX (n2, a bin the surface
leaves empty, and every observable of the axisymmetric pair are rounding
noise, ~1e-15: held absolutely at 1e-14); the residual
relaxation within 1e-12 (the 95th percentile linear, as ``jnp.percentile``);
the zonal ratio within 1e-12; the two-fluid TEMHD profile (the columns one
batch a step) and the divertor profiles within 1e-12, their diagnostics
within 1e-12; the TBR calibration within 1e-12.  The SOLPS surrogate is
NumPy on both sides (equal).  The JAX tests' gates hold on the port's own
draws, and the package exports the JAX package's names.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel

from scpn_fusion_tpu.models.physics import quasi3d as jq
from scpn_fusion_tpu.models.physics import stellarator as js
from scpn_fusion_tpu_torch.models import physics as tphys
from scpn_fusion_tpu_torch.models.physics import quasi3d as tq
from scpn_fusion_tpu_torch.models.physics import stellarator as ts

F64 = torch.float64
KW = dict(dtype=F64, device="cpu")
BASE = dict(n_fp=1, r0=2.95, a=0.95, helical_excursion=0.0, mirror_ratio=0.0)
STELLAR = dict(n_fp=4, r0=2.95, a=0.95, helical_excursion=0.057, mirror_ratio=0.04)
JET_STATS = [{"q95": 4.0, "edge_gradient": 0.02, "bcentr": 2.8},
             {"q95": 3.4, "edge_gradient": 0.03, "bcentr": 3.4}]


def t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=F64)


@pytest.mark.parametrize("seed, samples, stellar", [(42, 720, STELLAR), (0, 512, STELLAR),
                                                    (1, 256, BASE)])
def test_force_balance_matches_jax(seed, samples, stellar):
    key = jax.random.PRNGKey(seed)
    ref = jq.quasi_3d_force_balance(key, base=js.StellaratorConfig(**BASE),
                                    stellar=js.StellaratorConfig(**stellar), samples=samples)
    k1, k2 = jax.random.split(key)
    theta = jax.random.uniform(k1, (samples,)) * 2.0 * jnp.pi
    phi = jax.random.uniform(k2, (samples,)) * 2.0 * jnp.pi
    ours = tq._quasi_3d_force_balance(t(theta), t(phi), base=ts.StellaratorConfig(**BASE),
                                      stellar=ts.StellaratorConfig(**stellar))
    for name in ref._fields:
        a, b = getattr(ours, name), np.asarray(getattr(ref, name))
        if name == "n2_amp" or float(np.abs(b)) < 1e-12:
            assert abs(float(a) - float(b)) <= 1e-14, name
        else:
            assert rel(a, b) <= 1e-13, name


@pytest.mark.parametrize("iterations", [2, 14])
def test_force_residual_matches_jax(iterations):
    ref = jq.solve_quasi_3d_force_residual(0.06, 0.057, 0.002, iterations=iterations)
    ours = tq.solve_quasi_3d_force_residual(0.06, 0.057, 0.002, iterations=iterations, **KW)
    for a, b in zip(ours, ref):
        assert rel(a, b) <= 1e-12


def test_zonal_ratio_matches_jax():
    key = jax.random.PRNGKey(2)
    ref = jq.hall_mhd_zonal_ratio(key, grid=16, steps=16)
    k1, k2 = jax.random.split(key)
    normals = torch.stack([t(jax.random.normal(k, (16, 16))) for k in (k1, k2)])
    ours = tq._hall_mhd_zonal_ratio(normals, steps=16)
    assert ours["backend"] == ref["backend"] == "hall_mhd"
    assert abs(ours["zonal_ratio"] - ref["zonal_ratio"]) <= 1e-12 * ref["zonal_ratio"]
    own = tq.hall_mhd_zonal_ratio(torch.Generator().manual_seed(2), grid=16, steps=16, **KW)
    assert own["backend"] == "hall_mhd" and 0.0 < own["zonal_ratio"] < 1.0


def test_two_fluid_profile_matches_jax():
    raw = np.full(16, 8.5e5) * (1.0 + 0.1 * np.sin(np.arange(16)))
    ref, rdiag = jq.two_fluid_temhd_coupled_profile(jnp.asarray(raw), 0.2, n_steps=40)
    ours, diag = tq.two_fluid_temhd_coupled_profile(raw, 0.2, n_steps=40, **KW)
    assert rel(ours, ref) <= 1e-12
    for key in rdiag:
        assert rel(diag[key], rdiag[key]) <= 1e-12, key
    # the JAX test's gates
    cool, d = tq.two_fluid_temhd_coupled_profile(np.full(16, 8.5e5), 0.2, **KW)
    assert bool((cool <= 8.5e5).all()) and bool((cool >= 0.70 * 8.5e5).all())
    assert float(d["ion_temp_mean_kev"]) <= 65.0


def test_divertor_profiles_and_solps_match_jax():
    ref_p, ref_meta = jq.jet_solps_reference_profile(JET_STATS, 48)
    ours_p, meta = tq.jet_solps_reference_profile(JET_STATS, 48)
    assert np.array_equal(ours_p, ref_p) and meta == ref_meta
    kw = dict(n1_amp=0.057, n2_amp=0.002, z_n1_amp=0.057, zonal_ratio=0.06,
              reference_profile_w_m2=ref_p)
    ref = jq.build_divertor_profiles(**kw)
    ours = tq.build_divertor_profiles(**kw, **KW)
    assert rel(ours["predicted_profile_w_m2"], ref["predicted_profile_w_m2"]) <= 1e-12
    assert np.array_equal(ours["reference_profile_w_m2"], ref["reference_profile_w_m2"])
    assert abs(ours["cooling_gain_pct"] - ref["cooling_gain_pct"]) <= 1e-12 * abs(
        ref["cooling_gain_pct"])
    for group in ("two_fluid_diag", "divertor_state"):
        for key, v in ref[group].items():
            assert abs(ours[group][key] - v) <= 1e-12 * abs(v), key
    assert 0.1 < ours["cooling_gain_pct"] < 30.0
    assert ours["two_fluid_diag"]["electron_temp_mean_kev"] > 2.0
    with pytest.raises(ValueError):
        tq.jet_solps_reference_profile(JET_STATS, 8)


@pytest.mark.parametrize("flux", [8.5e5, 8.5e7])
def test_tbr_calibration_matches_jax(flux):
    kw = dict(mean_heat_flux_w_m2=flux, thickness_cm=260.0, asdex_erosion_ref_mm_year=0.25)
    ref = jq.calibrate_tbr_with_erosion(**kw)
    ours = tq.calibrate_tbr_with_erosion(**kw, **KW)
    assert ours.keys() == ref.keys()
    for key, v in ref.items():
        if isinstance(v, bool):
            assert ours[key] is v, key
        else:
            assert abs(ours[key] - v) <= 1e-12 * abs(v), key
    assert ours["calibrated_tbr"] <= ours["raw_tbr"] + 1e-9
    assert 0.0 < ours["calibration_factor"] <= 1.0


def test_force_balance_gates_on_port_draws():
    """``tests/test_quasi3d.py``'s and the contract lane's gates on the port's
    own draws."""
    obs = tq.quasi_3d_force_balance(torch.Generator().manual_seed(0),
                                    base=ts.StellaratorConfig(**BASE),
                                    stellar=ts.StellaratorConfig(**STELLAR), samples=512, **KW)
    assert 0.0 < float(obs.force_balance_rmse_pct) < 20.0
    assert float(obs.n1_amp) == pytest.approx(0.057, rel=0.05)
    assert float(obs.asymmetry_index) > 0.01 and float(obs.radial_spread_m) > 0.0
    flat = tq.quasi_3d_force_balance(torch.Generator().manual_seed(1),
                                     base=ts.StellaratorConfig(**BASE),
                                     stellar=ts.StellaratorConfig(**BASE), samples=256, **KW)
    assert float(flat.force_balance_rmse_pct) < 1e-4 and float(flat.n1_amp) < 1e-6
    m2, p2 = tq.solve_quasi_3d_force_residual(0.06, 0.057, 0.002, iterations=2, **KW)
    m14, p14 = tq.solve_quasi_3d_force_residual(0.06, 0.057, 0.002, iterations=14, **KW)
    assert float(p14) < float(p2) and 0.0 < float(m14) < float(p14)


def test_geqdsk_stats_match_jax():
    from scpn_fusion_tpu.io.geqdsk import read_geqdsk as jread
    from scpn_fusion_tpu_torch.io.geqdsk import read_geqdsk as tread
    path = Path(__file__).resolve().parents[1] / "fuzz/seeds/geqdsk/sparc_lmode_hv.geqdsk"
    assert tq.geqdsk_profile_stats(tread(path)) == jq.geqdsk_profile_stats(jread(path))


def test_package_exports_and_default_device():
    for name in ("build_divertor_profiles", "calibrate_tbr_with_erosion", "hall_mhd_zonal_ratio",
                 "jet_solps_reference_profile", "quasi_3d_force_balance",
                 "solve_quasi_3d_force_residual", "two_fluid_temhd_coupled_profile"):
        assert getattr(tphys, name) is getattr(tq, name)
    with pytest.raises(AttributeError):
        tphys.not_a_name    # noqa: B018
    g = torch.Generator().manual_seed(0)
    for run in (lambda: tq.quasi_3d_force_balance(g, base=ts.StellaratorConfig(**BASE),
                                                  stellar=ts.StellaratorConfig(**STELLAR)),
                lambda: tq.solve_quasi_3d_force_residual(0.06, 0.057, 0.002),
                lambda: tq.calibrate_tbr_with_erosion(mean_heat_flux_w_m2=8.5e5,
                                                      thickness_cm=260.0,
                                                      asdex_erosion_ref_mm_year=0.25)):
        with pytest.raises((RuntimeError, AssertionError)):
            run()
