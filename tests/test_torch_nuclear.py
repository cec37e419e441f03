"""Port parity: the breeding blanket, the TEMHD layer, wall loading and PWI
(``models/nuclear/{blanket, temhd, wall_loading, pwi}``).

In float64 on the CPU the TBRs, fluxes, TEMHD traces, wall loads and yields
are within 1e-9 of JAX's scale: the 3-group blanket at the reference
configuration and at 60 cm / 60 %, the 1-group blanket, the volumetric
surrogate at 8 x 16 x 12 and at its defaults (24 x 72 x 48), a
100-step transient and a 50-step scan of three fluxes (one batched
Thomas solve a step), the 65^2 wall-loading case of
``tests/test_temhd_wall.py`` with its material reports.  ``torch.autograd``
agrees with ``jax.grad`` of the sputtering yield at 1e-12.  The gates of
``tests/test_nuclear.py`` and ``test_temhd_wall.py`` hold for the port, the
TEMHD ones at reduced lengths named in each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np, rel

from scpn_fusion_tpu.models.nuclear import blanket as jbk
from scpn_fusion_tpu.models.nuclear import pwi as jpwi
from scpn_fusion_tpu.models.nuclear import temhd as jte
from scpn_fusion_tpu.models.nuclear import wall_loading as jwl
from scpn_fusion_tpu_torch.models import nuclear as tnuc
from scpn_fusion_tpu_torch.models.nuclear import blanket as tbk
from scpn_fusion_tpu_torch.models.nuclear import pwi as tpwi
from scpn_fusion_tpu_torch.models.nuclear import temhd as tte
from scpn_fusion_tpu_torch.models.nuclear import wall_loading as twl

TOL = 1e-9
F64 = torch.float64
CPU = dict(dtype=F64, device="cpu")


def _same(ours, ref, tol=TOL):
    for name, a, b in zip(ref._fields, ours, ref):
        assert rel(a, b) <= tol, (name, rel(a, b))


# ── blanket ──────────────────────────────────────────────────────────────


@pytest.mark.parametrize("cfg", [{}, dict(thickness_cm=60.0, li6_enrichment=0.6, n_cells=120)])
def test_multigroup_matches_jax(cfg):
    ours = tbk.multigroup_tbr(tbk.MultiGroupConfig(**cfg), **CPU)
    _same(ours, jbk.multigroup_tbr(jbk.MultiGroupConfig(**cfg)))


def test_single_group_and_volumetric_match_jax():
    _same(tbk.single_group_tbr(tbk.BlanketConfig(), **CPU), jbk.single_group_tbr(jbk.BlanketConfig()))
    _same(tbk.single_group_tbr(tbk.BlanketConfig(li6_enrichment=0.7), 5e13, 0.4, **CPU),
          jbk.single_group_tbr(jbk.BlanketConfig(li6_enrichment=0.7), 5e13, 0.4))
    cfg = dict(thickness_cm=250.0, li6_enrichment=0.9)
    cells = dict(radial_cells=8, poloidal_cells=16, toroidal_cells=12)
    _same(tbk.volumetric_tbr(tbk.BlanketConfig(**cfg), major_radius_m=5.5, minor_radius_m=1.7,
                             elongation=1.9, **cells, **CPU),
          jbk.volumetric_tbr(jbk.BlanketConfig(**cfg), major_radius_m=5.5, minor_radius_m=1.7,
                             elongation=1.9, **cells))
    _same(tbk.volumetric_tbr(tbk.BlanketConfig(), **CPU), jbk.volumetric_tbr(jbk.BlanketConfig()))


class TestBlanketGates:
    """tests/test_nuclear.py:23-70 on the port."""

    def test_multigroup_headline_tbr_and_fluxes(self):
        res = tbk.multigroup_tbr(tbk.MultiGroupConfig(), **CPU)
        np.testing.assert_allclose(float(res.tbr), 1.14, atol=0.02)
        pg = res.tbr_per_group.numpy()
        assert pg[2] > pg[1] > pg[0]
        np.testing.assert_allclose(pg.sum(), float(res.tbr), rtol=1e-6)
        phi = res.flux.numpy()
        assert phi.shape[0] == 3 and np.all(phi >= 0)
        assert phi[0, -1] < 0.05 * phi[0, 0]
        assert phi[1].max() > 0 and phi[2].max() > 0 and phi[2, 1:20].min() > 0

    def test_tbr_increases_with_enrichment(self):
        scan = tbk.enrichment_scan([0.3, 0.6, 0.9], **CPU).numpy()
        assert scan[2] > scan[1] > scan[0] > 0
        for e, tbr in zip((0.3, 0.6, 0.9), scan):
            assert tbr == float(tbk.multigroup_tbr(tbk.MultiGroupConfig(li6_enrichment=e),
                                                   **CPU).tbr)

    def test_single_group_breeding_and_validation(self):
        res = tbk.single_group_tbr(tbk.BlanketConfig(), **CPU)
        assert 1.0 < float(res.tbr) < 2.5 and bool(torch.all(res.flux >= 0))
        with pytest.raises(ValueError, match="Supercritical"):
            tbk.single_group_tbr(tbk.BlanketConfig(li6_enrichment=0.2), **CPU)
        with pytest.raises(ValueError):
            tbk.BlanketConfig(li6_enrichment=1.5)
        with pytest.raises(ValueError):
            tbk.BlanketConfig(thickness_cm=0.01)


# ── PWI ──────────────────────────────────────────────────────────────────


def test_pwi_matches_jax():
    for name in ("Tungsten", "Carbon"):
        mj, mt = jpwi.SputteringMaterial.from_name(name), tpwi.SputteringMaterial.from_name(name)
        e = np.asarray([20.0, 150.0, 250.0, 500.0, 2000.0, 1e4])
        angle = np.asarray([[0.0], [80.0], [95.0]])
        assert rel(tpwi.sputtering_yield(mt, torch.from_numpy(e), torch.from_numpy(angle)),
                   jpwi.sputtering_yield(mj, jnp.asarray(e), jnp.asarray(angle))) <= TOL
        ours = tpwi.erosion_rate(mt, 1e24, torch.from_numpy(e / 5.0))
        ref = jpwi.erosion_rate(mj, 1e24, jnp.asarray(e / 5.0))
        for key in ("Yield", "E_impact", "Net_Flux", "Erosion_mm_year", "Impurity_Source"):
            assert rel(ours[key], ref[key]) <= TOL, key
        for a, b in zip(tpwi.erosion_scan(mt, 1e24, 10.0, 100.0, 50, **CPU),
                        jpwi.erosion_scan(mj, 1e24, 10.0, 100.0, 50)):
            assert rel(a, b) <= TOL
    w_j, w_t = jpwi.SputteringMaterial.from_name("Tungsten"), tpwi.SputteringMaterial.from_name()
    g_j = float(jax.grad(lambda e: jpwi.sputtering_yield(w_j, e))(2000.0))
    e = torch.tensor(2000.0, dtype=F64, requires_grad=True)
    g_t, = torch.autograd.grad(tpwi.sputtering_yield(w_t, e), e)
    assert abs(float(g_t) - g_j) <= 1e-12 * abs(g_j) and g_j > 0


class TestPWIGates:
    """tests/test_nuclear.py:73-111 on the port."""

    def test_thresholds_and_materials(self):
        w = tpwi.SputteringMaterial.from_name("Tungsten")
        c = tpwi.SputteringMaterial.from_name("Carbon")
        assert float(tpwi.sputtering_yield(w, 100.0, **CPU)) == 0.0
        assert float(tpwi.sputtering_yield(w, 1000.0, **CPU)) > 0.0
        assert float(tpwi.sputtering_yield(c, 500.0, **CPU)) > float(
            tpwi.sputtering_yield(w, 500.0, **CPU))
        assert float(tpwi.sputtering_yield(w, 2000.0, angle_deg=80.0, **CPU)) > 2.0 * float(
            tpwi.sputtering_yield(w, 2000.0, angle_deg=0.0, **CPU))

    def test_erosion_rate_keys_redeposition_and_scan(self):
        w = tpwi.SputteringMaterial.from_name("Tungsten", redeposition_factor=0.95)
        res = tpwi.erosion_rate(w, 1e24, 100.0, **CPU)
        assert {"Yield", "E_impact", "Net_Flux", "Erosion_mm_year", "Impurity_Source"} <= set(res)
        assert float(res["E_impact"]) == pytest.approx(500.0)
        res0 = tpwi.erosion_rate(tpwi.SputteringMaterial.from_name("Tungsten", 0.0), 1e24, 100.0,
                                 **CPU)
        np.testing.assert_allclose(float(res["Net_Flux"]), 0.05 * float(res0["Net_Flux"]),
                                   rtol=1e-5)
        temps, erosion, _ = tpwi.erosion_scan(w, 1e24, 10.0, 100.0, 50, **CPU)
        erosion = erosion.numpy()
        assert erosion.shape == (50,) and erosion[0] == 0.0 and erosion[-1] > 0.0
        assert np.all(np.diff(erosion) >= -1e-12)


# ── TEMHD ────────────────────────────────────────────────────────────────


def test_temhd_matches_jax():
    pj, pt = jte.TEMHDParams(), tte.TEMHDParams()
    s_t = tte.temhd_step(pt, tte.init_temhd(pt, **CPU), 10.0, dt=0.05)
    ref = jte.run_temhd(pj, 10.0, dt=0.05, n_steps=100)
    ours = tte.run_temhd(pt, 10.0, dt=0.05, n_steps=100, **CPU)
    assert ours.surface_t_k.shape == (100,)
    # the transient's first step is temhd_step from the wall temperature
    assert torch.equal(ours.surface_t_k[0], s_t[1]) and torch.equal(ours.k_eff_max[0], s_t[2])
    for a, b in ((ours.surface_t_k, ref.surface_t_k), (ours.k_eff_max, ref.k_eff_max),
                 (ours.state.t_k, ref.state.t_k)):
        assert rel(a, b) <= TOL
    fluxes = np.asarray([1.0, 5.0, 20.0])
    for a, b in zip(tte.temhd_flux_scan(pt, torch.from_numpy(fluxes), n_steps=50, **CPU),
                    jte.temhd_flux_scan(pj, jnp.asarray(fluxes), n_steps=50)):
        assert rel(a, b) <= TOL


class TestTEMHDGates:
    """tests/test_temhd_wall.py:24-57 on the port."""

    def test_surface_heats_and_saturates(self):
        # 250 steps of 0.05 s (the JAX test runs 600; the change over the last
        # ten steps is ~4e-5 K at 250 and ~2e-12 K at 600)
        p = tte.TEMHDParams()
        t = tte.run_temhd(p, 10.0, dt=0.05, n_steps=250, **CPU).surface_t_k.numpy()
        assert t[-1] > p.t_wall_k + 5.0 and abs(t[-1] - t[-10]) < 1e-3
        assert np.all(np.isfinite(t))

    def test_te_convection_and_flux_scan(self):
        # 150 steps of 0.1 s (the JAX test runs 400 and its scan 200); each field one scan
        p, p0 = tte.TEMHDParams(b_field_t=10.0), tte.TEMHDParams(b_field_t=0.0)
        t_surf, k_enh = tte.temhd_flux_scan(p, torch.tensor([1.0, 5.0, 20.0], dtype=F64),
                                            n_steps=150, **CPU)
        t0_surf, k0 = tte.temhd_flux_scan(p0, torch.tensor([20.0], dtype=F64), n_steps=150,
                                          **CPU)
        assert float(k_enh[2]) > 1.05 and float(k0[0]) == pytest.approx(1.0, rel=1e-6)
        assert float(t_surf[2]) < float(t0_surf[0])
        t = t_surf.numpy()
        assert t[0] < t[1] < t[2] and np.all(k_enh.numpy() >= 1.0)


# ── wall loading ─────────────────────────────────────────────────────────


@pytest.fixture(scope="module")
def meshes():
    n = 65
    rr, zz = np.meshgrid(np.linspace(3.5, 9.0, n), np.linspace(-4.5, 4.5, n))
    src_j = jwl.neutron_source_density(jnp.asarray(rr), jnp.asarray(zz), p_fusion_mw=500.0)
    src_t = twl.neutron_source_density(torch.from_numpy(rr), torch.from_numpy(zz),
                                       p_fusion_mw=500.0)
    return (src_t, twl.compute_wall_loading(src_t, torch.from_numpy(rr), torch.from_numpy(zz)),
            src_j, jwl.compute_wall_loading(src_j, jnp.asarray(rr), jnp.asarray(zz)))


def test_wall_loading_matches_jax(meshes):
    src_t, lt, src_j, lj = meshes
    assert rel(src_t, src_j) <= TOL
    _same(lt, lj)
    for material in twl.MATERIALS:
        _same(twl.analyze_material(lt, material), jwl.analyze_material(lj, material))
    normals = twl.WallGeometry().normals(**CPU)
    for a, b in zip(normals, jwl.WallGeometry().normals()):
        assert rel(a, b) <= TOL
    for f in (0.0, 0.1, 0.3, 0.6):
        assert rel(twl.ash_poisoning_dilution(f, **CPU), jwl.ash_poisoning_dilution(f)) <= TOL


class TestWallGates:
    """tests/test_temhd_wall.py:60-98 on the port."""

    def test_iter_scale_nwl_and_outboard_peak(self, meshes):
        loading = meshes[1]
        nwl = loading.nwl_mw_m2.numpy()
        assert np.all(nwl >= 0.0) and 0.1 < nwl.mean() < 1.5
        assert 1.0 < float(loading.peaking_factor) < 4.0
        i_peak = int(np.argmax(nwl))
        r_w, z_w = loading.r_wall.numpy(), loading.z_wall.numpy()
        assert r_w[i_peak] > np.median(r_w) and abs(z_w[i_peak]) < 2.0

    def test_material_analysis_and_ash(self, meshes):
        loading = meshes[1]
        rep_w = twl.analyze_material(loading, "tungsten")
        rep_fe = twl.analyze_material(loading, "eurofer")
        assert isinstance(rep_w, twl.MaterialReport)
        assert float(rep_fe.lifetime_fpy) < float(rep_w.lifetime_fpy)
        assert np.all(rep_w.he_appm_per_fpy.numpy() >= 0.0)
        with pytest.raises(ValueError, match="unknown material"):
            twl.analyze_material(loading, "unobtainium")
        assert float(twl.ash_poisoning_dilution(0.0, **CPU)) == 1.0
        assert float(twl.ash_poisoning_dilution(0.1, **CPU)) == pytest.approx(0.64)
        assert float(twl.ash_poisoning_dilution(0.6, **CPU)) == 0.0


def test_nuclear_exports_match_jax():
    from scpn_fusion_tpu.models import nuclear as jnuc
    names = [n for n in dir(jnuc) if not n.startswith("_") and n not in (
        "temhd", "wall_loading", "heating_neutronics", "blanket", "pwi")]
    assert all(hasattr(tnuc, n) for n in names), names
    assert as_np(tnuc.ash_poisoning_dilution(0.1, **CPU)) == pytest.approx(0.64)
