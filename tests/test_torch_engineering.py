"""Port parity: balance of plant, thermal hydraulics, the carried-over
direct-energy module, the HTS quench screen with row H's plain twin
(``ops/cuda_quench.quench_run_plain``), and the CAD loading raytrace
(``models/engineering``).

``plant_performance`` is float32 in both (JAX casts its inputs): within
1e-6 relative of JAX's.  In float64 on the CPU the pumping powers, the
friction factors and the CAD loads are within 1e-9 of JAX's, the quench
transients within 1e-12 of each trace's scale; the quench reports' verdicts
and failure lists and the occlusion masks are equal (on the JAX test's two
squares and on a random mesh of 300 small faces).  ``torch.autograd``
agrees with ``jax.grad`` of the pumping power in the pipe diameter at 1e-12.
The gates of ``tests/test_engineering.py``, ``test_hts_bop.py``,
``test_thermal_hydraulics.py`` and the CAD cases of
``test_cad_fueling_torax.py`` hold for the port.  ``direct_energy`` equals
its source line for line.  Row H's plain twin equals the module's step
looped by hand; its argument block lists the C struct field for field, and
an input that requires a gradient raises.
"""

import difflib
import struct
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np, c_struct_fields, ctypes_fields, rel

from scpn_fusion_tpu.models.engineering import balance_of_plant as jbop
from scpn_fusion_tpu.models.engineering import cad_raytrace as jcad
from scpn_fusion_tpu.models.engineering import direct_energy as jdec
from scpn_fusion_tpu.models.engineering import hts_quench as jq
from scpn_fusion_tpu.models.engineering import thermal_hydraulics as jth
from scpn_fusion_tpu_torch.models import engineering as teng
from scpn_fusion_tpu_torch.models.engineering import balance_of_plant as tbop
from scpn_fusion_tpu_torch.models.engineering import cad_raytrace as tcad
from scpn_fusion_tpu_torch.models.engineering import direct_energy as tdec
from scpn_fusion_tpu_torch.models.engineering import hts_quench as tq
from scpn_fusion_tpu_torch.models.engineering import thermal_hydraulics as tth
from scpn_fusion_tpu_torch.ops import cuda_quench as cq

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-9
QUENCH_TOL = 1e-12   # of each trace's scale, float64
F32_TOL = 1e-6       # plant_performance: float32 in both
F64 = torch.float64
CPU = dict(dtype=F64, device="cpu")


def _same(ours, ref, tol):
    for name in ref._fields:
        assert rel(getattr(ours, name), getattr(ref, name)) <= tol, name


# ── balance of plant ─────────────────────────────────────────────────────


@pytest.mark.parametrize("p_fus, p_aux", [(500.0, 50.0), (2500.0, 80.0), (1000.0, 50.0),
                                          (2000.0, 50.0), (50.0, 50.0), (300.0, 0.0)])
def test_plant_performance_matches_jax(p_fus, p_aux):
    ours = tbop.plant_performance(p_fus, p_aux, device="cpu")
    assert ours.p_net_mw.dtype == torch.float32
    _same(ours, jbop.plant_performance(p_fus, p_aux), F32_TOL)


def test_plant_scan_and_coolants_match_jax():
    p_fus = np.linspace(100.0, 3000.0, 16)
    ref = jax.vmap(lambda p: jbop.plant_performance(p, 50.0))(jnp.asarray(p_fus))
    ours = tbop.plant_performance(torch.from_numpy(p_fus), 50.0)
    _same(ours, ref, F32_TOL)
    for coolant in ("water", "helium", "flibe"):
        params = tbop.PlantParams(coolant=coolant)
        ref_p = jbop.PlantParams(coolant=coolant)
        assert rel(tbop.pumping_power(2000.0, params, **CPU),
                   jbop.pumping_power(2000.0, ref_p)) <= TOL
        got = tbop.CoolantLoop(coolant, **CPU).calculate_pumping_power(2000.0)
        want = jbop.CoolantLoop(coolant).calculate_pumping_power(2000.0)
        assert got["mdot_kg_s"] == want["mdot_kg_s"]
        assert rel(got["P_pump_MW"], want["P_pump_MW"]) <= TOL
    for re in (500.0, 5e4, 1e5):
        assert rel(tbop.churchill_friction_factor(re, **CPU),
                   jbop.churchill_friction_factor(re)) <= 1e-12


class TestBalanceOfPlantGates:
    """tests/test_engineering.py:24-68 and test_hts_bop.py:49-87 on the port."""

    def test_iter_like_plant_is_net_negative(self):
        perf = tbop.plant_performance(500.0, 50.0, device="cpu")
        assert float(perf.q_plasma) == pytest.approx(10.0)
        assert float(perf.p_net_mw) < 100.0

    def test_reactor_scale_plant_is_net_positive(self):
        perf = tbop.plant_performance(2500.0, 80.0, device="cpu")
        assert float(perf.p_net_mw) > 300.0
        assert float(perf.q_engineering) > 1.0

    def test_energy_conservation_and_bookkeeping(self):
        perf = tbop.plant_performance(1000.0, 50.0, device="cpu")
        assert float(perf.p_gross_mw) < float(perf.p_thermal_mw)
        assert float(perf.p_thermal_mw) == pytest.approx(0.8 * 1000 * 1.15 + 0.2 * 1000 + 50)
        perf = tbop.plant_performance(2000.0, 50.0, device="cpu")
        assert float(perf.p_thermal_mw) == pytest.approx(2290.0, rel=1e-5)
        assert float(perf.p_gross_mw) == pytest.approx(2290.0 * 0.35, rel=1e-5)
        assert float(perf.p_net_mw) < float(perf.p_gross_mw)
        assert float(perf.q_plasma) == pytest.approx(40.0, rel=1e-5)
        assert float(perf.q_engineering) > 1.0
        assert float(tbop.plant_performance(50.0, 50.0, device="cpu").p_net_mw) < 0.0

    def test_operating_scan_is_monotone(self):
        net = tbop.plant_performance(torch.linspace(100.0, 3000.0, 16), 50.0).p_net_mw.numpy()
        assert net.shape == (16,) and np.all(np.diff(net) > 0)

    def test_coolant_loop_facade_and_pumping(self):
        for coolant in ("water", "helium", "flibe"):
            out = tbop.CoolantLoop(coolant, device="cpu").calculate_pumping_power(2000.0)
            assert out["P_pump_MW"] > 0.0 and out["mdot_kg_s"] > 0.0
        with pytest.raises(ValueError, match="unknown coolant"):
            tbop.PlantParams(coolant="mercury")
        p1, p2 = (float(tbop.pumping_power(p, tbop.PlantParams(), device="cpu"))
                  for p in (500.0, 1000.0))
        assert 0.0 < p1 < p2

    def test_churchill_limits(self):
        f_lam = float(tbop.churchill_friction_factor(500.0, device="cpu"))
        assert f_lam == pytest.approx(64.0 / 500.0, rel=0.05)
        assert 0.01 < float(tbop.churchill_friction_factor(1e5, device="cpu")) < 0.03


# ── thermal hydraulics ───────────────────────────────────────────────────


@pytest.mark.parametrize("kw", [dict(), dict(coolant="helium", pipe_diameter_m=0.2),
                                dict(coolant="lipb", delta_t=80.0, pipe_length_m=40.0)])
def test_pumping_power_matches_jax(kw):
    _same(tth.pumping_power(500.0, **kw, **CPU), jth.pumping_power(500.0, **kw), TOL)


def test_pumping_scan_and_gradient_match_jax():
    q = np.asarray([100.0, 300.0, 500.0])
    ref = jax.vmap(lambda qq: jth.pumping_power(qq, coolant="water"))(jnp.asarray(q))
    ours = tth.pumping_power(torch.from_numpy(q), coolant="water")
    _same(ours, ref, TOL)
    assert (np.diff(as_np(ours.p_pump_mw)) > 0.0).all()
    g_j = float(jax.grad(lambda d: jth.pumping_power(500.0, pipe_diameter_m=d).p_pump_mw)(0.05))
    d = torch.tensor(0.05, dtype=F64, requires_grad=True)
    g_t, = torch.autograd.grad(tth.pumping_power(500.0, pipe_diameter_m=d).p_pump_mw, d)
    assert abs(float(g_t) - g_j) <= 1e-12 * abs(g_j)
    assert np.isfinite(g_j) and float(g_t) < 0.0


class TestThermalHydraulicsGates:
    """tests/test_thermal_hydraulics.py on the port."""

    def test_churchill_laminar_turbulent_and_reference_formula(self):
        for re in (100.0, 500.0, 1000.0):
            f = float(tth.churchill_friction_factor(re, **CPU))
            np.testing.assert_allclose(f, 64.0 / re, rtol=0.05)
        assert 0.015 < float(tth.churchill_friction_factor(1e5, **CPU)) < 0.03
        re, eps = 5.0e4, 1e-4
        a = (2.457 * np.log(1.0 / ((7.0 / re) ** 0.9 + 0.27 * eps))) ** 16
        b = (37530.0 / re) ** 16
        expect = 8.0 * ((8.0 / re) ** 12 + 1.0 / (a + b) ** 1.5) ** (1.0 / 12.0)
        np.testing.assert_allclose(float(tth.churchill_friction_factor(re, eps, **CPU)), expect,
                                   rtol=1e-12)

    def test_water_loop_and_helium_penalty(self):
        res = tth.pumping_power(500.0, coolant="water", **CPU)
        np.testing.assert_allclose(float(res.mdot_kg_s), 2000.0, rtol=1e-12)
        assert float(res.reynolds) > 1e6 and float(res.p_pump_mw) > 0.0
        assert np.isfinite(float(res.dp_pa))
        w = tth.pumping_power(500.0, coolant="water", pipe_diameter_m=0.2, **CPU)
        he = tth.pumping_power(500.0, coolant="helium", pipe_diameter_m=0.2, **CPU)
        assert float(he.p_pump_mw) > 10.0 * float(w.p_pump_mw)
        assert tth.COOLANTS["lipb"]["rho"] == 9000.0 and tth.COOLANTS["helium"]["cp"] == 5190.0


# ── direct energy conversion (carried over) ──────────────────────────────


def test_direct_energy_copy_equals_its_source():
    path = Path("models") / "engineering" / "direct_energy.py"
    ours = (ROOT / "scpn_fusion_tpu_torch" / path).read_text().splitlines()
    ref = (ROOT / "scpn_fusion_tpu" / path).read_text().splitlines()
    differs = [(ref[i1:i2], ours[j1:j2]) for tag, i1, i2, j1, j2 in
               difflib.SequenceMatcher(None, ref, ours, autojunk=False).get_opcodes()
               if tag != "equal"]
    assert differs == []


@pytest.mark.parametrize("channel, fault", [
    ({}, {}), (dict(isolation_time_ms=300.0, max_unisolated_energy_mj=1.0), {}),
    (dict(bus_capacitance_f=1e-6), {}), ({}, dict(sensor_detection_latency_ms=100.0))])
def test_direct_energy_matches_jax_and_gates(channel, fault):
    ours = tdec.evaluate_direct_energy_conversion(tdec.DECChannel(**channel),
                                                  tdec.DECFault(**fault))
    ref = jdec.evaluate_direct_energy_conversion(jdec.DECChannel(**channel),
                                                 jdec.DECFault(**fault))
    assert ours == ref
    if not channel and not fault:      # tests/test_engineering.py:116-123
        assert ours.passed and ours.nominal_electric_power_mw == pytest.approx(500.0 * 0.2 * 0.6)
        assert ours.degraded_electric_power_mw < ours.nominal_electric_power_mw
    elif "isolation_time_ms" in channel:
        assert "unisolated_energy" in ours.failures
    elif channel:
        assert "bus_overvoltage" in ours.failures
    else:                              # run_whole_plant_fault.py lane 3's degraded case
        assert not ours.passed
    with pytest.raises(ValueError):
        tdec.DECChannel(charged_particle_fraction=1.5)
    with pytest.raises(ValueError):
        tdec.DECFault(load_rejection_fraction=-0.1)


# ── HTS quench and row H ─────────────────────────────────────────────────

QUENCH_CASES = {
    "default": ({}, {}),
    "degraded (run_whole_plant_fault.py lane 2)": (
        {}, dict(initial_normal_zone_m=1e-3, normal_zone_velocity_m_s=1e-3)),
    "weak dump": (dict(dump_resistance_ohm=0.002, coolant_heat_transfer_w_m2_k=0.0,
                       stabilizer_area_m2=4e-5),
                  dict(detection_delay_s=1.0, simulation_duration_s=8.0)),
    "low margin": (dict(operating_current_a=55_000.0), {}),
}


@pytest.mark.parametrize("case", list(QUENCH_CASES))
def test_quench_matches_jax(case):
    c_kw, s_kw = QUENCH_CASES[case]
    ref_tr = jq.simulate_quench_transient(jq.REBCOConductor(**c_kw), jq.QuenchScenario(**s_kw))
    tr = tq.simulate_quench_transient(tq.REBCOConductor(**c_kw), tq.QuenchScenario(**s_kw), **CPU)
    assert tr.current_a.dtype == F64 and tr.t.shape == ref_tr.t.shape
    _same(tr, ref_tr, QUENCH_TOL)
    ref = jq.evaluate_rebco_quench(jq.REBCOConductor(**c_kw), jq.QuenchScenario(**s_kw))
    rep = tq.evaluate_rebco_quench(tq.REBCOConductor(**c_kw), tq.QuenchScenario(**s_kw), **CPU)
    assert rep.passed == ref.passed and rep.failures == ref.failures
    for name, value in ref._asdict().items():
        if isinstance(value, float):
            assert abs(getattr(rep, name) - value) <= QUENCH_TOL * max(abs(value), 1.0), name


class TestQuenchGates:
    """tests/test_engineering.py:71-113 and test_hts_bop.py:21-47 on the port."""

    def test_tcs(self):
        c = tq.REBCOConductor()
        tcs = tq.current_sharing_temperature_k(c)
        assert tcs == pytest.approx(20.0 + 70.0 * (1.0 / 3.0), rel=1e-12)
        assert c.operating_temperature_k < tcs < c.critical_temperature_k

    def test_transient_decays_after_detection(self):
        c, s = tq.REBCOConductor(), tq.QuenchScenario()
        tr = tq.simulate_quench_transient(c, s, **CPU)
        i, t = tr.current_a.numpy(), tr.t.numpy()
        tau = c.inductance_h / c.dump_resistance_ohm
        t_det = s.detection_delay_s + s.protection_switch_delay_s
        assert i[-1] == pytest.approx(c.operating_current_a * np.exp(-(t[-1] - t_det) / tau),
                                      rel=0.05)
        assert np.all(np.diff(i[t > t_det]) <= 1e-9)
        assert np.all(np.isfinite(tr.hotspot_k.numpy()))
        after = i[t > 0.2]
        assert after[-1] < after[0] and 0.3 * i[0] < i[-1] < i[0]
        assert float(tr.hotspot_k.max()) < 200.0

    def test_screens(self):
        rep = tq.evaluate_rebco_quench(**CPU)
        assert rep.passed and not rep.failures and rep.peak_hotspot_k < 200.0
        assert rep.current_after_1s_a < tq.REBCOConductor().operating_current_a
        for case, failure in (("weak dump", "hotspot_temperature_limit"),
                              ("low margin", "critical_current_margin"),
                              ("degraded (run_whole_plant_fault.py lane 2)",
                               "detection_voltage_below_threshold")):
            c_kw, s_kw = QUENCH_CASES[case]
            bad = tq.evaluate_rebco_quench(tq.REBCOConductor(**c_kw), tq.QuenchScenario(**s_kw),
                                           **CPU)
            assert not bad.passed and failure in bad.failures, case
        for kw in (dict(critical_temperature_k=10.0), dict(operating_current_a=70_000.0),
                   dict(inductance_h=0.0)):
            with pytest.raises(ValueError):
                tq.REBCOConductor(**kw)


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_quench_run_plain_is_the_module_loop(dtype):
    s = tq.QuenchScenario(n_steps=300)
    values = tq.quench_values(tq.REBCOConductor(), s)
    c = tq.step_constants(values, dtype, "cpu")
    got = cq.quench_run_plain(c, s.n_steps)
    carry, rows = (c["i0"], c["temp0"]), []
    for k in range(s.n_steps):
        carry, row = tq.quench_step(c, carry, torch.tensor(k, dtype=dtype) * c["dt"])
        rows.append(row)
    assert all(torch.equal(a, torch.stack(b)) for a, b in zip(got, zip(*rows)))
    assert got[0].dtype == dtype
    tr = tq.simulate_quench_transient(tq.REBCOConductor(), s, dtype=dtype, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tr, got))


def test_row_h_refuses_gradients_and_host_tensors():
    values = tq.quench_values(tq.REBCOConductor(), tq.QuenchScenario())
    c = tq.step_constants(values, F64, "cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        cq.check_inputs(c)
    c["inductance"].requires_grad_()
    with pytest.raises(RuntimeError, match="requires a gradient"):
        cq.check_inputs(c)


def test_row_h_argument_block_lists_the_c_source():
    src = (ROOT / "scpn_fusion_tpu_torch" / "csrc" / "quench.cu").read_text()
    assert ctypes_fields(cq._Args) == c_struct_fields(src, "QuenchArgs")
    values = tq.quench_values(tq.REBCOConductor(), tq.QuenchScenario())
    assert set(cq.VALUES) == set(values)
    args, traces = cq.launch_args(values, F64, "cpu", 2000)
    assert args.n_steps == 2000 and args.h_pw == 200.0 * 0.12 and len(traces) == 5


def test_engineering_exports_match_jax():
    from scpn_fusion_tpu.models import engineering as jeng
    assert teng.__all__ == jeng.__all__
    assert all(hasattr(teng, name) for name in teng.__all__)


# ── CAD loading ──────────────────────────────────────────────────────────


def _unit_square_mesh():
    vertices = np.asarray([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], dtype=float)
    return vertices, np.asarray([[0, 1, 2], [0, 2, 3]])


def _two_squares():
    v0, f0 = _unit_square_mesh()
    return np.vstack([v0, v0 + np.asarray([0.0, 0.0, 1.0])]), np.vstack([f0, f0 + 4])


def _random_mesh(n_faces: int, seed: int = 7):
    """Small triangles scattered in a box: some shadowed, some not."""
    g = np.random.default_rng(seed)
    centres = g.uniform(-1.0, 1.0, (n_faces, 1, 3))
    vertices = (centres + g.uniform(-0.12, 0.12, (n_faces, 3, 3))).reshape(-1, 3)
    return vertices, np.arange(3 * n_faces).reshape(-1, 3)


def test_occlusion_masks_equal_jax(monkeypatch):
    src = np.asarray([[0.5, 0.5, 3.0], [0.2, -0.3, 2.5]])
    for vertices, faces in (_two_squares(), _random_mesh(300)):
        tris = vertices[faces]
        cen_j = jnp.mean(jnp.asarray(tris), axis=1)
        tris_t = torch.from_numpy(tris)
        cen_t = tcad.xla_mean(tris_t, dim=1)
        for p in src:
            ref = np.asarray(jcad._occlusion_mask(jnp.asarray(p), cen_j, jnp.asarray(tris),
                                                  jnp.asarray(1e-9)))
            eps = torch.tensor(1e-9, dtype=F64)
            got = tcad._occlusion_mask(torch.from_numpy(p), cen_t, tris_t, eps).numpy()
            assert np.array_equal(got, ref)
            monkeypatch.setattr(tcad, "OCCLUSION_PAIRS", 1000)   # chunks of 3 faces
            assert np.array_equal(
                tcad._occlusion_mask(torch.from_numpy(p), cen_t, tris_t, eps).numpy(), ref)
            monkeypatch.undo()
    assert 0 < ref.sum() < len(ref)


def test_surface_loading_matches_jax():
    vertices, faces = _random_mesh(300, seed=11)
    src = np.asarray([[0.1, 0.2, 3.0], [2.0, -1.0, 0.5]])
    power = np.asarray([100.0, 50.0])
    for cull in (False, True):
        ref = jcad.estimate_surface_loading(vertices, faces, src, power, occlusion_cull=cull)
        ours = tcad.estimate_surface_loading(vertices, faces, src, power, occlusion_cull=cull,
                                             **CPU)
        assert rel(ours.face_loading_w_m2, ref.face_loading_w_m2) <= TOL
        assert np.array_equal(ours.face_loading_w_m2 == 0.0, ref.face_loading_w_m2 == 0.0)
        assert abs(ours.peak_loading_w_m2 - ref.peak_loading_w_m2) <= TOL * ref.peak_loading_w_m2


class TestCADGates:
    """The CAD cases of tests/test_cad_fueling_torax.py:38-108 on the port."""

    def test_stl_round_trips_and_validation(self, tmp_path):
        path = tmp_path / "tri.stl"
        path.write_text("solid t\nfacet normal 0 0 1\nouter loop\nvertex 0 0 0\nvertex 1 0 0\n"
                        "vertex 0 1 0\nendloop\nendfacet\nendsolid t\n")
        v, f = tcad.load_cad_mesh(path)
        assert v.shape == (3, 3) and f.shape == (1, 3)
        blob = b"\x00" * 80 + struct.pack("<I", 1) + struct.pack("<3f", 0, 0, 1)
        for row in np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32):
            blob += struct.pack("<3f", *row)
        path = tmp_path / "tri_bin.stl"
        path.write_bytes(blob + b"\x00\x00")
        assert tcad.load_cad_mesh(path)[0].shape == (3, 3)
        bad = tmp_path / "bad.stl"
        bad.write_bytes(b"\x00" * 80 + struct.pack("<I", 5) + b"\x00" * 10)
        with pytest.raises(ValueError, match="truncated"):
            tcad.load_cad_mesh(bad)
        with pytest.raises(ValueError, match="non-degenerate"):
            tcad.validate_mesh(np.asarray([[0, 0, 0], [1, 0, 0], [2, 0, 0]], float),
                               np.asarray([[0, 1, 2]]))

    def test_inverse_square_and_cosine(self):
        v, f = _unit_square_mesh()
        rep = tcad.estimate_surface_loading(v, f, np.asarray([[0.5, 0.5, 2.0]]),
                                            np.asarray([100.0]), **CPU)
        expect = 100.0 / (4 * np.pi * 2.0**2)
        assert rep.face_loading_w_m2 == pytest.approx([expect, expect], rel=0.1)

    def test_occlusion_shadows_back_plate(self):
        vertices, faces = _two_squares()
        src, power = np.asarray([[0.5, 0.5, 3.0]]), np.asarray([100.0])
        plain = tcad.estimate_surface_loading(vertices, faces, src, power, **CPU)
        culled = tcad.estimate_surface_loading(vertices, faces, src, power, occlusion_cull=True,
                                               **CPU)
        assert culled.face_loading_w_m2[0] == 0.0 and culled.face_loading_w_m2[1] == 0.0
        np.testing.assert_allclose(culled.face_loading_w_m2[2:], plain.face_loading_w_m2[2:],
                                   rtol=1e-6)
        assert plain.face_loading_w_m2[0] > 0.0

    def test_input_validation(self):
        v, f = _unit_square_mesh()
        with pytest.raises(ValueError, match="shape"):
            tcad.estimate_surface_loading(v, f, np.zeros((1, 2)), np.ones(1), **CPU)
        with pytest.raises(ValueError, match="non-negative"):
            tcad.estimate_surface_loading(v, f, np.zeros((1, 3)), np.asarray([-1.0]), **CPU)


def test_default_device_is_the_card():
    """With no ``device`` the entry points run on CUDA; without a card they
    raise instead of falling back to the CPU."""
    calls = (lambda: tbop.plant_performance(500.0, 50.0).p_net_mw,
             lambda: tq.simulate_quench_transient(tq.REBCOConductor(),
                                                  tq.QuenchScenario(n_steps=10)).current_a,
             lambda: tth.pumping_power(500.0).p_pump_mw)
    for call in calls:
        if torch.cuda.is_available():
            assert call().is_cuda
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                call()
