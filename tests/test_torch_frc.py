"""Port parity: the FRC rigid rotor (``models/physics/frc``), its tilt
diagnostics and audit (``frc_stability``), the C-2U table
(``frc_public``) and the Faraday recovery contract (``faraday_recovery``).

In float64 on the CPU every result is within 1e-9 of JAX's (the
dimensionless residuals of a cancellation -- force and pressure balance, the
flux closure -- within 1e-12 absolutely), and integer and bool results are
equal (regime codes, the ``*_ok`` fields, the overflow flags).  The radial grid equals JAX's eager ``jnp.linspace`` bit for bit at
256 and 512 points in float32 and float64, and ``jnp.gradient``'s edges are
reproduced.  The gates of ``tests/test_frc_stability.py``,
``test_faraday_recovery.py`` and the FRC cases of
``test_edge_orbits_frc.py:136-170`` hold for the port, and so do lanes 1-3
of ``validation/run_mif_frc.py`` at 512 points (the audit, the tilt
diagnostic against its dense numpy twin, Faraday recovery on a 800-step
compression trace at ``dt_s = 1e-7``).  The C-2U parser's gates (sha256,
monotone shots, positive and present columns) run on CSVs the tests write;
the real table is not in the repository, so its status is the blocked one.
"""

import hashlib
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np, rel

from scpn_fusion_tpu.models.physics import frc as jfrc
from scpn_fusion_tpu.models.physics import frc_public as jpub
from scpn_fusion_tpu.models.physics import frc_stability as jst
from scpn_fusion_tpu.models.physics import pulsed_compression as jpc
from scpn_fusion_tpu_torch.models.physics import frc as tfrc
from scpn_fusion_tpu_torch.models.physics import frc_public as tpub
from scpn_fusion_tpu_torch.models.physics import frc_stability as tst
from scpn_fusion_tpu_torch.models.physics import pulsed_compression as tpc

# the packages export the function faraday_recovery under the module's name
jfr = importlib.import_module("scpn_fusion_tpu.models.physics.faraday_recovery")
tfr = importlib.import_module("scpn_fusion_tpu_torch.models.physics.faraday_recovery")

TOL = 1e-9
F64 = torch.float64
CPU = dict(dtype=F64, device="cpu")
EQ_512 = dict(b_external_t=1.5, separatrix_radius_m=0.3, peak_density_m3=2e20, n_points=512)
EQ_256 = dict(b_external_t=0.5, separatrix_radius_m=0.3)
# dimensionless residuals of a cancellation (a total pressure that is constant, a flux
# rate against -EMF/N), held absolutely: their relative rounding grows as they shrink
NOISE = {"force_balance_residual": 1e-12, "pressure_balance_residual": 1e-12,
         "flux_derivative_residual_linf": 1e-12, "flux_derivative_residual_l2": 1e-12}
LEDGERS = ("thermal_energy_j", "compression_work_j", "radiated_loss_j", "ohmic_loss_j",
           "source_work_j")


def _same(ours, ref, label=""):
    """Field by field: bool and integer fields equal, floats within TOL."""
    for name, a, b in zip(ref._fields, ours, ref):
        b = np.asarray(b)
        if b.dtype == bool or np.issubdtype(b.dtype, np.integer):
            assert np.array_equal(a.cpu().numpy(), b), (label, name)
            assert a.dtype in (torch.bool, torch.int32) and (a.dtype == torch.bool) == (
                b.dtype == bool), (label, name, a.dtype)
        elif name in NOISE:
            assert abs(float(a) - float(b)) <= NOISE[name], (label, name, float(a), float(b))
        else:
            fin = np.isfinite(b)
            a = as_np(a)
            assert np.array_equal(np.isfinite(a), fin), (label, name)
            assert not fin.any() or rel(a[fin], b[fin]) <= TOL, (label, name, rel(a[fin], b[fin]))


@pytest.fixture(scope="module")
def eqs():
    return {n: (tfrc.solve_rigid_rotor(**kw, **CPU), jfrc.solve_rigid_rotor(**kw))
            for n, kw in ((512, EQ_512), (256, EQ_256))}


@pytest.mark.parametrize("n", [256, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_radial_grid_is_jax_eager_linspace(n, dtype):
    """The grid of ``frc.py:59-60``: the eager ``jnp.linspace`` call."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    ours = tfrc.solve_rigid_rotor(b_external_t=1.5, separatrix_radius_m=0.3, n_points=n,
                                  dtype=dtype, device="cpu")
    ref = jnp.linspace(0.0, 1.4 * 0.3, n, dtype=jdt)
    assert ours.rho.dtype == dtype and np.array_equal(ours.rho.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n", [256, 512])
def test_rigid_rotor_matches_jax(eqs, n):
    ours, ref = eqs[n]
    _same(ours, ref, n)


def test_rigid_rotor_gates(eqs):
    """``test_edge_orbits_frc.py`` ``TestFRC``: exact force balance, the null
    at r_s / sqrt(2), the reversed core."""
    eq = eqs[256][0]
    assert float(eq.force_balance_residual) < 1e-8
    rho, bz = eq.rho.numpy(), eq.b_z.numpy()
    null_idx = np.argmin(np.abs(bz[: len(bz) // 2 + 40]))
    np.testing.assert_allclose(rho[null_idx], 0.3 / np.sqrt(2), atol=0.01)
    assert bz[0] > 0 and bz[-1] < 0
    with pytest.raises(ValueError):
        tfrc.solve_rigid_rotor(b_external_t=0.0, separatrix_radius_m=0.3, **CPU)


def test_s_parameter_and_alfven(eqs):
    """Steinhauer's s against JAX and the dense clipped numpy twin (1e-6),
    its 1/sqrt(T) scaling, and the Alfven speed (``test_frc_stability.py:32-62``)."""
    eq, eq_j = eqs[512]
    for t_i in (400.0, 500.0, 800.0):
        s = float(tst.s_parameter(eq, t_i))
        assert s == pytest.approx(float(jst.s_parameter(eq_j, t_i)), rel=TOL)
    t_i, rho, b_z, r_s = 500.0, eq.rho.numpy(), eq.b_z.numpy(), float(eq.r_s)
    p_th = np.sqrt(2.0 * tst.DEUTERIUM_MASS_AMU * tst.ATOMIC_MASS_KG * t_i
                   * tst.ELEMENTARY_CHARGE_C)
    integrand = rho * tst.ELEMENTARY_CHARGE_C * np.abs(b_z) / p_th
    stop = int(np.searchsorted(rho, r_s, side="right"))
    twin = np.trapezoid(np.append(integrand[:stop], np.interp(r_s, rho, integrand)),
                        np.append(rho[:stop], r_s)) / r_s
    assert float(tst.s_parameter(eq, t_i)) == pytest.approx(twin, rel=1e-6)
    s1, s2 = float(tst.s_parameter(eq, 400.0)), float(tst.s_parameter(eq, 800.0))
    assert s1 / s2 == pytest.approx(np.sqrt(2.0), rel=1e-6)
    v = float(tst.alfven_speed_m_s(2.0, 1e20, **CPU))
    assert v == pytest.approx(float(jst.alfven_speed_m_s(2.0, 1e20)), rel=TOL)
    assert v == pytest.approx(2.0 / np.sqrt(tst.MU0 * 1e20 * tst.DEUTERIUM_MASS_AMU
                                            * tst.ATOMIC_MASS_KG), rel=1e-6)


def test_regime_ladder_and_report(eqs):
    codes = tst.rigid_body_flr_regime_code(torch.tensor([1.0, 2.0, 2.5, 3.5], dtype=F64))
    assert codes.dtype == torch.int32 and codes.tolist() == [0, 1, 2, 3]
    assert tst.regime_name(0) == "diamagnetic_flr_threshold_passed"
    assert tst.regime_name(3) == "mhd_tilt_susceptible"
    eq, eq_j = eqs[512]
    for t_i, e in ((500.0, 4.0), (50.0, 0.5), (5000.0, 8.0)):
        report = tst.tilt_mode_report(eq, t_i, e)
        _same(report, jst.tilt_mode_report(eq_j, t_i, e), (t_i, e))
    report = tst.tilt_mode_report(eq, 500.0, 4.0)
    v_a = float(tst.alfven_speed_m_s(eq.b_z.abs().max(), eq.density.max()))
    expect = tst.BELOVA_MHD_GROWTH_COEFFICIENT * v_a / (float(eq.r_s) * 4.0)
    assert float(report.growth_rate_s_inv) == pytest.approx(expect, rel=1e-6)
    assert float(report.alfven_transit_time_s) == pytest.approx(float(eq.r_s) * 4.0 / v_a,
                                                                rel=1e-6)
    assert report.elongation.dtype == F64
    stable, gamma = tst.tilt_mode_stable(eq, 500.0, 4.0)
    assert stable is False and float(gamma) > 0
    assert tst.belova_table1_acceptance_status() == jst.belova_table1_acceptance_status()
    assert tst.claim_boundary() == jst.claim_boundary()


# (t, R, T_i, n, B_ext) of test_frc_stability.py's trajectories: constant states,
# the self-similar pair, the overflowing pair
TRAJECTORIES = {
    "constant": (np.linspace(0.0, 1e-5, 16), [0.3] * 16, [500.0] * 16, [2e20] * 16, [1.5] * 16),
    "self-similar": ([0.0, 1e-6], [0.3, 0.15], [500.0, 2000.0], [2e20, 8e20], [1.5, 6.0]),
    "overflow": ([0.0, 1e6], [0.3, 0.3], [500.0, 500.0], [2e20, 2e20], [1.5, 1.5]),
}


@pytest.mark.parametrize("case", list(TRAJECTORIES))
def test_tilt_trajectory_matches_jax(eqs, case):
    eq, eq_j = eqs[512]
    cols = dict(zip(("t_s", "radius_m", "t_i_ev", "density_m3", "b_ext_t"), TRAJECTORIES[case]))
    ours = tst.tilt_trajectory_from_compression(
        eq, 500.0, 4.0, **{k: torch.tensor(v, dtype=F64) for k, v in cols.items()})
    ref = jax.jit(lambda e, c: jst.tilt_trajectory_from_compression(e, 500.0, 4.0, **c))(
        eq_j, {k: jnp.asarray(v) for k, v in cols.items()})
    _same(ours, ref, case)
    if case == "constant":
        gamma, t = float(ours.growth_rate_s_inv[0]), cols["t_s"]
        np.testing.assert_allclose(as_np(ours.cumulative_growth_integral), gamma * t, rtol=1e-5)
        assert not bool(ours.amplification_overflow_limited[0])
    elif case == "self-similar":
        s0 = float(ours.s_parameter[0])
        assert float(ours.s_parameter[1]) == pytest.approx(
            s0 * 0.5 * 4.0 * np.sqrt(0.25), rel=1e-6)
    else:
        assert bool(ours.amplification_overflow_limited[1])
        assert np.isfinite(float(ours.perturbation_amplification[1]))


def test_overflow_clamp_in_float32():
    """The clamp is ``log(finfo.max)`` of the working dtype.  In float32 that
    logarithm rounds up, so exp of it overflows: JAX's float32 amplification
    saturates at inf, and the port's does too (float64's stays finite)."""
    eq = tfrc.solve_rigid_rotor(**EQ_512, dtype=torch.float32, device="cpu")
    eq_j = jax.jit(lambda: jfrc.solve_rigid_rotor(**EQ_512, dtype=jnp.float32))()
    cols = dict(zip(("t_s", "radius_m", "t_i_ev", "density_m3", "b_ext_t"),
                    TRAJECTORIES["overflow"]))
    tr = tst.tilt_trajectory_from_compression(
        eq, 500.0, 4.0, **{k: torch.tensor(v, dtype=torch.float32) for k, v in cols.items()})
    ref = jax.jit(lambda e, c: jst.tilt_trajectory_from_compression(e, 500.0, 4.0, **c))(
        eq_j, {k: jnp.asarray(v, jnp.float32) for k, v in cols.items()})
    assert tr.perturbation_amplification.dtype == torch.float32
    assert bool(tr.amplification_overflow_limited[1]) and bool(ref.amplification_overflow_limited[1])
    assert float(tr.cumulative_growth_integral[1]) == pytest.approx(
        float(ref.cumulative_growth_integral[1]), rel=1e-6)
    assert np.array_equal(tr.perturbation_amplification.numpy(),
                          np.asarray(ref.perturbation_amplification))


def test_gradient_is_jax_gradient():
    f = np.random.default_rng(3).standard_normal(37)
    h = 0.0123
    ours = tst.gradient(torch.tensor(f), torch.tensor(h, dtype=F64))
    assert np.array_equal(ours.numpy(), np.asarray(jnp.gradient(jnp.asarray(f), jnp.asarray(h))))


def test_validate_rigid_rotor(eqs):
    """The audit against JAX's, its pass on the clean state (lane 1 of
    ``run_mif_frc.py``) and its catches (``test_frc_stability.py:143-157``)."""
    validate = jax.jit(jst.validate_rigid_rotor)
    for n in (256, 512):
        _same(tst.validate_rigid_rotor(eqs[n][0]), validate(eqs[n][1]), n)
    eq, eq_j = eqs[512]
    report = tst.validate_rigid_rotor(eq)
    assert bool(report.all_passed) and float(report.pressure_balance_residual) < 1e-3
    bad = eq._replace(pressure=torch.zeros_like(eq.pressure))
    _same(tst.validate_rigid_rotor(bad),
          validate(eq_j._replace(pressure=jnp.zeros_like(eq_j.pressure))), "bad")
    assert not bool(tst.validate_rigid_rotor(bad).pressure_balance_ok)
    b_z = eq.b_z.clone()
    b_z[3] = float("nan")
    assert not bool(tst.validate_rigid_rotor(eq._replace(b_z=b_z)).all_passed)


# ---- C-2U table ----

HEADER = "shot,Eth(kJ),Fp(mWb),T(keV),t_max(ms),P_max(MW),E_max(kJ),comment\n"
ROWS = ("46366,9.5,5.2,0.62,1.8,1.9,10.4, first\n"
        "46371,11.0,5.9,0.71,2.4,2.6,12.1,second \n"
        "46402,12.5,6.3,0.75,3.1,3.0,13.0,third\n")


def _write(tmp_path, body, name="c2u.csv"):
    path = tmp_path / name
    path.write_text("# C-2U positive heating\n" + HEADER + body)
    return path


def _metadata(monkeypatch, tmp_path, sha):
    meta = tmp_path / "c2u.metadata.json"
    meta.write_text(json.dumps({"source_sha256": sha}))
    monkeypatch.setattr(tpub, "C2U_METADATA", meta)
    monkeypatch.setattr(jpub, "C2U_METADATA", meta)
    return meta


def test_c2u_table_matches_jax(tmp_path, monkeypatch):
    path = _write(tmp_path, ROWS)
    _metadata(monkeypatch, tmp_path, hashlib.sha256(path.read_bytes()).hexdigest())
    ours, ref = tpub.load_c2u_table(path, **CPU), jpub.load_c2u_table(path)
    assert ours.comments == ref.comments == ("first", "second", "third")
    assert ours.shot.dtype == torch.int32 and ours.shot.tolist() == np.asarray(ref.shot).tolist()
    for name in ref._fields[1:-1]:
        assert np.array_equal(as_np(getattr(ours, name)), np.asarray(getattr(ref, name))), name
    assert np.array_equal(as_np(ours.energy_per_flux_j_per_wb),
                          np.asarray(ref.energy_per_flux_j_per_wb))
    assert tpub.c2u_regime_screen(ours) == jpub.c2u_regime_screen(ref)
    assert tpub.c2u_reference_status(path, **CPU) == jpub.c2u_reference_status(path)


@pytest.mark.parametrize("body, match", [
    ("46371,11.0,5.9,0.71,2.4,2.6,12.1,a\n46366,9.5,5.2,0.62,1.8,1.9,10.4,b\n",
     "strictly increasing"),
    ("46366,9.5,-5.2,0.62,1.8,1.9,10.4,a\n", "Fp\\(mWb\\) must be positive"),
    ("46366,9.5,x,0.62,1.8,1.9,10.4,a\n", "must be numeric"),
    ("46366,9.5,5.2,0.62,1.8,1.9\n", "missing required"),
    ("", "at least one shot"),
])
def test_c2u_parser_gates(tmp_path, monkeypatch, body, match):
    path = _write(tmp_path, body)
    _metadata(monkeypatch, tmp_path, "")
    for load in (lambda: tpub.load_c2u_table(path, **CPU), lambda: jpub.load_c2u_table(path)):
        with pytest.raises(ValueError, match=match):
            load()


def test_c2u_sha256_gate_and_blocked_status(tmp_path, monkeypatch):
    path = _write(tmp_path, ROWS)
    _metadata(monkeypatch, tmp_path, "0" * 64)
    with pytest.raises(ValueError, match="sha256 mismatch"):
        tpub.load_c2u_table(path, **CPU)
    assert tpub.load_c2u_table(path, verify_sha256=False, **CPU).shot.shape == (3,)
    monkeypatch.undo()
    assert not tpub.C2U_CSV.exists()
    status = tpub.c2u_reference_status(**CPU)
    assert status == jpub.c2u_reference_status(tmp_path / "absent.csv")
    assert status["status"] == "blocked_missing_public_reference_artifact"


# ---- Faraday recovery ----

def test_central_derivative_and_emf():
    """Exact on quadratics over a non-uniform grid; the closed-form EMF and
    flux (``test_faraday_recovery.py:23-41``); against JAX."""
    t = np.sort(np.concatenate([np.linspace(0, 1, 9), [0.013, 0.37, 0.81]]))
    y = 3.0 * t**2 - 2.0 * t + 0.5
    ours = tfr.central_derivative(torch.tensor(t), torch.tensor(y))
    assert rel(ours, jfr.central_derivative(jnp.asarray(t), jnp.asarray(y))) <= TOL
    np.testing.assert_allclose(ours.numpy(), 6.0 * t - 2.0, rtol=1e-10)
    emf = float(tfr.faraday_back_emf(0.2, 1.5, -10.0, 50.0, 8))
    assert emf == pytest.approx(-8 * np.pi * (0.2**2 * 50.0 + 2.0 * 1.5 * 0.2 * (-10.0)),
                                rel=1e-12)
    assert float(tfr.magnetic_flux_wb(0.2, 1.5)) == pytest.approx(1.5 * np.pi * 0.04, rel=1e-12)


def _analytic():
    t = np.linspace(0.0, 1e-3, 201)
    return t, 0.3 - 100.0 * t**2, 1.0 + 4000.0 * t


def test_faraday_recovery_matches_jax():
    t, r, b = _analytic()
    kw = dict(n_turns=4, coil_resistance_ohm=0.5)
    ours = tfr.faraday_recovery(torch.tensor(t), torch.tensor(r), torch.tensor(b), **kw,
                                d_radius_dt_m_s=torch.tensor(-200.0 * t),
                                d_b_ext_dt_t_s=torch.full((201,), 4000.0, dtype=F64))
    ref = jax.jit(lambda *a: jfr.faraday_recovery(*a[:3], **kw, d_radius_dt_m_s=a[3],
                                                  d_b_ext_dt_t_s=a[4]))(
        jnp.asarray(t), jnp.asarray(r), jnp.asarray(b), jnp.asarray(-200.0 * t),
        jnp.full((201,), 4000.0))
    _same(ours, ref, "analytic")
    assert float(ours.flux_derivative_residual_linf) < 1e-6
    assert float(ours.recovered_energy_j) == pytest.approx(
        np.trapezoid(ours.load_power_w.numpy(), t), rel=1e-12)
    t = np.linspace(0.0, 1e-3, 64)
    r, b = 0.3 * np.exp(-t / 1e-3), 1.0 + 2000.0 * t
    kw = dict(n_turns=2, coil_resistance_ohm=1.0)
    _same(tfr.faraday_recovery(torch.tensor(t), torch.tensor(r), torch.tensor(b), **kw),
          jax.jit(lambda *a: jfr.faraday_recovery(*a, **kw))(
              jnp.asarray(t), jnp.asarray(r), jnp.asarray(b)), "fd")


def test_budget_gates():
    """Fail-closed without work, pass and fail with it, and the input checks
    (``test_faraday_recovery.py:65-112``)."""
    t = np.linspace(0.0, 1e-3, 32)
    args = (torch.tensor(t), torch.tensor(0.3 - 50.0 * t**2), torch.tensor(1.0 + 1000.0 * t))
    kw = dict(n_turns=2, coil_resistance_ohm=1.0)
    rep = tfr.integrated_recovery_energy(*args, **kw)
    assert rep.budget_claim_status == "blocked_missing_compression_work"
    assert rep.energy_budget_passed is None
    assert rep.source_budget_claim_status == "blocked_missing_coil_source_work"
    recovered = float(rep.result.recovered_energy_j)
    ok = tfr.integrated_recovery_energy(*args, **kw, compression_work_j=recovered * 1.001)
    assert ok.energy_budget_passed is True and ok.budget_claim_status == "passed"
    bad = tfr.integrated_recovery_energy(*args, **kw, compression_work_j=recovered * 10.0)
    assert bad.energy_budget_passed is False and bad.budget_claim_status == "failed"
    with pytest.raises(ValueError, match="strictly increasing"):
        tfr.integrated_recovery_energy(torch.tensor([0.0, 1.0, 0.5]), torch.ones(3),
                                       torch.ones(3), n_turns=1, coil_resistance_ohm=1.0)
    with pytest.raises(ValueError, match="positive"):
        tfr.integrated_recovery_energy(torch.tensor([0.0, 1.0]), torch.tensor([0.1, -0.1]),
                                       torch.ones(2), n_turns=1, coil_resistance_ohm=1.0)
    with pytest.raises(ValueError, match="n_turns"):
        tfr.integrated_recovery_energy(torch.tensor([0.0, 1.0]), torch.ones(2), torch.ones(2),
                                       n_turns=0, coil_resistance_ohm=1.0)


def test_recovery_from_compression_matches_jax():
    """The 800-step compression of ``test_faraday_recovery.py:115-137`` and
    lane 3 of ``run_mif_frc.py``, its trace and the every field within 1e-9 (the energy ledgers of their
    common scale: without a loss channel the radiated one is rounding noise
    that XLA does not make exactly 0), the statuses equal, the
    closure passed and both budget gates evaluated."""
    coil = dict(n_turns=20, l_coil_m=1.0, resistance_ohm=5e-3, inductance_h=2e-6)
    cfg = dict(min_radius_m=0.02, gamma=5.0 / 3.0, plasma_mass_kg=2e-5)
    s0 = dict(radius_m=0.3, t_i_ev=100.0, t_e_ev=100.0, density_m3=5e19)
    cj = jpc.CompressionConfig(coil=jpc.CoilGeometry(**coil), **cfg)
    ct = tpc.CompressionConfig(coil=tpc.CoilGeometry(**coil), **cfg)
    trj = jpc.run_voltage_driven_compression(cj, jpc.initial_state(cj, **s0), lambda t: 400.0,
                                             n_steps=800, dt_s=1e-7)
    trt = tpc.run_voltage_driven_compression(ct, tpc.initial_state(ct, **s0, **CPU),
                                             lambda t: 400.0, n_steps=800, dt_s=1e-7)
    ledger = max(float(np.max(np.abs(np.asarray(getattr(trj.state, f))))) for f in LEDGERS)
    for name in jpc.CompressionState._fields:
        ours, ref_row = as_np(getattr(trt.state, name)), np.asarray(getattr(trj.state, name))
        scale = ledger if name in LEDGERS else np.max(np.abs(ref_row))
        assert np.max(np.abs(ours - ref_row)) <= TOL * scale, name
    assert rel(trt.b_ext_t, trj.b_ext_t) <= TOL
    ours = tfr.recovery_from_compression(trt, n_turns=8, coil_resistance_ohm=0.1)
    ref = jfr.recovery_from_compression(trj, n_turns=8, coil_resistance_ohm=0.1)
    _same(ours.result, ref.result, "adapter")
    for name in ("n_turns", "budget_claim_status", "source_budget_claim_status",
                 "flux_derivative_closure_passed", "energy_budget_passed",
                 "source_energy_budget_passed"):
        assert getattr(ours, name) == getattr(ref, name), name
    for name in ("compression_work_j", "energy_budget_relative_error", "coil_source_work_j",
                 "source_energy_budget_relative_error"):
        assert getattr(ours, name) == pytest.approx(getattr(ref, name), rel=TOL), name
    assert float(ours.result.recovered_energy_j) >= 0.0
    assert ours.flux_derivative_closure_passed
    assert ours.budget_claim_status in ("passed", "failed")
    assert ours.source_budget_claim_status in ("passed", "failed")


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    for call in (lambda: tfrc.solve_rigid_rotor(b_external_t=1.0, separatrix_radius_m=0.3),
                 lambda: tst.alfven_speed_m_s(2.0, 1e20)):
        with pytest.raises((RuntimeError, AssertionError)):
            call()
