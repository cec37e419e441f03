"""The carried-over host lanes on the CPU: the port's copy of the native C++
GS runtime (built with ``g++`` into ``scpn_fusion_tpu_torch/native/_build``)
against the port's NumPy twin ``utils/npref`` and the port's plain float64
``ops.stencil.sor_step`` -- lanes 1 and 2 of
``validation/run_implementation_parity.py`` (one sweep within 1e-13
span-relative; the converged solves pairwise within 1e-8 and each within
1.5x of the best error) -- and the port's own fallback telemetry counting
the port's archive and MAST fallbacks (the JAX package's ledger untouched),
its budget failing closed.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from scpn_fusion_tpu.utils import telemetry as jtel
from scpn_fusion_tpu_torch.io import archive, codac, mast
from scpn_fusion_tpu_torch.native import runtime as native_rt
from scpn_fusion_tpu_torch.ops.stencil import sor_step
from scpn_fusion_tpu_torch.utils import npref, telemetry


def _problem(n=65):
    """``run_implementation_parity.py:_problem`` and its perturbed start."""
    r_1d = np.linspace(2.0, 10.0, n)
    z_1d = np.linspace(-4.0, 4.0, n)
    d_r, d_z = float(r_1d[1] - r_1d[0]), float(z_1d[1] - z_1d[0])
    rr, zz = np.meshgrid(r_1d, z_1d)
    exact = np.exp(-((rr - 6.0) ** 2 + zz**2) / 3.0)
    source = npref.gs_operator_np(exact, r_1d, d_r, d_z)
    psi0 = exact + 0.1 * np.random.default_rng(42).standard_normal(exact.shape)
    psi0[0, :], psi0[-1, :] = exact[0, :], exact[-1, :]
    psi0[:, 0], psi0[:, -1] = exact[:, 0], exact[:, -1]
    return r_1d, d_r, d_z, exact, source, psi0


def _three(n_sweeps, omega=1.6):
    r_1d, d_r, d_z, exact, source, psi0 = _problem()
    out = psi0.copy()
    for _ in range(n_sweeps):
        out = npref.sor_step_np(out, source, r_1d, d_r, d_z, omega)
    solver = native_rt.NativeGSSolver(r_1d, d_r, d_z, nz=psi0.shape[0])
    solver.set_state(psi0, source)
    solver.set_boundary(exact)
    solver.sweeps(n_sweeps, omega=omega)
    t = torch.from_numpy(psi0.copy())
    s, r = torch.from_numpy(source), torch.from_numpy(r_1d)
    for _ in range(n_sweeps):
        t = sor_step(t, s, r, d_r, d_z, omega)
    span = float(exact.max() - exact.min())
    return {"numpy": out, "cpp": solver.psi, "torch": t.numpy()}, exact, span


def test_native_runtime_builds_from_the_port_copy():
    assert native_rt.is_available(), "g++ is expected on this host"
    lib = native_rt.build_library()
    assert lib is not None and Path(lib).parent == Path(native_rt.__file__).with_name("_build")


def test_one_sweep_trajectory_parity():
    sols, _, span = _three(1)
    for name in ("cpp", "torch"):
        assert float(np.max(np.abs(sols[name] - sols["numpy"]))) / span < 1e-13, name


def test_converged_cross_implementation():
    sols, exact, span = _three(4000)
    errs = {k: float(np.max(np.abs(v - exact))) / span for k, v in sols.items()}
    keys = sorted(sols)
    for i, a in enumerate(keys):
        for b in keys[i + 1:]:
            assert float(np.max(np.abs(sols[a] - sols[b]))) / span < 1e-8, (a, b)
    best = min(errs.values())
    assert all(e <= 1.5 * best + 1e-12 for e in errs.values()), errs


def test_port_telemetry_counts_the_port_fallbacks(tmp_path, monkeypatch):
    telemetry.TELEMETRY.reset()
    before = jtel.TELEMETRY.counts()
    prof = archive.load_machine_profiles("diiid", 123456, root=tmp_path)
    assert prof.source == "synthetic"
    archive.fetch_mdsplus_profiles("diiid", 123456)
    data, source = mast.MastIngestor(cache_dir=tmp_path / "mast").load_shot_summary(30420)
    assert source == "synthetic" and data["ip"].shape == (500,)
    counts = telemetry.TELEMETRY.counts()
    assert counts["archive.synthetic_profiles"] == 1
    assert counts["mast_ingestor.synthetic_shot_30420"] == 1
    assert counts["archive.mdsplus_unavailable"] == 1
    assert jtel.TELEMETRY.counts() == before
    # a budget fails closed in the port's ledger
    monkeypatch.setenv("SCPN_TPU_MAX_FALLBACK_EVENTS_ARCHIVE", "1")
    with pytest.raises(telemetry.FallbackBudgetExceeded):
        archive.load_machine_profiles("diiid", 123457, root=tmp_path)
    telemetry.TELEMETRY.reset()


def test_profiles_round_trip_and_codac_gateway(tmp_path):
    prof = archive.synthetic_machine_profiles("JET", 99)
    path = archive.save_reference_profiles(prof, root=tmp_path)
    back = archive.load_machine_profiles("JET", 99, root=tmp_path, allow_synthetic=False)
    assert path.exists() and np.array_equal(back.t_e_kev, prof.t_e_kev)
    gw = codac.PulseGateway()
    visited = gw.run_nominal_pulse()
    assert visited[0] is codac.PulseState.IDLE and gw.state is codac.PulseState.TERMINATED
    with pytest.raises(codac.CodacError):
        gw.transition(codac.PulseState.FLATTOP)
