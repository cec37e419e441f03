"""The port's ``ui/``: the Markdown dashboard against JAX's on the same
repository tree, the flux-map SVG against JAX's, and the live solve server
on the CPU (its three endpoints with the security headers, as
``tests/test_live_dashboard.py`` checks them, and its first tick's psi
against JAX's ``solve_equilibrium`` at 65^2 in float64).  The worker is
stopped and joined before each test ends.
"""

import functools
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scpn_fusion_tpu.models.equilibrium as jax_eq
from scpn_fusion_tpu.ui import dashboard as jax_dashboard
from scpn_fusion_tpu.ui import live_server as jax_live
from scpn_fusion_tpu.utils import telemetry as jax_telemetry
from scpn_fusion_tpu_torch.cli import main
from scpn_fusion_tpu_torch.ui import dashboard, live_server
from scpn_fusion_tpu_torch.utils import telemetry
from tests.torch_parity import span_rel

HEADINGS = {   # the port's heading -> JAX's (the lines that differ besides the timestamp)
    "# scpn_fusion_tpu_torch — mission dashboard": "# scpn_fusion_tpu — mission dashboard",
    "## Validation evidence (the port's campaigns, validation/reports_torch)":
        "## Validation evidence",
    "## Benchmark history (the JAX package's TPU record, not the port's)":
        "## Benchmark history",
}


def _repo(tmp_path):
    """A repository tree with one campaign report (in the JAX package's and
    the port's report directories) and one bench record."""
    rep = {"overall_status": "pass", "lanes": [{"name": "a", "status": "pass"},
                                               {"name": "b", "status": "fail"}]}
    for sub in ("reports", "reports_torch"):
        d = tmp_path / "validation" / sub
        d.mkdir(parents=True)
        (d / "demo.json").write_text(json.dumps(rep))
    (tmp_path / "BENCH_r01.json").write_text(json.dumps(
        {"metric": "solve", "value": 1.5, "unit": "ms", "vs_baseline": 3.0}))
    cfg = {"reactor_name": "dash", "grid_resolution": [33, 33],
           "dimensions": {"R_min": 2.0, "R_max": 10.0, "Z_min": -4.0, "Z_max": 4.0},
           "physics": {"plasma_current_target": 15.0, "vacuum_permeability": 1.0},
           "coils": [{"r": 8.0, "z": 4.8, "current": 4.0}, {"r": 10.8, "z": 0.0, "current": 6.0},
                     {"r": 8.0, "z": -4.8, "current": 4.0}],
           "solver": {"max_iterations": 200, "convergence_threshold": 1e-4,
                      "relaxation_factor": 0.1, "solver_method": "multigrid"}}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    return tmp_path


def test_dashboard_equals_jax_but_timestamp_and_headings(tmp_path, monkeypatch):
    """Each package's fallback telemetry is its process's: whatever earlier
    tests in this process recorded, both dashboards are given one count."""
    repo = _repo(tmp_path)
    for registry in (jax_telemetry.TELEMETRY, telemetry.TELEMETRY):
        monkeypatch.setattr(registry, "counts", lambda: {"demo.fallback": 2})
    ours = dashboard.generate_dashboard(
        tmp_path / "ours.md", repo_root=repo, config_path=str(repo / "cfg.json"),
        device="cpu", dtype=torch.float64).read_text().splitlines()
    monkeypatch.setattr(jax_eq, "solve_equilibrium",
                        functools.partial(jax_eq.solve_equilibrium, dtype=jnp.float64))
    ref = jax_dashboard.generate_dashboard(
        tmp_path / "ref.md", repo_root=repo,
        config_path=str(repo / "cfg.json")).read_text().splitlines()
    assert len(ours) == len(ref)
    assert ours[2].startswith("_Generated ") and ref[2].startswith("_Generated ")
    differ = [(a, b) for a, b in zip(ours, ref) if a != b and not a.startswith("_Generated ")]
    assert differ == list(HEADINGS.items())
    assert "| demo | pass | 1/2 pass |" in ours
    assert "| demo.fallback | 2 |" in ours
    assert any(line.startswith("- converged: True in ") for line in ours)


def test_dashboard_mode_writes_into_the_working_directory(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert main(["--device", "cpu", "dashboard"]) == 0
    out = capsys.readouterr().out.split()
    assert out == ["DASHBOARD.md", "DASHBOARD.html", "studio_manifest.json"]
    for name in out:
        assert (tmp_path / name).stat().st_size > 0
    assert (tmp_path / "DASHBOARD.md").read_text().startswith(
        "# scpn_fusion_tpu_torch — mission dashboard")
    manifest = json.loads((tmp_path / "studio_manifest.json").read_text())
    assert "torch-cuda" in manifest["capabilities"]["verbs"][0]["backends"]


def test_psi_svg_equals_jax():
    rng = np.random.default_rng(0)
    for psi in (rng.standard_normal((65, 65)), rng.standard_normal((129, 97)),
                np.ones((16, 16))):
        assert live_server._psi_to_svg(psi) == jax_live._psi_to_svg(psi)
    assert live_server._PAGE == jax_live._PAGE
    assert live_server.SECURITY_HEADERS == jax_live.SECURITY_HEADERS


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.status, r.headers, r.read()


def test_live_server_on_the_cpu():
    worker = live_server.LiveSolveWorker(period_s=60.0, device="cpu", dtype=torch.float64)
    worker.start()
    srv = live_server.make_server(worker, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    port = srv.server_address[1]
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            snap = json.loads(_get(port, "/api/status")[2])
            if snap["solver"] or worker.error is not None:
                break
            time.sleep(0.2)
        assert worker.error is None
        assert snap["tick"] == 0 and snap["solver"]["converged"] is True
        assert snap["solver"]["grid"] == "65x65" and snap["history"]
        # True marks a violated invariant (the page shows it as VIOLATED)
        assert snap["invariants"] == {"q_min": False, "beta_N": False,
                                      "energy_conservation_error": False}
        for path, ctype, probe in (("/", "text/html", b"/api/status"),
                                   ("/api/status", "application/json", b'"tick"'),
                                   ("/api/psi.svg", "image/svg+xml", b"<rect")):
            status, headers, body = _get(port, path)
            assert status == 200 and headers.get("Content-Type") == ctype and probe in body
            for name, value in live_server.SECURITY_HEADERS:
                assert headers.get(name) == value, (path, name)
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(port, "/nope")
        assert err.value.code == 404
        assert err.value.headers.get("X-Frame-Options") == "DENY"
        psi = worker._psi
    finally:
        srv.shutdown()
        srv.server_close()
        worker.stop()
        worker.join(timeout=60)
    assert not worker.is_alive()
    ref = jax_eq.solve_equilibrium(jax_live.LiveSolveWorker()._default_cfg(), i_target=15.0,
                                   dtype=jnp.float64)
    assert psi.shape == (65, 65)
    assert span_rel(psi, ref.psi) <= 1e-9


def test_worker_without_the_card_fails_and_ends():
    """No fallback: the default device on this CPU-only host ends the
    worker's loop with the error, kept for the caller."""
    worker = live_server.LiveSolveWorker(period_s=0.01)
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive()
    assert isinstance(worker.error, (RuntimeError, AssertionError))


def test_serve_on_a_taken_port_raises_with_no_worker_running():
    """The bind fails before the worker starts: nothing is left launching
    solves after the error."""
    with socket.socket() as blocker:
        blocker.bind(("127.0.0.1", 0))
        blocker.listen(1)
        with pytest.raises(OSError):
            live_server.serve_live_dashboard(port=blocker.getsockname()[1],
                                             device="cpu", dtype=torch.float64)
    assert not any(isinstance(t, live_server.LiveSolveWorker) for t in threading.enumerate())
