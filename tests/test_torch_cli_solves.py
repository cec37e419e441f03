"""The CLI's ``free-boundary`` and ``geqdsk`` modes against the JAX CLI on
the CPU (``kernel``: ``tests/test_torch_cli_kernel.py``).

The port's mode runs ``--device cpu --dtype float64``, the JAX mode under
x64 (``tests/conftest.py``) with its solver asked for float64 (the JAX
solvers default to float32 whatever the x64 flag; the port's ``--dtype``
asks for the type): the same exit code, the same JSON keys, values within
1e-9 relative (``json_mismatches`` holds keys, strings and flags equal).
"""

import functools
import json
from pathlib import Path

import jax.numpy as jnp
import pytest

import scpn_fusion_tpu.models.equilibrium.free_boundary as jax_fb
from scpn_fusion_tpu.cli import main as jax_main
from scpn_fusion_tpu_torch.cli import main
from tests.torch_parity import cli_run, json_mismatches

TOL = 1e-9
PORT = ["--device", "cpu", "--dtype", "float64"]
SPARC = str(Path(__file__).resolve().parent.parent / "fuzz" / "seeds" / "geqdsk"
            / "sparc_lmode_hv.geqdsk")


@pytest.fixture
def config_file(tmp_path):
    """The JAX CLI test's configuration (``tests/test_cli_utils.py``)."""
    cfg = {
        "reactor_name": "cli-test",
        "grid_resolution": [33, 33],
        "dimensions": {"R_min": 2.0, "R_max": 10.0, "Z_min": -4.0, "Z_max": 4.0},
        "physics": {"plasma_current_target": 15.0, "vacuum_permeability": 1.0},
        "coils": [
            {"r": 8.0, "z": 4.8, "current": 4.0},
            {"r": 10.8, "z": 0.0, "current": 6.0},
            {"r": 8.0, "z": -4.8, "current": 4.0},
        ],
        "solver": {"max_iterations": 200, "convergence_threshold": 1e-4,
                   "relaxation_factor": 0.1, "solver_method": "multigrid"},
    }
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps(cfg))
    return p


def _both(argv, capsys, monkeypatch, module, name):
    """(port, JAX x64 with ``module.name`` asked for float64) runs."""
    ours = cli_run(main, PORT + argv, capsys)
    monkeypatch.setattr(module, name, functools.partial(getattr(module, name),
                                                        dtype=jnp.float64))
    return ours, cli_run(jax_main, argv, capsys)


def test_free_boundary_mode(config_file, capsys, monkeypatch):
    (rc, ours), (rc_ref, ref) = _both(
        ["free-boundary", str(config_file), "--max-outer", "3"], capsys, monkeypatch,
        jax_fb, "solve_free_boundary")
    assert rc == rc_ref == 0
    assert json_mismatches(ours, ref, TOL) == {}


def test_geqdsk_mode(capsys):
    """``solve_from_geqdsk`` takes the x64 flag's float in JAX: float64 here."""
    rc, ours = cli_run(main, PORT + ["geqdsk", SPARC, "--max-iter", "400"], capsys)
    rc_ref, ref = cli_run(jax_main, ["geqdsk", SPARC, "--max-iter", "400"], capsys)
    assert rc == rc_ref == 0
    assert json_mismatches(ours, ref, TOL) == {}
