"""The CLI's ``kernel`` mode, the port's main path, against the JAX CLI on
the CPU.

The port's mode runs ``--device cpu --dtype float64``, the JAX mode under
x64 (``tests/conftest.py``) with its solver asked for float64 (the JAX
solvers default to float32 whatever the x64 flag; the port's ``--dtype``
asks for the type): the same exit code, the same JSON keys, values within
1e-9 relative (``json_mismatches`` holds keys, strings and flags equal).
The npz of ``--output`` holds host copies of the port's fields, equal to a
direct ``solve_equilibrium`` call.
"""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scpn_fusion_tpu.models.equilibrium as jax_eq
from scpn_fusion_tpu.cli import main as jax_main
from scpn_fusion_tpu_torch.cli import main
from tests.torch_parity import cli_run, json_mismatches

TOL = 1e-9
PORT = ["--device", "cpu", "--dtype", "float64"]


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


def test_kernel_mode(config_file, tmp_path, capsys, monkeypatch):
    from scpn_fusion_tpu_torch.core.config import load_config
    from scpn_fusion_tpu_torch.models.equilibrium import solve_equilibrium

    out = tmp_path / "out.npz"
    (rc, ours), (rc_ref, ref) = _both(
        ["kernel", str(config_file), "--output", str(out)], capsys, monkeypatch,
        jax_eq, "solve_equilibrium")
    # the JAX mode wrote its own fields over the port's: the port's again
    assert main(PORT + ["kernel", str(config_file), "--output", str(out)]) == 0
    direct = solve_equilibrium(load_config(config_file), dtype=torch.float64, device="cpu")
    assert rc == rc_ref == 0 and ours["converged"] is True
    assert json_mismatches(ours, ref, TOL) == {}
    data = np.load(out)
    assert data["psi"].shape == (33, 33) and data["psi"].dtype == np.float64
    for name in ("psi", "j_phi", "b_r", "b_z"):
        assert np.array_equal(data[name], getattr(direct, name).numpy()), name
