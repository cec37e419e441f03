"""More of the CLI's modes that draw nothing, against the JAX CLI on the
CPU, as ``tests/test_torch_cli_modes.py`` holds them: ``--device cpu
--dtype float64`` beside the JAX ``cli_main`` under x64, the same exit code
and JSON keys, values within 1e-9 relative in float64 or 1e-5 where the JAX
mode fixes float32 itself (the ``diagnostics`` grid).  ``tglf``:
``tests/test_torch_cli_tglf.py``.
"""

import functools

import jax.numpy as jnp
import pytest

import scpn_fusion_tpu.control.digital_twin as jax_twin
import scpn_fusion_tpu.models.equilibrium.force_balance_3d as jax_fb3d
from scpn_fusion_tpu.cli import main as jax_main
from scpn_fusion_tpu_torch.cli import main
from tests.torch_parity import cli_run, json_mismatches

F64, F32 = 1e-9, 1e-5
PORT = ["--device", "cpu", "--dtype", "float64"]


def twin_f64(monkeypatch):
    # JAX's jitted twin takes no static dtype: its float64 run is the
    # unjitted function's
    monkeypatch.setattr(jax_twin, "run_digital_twin", functools.partial(
        jax_twin.run_digital_twin.__wrapped__, dtype=jnp.float64))


def geometry_f64(monkeypatch):
    zero = jax_fb3d.Geometry3D.zero_amplitudes
    monkeypatch.setattr(jax_fb3d.Geometry3D, "zero_amplitudes",
                        lambda self, dtype=jnp.float64: zero(self, dtype))


CASES = {
    "diagnostics": (["diagnostics", "--n", "33"], F32, None),     # the float32 grid
    "optimal": (["optimal", "--iters", "3"], F64, None),
    "digital-twin": (["digital-twin", "--steps", "30"], F64, twin_f64),
    "geometry": (["geometry", "--iters", "3"], F64, geometry_f64),
}


@pytest.mark.parametrize("case", list(CASES))
def test_mode_matches_jax(case, capsys, monkeypatch):
    argv, tol, jax_f64 = CASES[case]
    rc, ours = cli_run(main, PORT + argv, capsys)
    if jax_f64 is not None:
        jax_f64(monkeypatch)
    rc_ref, ref = cli_run(jax_main, argv, capsys)
    assert rc == rc_ref == 0
    assert json_mismatches(ours, ref, tol) == {}
