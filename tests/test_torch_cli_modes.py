"""The CLI's modes that draw nothing, against the JAX CLI on the CPU
(the equilibrium modes: ``tests/test_torch_cli_kernel.py``,
``tests/test_torch_cli_solves.py``; more modes:
``tests/test_torch_cli_modes_b.py``).

Each runs as ``main(["--device", "cpu", "--dtype", "float64", ...])``
beside the JAX ``cli_main`` under x64 (``tests/conftest.py``), at the JAX
test's arguments (``tests/test_cli_utils.py``) or at small ones: the same
exit code, the same JSON keys, values within 1e-9 relative in float64, or
1e-5 where the JAX mode fixes float32 itself (the port fixes it too).
Where the JAX function defaults to float32 whatever the x64 flag, the JAX
mode runs with that function asked for float64, as the port's ``--dtype``
asks.  The ``transport`` mode's float32 runs move apart by ~1e-6 relative
a step (rounding; ``tests/test_torch_transport.py`` holds five steps at
1e-5 of the span): three steps are held here at 1e-5.
"""

import functools

import jax.numpy as jnp
import pytest

import scpn_fusion_tpu.control.flight_sim as jax_flight_sim
import scpn_fusion_tpu.models.wdm as jax_wdm
from scpn_fusion_tpu.cli import main as jax_main
from scpn_fusion_tpu.models.transport import initial_state as jax_initial_state
from scpn_fusion_tpu_torch.cli import main
from tests.torch_parity import cli_run, json_mismatches

F64, F32 = 1e-9, 1e-5
PORT = ["--device", "cpu", "--dtype", "float64"]


def flight_sim_f64(monkeypatch):
    monkeypatch.setattr(jax_flight_sim, "run_shot_reduced", functools.partial(
        jax_flight_sim.run_shot_reduced, dtype=jnp.float64))


def wdm_f64(monkeypatch):
    monkeypatch.setattr(jax_wdm, "default_initial_state",
                        lambda cfg: jax_initial_state(cfg.transport, jnp.float64))


# (argv, tolerance, the JAX float64 request or None)
CASES = {
    "transport": (["transport", "--steps", "3"], F32, None),      # float32 in both
    "flight-sim": (["flight-sim", "--hz", "1000", "--duration", "0.2"], F64, flight_sim_f64),
    "burn": (["burn", "--ne19", "10", "--p-aux", "50"], F64, None),
    "disruption": (["disruption"], F64, None),
    "disruption-spi": (["disruption", "--spi", "200"], F64, None),
    "startup": (["startup"], F64, None),
    "divertor": (["divertor"], F64, None),
    "breeding": (["breeding", "--thickness", "80", "--li6", "0.9"], F64, None),
    "heating": (["heating"], F64, None),
    "sawtooth": (["sawtooth", "--q0", "0.9"], F64, None),
    "nuclear": (["nuclear", "--n", "20"], F64, None),
    "neural": (["neural"], F32, None),                            # float32 input in both
    "wdm": (["wdm", "--steps", "20"], F64, wdm_f64),
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
