"""The CLI's ``tglf`` mode against the JAX CLI on the CPU, as
``tests/test_torch_cli_modes.py`` holds the modes that draw nothing: the
native model (no TGLF binary on this host) in float64, the same exit code
and JSON keys, values within 1e-9 relative.  A file of its own: the port's
local kinetic dispersion takes ~20 s on one CPU thread (60 ``torch.func.jvp``
Newton steps of its dispersion function).
"""

from scpn_fusion_tpu.cli import main as jax_main
from scpn_fusion_tpu_torch.cli import main
from tests.torch_parity import cli_run, json_mismatches


def test_tglf_mode_matches_jax(capsys):
    rc, ours = cli_run(main, ["--device", "cpu", "--dtype", "float64", "tglf"], capsys)
    rc_ref, ref = cli_run(jax_main, ["tglf"], capsys)
    assert rc == rc_ref == 0
    assert ours["dominant_mode"] == "ITG"
    assert json_mismatches(ours, ref, 1e-9) == {}
