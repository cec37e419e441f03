"""The port's CLI offers the JAX CLI's 34 modes with the same options and
defaults, plus the two global options ``--device`` and ``--dtype``; without
``--device cpu`` a mode raises on this CPU-only host (no fallback); the
module runs under ``python -m`` and is the console script the packaging
names.
"""

import argparse
import subprocess
import sys
import tomllib
from pathlib import Path

import pytest
import torch

from scpn_fusion_tpu.cli import build_parser as jax_parser
from scpn_fusion_tpu.cli import main as jax_main
from scpn_fusion_tpu_torch.cli import build_parser, main

ROOT = Path(__file__).resolve().parent.parent
ADDED = ("device", "dtype")     # the port's only additions, global options


def _subparsers(parser) -> dict:
    action = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return action.choices


def _options(parser) -> dict:
    """dest -> (option strings, default, type, choices, action class) of
    every argument but help."""
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices, type(a).__name__)
            for a in parser._actions if not isinstance(a, (argparse._HelpAction,
                                                           argparse._SubParsersAction))}


def test_modes_equal_jax_modes():
    ours, ref = _subparsers(build_parser()), _subparsers(jax_parser())
    assert sorted(ours) == sorted(ref)
    assert len(ours) == 34


@pytest.mark.parametrize("mode", sorted(_subparsers(jax_parser())))
def test_mode_options_and_defaults_equal_jax(mode):
    ours = _subparsers(build_parser())[mode]
    ref = _subparsers(jax_parser())[mode]
    assert _options(ours) == _options(ref)
    assert ours._defaults["fn"].__name__ == ref._defaults["fn"].__name__


def test_global_options_are_the_only_additions():
    ours, ref = _options(build_parser()), _options(jax_parser())
    assert set(ours) - set(ref) == set(ADDED)
    assert ours["device"][:2] == (("--device",), "cuda")
    assert ours["dtype"][:2] == (("--dtype",), "float32")
    assert set(ours["dtype"][3]) == {"float32", "float64"}


def test_unknown_mode_rejected():
    with pytest.raises(SystemExit):
        main(["warp-drive"])
    with pytest.raises(SystemExit):
        jax_main(["warp-drive"])


def test_bare_call_needs_the_card(tmp_path):
    """No fallback: on this CPU-only host a mode asked for the default
    device raises, as every entry point of the port does."""
    assert not torch.cuda.is_available()
    cfg = tmp_path / "cfg.json"
    cfg.write_text('{"reactor_name": "x", "grid_resolution": [17, 17], '
                   '"dimensions": {"R_min": 2.0, "R_max": 10.0, "Z_min": -4.0, '
                   '"Z_max": 4.0}, "coils": [{"r": 8.0, "z": 4.8, "current": 4.0}]}')
    with pytest.raises((RuntimeError, AssertionError)):
        main(["kernel", str(cfg)])
    with pytest.raises((RuntimeError, AssertionError)):
        main(["burn"])


def test_unknown_campaign_returns_2(capsys):
    assert main(["--device", "cpu", "validate", "--campaign", "no_such"]) == 2
    assert "unknown campaign: run_no_such" in capsys.readouterr().err
    assert jax_main(["validate", "--campaign", "no_such"]) == 2


def test_python_m_and_console_script():
    proc = subprocess.run([sys.executable, "-m", "scpn_fusion_tpu_torch.cli", "--help"],
                          capture_output=True, text=True, cwd=str(ROOT), timeout=120)
    assert proc.returncode == 0 and "--device" in proc.stdout and "kernel" in proc.stdout
    scripts = tomllib.loads((ROOT / "pyproject.toml").read_text())["project"]["scripts"]
    assert scripts["scpn-fusion-tpu-torch"] == "scpn_fusion_tpu_torch.cli:main"
    assert scripts["scpn-fusion-tpu"] == "scpn_fusion_tpu.cli:main"
