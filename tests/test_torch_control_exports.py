"""The port's ``control/__init__.py`` exports every name that the JAX
package's ``control/__init__.py`` exports from the modules ported so far,
under the same name and from the same module, read from the JAX file's
imports (an AST scan: nothing of the JAX package is imported here)."""

import ast
from pathlib import Path

import pytest

import scpn_fusion_tpu_torch.control as port

ROOT = Path(__file__).resolve().parent.parent
PORTED = ("pid", "actuator", "flight_sim", "scenario", "optimal_scenario", "hinf", "robust",
          "vessel_rzip", "gain_schedule", "sliding_mode", "estimator", "fault_tolerant",
          "tuning", "stress", "neuro_cybernetic", "soc_learning", "federated", "disruption_seq",
          "replay", "surrogate_mpc")


def _jax_exports() -> dict[str, list[str]]:
    tree = ast.parse((ROOT / "scpn_fusion_tpu" / "control" / "__init__.py").read_text())
    out: dict[str, list[str]] = {}
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.module.startswith("scpn_fusion_tpu.control."):
            out.setdefault(node.module.rsplit(".", 1)[1], []).extend(a.name for a in node.names)
    return out


@pytest.mark.parametrize("module", PORTED)
def test_exports_of_ported_modules(module):
    import importlib

    names = _jax_exports().get(module, [])
    mod = importlib.import_module(f"scpn_fusion_tpu_torch.control.{module}")
    for name in names:
        assert getattr(port, name) is getattr(mod, name), name


def test_this_slice_exports():
    exported = _jax_exports()
    assert exported["tuning"] == ["CEMResult", "cem_minimize", "tune_hinf", "tune_pid"]
    assert {"mu_synthesis", "rwm_feedback_design"} <= set(exported["robust"])
    assert "run_fault_tolerant_shot" in exported["fault_tolerant"]
