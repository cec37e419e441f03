"""The port imports neither jax nor the JAX package.

The GPU host has no jax, so every module of ``scpn_fusion_tpu_torch`` (and
``chip_smoke.py``) must import with ``jax`` and ``scpn_fusion_tpu`` blocked.
An AST scan backs the import check up for code paths not run at import time.
"""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "scpn_fusion_tpu_torch"
BLOCKED = ("jax", "jaxlib", "scpn_fusion_tpu")


def _modules() -> list[str]:
    mods = []
    for f in sorted(PKG.rglob("*.py")):
        parts = f.relative_to(ROOT).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return mods


_PROBE = """
import importlib, importlib.abc, sys
BLOCKED = {blocked!r}
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]

class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked import of " + name)
        return None

sys.meta_path.insert(0, Blocker())
sys.path.insert(0, {root!r})
for mod in {mods!r}:
    importlib.import_module(mod)
import chip_smoke  # noqa: F401
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("ok", len({mods!r}))
"""


def test_port_imports_without_jax():
    mods = _modules()
    assert len(mods) >= 15
    code = _PROBE.format(blocked=BLOCKED, root=str(ROOT), mods=mods)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(ROOT), timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == f"ok {len(mods)}"


def test_no_jax_import_in_source():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), filename=str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in BLOCKED, f"{f}: imports {name}"


def test_slice_modules_are_scanned():
    """The modules of each later slice are among those both checks cover
    (control slice 4a: five ported, three carried over, and row D's wrapper)."""
    mods = set(_modules())
    for name in ("control.fueling_torax", "control.digital_twin", "control.twin_ingest",
                 "control.fpga_export", "control.realtime_bus", "control.director",
                 "io.imas_history", "ops.cuda_twin"):
        assert f"scpn_fusion_tpu_torch.{name}" in mods, name


def test_slice_4b_modules_are_scanned():
    """Control slice 4b's modules and row B's wrapper are among those both
    checks cover; with them every module of the JAX package's ``control/``
    has its counterpart."""
    mods = set(_modules())
    for name in ("models.physics.ballooning", "models.physics.edge",
                 "control.plasma_controllers", "control.stellarator_contracts", "control.rmf",
                 "control.hil_sensors", "control.hil", "control.realtime_efit",
                 "control.control_room", "ops.cuda_ballooning"):
        assert f"scpn_fusion_tpu_torch.{name}" in mods, name
    jax_control = {f.stem for f in (ROOT / "scpn_fusion_tpu" / "control").glob("*.py")}
    port_control = {f.stem for f in (PKG / "control").glob("*.py")}
    assert jax_control <= port_control, sorted(jax_control - port_control)


def test_mhd_disruption_slice_modules_are_scanned():
    """The MHD, disruption and runaway modules and the wrappers of rows Q
    and S are among those both checks cover."""
    mods = set(_modules())
    for name in ("disruption_sequence", "fokker_planck_re", "runaway_fluid", "spi_ablation",
                 "mhd_modes", "sawtooth", "stability_mhd", "elm", "edge_events", "sandpile"):
        assert f"scpn_fusion_tpu_torch.models.physics.{name}" in mods, name
    for name in ("cuda_disruption", "cuda_sandpile"):
        assert f"scpn_fusion_tpu_torch.ops.{name}" in mods, name


def test_frc_pulsed_slice_modules_are_scanned():
    """The FRC and pulsed modules and row P's wrapper are among those both
    checks cover, and each has its JAX module at the same path."""
    mods = set(_modules())
    names = ("frc", "frc_stability", "frc_public", "pulsed_compression", "faraday_recovery",
             "hall_mhd_pulsed", "hall_mhd_discovery")
    for name in names:
        assert f"scpn_fusion_tpu_torch.models.physics.{name}" in mods, name
        assert (ROOT / "scpn_fusion_tpu" / "models" / "physics" / f"{name}.py").is_file(), name
    assert "scpn_fusion_tpu_torch.ops.cuda_compression" in mods


def test_heating_orbit_slice_modules_are_scanned():
    """The heating, orbit, divertor and stellarator modules and row F's
    wrapper are among those both checks cover, and each has its JAX module at
    the same path."""
    mods = set(_modules())
    names = ("orbits", "fast_ions", "current_drive", "rf_heating", "drift_wave", "divertor_lab",
             "stellarator")
    for name in names:
        assert f"scpn_fusion_tpu_torch.models.physics.{name}" in mods, name
        assert (ROOT / "scpn_fusion_tpu" / "models" / "physics" / f"{name}.py").is_file(), name
    assert "scpn_fusion_tpu_torch.ops.cuda_orbits" in mods


def test_engineering_nuclear_slice_modules_are_scanned():
    """The engineering, design-scan and nuclear modules and the wrappers of
    rows E and H are among those both checks cover, and each has its JAX
    module at the same path."""
    mods = set(_modules())
    for sub, names in (("engineering", ("balance_of_plant", "thermal_hydraulics",
                                        "direct_energy", "hts_quench", "cad_raytrace")),
                       ("physics", ("design_scan",)),
                       ("nuclear", ("pwi", "blanket", "temhd", "wall_loading",
                                    "heating_neutronics"))):
        for name in names:
            assert f"scpn_fusion_tpu_torch.models.{sub}.{name}" in mods, name
            assert (ROOT / "scpn_fusion_tpu" / "models" / sub / f"{name}.py").is_file(), name
    for name in ("cuda_burn", "cuda_quench"):
        assert f"scpn_fusion_tpu_torch.ops.{name}" in mods, name
