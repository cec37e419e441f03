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
