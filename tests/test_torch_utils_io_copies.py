"""The carried-over framework-neutral modules of ``utils/``, ``io/`` and
``native/``: each copy equals its JAX package's source text but for the
lines named here (the imports that point at the port), and the native
runtime's C++ source is the JAX package's, byte for byte.  ``io/__init__``
exports every name that the JAX package's ``io/__init__`` exports.
"""

import ast
import difflib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

# (path, [(the source's lines, the port's lines that stand for them), ...])
COPIES = {
    "utils/__init__": ("utils/__init__.py", []),
    "utils/telemetry": ("utils/telemetry.py", []),
    "utils/evidence": ("utils/evidence.py", []),
    "utils/npref": ("utils/npref.py", []),
    "utils/exactness": ("utils/exactness.py", []),
    "utils/repro": ("utils/repro.py", []),
    "utils/quantum_bridge": ("utils/quantum_bridge.py", []),
    "native/__init__": ("native/__init__.py", [
        (["from scpn_fusion_tpu.native.runtime import ("],
         ["from scpn_fusion_tpu_torch.native.runtime import ("])]),
    "native/runtime": ("native/runtime.py", []),
    "io/archive": ("io/archive.py", [
        (["from scpn_fusion_tpu.utils.telemetry import record_fallback_event"],
         ["from scpn_fusion_tpu_torch.utils.telemetry import record_fallback_event"])]),
    "io/codac": ("io/codac.py", []),
    "io/imas": ("io/imas.py", [
        (["from scpn_fusion_tpu.io.archive import MachineProfiles"],
         ["from scpn_fusion_tpu_torch.io.archive import MachineProfiles"])]),
    "io/mast": ("io/mast.py", [
        (["from scpn_fusion_tpu.utils.telemetry import record_fallback_event"],
         ["from scpn_fusion_tpu_torch.utils.telemetry import record_fallback_event"])]),
    "io/omas_inputs": ("io/omas_inputs.py", []),
}


@pytest.mark.parametrize("name", list(COPIES))
def test_copy_equals_its_source(name):
    path, differs = COPIES[name]
    ours = (ROOT / "scpn_fusion_tpu_torch" / path).read_text().splitlines()
    ref = (ROOT / "scpn_fusion_tpu" / path).read_text().splitlines()
    blocks = [(ref[i1:i2], ours[j1:j2]) for tag, i1, i2, j1, j2 in
              difflib.SequenceMatcher(None, ref, ours, autojunk=False).get_opcodes()
              if tag != "equal"]
    assert blocks == differs


def test_native_source_is_byte_equal():
    ours = (ROOT / "scpn_fusion_tpu_torch" / "native" / "gs_runtime.cpp").read_bytes()
    assert ours == (ROOT / "scpn_fusion_tpu" / "native" / "gs_runtime.cpp").read_bytes()


def _exports(path: Path) -> set[str]:
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
    return names


def test_io_exports_what_jax_io_exports():
    ref = _exports(ROOT / "scpn_fusion_tpu" / "io" / "__init__.py")
    ours = _exports(ROOT / "scpn_fusion_tpu_torch" / "io" / "__init__.py")
    assert ref and ours == ref
    import scpn_fusion_tpu_torch.io as tio
    assert all(hasattr(tio, name) for name in ref)
