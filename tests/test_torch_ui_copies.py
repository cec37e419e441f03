"""The carried-over modules of ``ui/``: ``studio_verbs``, ``html_dashboard``
and ``__init__`` each equal their JAX package's source text but for the
lines named here.  ``studio_verbs`` names the port's execution tiers (the
PyTorch ops on CUDA, the hand-written CUDA kernels, the C++ runtime, plain
Python) where the source names the TPU's (``tpu-xla``, ``pallas``), and
drops the comment that quotes the JAX package's own tick time;
``html_dashboard`` and ``__init__`` import the port's modules.
"""

import difflib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

TIERS4_REF = '         ("tpu-xla", "pallas", "cpp-native", "python")),'
TIERS4 = '         ("torch-cuda", "cuda-kernels", "cpp-native", "python")),'

# (path, [(the source's lines, the port's lines that stand for them), ...])
COPIES = {
    "ui/studio_verbs": ("ui/studio_verbs.py", [
        (["this repo's actual execution tiers — ``tpu-xla`` (jit/pjit), ``pallas``",
          "(hand kernels), ``cpp-native`` (the C ABI runtime), ``python``",
          "(NumPy twins / host orchestration) — instead of the reference's",
          "rust/julia/go matrix.  No verb is live-hardware: everything is"],
         ["the PyTorch port's actual execution tiers — ``torch-cuda`` (PyTorch ops",
          "on the CUDA device), ``cuda-kernels`` (the hand-written CUDA kernels of",
          "``csrc/``), ``cpp-native`` (the C ABI runtime), ``python`` (plain CPU",
          "twins / host orchestration) — instead of the reference's rust/julia/go",
          "matrix.  No verb is live-hardware: everything is"]),
        (['BACKENDS = frozenset({"tpu-xla", "pallas", "cpp-native", "python"})'],
         ['BACKENDS = frozenset({"torch-cuda", "cuda-kernels", "cpp-native", "python"})']),
        ([TIERS4_REF], [TIERS4]),
        ([TIERS4_REF], [TIERS4]),
        (['         ("tpu-xla", "python")),'], ['         ("torch-cuda", "python")),']),
        ([TIERS4_REF], [TIERS4]),
        (['         ("studio.control-replay.v1",), ("tpu-xla", "python"),'],
         ['         ("studio.control-replay.v1",), ("torch-cuda", "python"),']),
        (['                               # (control_latency.json: 9.4 us/tick)'], []),
        (['         ("studio.disruption-forecast.v1",), ("tpu-xla", "python")),'],
         ['         ("studio.disruption-forecast.v1",), ("torch-cuda", "python")),']),
        (['            "single-language compute path (JAX/XLA/Pallas) + C++ runtime; "',
          '            "no rust/julia/go tiers",',
          '            "TPU f32/bf16 on device; f64 twins on host CPU only",'],
         ['            "single-language compute path (PyTorch + hand-written CUDA "',
          '            "kernels) + C++ runtime; no rust/julia/go tiers",',
          '            "f32 kernels on the CUDA device; f64 on its plain ops and the CPU",']),
    ]),
    "ui/html_dashboard": ("ui/html_dashboard.py", [
        (["    from scpn_fusion_tpu.ui.studio_verbs import capability_block"],
         ["    from scpn_fusion_tpu_torch.ui.studio_verbs import capability_block"])]),
    "ui/__init__": ("ui/__init__.py", [
        (["from scpn_fusion_tpu.ui.dashboard import generate_dashboard"],
         ["from scpn_fusion_tpu_torch.ui.dashboard import generate_dashboard"])]),
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


def test_capability_block_names_the_port_tiers():
    from scpn_fusion_tpu.ui.studio_verbs import capability_block as jax_block
    from scpn_fusion_tpu_torch.ui.studio_verbs import BACKENDS, capability_block

    ours, ref = capability_block(), jax_block()
    assert BACKENDS == {"torch-cuda", "cuda-kernels", "cpp-native", "python"}
    assert [v["name"] for v in ours["verbs"]] == [v["name"] for v in ref["verbs"]]
    assert ours["evidence_schemas"] == ref["evidence_schemas"]
    for v in ours["verbs"]:
        assert set(v["backends"]) <= BACKENDS and "tpu-xla" not in v["backends"]


def test_html_dashboard_and_manifest_equal_jax(tmp_path):
    """On the same repository tree both write the same page, and manifests
    that differ only in the capability block's tiers."""
    import json

    from scpn_fusion_tpu.ui import html_dashboard as jax_html
    from scpn_fusion_tpu_torch.ui import html_dashboard

    reports = tmp_path / "validation" / "reports"
    reports.mkdir(parents=True)
    (reports / "a.json").write_text(json.dumps(
        {"campaign": "a", "overall_status": "pass", "git_sha": "abc",
         "lanes": [{"name": "l1", "status": "pass", "metrics": {}}]}))
    ours = html_dashboard.generate_html_dashboard(tmp_path, tmp_path / "ours.html")
    ref = jax_html.generate_html_dashboard(tmp_path, tmp_path / "ref.html")
    assert ours.read_text() == ref.read_text()
    m_ours = json.loads(html_dashboard.emit_studio_manifest(
        tmp_path, tmp_path / "ours.json").read_text())
    m_ref = json.loads(jax_html.emit_studio_manifest(tmp_path, tmp_path / "ref.json").read_text())
    assert m_ours["entries"] == m_ref["entries"] and m_ours["n_entries"] == 1
