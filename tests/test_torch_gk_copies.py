"""Port parity: the carried-over GK modules (``models/gyrokinetics/{interface,
registry, external, tglf_benchmark, mock_binaries, quasilinear}.py`` and the
package's ``__init__``).

Each is a copy of the JAX package's module: it is held equal to its source
text outside the import lines, and each differing import line is named.
The registry builds the port's solvers (the native TGLF model on the
device asked for) and falls back to it when no TGLF binary is on the path;
none of the external GK binaries is installed, so every adapter reports
``is_available() == False``, as in JAX; the mock binaries, written to a
temporary directory, run every adapter's deck -> subprocess -> parse chain
with the JAX package's results; and the TGLF reference suite scores the
port's reduced closure as the JAX package scores its own.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

import scpn_fusion_tpu.models.gyrokinetics as jgk
import scpn_fusion_tpu_torch.models.gyrokinetics as tgk
from scpn_fusion_tpu.models.gyrokinetics import mock_binaries as jmock
from scpn_fusion_tpu.models.gyrokinetics import tglf_benchmark as jbench
from scpn_fusion_tpu_torch.models.gyrokinetics import external as text
from scpn_fusion_tpu_torch.models.gyrokinetics import mock_binaries as tmock
from scpn_fusion_tpu_torch.models.gyrokinetics import registry as treg
from scpn_fusion_tpu_torch.models.gyrokinetics import tglf_benchmark as tbench
from scpn_fusion_tpu_torch.models.gyrokinetics.interface import GKLocalParams

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "scpn_fusion_tpu" / "models" / "gyrokinetics"
PORT = ROOT / "scpn_fusion_tpu_torch" / "models" / "gyrokinetics"
COPIES = ("interface.py", "registry.py", "external.py", "tglf_benchmark.py", "mock_binaries.py",
          "quasilinear.py", "__init__.py")
# The one import line that is not the source's with the package renamed:
# the benchmark's fixture reader makes its scalars with ``jnp.asarray``,
# which the port binds to ``io/torch_arrays.on(device)``.
RENAMED_JNP = {"    import jax.numpy as jnp":
               "    from scpn_fusion_tpu_torch.io import torch_arrays"}
# The port's code lines that differ from the source, each with the source
# line it stands for (None: the port adds it): the benchmark's entry points
# take the device the closure runs on (the card by default, as JAX puts its
# arrays on its default device).
PORT_ONLY = {"tglf_benchmark.py": {
    '                           ti_kev: float = 10.0, device="cuda") -> ClosureInputs:':
        "                           ti_kev: float = 10.0) -> ClosureInputs:",
    "    jnp = torch_arrays.on(device)": None,
    '                            ref_dir: str | Path = FIXTURE_DIR, device="cuda",':
        "                            ref_dir: str | Path = FIXTURE_DIR,",
    "    inp = case_to_closure_inputs(payload, ti_kev=ti_kev, device=device)":
        "    inp = case_to_closure_inputs(payload, ti_kev=ti_kev)",
    '                             ref_dir: str | Path = FIXTURE_DIR, device="cuda",':
        "                             ref_dir: str | Path = FIXTURE_DIR,",
    "    return [validate_reference_case(name, ti_kev=ti_kev, ref_dir=ref_dir, device=device)":
        "    return [validate_reference_case(name, ti_kev=ti_kev, ref_dir=ref_dir)",
}}
CYCLONE = GKLocalParams(r_l_ti=9.0, r_l_te=6.9, r_l_ne=2.2, q=1.4, s_hat=0.8, beta_e=0.01,
                        kappa=1.7, delta=0.33, rho=0.5)


def _split(path: Path, port_only: dict | None = None):
    """(code lines, import lines) of a module; ``port_only`` maps a port line
    to the source line it stands for (None: dropped)."""
    code, imports = [], []
    for line in path.read_text().splitlines():
        (imports if line.lstrip().startswith(("import ", "from ")) else code).append(line)
    if port_only:
        assert all(code.count(line) == 1 for line in port_only)
        code = [port_only.get(line, line) for line in code
                if port_only.get(line, line) is not None]
    return code, imports


@pytest.mark.parametrize("name", COPIES)
def test_copy_equals_source_outside_imports(name):
    code_p, imports_p = _split(PORT / name, PORT_ONLY.get(name))
    code_s, imports_s = _split(SRC / name)
    assert code_p == code_s
    want = [RENAMED_JNP.get(line, line.replace("scpn_fusion_tpu.", "scpn_fusion_tpu_torch."))
            for line in imports_s]
    assert imports_p == want
    assert not any(line.split()[1].split(".")[0] in ("jax", "scpn_fusion_tpu")
                   for line in imports_p)


def test_package_exports_the_jax_names():
    names = [n for n in dir(jgk) if not n.startswith("_")]
    assert [n for n in names if not hasattr(tgk, n)] == []


def test_registry_builds_the_port_solvers():
    assert set(treg.registered_gk_solvers()) >= {"tglf", "tglf-native", "gene", "gs2", "cgyro",
                                                 "qualikiz"}
    native = treg.create_gk_solver("tglf-native", device="cpu")
    assert type(native).__module__ == "scpn_fusion_tpu_torch.models.gyrokinetics.tglf_native"
    assert native.device == "cpu" and native.is_available()
    # no TGLF binary on the path: the native model stands in
    resolved = treg.resolve_tglf_solver()
    assert type(resolved).__name__ == "TGLFNativeSolver" and resolved.device == "cuda"
    avail = treg.available_gk_solvers()
    assert [k for k, ok in avail.items() if ok] == ["tglf-native"]
    with pytest.raises(KeyError):
        treg.create_gk_solver("no-such-code")


def test_external_adapters_are_unavailable():
    for cls in (text.TGLFSolver, text.GENESolver, text.GS2Solver, text.CGYROSolver,
                text.QuaLiKizSolver):
        assert not cls().is_available()


@pytest.fixture()
def mock_bins(tmp_path):
    """The mock binaries of both packages, each in a temporary directory."""
    out = {}
    for tag, mock in (("jax", jmock), ("port", tmock)):
        bin_dir = tmp_path / tag / "bin"
        mock.install_mock_gk_binaries(bin_dir, mock.canonical_mock_payload("ITG-dominated"))
        out[tag] = bin_dir
    return out


@pytest.mark.parametrize("code", ["tglf", "gene", "gs2", "cgyro", "qualikiz"])
def test_mock_roundtrip_matches_jax(code, mock_bins, tmp_path):
    outs = {}
    for tag, mock in (("jax", jmock), ("port", tmock)):
        with mock.mock_path_env(mock_bins[tag]):
            params = CYCLONE if tag == "port" else jgk.GKLocalParams(**dataclasses.asdict(CYCLONE))
            outs[tag] = mock.run_adapter_roundtrip(code, params, tmp_path / tag / f"{code}_run")
    ours, ref = outs["port"], outs["jax"]
    assert ours.converged and ref.converged
    assert ours.dominant_mode == ref.dominant_mode
    for f in ("chi_i", "chi_e", "d_e", "d_i"):
        assert getattr(ours, f) == getattr(ref, f), f
    for f in ("gamma", "omega_r", "k_y"):
        assert np.array_equal(np.asarray(getattr(ours, f)), np.asarray(getattr(ref, f))), f


def _same_comparison(ours, ref):
    assert ours._fields == ref._fields
    for a, b in zip(ours, ref):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_mock_profile_validation_matches_jax(mock_bins):
    prof = tmock.canonical_mock_payload("ITG-dominated")["profile"]
    rho = np.asarray(prof["rho"])
    ours = tmock.validate_profile_against_external(
        rho, np.asarray(prof["chi_i"]), np.asarray(prof["chi_e"]), bin_dir=mock_bins["port"],
        base_params=CYCLONE)
    ref = jmock.validate_profile_against_external(
        rho, np.asarray(prof["chi_i"]), np.asarray(prof["chi_e"]), bin_dir=mock_bins["jax"],
        base_params=jgk.GKLocalParams(**dataclasses.asdict(CYCLONE)))
    _same_comparison(ours, ref)
    assert ours.rms_error_chi_i < 1e-9


def test_reference_suite_matches_jax():
    ours = tbench.validate_reference_suite(device="cpu")
    ref = jbench.validate_reference_suite()
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        assert (a.case_name, a.reference_mode, a.predicted_mode, a.mode_match) == \
            (b.case_name, b.reference_mode, b.predicted_mode, b.mode_match)
        for f in ("predicted_chi_i_gyrobohm", "predicted_chi_e_gyrobohm", "rel_error_chi_i",
                  "rel_error_chi_e"):
            assert getattr(a, f) == pytest.approx(getattr(b, f), rel=1e-12, abs=1e-300), f
    inp = tbench.case_to_closure_inputs(tbench.load_reference_case("ITG-dominated"),
                                        device="cpu")
    assert inp.q.device.type == "cpu" and inp.q.dtype.is_floating_point
    with pytest.raises((RuntimeError, AssertionError)):    # the card by default
        tbench.validate_reference_case("ITG-dominated")


def test_profile_cases_and_table_match():
    cases = tbench.load_profile_cases()
    assert cases == jbench.load_profile_cases()
    name = next(iter(cases))
    case = cases[name]
    rho = np.asarray(case["rho_points"])
    chi_i = np.asarray(case["chi_i"]) * 1.1
    chi_e = np.asarray(case["chi_e"]) * 0.9
    ours = tbench.compare_chi_profiles(chi_i, chi_e, rho, name, case)
    ref = jbench.compare_chi_profiles(chi_i, chi_e, rho, name, case)
    _same_comparison(ours, ref)
    assert tbench.comparison_table_md([ours]) == jbench.comparison_table_md([ref])
