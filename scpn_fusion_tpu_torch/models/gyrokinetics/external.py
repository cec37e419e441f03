"""External gyrokinetic-code adapters (GK path A).

Deck writers + output parsers + PATH probes for the five external GK codes
the reference integrates (``core/gk_tglf.py``, ``gk_gene.py``,
``gk_gs2.py``, ``gk_cgyro.py``, ``gk_qualikiz.py``).  None of the binaries
ship in this image, so on this host every adapter honestly reports
``is_available() == False`` — but the deck-generation and output-parsing
logic is real and unit-tested against synthetic run directories, exactly
how the reference tests its own adapters without the binaries
(reference ``tests/test_gk_tglf.py`` mocked-run pattern).

Parsers are fail-soft per the adapter contract: a missing or malformed
output file yields a zero-flux, ``converged=False`` result rather than an
exception — the hybrid scheduler treats that as "spot-check unavailable".
"""

from __future__ import annotations

import logging
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from scpn_fusion_tpu_torch.models.gyrokinetics.interface import (
    GKLocalParams,
    GKOutput,
    GKSolverBase,
    empty_gk_output,
)

logger = logging.getLogger(__name__)


def classify_dominant_mode(gamma: np.ndarray, omega_r: np.ndarray) -> str:
    """ITG for ion-diamagnetic (negative) real frequency, TEM otherwise."""
    gamma = np.asarray(gamma)
    if gamma.size == 0 or np.all(gamma <= 0.0):
        return "stable"
    idx = int(np.argmax(gamma))
    return "ITG" if float(np.asarray(omega_r)[idx]) < 0.0 else "TEM"


def _run_binary(cmd: list[str], cwd: Path, timeout_s: float) -> bool:
    """Bounded subprocess run; False on any failure (fail-soft)."""
    try:
        proc = subprocess.run(
            cmd, cwd=cwd, capture_output=True, timeout=timeout_s, check=False)
        return proc.returncode == 0
    except (OSError, subprocess.TimeoutExpired) as exc:
        logger.warning("external GK run failed (%s): %s", cmd[0], exc)
        return False


class _ExternalGKSolver(GKSolverBase):
    """Shared skeleton: tmp run dir, PATH probe, bounded subprocess."""

    binary: str = ""
    deck_name: str = ""

    def __init__(self, binary: str | None = None,
                 work_dir: Path | None = None) -> None:
        if binary is not None:
            self.binary = binary
        self.work_dir = work_dir

    def is_available(self) -> bool:
        return shutil.which(self.binary) is not None

    def _make_run_dir(self) -> Path:
        if self.work_dir is not None:
            base = Path(self.work_dir)
            base.mkdir(parents=True, exist_ok=True)
            return base
        return Path(tempfile.mkdtemp(prefix=f"{self.binary}_run_"))

    def generate_input(self, params: GKLocalParams) -> str:
        raise NotImplementedError

    def parse_output(self, run_dir: Path) -> GKOutput:
        raise NotImplementedError

    def command(self, run_dir: Path) -> list[str]:
        return [self.binary, str(run_dir / self.deck_name)]

    def prepare_input(self, params: GKLocalParams) -> Path:
        run_dir = self._make_run_dir()
        (run_dir / self.deck_name).write_text(self.generate_input(params),
                                              encoding="utf-8")
        return run_dir

    def run(self, input_path: Path, *, timeout_s: float = 30.0) -> GKOutput:
        run_dir = Path(input_path)
        if not (run_dir / self.deck_name).exists():
            raise FileNotFoundError(
                f"{self.deck_name} not found in {run_dir}")
        if self.is_available():
            _run_binary(self.command(run_dir), run_dir, timeout_s)
        return self.parse_output(run_dir)


# ── TGLF (GACODE) ────────────────────────────────────────────────────────


class TGLFSolver(_ExternalGKSolver):
    """GACODE TGLF wrapper: ``input.tglf`` namelist in,
    ``out.tglf.transport`` + ``out.tglf.eigenvalue_spectrum`` out
    (reference ``gk_tglf.py:83-241`` file contract)."""

    binary = "tglf"
    deck_name = "input.tglf"

    def command(self, run_dir: Path) -> list[str]:
        return [self.binary, "-i", str(run_dir / self.deck_name)]

    def generate_input(self, params: GKLocalParams) -> str:
        p = params
        lines = [
            "# TGLF input deck (scpn_fusion_tpu adapter)",
            "NS = 2",
            "GEOMETRY_FLAG = 1",          # Miller
            f"AS_2 = 1.0",
            f"RLNS_1 = {p.r_l_ne:.6f}",
            f"RLNS_2 = {p.r_l_ne:.6f}",
            f"RLTS_1 = {p.r_l_te:.6f}",
            f"RLTS_2 = {p.r_l_ti:.6f}",
            f"TAUS_2 = {1.0 / max(p.te_ti, 1e-6):.6f}",
            f"BETAE = {p.beta_e:.6e}",
            f"XNUE = {p.nu_star:.6e}",
            f"ZEFF = {p.z_eff:.4f}",
            f"RMIN_LOC = {p.rho:.6f}",
            f"RMAJ_LOC = {p.r0 / max(p.a, 0.01):.6f}",
            f"Q_LOC = {p.q:.6f}",
            f"KAPPA_LOC = {p.kappa:.6f}",
            f"DELTA_LOC = {p.delta:.6f}",
            f"S_KAPPA_LOC = 0.0",
            f"S_DELTA_LOC = 0.0",
            f"SHAT = {p.s_hat:.6f}",
            f"ALPHA_MHD = {p.alpha_mhd:.6f}",
            f"NKY = {p.n_radial_modes}",
            "USE_TRANSPORT_MODEL = T",
        ]
        return "\n".join(lines) + "\n"

    def parse_output(self, run_dir: Path) -> GKOutput:
        transport = run_dir / "out.tglf.transport"
        spectrum = run_dir / "out.tglf.eigenvalue_spectrum"
        chi_i = chi_e = d_e = 0.0
        converged = False
        if transport.exists():
            try:
                for line in transport.read_text().strip().splitlines():
                    toks = line.split()
                    if len(toks) < 2:
                        continue
                    key = toks[0].lower()
                    if key == "chi_i":
                        chi_i = float(toks[1])
                        converged = True
                    elif key == "chi_e":
                        chi_e = float(toks[1])
                        converged = True
                    elif key in ("d_e", "particle_flux"):
                        d_e = float(toks[1])
                        converged = True
                # converged only when at least one recognized transport key
                # actually parsed: an unrelated/empty file must NOT read as a
                # valid all-zero stable result (ADVICE r2) — the hybrid
                # scheduler treats converged=False as "spot-check unavailable".
            except ValueError as exc:
                logger.warning("TGLF transport parse error: %s", exc)
        k_y = gamma = omega_r = np.empty(0)
        if spectrum.exists():
            try:
                data = np.atleast_2d(np.loadtxt(spectrum, comments="#"))
                if data.size and data.shape[1] >= 3:
                    k_y, gamma, omega_r = data[:, 0], data[:, 1], data[:, 2]
            except (ValueError, OSError) as exc:
                logger.warning("TGLF spectrum parse error: %s", exc)
        return GKOutput(
            chi_i=chi_i, chi_e=chi_e, d_e=d_e, d_i=0.0,
            gamma=gamma, omega_r=omega_r, k_y=k_y,
            dominant_mode=classify_dominant_mode(gamma, omega_r),
            converged=converged)


# ── GENE ─────────────────────────────────────────────────────────────────


class GENESolver(_ExternalGKSolver):
    """GENE wrapper: ``parameters`` namelist in, ``nrg_*`` out
    (reference ``gk_gene.py:90-179`` file contract)."""

    binary = "gene"
    deck_name = "parameters"

    def command(self, run_dir: Path) -> list[str]:
        return [self.binary]

    def generate_input(self, params: GKLocalParams) -> str:
        p = params
        nl = f"""&parallelization
n_procs_s = 1
/
&box
n_spec = 2
nx0 = {p.n_radial_modes}
nky0 = {p.n_binormal_modes}
nz0 = {p.n_parallel_grid}
nv0 = {p.n_vpar_grid}
nw0 = {p.n_mu_grid}
kymin = 0.05
/
&general
nonlinear = {'T' if p.requires_nonlinear_solver else 'F'}
beta = {p.beta_e:.6e}
coll = {p.nu_star:.6e}
zeff = {p.z_eff:.4f}
simtimelim = {p.simulation_time:.1f}
/
&geometry
magn_geometry = 'miller'
trpeps = {p.epsilon:.6f}
q0 = {p.q:.6f}
shat = {p.s_hat:.6f}
kappa = {p.kappa:.6f}
delta = {p.delta:.6f}
amhd = {p.alpha_mhd:.6f}
major_R = {p.r0 / max(p.a, 0.01):.6f}
/
&species
name = 'ions'
omn = {p.r_l_ne:.6f}
omt = {p.r_l_ti:.6f}
mass = 1.0
charge = 1
temp = {1.0 / max(p.te_ti, 1e-6):.6f}
dens = 1.0
/
&species
name = 'electrons'
omn = {p.r_l_ne:.6f}
omt = {p.r_l_te:.6f}
mass = 2.72e-4
charge = -1
temp = 1.0
dens = 1.0
/
"""
        return nl

    def parse_output(self, run_dir: Path) -> GKOutput:
        # GENE writes nrg_NNNN: per-species columns, heat flux in col 7.
        nrg_files = sorted(run_dir.glob("nrg*"))
        if not nrg_files:
            return empty_gk_output()
        try:
            rows = []
            for line in nrg_files[-1].read_text().strip().splitlines():
                toks = line.split()
                if len(toks) >= 7:
                    rows.append([float(t) for t in toks])
            if not rows:
                return empty_gk_output()
            last = np.asarray(rows[-2:])   # final ions + electrons rows
            chi_i = float(last[0, 6]) if last.shape[0] >= 1 else 0.0
            chi_e = float(last[1, 6]) if last.shape[0] >= 2 else 0.0
            d_e = float(last[-1, 4]) if last.shape[1] >= 5 else 0.0
            z = np.empty(0)
            return GKOutput(chi_i=chi_i, chi_e=chi_e, d_e=d_e, d_i=0.0,
                            gamma=z, omega_r=z, k_y=z,
                            dominant_mode="stable", converged=True)
        except (ValueError, OSError) as exc:
            logger.warning("GENE nrg parse error: %s", exc)
            return empty_gk_output()


# ── GS2 ──────────────────────────────────────────────────────────────────


class GS2Solver(_ExternalGKSolver):
    """GS2 wrapper: ``gs2.in`` namelist, ``gs2.omega`` text output
    (reference ``gk_gs2.py:29-156`` file contract)."""

    binary = "gs2"
    deck_name = "gs2.in"

    def generate_input(self, params: GKLocalParams) -> str:
        p = params
        return f"""&theta_grid_parameters
ntheta = {p.n_parallel_grid}
nperiod = 1
rhoc = {p.rho:.6f}
qinp = {p.q:.6f}
shat = {p.s_hat:.6f}
akappa = {p.kappa:.6f}
tri = {p.delta:.6f}
rmaj = {p.r0 / max(p.a, 0.01):.6f}
/
&parameters
beta = {p.beta_e:.6e}
zeff = {p.z_eff:.4f}
/
&species_parameters_1
z = 1.0
mass = 1.0
dens = 1.0
temp = {1.0 / max(p.te_ti, 1e-6):.6f}
tprim = {p.r_l_ti:.6f}
fprim = {p.r_l_ne:.6f}
vnewk = {p.nu_star:.6e}
type = 'ion'
/
&species_parameters_2
z = -1.0
mass = 2.72e-4
dens = 1.0
temp = 1.0
tprim = {p.r_l_te:.6f}
fprim = {p.r_l_ne:.6f}
vnewk = {p.nu_star:.6e}
type = 'electron'
/
&kt_grids_range_parameters
naky = {p.n_binormal_modes}
aky_min = 0.1
aky_max = 1.0
/
"""

    def parse_output(self, run_dir: Path) -> GKOutput:
        # gs2.omega rows: ky  omega_r  gamma
        omega_file = run_dir / "gs2.omega"
        if not omega_file.exists():
            return empty_gk_output()
        try:
            data = np.atleast_2d(np.loadtxt(omega_file, comments="#"))
            if not data.size or data.shape[1] < 3:
                return empty_gk_output()
            k_y, omega_r, gamma = data[:, 0], data[:, 1], data[:, 2]
            return GKOutput(
                chi_i=0.0, chi_e=0.0, d_e=0.0, d_i=0.0,
                gamma=gamma, omega_r=omega_r, k_y=k_y,
                dominant_mode=classify_dominant_mode(gamma, omega_r),
                converged=True)
        except (ValueError, OSError) as exc:
            logger.warning("GS2 omega parse error: %s", exc)
            return empty_gk_output()


# ── CGYRO (GACODE) ───────────────────────────────────────────────────────


class CGYROSolver(_ExternalGKSolver):
    """CGYRO wrapper: ``input.cgyro`` in, ``out.cgyro.freq`` out
    (reference ``gk_cgyro.py:29-128`` file contract)."""

    binary = "cgyro"
    deck_name = "input.cgyro"

    def command(self, run_dir: Path) -> list[str]:
        return [self.binary, "-i", str(run_dir / self.deck_name)]

    def generate_input(self, params: GKLocalParams) -> str:
        p = params
        lines = [
            "# CGYRO input deck (scpn_fusion_tpu adapter)",
            "N_SPECIES = 2",
            f"RMIN = {p.rho:.6f}",
            f"RMAJ = {p.r0 / max(p.a, 0.01):.6f}",
            f"Q = {p.q:.6f}",
            f"S = {p.s_hat:.6f}",
            f"KAPPA = {p.kappa:.6f}",
            f"DELTA = {p.delta:.6f}",
            f"BETAE_UNIT = {p.beta_e:.6e}",
            f"NU_EE = {p.nu_star:.6e}",
            f"Z_EFF = {p.z_eff:.4f}",
            f"DLNNDR_1 = {p.r_l_ne:.6f}",
            f"DLNTDR_1 = {p.r_l_ti:.6f}",
            f"DLNNDR_2 = {p.r_l_ne:.6f}",
            f"DLNTDR_2 = {p.r_l_te:.6f}",
            f"TEMP_2 = {p.te_ti:.6f}",
            f"N_RADIAL = {p.n_radial_modes}",
            f"N_TOROIDAL = {p.n_binormal_modes}",
            f"N_THETA = {p.n_parallel_grid}",
            f"N_XI = {p.n_vpar_grid}",
            f"N_ENERGY = {p.n_mu_grid}",
            f"MAX_TIME = {p.simulation_time:.1f}",
            f"NONLINEAR_FLAG = {1 if p.requires_nonlinear_solver else 0}",
        ]
        return "\n".join(lines) + "\n"

    def parse_output(self, run_dir: Path) -> GKOutput:
        # out.cgyro.freq rows: omega_r  gamma (final = converged mode)
        freq_file = run_dir / "out.cgyro.freq"
        if not freq_file.exists():
            return empty_gk_output()
        try:
            data = np.atleast_2d(np.loadtxt(freq_file, comments="#"))
            if not data.size or data.shape[1] < 2:
                return empty_gk_output()
            omega_r = data[-1:, 0]
            gamma = data[-1:, 1]
            k_y = np.asarray([0.3])
            return GKOutput(
                chi_i=0.0, chi_e=0.0, d_e=0.0, d_i=0.0,
                gamma=gamma, omega_r=omega_r, k_y=k_y,
                dominant_mode=classify_dominant_mode(gamma, omega_r),
                converged=True)
        except (ValueError, OSError) as exc:
            logger.warning("CGYRO freq parse error: %s", exc)
            return empty_gk_output()


# ── QuaLiKiz ─────────────────────────────────────────────────────────────


class QuaLiKizSolver(_ExternalGKSolver):
    """QuaLiKiz wrapper.  Preferred lane is the ``qualikiz_tools`` Python
    package (reference ``gk_qualikiz.py:32-76``); the binary lane is the
    fallback.  Neither ships in this image, so ``is_available`` is
    honestly False and ``run`` degrades to a zero-flux unconverged
    result unless an output JSON is present."""

    binary = "qualikiz"
    deck_name = "qlk_input.json"

    def is_available(self) -> bool:
        try:
            import qualikiz_tools  # noqa: F401
            return True
        except ImportError:
            return shutil.which(self.binary) is not None

    def generate_input(self, params: GKLocalParams) -> str:
        import json as _json
        return _json.dumps({"params": params.as_dict()}, indent=1)

    def parse_output(self, run_dir: Path) -> GKOutput:
        import json as _json
        out_file = run_dir / "qlk_output.json"
        if not out_file.exists():
            return empty_gk_output()
        try:
            payload = _json.loads(out_file.read_text(encoding="utf-8"))
            z = np.empty(0)
            return GKOutput(
                chi_i=float(payload.get("chi_i", 0.0)),
                chi_e=float(payload.get("chi_e", 0.0)),
                d_e=float(payload.get("d_e", 0.0)),
                d_i=float(payload.get("d_i", 0.0)),
                gamma=z, omega_r=z, k_y=z,
                dominant_mode=str(payload.get("dominant_mode", "stable")),
                converged=bool(payload.get("converged", True)))
        except (ValueError, OSError) as exc:
            logger.warning("QuaLiKiz output parse error: %s", exc)
            return empty_gk_output()
