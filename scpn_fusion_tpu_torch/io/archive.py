"""Tokamak shot archive: machine profile loaders + live-feed polling.

Role-parity with the reference's archive layer (``io/tokamak_archive.py:
98-470`` DIII-D/C-Mod loaders, ``fetch_mdsplus_profiles`` :220,
``poll_mdsplus_feed`` :300 with fallback telemetry, ``load_machine_profiles``
:398; synthetic generator ``io/tokamak_synthetic_archive.py``), redesigned:

* profiles are a frozen :class:`MachineProfiles` record of NumPy arrays
  (host-side I/O stays NumPy; conversion to device arrays happens at the
  solver boundary),
* reference data live as size-capped JSON files under a data root
  (``SCPN_TPU_DATA_ROOT`` env var or ``validation/reference_data``),
* MDSplus is an optional dependency: when absent (always, in this image),
  fetches degrade to the deterministic synthetic generator and a fallback
  telemetry event is recorded against the budget ledger
  (``utils/telemetry.py``) — the reference's fail-open-with-accounting
  contract (``fallback_telemetry.py:82-128``),
* :func:`poll_feed` yields monotone time-stamped frames suitable for the
  digital-twin / disruption replay consumers.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Iterator

import numpy as np

from scpn_fusion_tpu_torch.utils.telemetry import record_fallback_event

MAX_PROFILE_BYTES = 8 * 1024 * 1024

KNOWN_MACHINES = ("diiid", "cmod", "sparc", "iter", "jet", "mast")


@dataclasses.dataclass(frozen=True)
class MachineProfiles:
    """1D kinetic profiles for one shot/time-slice."""

    machine: str
    shot: int
    time_s: float
    rho: np.ndarray            # normalised sqrt toroidal flux, (n,)
    t_e_kev: np.ndarray
    t_i_kev: np.ndarray
    n_e_19: np.ndarray         # 1e19 m^-3
    ip_ma: float
    b0_t: float
    r0_m: float
    a_m: float
    source: str = "synthetic"  # "reference" | "mdsplus" | "synthetic"

    def __post_init__(self):
        n = self.rho.shape[0]
        for name in ("t_e_kev", "t_i_kev", "n_e_19"):
            arr = getattr(self, name)
            if arr.shape != (n,):
                raise ValueError(f"{name} shape {arr.shape} != rho ({n},)")
            if not np.all(np.isfinite(arr)) or np.any(arr < 0):
                raise ValueError(f"{name} must be finite and non-negative")
        if not (np.all(np.diff(self.rho) > 0) and self.rho[0] >= 0.0):
            raise ValueError("rho must be strictly increasing from >= 0")

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        for k, v in d.items():
            if isinstance(v, np.ndarray):
                d[k] = v.tolist()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "MachineProfiles":
        arrays = {k: np.asarray(d[k], dtype=np.float64)
                  for k in ("rho", "t_e_kev", "t_i_kev", "n_e_19")}
        return cls(
            machine=str(d["machine"]), shot=int(d["shot"]),
            time_s=float(d.get("time_s", 0.0)), **arrays,
            ip_ma=float(d["ip_ma"]), b0_t=float(d["b0_t"]),
            r0_m=float(d["r0_m"]), a_m=float(d["a_m"]),
            source=str(d.get("source", "reference")))


_MACHINE_DEFAULTS = {
    # machine: (ip_ma, b0_t, r0_m, a_m, t_core_kev, n_core_19)
    "diiid": (1.2, 2.1, 1.67, 0.67, 4.0, 6.0),
    "cmod": (1.0, 5.4, 0.68, 0.22, 3.5, 20.0),
    "sparc": (8.7, 12.2, 1.85, 0.57, 20.0, 30.0),
    "iter": (15.0, 5.3, 6.2, 2.0, 25.0, 10.0),
    "jet": (3.0, 3.4, 2.96, 1.0, 8.0, 8.0),
    "mast": (1.0, 0.55, 0.85, 0.65, 1.5, 4.0),
}


def _mtanh(rho: np.ndarray, core: float, ped: float, sol: float,
           pos: float = 0.95, width: float = 0.04) -> np.ndarray:
    """Core-parabola + mtanh pedestal composite (H-mode shape)."""
    x = (pos - rho) / (2.0 * width)
    mth = (ped - sol) / 2.0 * (np.tanh(x) + 1.0) + sol
    core_part = np.maximum(core - ped, 0.0) * np.maximum(
        1.0 - (rho / pos) ** 2, 0.0) ** 1.5
    return mth + core_part


def synthetic_machine_profiles(machine: str, shot: int, *,
                               time_s: float = 1.0, n_rho: int = 64,
                               h_mode: bool = True) -> MachineProfiles:
    """Deterministic synthetic shot (reference
    ``io/tokamak_synthetic_archive.py`` role).

    Shot number seeds small reproducible shot-to-shot variation.
    """
    m = machine.lower()
    if m not in _MACHINE_DEFAULTS:
        raise ValueError(f"unknown machine {machine!r}; "
                         f"expected one of {KNOWN_MACHINES}")
    ip, b0, r0, a, t_core, n_core = _MACHINE_DEFAULTS[m]
    rng = np.random.default_rng(abs(hash((m, int(shot)))) % (2 ** 31))
    jitter = 1.0 + 0.05 * rng.standard_normal(3)
    rho = np.linspace(0.0, 1.0, n_rho)
    if h_mode:
        te = _mtanh(rho, t_core * jitter[0], 0.25 * t_core, 0.05)
        ne = _mtanh(rho, n_core * jitter[1], 0.6 * n_core, 0.1 * n_core)
    else:
        te = t_core * jitter[0] * np.maximum(1.0 - rho ** 2, 0.0) ** 1.5 \
            + 0.05
        ne = n_core * jitter[1] * np.maximum(1.0 - rho ** 2, 0.0) + 0.1
    ti = te * (0.9 + 0.1 * jitter[2])
    return MachineProfiles(
        machine=m, shot=int(shot), time_s=float(time_s), rho=rho,
        t_e_kev=te, t_i_kev=ti, n_e_19=ne, ip_ma=ip * jitter[0],
        b0_t=b0, r0_m=r0, a_m=a, source="synthetic")


def data_root() -> Path:
    env = os.environ.get("SCPN_TPU_DATA_ROOT")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "validation" \
        / "reference_data"


def _profile_path(machine: str, shot: int, root: Path) -> Path:
    return root / machine.lower() / f"shot_{int(shot)}.json"


def save_reference_profiles(profiles: MachineProfiles,
                            root: Path | None = None) -> Path:
    root = root or data_root()
    path = _profile_path(profiles.machine, profiles.shot, root)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(profiles.to_dict(), indent=1))
    return path


def load_machine_profiles(machine: str, shot: int, *,
                          root: Path | None = None,
                          allow_synthetic: bool = True) -> MachineProfiles:
    """Load from the reference-data root; degrade to synthetic with a
    telemetry event (reference ``load_machine_profiles``
    ``tokamak_archive.py:398`` fallback semantics)."""
    root = root or data_root()
    path = _profile_path(machine, shot, root)
    if path.exists():
        if path.stat().st_size > MAX_PROFILE_BYTES:
            raise ValueError(f"profile file exceeds size cap: {path}")
        d = json.loads(path.read_text())
        prof = MachineProfiles.from_dict(d)
        return prof
    if not allow_synthetic:
        raise FileNotFoundError(f"no reference profiles for "
                                f"{machine}#{shot} under {root}")
    record_fallback_event("archive", "synthetic_profiles",
                          {"machine": machine, "shot": int(shot)})
    return synthetic_machine_profiles(machine, shot)


def fetch_mdsplus_profiles(machine: str, shot: int, *,
                           server: str | None = None) -> MachineProfiles:
    """MDSplus fetch with fail-open synthetic fallback.

    MDSplus is an optional dependency (reference
    ``fetch_mdsplus_profiles`` :220); when the module or server is
    unavailable the call degrades to the synthetic generator and records a
    budget-enforced fallback event.
    """
    try:
        import MDSplus  # type: ignore  # noqa: F401
    except ImportError:
        record_fallback_event("archive", "mdsplus_unavailable",
                              {"machine": machine, "shot": int(shot)})
        return synthetic_machine_profiles(machine, shot)
    raise NotImplementedError(
        "live MDSplus fetch requires a configured server")


def poll_feed(machine: str, shot: int, *, n_frames: int = 10,
              dt_s: float = 0.1,
              start_s: float = 0.0) -> Iterator[MachineProfiles]:
    """Yield a monotone time series of profile frames (reference
    ``poll_mdsplus_feed`` :300 live-feed shape, synthetic telemetry)."""
    base = load_machine_profiles(machine, shot)
    for k in range(n_frames):
        t = start_s + k * dt_s
        ramp = min(1.0, 0.5 + 0.5 * (k + 1) / max(n_frames, 1))
        yield dataclasses.replace(
            base, time_s=t,
            t_e_kev=base.t_e_kev * ramp,
            t_i_kev=base.t_i_kev * ramp,
            n_e_19=base.n_e_19 * ramp)
