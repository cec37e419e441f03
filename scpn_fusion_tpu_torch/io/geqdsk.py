"""G-EQDSK equilibrium file reader/writer (fail-closed).

From-scratch implementation of the standard EFIT G-EQDSK exchange format,
covering the same surface as the reference's ``core/eqdsk.py`` (container
:61-195, tokenizer :197-243, schema validation :245+, ``read_geqdsk`` :349,
``write_geqdsk`` :542): 48-char header with grid dims, 4 scalar records of 5
Fortran floats, five nw-length profile arrays (fpol, pres, ffprime, pprime,
qpsi), the (nh, nw) psi map, and boundary/limiter contours.

Notable format hazards handled here:
* Fortran floats may run together without separators
  (``-8.33E-06-6.04E-02``) — tokenised by regex, not ``split()``.
* ``D`` exponents, missing ``E`` (``1.5-101``) are normalised.
* All values validated finite; dimensions capped (size-bomb guard), matching
  the reference's fail-closed stance.
"""

from __future__ import annotations

import dataclasses
import math
import re
from pathlib import Path

import numpy as np

MAX_GEQDSK_BYTES = 20 * 1024 * 1024
MAX_GRID_POINTS = 4096 * 4096
MAX_CONTOUR_POINTS = 100_000

# Fortran-style float: optional sign, digits with optional decimal point,
# optional E/D exponent — INCLUDING the bare-exponent form Fortran emits
# when a 3-digit exponent squeezes out the 'E' ("1.5-101" == 1.5e-101).
# The bare branch requires a decimal point in the mantissa and >= 2 exponent
# digits so "1-2" in free text is not mis-tokenised (ADVICE.md r1 medium).
_FLOAT_RE = re.compile(
    r"[+-]?(?:\d+\.\d*|\.\d+)(?:[EeDd][+-]?\d+|[+-]\d{2,3})?"
    r"|[+-]?\d+(?:[EeDd][+-]?\d+)?")


def _normalise_fortran_float(tok: str) -> str:
    """Insert the elided 'E' in bare-exponent Fortran floats ("1.5-101")."""
    m = re.match(r"^([+-]?(?:\d+\.\d*|\.\d+))([+-]\d{2,3})$", tok)
    if m:
        return m.group(1) + "E" + m.group(2)
    return tok


class GeqdskError(ValueError):
    """Raised on malformed or unsafe GEQDSK content."""


@dataclasses.dataclass
class GEqdsk:
    """All data in a G-EQDSK file (psi in Wb/rad, SI units)."""

    description: str = ""
    nw: int = 0
    nh: int = 0

    rdim: float = 0.0
    zdim: float = 0.0
    rcentr: float = 0.0
    rleft: float = 0.0
    zmid: float = 0.0
    rmaxis: float = 0.0
    zmaxis: float = 0.0
    simag: float = 0.0
    sibry: float = 0.0
    bcentr: float = 0.0
    current: float = 0.0

    fpol: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0))
    pres: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0))
    ffprime: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0))
    pprime: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0))
    qpsi: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0))
    psirz: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0, 0)))

    rbdry: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0))
    zbdry: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0))
    rlim: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0))
    zlim: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0))

    @property
    def r(self) -> np.ndarray:
        return np.linspace(self.rleft, self.rleft + self.rdim, self.nw)

    @property
    def z(self) -> np.ndarray:
        return np.linspace(self.zmid - self.zdim / 2, self.zmid + self.zdim / 2, self.nh)

    @property
    def psi_norm(self) -> np.ndarray:
        return np.linspace(0.0, 1.0, self.nw)

    def psi_to_norm(self, psi: np.ndarray) -> np.ndarray:
        return (psi - self.simag) / (self.sibry - self.simag)

    def to_config(self, name: str = "eqdsk") -> dict:
        """Convert to a reactor-config dict (no coils in GEQDSK files —
        boundary contour carried as shape metadata, reference ``to_config``
        :128-195 semantics)."""
        r, z = self.r, self.z
        cfg = {
            "reactor_name": name,
            "grid_resolution": [int(self.nw), int(self.nh)],
            "dimensions": {
                "R_min": float(r[0]), "R_max": float(r[-1]),
                "Z_min": float(z[0]), "Z_max": float(z[-1]),
            },
            "coils": [],
            "physics": {
                "plasma_current_target": float(self.current),
                "vacuum_permeability": 4e-7 * math.pi,
            },
            "free_boundary": {
                "magnetic_axis": [float(self.rmaxis), float(self.zmaxis)],
                "psi_axis": float(self.simag),
                "psi_boundary": float(self.sibry),
                "boundary_points": np.stack([self.rbdry, self.zbdry], axis=1).tolist()
                if self.rbdry.size else [],
                "limiter_points": np.stack([self.rlim, self.zlim], axis=1).tolist()
                if self.rlim.size else [],
            },
        }
        return cfg


def _parse_float(tok: str, field_name: str) -> float:
    try:
        v = float(_normalise_fortran_float(tok).replace("D", "E").replace("d", "e"))
    except ValueError as exc:
        raise GeqdskError(f"GEQDSK {field_name}: bad float {tok!r}") from exc
    if not math.isfinite(v):
        raise GeqdskError(f"GEQDSK {field_name} must be finite")
    return v


class _Tokens:
    """Stream of Fortran floats pulled line-by-line from the file body."""

    def __init__(self, lines: list[str]):
        self._lines = lines
        self._i = 0
        self._buf: list[str] = []

    def take(self, n: int, field_name: str) -> np.ndarray:
        out: list[float] = []
        while len(out) < n:
            while not self._buf:
                if self._i >= len(self._lines):
                    raise GeqdskError(
                        f"GEQDSK truncated while reading {field_name} "
                        f"({len(out)}/{n} values)")
                self._buf = _FLOAT_RE.findall(self._lines[self._i])
                self._i += 1
            out.append(_parse_float(self._buf.pop(0), field_name))
        return np.asarray(out, dtype=np.float64)

    def take_ints(self, n: int, field_name: str) -> list[int]:
        vals = self.take(n, field_name)
        return [int(v) for v in vals]


def _validate(eq: GEqdsk) -> None:
    if eq.nw < 2 or eq.nh < 2:
        raise GeqdskError(f"grid dims must be >= 2x2, got {(eq.nw, eq.nh)}")
    if eq.nw * eq.nh > MAX_GRID_POINTS:
        raise GeqdskError("grid dims exceed safety limit")
    if eq.rdim <= 0 or eq.zdim <= 0:
        raise GeqdskError("rdim and zdim must be positive")
    if eq.rcentr <= 0:
        raise GeqdskError("rcentr must be positive")
    if eq.sibry == eq.simag:
        raise GeqdskError("psi boundary must differ from psi axis")
    for nm in ("fpol", "pres", "ffprime", "pprime", "qpsi"):
        arr = getattr(eq, nm)
        if arr.shape != (eq.nw,):
            raise GeqdskError(f"{nm} must have shape ({eq.nw},)")
        if not np.all(np.isfinite(arr)):
            raise GeqdskError(f"{nm} must be finite")
    if eq.psirz.shape != (eq.nh, eq.nw):
        raise GeqdskError(f"psirz must have shape {(eq.nh, eq.nw)}")
    if not np.all(np.isfinite(eq.psirz)):
        raise GeqdskError("psirz must be finite")
    for rn, zn in (("rbdry", "zbdry"), ("rlim", "zlim")):
        if getattr(eq, rn).shape != getattr(eq, zn).shape:
            raise GeqdskError(f"{rn}/{zn} must have matching lengths")


def read_geqdsk(path: str | Path) -> GEqdsk:
    """Read and validate a G-EQDSK file."""
    p = Path(path)
    if p.stat().st_size > MAX_GEQDSK_BYTES:
        raise GeqdskError(f"file exceeds {MAX_GEQDSK_BYTES} byte limit: {p}")
    text = p.read_text(encoding="utf-8", errors="replace")
    lines = text.splitlines()
    if not lines:
        raise GeqdskError("empty GEQDSK file")

    header = lines[0]
    parts = header.split()
    if len(parts) < 3:
        raise GeqdskError("header must end with idum nw nh")
    try:
        nh = int(parts[-1])
        nw = int(parts[-2])
    except ValueError as exc:
        raise GeqdskError("header nw/nh must be integers") from exc
    desc = header[:48].strip()

    toks = _Tokens(lines[1:])
    s1 = toks.take(5, "record1")   # rdim zdim rcentr rleft zmid
    s2 = toks.take(5, "record2")   # rmaxis zmaxis simag sibry bcentr
    s3 = toks.take(5, "record3")   # current simag xdum rmaxis xdum
    s4 = toks.take(5, "record4")   # zmaxis xdum sibry xdum xdum

    eq = GEqdsk(
        description=desc, nw=nw, nh=nh,
        rdim=s1[0], zdim=s1[1], rcentr=s1[2], rleft=s1[3], zmid=s1[4],
        rmaxis=s2[0], zmaxis=s2[1], simag=s2[2], sibry=s2[3], bcentr=s2[4],
        current=s3[0],
    )
    del s4  # redundant duplicates (zmaxis, sibry) — canonical values kept

    eq.fpol = toks.take(nw, "fpol")
    eq.pres = toks.take(nw, "pres")
    eq.ffprime = toks.take(nw, "ffprime")
    eq.pprime = toks.take(nw, "pprime")
    eq.psirz = toks.take(nw * nh, "psirz").reshape(nh, nw)
    eq.qpsi = toks.take(nw, "qpsi")

    try:
        nbdry, nlim = toks.take_ints(2, "contour counts")
    except GeqdskError:
        nbdry, nlim = 0, 0
    for nm, count in (("bdry", nbdry), ("lim", nlim)):
        if count < 0 or count > MAX_CONTOUR_POINTS:
            raise GeqdskError(f"{nm} count out of range: {count}")
    if nbdry > 0:
        pairs = toks.take(2 * nbdry, "boundary").reshape(nbdry, 2)
        eq.rbdry, eq.zbdry = pairs[:, 0].copy(), pairs[:, 1].copy()
    if nlim > 0:
        pairs = toks.take(2 * nlim, "limiter").reshape(nlim, 2)
        eq.rlim, eq.zlim = pairs[:, 0].copy(), pairs[:, 1].copy()

    _validate(eq)
    return eq


def _fmt_one(v: float) -> str:
    """One value in 16 columns of Fortran E16.9.

    Three cases by exponent width and sign:

    * 2-digit exponent, negative value: the standard form is exactly 16
      chars starting with '-'.  KEEP it — external fixed-width readers
      ``float()`` it, and the leading sign is an unambiguous token
      boundary for regex readers (ADVICE.md r2 medium: the bare form was
      an interop regression here).
    * 3-digit exponent, positive value: the standard form is 16 chars
      starting with a DIGIT — it merges with the preceding token for any
      whitespace/regex reader (``...E+003.890...``).  Fortran's answer is
      dropping the 'E' (bare-exponent ``3.89-146``, 15 chars, padded to a
      leading space); emit that — the tokenizer normalises it back
      (hypothesis round-trip lane, ``tests/test_fuzz_parsers.py``).
    * 3-digit exponent, negative value: the standard form is 17 chars —
      too wide; the bare form is the only option (16 chars, sign-leading,
      unambiguous)."""
    s = f"{v:16.9E}"
    if len(s) > 16 or s[0] not in (" ", "-"):
        s = s.replace("E", "")
        s = " " * max(16 - len(s), 0) + s
    return s


def _fmt(values) -> str:
    """Format a flat value sequence as Fortran 5E16.9 records."""
    out = []
    vals = np.asarray(values, dtype=np.float64).ravel()
    for i in range(0, len(vals), 5):
        chunk = vals[i:i + 5]
        out.append("".join(_fmt_one(v) for v in chunk))
    return "\n".join(out)


def write_geqdsk(eq: GEqdsk, path: str | Path, *, description: str | None = None) -> None:
    """Write a validated G-EQDSK file (5E16.9 records)."""
    _validate(eq)
    desc = (description if description is not None else eq.description)[:48]
    lines = [f"{desc:<48s} 0 {eq.nw:4d} {eq.nh:4d}"]
    lines.append(_fmt([eq.rdim, eq.zdim, eq.rcentr, eq.rleft, eq.zmid]))
    lines.append(_fmt([eq.rmaxis, eq.zmaxis, eq.simag, eq.sibry, eq.bcentr]))
    lines.append(_fmt([eq.current, eq.simag, 0.0, eq.rmaxis, 0.0]))
    lines.append(_fmt([eq.zmaxis, 0.0, eq.sibry, 0.0, 0.0]))
    for arr in (eq.fpol, eq.pres, eq.ffprime, eq.pprime):
        lines.append(_fmt(arr))
    lines.append(_fmt(eq.psirz))
    lines.append(_fmt(eq.qpsi))
    lines.append(f"{eq.rbdry.size:5d}{eq.rlim.size:5d}")
    if eq.rbdry.size:
        lines.append(_fmt(np.stack([eq.rbdry, eq.zbdry], axis=1)))
    if eq.rlim.size:
        lines.append(_fmt(np.stack([eq.rlim, eq.zlim], axis=1)))
    Path(path).write_text("\n".join(lines) + "\n", encoding="utf-8")


def geqdsk_from_solution(cfg, res, *, description: str = "scpn-fusion-tpu",
                         bcentr: float = 1.0) -> GEqdsk:
    """Build a writable :class:`GEqdsk` from a solved fixed-boundary
    equilibrium (``models.equilibrium.EquilibriumResult``).

    Export counterpart of the reference's eqdsk writer (``io/eqdsk.py``):
    psirz is the solved flux map; simag/sibry come from the axis max and
    the boundary ring; the 1D tables carry the solver's own p'(psi_N) and
    FF'(psi_N) profile shapes with pressure and F integrated from them
    (F(1)^2 = (rcentr*bcentr)^2).  ``qpsi`` is exported as zeros — the
    writer's consumers here (round-trip + reconstruction lanes) do not
    define a q table for fixed-boundary normalised-unit solves.

    This function is the one part of the file that differs from
    ``scpn_fusion_tpu/io/geqdsk.py``: ``res`` holds the port's tensors (on any
    device), and the profile tables come from the port's profiles.
    """
    import torch

    from scpn_fusion_tpu_torch.models.equilibrium.profiles import (
        mtanh_profile,
        profile_coeffs_from_physics,
    )

    psi = res.psi.detach().cpu().numpy().astype(np.float64)
    nh, nw = psi.shape
    r_min, r_max = cfg.dimensions.R_min, cfg.dimensions.R_max
    z_min, z_max = cfg.dimensions.Z_min, cfg.dimensions.Z_max
    iz, ir = np.unravel_index(np.argmax(psi), psi.shape)
    r_1d = np.linspace(r_min, r_max, nw)
    z_1d = np.linspace(z_min, z_max, nh)
    simag = float(psi[iz, ir])
    sibry = float(psi[0].max())         # Dirichlet boundary ring value scale
    rcentr = 0.5 * (r_min + r_max)

    psi_n = np.linspace(0.0, 1.0, nw)
    p_c, ff_c = profile_coeffs_from_physics(cfg.physics, torch.float64, "cpu")
    pprime = mtanh_profile(torch.from_numpy(psi_n), p_c).numpy()
    ffprime = mtanh_profile(torch.from_numpy(psi_n), ff_c).numpy()

    # Integrate the tables: psi = simag + psi_N * (sibry - simag).
    dpsi = (sibry - simag) / (nw - 1)
    # p(psi_N) = -int_{psi_N}^{1} p' dpsi  (p(1) = 0 at the boundary)
    rev = np.cumsum((pprime[::-1][:-1] + pprime[::-1][1:]) * 0.5) * dpsi
    pres = np.concatenate([rev[::-1], [0.0]])
    f1_sq = (rcentr * bcentr) ** 2
    rev_ff = np.cumsum((ffprime[::-1][:-1] + ffprime[::-1][1:]) * 0.5) * dpsi
    f_sq = np.concatenate([f1_sq - 2.0 * rev_ff[::-1], [f1_sq]])
    fpol = np.sqrt(np.maximum(f_sq, 0.0))

    return GEqdsk(
        description=description, nw=nw, nh=nh,
        rdim=r_max - r_min, zdim=z_max - z_min,
        rcentr=rcentr, rleft=r_min, zmid=0.5 * (z_min + z_max),
        rmaxis=float(r_1d[ir]), zmaxis=float(z_1d[iz]),
        simag=simag, sibry=sibry, bcentr=bcentr,
        current=float(np.sum(res.j_phi.detach().cpu().numpy())
                      * (r_1d[1] - r_1d[0]) * (z_1d[1] - z_1d[0])),
        fpol=fpol, pres=pres, ffprime=ffprime, pprime=pprime,
        qpsi=np.zeros(nw), psirz=psi,
    )
