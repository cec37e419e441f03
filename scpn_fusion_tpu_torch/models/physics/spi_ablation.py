"""Multi-fragment shattered-pellet-injection (SPI) ablation solver (port of
``scpn_fusion_tpu/models/physics/spi_ablation.py``).

N neutral fragments fly from an outboard injector into the plasma and
ablate with the shielding-modified Parks scaling

    dm/dt  ~  n_e^0.33  T_e^1.64  r_p^1.33      [Parks, NF 57 (2017), Eq. 8]

with the reference's mixed-unit prefactor (n_e in 1e20 m^-3, T_e in keV,
r_p in cm, rate in g/s).  The fragment cloud is a structure of arrays
(:class:`FragmentState`); fragment "death" is masking; the injection is a
Python loop of :func:`spi_step` on plain PyTorch ops, and
:func:`spi_quantity_sweep` runs every inventory as one batch of that loop.

The deposition is a scatter-add onto the rho grid (``index_add_``: on a CUDA
tensor its atomics sum two fragments of one cell in either order, so the
card's float64 deposition agrees with the CPU's to rounding, not bit for
bit).  ``time_90pct_ms`` is float32, as JAX makes it even under x64.

Draws: JAX draws the cloud from a threefry key; :func:`spi_init` draws the
same three normal samples (direction, speed, position) from a
``torch.Generator``, and :func:`_spi_init` takes them (the CPU tests feed it
JAX's).  The injector's position and direction pass through float32 first,
as JAX's ``jnp.asarray(..., dtype=float32)`` does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from scpn_fusion_tpu_torch.control.scenario import interp
from scpn_fusion_tpu_torch.core.grid import linspace

AMU_KG = 1.66e-27
M_NEON_KG = 20.18 * AMU_KG
RHO_NEON_SOLID = 1444.0           # kg/m^3 (solid neon, CRC)
PARKS_COEFF_G_S = 2.0             # mixed units: ne[1e20]^.33 Te[keV]^1.64 rp[cm]^1.33


@dataclasses.dataclass(frozen=True)
class SpiConfig:
    """Injection + machine geometry (reference defaults mirrored)."""

    n_fragments: int = 100
    total_mass_kg: float = 0.01          # 10 g neon
    velocity_mps: float = 200.0
    dispersion: float = 0.1              # direction spread (stdev, per axis)
    speed_jitter: float = 0.1            # fractional speed stdev
    position_jitter_m: float = 0.05
    injector_pos: tuple = (10.0, 0.0, 0.0)
    injector_dir: tuple = (-1.0, 0.0, 0.0)
    r_major_m: float = 6.2
    a_minor_m: float = 2.0
    elongation: float = 1.7
    rho_max: float = 1.2                 # fragments beyond this are inert
    te_floor_kev: float = 0.01           # no ablation below this

    def __post_init__(self):
        if int(self.n_fragments) < 1:
            raise ValueError("n_fragments must be >= 1")
        for name in ("total_mass_kg", "velocity_mps"):
            if not float(getattr(self, name)) > 0.0:
                raise ValueError(f"{name} must be > 0")
        if float(self.dispersion) < 0.0:
            raise ValueError("dispersion must be >= 0")
        if len(tuple(self.injector_dir)) != 3:
            raise ValueError("injector_dir must be a 3-vector")


class FragmentState(NamedTuple):
    """Structure-of-arrays fragment cloud (shapes (..., N, 3) / (..., N))."""

    pos_m: torch.Tensor       # (..., N, 3)
    vel_mps: torch.Tensor     # (..., N, 3)
    mass_kg: torch.Tensor     # (..., N)


class SpiDraws(NamedTuple):
    """The cloud's three normal samples."""

    direction: torch.Tensor   # (N, 3)
    speed: torch.Tensor       # (N,)
    position: torch.Tensor    # (N, 3)


class SpiTrace(NamedTuple):
    deposition_m3s: torch.Tensor   # (T, n_rho) particles / m^3 / s
    mass_total_kg: torch.Tensor    # (T,) surviving solid inventory
    n_active: torch.Tensor         # (T,)


class SpiSummary(NamedTuple):
    assimilated_particles: torch.Tensor   # total ablated atoms
    assimilated_fraction: torch.Tensor    # of injected inventory
    delta_ne20_volavg: torch.Tensor       # volume-averaged density step
    time_90pct_ms: torch.Tensor           # time to 90% assimilation (float32)


def _radius_from_mass(mass_kg: torch.Tensor) -> torch.Tensor:
    """Solid-sphere radius [m]; exact zero at zero mass."""
    vol = torch.clamp(mass_kg, min=0.0) / RHO_NEON_SOLID
    return (3.0 * vol / (4.0 * math.pi)) ** (1.0 / 3.0)


def spi_draws(cfg: SpiConfig, generator: torch.Generator | None = None, *,
              dtype: torch.dtype = torch.float32) -> SpiDraws:
    """The cloud's normal samples from ``generator`` (a fresh one seeded 0
    when None), on the CPU."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    n = int(cfg.n_fragments)
    return SpiDraws(torch.randn((n, 3), generator=gen, dtype=dtype),
                    torch.randn((n,), generator=gen, dtype=dtype),
                    torch.randn((n, 3), generator=gen, dtype=dtype))


def _spi_init(cfg: SpiConfig, draws: SpiDraws, *, dtype: torch.dtype,
              device: torch.device | str) -> FragmentState:
    """The fragment cloud from its draws (reference ``__init__``
    distributions: direction = normalise(dir + N(0, dispersion)^3), speed =
    v0 N(1, jitter), position = injector + N(0, jitter)^3)."""
    n = int(cfg.n_fragments)
    dir_noise, spd_noise, pos_noise = (d.to(device=device, dtype=dtype) for d in draws)
    base_dir = torch.tensor(cfg.injector_dir, dtype=torch.float32, device=device)
    base_dir = (base_dir / torch.linalg.vector_norm(base_dir)).to(dtype)
    d = base_dir[None, :] + cfg.dispersion * dir_noise
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    speed = cfg.velocity_mps * (1.0 + cfg.speed_jitter * spd_noise)
    pos = (torch.tensor(cfg.injector_pos, dtype=torch.float32, device=device).to(dtype)[None, :]
           + cfg.position_jitter_m * pos_noise)
    mass = torch.full((n,), cfg.total_mass_kg / n, dtype=dtype, device=device)
    return FragmentState(pos_m=pos, vel_mps=d * speed[:, None], mass_kg=mass)


def spi_init(cfg: SpiConfig, generator: torch.Generator | None = None, *,
             dtype: torch.dtype = torch.float32,
             device: torch.device | str = "cuda") -> FragmentState:
    """Sample the fragment cloud (reference ``__init__`` distributions)."""
    return _spi_init(cfg, spi_draws(cfg, generator, dtype=dtype), dtype=dtype, device=device)


def spi_step(state: FragmentState, *, ne19_prof: torch.Tensor, te_kev_prof: torch.Tensor,
             dt_s: float, cfg: SpiConfig) -> tuple[FragmentState, torch.Tensor]:
    """One ballistic + ablation step; returns (state', deposition).

    Deposition is particles/m^3/s on the ``len(ne19_prof)``-point rho grid
    (reference ``SpiAblationSolver.step`` contract), (..., n_rho) for a
    batch of clouds.
    """
    n_rho = ne19_prof.shape[0]
    rho_axis = linspace(0.0, 1.0, n_rho, ne19_prof.dtype, ne19_prof.device)

    pos = state.pos_m + state.vel_mps * dt_s
    r_loc = torch.sqrt(pos[..., 0] ** 2 + pos[..., 1] ** 2)
    z_loc = pos[..., 2]
    rho = torch.sqrt(((r_loc - cfg.r_major_m) / cfg.a_minor_m) ** 2
                     + (z_loc / cfg.elongation) ** 2)

    ne19 = interp(rho, rho_axis, ne19_prof)
    te = interp(rho, rho_axis, te_kev_prof)

    in_plasma = (rho <= cfg.rho_max) & (te >= cfg.te_floor_kev)
    alive = state.mass_kg > 0.0
    active = in_plasma & alive

    # Parks NF 57 (2017) Eq. 8, mixed units -> kg/s.
    rp_cm = _radius_from_mass(state.mass_kg) * 100.0
    ne20 = torch.clamp(ne19 / 10.0, min=0.0)
    dm_dt_kg = 1e-3 * PARKS_COEFF_G_S * (ne20 ** 0.33) * (te ** 1.64) * (rp_cm ** 1.33)
    zero = torch.zeros_like(state.mass_kg)
    delta_m = torch.where(active, torch.minimum(dm_dt_kg * dt_s, state.mass_kg), zero)

    n_particles = delta_m / M_NEON_KG

    # Shell-volume normalisation per reference (smooth on-axis guard).
    drho = 1.0 / (n_rho - 1)
    r_minor = rho * cfg.a_minor_m
    dv = 4.0 * math.pi ** 2 * cfg.r_major_m * r_minor * (cfg.a_minor_m * drho)
    dv = torch.clamp(dv, min=1.0)  # reference: dV < 1e-3 -> 1.0 on-axis guard
    idx = torch.clamp(torch.round(rho * (n_rho - 1)).to(torch.int64), 0, n_rho - 1)
    contrib = torch.where(active, (n_particles / dt_s) / dv, zero)
    batch = contrib.shape[:-1]
    offsets = (torch.arange(math.prod(batch), device=idx.device) * n_rho).reshape(*batch, 1)
    deposition = torch.zeros(math.prod(batch) * n_rho, dtype=contrib.dtype,
                             device=contrib.device).index_add_(
        0, (idx + offsets).reshape(-1), contrib.reshape(-1)).reshape(*batch, n_rho)

    return FragmentState(pos_m=pos, vel_mps=state.vel_mps,
                         mass_kg=state.mass_kg - delta_m), deposition


def _time_90pct_ms(m0, mass_trace, mass_final, dt_s: float, n_steps: int, *,
                   folded: bool = False) -> torch.Tensor:
    """Time [ms] to 90% of the final assimilation, float32 (``:203-208``).
    ``folded``: the step index times float32(dt_s) * float32(1e3) formed
    first, as XLA folds the two constants where ``dt_s`` is one (the sweep);
    else times dt_s, then 1e3 (``run_spi_injection``, where it is traced)."""
    ablated_cum = m0[..., None] - mass_trace  # monotone by construction
    target = 0.9 * (m0 - mass_final)
    reached = ablated_cum >= torch.clamp(target, min=1e-30)[..., None]
    first = torch.argmax(reached.to(torch.uint8), dim=-1).to(torch.float32)
    at = (first * float(np.float32(dt_s) * np.float32(1e3)) if folded
          else first * dt_s * 1e3)
    return torch.where(torch.any(reached, dim=-1), at,
                       torch.tensor(n_steps * dt_s * 1e3, dtype=torch.float32,
                                    device=first.device))


def _plasma_volume(cfg: SpiConfig) -> float:
    return 2.0 * math.pi ** 2 * cfg.r_major_m * cfg.a_minor_m ** 2 * cfg.elongation


def _run_spi_injection(cfg: SpiConfig, state0: FragmentState, ne19_prof: torch.Tensor,
                       te_kev_prof: torch.Tensor, *, dt_s: float = 5e-5,
                       n_steps: int = 400) -> tuple[SpiTrace, SpiSummary]:
    """The injection from the cloud ``state0``: per-step trace + summary."""
    state, rows = state0, []
    for _ in range(n_steps):
        state, dep = spi_step(state, ne19_prof=ne19_prof, te_kev_prof=te_kev_prof, dt_s=dt_s,
                              cfg=cfg)
        rows.append((dep, torch.sum(state.mass_kg),
                     torch.sum(state.mass_kg > 0.0).to(torch.int32)))
    dep, mass, nact = (torch.stack(col) for col in zip(*rows))
    # Ledger against the SUMMED initial inventory (f32 rounding of the
    # per-fragment split must not alias into a phantom source/sink).
    m0 = torch.sum(state0.mass_kg)
    m_final = torch.sum(state.mass_kg)
    injected = m0 / M_NEON_KG
    assimilated = torch.clamp(m0 - m_final, min=0.0) / M_NEON_KG
    return (SpiTrace(deposition_m3s=dep, mass_total_kg=mass, n_active=nact),
            SpiSummary(assimilated_particles=assimilated,
                       assimilated_fraction=assimilated / injected,
                       delta_ne20_volavg=assimilated / _plasma_volume(cfg) / 1e20,
                       time_90pct_ms=_time_90pct_ms(m0, mass, m_final, dt_s, n_steps)))


def run_spi_injection(cfg: SpiConfig, generator: torch.Generator | None,
                      ne19_prof: torch.Tensor, te_kev_prof: torch.Tensor, *,
                      dt_s: float = 5e-5, n_steps: int = 400) -> tuple[SpiTrace, SpiSummary]:
    """The whole injection, the cloud drawn from ``generator``; follows the
    profiles' device and dtype."""
    state0 = spi_init(cfg, generator, dtype=ne19_prof.dtype, device=ne19_prof.device)
    return _run_spi_injection(cfg, state0, ne19_prof, te_kev_prof, dt_s=dt_s, n_steps=n_steps)


def _spi_quantity_sweep(cfg: SpiConfig, state0: FragmentState, masses_kg: torch.Tensor,
                        ne19_prof: torch.Tensor, te_kev_prof: torch.Tensor, *,
                        dt_s: float = 5e-5, n_steps: int = 400) -> SpiSummary:
    """The injection of ``state0`` scaled to each pellet inventory
    (``masses_kg`` (B,), taken in the profiles' dtype), every inventory one
    batch of the step loop."""
    masses_kg = torch.as_tensor(masses_kg, dtype=ne19_prof.dtype, device=ne19_prof.device)
    scale = masses_kg / cfg.total_mass_kg
    b = masses_kg.shape[0]
    state = FragmentState(pos_m=state0.pos_m.expand(b, -1, -1),
                          vel_mps=state0.vel_mps.expand(b, -1, -1),
                          mass_kg=state0.mass_kg[None, :] * scale[:, None])
    m0 = torch.sum(state.mass_kg, dim=-1)
    masses = []
    for _ in range(n_steps):
        state, _ = spi_step(state, ne19_prof=ne19_prof, te_kev_prof=te_kev_prof, dt_s=dt_s,
                            cfg=cfg)
        masses.append(torch.sum(state.mass_kg, dim=-1))
    m_final = torch.sum(state.mass_kg, dim=-1)
    assimilated = torch.clamp(m0 - m_final, min=0.0) / M_NEON_KG
    injected = m0 / M_NEON_KG
    return SpiSummary(assimilated_particles=assimilated,
                      assimilated_fraction=assimilated / injected,
                      delta_ne20_volavg=assimilated / _plasma_volume(cfg) / 1e20,
                      time_90pct_ms=_time_90pct_ms(m0, torch.stack(masses, dim=-1), m_final,
                                                   dt_s, n_steps, folded=True))


def spi_quantity_sweep(cfg: SpiConfig, generator: torch.Generator | None,
                       masses_kg: torch.Tensor, ne19_prof: torch.Tensor,
                       te_kev_prof: torch.Tensor, *, dt_s: float = 5e-5,
                       n_steps: int = 400) -> SpiSummary:
    """The full injection over pellet inventories (mitigation scan): one
    cloud drawn from ``generator``, its mass scaled to each inventory."""
    state0 = spi_init(cfg, generator, dtype=ne19_prof.dtype, device=ne19_prof.device)
    return _spi_quantity_sweep(cfg, state0, masses_kg, ne19_prof, te_kev_prof, dt_s=dt_s,
                               n_steps=n_steps)
