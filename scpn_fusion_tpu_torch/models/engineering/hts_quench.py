"""REBCO/HTS magnet quench protection screen (port of
``scpn_fusion_tpu/models/engineering/hts_quench.py``).

The reference's lumped quench screen -- current-sharing temperature,
detection voltage, dump time constant, peak terminal voltage, hotspot
temperature, critical-current margin -- with its fail-closed
verdict-with-failure-list contract.  The hotspot is integrated as an
explicit transient (normal-zone growth, dump decay, Joule heating minus
wetted cooling), JAX's 2000-step ``lax.scan``: on the card one launch of one
thread (``ops/cuda_quench.quench_run``, ``csrc/quench.cu``; row H), on the
CPU its plain version, the loop of :func:`quench_step`.  The report's
reductions are plain ops and host reads, as in JAX.

:func:`quench_step` divides by 0-d tensors (:func:`step_constants`): on a
CUDA tensor PyTorch multiplies by the reciprocal of a Python divisor, and
the kernel divides.  The step time ``k * dt`` is formed in the working
dtype.  The entry points take ``dtype`` (JAX takes its float from
``core.dtypes.default_float``; float32 by default here) and ``device``
(``"cuda"`` by default).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch


def _pos(name: str, v: float) -> float:
    if not math.isfinite(v) or v <= 0.0:
        raise ValueError(f"{name} must be positive and finite, got {v}")
    return float(v)


def _nonneg(name: str, v: float) -> float:
    if not math.isfinite(v) or v < 0.0:
        raise ValueError(f"{name} must be non-negative and finite, got {v}")
    return float(v)


@dataclasses.dataclass(frozen=True)
class REBCOConductor:
    operating_temperature_k: float = 20.0
    critical_temperature_k: float = 90.0
    operating_current_a: float = 40_000.0
    critical_current_a: float = 60_000.0
    inductance_h: float = 1.2
    dump_resistance_ohm: float = 0.15
    stabilizer_resistivity_ohm_m: float = 2.4e-10   # Cu at ~20 K (RRR~100)
    # Linear rho(T) slope for Cu above ~20 K (to ~1.7e-8 ohm m at 300 K);
    # this is the thermal-runaway feedback that makes quenches dangerous.
    resistivity_slope_ohm_m_k: float = 6.0e-11
    stabilizer_area_m2: float = 4.0e-4
    conductor_density_kg_m3: float = 8000.0
    conductor_heat_capacity_j_kg_k: float = 200.0
    wetted_perimeter_m: float = 0.12
    coolant_heat_transfer_w_m2_k: float = 200.0
    quench_detection_threshold_v: float = 0.01
    max_terminal_voltage_v: float = 10_000.0
    max_hotspot_temperature_k: float = 200.0

    def __post_init__(self):
        _pos("operating_temperature_k", self.operating_temperature_k)
        _pos("critical_temperature_k", self.critical_temperature_k)
        _pos("operating_current_a", self.operating_current_a)
        _pos("critical_current_a", self.critical_current_a)
        _pos("inductance_h", self.inductance_h)
        _pos("dump_resistance_ohm", self.dump_resistance_ohm)
        if self.critical_temperature_k <= self.operating_temperature_k:
            raise ValueError("critical temperature must exceed operating")
        if self.critical_current_a <= self.operating_current_a:
            raise ValueError("critical current must exceed operating")


@dataclasses.dataclass(frozen=True)
class QuenchScenario:
    initial_normal_zone_m: float = 0.5
    normal_zone_velocity_m_s: float = 20.0e-3   # slow NZPV is the HTS hazard
    detection_delay_s: float = 0.1
    protection_switch_delay_s: float = 0.05
    simulation_duration_s: float = 2.0
    n_steps: int = 2000
    assumed_coolant_temperature_k: float = 20.0

    def __post_init__(self):
        _pos("initial_normal_zone_m", self.initial_normal_zone_m)
        _nonneg("normal_zone_velocity_m_s", self.normal_zone_velocity_m_s)
        _nonneg("detection_delay_s", self.detection_delay_s)
        _pos("simulation_duration_s", self.simulation_duration_s)


class QuenchTransient(NamedTuple):
    t: torch.Tensor                # (n,)
    current_a: torch.Tensor        # (n,)
    hotspot_k: torch.Tensor        # (n,)
    normal_zone_m: torch.Tensor    # (n,)
    terminal_voltage_v: torch.Tensor


class QuenchReport(NamedTuple):
    passed: bool
    failures: tuple
    current_sharing_temperature_k: float
    detection_voltage_v: float
    detection_time_s: float
    dump_time_constant_s: float
    peak_terminal_voltage_v: float
    peak_hotspot_k: float
    current_margin: float
    current_after_1s_a: float

    def to_dict(self) -> dict:
        d = self._asdict()
        d["failures"] = list(self.failures)
        return d


def current_sharing_temperature_k(c: REBCOConductor) -> float:
    """T_cs from a linear Ic(T) screen (reference ``hts_quench.py:99``)."""
    frac = 1.0 - c.operating_current_a / c.critical_current_a
    return float(c.operating_temperature_k
                 + (c.critical_temperature_k - c.operating_temperature_k)
                 * frac)


def quench_values(c: REBCOConductor, s: QuenchScenario) -> dict:
    """The transient's numbers as Python doubles, folded as JAX folds them
    (``hts_quench.py:131-134``): the step constants of :func:`quench_step`
    and of row H, and the initial (current, temperature)."""
    area = c.stabilizer_area_m2
    return {
        "dt": s.simulation_duration_s / s.n_steps,
        "t_detect": s.detection_delay_s + s.protection_switch_delay_s,
        "z0": s.initial_normal_zone_m,
        "v_nz": s.normal_zone_velocity_m_s,
        "rho": c.stabilizer_resistivity_ohm_m,
        "slope": c.resistivity_slope_ohm_m_k,
        "t_op": c.operating_temperature_k,
        "area": area,
        "r_dump": c.dump_resistance_ohm,
        "inductance": c.inductance_h,
        "h_pw": c.coolant_heat_transfer_w_m2_k * c.wetted_perimeter_m,
        "t_cool": s.assumed_coolant_temperature_k,
        "cap": c.conductor_density_kg_m3 * area * c.conductor_heat_capacity_j_kg_k,
        "cap_floor": 1e-12,
        "t_max": 3000.0,
        "i0": c.operating_current_a,
        "temp0": c.operating_temperature_k,
    }


def step_constants(values: dict, dtype: torch.dtype, device) -> dict:
    """:func:`quench_values` as 0-d tensors of ``dtype`` on ``device``, each
    rounded once from its double."""
    return {k: torch.tensor(v, dtype=dtype, device=device) for k, v in values.items()}


def quench_step(c: dict, carry, t):
    """One step of ``simulate_quench_transient``'s scan (``:138-159``):
    ``carry`` = (current, temperature), ``t`` the step's time (0-d); returns
    (carry', (t, current, temperature, zone, terminal voltage))."""
    i, temp = carry
    zone = c["z0"] + c["v_nz"] * t
    rho_t = c["rho"] + c["slope"] * torch.clamp(temp - c["t_op"], min=0.0)
    r_nz = rho_t * zone / c["area"]
    dumping = t >= c["t_detect"]
    di = torch.where(dumping, -(c["r_dump"] + r_nz) / c["inductance"] * i, 0.0)
    q_joule = i * i * r_nz                                   # W
    q_cool = c["h_pw"] * zone * torch.clamp(temp - c["t_cool"], min=0.0)
    dtemp = (q_joule - q_cool) / torch.clamp(c["cap"] * zone, min=1e-12)
    i1 = torch.clamp(i + c["dt"] * di, min=0.0)
    # Clamp to a melt-scale ceiling: past ~3000 K the screen verdict is
    # already "failed"; letting explicit Euler run away adds nothing.
    # jnp.clip is minimum(maximum(.)).
    temp1 = torch.minimum(torch.maximum(temp + c["dt"] * dtemp, c["t_cool"]), c["t_max"])
    v_term = torch.where(dumping, i1 * c["r_dump"], i1 * r_nz)
    return (i1, temp1), (t, i1, temp1, zone, v_term)


def step_times(c: dict, n_steps: int) -> torch.Tensor:
    """``k * dt`` of every step, formed in the constants' dtype."""
    return torch.arange(n_steps, dtype=c["dt"].dtype, device=c["dt"].device) * c["dt"]


def simulate_quench_transient(c: REBCOConductor, s: QuenchScenario, *,
                              dtype: torch.dtype = torch.float32,
                              device: torch.device | str = "cuda") -> QuenchTransient:
    """Explicit lumped transient (JAX's ``lax.scan``).

    Phases: (1) undetected -- full current through the growing normal zone;
    (2) after detection+switch -- current decays through the dump resistor
    while Joule heating continues in the (still growing) zone; cooling over
    the wetted perimeter opposes the temperature rise.  On the card one
    launch of row H; on the CPU the loop of :func:`quench_step`."""
    from scpn_fusion_tpu_torch.ops.cuda_quench import quench_run

    values = quench_values(c, s)
    return QuenchTransient(*quench_run(values, step_constants(values, dtype, device), s.n_steps))


def evaluate_rebco_quench(c: REBCOConductor | None = None, s: QuenchScenario | None = None, *,
                          dtype: torch.dtype = torch.float32,
                          device: torch.device | str = "cuda") -> QuenchReport:
    """Run the transient and apply the protection-screen criteria
    (reference ``evaluate_rebco_quench`` :112-226 verdict contract)."""
    c = c or REBCOConductor()
    s = s or QuenchScenario()
    tr = simulate_quench_transient(c, s, dtype=dtype, device=device)

    t_detect = s.detection_delay_s + s.protection_switch_delay_s
    zone_at_detect = (s.initial_normal_zone_m
                      + s.normal_zone_velocity_m_s * t_detect)
    r_detect = (c.stabilizer_resistivity_ohm_m * zone_at_detect
                / c.stabilizer_area_m2)
    detection_voltage = c.operating_current_a * r_detect
    tau = c.inductance_h / c.dump_resistance_ohm
    peak_v = float(torch.max(tr.terminal_voltage_v))
    peak_hotspot = float(torch.max(tr.hotspot_k))
    tcs = current_sharing_temperature_k(c)
    margin = (c.critical_current_a - c.operating_current_a) \
        / c.critical_current_a
    idx_1s = min(int(1.0 / (s.simulation_duration_s / s.n_steps)),
                 s.n_steps - 1)
    i_1s = float(tr.current_a[idx_1s])

    failures = []
    if detection_voltage < c.quench_detection_threshold_v:
        failures.append("detection_voltage_below_threshold")
    if peak_v > c.max_terminal_voltage_v:
        failures.append("terminal_voltage_limit")
    if peak_hotspot > c.max_hotspot_temperature_k:
        failures.append("hotspot_temperature_limit")
    if margin < 0.20:
        failures.append("critical_current_margin")

    return QuenchReport(
        passed=not failures, failures=tuple(failures),
        current_sharing_temperature_k=tcs,
        detection_voltage_v=float(detection_voltage),
        detection_time_s=t_detect, dump_time_constant_s=float(tau),
        peak_terminal_voltage_v=peak_v, peak_hotspot_k=peak_hotspot,
        current_margin=float(margin), current_after_1s_a=i_1s)
