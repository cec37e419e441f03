"""Direct energy conversion (DEC) channel: performance + fault boundary.

Role-parity with the reference's reduced DEC fault screen
(``core/direct_energy_conversion.py:39-160``
``evaluate_direct_energy_conversion_fault``): a charged-particle DEC
channel with nominal/degraded electric output, fail-closed isolation timing,
unisolated-energy and bus-overvoltage bounds, and crowbar dump-power limits.
Verdict is a fail-closed failure list.  Reduced-order screen only — not a
power-electronics design tool.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple


def _pos(name: str, v: float) -> float:
    if not math.isfinite(v) or v <= 0.0:
        raise ValueError(f"{name} must be positive and finite, got {v}")
    return float(v)


def _frac(name: str, v: float) -> float:
    if not math.isfinite(v) or not 0.0 <= v <= 1.0:
        raise ValueError(f"{name} must be in [0, 1], got {v}")
    return float(v)


@dataclasses.dataclass(frozen=True)
class DECChannel:
    thermal_power_mw: float = 500.0
    charged_particle_fraction: float = 0.2
    nominal_efficiency: float = 0.6
    bus_voltage_kv: float = 120.0
    bus_capacitance_f: float = 2.0e-3
    dump_resistance_ohm: float = 50.0
    isolation_time_ms: float = 5.0
    crowbar_time_ms: float = 2.0
    max_bus_overvoltage_fraction: float = 0.2
    max_unisolated_energy_mj: float = 5.0
    max_dump_power_mw: float = 400.0

    def __post_init__(self):
        _pos("thermal_power_mw", self.thermal_power_mw)
        _frac("charged_particle_fraction", self.charged_particle_fraction)
        _frac("nominal_efficiency", self.nominal_efficiency)
        _pos("bus_voltage_kv", self.bus_voltage_kv)
        _pos("dump_resistance_ohm", self.dump_resistance_ohm)


@dataclasses.dataclass(frozen=True)
class DECFault:
    efficiency_drop_fraction: float = 0.5
    load_rejection_fraction: float = 0.8
    sensor_detection_latency_ms: float = 1.0
    control_latency_ms: float = 1.0
    degraded_efficiency_floor: float = 0.05

    def __post_init__(self):
        _frac("efficiency_drop_fraction", self.efficiency_drop_fraction)
        _frac("load_rejection_fraction", self.load_rejection_fraction)


class DECReport(NamedTuple):
    passed: bool
    failures: tuple
    nominal_electric_power_mw: float
    degraded_electric_power_mw: float
    isolated_energy_mj: float
    bus_overvoltage_fraction: float
    peak_dump_power_mw: float
    fail_closed_time_ms: float

    def to_dict(self) -> dict:
        d = self._asdict()
        d["failures"] = list(self.failures)
        return d


def evaluate_direct_energy_conversion(
        channel: DECChannel | None = None,
        fault: DECFault | None = None) -> DECReport:
    c = channel or DECChannel()
    f = fault or DECFault()

    nominal = (c.thermal_power_mw * c.charged_particle_fraction
               * c.nominal_efficiency)
    degraded_eff = max(c.nominal_efficiency
                       * (1.0 - f.efficiency_drop_fraction),
                       f.degraded_efficiency_floor)
    degraded = c.thermal_power_mw * c.charged_particle_fraction \
        * degraded_eff

    fail_closed_ms = (f.sensor_detection_latency_ms + f.control_latency_ms
                      + c.isolation_time_ms + c.crowbar_time_ms)
    unisolated_mw = nominal * f.load_rejection_fraction
    isolated_energy_mj = unisolated_mw * fail_closed_ms * 1e-3

    stored_j = 0.5 * c.bus_capacitance_f * (c.bus_voltage_kv * 1e3) ** 2
    injected_j = isolated_energy_mj * 1e6
    overvoltage = math.sqrt(
        (stored_j + injected_j) / max(stored_j, 1e-12)) - 1.0
    peak_dump_mw = (c.bus_voltage_kv * 1e3) ** 2 \
        / c.dump_resistance_ohm / 1e6

    failures = []
    if isolated_energy_mj > c.max_unisolated_energy_mj:
        failures.append("unisolated_energy")
    if overvoltage > c.max_bus_overvoltage_fraction:
        failures.append("bus_overvoltage")
    if peak_dump_mw > c.max_dump_power_mw:
        failures.append("dump_power")
    if degraded <= 0.0:
        failures.append("degraded_power_floor")

    return DECReport(
        passed=not failures, failures=tuple(failures),
        nominal_electric_power_mw=nominal,
        degraded_electric_power_mw=degraded,
        isolated_energy_mj=isolated_energy_mj,
        bus_overvoltage_fraction=overvoltage,
        peak_dump_power_mw=peak_dump_mw,
        fail_closed_time_ms=fail_closed_ms)
