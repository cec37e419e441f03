"""ADC/DAC sensor-actuator boundary for the HIL harness (port of
``scpn_fusion_tpu/control/hil_sensors.py``).

ADC quantisation + Gaussian measurement noise on the sensor side;
range-clamped, slew-rate-limited DAC output with a fail-safe hold on
non-finite commands on the actuator side; the magnetic-probe (±1.5 V <->
±10 T) and coil-current (±10 V <-> ±50 kA) scale adapters.  The converter is
a pure function over an explicit ``DacState``; a command sequence runs
through it as a plain loop (``converter_loop``).

The draws rule: :func:`read_adc` draws its noise from a ``torch.Generator``;
:func:`_read_adc` takes the standard normals as a tensor (the tests feed it
JAX's draws).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class AdcConfig:
    """ADC configuration (reference defaults: 12-bit, ±1.5 V, 0.5 LSB rms)."""

    resolution_bits: int = 12
    v_min: float = -1.5
    v_max: float = 1.5
    noise_rms_lsb: float = 0.5

    @property
    def n_levels(self) -> int:
        return (1 << int(self.resolution_bits)) - 1

    @property
    def lsb_voltage(self) -> float:
        return (self.v_max - self.v_min) / self.n_levels


@dataclasses.dataclass(frozen=True)
class DacConfig:
    """DAC configuration (reference defaults: 16-bit, ±10 V, 50 V/µs)."""

    resolution_bits: int = 16
    v_min: float = -10.0
    v_max: float = 10.0
    slew_rate_v_per_us: float = 50.0


class DacState(NamedTuple):
    """Actuator carry: last applied voltage(s) + fault count."""

    last_voltage: torch.Tensor   # scalar or (channels,)
    faults: torch.Tensor         # int32, same shape


def dac_init(n_channels: int | None = None, *, dtype: torch.dtype = torch.float32,
             device: torch.device | str = "cuda") -> DacState:
    shape = () if n_channels is None else (n_channels,)
    return DacState(last_voltage=torch.zeros(shape, dtype=dtype, device=device),
                    faults=torch.zeros(shape, dtype=torch.int32, device=device))


def _read_adc(true_voltage: torch.Tensor, normals: torch.Tensor,
              cfg: AdcConfig = AdcConfig()) -> torch.Tensor:
    """Clip, add ``noise_rms_lsb`` LSB times the standard ``normals``, and
    quantise to the (2^bits - 1)-level code."""
    v = torch.clamp(true_voltage, cfg.v_min, cfg.v_max)
    v = v + cfg.noise_rms_lsb * cfg.lsb_voltage * normals
    span = torch.tensor(cfg.v_max - cfg.v_min, dtype=v.dtype, device=v.device)
    code = torch.round((v - cfg.v_min) / span * cfg.n_levels)
    code = torch.clamp(code, 0, cfg.n_levels)
    return cfg.v_min + code * cfg.lsb_voltage


def read_adc(true_voltage: torch.Tensor, generator: torch.Generator,
             cfg: AdcConfig = AdcConfig()) -> torch.Tensor:
    """Clip, add converter noise drawn from ``generator`` (on its device),
    and quantise (reference ``read_adc``)."""
    normals = torch.randn(true_voltage.shape, generator=generator, dtype=true_voltage.dtype,
                          device=generator.device).to(true_voltage.device)
    return _read_adc(true_voltage, normals, cfg)


def write_dac(state: DacState, target_voltage: torch.Tensor, *, dt_us: float = 1.0,
              cfg: DacConfig = DacConfig()) -> tuple[DacState, torch.Tensor]:
    """Slew-limited, range-clamped output with fail-safe hold; returns the
    voltage PHYSICALLY applied (drive the plant with it, never the raw
    command)."""
    target_voltage = torch.as_tensor(target_voltage, dtype=state.last_voltage.dtype,
                                     device=state.last_voltage.device)
    finite = torch.isfinite(target_voltage)
    target = torch.clamp(torch.where(finite, target_voltage, torch.zeros_like(target_voltage)),
                         cfg.v_min, cfg.v_max)
    max_change = cfg.slew_rate_v_per_us * dt_us
    delta = torch.clamp(target - state.last_voltage, -max_change, max_change)
    proposed = state.last_voltage + delta
    output = torch.where(finite, proposed, state.last_voltage)
    return (DacState(last_voltage=output, faults=state.faults + (~finite).to(torch.int32)),
            output)


# Scale adapters -- the reference's physical channel mappings.
B_FULL_SCALE_T = 10.0       # ±1.5 V ADC <-> ±10 T probe
I_FULL_SCALE_KA = 50.0      # ±10 V DAC <-> ±50 kA coil


def _read_magnetic_probe(b_true_t: torch.Tensor, normals: torch.Tensor,
                         adc: AdcConfig = AdcConfig()) -> torch.Tensor:
    v = b_true_t * (adc.v_max / B_FULL_SCALE_T)
    return _read_adc(v, normals, adc) * (B_FULL_SCALE_T / adc.v_max)


def read_magnetic_probe(b_true_t: torch.Tensor, generator: torch.Generator,
                        adc: AdcConfig = AdcConfig()) -> torch.Tensor:
    normals = torch.randn(b_true_t.shape, generator=generator, dtype=b_true_t.dtype,
                          device=generator.device).to(b_true_t.device)
    return _read_magnetic_probe(b_true_t, normals, adc)


def write_coil_current(state: DacState, target_ka: torch.Tensor, *, dt_us: float = 1.0,
                       dac: DacConfig = DacConfig()) -> tuple[DacState, torch.Tensor]:
    v = target_ka * (dac.v_max / I_FULL_SCALE_KA)
    state, out_v = write_dac(state, v, dt_us=dt_us, cfg=dac)
    return state, out_v * (I_FULL_SCALE_KA / dac.v_max)


def converter_loop(commands_v: torch.Tensor, *, dt_us: float = 1.0,
                   dac: DacConfig = DacConfig()) -> tuple[DacState, torch.Tensor]:
    """Run a command sequence (ticks, [channels]) through the DAC, a tick at
    a time; returns (final state, applied outputs)."""
    n_ch = commands_v.shape[1] if commands_v.dim() > 1 else None
    state = dac_init(n_ch, dtype=commands_v.dtype, device=commands_v.device)
    outs = []
    for cmd in commands_v:
        state, out = write_dac(state, cmd, dt_us=dt_us, cfg=dac)
        outs.append(out)
    return state, torch.stack(outs)
