"""FPGA register-level export of the compiled SCPN controller (port of
``scpn_fusion_tpu/control/fpga_export.py``).

Counterpart of the reference's
``control/hil_fpga_export.py:27-180`` (register map + Verilog module
header for HIL deployment).  Two upgrades over the reference's generic
LIF slot map:

* the export carries the ACTUAL compiled controller — W_in / W_out /
  thresholds / gains quantised to Q2.14 fixed point as ROM images
  (``$readmemh`` hex) — not just per-neuron parameter slots;
* :func:`quantization_report` round-trips the quantised weights through
  the real ``controller_step`` and reports the action deviation against
  the float controller on a test trace, so the export ships with
  measured fixed-point error, not hope.

Like the reference, the Verilog is a register-level description for HLS
integration, not a full synthesisable design.

The quantisation is numpy, as in JAX: it reads the controller's tensors
with ``.cpu().numpy()``.  The report's two controller runs tick the port's
plain ``controller_step`` on the controller's device (there is no plant, so
no closed-loop kernel applies).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from scpn_fusion_tpu_torch.scpn.controller import (
    CompiledController,
    ControllerConfig,
    controller_step,
    initial_controller_state,
)


@dataclasses.dataclass(frozen=True)
class FixedPointFormat:
    """Signed fixed point (default Q2.14 in 16 bits, reference parity)."""

    total_bits: int = 16
    frac_bits: int = 14

    def __post_init__(self) -> None:
        if not 2 <= self.total_bits <= 32:
            raise ValueError("total_bits must be in [2, 32]")
        if not 0 <= self.frac_bits < self.total_bits:
            raise ValueError("frac_bits must be in [0, total_bits)")

    @property
    def scale(self) -> int:
        return 1 << self.frac_bits

    @property
    def min_int(self) -> int:
        return -(1 << (self.total_bits - 1))

    @property
    def max_int(self) -> int:
        return (1 << (self.total_bits - 1)) - 1

    def quantize(self, x) -> np.ndarray:
        q = np.round(np.asarray(x, np.float64) * self.scale)
        return np.clip(q, self.min_int, self.max_int).astype(np.int64)

    def dequantize(self, q) -> np.ndarray:
        return np.asarray(q, np.float64) / self.scale

    def to_hex(self, q: np.ndarray) -> list[str]:
        mask = (1 << self.total_bits) - 1
        width = (self.total_bits + 3) // 4
        return [format(int(v) & mask, f"0{width}x") for v in q.ravel()]


class RegisterMap(NamedTuple):
    """Full register-level description of one compiled controller."""

    clock_hz: int
    dt_ticks: int
    n_places: int
    n_transitions: int
    fmt: FixedPointFormat
    w_in_q: np.ndarray        # (nT, nP) int
    w_out_q: np.ndarray       # (nP, nT) int
    thresholds_q: np.ndarray  # (nT,)
    gains_q: np.ndarray       # (nAct,)
    input_ports: tuple[str, ...]
    output_ports: tuple[str, ...]
    reset_active_low: bool = True


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def generate_register_map(
    ctrl: CompiledController,
    *,
    clock_mhz: float = 100.0,
    dt_us: float = 100.0,
    fmt: FixedPointFormat = FixedPointFormat(),
) -> RegisterMap:
    """Quantise the compiled controller into the register map."""
    clock_hz = int(clock_mhz * 1e6)
    n_t, n_p = ctrl.w_in.shape
    n_inj = int(ctrl.inj_place_ids.shape[0])
    n_act = int(ctrl.act_gain.shape[0])
    return RegisterMap(
        clock_hz=clock_hz,
        dt_ticks=int(dt_us * clock_hz / 1e6),
        n_places=n_p,
        n_transitions=n_t,
        fmt=fmt,
        w_in_q=fmt.quantize(_np(ctrl.w_in)),
        w_out_q=fmt.quantize(_np(ctrl.w_out)),
        thresholds_q=fmt.quantize(_np(ctrl.thresholds)),
        gains_q=fmt.quantize(_np(ctrl.act_gain)),
        input_ports=tuple(f"inject_{i}" for i in range(n_inj)),
        output_ports=tuple(f"action_{i}" for i in range(n_act)),
    )


def export_weight_hex(reg: RegisterMap) -> dict[str, str]:
    """ROM images as ``$readmemh`` payloads (one hex word per line)."""
    fmt = reg.fmt
    return {
        "w_in.hex": "\n".join(fmt.to_hex(reg.w_in_q)) + "\n",
        "w_out.hex": "\n".join(fmt.to_hex(reg.w_out_q)) + "\n",
        "thresholds.hex": "\n".join(fmt.to_hex(reg.thresholds_q)) + "\n",
        "gains.hex": "\n".join(fmt.to_hex(reg.gains_q)) + "\n",
    }


def export_verilog_header(reg: RegisterMap) -> str:
    """Verilog module header (register-level, HLS-integration contract)."""
    fmt = reg.fmt
    rst = "rst_n" if reg.reset_active_low else "rst"
    lines = [
        "// Auto-generated by scpn_fusion_tpu — SCPN controller export",
        f"// {reg.n_places} places, {reg.n_transitions} transitions; "
        f"Q{fmt.total_bits - fmt.frac_bits - 1}.{fmt.frac_bits} fixed point",
        f"// Clock: {reg.clock_hz / 1e6:.0f} MHz, control period "
        f"{reg.dt_ticks} ticks",
        "",
        "module scpn_controller #(",
        f"    parameter N_PLACES      = {reg.n_places},",
        f"    parameter N_TRANSITIONS = {reg.n_transitions},",
        f"    parameter CLK_HZ        = {reg.clock_hz},",
        f"    parameter DT_TICKS      = {reg.dt_ticks}",
        ") (",
        "    input  wire clk,",
        f"    input  wire {rst},",
    ]
    for port in reg.input_ports:
        lines.append(f"    input  wire signed [{fmt.total_bits - 1}:0] "
                     f"{port},")
    for i, port in enumerate(reg.output_ports):
        comma = "," if i < len(reg.output_ports) - 1 else ""
        lines.append(f"    output reg  signed [{fmt.total_bits - 1}:0] "
                     f"{port}{comma}")
    lines += [
        ");",
        "",
        "    // Compiled-net ROMs (load with the sidecar hex images).",
        f"    reg signed [{fmt.total_bits - 1}:0] "
        "w_in  [0:N_TRANSITIONS*N_PLACES-1];",
        f"    reg signed [{fmt.total_bits - 1}:0] "
        "w_out [0:N_PLACES*N_TRANSITIONS-1];",
        f"    reg signed [{fmt.total_bits - 1}:0] "
        "thresholds [0:N_TRANSITIONS-1];",
        f"    reg signed [{fmt.total_bits - 1}:0] marking [0:N_PLACES-1];",
        "    initial begin",
        '        $readmemh("w_in.hex", w_in);',
        '        $readmemh("w_out.hex", w_out);',
        '        $readmemh("thresholds.hex", thresholds);',
        "    end",
        "",
        "    // Tick sequencing: activation matvec -> threshold firing ->",
        "    // marking update -> action decode, one control period per",
        "    // DT_TICKS (pipeline stages left to HLS).",
        "endmodule",
    ]
    return "\n".join(lines)


class QuantizationReport(NamedTuple):
    max_action_dev: float
    rms_action_dev: float
    action_scale: float
    acceptable: bool


def quantization_report(
    ctrl: CompiledController,
    cfg: ControllerConfig,
    *,
    fmt: FixedPointFormat = FixedPointFormat(),
    obs_trace: np.ndarray | None = None,
    tolerance_rel: float = 0.02,
) -> QuantizationReport:
    """Round-trip the quantised weights through the REAL controller and
    measure the action deviation vs the float controller."""
    if obs_trace is None:
        rng = np.random.default_rng(0)
        n_axes = int(ctrl.axis_targets.shape[0])
        obs_trace = (_np(ctrl.axis_targets)[None, :]
                     + 0.3 * rng.standard_normal((200, n_axes)))
    dtype, device = ctrl.w_in.dtype, ctrl.w_in.device

    def requantized(t):
        return torch.as_tensor(fmt.dequantize(fmt.quantize(_np(t))), dtype=dtype, device=device)

    ctrl_q = ctrl._replace(
        w_in=requantized(ctrl.w_in),
        w_out=requantized(ctrl.w_out),
        thresholds=requantized(ctrl.thresholds),
        act_gain=requantized(ctrl.act_gain),
    )
    obs = torch.as_tensor(np.asarray(obs_trace), dtype=dtype, device=device)

    def run(c):
        state = initial_controller_state(c, cfg)
        outs = []
        for k in range(obs.shape[0]):
            state, actions, _ = controller_step(c, cfg, state, obs[k], k)
            outs.append(actions)
        return torch.stack(outs).cpu().numpy()

    a_float = run(ctrl)
    a_quant = run(ctrl_q)
    dev = np.abs(a_float - a_quant)
    scale = float(np.max(np.abs(a_float)) + 1e-30)
    max_dev = float(dev.max())
    return QuantizationReport(
        max_action_dev=max_dev,
        rms_action_dev=float(np.sqrt(np.mean(dev**2))),
        action_scale=scale,
        acceptable=max_dev <= tolerance_rel * scale,
    )
