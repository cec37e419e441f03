"""Disruption sequence: thermal quench -> current quench -> runaways, halo
currents, SPI mitigation, structural response (port of
``scpn_fusion_tpu/models/physics/disruption_sequence.py``).

The JAX package integrates the staged disruption (Te collapse on tau_TQ,
L/R current decay with cold-plasma Spitzer resistivity, Rosenbluth-Putvinski
avalanche growth of the RE current against the critical field) as one
``lax.scan`` and ``vmap``s it over SPI inventories.  The port runs every
tick of every sequence of a call in ONE launch of a hand-written CUDA
kernel, one thread a sequence (``ops/cuda_disruption.disruption_sequence``,
``csrc/disruption.cu``; row Q); on a CPU tensor the same call is its plain
version, the loop of :func:`disruption_step` over the ticks with the
sequences as one batch.  The summary (80-20 quench time, halo peak, force)
is plain ops on the traces.

:func:`disruption_step` divides by tensors (:func:`step_constants`): on a
CUDA tensor PyTorch multiplies by the reciprocal of a Python divisor, and
the kernel divides.  The tick time ``k * dt_ms`` is formed in the working
dtype.  The entry points take ``dtype`` (float32 by default; JAX takes its
float from the x64 flag) and ``device`` (``"cuda"`` by default).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.models.physics.edge import as_tensors

MU0 = 4.0e-7 * math.pi
E_CHARGE = 1.602176634e-19
M_E = 9.109e-31
C_LIGHT = 2.998e8
LN_LAMBDA = 15.0
TE_HOT_EV = 100.0           # the seed current flows once Te is below this
Z_EFF = 1.5                 # spitzer_resistivity's default


@dataclasses.dataclass(frozen=True)
class DisruptionParams:
    ip0_ma: float = 15.0
    te0_kev: float = 10.0
    te_post_tq_ev: float = 10.0       # post-thermal-quench temperature
    ne20: float = 1.0                 # pre-disruption density
    r0_m: float = 6.2
    a_m: float = 2.0
    kappa: float = 1.8
    l_plasma_uh: float = 7.0
    tau_tq_ms: float = 1.0
    re_seed_fraction: float = 1e-9    # seed RE current fraction of Ip
    halo_fraction_max: float = 0.35
    tpf: float = 2.0                  # toroidal peaking factor
    dt_ms: float = 0.05
    n_steps: int = 4000


def spitzer_resistivity(te_ev, z_eff=Z_EFF, *, dtype=None, device="cuda"):
    """Spitzer eta [ohm m] for the cold post-TQ plasma (the quotient rounded
    once, as JAX divides: a Python numerator would make PyTorch multiply by
    the reciprocal)."""
    (te_ev,) = as_tensors(te_ev, dtype=dtype, device=device)
    num = torch.as_tensor(5.2e-5 * z_eff * LN_LAMBDA, dtype=te_ev.dtype, device=te_ev.device)
    return torch.div(num, torch.clamp(te_ev, min=1.0) ** 1.5)


# E_c / (ne20 lnLambda) precomputed in f64:
#   e^3 / (4 pi eps0^2 m_e c^2) * 1e20  [V/m per 1e20 m^-3 per lnLambda]
# (evaluating the raw e^3 product underflows f32).
_EC_PER_NE20_LNL = 5.0990991e-3


def critical_field_connor_hastie(ne20, *, dtype=None, device="cuda"):
    """Connor-Hastie critical field E_c [V/m] for RE sustainment
    (f32-safe constant-folded form)."""
    (ne20,) = as_tensors(ne20, dtype=dtype, device=device)
    return torch.clamp(ne20, min=1e-6) * LN_LAMBDA * _EC_PER_NE20_LNL


def _avalanche(e_par, ne20, c: dict) -> torch.Tensor:
    """The Rosenbluth-Putvinski rate with the divisors of ``c``."""
    e_c = torch.clamp(torch.clamp(ne20, min=1e-6) * LN_LAMBDA * _EC_PER_NE20_LNL, min=1e-12)
    tau_av = torch.div(c["mec_lnl"], e_c) / c["e_charge"] / c["two"]
    return torch.clamp(e_par / e_c - 1.0, min=0.0) / tau_av


def avalanche_growth_rate(e_par, ne20, *, dtype=None, device="cuda"):
    """Rosenbluth-Putvinski avalanche rate ~ (E/E_c - 1)/tau_av [1/s]."""
    e_par, ne20 = as_tensors(e_par, ne20, dtype=dtype, device=device)
    return _avalanche(e_par, ne20, _constant_tensors(
        {"mec_lnl": M_E * C_LIGHT * LN_LAMBDA, "e_charge": E_CHARGE, "two": 2.0},
        e_par.dtype, e_par.device))


class DisruptionTrace(NamedTuple):
    t_ms: torch.Tensor
    te_ev: torch.Tensor
    ip_ma: torch.Tensor          # ohmic (thermal-channel) current
    i_re_ma: torch.Tensor        # runaway current
    e_par_v_m: torch.Tensor
    halo_ma: torch.Tensor


class DisruptionSummary(NamedTuple):
    tau_cq_ms: torch.Tensor      # 80-20 current-quench time
    i_re_final_ma: torch.Tensor
    halo_peak_ma: torch.Tensor
    halo_force_mn: torch.Tensor  # vertical force proxy (with TPF)
    mitigated: torch.Tensor      # RE current below 1% of Ip0


def _constant_tensors(values: dict, dtype, device) -> dict:
    return {k: torch.tensor(v, dtype=dtype, device=device) for k, v in values.items()}


def step_constants(p: DisruptionParams, dtype, device) -> dict:
    """The divisors and selected values of :func:`disruption_step` as 0-d
    tensors (Python-double folds of the JAX expression, rounded once to
    ``dtype``); ``csrc/disruption.cu`` takes the same doubles."""
    dt = p.dt_ms * 1e-3
    return _constant_tensors({
        "tau_tq": p.tau_tq_ms,
        "c_eta": 5.2e-5 * Z_EFF * LN_LAMBDA,
        "area": math.pi * p.a_m ** 2 * p.kappa,
        "two_pi_r0": 2.0 * math.pi * p.r0_m,
        "l_p": p.l_plasma_uh * 1e-6,
        "mec_lnl": M_E * C_LIGHT * LN_LAMBDA,
        "e_charge": E_CHARGE,
        "two": 2.0,
        "seed": p.re_seed_fraction * p.ip0_ma * 1e6 / (p.n_steps * dt),
        "zero": 0.0,
        "ip0_a": p.ip0_ma * 1e6,
        "mega": 1e6,
    }, dtype, device)


def disruption_step(p: DisruptionParams, c: dict, carry, t_ms, spi_ne20, spi_time_ms: float):
    """One tick of ``run_disruption_sequence``'s scan (``:112-133``) for a
    batch of sequences: ``carry`` = (te, ip [A], i_re [A]), ``t_ms`` the
    tick's time (0-d), ``spi_ne20`` each sequence's injected density; returns
    (carry', (t, te, ip [MA], i_re [MA], E_par, halo [MA]))."""
    _, ip_a, i_re_a = carry
    dt = p.dt_ms * 1e-3
    # Thermal quench: exponential Te collapse to the post-TQ floor.
    te1 = p.te_post_tq_ev + (p.te0_kev * 1e3 - p.te_post_tq_ev) * torch.exp(-t_ms / c["tau_tq"])
    # Density: SPI delivery is a step at spi_time_ms.
    ne20 = p.ne20 + torch.where(t_ms >= spi_time_ms, spi_ne20, c["zero"])
    # Current quench: L dI/dt = -R I, R from cold Spitzer resistivity.
    eta = torch.div(c["c_eta"], torch.clamp(te1, min=1.0) ** 1.5)
    r_plasma = eta * 2.0 * math.pi * p.r0_m / c["area"]
    e_par = r_plasma * (ip_a - i_re_a) / c["two_pi_r0"]
    dip = -r_plasma * (ip_a - i_re_a) / c["l_p"]
    # RE avalanche on the same loop field.
    gamma = _avalanche(e_par, ne20, c)
    di_re = gamma * i_re_a + torch.where(te1 < TE_HOT_EV, c["seed"], c["zero"])
    ip1 = torch.clamp(ip_a + dt * dip, min=0.0)
    i_re1 = torch.minimum(i_re_a + dt * di_re, ip1)
    # Halo current: grows as the thermal current decays.
    lost = 1.0 - ip1 / c["ip0_a"]
    halo = p.halo_fraction_max * lost * ip1
    return ((te1, ip1, i_re1),
            (t_ms, te1, ip1 / c["mega"], i_re1 / c["mega"], e_par, halo / c["mega"]))


def initial_carry(p: DisruptionParams, n_seq: int, dtype, device):
    """(Te, Ip, I_RE) at t = 0 of ``n_seq`` sequences."""
    return tuple(torch.full((n_seq,), v, dtype=dtype, device=device)
                 for v in (p.te0_kev * 1e3, p.ip0_ma * 1e6, 0.0))


def tick_times(p: DisruptionParams, dtype, device) -> torch.Tensor:
    """``k * dt_ms`` of every tick, formed in ``dtype``."""
    return torch.arange(p.n_steps, dtype=dtype, device=device) * p.dt_ms


def summarize(p: DisruptionParams, trace: DisruptionTrace) -> DisruptionSummary:
    """80-20 quench time, final RE current, halo peak and force of traces
    of shape (..., n_steps) (``:137-156``).  The first crossings are
    ``jnp.argmax`` of bool masks: ``torch.argmax`` refuses bool, so the
    masks go as uint8."""
    t_ms, ip_ma, i_re_ma = trace.t_ms, trace.ip_ma, trace.i_re_ma
    ip0 = p.ip0_ma
    below80, below20 = ip_ma < 0.8 * ip0, ip_ma < 0.2 * ip0
    t80, t20 = (torch.gather(t_ms, -1, torch.argmax(m.to(torch.uint8), dim=-1)[..., None])[..., 0]
                for m in (below80, below20))
    t20 = torch.where(torch.any(below20, dim=-1), t20, t_ms[..., -1])
    tau_cq = (t20 - t80) / 0.6
    halo_peak = torch.amax(trace.halo_ma, dim=-1)
    # Vertical force proxy: F ~ TPF * I_halo * B_pol * 2 pi R
    b_pol = MU0 * p.ip0_ma * 1e6 / (2.0 * math.pi * p.a_m)
    force_mn = p.tpf * halo_peak * 1e6 * b_pol * 2.0 * math.pi * p.r0_m / 1e6
    i_re_final = i_re_ma[..., -1]
    return DisruptionSummary(tau_cq_ms=tau_cq, i_re_final_ma=i_re_final,
                             halo_peak_ma=halo_peak, halo_force_mn=force_mn,
                             mitigated=i_re_final < 0.01 * p.ip0_ma)


def _sequences(p: DisruptionParams, spi_ne20: torch.Tensor, spi_time_ms: float) -> DisruptionTrace:
    from scpn_fusion_tpu_torch.ops.cuda_disruption import disruption_sequence
    return DisruptionTrace(*disruption_sequence(p, spi_ne20, spi_time_ms))


def run_disruption_sequence(p: DisruptionParams, *, spi_ne20_injected=0.0,
                            spi_time_ms: float = 0.0, dtype: torch.dtype | None = None,
                            device: torch.device | str = "cuda"
                            ) -> tuple[DisruptionTrace, DisruptionSummary]:
    """Integrate the staged disruption (one launch of row Q on the card).

    SPI raises the density (and hence E_c) at ``spi_time_ms``; a large
    enough injected inventory suppresses the avalanche (the reference's
    mitigation criterion).
    """
    (q,) = as_tensors(spi_ne20_injected, dtype=dtype, device=device)
    trace = _sequences(p, q.reshape(1), float(spi_time_ms))
    trace = DisruptionTrace(*(x[0] for x in trace))
    return trace, summarize(p, trace)


def spi_mitigation_scan(p: DisruptionParams, quantities_ne20, *, spi_time_ms: float = 0.5,
                        dtype: torch.dtype | None = None,
                        device: torch.device | str = "cuda") -> DisruptionSummary:
    """The sequence over SPI inventories, every inventory in one launch of
    row Q; returns summaries (reference ``spi_mitigation.py`` planning
    scan)."""
    (q,) = as_tensors(quantities_ne20, dtype=dtype, device=device)
    return summarize(p, _sequences(p, q.reshape(-1), float(spi_time_ms)))


def structural_response_screen(summary: DisruptionSummary, *,
                               force_limit_mn: float = 80.0,
                               tau_cq_min_ms: float = 1.5):
    """Fail-closed vessel screen (reference
    ``disruption_structural_response.py`` contract): halo force within the
    design limit and the current quench not faster than the eddy-load
    design basis."""
    failures = []
    if float(summary.halo_force_mn) > force_limit_mn:
        failures.append("halo_force_limit")
    if float(summary.tau_cq_ms) < tau_cq_min_ms:
        failures.append("current_quench_too_fast")
    return {"passed": not failures, "failures": failures,
            "halo_force_mn": float(summary.halo_force_mn),
            "tau_cq_ms": float(summary.tau_cq_ms)}
