"""Shot scenario machinery: startup, waveform scheduling, volt-second budget
(port of ``scpn_fusion_tpu/control/scenario.py``).

* Paschen breakdown, the Townsend avalanche and radiative burn-through (the
  JAX ``lax.scan`` loops are Python loops of tensor ops);
* waveforms are breakpoint tensors evaluated with :func:`interp`, JAX's
  ``jnp.interp`` step for step, so a whole schedule evaluates at a tensor of
  times in one call and stays differentiable in its values (the knobs of
  ``control/optimal_scenario.py``);
* the volt-second budget uses the Ejima resistive-consumption form.

The JAX module takes its float type from the x64 flag (``core/dtypes``);
the port has none: a function that makes tensors from Python numbers takes
``dtype`` (float64, JAX's type with x64 on) and ``device`` (the card by
default).  :class:`FluxBudget` takes Python numbers or tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

MU0 = 4.0e-7 * math.pi
E_CHARGE = 1.602176634e-19

# Townsend coefficients for D2 (Lieberman & Lichtenberg 2005 Ch.14 values,
# as used by the reference PaschenBreakdown model).
TOWNSEND_A = 44.7      # 1/(Pa m)
TOWNSEND_C2 = 2.64
TOWNSEND_B = 155.0     # V/(Pa m)


def _tensor(x, dtype: torch.dtype, device) -> torch.Tensor:
    """``x`` itself if it is a tensor, else a tensor of ``dtype`` on ``device``."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x, dtype=dtype, device=device)


def _floor(x, lo):
    return torch.clamp(x, min=lo) if isinstance(x, torch.Tensor) else max(x, lo)


# ---------------------------------------------------------------------------
# Breakdown + avalanche + burn-through
# ---------------------------------------------------------------------------

def paschen_breakdown_voltage(p_pa, connection_length_m=100.0, *,
                              dtype: torch.dtype = torch.float64,
                              device: torch.device | str = "cuda"):
    """Paschen V_bd(p L); +inf outside the valid branch."""
    pd = _tensor(p_pa, dtype, device) * connection_length_m
    denom = TOWNSEND_A * torch.log(torch.clamp(pd, min=1e-6)) - TOWNSEND_C2
    v = TOWNSEND_B * pd / torch.clamp(denom, min=1e-12)
    return torch.where((pd > 0) & (denom > 0), v, torch.full_like(v, math.inf))


def optimal_prefill_pressure(connection_length_m=100.0):
    """Paschen-minimum prefill: pd_opt = exp(1 + C2/A)."""
    return math.exp(1.0 + TOWNSEND_C2 / TOWNSEND_A) / connection_length_m


def is_breakdown(v_loop, p_pa, connection_length_m=100.0, *,
                 dtype: torch.dtype = torch.float64, device: torch.device | str = "cuda"):
    v_bd = paschen_breakdown_voltage(p_pa, connection_length_m, dtype=dtype, device=device)
    return _tensor(v_loop, dtype, v_bd.device) > v_bd


class AvalancheTrace(NamedTuple):
    ne_m3: torch.Tensor
    te_ev: torch.Tensor
    ionization_fraction: torch.Tensor   # scalar final
    time_to_full_ionization_s: torch.Tensor  # inf if never


def townsend_avalanche(*, v_loop: float, p_pa: float, r0_m: float,
                       dt: float = 1e-5, n_steps: int = 2000,
                       seed_ne_m3: float = 1e13, dtype: torch.dtype = torch.float64,
                       device: torch.device | str = "cuda") -> AvalancheTrace:
    """Seed-electron avalanche to full ionization (reference
    ``TownsendAvalanche.evolve`` :100-140 physics), step by step."""
    e_par = v_loop / (2.0 * math.pi * r0_m)
    n_neutral = p_pa / (1.38e-23 * 300.0)

    ne = torch.as_tensor(seed_ne_m3, dtype=dtype, device=device)
    te = torch.as_tensor(1.0, dtype=dtype, device=device)
    ne_tr, te_tr = [], []
    for _ in range(n_steps):
        sig_v = 1e-14 * torch.exp(-13.6 / torch.clamp(te, min=0.1))
        nu_ion = n_neutral * sig_v * (te > 0.1)
        ne1 = torch.clamp(ne * (1.0 + nu_ion * dt), max=n_neutral)
        eta = 1e-4 / torch.clamp(te, min=0.1) ** 1.5
        p_ohmic = e_par ** 2 / eta
        p_loss = nu_ion * 13.6 * E_CHARGE * ne
        dte = (p_ohmic - p_loss) * dt / torch.clamp(ne, min=1e-6) / E_CHARGE
        te = torch.clamp(te + dte, 0.5, 10.0)
        ne = ne1
        ne_tr.append(ne)
        te_tr.append(te)
    ne_tr, te_tr = torch.stack(ne_tr), torch.stack(te_tr)
    frac = ne_tr[-1] / n_neutral
    full = ne_tr >= 0.99 * n_neutral
    t_full = torch.where(full.any(), torch.argmax(full.to(torch.int8)).to(dtype) * dt,
                         torch.full((), math.inf, dtype=dtype, device=ne_tr.device))
    return AvalancheTrace(ne_m3=ne_tr, te_ev=te_tr,
                          ionization_fraction=frac,
                          time_to_full_ionization_s=t_full)


class BurnThroughTrace(NamedTuple):
    te_ev: torch.Tensor
    succeeded: torch.Tensor   # bool: Te cleared the radiation barrier


def burn_through(*, v_loop: float, r0_m: float, a_m: float,
                 ne19: float = 1.0, impurity_fraction: float = 0.01,
                 dt: float = 1e-4, n_steps: int = 3000, dtype: torch.dtype = torch.float64,
                 device: torch.device | str = "cuda") -> BurnThroughTrace:
    """0D ohmic-heating vs line-radiation barrier (reference
    ``BurnThrough.evolve`` :214-256 contract: success = Te rises through
    the low-Z radiation peak around a few eV)."""
    ne = ne19 * 1e19
    te = torch.as_tensor(2.0, dtype=dtype, device=device)
    te_tr = []
    for _ in range(n_steps):
        # Spitzer-like resistivity (eta ~ Te^-3/2), loop-driven current
        eta = 1.65e-9 * 15.0 / torch.clamp(te / 1e3, min=1e-4) ** 1.5  # Te in eV
        e_par = v_loop / (2.0 * math.pi * r0_m)
        p_ohmic = e_par ** 2 / eta                                 # W/m^3
        # Low-Z line-radiation barrier: peaked near 10 eV
        lz = 1e-33 * torch.exp(-((torch.log(torch.clamp(te, min=0.5) / 10.0)) ** 2))
        p_rad = impurity_fraction * ne * ne * lz
        dte = (p_ohmic - p_rad) * dt / (1.5 * ne * E_CHARGE)
        te = torch.clamp(te + dte, 0.2, 1e4)
        te_tr.append(te)
    te_tr = torch.stack(te_tr)
    return BurnThroughTrace(te_ev=te_tr, succeeded=te_tr[-1] > 100.0)


class StartupResult(NamedTuple):
    breakdown_ok: torch.Tensor
    ionization_fraction: torch.Tensor
    burn_through_ok: torch.Tensor
    succeeded: torch.Tensor


def run_startup_sequence(*, v_loop: float, p_pa: float, r0_m: float,
                         a_m: float, ne19_post: float = 1.0,
                         impurity_fraction: float = 0.01,
                         connection_length_m: float = 100.0,
                         dtype: torch.dtype = torch.float64,
                         device: torch.device | str = "cuda") -> StartupResult:
    """Breakdown -> avalanche -> burn-through composite verdict
    (reference ``StartupSequence.run`` :287-310)."""
    bd = is_breakdown(v_loop, p_pa, connection_length_m, dtype=dtype, device=device)
    av = townsend_avalanche(v_loop=v_loop, p_pa=p_pa, r0_m=r0_m, dtype=dtype, device=device)
    bt = burn_through(v_loop=v_loop, r0_m=r0_m, a_m=a_m, ne19=ne19_post,
                      impurity_fraction=impurity_fraction, dtype=dtype, device=device)
    ok = bd & (av.ionization_fraction > 0.99) & bt.succeeded
    return StartupResult(breakdown_ok=bd,
                         ionization_fraction=av.ionization_fraction,
                         burn_through_ok=bt.succeeded, succeeded=ok)


# ---------------------------------------------------------------------------
# Scenario schedule (waveforms)
# ---------------------------------------------------------------------------

def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` (constant outside ``xp``), operation for
    operation, differentiable in ``fp``."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    epsilon = float(np.spacing(np.finfo(np.float64 if xp.dtype == torch.float64
                                        else np.float32).eps))
    dx0 = dx.abs() <= epsilon  # Prevent NaN gradients when `dx` is small.
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, torch.ones_like(dx), dx))
                    * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


@dataclasses.dataclass(frozen=True)
class Waveform:
    """Piecewise-linear breakpoint waveform; a value may be a tensor (a
    differentiable knob)."""

    times: tuple
    values: tuple

    def __post_init__(self):
        if len(self.times) != len(self.values) or len(self.times) < 2:
            raise ValueError("waveform needs >= 2 matching breakpoints")
        if any(b <= a for a, b in zip(self.times, self.times[1:])):
            raise ValueError("waveform times must be strictly increasing")

    def __call__(self, t):
        """The waveform at ``t`` (a tensor: on its device and in its float
        type; a number: float64 on the card)."""
        t = _tensor(t, torch.float64, "cuda")
        dtype = t.dtype if t.is_floating_point() else torch.float64
        xp = torch.tensor(self.times, dtype=dtype, device=t.device)
        fp = torch.stack([_tensor(v, dtype, t.device).to(dtype) for v in self.values])
        return interp(t.to(dtype), xp, fp)


@dataclasses.dataclass(frozen=True)
class ScenarioSchedule:
    """Named waveform bundle (reference ``ScenarioSchedule`` contract)."""

    waveforms: tuple   # ((name, Waveform), ...)

    def evaluate(self, t) -> dict:
        return {name: wf(t) for name, wf in self.waveforms}

    @property
    def duration(self) -> float:
        return max(wf.times[-1] for _, wf in self.waveforms)

    def validate(self) -> list:
        problems = []
        names = [n for n, _ in self.waveforms]
        if len(set(names)) != len(names):
            problems.append("duplicate waveform names")
        for name, wf in self.waveforms:
            if name.startswith("ip") and any(v < 0 for v in wf.values):
                problems.append(f"{name}: negative plasma current")
            if name.startswith("ne") and any(v <= 0 for v in wf.values):
                problems.append(f"{name}: non-positive density")
        return problems


def standard_shot_schedule(*, ip_flat_ma: float = 15.0,
                           ramp_s: float = 60.0, flattop_s: float = 300.0,
                           ne_flat_19: float = 10.0,
                           p_aux_flat_mw: float = 50.0) -> ScenarioSchedule:
    """Ramp-up / flattop / ramp-down template shot.

    Density is STAGED (ITER-style H-mode access): the Ip ramp ends at half
    the flattop density — where the Martin L-H threshold is low enough for
    the auxiliary power to cross it — and the density completes its ramp
    early in the flattop once alpha heating holds the plasma inside the
    H-mode hysteresis band.
    """
    end = 2 * ramp_s + flattop_s
    t_full_ne = ramp_s + 0.3 * flattop_s
    return ScenarioSchedule(waveforms=(
        ("ip_ma", Waveform((0.0, ramp_s, ramp_s + flattop_s, end),
                           (0.1, ip_flat_ma, ip_flat_ma, 0.1))),
        # Density pumps out FASTER than the current ramp-down so the
        # Greenwald fraction stays below 1 through termination.
        ("ne19", Waveform((0.0, ramp_s, t_full_ne, ramp_s + flattop_s,
                           ramp_s + flattop_s + 0.5 * ramp_s, end),
                          (0.5, 0.5 * ne_flat_19, ne_flat_19, ne_flat_19,
                           0.3, 0.3))),
        ("p_aux_mw", Waveform((0.0, 0.5 * ramp_s, ramp_s,
                               ramp_s + flattop_s, end),
                              (0.0, 0.0, p_aux_flat_mw, p_aux_flat_mw,
                               0.0))),
    ))


# ---------------------------------------------------------------------------
# Volt-second (flux) budget
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FluxBudget:
    """CS flux budget with Ejima resistive consumption (reference
    ``FluxBudget`` ``volt_second_manager.py:45-74``)."""

    phi_cs_vs: float           # total available CS swing [V s]
    l_plasma_uh: float         # plasma inductance [uH]
    r0_m: float = 6.2
    ejima_coeff: float = 0.45

    def inductive_flux(self, ip_ma):
        return self.l_plasma_uh * 1e-6 * ip_ma * 1e6

    def resistive_flux(self, ip_ma):
        """Ejima: Phi_res = C_E mu0 R0 Ip."""
        return self.ejima_coeff * MU0 * self.r0_m * ip_ma * 1e6

    def remaining_flux(self, ip_ma):
        return (self.phi_cs_vs - self.inductive_flux(ip_ma)
                - self.resistive_flux(ip_ma))

    def max_flattop_duration(self, ip_ma, loop_voltage_v,
                             bootstrap_fraction=0.0):
        """Flattop time = remaining flux / (V_loop * (1 - f_bs))."""
        v_eff = _floor(loop_voltage_v * (1.0 - bootstrap_fraction), 1e-6)
        return _floor(self.remaining_flux(ip_ma), 0.0) / v_eff


class FluxConsumptionTrace(NamedTuple):
    consumed_vs: torch.Tensor
    remaining_vs: torch.Tensor
    exhausted_at_s: torch.Tensor


def monitor_flux_consumption(budget: FluxBudget, times_s: torch.Tensor,
                             ip_ma: torch.Tensor,
                             v_loop: torch.Tensor) -> FluxConsumptionTrace:
    """Integrate V_loop dt on top of the inductive share; report when the
    budget runs out (reference ``FluxConsumptionMonitor``)."""
    dt = torch.diff(times_s, prepend=times_s[:1])
    resistive = torch.cumsum(v_loop * dt, 0)
    consumed = budget.inductive_flux(ip_ma) + resistive
    remaining = budget.phi_cs_vs - consumed
    out = remaining <= 0.0
    t_exhaust = torch.where(out.any(), times_s[torch.argmax(out.to(torch.int8))],
                            torch.full_like(times_s[0], math.inf))
    return FluxConsumptionTrace(consumed_vs=consumed,
                                remaining_vs=remaining,
                                exhausted_at_s=t_exhaust)
