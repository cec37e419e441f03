"""High-beta negative-triangularity scenario campaign, the port's
``validation/run_neg_triangularity.py``.

Counterpart of the reference's
``validation/high_beta_negative_triangularity_campaign.py`` (compact
spherical-tokamak-like reduced-order scenario: R=1.8 m, a=1.2 m,
kappa=2.2, delta=-0.3, Ip=8 MA, Bt=6 T, q95=5.5, P_SOL=50 MW, liquid
metal divertor at 45x expansion, vertical growth 28 1/s).  Every lane
carries an explicit claim boundary: these are reduced-order scenario
contracts, not hardware evidence of beta-40 operation.  Lanes (fail-closed):

1. geometry_contract    — aspect ratio in [1.15, 1.65], kappa > 2,
   delta < 0, beta target fraction in [0.30, 0.45] + Troyon-referenced
   beta accounting.
2. edge_elm_contract    — the NT edge sits INSIDE the coupled
   peeling-ballooning boundary (margin > 0.05), with a bounded Type-I
   crash stress case for sizing.
3. divertor_contract    — TEMHD liquid-metal operating state at
   8 m/s / 50 MW / 45x expansion is stable (index <= 1) and the surface
   stays below 2000 C.
4. vertical_control     — reduced 2-state vertical replay at
   gamma = 28 1/s with the additive-lag-sized PD gain: deterministic
   (two replays bit-identical), bounded, and restoring from a 5 mm kick.

Runs in float64 on ``device``; writes checksummed JSON+MD evidence into
``out_dir``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from scpn_fusion_tpu_torch.validation import REPORTS_DIR

MU0 = 4.0e-7 * np.pi


@dataclasses.dataclass(frozen=True)
class NTScenario:
    """Reduced-order compact NT scenario contract (reference
    ``NegativeTriangularityScenario``)."""

    scenario_id: str = "compact_negative_triangularity_high_beta_v1"
    major_radius_m: float = 1.8
    minor_radius_m: float = 1.2
    elongation_kappa: float = 2.2
    triangularity_delta: float = -0.3
    target_beta_fraction: float = 0.40   # fraction of the Troyon limit
    plasma_current_ma: float = 8.0
    toroidal_field_t: float = 6.0
    q95: float = 5.5
    edge_alpha: float = 0.8
    edge_current_norm: float = 0.15      # j_edge / (1 MA m^-2)
    edge_shear: float = 2.3
    p_sol_mw: float = 50.0
    divertor_expansion_factor: float = 45.0
    liquid_metal_flow_m_s: float = 8.0
    vertical_growth_rate_s_inv: float = 28.0
    vertical_actuator_gain_m_s2: float = 150.0
    vertical_damping_s_inv: float = 9.5

    def __post_init__(self) -> None:
        if self.triangularity_delta >= 0.0:
            raise ValueError("triangularity_delta must be negative")
        for name in ("major_radius_m", "minor_radius_m", "plasma_current_ma",
                     "toroidal_field_t", "q95", "p_sol_mw",
                     "divertor_expansion_factor", "liquid_metal_flow_m_s",
                     "vertical_growth_rate_s_inv"):
            v = getattr(self, name)
            if not np.isfinite(v) or v <= 0.0:
                raise ValueError(f"{name} must be finite and positive")
        if self.elongation_kappa < 1.0:
            raise ValueError("elongation_kappa must be >= 1")



def main(*, device: torch.device | str = "cuda", out_dir: str | Path = REPORTS_DIR) -> int:
    from scpn_fusion_tpu_torch.control.vessel_rzip import required_feedback_gain
    from scpn_fusion_tpu_torch.models.physics.divertor_lab import (
        temhd_liquid_metal_state,
    )
    from scpn_fusion_tpu_torch.models.physics.elm import (
        ballooning_limit,
        elm_crash,
        elm_power_balance_frequency,
        peeling_limit,
        pb_unstable,
    )
    from scpn_fusion_tpu_torch.utils.evidence import LaneResult, write_report

    dev = torch.device(device)
    f64 = torch.float64
    kw = dict(dtype=f64, device=dev)
    sc = NTScenario()
    lanes = []
    claim = ("reduced-order scenario contract only; NOT hardware evidence "
             "of beta-40 operation or external same-case parity "
             "(reference campaign carries the same claim boundary)")

    # ── Lane 1: geometry + beta accounting ──
    aspect = sc.major_radius_m / sc.minor_radius_m
    troyon_beta_pct = 2.8 * sc.plasma_current_ma / (
        sc.minor_radius_m * sc.toroidal_field_t)
    beta_target_pct = sc.target_beta_fraction * troyon_beta_pct
    ok1 = (1.15 <= aspect <= 1.65 and sc.elongation_kappa > 2.0
           and sc.triangularity_delta < 0.0
           and 0.30 <= sc.target_beta_fraction <= 0.45)
    lanes.append(LaneResult(
        name="geometry_contract",
        status="pass" if ok1 else "fail",
        metrics={"aspect_ratio": aspect,
                 "elongation_kappa": sc.elongation_kappa,
                 "triangularity_delta": sc.triangularity_delta,
                 "target_beta_fraction_of_troyon": sc.target_beta_fraction,
                 "troyon_no_wall_beta_pct": float(troyon_beta_pct),
                 "target_beta_pct": float(beta_target_pct)},
        thresholds={"aspect_ratio": [1.15, 1.65],
                    "target_beta_fraction": [0.30, 0.45]},
        notes=claim,
    ))

    # ── Lane 2: edge peeling-ballooning contract at delta < 0 ──
    unstable = bool(pb_unstable(sc.edge_alpha, sc.edge_current_norm,
                                sc.edge_shear, sc.q95, sc.elongation_kappa,
                                sc.triangularity_delta, **kw))
    a_crit = float(ballooning_limit(sc.edge_shear, **kw))
    j_crit = float(peeling_limit(sc.edge_current_norm, sc.q95,
                                 sc.elongation_kappa,
                                 sc.triangularity_delta, **kw))
    radius = float(np.sqrt((sc.edge_alpha / max(a_crit, 1e-3)) ** 2
                           + (sc.edge_current_norm / max(j_crit, 1e-3)) ** 2))
    margin = 1.0 - radius
    crash = elm_crash(4.5, 4.0, 12.0, **kw)      # bounded stress case, ref values
    f_elm = float(elm_power_balance_frequency(sc.p_sol_mw, 12.0, 0.04, **kw))
    ok2 = (margin > 0.05) and not unstable
    lanes.append(LaneResult(
        name="edge_elm_contract",
        status="pass" if ok2 else "fail",
        metrics={"pb_margin": margin, "pb_unstable": unstable,
                 "alpha_crit": a_crit, "j_crit": j_crit,
                 "stress_case_delta_w_mj": float(crash.delta_w_mj),
                 "stress_case_f_elm_hz": f_elm},
        thresholds={"pb_margin": 0.05},
        notes=("NT edge inside the coupled PB boundary; crash numbers are "
               "a bounded sizing stress case, not a prediction. " + claim),
    ))

    # ── Lane 3: TEMHD liquid-metal divertor contract ──
    b_pol = MU0 * sc.plasma_current_ma * 1e6 / (
        2.0 * np.pi * sc.minor_radius_m
        * np.sqrt((1.0 + sc.elongation_kappa**2) / 2.0))
    state = temhd_liquid_metal_state(
        sc.liquid_metal_flow_m_s, sc.p_sol_mw, sc.major_radius_m, b_pol,
        expansion_factor=sc.divertor_expansion_factor, **kw)
    ok3 = bool(state.is_stable) and float(state.t_surface_c) < 2000.0
    lanes.append(LaneResult(
        name="divertor_contract",
        status="pass" if ok3 else "fail",
        metrics={"b_pol_t": float(b_pol),
                 "t_surface_c": float(state.t_surface_c),
                 "q_surface_mw_m2": float(state.q_surface) / 1e6,
                 "stability_index": float(state.stability_index),
                 "stable": bool(state.is_stable)},
        thresholds={"stability_index": 1.0, "t_surface_c": 2000.0},
        notes=("liquid-metal target at 8 m/s, 45x flux expansion, "
               "50 MW P_SOL. " + claim),
    ))

    # ── Lane 4: vertical-control replay at gamma = 28 1/s ──
    gamma = sc.vertical_growth_rate_s_inv
    tau_wall = 1.0 / sc.vertical_damping_s_inv
    g_min = required_feedback_gain(gamma, tau_wall, 2.0e-3)
    kp = 2.0 * g_min * gamma            # sized above the sizing rule
    kd = 2.0 * g_min

    def replay(z0):
        """The 2000-step PD replay of JAX's ``lax.scan``, step by step on
        0-d float64 tensors on ``device``."""
        dt = 1.0e-3
        z = torch.tensor(z0, **kw)
        v = torch.tensor(0.0, **kw)
        zs = []
        for _ in range(2000):
            u = -(kp * z + kd * v)       # PD voltage -> acceleration
            acc = (gamma**2) * z + sc.vertical_actuator_gain_m_s2 * torch.tanh(
                u) - sc.vertical_damping_s_inv * v
            v = v + dt * acc
            z = z + dt * v
            zs.append(z)
        return torch.stack(zs).cpu().numpy()

    traj1 = replay(5.0e-3)
    traj2 = replay(5.0e-3)
    deterministic = bool(np.array_equal(traj1, traj2))
    bounded = bool(np.max(np.abs(traj1)) < 0.1)
    restored = bool(abs(traj1[-1]) < 1.0e-3)
    ok4 = deterministic and bounded and restored
    lanes.append(LaneResult(
        name="vertical_control",
        status="pass" if ok4 else "fail",
        metrics={"gamma_s_inv": gamma, "g_min": float(g_min),
                 "max_abs_z_m": float(np.max(np.abs(traj1))),
                 "final_abs_z_m": float(abs(traj1[-1])),
                 "deterministic_replay": deterministic},
        thresholds={"max_abs_z_m": 0.1, "final_abs_z_m": 1.0e-3},
        notes=("2-state reduced vertical replay, additive-lag gain sizing "
               "g_min = gamma (tau_wall + tau_ctrl), saturated actuator. "
               + claim),
    ))

    write_report("neg_triangularity", lanes, out_dir=out_dir)
    return 0 if all(ln.status == "pass" for ln in lanes
                    if ln.status != "blocked") else 1
