"""Stellarator evidence lane: ISS04 parity, ripple, 1/nu neoclassical,
the port's ``validation/run_stellarator_lane.py`` (what the CLI's
``stellarator-replay`` mode runs).

Lanes:

1. iss04_formula_parity — the module's tau_E at a W7-X-like operating
   point equals the PUBLISHED Yamada 2005 Eq. 4 evaluated literally
   (0.134 a^2.28 R^0.64 P^-0.61 n^0.54 B^0.84 iota_{2/3}^0.41), to
   1e-10 relative, plus the published scaling exponents recovered by
   finite differencing in P and n.
2. ripple_structure — effective ripple is zero for the axisymmetric
   degenerate configuration, positive and < 0.1 for W7-X-like shaping,
   and the ISS04 tau at W7-X scale lands in the 0.05-0.5 s band.
3. one_over_nu_scaling — the 1/nu neoclassical chi scales as T^2.5 over
   a temperature decade (the reference's reduced v_th^2/nu form) and
   increases with eps_eff.

Runs in float64 on ``device``; writes checksummed JSON+MD evidence into
``out_dir``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from scpn_fusion_tpu_torch.validation import REPORTS_DIR


def main(*, device: torch.device | str = "cuda", out_dir: str | Path = REPORTS_DIR) -> int:
    from scpn_fusion_tpu_torch.models.physics.stellarator import (
        effective_ripple,
        iota_profile,
        iss04_tau_e,
        stellarator_neoclassical_chi,
        w7x_config,
    )
    from scpn_fusion_tpu_torch.utils.evidence import LaneResult, write_report

    kw = dict(dtype=torch.float64, device=torch.device(device))

    lanes = []
    cfg = w7x_config()

    # ── Lane 1: ISS04 parity + exponents ──
    n_e19, p_mw = 8.0, 5.0
    tau = float(iss04_tau_e(cfg, n_e19, p_mw, **kw))
    iota23 = float(iota_profile(cfg, 2.0 / 3.0, **kw))
    tau_lit = (0.134 * cfg.a**2.28 * cfg.r0**0.64 * p_mw**-0.61
               * n_e19**0.54 * cfg.b0**0.84 * iota23**0.41)
    rel = abs(tau - tau_lit) / tau_lit
    # Exponent recovery by log-FD.
    e_p = float(np.log(float(iss04_tau_e(cfg, n_e19, p_mw * 1.1, **kw))
                       / tau) / np.log(1.1))
    e_n = float(np.log(float(iss04_tau_e(cfg, n_e19 * 1.1, p_mw, **kw))
                       / tau) / np.log(1.1))
    ok1 = rel < 1e-10 and abs(e_p + 0.61) < 1e-6 and abs(e_n - 0.54) < 1e-6
    lanes.append(LaneResult(
        name="iss04_formula_parity",
        status="pass" if ok1 else "fail",
        metrics={"tau_e_s": tau, "tau_literal_s": tau_lit,
                 "rel_dev": rel, "exponent_P": e_p, "exponent_n": e_n,
                 "iota_2_3": iota23},
        thresholds={"rel_dev": 1e-10},
        notes="module ISS04 == published Yamada 2005 Eq. 4 literal "
              "evaluation; P and n exponents recovered exactly"))

    # ── Lane 2: ripple structure ──
    axi = dataclasses.replace(cfg, mirror_ratio=0.0, helical_excursion=0.0)
    eps_axi = float(effective_ripple(axi, 0.5, **kw))
    eps_w7x = float(effective_ripple(cfg, 0.5, **kw))
    ok2 = eps_axi == 0.0 and 0.0 < eps_w7x < 0.1 and 0.05 < tau < 0.5
    lanes.append(LaneResult(
        name="ripple_structure",
        status="pass" if ok2 else "fail",
        metrics={"eps_eff_axisymmetric": eps_axi,
                 "eps_eff_w7x_like": eps_w7x,
                 "iss04_tau_band_s": tau},
        thresholds={"eps_eff_w7x_max": 0.1},
        notes="axisymmetric degenerate case has zero ripple; W7-X-like "
              "shaping gives a small positive eps_eff; tau in the "
              "experimentally sensible band"))

    # ── Lane 3: 1/nu scaling ──
    t_lo, t_hi = 1.0, 10.0
    chi_lo = float(stellarator_neoclassical_chi(cfg, 0.5, t_lo, 5.0, **kw))
    chi_hi = float(stellarator_neoclassical_chi(cfg, 0.5, t_hi, 5.0, **kw))
    exponent = float(np.log(chi_hi / chi_lo) / np.log(t_hi / t_lo))
    big = dataclasses.replace(cfg, mirror_ratio=cfg.mirror_ratio * 2.0)
    chi_big = float(stellarator_neoclassical_chi(big, 0.5, t_lo, 5.0, **kw))
    ok3 = abs(exponent - 2.5) < 0.125 and chi_big > chi_lo
    lanes.append(LaneResult(
        name="one_over_nu_scaling",
        status="pass" if ok3 else "fail",
        metrics={"chi_T_exponent": exponent, "expected": 2.5,
                 "chi_1kev": chi_lo, "chi_10kev": chi_hi,
                 "chi_doubled_mirror": chi_big},
        thresholds={"exponent_tolerance": 0.125},
        notes="1/nu-regime chi ~ T^2.5 over a decade (the reference's "
              "reduced v_th^2/nu form, matched exactly; the full "
              "drift-velocity form would scale T^3.5 — disclosed); "
              "monotone in ripple amplitude"))

    path = write_report("stellarator_lane", lanes, out_dir=out_dir)
    print(f"wrote {path}")
    return 0 if all(lane.status == "pass" for lane in lanes) else 1

