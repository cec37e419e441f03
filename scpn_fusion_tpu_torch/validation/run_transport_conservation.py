"""Multi-ion transport conservation + power-balance contract campaign, the
port's ``validation/run_transport_conservation.py``.

Mirrors the reference's transport contract lanes
(`validation/benchmark_multi_ion_transport_conservation.py` — quasineutral
residual <= 1e-10, physically-sane He-ash trajectory — and
`validation/benchmark_transport_power_balance.py` — auxiliary-heating
power-balance reconstruction) for the port's 1.5D stepper
(`models/transport/solver.py`; on a CUDA device every Crank-Nicolson solve
runs the Thomas kernel).

Lanes (fail-closed):
1. aux_power_balance — volume-integrated heating deposition reconstructs
   the commanded P_aux to float rounding, for multi-ion and single-ion
   modes and both electron fractions.
2. quasineutrality — ne == n_D + n_T + 2 n_He + Z_W(Te) n_imp after one
   species step, at machine precision (reference gate 1e-10).
3. he_ash_trajectory — 200-step ITER-like burn: He-ash peak above floor,
   core fuel consumed, temperatures stay in a physically sane band.
4. steady_state_energy_balance — after relaxation, |dW/dt| is a small
   fraction of P_aux.

Runs in float64 on ``device``; writes checksummed JSON+MD evidence into
``out_dir``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from scpn_fusion_tpu_torch.validation import REPORTS_DIR


def main(*, device: torch.device | str = "cuda", out_dir: str | Path = REPORTS_DIR) -> int:
    from scpn_fusion_tpu_torch.models.transport.closures import E_KEV_J
    from scpn_fusion_tpu_torch.models.transport.solver import (
        TransportParams,
        _aux_heating,
        _evolve_species,
        _volume_element,
        initial_state,
        run_transport,
    )
    from scpn_fusion_tpu_torch.utils.evidence import LaneResult, write_report

    dev = torch.device(device)
    f64 = torch.float64

    def scalar(x):
        return torch.tensor(x, dtype=f64, device=dev)

    lanes = []

    # ── Lane 1: aux heating power-balance reconstruction ──
    metrics, worst = {}, 0.0
    for multi_ion, e_frac in ((True, 0.5), (True, 0.0), (False, 0.0)):
        params = TransportParams(multi_ion=multi_ion,
                                 aux_heating_electron_fraction=e_frac)
        s = initial_state(params, dtype=f64, device=dev)
        rho = params.rho(f64, dev)
        p_aux = 50.0
        s_i, s_e = _aux_heating(params, scalar(p_aux), s.ne, rho)
        d_v = _volume_element(params, rho)
        ne_si = torch.clamp(s.ne, 0.1, 1e3) * 1e19
        p_rec_w = float(torch.sum(
            1.5 * (s_i + s_e) * ne_si * E_KEV_J * d_v))
        rel = abs(p_rec_w - p_aux * 1e6) / (p_aux * 1e6)
        tag = f"{'multi' if multi_ion else 'single'}_efrac{e_frac}"
        metrics[f"rel_err_{tag}"] = rel
        worst = max(worst, rel)
    lanes.append(LaneResult(
        name="aux_power_balance",
        status="pass" if worst <= 1e-10 else "fail",
        metrics={**metrics, "p_aux_mw": 50.0},
        thresholds={"rel_err_max": 1e-10},
        notes="volume-integrated (3/2) n_e T-rate deposition vs commanded "
              "P_aux; mirrors benchmark_transport_power_balance.py"))

    # ── Lane 2: quasineutrality at machine precision ──
    params = TransportParams(multi_ion=True)
    s = initial_state(params, dtype=f64, device=dev)
    rho = params.rho(f64, dev)
    s2, _ = _evolve_species(params, s, scalar(0.01), scalar(40.0), rho,
                            params.drho)
    te_safe = torch.clamp(s.te, 0.1, 1e3)   # z_w convention: Te at species step
    z_w = torch.clamp(15.0 + 12.0 * torch.log10(te_safe), 10.0, 50.0)
    qn = s2.ne - torch.clamp(
        s2.n_d + s2.n_t + 2.0 * s2.n_he + z_w * torch.clamp(s2.n_imp, min=0.0),
        min=0.1)
    qn_resid = float(qn.abs().max() / s2.ne.max())
    lanes.append(LaneResult(
        name="quasineutrality",
        status="pass" if qn_resid <= 1e-12 else "fail",
        metrics={"max_rel_residual": qn_resid},
        thresholds={"max_rel_residual": 1e-12},
        notes="ne == n_D + n_T + 2 n_He + Z_W(Te) n_imp after one species "
              "step (reference contract gate 1e-10; f64)"))

    # ── Lane 3: physically sane He-ash burn trajectory ──
    params = TransportParams(multi_ion=True)
    s = initial_state(params, dtype=f64, device=dev)
    rho = params.rho(f64, dev)
    s = s._replace(ti=s.ti * 0.0 + 8.0 * (1 - rho ** 2) + 0.1,
                   te=s.te * 0.0 + 8.0 * (1 - rho ** 2) + 0.1)
    final, traces = run_transport(s, 0.01, 40.0, params, 200)
    he_trace = traces["n_he0"].cpu().numpy()
    ti_trace = traces["ti0"].cpu().numpy()
    he_peak = float(he_trace.max())
    fuel_drop = float(s.n_d[1] - final.n_d[1])
    ti_band_ok = bool((ti_trace > 0.3).all() and (ti_trace < 60.0).all())
    finite_ok = bool(torch.isfinite(final.ti).all() and torch.isfinite(final.n_he).all())
    he_ok = he_peak >= 1e-4 and fuel_drop > 0.0
    lanes.append(LaneResult(
        name="he_ash_trajectory",
        status="pass" if (he_ok and ti_band_ok and finite_ok) else "fail",
        metrics={"he_ash_peak_1e19": he_peak,
                 "core_fuel_drop_1e19": fuel_drop,
                 "ti_core_final_kev": float(ti_trace[-1]),
                 "all_finite": finite_ok},
        thresholds={"he_ash_peak_min": 1e-4, "ti_band_kev": [0.3, 60.0]},
        notes="200-step ITER-like burn at 40 MW: ash accumulates, core "
              "fuel is consumed, trajectory stays in the ~keV band "
              "(reference's recalibrated sane-trajectory contract)"))

    # ── Lane 4: steady-state energy balance ──
    params = TransportParams(multi_ion=False)
    s = initial_state(params, dtype=f64, device=dev)
    p_aux = 30.0
    mid, _ = run_transport(s, 0.005, p_aux, params, 3000)
    fin, _ = run_transport(mid, 0.005, p_aux, params, 200)
    rho = params.rho(f64, dev)
    d_v = _volume_element(params, rho)

    def stored_w(st):
        return float(torch.sum(1.5 * (st.ne * 1e19) * (st.ti + st.te)
                               * E_KEV_J * d_v))

    w_mid, w_fin = stored_w(mid), stored_w(fin)
    dwdt_w = abs(w_fin - w_mid) / (200 * 0.005)
    frac = dwdt_w / (p_aux * 1e6)
    lanes.append(LaneResult(
        name="steady_state_energy_balance",
        status="pass" if frac <= 0.02 else "fail",
        metrics={"stored_energy_mj": w_fin / 1e6,
                 "dwdt_fraction_of_p_aux": frac},
        thresholds={"dwdt_fraction_of_p_aux": 0.02},
        notes="after 15 s of relaxation the residual dW/dt is <=2% of "
              "P_aux: the CN stepper settles to flux balance instead of "
              "ratcheting energy (reference late-energy-error gate intent)"))

    path = write_report("transport_conservation", lanes, out_dir=out_dir)
    print(f"report: {path}")
    return 0 if all(l.status == "pass" for l in lanes) else 1
