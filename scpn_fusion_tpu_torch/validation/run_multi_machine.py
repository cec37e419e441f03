"""Multi-machine validation campaign (5 machines, real solver slices), the
port's ``validation/run_multi_machine.py``.

Counterpart of the reference's ``validation/multi_machine_validation.py``
(machine-profile collection -> equilibrium / transport / diagnostics
metrics): per machine a fixed-boundary GS solve on machine-scaled
geometry, IPB98(y,2) confinement, and a forward-diagnostics
inverse-consistency check.  Machine parameters are public device values
(ITER / SPARC / DIII-D / JET / MAST-U-like).  Lanes (fail-closed):

1. multi_machine_equilibrium — the 65^2 GS solve CONVERGES on all five
   machine geometries (coil pattern scaled by R0, plasma current set to
   the device Ip), with positive flux span and bounded iterations.
2. multi_machine_confinement — IPB98(y,2) tau_E per machine is finite,
   sits in a broad published-expectation window, and the cross-machine
   ordering (ITER > SPARC > JET > DIII-D > MAST) holds.
3. diagnostics_inverse_consistency — per machine, the line-averaged
   density recovered from the synthetic interferometer phase equals the
   profile's true chord average to < 2%, and the core Thomson channel
   tracks the core density monotonically across machines.

Float64 on ``device``, as the script's solves (``dtype=float64``) and
maps are.  Writes checksummed JSON+MD evidence into ``out_dir``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from scpn_fusion_tpu_torch.validation import REPORTS_DIR
from scpn_fusion_tpu_torch.validation._lanes import exit_code

# name, R0, a, Ip, Bt, kappa, ne19, P_loss, tau window
MACHINES = [
    ("ITER",   6.20, 2.00, 15.0, 5.30, 1.80, 10.0, 100.0, (2.0, 5.0)),
    ("JET",    2.96, 0.95,  4.0, 3.45, 1.70,  5.0,  20.0, (0.2, 1.2)),
    ("SPARC",  1.85, 0.57,  8.7, 12.2, 1.97, 30.0,  25.0, (0.3, 1.5)),
    ("DIII-D", 1.67, 0.67,  1.5, 2.10, 1.80,  6.0,  10.0, (0.05, 0.4)),
    ("MAST-U", 0.85, 0.65,  1.0, 0.55, 2.45,  3.0,   4.0, (0.01, 0.2)),
]
# (r / R0, z / R0, current / Ip) of the six PF coils
PF_PATTERN = [
    (0.565, +0.774, -1.0 / 15.0), (1.290, +0.774, 4.0 / 15.0),
    (1.742, 0.0, 6.0 / 15.0), (1.290, -0.774, 4.0 / 15.0),
    (0.565, -0.774, -1.0 / 15.0), (1.742, 0.403, 3.0 / 15.0),
]
ELECTRON_RADIUS_M = 2.8179403262e-15


def machine_config(name: str, r0: float, ip: float):
    """A machine's 65^2 configuration: the PF pattern scaled by R0, the
    device Ip as the target, L-mode profiles, multigrid Picard."""
    from scpn_fusion_tpu_torch.core.config import (
        Coil, Dimensions, PhysicsParams, ReactorConfig, SolverParams,
    )
    coils = tuple(Coil(r=r0 * pr, z=r0 * pz, current=ip * pc, name=f"PF{i + 1}")
                  for i, (pr, pz, pc) in enumerate(PF_PATTERN))
    return ReactorConfig(
        reactor_name=name, grid_resolution=(65, 65),
        dimensions=Dimensions(R_min=0.35 * r0, R_max=1.80 * r0, Z_min=-0.70 * r0,
                              Z_max=0.70 * r0),
        coils=coils,
        physics=PhysicsParams(plasma_current_target=ip, vacuum_permeability=1.0,
                              profile_mode="l-mode"),
        solver=SolverParams(max_iterations=600, convergence_threshold=1e-4,
                            relaxation_factor=0.1, solver_method="multigrid", inner_sweeps=1))


def machine_solves(device, dtype: torch.dtype = torch.float64) -> dict:
    """Lane 1's solve of each machine in ``dtype`` (on a CUDA device in
    float32, kernels 2 and 3 once each a Picard iteration): by machine,
    (result, psi span)."""
    from scpn_fusion_tpu_torch.models.equilibrium import solve_equilibrium
    out = {}
    for name, r0, _a, ip, *_ in MACHINES:
        res = solve_equilibrium(machine_config(name, r0, ip), dtype=dtype, device=device)
        out[name] = (res, float(res.psi.max() - res.psi.min()))
    return out


def main(*, device: torch.device | str = "cuda", out_dir: str | Path = REPORTS_DIR) -> int:
    from scpn_fusion_tpu_torch.core.grid import Grid
    from scpn_fusion_tpu_torch.models.diagnostics.forward import (
        interferometer_phase_shift, thomson_scattering_voltage,
    )
    from scpn_fusion_tpu_torch.models.physics.scaling_burn import ipb98y2_tau_e
    from scpn_fusion_tpu_torch.utils.evidence import LaneResult, write_report

    lanes = []
    f64 = torch.float64

    # ── Lane 1: equilibrium on each machine ──
    eq_rows = []
    all_conv = True
    for name, (res, span) in machine_solves(device, f64).items():
        conv = bool(res.converged)
        all_conv &= conv and span > 0 and int(res.iterations) < 600
        eq_rows.append({"machine": name, "converged": conv,
                        "iterations": int(res.iterations), "psi_span": span})
    lanes.append(LaneResult(
        name="multi_machine_equilibrium",
        status="pass" if all_conv else "fail",
        metrics={"machines": eq_rows},
        thresholds={"max_iterations": 600},
        notes="65^2 multigrid-Picard solve on R0-scaled PF pattern, "
              "device Ip as the current target",
    ))

    # ── Lane 2: IPB98(y,2) confinement ──
    taus = {}
    windows_ok = True
    for name, r0, a, ip, bt, kappa, ne19, ploss, window in MACHINES:
        tau = float(ipb98y2_tau_e(ip, bt, ne19, ploss, r0, kappa, a / r0))
        taus[name] = tau
        windows_ok &= np.isfinite(tau) and window[0] <= tau <= window[1]
    order = ["ITER", "SPARC", "JET", "DIII-D", "MAST-U"]
    ordering_ok = all(taus[order[i]] > taus[order[i + 1]] for i in range(len(order) - 1))
    lanes.append(LaneResult(
        name="multi_machine_confinement",
        status="pass" if (windows_ok and ordering_ok) else "fail",
        metrics={"tau_e_s": taus, "ordering": order, "ordering_holds": ordering_ok},
        thresholds={m[0]: list(m[8]) for m in MACHINES},
        notes="IPB98(y,2) at public device parameters; windows are broad "
              "published expectations, ordering is the sharper gate",
    ))

    # ── Lane 3: diagnostics inverse consistency ──
    diag_rows = []
    ok3 = True
    core_voltages = []
    kw = dict(dtype=f64, device=device)
    for name, r0, a, ip, bt, kappa, ne19, ploss, window in MACHINES:
        grid = Grid.from_bounds(129, 129, r0 - 1.2 * a, r0 + 1.2 * a,
                                -1.2 * a * kappa, 1.2 * a * kappa, **kw)
        rho = torch.sqrt(((grid.RR - r0) / a) ** 2 + (grid.ZZ / (a * kappa)) ** 2)
        ne_map = ne19 * 1e19 * torch.clamp(1.0 - rho**2, min=0.0)
        te_map = 10.0 * torch.clamp(1.0 - rho**2, min=0.0) ** 1.5
        chord = torch.tensor([[[r0, -1.2 * a * kappa], [r0, 1.2 * a * kappa]]], **kw)
        phase = float(interferometer_phase_shift(ne_map, grid, chord, samples=513)[0])
        lam = 1.064e-6
        length = 2.0 * 1.2 * a * kappa
        nbar_rec = phase / (ELECTRON_RADIUS_M * lam * length)
        z = np.linspace(-1.2 * a * kappa, 1.2 * a * kappa, 4097)
        ne_true = ne19 * 1e19 * np.maximum(1.0 - (z / (a * kappa)) ** 2, 0.0)
        nbar_true = float(np.trapezoid(ne_true, z) / length)
        rel = abs(nbar_rec - nbar_true) / nbar_true
        v_core = float(thomson_scattering_voltage(ne_map, te_map, grid,
                                                  torch.tensor([[r0, 0.0]], **kw))[0])
        core_voltages.append((ne19, v_core))
        ok3 &= rel < 0.02
        diag_rows.append({"machine": name, "phase_rad": phase, "nbar_recovered_m3": nbar_rec,
                          "nbar_true_m3": nbar_true, "rel_err": rel, "thomson_core_v": v_core})
    mono = all(v2 > v1 for (n1, v1), (n2, v2)
               in zip(sorted(core_voltages), sorted(core_voltages)[1:]))
    ok3 &= mono
    lanes.append(LaneResult(
        name="diagnostics_inverse_consistency",
        status="pass" if ok3 else "fail",
        metrics={"machines": diag_rows, "thomson_monotone_in_density": mono},
        thresholds={"nbar_rel_err": 0.02},
        notes="line-averaged density recovered from the interferometer "
              "phase vs the analytic chord average; Thomson core channel "
              "monotone in device density",
    ))

    write_report("multi_machine", lanes, out_dir=out_dir)
    return exit_code(lanes)
