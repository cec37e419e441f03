"""The port's ``tracking_acceptance`` campaign on the CPU.

The committed ``validation/reports/tracking_acceptance.json`` was made on the
CPU in float64, but its 132 closed-loop ticks (each seven free-boundary
plant solves at 33^2) take ~13 minutes on one CPU thread.  So the test holds
the campaign in two parts.  The lanes' assembly: the shots are replaced by
traces that carry the committed report's numbers, in the script's order of
shots, and the port's report must then equal the committed one (every
metric within 1e-9 relative, statuses, thresholds and notes), its
supervisor lane's drift measured against the machine's own currents.  The
shots' arithmetic: the initial plant solve and its objectives against JAX's
``_plant_solve`` and ``soft_objectives`` in float64, within 1e-9 (the
closed-loop shots are held to JAX by ``tests/test_torch_tracking.py``).
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

from scpn_fusion_tpu_torch.control import free_boundary_tracking as fbt
from scpn_fusion_tpu_torch.validation import run_tracking_acceptance as ta
from tests.torch_parity import flat_report, report_mismatches

ROOT = Path(__file__).resolve().parent.parent
COMMITTED = ROOT / "validation" / "reports" / "tracking_acceptance.json"


def committed_traces(ref: dict, coils) -> list:
    """The script's shots in order, as traces carrying the report's numbers."""
    m = {lane["name"]: lane["metrics"] for lane in ref["lanes"]}
    f64 = torch.float64

    def trace(errors, max_current=6.0, levels=None, last_currents=None):
        n = len(errors)
        currents = torch.zeros((n, 6), dtype=f64)
        currents[0, 0] = max_current
        if last_currents is not None:
            currents[-1] = last_currents
        levels = torch.zeros(n, dtype=torch.int64) if levels is None else torch.tensor(levels)
        return fbt.TrackingTrace(objectives=torch.zeros((n, 4), dtype=f64), currents=currents,
                                 reconstructed_currents=currents.clone(),
                                 reconstruction_rms=torch.zeros(n, dtype=f64),
                                 alert_level=levels, axis_error=torch.tensor(errors, dtype=f64))

    nom = m["nominal_convergence"]
    kick = m["coil_kick_rejection"]
    off = m["measurement_offset_corrected"]
    lat = m["latency_sweep"]
    fb = m["supervisor_fallback"]
    return ([trace([nom["initial_error"], nom["final_error"]], nom["max_abs_current"])]
            + [trace([1.0, kick[f"final_error_kick_{s}"]], kick[f"max_abs_current_kick_{s}"])
               for s in ta.KICK_SCALES]
            + [trace([1.0, off["true_error_uncorrected"]]),
               trace([1.0, off["true_error_corrected"]])]
            + [trace([1.0, lat[f"final_error_latency_{k}"]]) for k in ta.LATENCY_STEPS]
            + [trace([1.0] * 6, levels=fb["alert_levels"], last_currents=coils.currents)])


def test_lanes_assemble_the_committed_report(tmp_path, monkeypatch):
    ref = json.loads(COMMITTED.read_text())
    plant = fbt._plant_solve
    shots, calls = [], []

    def fake_plant(coils, cfg, grid, use_pallas):
        if not shots:
            shots.extend(committed_traces(ref, coils))
        return plant(coils, cfg, grid, use_pallas)

    def fake_shot(cfg, coils, targets, *, n_steps, **kw):
        calls.append(n_steps)
        return shots[len(calls) - 1]

    monkeypatch.setattr(fbt, "_plant_solve", fake_plant)
    monkeypatch.setattr(fbt, "run_tracking_shot", fake_shot)
    assert ta.main(device="cpu", out_dir=tmp_path) == 0
    assert calls == [10, 12, 12, 12, 12, 12, 14, 14, 14, 14, 6] == [n for _, n in ta.SHOTS]
    ours = json.loads((tmp_path / "tracking_acceptance.json").read_text())
    assert [lane["notes"] for lane in ours["lanes"]] == [lane["notes"] for lane in ref["lanes"]]
    assert report_mismatches(flat_report(ours), flat_report(ref)) == {}


def test_initial_plant_solve_against_jax():
    from scpn_fusion_tpu.control import free_boundary_tracking as jfbt
    from scpn_fusion_tpu.core.config import (
        Coil, Dimensions, PhysicsParams, ReactorConfig, SolverParams,
    )
    from scpn_fusion_tpu.core.grid import Grid as JaxGrid
    from scpn_fusion_tpu.models.equilibrium.free_boundary import (
        coilset_from_config as jax_coilset,
    )
    from scpn_fusion_tpu_torch.core.grid import Grid
    from scpn_fusion_tpu_torch.models.equilibrium.free_boundary import coilset_from_config
    from scpn_fusion_tpu_torch.bench_config import ITER_LIKE
    from scpn_fusion_tpu_torch.validation._lanes import iter_like

    cfg = iter_like("tracking-acceptance", 33, ip=150.0, max_iterations=80,
                    convergence_threshold=1e-4, relaxation_factor=0.1, solver_method="multigrid")
    grid = Grid.from_config(cfg, dtype=torch.float64, device="cpu")
    psi = fbt._plant_solve(coilset_from_config(cfg, torch.float64, "cpu"), cfg, grid, False)
    obj = fbt.soft_objectives(psi, grid)
    jcfg = ReactorConfig(
        reactor_name="tracking-acceptance", grid_resolution=(33, 33),
        dimensions=Dimensions(R_min=2.0, R_max=10.0, Z_min=-4.0, Z_max=4.0),
        coils=tuple(Coil(**c) for c in ITER_LIKE["coils"]),
        physics=PhysicsParams(plasma_current_target=150.0, vacuum_permeability=1.0),
        solver=SolverParams(max_iterations=80, convergence_threshold=1e-4,
                            relaxation_factor=0.1, solver_method="multigrid"))
    jgrid = JaxGrid.from_config(jcfg, dtype=np.float64)
    jpsi = jfbt._plant_solve(jax_coilset(jcfg, jnp.float64), jcfg, jgrid, False)
    jobj = np.asarray(jfbt.soft_objectives(jpsi, jgrid))
    p = np.asarray(jpsi)
    assert float(np.max(np.abs(psi.numpy() - p))) / float(p.max() - p.min()) <= 1e-9
    assert float(np.max(np.abs(obj.numpy() - jobj))) <= 1e-9 * float(np.max(np.abs(jobj)))
