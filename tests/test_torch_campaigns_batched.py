"""The port's ``batched_amortisation`` campaign on the CPU.

The committed ``validation/reports/batched_amortisation.json`` was made on
the TPU, so the port's CPU run is held to the JAX script's CPU branch: the
lane names, thresholds and notes, lane 4 (the mixed batches) blocked with
the script's note, and lanes 2 and 3 following their own numbers and gates
(times on the host's clock).  The campaign runs at 33^2 with B = 1, 4, 8
here (the script's 129^2 and B = 1, 16, 64, 256 are its defaults, the
card's).  Lane 1's arithmetic is held to JAX's ``solve_equilibrium_batch``
in float64 at 33^2 on the script's 16 draws: each element's iterations
equal, psi within 1e-9 of its span.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

from scpn_fusion_tpu_torch.bench_config import amortisation_config, amortisation_draws
from scpn_fusion_tpu_torch.validation import run_batched_amortisation as ba
from scpn_fusion_tpu_torch.validation._lanes import NO_CARD
from tests.torch_parity import layout_mismatches

ROOT = Path(__file__).resolve().parent.parent
COMMITTED = ROOT / "validation" / "reports" / "batched_amortisation.json"
BATCHES = (1, 4, 8)


def test_cpu_run_layout_and_statuses(tmp_path):
    assert ba.main(device="cpu", out_dir=tmp_path, n=33, batches=BATCHES) in (0, 1)
    ours = json.loads((tmp_path / "batched_amortisation.json").read_text())
    ref = json.loads(COMMITTED.read_text())
    lanes = {lane["name"]: lane for lane in ours["lanes"]}
    m1, m2, m3 = (lanes[k]["metrics"] for k in ("batched_element_parity",
                                                 "batched_amortisation", "warm_cold_compile"))
    assert lanes["batched_element_parity"]["status"] == "pass"
    assert (m1["backend"], m1["dtype"], m1["batch_all_converged"]) == ("cpu", "float32", True)
    assert m2["grid"] == "33x33"
    ratios = [m2[f"per_solve_ms_B{b}"] / m2["per_solve_ms_B1"] for b in BATCHES[1:]]
    assert lanes["batched_amortisation"]["status"] == (
        "pass" if all(r < 0.5 for r in ratios) else "fail")
    assert lanes["warm_cold_compile"]["status"] == (
        "pass" if m3["warm_cached_ms_B256"] < m3["cold_trace_compile_ms_B256"] else "fail")
    # the per-solve keys follow the batches: the script's at its defaults
    ref_m2 = ref["lanes"][1]["metrics"]
    for b in (16, 64, 256):
        ref_m2.pop(f"per_solve_ms_B{b}")
    for b in BATCHES[1:]:
        ref_m2[f"per_solve_ms_B{b}"] = None
    assert layout_mismatches(ours, ref, {"batched_mixed_amortisation": NO_CARD}) == {}


def test_parity_batch_against_jax():
    from scpn_fusion_tpu.core.config import config_from_dict
    from scpn_fusion_tpu.core.grid import Grid as JaxGrid
    from scpn_fusion_tpu.parallel.ensemble import solve_equilibrium_batch as jax_batch
    from scpn_fusion_tpu_torch.bench_config import AMORTISATION_SOLVER, config_dict
    from scpn_fusion_tpu_torch.core.grid import Grid
    from scpn_fusion_tpu_torch.parallel.ensemble import solve_equilibrium_batch

    cur, tgt = amortisation_draws()["parity"]
    cfg = amortisation_config(33)
    ours = solve_equilibrium_batch(cfg, Grid.from_config(cfg, dtype=torch.float64, device="cpu"),
                                   torch.from_numpy(cur).double(), torch.from_numpy(tgt).double())
    jcfg = config_from_dict(config_dict(33, **AMORTISATION_SOLVER))
    ref = jax_batch(jcfg, JaxGrid.from_config(jcfg, dtype=np.float64),
                    jnp.asarray(cur, jnp.float64), jnp.asarray(tgt, jnp.float64))
    psi_ref = np.asarray(ref[0])
    assert ours.iterations.tolist() == np.asarray(ref[2]).tolist()
    assert bool(ours.converged.all()) and bool(np.all(np.asarray(ref[1])))
    for b in range(16):
        span = float(psi_ref[b].max() - psi_ref[b].min())
        assert float(np.max(np.abs(ours.psi[b].numpy() - psi_ref[b]))) / span <= 1e-9, b
