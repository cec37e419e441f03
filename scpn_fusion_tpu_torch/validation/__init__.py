"""The port's validation campaigns, behind the CLI's ``validate`` and
``stellarator-replay`` modes.

Each module is the lanes of the JAX package's ``validation/run_<name>.py``
with the same gates, thresholds, lane names and report layout, run on the
port's modules (in float64 on ``device`` where the JAX script pins the CPU
in float64, which it does only because the TPU has none; where the script
switches on the TPU backend, the port switches on a CUDA ``device``: float32
through the hand-written kernels and the script's TPU gates).  Each has
``main(*, device="cuda", out_dir=REPORTS_DIR) -> int`` with its script's
exit rule.  Reports go to ``validation/reports_torch/`` of the checkout,
never to ``validation/reports/``, whose JSON files are the JAX package's
evidence; ``collect_results`` writes its ``RESULTS.md`` there too.
"""

from __future__ import annotations

import importlib
from pathlib import Path

REPORTS_DIR = Path(__file__).resolve().parents[2] / "validation" / "reports_torch"

# the ``validate --campaign`` values; campaign ``name`` is module ``run_<name>``
CAMPAIGNS = ("adjoint_fd", "batched_amortisation", "equilibrium_parity", "error_audit",
             "free_boundary_forward", "gk_eigenvalue_perf", "ida_stability",
             "implementation_parity", "io_roundtrip", "mesh_convergence", "multi_machine",
             "neg_triangularity", "precision_budget", "resolution_scaling", "scpn_replay",
             "sharded_convergence", "sharded_gs", "stellarator_lane", "tracking_acceptance",
             "transport_conservation")


def campaign_module(name: str):
    """The module of campaign ``name``, or None if the port has none."""
    if name not in CAMPAIGNS:
        return None
    return importlib.import_module(f"{__name__}.run_{name}")
