"""The bench configuration: the 6-coil ITER-like machine of ``bench.py``.

``ITER_LIKE`` is the normalised machine (R in (2, 10) m, Z in (-4, 4) m,
Ip 15, mu0 = 1) in the JSON-shaped layout that ``config_from_dict`` reads,
so the same mapping can also be handed to the JAX package's own
``config_from_dict``.  ``BENCH_SOLVER`` is the bench's solver: Anderson
multigrid-Picard, depth 4, relaxation 1.0, (1,2) smoothing.
"""

from __future__ import annotations

from typing import Any

from scpn_fusion_tpu_torch.core.config import ReactorConfig, config_from_dict

ITER_LIKE: dict[str, Any] = {
    "reactor_name": "ITER-like-normalised",
    "dimensions": {"R_min": 2.0, "R_max": 10.0, "Z_min": -4.0, "Z_max": 4.0},
    "coils": [{"r": r, "z": z, "current": i} for r, z, i in (
        (3.5, 4.8, -1.0), (8.0, 4.8, 4.0), (10.8, 0.0, 6.0),
        (8.0, -4.8, 4.0), (3.5, -4.8, -1.0), (10.8, 2.5, 3.0))],
    "physics": {"plasma_current_target": 15.0, "vacuum_permeability": 1.0},
    "solver": {"max_iterations": 600, "convergence_threshold": 1e-4},
}
BENCH_SOLVER: dict[str, Any] = {"relaxation_factor": 1.0, "solver_method": "anderson_mg",
                                "anderson_depth": 4, "mg_pre_smooth": 1, "mg_post_smooth": 2}


def config_dict(n: int, **solver: Any) -> dict[str, Any]:
    """``ITER_LIKE`` on an ``n`` x ``n`` grid, with ``solver`` fields set."""
    return {**ITER_LIKE, "grid_resolution": [n, n],
            "solver": {**ITER_LIKE["solver"], **solver}}


def bench_config(n: int = 513, *, use_pallas: bool = True) -> ReactorConfig:
    """The bench configuration at ``n`` x ``n``; ``use_pallas`` selects the
    hand-written kernels (on a CUDA device in float32)."""
    return config_from_dict(config_dict(n, **BENCH_SOLVER, use_pallas=use_pallas))
