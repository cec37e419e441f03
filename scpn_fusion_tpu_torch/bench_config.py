"""The bench configurations: the 6-coil ITER-like machine of ``bench.py``,
the same machine under the free-boundary forward's solver, and the
DIII-D-like machine on a rectangular grid.

``ITER_LIKE`` is the normalised machine (R in (2, 10) m, Z in (-4, 4) m,
Ip 15, mu0 = 1) in the JSON-shaped layout that ``config_from_dict`` reads,
so the same mapping can also be handed to the JAX package's own
``config_from_dict``.  ``BENCH_SOLVER`` is the bench's solver: Anderson
multigrid-Picard, depth 4, relaxation 1.0, (1,2) smoothing.  With
``gs_residual_threshold=3e-5`` it is the resolution-scaling configuration of
``validation/run_resolution_scaling.py:97-111, 208``: the same machine and
solver, converged on the f64 GS residual as well (the 2049^2 mixed-precision
solve).

``FREE_BOUNDARY_SOLVER`` is the solver of the free-boundary forward
(``validation/run_free_boundary_forward.py:61-88``), which
:func:`free_boundary_config` puts on the ITER-like machine.

``DIII_D_LIKE`` is ``validation/configs/diiid_config.json`` (R in (0.9, 2.6)
m, Z in (-1.5, 1.5) m, five coils of 58 turns, Ip 1.2, L-mode) normalised as
``ITER_LIKE`` is (mu0 = 1: with the physical mu0 the flux spans ~1e-4, and an
absolute 1e-4 update tolerance is met by the first iteration).  Its update
tolerance is 2e-3: psi spans ~70 here, so the bench's 1e-4 is 1.4e-6 of the
span, where float32 rounding decides at which iteration the mean update
crosses it (the kernels and the plain float32 ops then differ by two
iterations); the mean update falls tenfold an iteration, and 2e-3 lies a
factor 2 or more from every iteration's in float32 and float64 alike.
:func:`rect_config` puts it on the tall grid (NR, NZ) = (129, 257), whose
spacing is nearly isotropic (1.7 m / 128, 3 m / 256), with ``BENCH_SOLVER``:
a grid that is not a square 2^k+1, so every level of its V-cycle smooths
through ``sor_sweeps``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np

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


def bench_config(n: int = 513, *, use_pallas: bool = True,
                 gs_residual_threshold: float = 0.0) -> ReactorConfig:
    """The bench configuration at ``n`` x ``n``; ``use_pallas`` selects the
    hand-written kernels (on a CUDA device in float32), and a
    ``gs_residual_threshold`` > 0 adds the GS-residual convergence gate."""
    return config_from_dict(config_dict(n, **BENCH_SOLVER, use_pallas=use_pallas,
                                        gs_residual_threshold=gs_residual_threshold))


FREE_BOUNDARY_SOLVER: dict[str, Any] = {
    "max_iterations": 400, "convergence_threshold": 1e-4, "relaxation_factor": 1.0,
    "solver_method": "anderson_mg", "anderson_depth": 4}
FREE_BOUNDARY_MU0_GREEN = 1.0   # the coils' Green's functions in the machine's normalised units


def free_boundary_config(n: int = 129, *, use_pallas: bool = True) -> ReactorConfig:
    """The ITER-like machine at ``n`` x ``n`` with the free-boundary
    forward's solver (inner Picard: ``anderson_mg``, depth 4, relaxation 1.0,
    update tolerance 1e-4, at most 400 iterations), to be solved with
    ``solve_free_boundary(..., mu0_green=FREE_BOUNDARY_MU0_GREEN)``.

    The outer controls are arguments of ``solve_free_boundary``, as the
    validation sets them: at 129^2 ``max_outer_iter=16`` with ``tol=2.5e-4``
    in float32 (the float32 fixed point is a limit cycle of ~25 ulps of
    psi_axis, ~1e-4, which 1e-4 would sit on) and ``tol=1e-4`` in float64
    with ``anderson_gram_f32=True``; at 257^2 ``max_outer_iter=40`` with
    ``tol=3e-4``.  ``use_pallas`` selects the hand-written kernels (on a
    CUDA device in float32, or inside the float32 V-cycle of the mixed
    solve)."""
    return config_from_dict(config_dict(n, **FREE_BOUNDARY_SOLVER, use_pallas=use_pallas))


DIII_D_LIKE: dict[str, Any] = {
    "reactor_name": "DIII-D-like-normalised",
    "dimensions": {"R_min": 0.9, "R_max": 2.6, "Z_min": -1.5, "Z_max": 1.5},
    "coils": [{"name": name, "r": r, "z": z, "current": i, "turns": 58} for name, r, z, i in (
        ("F1A", 1.0, 1.3, -0.2), ("F2A", 2.2, 1.2, 0.6), ("F3", 2.9, 0.0, 0.9),
        ("F2B", 2.2, -1.2, 0.6), ("F1B", 1.0, -1.3, -0.2))],
    "physics": {"plasma_current_target": 1.2, "vacuum_permeability": 1.0,
                "profiles": {"mode": "l-mode"}},
    "solver": {"max_iterations": 600, "convergence_threshold": 2e-3},
}
RECT_GRID = (129, 257)   # (NR, NZ): psi is 257 x 129


def rect_config_dict(grid: tuple[int, int] = RECT_GRID, **solver: Any) -> dict[str, Any]:
    """``DIII_D_LIKE`` on an (NR, NZ) ``grid`` with ``BENCH_SOLVER``, with
    ``solver`` fields set."""
    return {**DIII_D_LIKE, "grid_resolution": list(grid),
            "solver": {**DIII_D_LIKE["solver"], **BENCH_SOLVER, **solver}}


def rect_config(grid: tuple[int, int] = RECT_GRID, *, use_pallas: bool = True) -> ReactorConfig:
    """The DIII-D-like machine on the rectangular ``grid`` (NR, NZ) with the
    bench solver; ``use_pallas`` selects the hand-written kernels."""
    return config_from_dict(rect_config_dict(grid, use_pallas=use_pallas))


# ── the ensembles and sharded solves of parallel/ ──

AMORTISATION_SOLVER: dict[str, Any] = {
    "max_iterations": 200, "convergence_threshold": 1e-4, "relaxation_factor": 1.0,
    "solver_method": "anderson_mg", "anderson_depth": 4, "inner_sweeps": 1}
AMORTISATION_SEED = 5
AMORTISATION_BATCHES = (1, 16, 64, 256)


def amortisation_config(n: int = 129, *, use_pallas: bool = True) -> ReactorConfig:
    """The ensemble lane's configuration (``validation/run_batched_amortisation.py``
    ``_make_cfg``): the ITER-like machine at ``n`` x ``n``, ``anderson_mg``,
    depth 4, relaxation 1.0, (3,3) smoothing, at most 200 iterations."""
    return config_from_dict(config_dict(n, **AMORTISATION_SOLVER, use_pallas=use_pallas))


def amortisation_draws(n_coils: int = 6, batches=AMORTISATION_BATCHES) -> dict:
    """The validation's ensemble inputs, drawn in its order from one
    ``default_rng(AMORTISATION_SEED)``: the coil currents of element b are
    the machine's times ``1 + 0.05 x`` in float32 (x standard normal), every
    target current 15.  Keys: ``"parity"`` (lane 1's 16), each B of
    ``batches`` (lanes 2-3; :data:`AMORTISATION_BATCHES` by default),
    ``("mixed", 16)`` and ``("mixed", 64)`` (lane 4); values (currents (B,
    n_coils), targets (B,)) as float32 numpy arrays."""
    rng = np.random.default_rng(AMORTISATION_SEED)
    base = np.asarray([c["current"] for c in ITER_LIKE["coils"]], np.float32)

    def draw(b):
        pert = np.float32(1.0) + np.float32(0.05) * rng.standard_normal((b, n_coils)).astype(
            np.float32)
        return base[None, :] * pert, np.full((b,), 15.0, np.float32)

    out = {"parity": draw(16)}
    for b in batches:
        out[b] = draw(b)
    for b in (16, 64):
        out[("mixed", b)] = draw(b)
    return out


SHARDED_SOLVER: dict[str, Any] = {
    "max_iterations": 600, "convergence_threshold": 1e-4, "relaxation_factor": 0.8,
    "solver_method": "anderson_mg", "anderson_depth": 4, "inner_sweeps": 1}


def sharded_config(n: int = 513) -> ReactorConfig:
    """``validation/run_sharded_convergence.py``'s headline configuration:
    the ITER-like machine at ``n`` x ``n``, ``anderson_mg``, depth 4,
    relaxation 0.8, at most 600 iterations."""
    return config_from_dict(config_dict(n, **SHARDED_SOLVER))


# ── transport (1.5D stepper, the GS <-> transport coupling, the small lanes) ──
#
# TORAX_COARSE is the coarse tier of ``validation/run_torax_parity.py:37-39,
# 76-81``: the default ``TransportParams()`` (nr 50, multi-ion) in float64,
# dt 0.5 s, 50 MW, 400 steps (t = 200 s); ``limit_cycle`` is that script's
# period-2 test of the core Ti trace.  COUPLED is
# ``examples/10_integrated_scenario.py:70-78`` at full width: the bench machine
# at 257^2 (``bench_config(257)``) with the default transport (nr 50), 30 MW,
# dt 0.02 s, 10 transport steps an outer iteration, at most 6 outer
# iterations, psi tolerance 1e-3.
TORAX_COARSE: dict[str, Any] = {"dt": 0.5, "p_aux_mw": 50.0, "n_steps": 400}
COUPLED: dict[str, Any] = {"n": 257, "p_aux_mw": 30.0, "dt": 0.02, "n_inner": 10,
                           "n_outer": 6, "psi_tol": 1e-3}


def limit_cycle(ti_core) -> bool:
    """``run_torax_parity.py:82-95``: the last 8 core Ti values swing by more
    than 2 keV while every other one repeats within 0.5 keV."""
    tail = np.asarray(ti_core, np.float64)[-8:]
    swings = np.abs(np.diff(tail))
    period2 = np.abs(tail[2:] - tail[:-2])
    return bool(np.max(swings) > 2.0 and np.median(period2) < 0.5)


def lane_profiles(nr: int = 50, seed: int = 9) -> dict[str, Any]:
    """Seeded ITER-like radial profiles (numpy, float64) for the small
    transport lanes: rho, Te / Ti [keV], ne [1e19 m^-3], q, s_hat, a chi_i
    [m^2/s], an impurity diffusivity and a current-drive source."""
    g = np.random.default_rng(seed)
    rho = np.linspace(0.0, 1.0, nr)
    shape = 1.0 - rho**2
    te = 0.1 + 12.0 * shape**1.5 * (1.0 + 0.02 * g.random(nr))
    return {
        "rho": rho, "te_kev": te, "ti_kev": 0.9 * te + 0.05,
        "ne_19": 1.0 + 9.0 * np.sqrt(shape) * (1.0 + 0.02 * g.random(nr)),
        "q": 1.0 + 2.5 * rho**2, "s_hat": 5.0 * rho**2 / (1.0 + 2.5 * rho**2),
        "chi_i": 0.5 + 1.5 * rho**2 + 0.1 * g.random(nr),
        "d_imp": 0.3 + 0.7 * rho**2,
        "j_source": 1e5 * np.exp(-((rho - 0.4) / 0.15) ** 2),
    }


def aurora_case_arrays(nr: int = 24, nz: int = 5, nt: int = 6, seed: int = 10) -> dict[str, Any]:
    """Fields of an ``AuroraParityCase`` (neon, 0.05-0.6 m, 50 ms) with
    seeded diffusion, pinch and rate tables, and a seeded reference
    trajectory (nt, nr, Z+1) for the effective-source closure."""
    g = np.random.default_rng(seed)
    radius = np.linspace(0.05, 0.6, nr)
    prof = np.exp(-((radius - 0.3) / 0.08) ** 2)
    start = np.tile(prof[:, None], (1, nz)) * (1.0 + np.arange(nz)) * 1e16
    ref = start[None] * (1.0 + 0.05 * g.random((nt, nr, nz)))
    return {
        "fields": dict(
            element="Ne", charge_states=np.arange(nz, dtype=float), radius_m=radius,
            time_s=np.linspace(0.0, 0.05, nt), major_radius_m=1.65,
            ne_t_r=3e19 * (1.0 + 0.1 * g.random((nt, nr))),
            diffusion_m2_s_r_z=0.5 + g.random((nr, nz)),
            convection_m_s_r_z=-2.0 * g.random((nr, nz)) * radius[:, None] / 0.6,
            ionisation_m3_s_t_r_z=1e-15 * (0.5 + g.random((nt, nr, nz))),
            recombination_m3_s_t_r_z=5e-16 * (0.5 + g.random((nt, nr, nz)))),
        "density": start, "reference": ref,
    }


# ── control (the flight simulator's full lane, the SCPN closed loop, the
# tracking shot) ──
#
# FLIGHT_FULL is the full-physics lane of ``run_shot_full`` on the bench
# machine (``bench_config(513)``) in the normalised units of
# ``tests/test_control.py:126-133``: the default 30 ticks of 0.05 s, a coil
# delta limit of 0.2 and target axis (6.0, 0.0) m.  The R/Z controller is
# ``validation/run_control_latency.py:23-42``: eight places, four transitions
# (threshold 0.02), targets (6.2, 0) m, scales 0.5, two actions (gain 0.5,
# limit 5, slew 1e4 /s); CLOSED_LOOP is that script's fused lane (fractional
# firing, margin 0.5, dt 1e-3 s, plant from (6.5, 0.3) m, 10,000 ticks).
# TRACKING_MACHINE is ``validation/run_tracking_acceptance.py:44-70`` (33^2,
# six coils, Ip 150, mu0 = 1, multigrid inner solves) and TRACKING_STEP the
# target step of its lanes.
FLIGHT_FULL: dict[str, Any] = {"n": 513, "actuator_delta_limit": 0.2, "target_r": 6.0,
                               "target_z": 0.0}
RZ_PLACES = ("eR+", "eR-", "eZ+", "eZ-", "cR+", "cR-", "cZ+", "cZ-")
RZ_TRANSITIONS = (("tR+", "eR+", "cR+"), ("tR-", "eR-", "cR-"),
                  ("tZ+", "eZ+", "cZ+"), ("tZ-", "eZ-", "cZ-"))
RZ_SPECS: dict[str, Any] = dict(
    axis_targets=[6.2, 0.0], axis_scales=[0.5, 0.5],
    injections=[("eR+", 0, True, 1.0, 0.0), ("eR-", 0, False, 1.0, 0.0),
                ("eZ+", 1, True, 1.0, 0.0), ("eZ-", 1, False, 1.0, 0.0)],
    actions=[("cR+", "cR-", 0.5, 5.0, 1e4), ("cZ+", "cZ-", 0.5, 5.0, 1e4)])
CLOSED_LOOP: dict[str, Any] = {"firing_margin": 0.5, "dt": 1e-3, "plant0": (6.5, 0.3),
                               "n_ticks": 10_000}
TRACKING_MACHINE: dict[str, Any] = {
    "reactor_name": "tracking-acceptance", "grid_resolution": [33, 33],
    "dimensions": ITER_LIKE["dimensions"],
    "coils": [{"r": r, "z": z, "current": i} for r, z, i in (
        (3.5, 4.8, -1.0), (8.0, 4.8, 4.0), (10.8, 0.0, 6.0),
        (8.0, -4.8, 4.0), (3.5, -4.8, -1.0), (10.8, 2.5, 3.0))],
    "physics": {"plasma_current_target": 150.0, "vacuum_permeability": 1.0},
    "solver": {"max_iterations": 80, "convergence_threshold": 1e-4, "relaxation_factor": 0.1,
               "solver_method": "multigrid"}}
TRACKING_STEP = (-0.05, 0.04, 0.0, 0.0)


def rz_net(net_cls, delays: tuple[int, ...] = (0, 0, 0, 0)):
    """The compiled R/Z net, built with ``net_cls`` (a ``StochasticPetriNet``
    of either package); ``delays`` are the four transitions' tick delays."""
    net = net_cls()
    for p in RZ_PLACES:
        net.add_place(p)
    for (t, src, dst), delay in zip(RZ_TRANSITIONS, delays):
        net.add_transition(t, threshold=0.02, delay_ticks=delay)
        net.add_arc(src, t)
        net.add_arc(t, dst)
    return net.compile()


# ── vertical stability (control/vessel_rzip.py) ──
#
# RZIP_VESSEL is the vessel of ``tests/test_vessel_rzip.py:_make_vessel``
# with its coils: eight wall filaments evenly spaced on an ellipse about
# R = 7.5 m (half-axes 2.8 m in R, 3.2 m in Z), 5e-4 Ohm each and the loop
# self-inductance mu0 R (ln(8R/a) - 2) of a 5 cm conductor, then two active
# coils at (9.5, +-2.0) m, 1e-3 Ohm, 20 times that inductance.
RZIP_VESSEL: dict[str, Any] = {"n_wall": 8, "r0": 7.5, "half_r": 2.8, "half_z": 3.2,
                               "wall_ohm": 5e-4, "conductor_m": 0.05,
                               "coils": ((9.5, 2.0), (9.5, -2.0)), "coil_ohm": 1e-3,
                               "coil_l_factor": 20.0}


def rzip_vessel_arrays() -> dict[str, np.ndarray]:
    """``RZIP_VESSEL`` as float64 arrays r, z, resistance, inductance (wall
    filaments first), computed as the test's fixture computes them."""
    v = RZIP_VESSEL
    n = v["n_wall"]
    theta = np.linspace(0, 2 * np.pi, n, endpoint=False)
    r = v["r0"] + v["half_r"] * np.cos(theta)
    z = v["half_z"] * np.sin(theta)
    resistance = np.full(n, v["wall_ohm"])
    inductance = 4e-7 * np.pi * r * (np.log(8.0 * r / v["conductor_m"]) - 2.0)
    coil_r = [c[0] for c in v["coils"]]
    l_coil = [4e-7 * np.pi * rc * (np.log(8.0 * rc / v["conductor_m"]) - 2.0)
              * v["coil_l_factor"] for rc in coil_r]
    return {"r": np.concatenate([r, coil_r]),
            "z": np.concatenate([z, [c[1] for c in v["coils"]]]),
            "resistance": np.concatenate([resistance, [v["coil_ohm"]] * len(coil_r)]),
            "inductance": np.concatenate([inductance, l_coil])}


# ── the learned controllers' validation cohorts ──
#
# ``ladder_cohort`` is ``_synthetic_cohort`` of validation/run_control_ladder.py
# (the recall / FPR lane: 24 training shots and 16 held-out shots of 200
# ticks) and ``roc_cohort`` is ``_cohort`` of validation/run_disruption_roc.py
# (the separable ROC lane: 32 training shots and 48 held-out shots of 240
# ticks), carried over as they are (numpy only).

LADDER_COHORTS = {"train": (24, 200, 0), "test": (16, 200, 1234)}   # (shots, ticks, seed)
ROC_COHORTS = {"train": (32, 240, 7), "test": (48, 240, 991)}
ROC_MODES = ("ntm", "density_limit", "vde")


def ladder_cohort(n_shots: int, t_len: int, seed: int):
    """Disruptive shots carry an oscillating precursor + drift over the
    final ~40 ticks (the synthetic-archive shape the test suite and the
    reference's empirical campaign both use)."""
    rng = np.random.default_rng(seed)
    shots = rng.standard_normal((n_shots, t_len, 3)).astype(np.float32) * 0.1
    labels = (np.arange(n_shots) % 2 == 0).astype(np.float32)
    t = np.arange(t_len)
    for i in range(n_shots):
        if labels[i] > 0:
            onset = t_len - 40
            grow = np.maximum(0, t - onset) / 40.0
            shots[i, :, 0] += 2.0 * grow * np.sin(0.8 * t)
            shots[i, :, 1] += 1.5 * grow
    return shots, labels


def roc_cohort(n_shots: int, t_len: int, seed: int):
    """Balanced cohort; disruptive shots get one of three precursor modes
    with randomised onset and amplitude (reference
    ``disruption_roc_analysis.py:generate_scenario_batch``)."""
    MODES = ROC_MODES
    rng = np.random.default_rng(seed)
    shots = rng.standard_normal((n_shots, t_len, 3)).astype(np.float32) * 0.4
    labels = (np.arange(n_shots) % 2 == 0).astype(np.float32)
    onsets = np.full(n_shots, -1, dtype=np.int64)
    modes = []
    for i in range(n_shots):
        if labels[i] < 0.5:
            modes.append("safe")
            continue
        mode = MODES[int(rng.integers(len(MODES)))]
        modes.append(mode)
        onset = int(rng.integers(t_len // 3, 2 * t_len // 3))
        onsets[i] = onset
        amp = float(rng.uniform(0.8, 2.0))
        t = np.arange(t_len - onset, dtype=np.float32)
        grow = 1.0 - np.exp(-t / 40.0)
        if mode == "ntm":                       # rotating island: n=1 osc
            shots[i, onset:, 0] += amp * grow * np.sin(0.8 * t)
        elif mode == "density_limit":           # monotone density drift
            shots[i, onset:, 1] += amp * grow
        else:                                   # vde: radial spread ramp
            shots[i, onset:, 2] += amp * grow * (1.0 + 0.3 * np.sin(0.2 * t))
    return shots, labels, onsets, modes


# ── the nonlinear gyrokinetic run (models/gyrokinetics/nonlinear.py) ──
# The default configuration is NonlinearGKConfig() itself (2 x 16 x 16 x 32 x
# 16 x 8, complex64, 200 steps).  The 32^3 spec is the 32 x 32 x 16 x 16 x 8
# complex128 run of validation/run_sharded_convergence.py:350-354 (nonlinear,
# collisions, save interval half the steps); the linear ITG lane is
# validation/run_gk_scenario.py:78-90 (amplitude 1e-6, seed 3, gate
# phi_rms[-1] / phi_rms[0] > 1); the variant runs every optional term at 8^4 x 4.
GK_SPEC_32 = dict(n_kx=32, n_ky=32, n_theta=16, n_vpar=16, n_mu=8, n_steps=50,
                  save_interval=25, nonlinear=True, collisions=True, dtype="complex128")
GK_SPEC_32_SEED = 5
GK_LINEAR_ITG = dict(n_kx=8, n_ky=8, n_theta=8, n_vpar=8, n_mu=4, n_steps=60,
                     save_interval=10, dt=0.05, dtype="complex64", nonlinear=False,
                     collisions=False, hyper_coeff=0.0, r_l_ti=9.0, cfl_adapt=False)
GK_LINEAR_ITG_RUN = dict(amplitude=1e-6, seed=3)
GK_VARIANT = dict(n_kx=8, n_ky=8, n_theta=8, n_vpar=8, n_mu=4, n_steps=20, save_interval=5,
                  dt=0.02, dtype="complex128", kinetic_electrons=True, electromagnetic=True,
                  collision_model="conservative", zonal_damping_rate=0.05)
# the Miller geometry of the variant: a shaped surface (kappa 1.6, delta 0.3)
GK_VARIANT_MILLER = dict(kappa=1.6, delta=0.3, s_kappa=0.1, s_delta=0.2, n_theta=8,
                         n_period=1)
# The linear ITG lane's initial f as the JAX package draws it (jax.random,
# seed 3: jnl.init_state(NonlinearGKConfig(**GK_LINEAR_ITG), grids,
# amplitude=1e-6, seed=3).f, complex64; a test holds the file to it).  The
# lane's gate depends on the draw -- JAX's own draws miss it at seeds 4-7 --
# so the port's run of the validation lane starts from the validation's draw.
GK_LINEAR_ITG_JAX_F0 = Path(__file__).resolve().parent / "data" / "gk_linear_itg_jax_f0.npy"
# The drift-wave drive test's noise as the JAX package draws it
# (tests/test_drift_wave_esn.py:52-55: drift_wave.initial_state(PRNGKey(2),
# DriftWaveConfig(n=64)): the two standard-normal (64, 64) float32 fields of
# the split key, phi's then n's; a test holds the file to them).  The test's
# gate (probe variance at kappa 2 above twice that at kappa 0) depends on the
# draw -- JAX's own draws miss it at keys 0, 1, 3 and 4 -- so the port's run
# of that lane starts from the test's draw.
DRIFT_WAVE_JAX_NOISE = Path(__file__).resolve().parent / "data" / "drift_wave_jax_noise_key2.npy"
# The ESN sine lane's reservoir as the JAX package draws it
# (tests/test_drift_wave_esn.py:90-100: esn.init_esn(PRNGKey(5), input_dim=2,
# reservoir_size=300), float32): ``w_in`` and the masked reservoir ``w *
# (mask < 0.1)`` before its spectral-radius scaling; a test holds the file to
# them.  The test's gate (a closed-loop horizon above 50 of 100 steps)
# depends on the draw -- JAX's own keys 1, 3, 4, 8, 11, 14, 16, 17 and 18
# miss it -- so the port's run of that lane starts from the test's draw.
ESN_SINE_JAX_INIT = Path(__file__).resolve().parent / "data" / "esn_sine_jax_init_key5.npz"
