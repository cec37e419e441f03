"""Port parity: closed-loop free-boundary shape tracking
(``control/free_boundary_tracking.py``).

The machine of ``validation/run_tracking_acceptance.py:44-70`` at 17^2 in
float64 (six coils, Ip 150, multigrid inner solves), targets a seeded step
from the initial objectives, a one-tick measurement latency, a sensor bias
and probe noise: three ticks of plant solve -> synthetic magnetics ->
reconstruction -> observer -> bounded LSQ -> supervisor.  JAX draws the
probe noise with threefry keys; the port's private shot function is fed
JAX's own draws (``split(PRNGKey(seed), n_steps)``, one ``normal`` a tick).
Every trace within 1e-9 of JAX's, the alert levels equal.  The default
flux-loop ellipse, the supervisor ladder and the objectives are held to JAX
on their own.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np, rng

from scpn_fusion_tpu.control import free_boundary_tracking as jt
from scpn_fusion_tpu.core.config import config_from_dict
from scpn_fusion_tpu.core.grid import Grid as JGrid
from scpn_fusion_tpu.models.equilibrium.free_boundary import coilset_from_config as j_coils
from scpn_fusion_tpu_torch import interop
from scpn_fusion_tpu_torch.bench_config import TRACKING_MACHINE, TRACKING_STEP
from scpn_fusion_tpu_torch.control import free_boundary_tracking as tt
from scpn_fusion_tpu_torch.core.grid import Grid as TGrid
from scpn_fusion_tpu_torch.models.equilibrium.free_boundary import coilset_from_config as t_coils

TOL = 1e-9
N = 17
TCFG = dict(probe_noise_sigma=2e-3, latency_steps=1, sensor_bias=(0.01, -0.01, 0.0, 0.0))


def _cfg():
    """The JAX package's config of ``bench_config.TRACKING_MACHINE`` at N^2."""
    return config_from_dict({**TRACKING_MACHINE, "grid_resolution": [N, N]})


def _close(ours, ref, what):
    a, b = as_np(ours), np.asarray(ref, np.float64)
    assert a.shape == b.shape, what
    assert float(np.max(np.abs(a - b))) <= TOL * max(float(np.max(np.abs(b))), 1.0), what


def test_tracking_shot_matches_jax():
    cfg = _cfg()
    tcfg_port = interop.config_from_asdict(dataclasses.asdict(cfg))
    j_grid = JGrid.from_config(cfg, dtype=np.float64)
    t_grid = TGrid.from_config(tcfg_port, dtype=torch.float64, device="cpu")
    jc, tc = j_coils(cfg, jnp.float64), t_coils(tcfg_port, torch.float64, "cpu")
    obj0 = jt.soft_objectives(jt._plant_solve(jc, cfg, j_grid, False), j_grid)
    targets = np.asarray(obj0) + np.asarray(TRACKING_STEP)
    n_steps, seed = 3, 5
    ref = jt.run_tracking_shot(cfg, jc, jnp.asarray(targets), grid=j_grid, dtype=jnp.float64,
                               tcfg=jt.TrackingConfig(**TCFG), n_steps=n_steps, seed=seed)
    flux = tt.default_flux_loops(t_grid)
    dirs = torch.tensor([0, 1], dtype=torch.int32).repeat(8)
    keys = jax.random.split(jax.random.PRNGKey(seed), n_steps)
    noise = torch.tensor(np.stack([np.asarray(jax.random.normal(k, (32,), jnp.float64))
                                   for k in keys]))
    ours = tt._run_tracking_shot(tc, torch.tensor(targets), tc.currents, flux, flux, dirs, noise,
                                 cfg=tcfg_port, grid=t_grid, tcfg=tt.TrackingConfig(**TCFG),
                                 n_steps=n_steps)
    for name in ref._fields:
        if name == "alert_level":
            assert getattr(ours, name).tolist() == np.asarray(ref.alert_level).tolist()
        else:
            _close(getattr(ours, name), getattr(ref, name), name)
    assert float(ours.axis_error[-1]) < float(ours.axis_error[0])


def test_default_flux_loops_match_jax():
    th = jnp.linspace(0.0, 2.0 * jnp.pi, 17, dtype=jnp.float64)[:-1]
    ref = jnp.stack([6.0 + 0.47 * 8.0 * jnp.cos(th), 0.42 * 8.0 * jnp.sin(th)], axis=1)
    grid = TGrid.from_bounds(N, N, 2.0, 10.0, -4.0, 4.0, dtype=torch.float64, device="cpu")
    _close(tt.default_flux_loops(grid), ref, "flux loops")


@pytest.mark.parametrize("seed", range(4))
def test_supervisor_and_objectives_match_jax(seed):
    g = rng(seed)
    sup = jt.SupervisorConfig()
    js, ts = jt.supervisor_init(), tt.supervisor_init("cpu")
    currents, fallback = g.uniform(-30, 30, 6), g.uniform(-5, 5, 6)
    for _ in range(8):
        delta = g.normal(0.0, 1.5, 6)
        errs = g.uniform(0.0, 0.15, 3)
        js, jd = jt.supervisor_step(sup, js, jnp.asarray(delta), jnp.asarray(currents),
                                    jnp.asarray(fallback), *map(jnp.asarray, errs))
        ts, td = tt.supervisor_step(tt.SupervisorConfig(), ts, torch.tensor(delta),
                                    torch.tensor(currents), torch.tensor(fallback),
                                    *map(torch.tensor, errs))
        _close(td, jd, "delta")
        assert (int(ts.level), int(ts.hold)) == (int(js.level), int(js.hold))
        currents = currents + np.asarray(jd)
    if torch.cuda.is_available():
        assert tt.supervisor_init().level.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            tt.supervisor_init()       # the card by default, no fall-back to the CPU
    psi = g.standard_normal((N, N)).cumsum(0).cumsum(1)
    j_grid = JGrid.from_config(_cfg(), dtype=np.float64)
    t_grid = TGrid.from_bounds(N, N, 2.0, 10.0, -4.0, 4.0, dtype=torch.float64, device="cpu")
    _close(tt.soft_objectives(torch.tensor(psi), t_grid),
           jt.soft_objectives(jnp.asarray(psi), j_grid), "objectives")
