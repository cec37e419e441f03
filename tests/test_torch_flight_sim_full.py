"""Port parity: the physics-in-the-loop flight simulator
(``control/flight_sim.run_shot_full``).

The bench machine at 33^2 under the multigrid Picard solver
(``tests/test_fixed_boundary.make_cfg``), three control ticks in float64 in
the normalised units of ``tests/test_control.py`` (delta limit 0.2, target
R 6.0 m): the final psi within 1e-9 of its span, the currents and every
trace within 1e-9, and the Picard count of each of the four solves (the
initial one and one a tick) equal.  Each package's counts are read by
wrapping its ``solve_fixed_boundary_impl`` where the flight simulator looks
it up (JAX's through an ordered ``jax.debug.callback``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch_parity import as_np, span_rel

import scpn_fusion_tpu.models.equilibrium.fixed_boundary as jfb
from scpn_fusion_tpu.control import flight_sim as jf
from scpn_fusion_tpu_torch import interop
from scpn_fusion_tpu_torch.control import flight_sim as tf
from tests.test_fixed_boundary import make_cfg

TOL = 1e-9
SHOT = dict(shot_steps=3, actuator_delta_limit=0.2, target_r=6.0, target_z=0.0)


def test_full_shot_33_three_ticks(monkeypatch):
    cfg = make_cfg("multigrid", n=33)
    j_counts, t_counts = [], []
    j_solve, t_solve = jfb.solve_fixed_boundary_impl, tf.solve_fixed_boundary_impl

    def j_counted(*args, **kw):
        eq = j_solve(*args, **kw)
        jax.debug.callback(lambda it: j_counts.append(int(it)), eq.iterations, ordered=True)
        return eq

    def t_counted(*args, **kw):
        eq = t_solve(*args, **kw)
        t_counts.append(eq.iterations)
        return eq

    monkeypatch.setattr(jfb, "solve_fixed_boundary_impl", j_counted)
    monkeypatch.setattr(tf, "solve_fixed_boundary_impl", t_counted)
    j_psi, j_cur, j_tr = jf.run_shot_full(cfg, dtype=jnp.float64, **SHOT)
    j_psi = np.asarray(j_psi)
    t_psi, t_cur, t_tr = tf.run_shot_full(interop.config_from_asdict(dataclasses.asdict(cfg)),
                                          dtype=torch.float64, device="cpu", **SHOT)
    assert len(t_counts) == 4 and t_counts == j_counts, (t_counts, j_counts)
    assert span_rel(t_psi, j_psi) <= TOL
    assert np.max(np.abs(as_np(t_cur) - np.asarray(j_cur))) <= TOL * np.max(np.abs(j_cur))
    for name in j_tr._fields:
        ref, ours = np.asarray(getattr(j_tr, name)), getattr(t_tr, name)
        if name == "converged":
            assert ours.tolist() == ref.tolist() and all(ref)
        else:
            scale = max(float(np.max(np.abs(ref))), 1.0)
            assert float(np.max(np.abs(as_np(ours) - ref))) <= TOL * scale, name
