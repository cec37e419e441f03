"""Port parity: the digital twin (``control/digital_twin.py``), row D's
plain twin (``ops/cuda_twin.twin_shot_plain``) and the twin's IMAS history
through the carried-over ``io/imas_history.py``.

In float64 on the CPU the geometry, q-profile, MRE step and danger map, one
step from a seeded state and whole shots (32^2 x 300 steps uncontrolled,
48^2 x 200 steps under a seeded action trace) are within 1e-9 of JAX, and
the gates of ``tests/test_digital_twin.py:30-100`` hold.  The Laplacian
wraps as ``jnp.roll`` does: the mask holds (0, n/2), whose upward neighbour
is row n-1.  The IDS snapshots of the port's twin go through the copied
history converters as ``tests/test_imas_history.py`` drives them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np, rel, rng

from scpn_fusion_tpu.control import digital_twin as jdt
from scpn_fusion_tpu.io import imas_history as jih
from scpn_fusion_tpu_torch.control import digital_twin as tdt
from scpn_fusion_tpu_torch.io import imas_history as tih
from scpn_fusion_tpu_torch.ops import cuda_twin

TOL = 1e-9
F64 = torch.float64
CFG_J, CFG_T = jdt.TwinConfig(grid_size=32), tdt.TwinConfig(grid_size=32)


def _geometry(n=32):
    r_j, m_j = jdt._geometry(jdt.TwinConfig(grid_size=n), jnp.float64)
    r_t, m_t = tdt._geometry(tdt.TwinConfig(grid_size=n), F64, "cpu")
    return r_j, m_j, r_t, m_t


def test_geometry_and_operators_match_jax():
    r_j, m_j, r_t, m_t = _geometry()
    assert rel(r_t, r_j) <= 1e-15 and np.array_equal(m_t.numpy(), np.asarray(m_j))
    for a in (0.0, 1.0, -0.6):
        assert rel(tdt.q_map(CFG_T, r_t, torch.tensor(a, dtype=F64)),
                   jdt.q_map(CFG_J, r_j, jnp.float64(a))) <= 1e-15
    w = rng(1).uniform(0.0, 0.5, 4)
    assert rel(tdt.mre_step(CFG_T, torch.tensor(w)), jdt.mre_step(CFG_J, jnp.asarray(w))) <= 1e-15
    qm_t = tdt.q_map(CFG_T, r_t, torch.tensor(0.0, dtype=F64))
    qm_j = jdt.q_map(CFG_J, r_j, jnp.float64(0.0))
    for width in (0.05, 0.2):
        d_t = tdt.danger_map(CFG_T, qm_t, m_t, torch.full((4,), width, dtype=F64))
        d_j = jdt.danger_map(CFG_J, qm_j, m_j, jnp.full((4,), width, jnp.float64))
        assert np.array_equal(d_t.numpy(), np.asarray(d_j))


def test_one_step_from_a_seeded_state_matches_jax():
    r_j, m_j, r_t, m_t = _geometry()
    g = rng(2)
    t0, w0 = g.uniform(0.0, 50.0, (32, 32)) * np.asarray(m_j), g.uniform(0.01, 0.3, 4)
    s_j, out_j = jdt.twin_step(CFG_J, r_j, m_j, jdt.TwinState(jnp.asarray(t0), jnp.asarray(w0)),
                               jnp.float64(0.3))
    s_t, out_t = tdt.twin_step(CFG_T, r_t, m_t, tdt.TwinState(torch.tensor(t0), torch.tensor(w0)),
                               torch.tensor(0.3, dtype=F64))
    assert rel(s_t.t_field, s_j.t_field) <= TOL and rel(s_t.island_widths, s_j.island_widths) <= TOL
    for a, b in zip(out_t, out_j):
        assert rel(a, b) <= TOL


@pytest.mark.parametrize("n, steps, acted", [(32, 300, False), (48, 200, True)])
def test_shot_matches_jax(n, steps, acted):
    acts = rng(n).uniform(-1.0, 1.0, steps) if acted else None
    final_j, tr_j = jdt.run_digital_twin.__wrapped__(
        jdt.TwinConfig(grid_size=n), n_steps=steps, dtype=jnp.float64,
        actions=None if acts is None else jnp.asarray(acts))
    final_t, tr_t = tdt.run_digital_twin(
        tdt.TwinConfig(grid_size=n), n_steps=steps, dtype=F64, device="cpu",
        actions=None if acts is None else torch.tensor(acts))
    assert rel(final_t.t_field, final_j.t_field) <= TOL
    assert rel(final_t.island_widths, final_j.island_widths) <= TOL
    for field in tr_j._fields:
        assert rel(getattr(tr_t, field), getattr(tr_j, field)) <= TOL, field


def test_the_laplacian_wraps_at_the_top_row():
    """A hot point on the last row at the middle column heats (0, n/2), which
    the mask holds, through the wrapped neighbour: zero rings would not."""
    n = 32
    r_t, m_t = tdt._geometry(CFG_T, F64, "cpu")
    assert bool(m_t[0, n // 2]) and bool(m_t[n - 1, n // 2])
    t0 = torch.zeros((n, n), dtype=F64)
    t0[n - 1, n // 2] = 10.0
    state = tdt.TwinState(t0, torch.full((4,), 0.01, dtype=F64))
    s1, _ = tdt.twin_step(CFG_T, r_t, m_t, state, torch.tensor(0.0, dtype=F64))
    assert float(s1.t_field[0, n // 2]) > 0.0
    r_j, m_j = jdt._geometry(CFG_J, jnp.float64)
    s_j, _ = jdt.twin_step(CFG_J, r_j, m_j, jdt.TwinState(jnp.asarray(t0.numpy()),
                                                          jnp.full((4,), 0.01)), 0.0)
    assert rel(s1.t_field, s_j.t_field) <= 1e-15


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_twin_is_the_step_loop(dtype):
    """Row D's plain version is the loop of ``twin_step`` (what the kernel
    replaces), and the danger fraction is a count over n^2."""
    cfg = tdt.TwinConfig(grid_size=24)
    r, m = tdt._geometry(cfg, dtype, "cpu")
    acts = torch.tensor(rng(4).uniform(-1.0, 1.0, 30), dtype=dtype)
    state, (core, widths, frac) = cuda_twin.twin_shot(cfg, r, m, tdt.twin_init(cfg, dtype, "cpu"),
                                                      acts)
    s = tdt.twin_init(cfg, dtype, "cpu")
    for k in range(30):
        s, (c_k, w_k, f_k) = tdt.twin_step(cfg, r, m, s, acts[k])
        assert torch.equal(core[k], c_k) and torch.equal(widths[k], w_k)
        assert torch.equal(frac[k], f_k)
    assert torch.equal(state.t_field, s.t_field)
    counts = frac * (24 * 24)
    assert torch.equal(counts, torch.round(counts))


def test_jax_gates_hold():
    r_t, m_t = tdt._geometry(CFG_T, F64, "cpu")
    n = CFG_T.grid_size
    q0 = tdt.q_map(CFG_T, r_t, 0.0)
    q_mod = tdt.q_map(CFG_T, r_t, 1.0)
    assert float(q0[n // 2, n // 2]) == pytest.approx(1.0, abs=0.05)
    assert float(q_mod[n // 2, n // 2]) < float(q0[n // 2, n // 2])
    assert float(q_mod[0, n // 2]) > float(q0[0, n // 2])

    def dwdt(w):
        w = torch.full((4,), w, dtype=F64)
        return float((tdt.mre_step(CFG_T, w) - w)[0])

    assert dwdt(0.01) > 0.0 and dwdt(0.2) > 0.0 and dwdt(0.4) < 0.0
    widths = torch.full((4,), 0.05, dtype=F64)
    danger = tdt.danger_map(CFG_T, q0, m_t, widths)
    wide = tdt.danger_map(CFG_T, q0, m_t, torch.full((4,), 0.2, dtype=F64))
    assert bool(danger.any()) and int(wide.sum()) > int(danger.sum())

    final, base = tdt.run_digital_twin(CFG_T, n_steps=300, device="cpu")
    assert bool(torch.isfinite(final.t_field).all()) and float(base.t_core[-1]) > 0.0
    assert 0.0 <= float(base.danger_fraction[-1]) <= 1.0
    assert float(final.t_field[~m_t.to(torch.bool)].abs().max()) == 0.0
    acts = tdt.avoidance_action_trace(CFG_T, 300, gain=1.0, device="cpu")
    _, driven = tdt.run_digital_twin(CFG_T, n_steps=300, actions=acts)
    assert float(driven.danger_fraction[-1]) < float(base.danger_fraction[-1])


def _history(n=4, dt=0.1):
    cfg = tdt.TwinConfig()
    state = tdt.twin_init(cfg, device="cpu")
    return [(i * dt, tdt.twin_to_ids(state, cfg, time_s=i * dt)) for i in range(n)]


def test_ids_snapshot_matches_jax():
    final_t, _ = tdt.run_digital_twin(CFG_T, n_steps=50, dtype=F64, device="cpu")
    final_j, _ = jdt.run_digital_twin.__wrapped__(CFG_J, n_steps=50, dtype=jnp.float64)
    ids_t = tdt.twin_to_ids(final_t, CFG_T, time_s=1.5)
    ids_j = jdt.twin_to_ids(final_j, CFG_J, time_s=1.5)
    assert ids_t["time"] == [1.5] and ids_t.keys() == ids_j.keys()
    assert set(ids_t["summary"]["island_widths"]) == set(ids_j["summary"]["island_widths"])
    assert ids_t["summary"]["t_core"] == pytest.approx(ids_j["summary"]["t_core"], rel=TOL)
    assert rel(np.asarray(ids_t["profiles_2d"][0]["temperature"]),
               np.asarray(ids_j["profiles_2d"][0]["temperature"])) <= TOL


def test_history_roundtrip_through_the_copy():
    hist = _history(5)
    payloads = tih.twin_history_to_ids(hist, machine="SPARC", shot=7, run=2)
    assert len(payloads) == 5 and all(p["machine"] == "SPARC" for p in payloads)
    back = tih.ids_to_twin_history(payloads)
    np.testing.assert_allclose([t for t, _ in back], [0.0, 0.1, 0.2, 0.3, 0.4], atol=1e-9)
    assert back[0][1]["summary"] == hist[0][1]["summary"]
    j_payloads = jih.twin_history_to_ids(hist, machine="SPARC", shot=7, run=2)
    assert payloads == j_payloads
    times = [p["time_slice"]["time_s"] for p in tih.twin_history_to_ids(_history(3, dt=0.0))]
    assert times == pytest.approx([0.0, 1e-3, 2e-3])


def test_pulse_roundtrip_and_schema_gates():
    pulse = tih.twin_history_to_ids_pulse(_history(4), machine="ITER", shot=3, run=1)
    assert pulse["schema"] == "ids_equilibrium_pulse_v1"
    assert len(tih.ids_pulse_to_twin_history(pulse)) == 4
    with pytest.raises(ValueError, match="schema"):
        tih.ids_pulse_to_twin_history(dict(pulse, schema="bogus"))
    payloads = tih.twin_history_to_ids(_history(2), machine="ITER", shot=1)
    with pytest.raises(ValueError, match="same"):
        tih.validate_ids_payload_sequence([payloads[0], dict(payloads[1], machine="SPARC")])
    with pytest.raises(ValueError, match="strictly increasing"):
        tih.validate_ids_payload_sequence([payloads[1], payloads[0]])
    with pytest.raises(ValueError, match="missing keys"):
        tih.validate_ids_payload_sequence([{"machine": "ITER"}])


def test_wrapper_guards_and_the_default_device():
    r, m = tdt._geometry(CFG_T, F64, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_twin.check_twin_shot(CFG_T, r, m, tdt.twin_init(CFG_T, F64, "cpu"),
                                  torch.zeros(3, dtype=F64))
    if torch.cuda.is_available():
        tdt.run_digital_twin(CFG_T, n_steps=2)
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            tdt.run_digital_twin(CFG_T, n_steps=2)
    assert as_np(tdt.avoidance_action_trace(CFG_T, 3, gain=2.0, device="cpu")).tolist() == [1.0] * 3
