"""Port parity: the staged disruption (``models/physics/disruption_sequence``,
row Q's plain twin ``ops/cuda_disruption.disruption_sequence_plain``), the
Fokker-Planck runaway kernel (``fokker_planck_re``) and the fluid runaway
model (``runaway_fluid``).

In float64 on the CPU every trace and summary is within 1e-9 (of the
largest magnitude) of JAX's: the default 4000-tick sequence, an SPI-mitigated
one at 1000 ticks and the mitigation scan of
``tests/test_disruption_edge_events.py:52-54``; the momentum grid within
1e-15 relative, the coefficients and a 300-step kinetic run; every rate, the
balance and the exponential-integrator run.  The gates of
``test_disruption_edge_events.py`` (``TestDisruption``),
``test_physics_kernels.py`` (``TestFokkerPlanck``) and
``test_runaway_fluid.py`` hold for the port; the Hall-MHD half of
``test_physics_kernels.py`` is held in ``test_torch_hall_mhd.py``.  Waiting
for its artifact: the DREAM cross-code bands (not in the repository).  The batched plain twin equals, bit for bit, the module's step
looped over one sequence at a time; the kernel's argument block lists the C
struct field for field.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np, c_struct_fields, ctypes_fields, rel

from scpn_fusion_tpu.models.physics import disruption_sequence as jd
from scpn_fusion_tpu.models.physics import fokker_planck_re as jfp
from scpn_fusion_tpu.models.physics import runaway_fluid as jrf
from scpn_fusion_tpu_torch.models.physics import disruption_sequence as td
from scpn_fusion_tpu_torch.models.physics import fokker_planck_re as tfp
from scpn_fusion_tpu_torch.models.physics import runaway_fluid as trf
from scpn_fusion_tpu_torch.ops import cuda_disruption as cd

TOL = 1e-9
F64 = torch.float64
CPU = dict(dtype=F64, device="cpu")
CSRC = Path(cd.__file__).resolve().parent.parent / "csrc"


def _close(ours, ref) -> bool:
    """Within TOL of the largest finite magnitude, infinities in the same places."""
    a, b = as_np(ours), np.asarray(ref, dtype=np.float64)
    fin = np.isfinite(b)
    return bool(np.array_equal(a[~fin], b[~fin])) and (not fin.any() or rel(a[fin], b[fin]) <= TOL)


def _same(ours, ref, label):
    for name, a, b in zip(ref._fields, ours, ref):
        if np.asarray(b).dtype == bool:
            assert np.array_equal(as_np(a).astype(bool), np.asarray(b)), (label, name)
        else:
            assert rel(a, b) <= TOL, (label, name, rel(a, b))


@pytest.fixture(scope="module")
def default_runs():
    p = jd.DisruptionParams()
    return {"unmitigated": (td.run_disruption_sequence(td.DisruptionParams(), **CPU),
                            jd.run_disruption_sequence(p)),
            "spi": (td.run_disruption_sequence(td.DisruptionParams(n_steps=1000),
                                               spi_ne20_injected=200.0, spi_time_ms=0.2, **CPU),
                    jd.run_disruption_sequence(jd.DisruptionParams(n_steps=1000),
                                               spi_ne20_injected=200.0, spi_time_ms=0.2))}


@pytest.mark.parametrize("case", ["unmitigated", "spi"])
def test_sequence_matches_jax(default_runs, case):
    (trace, summary), (trace_j, summary_j) = default_runs[case]
    assert trace.ip_ma.shape == (trace_j.ip_ma.shape[0],) and trace.ip_ma.dtype == F64
    _same(trace, trace_j, case)
    _same(summary, summary_j, case)


def test_mitigation_scan_matches_jax():
    q = [0.0, 5.0, 50.0]
    ours = td.spi_mitigation_scan(td.DisruptionParams(n_steps=2000), torch.tensor(q, dtype=F64))
    ref = jd.spi_mitigation_scan(jd.DisruptionParams(n_steps=2000), jnp.asarray(q))
    _same(ours, ref, "scan")
    i_re = as_np(ours.i_re_final_ma)
    assert i_re.shape == (3,) and i_re[2] < i_re[0]     # test_spi_scan_monotone_mitigation


def test_disruption_gates(default_runs):
    """``TestDisruption`` of ``tests/test_disruption_edge_events.py``."""
    (trace, s), _ = default_runs["unmitigated"]
    ip, i_re = as_np(trace.ip_ma), as_np(trace.i_re_ma)
    assert ip[0] == pytest.approx(15.0, rel=0.01)
    assert (ip[-1] - i_re[-1]) < 1.0 and ip[-1] < ip[0]
    assert float(s.tau_cq_ms) > 0.0
    assert as_np(trace.te_ev)[-1] == pytest.approx(10.0, rel=0.2)
    assert float(s.i_re_final_ma) > 0.5 and not bool(s.mitigated)
    _, mit = td.run_disruption_sequence(td.DisruptionParams(), spi_ne20_injected=200.0,
                                        spi_time_ms=0.2, **CPU)
    assert float(mit.i_re_final_ma) < 0.2 * float(s.i_re_final_ma)
    assert float(s.halo_peak_ma) > 0.5
    screen = td.structural_response_screen(s, force_limit_mn=1e4, tau_cq_min_ms=0.0)
    assert screen["passed"]
    assert "halo_force_limit" in td.structural_response_screen(s, force_limit_mn=0.1)["failures"]
    ref = jd.structural_response_screen(default_runs["unmitigated"][1][1], force_limit_mn=1e4,
                                        tau_cq_min_ms=0.0)
    assert (screen["passed"], screen["failures"]) == (ref["passed"], ref["failures"])
    assert abs(screen["halo_force_mn"] - ref["halo_force_mn"]) <= TOL * ref["halo_force_mn"]


def test_physics_helpers_match_jax():
    te = [0.5, 10.0, 100.0, 1000.0]
    assert rel(td.spitzer_resistivity(torch.tensor(te, dtype=F64)),
               jd.spitzer_resistivity(jnp.asarray(te))) <= TOL
    assert float(td.spitzer_resistivity(10.0, **CPU)) > float(td.spitzer_resistivity(1000.0, **CPU))
    e, ne = [0.0, 0.05, 10.0, 100.0], [0.5, 1.0, 50.0, 1e-9]
    assert rel(td.avalanche_growth_rate(torch.tensor(e, dtype=F64), torch.tensor(ne, dtype=F64)),
               jd.avalanche_growth_rate(jnp.asarray(e), jnp.asarray(ne))) <= TOL
    g_lo = float(td.avalanche_growth_rate(10.0, 1.0, **CPU))
    g_hi = float(td.avalanche_growth_rate(10.0, 50.0, **CPU))
    assert g_hi < g_lo
    assert float(td.critical_field_connor_hastie(5.0, **CPU)) == pytest.approx(
        5.0 * float(td.critical_field_connor_hastie(1.0, **CPU)), rel=1e-6)
    assert rel(td.critical_field_connor_hastie(torch.tensor(ne, dtype=F64)),
               jd.critical_field_connor_hastie(jnp.asarray(ne))) <= TOL


def test_quench_times_of_bool_masks():
    """The 80-20 indices are ``jnp.argmax`` of bool masks, taken as uint8: a
    mask with no True gives index 0 (t80) and the last time (t20), as JAX."""
    p = td.DisruptionParams(n_steps=4)
    t = torch.arange(4, dtype=F64) * p.dt_ms
    flat = torch.full((4,), 15.0, dtype=F64)
    s = td.summarize(p, td.DisruptionTrace(t, flat, flat, flat * 0, flat * 0, flat * 0))
    assert float(s.tau_cq_ms) == pytest.approx((float(t[-1]) - float(t[0])) / 0.6)
    drop = torch.tensor([15.0, 11.0, 2.0, 1.0], dtype=F64)
    s = td.summarize(p, td.DisruptionTrace(t, flat, drop, flat * 0, flat * 0, flat * 0))
    assert float(s.tau_cq_ms) == pytest.approx((float(t[2]) - float(t[1])) / 0.6)


def test_plain_twin_is_the_step_loop():
    """The batched plain twin equals the module's step looped over each
    sequence alone, bit for bit, in float32 and float64."""
    p = td.DisruptionParams(n_steps=300)
    for dtype in (torch.float32, F64):
        q = torch.tensor([0.0, 40.0, 200.0], dtype=dtype)
        batched = cd.disruption_sequence(p, q, 0.05)
        c = td.step_constants(p, dtype, "cpu")
        for j in range(3):
            carry, rows = td.initial_carry(p, 1, dtype, "cpu"), []
            for t in td.tick_times(p, dtype, "cpu"):
                carry, row = td.disruption_step(p, c, carry, t, q[j:j + 1], 0.05)
                rows.append(row)
            for k, col in enumerate(zip(*rows)):
                assert torch.equal(torch.stack(col, dim=-1).reshape(-1), batched[k][j]), \
                    (dtype, j, k)


def test_tick_time_is_formed_in_the_dtype():
    t32 = td.tick_times(td.DisruptionParams(), torch.float32, "cpu")
    assert t32.dtype == torch.float32
    assert torch.equal(t32, torch.arange(4000, dtype=torch.float32) * np.float32(0.05))


def test_argument_block_matches_the_kernel_source():
    src = (CSRC / "disruption.cu").read_text()
    assert c_struct_fields(src, "DisruptionArgs") == ctypes_fields(cd._Args)
    p = td.DisruptionParams(n_steps=7)
    q = torch.tensor([1.0, 2.0], dtype=F64)
    args, traces = cd.launch_args(p, q, 0.3)
    assert args.n_seq == 2 and args.n_steps == 7 and args.spi_ne20 == q.data_ptr()
    assert [tr.shape for tr in traces] == [(2, 7)] * 6 and args.halo_ma == traces[5].data_ptr()
    assert args.spi_time_ms == 0.3 and args.pow_exp == 1.5
    assert args.seed == p.re_seed_fraction * p.ip0_ma * 1e6 / (p.n_steps * (p.dt_ms * 1e-3))


def test_guards_and_default_device():
    with pytest.raises(ValueError, match="CUDA"):
        cd.check_disruption(td.DisruptionParams(), torch.zeros(2, dtype=F64))
    with pytest.raises(TypeError):
        cd.check_disruption(td.DisruptionParams(), torch.zeros(2, dtype=torch.int64))
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            td.run_disruption_sequence(td.DisruptionParams(n_steps=3))


# ── Fokker-Planck ──

def _fp_seed(grid):
    p = np.asarray(jfp.FokkerPlanckGrid(grid.np_grid, grid.p_max).p(jnp.float64))
    return 1e12 * np.exp(-((np.log10(p) + 1.0) ** 2) / 0.1)


@pytest.mark.parametrize("np_grid, p_max", [(64, 100.0), (200, 100.0), (40, 37.5)])
def test_fp_grid_matches_jax(np_grid, p_max):
    ours, ref = tfp.FokkerPlanckGrid(np_grid, p_max), jfp.FokkerPlanckGrid(np_grid, p_max)
    for name in ("p", "dp"):
        a = as_np(getattr(ours, name)(F64, "cpu"))
        b = np.asarray(getattr(ref, name)(jnp.float64))
        # p within 1e-15 (XLA's pow and libm's differ by an ulp); dp, a
        # difference of neighbours, within the ulp over the spacing
        assert np.max(np.abs(a - b) / np.abs(b)) <= (1e-15 if name == "p" else 1e-13), name
    np.testing.assert_allclose(as_np(ours.p(F64, "cpu")), np.logspace(-2, np.log10(p_max), np_grid),
                               rtol=1e-12)


def test_fp_coefficients_match_jax():
    p = tfp.FokkerPlanckGrid(64).p(F64, "cpu")
    p_j = jfp.FokkerPlanckGrid(64).p(jnp.float64)
    for e_field in (0.0, 10.0, 5.0):
        ours = tfp.fp_coefficients(p, e_field, 5e19, 1.5, 5000.0)
        ref = jfp.fp_coefficients(p_j, e_field, 5e19, 1.5, 5000.0)
        for a, b in zip(ours, ref):
            assert rel(a, b) <= TOL


def test_fp_critical_field_is_folded_in_double():
    """The e^3 product underflows float32: with a Python density the
    critical force is the double fold, rounded once to float32."""
    p32 = tfp.FokkerPlanckGrid(64).p(torch.float32, "cpu")
    _, _, fc = tfp.fp_coefficients(p32, 0.0, 5e19, 1.5, 5000.0)
    assert fc > 0.0 and fc == (tfp.E_CHARGE * tfp._e_crit(5e19)) / tfp.MC


@pytest.fixture(scope="module")
def fp_runs():
    """(port, JAX) runs of the JAX test's seed: at 10 V/m for 300 steps,
    field-free for 50 and 300.  The field-free explicit scheme is unstable at
    low p (``test_physics_kernels.py:49-50``: CFL-limited): an ulp of
    difference grows ~1e4-fold each 50 steps, 8.8e-11 at 50 and O(1) at 300,
    so it is held to JAX at 50 steps and to the gate at 300."""
    grid, grid_j = tfp.FokkerPlanckGrid(64), jfp.FokkerPlanckGrid(64)
    f0 = _fp_seed(grid)
    out = {}
    for e_field, n_steps in ((10.0, 300), (0.0, 50), (0.0, 300)):
        out[e_field, n_steps] = (tfp.run_fokker_planck(grid, torch.tensor(f0), 1e-6, e_field,
                                                       5e19, 5000.0, 1.5, n_steps=n_steps),
                                 jfp.run_fokker_planck(grid_j, jnp.asarray(f0), 1e-6, e_field,
                                                       5e19, 5000.0, 1.5, n_steps=n_steps))
    return out


@pytest.mark.parametrize("e_field, n_steps", [(10.0, 300), (0.0, 50)])
def test_fokker_planck_run_matches_jax(fp_runs, e_field, n_steps):
    (f, trace), (f_j, trace_j) = fp_runs[e_field, n_steps]
    assert rel(f, f_j) <= TOL
    assert rel(trace.n_re, trace_j.n_re) <= TOL and rel(trace.j_re, trace_j.j_re) <= TOL


def test_fokker_planck_gates(fp_runs):
    """``TestFokkerPlanck`` of ``tests/test_physics_kernels.py``."""
    (f, grow), _ = fp_runs[10.0, 300]
    n_re = as_np(grow.n_re)
    assert np.all(np.isfinite(n_re)) and n_re[-1] > n_re[0]
    (_, decay), _ = fp_runs[0.0, 300]
    n_re = as_np(decay.n_re)
    assert np.all(np.isfinite(n_re)) and n_re[-1] < n_re[0]
    assert np.all(as_np(f) >= 0.0)
    j, n = float(grow.j_re[49]), float(grow.n_re[49])
    assert 0 <= j <= tfp.E_CHARGE * tfp.C * n * (1 + 1e-6)
    p = tfp.FokkerPlanckGrid(64).p(F64, "cpu")
    e_crit = float(tfp._e_crit(5e19))
    a_hi, _, _ = tfp.fp_coefficients(p, 100.0 * e_crit, 5e19, 1.5, 5000.0)
    a_lo, _, _ = tfp.fp_coefficients(p, 0.0, 5e19, 1.5, 5000.0)
    assert np.all(as_np(a_hi)[20:40] > 0) and np.all(as_np(a_lo) < 0)


# ── fluid runaway ──

RF_INPUTS = [(0.5, 0.1, 2.0, 1.0), (0.5, 0.1, 6.0, 1.0), (1.2, 2.0, 40.0, 2.5),
             (0.5, 0.1, 1e-4, 1.0), (0.7, 10.0, 3.0, 1.0)]


def test_rates_match_jax():
    cols = [torch.tensor(c, dtype=F64) for c in zip(*RF_INPUTS)]
    cols_j = [jnp.asarray(c) for c in zip(*RF_INPUTS)]
    for name in ("dreicer_rate", "avalanche_rate"):
        assert rel(getattr(trf, name)(*cols), getattr(jrf, name)(*cols_j)) <= TOL, name
    assert rel(trf.coulomb_log_thermal(cols[0], cols[1]),
               jrf.coulomb_log_thermal(*cols_j[:2])) <= TOL
    assert rel(trf.coulomb_log_relativistic(cols[0], cols[1]),
               jrf.coulomb_log_relativistic(*cols_j[:2])) <= TOL
    assert rel(trf.dreicer_field(cols[0], cols[1], 15.0),
               jrf.dreicer_field(*cols_j[:2], 15.0)) <= TOL
    assert rel(trf.hot_tail_seed(3.0, 0.02, 0.5, cols[1]),
               jrf.hot_tail_seed(3.0, 0.02, 0.5, cols_j[1])) <= TOL
    for loss in (5e-3, np.inf, 1e-9):
        ours = trf.fluid_density_balance(0.5, 0.1, 6.0, 1.0, 1e14, loss_time_s=loss, **CPU)
        ref = jrf.fluid_density_balance(0.5, 0.1, 6.0, 1.0, 1e14, loss_time_s=loss)
        for name, a, b in zip(ref._fields, ours, ref):
            assert _close(a, b), (loss, name)


@pytest.mark.parametrize("args, kw", [
    ((0.5, 0.01, 0.5, 1.0), dict(n_re_seed=1e10, t_max_s=0.01, n_steps=50)),
    ((0.5, 0.1, 50.0, 1.0), dict(n_re_seed=1e16, t_max_s=1.0, n_steps=100,
                                 max_runaway_fraction=0.05)),
    ((0.8, 1.0, 8.0, 1.5), dict(n_re_seed=1e12, t_max_s=0.02, n_steps=80, loss_time_s=2e-3)),
])
def test_fluid_run_matches_jax(args, kw):
    ours = trf.run_fluid_runaway(*args, **kw, **CPU)
    ref = jrf.run_fluid_runaway(*args, **kw)
    for name, a, b in zip(ref._fields, ours, ref):
        assert a.dtype == F64 and a.shape == b.shape and rel(a, b) <= TOL, name


def test_runaway_fluid_gates():
    """``tests/test_runaway_fluid.py`` but the DREAM bands (no artifact)."""
    assert np.isclose(float(trf.coulomb_log_thermal(1.0, 1.0, **CPU)), 14.9)
    assert np.isclose(float(trf.coulomb_log_relativistic(1.0, 1.0, **CPU)),
                      14.6 + 0.5 * np.log(1e3))
    ratio = float(trf.dreicer_field(0.7, 10.0, 15.0, **CPU) / trf.critical_field(0.7, 15.0, **CPU))
    assert np.isclose(ratio, 510.99895 / 10.0, rtol=1e-6)
    assert float(trf.dreicer_rate(0.5, 0.1, 1e-4, 1.0, **CPU)) == 0.0
    assert float(trf.avalanche_rate(0.5, 0.1, 1e-4, 1.0, **CPU)) == 0.0
    rates = as_np(trf.dreicer_rate(0.5, 0.1, torch.tensor([1.0, 2.0, 4.0, 6.0], dtype=F64), 1.0))
    assert np.all(np.diff(rates) > 0.0) and np.all(rates >= 0.0) and np.all(np.isfinite(rates))
    g2, g4 = (float(trf.avalanche_rate(0.5, 0.1, e, 1.0, **CPU)) for e in (2.0, 4.0))
    e_c = float(trf.critical_field(0.5, trf.coulomb_log_relativistic(0.5, 0.1, **CPU)))
    assert np.isclose(g4 / g2, (4.0 - e_c) / (2.0 - e_c), rtol=1e-6)
    b_inf = trf.fluid_density_balance(0.5, 0.1, 6.0, 1.0, 1e14, **CPU)
    b_tau = trf.fluid_density_balance(0.5, 0.1, 6.0, 1.0, 1e14, loss_time_s=5e-3, **CPU)
    assert np.isclose(float(b_inf.total_source - b_tau.total_source), 1e14 / 5e-3, rtol=1e-10)
    assert float(b_inf.loss_source) == 0.0
    assert float(trf.dreicer_rate(0.5, 0.01, 0.5, 1.0, **CPU)) < 1e-12
    gamma = float(trf.avalanche_rate(0.5, 0.01, 0.5, 1.0, **CPU))
    tr = trf.run_fluid_runaway(0.5, 0.01, 0.5, 1.0, n_re_seed=1e10, t_max_s=0.01, n_steps=50, **CPU)
    np.testing.assert_allclose(as_np(tr.n_re), 1e10 * np.exp(gamma * as_np(tr.time_s)), rtol=1e-9)
    tr = trf.run_fluid_runaway(0.5, 0.1, 50.0, 1.0, n_re_seed=1e16, t_max_s=1.0, n_steps=100,
                               max_runaway_fraction=0.05, **CPU)
    assert float(np.max(as_np(tr.n_re))) <= 0.05 * 0.5e20 * (1 + 1e-12)
    assert float(trf.hot_tail_seed(1.0, 2.0, 0.5, 1.0, **CPU)) == 0.0
    fast = float(trf.hot_tail_seed(3.0, 0.02, 0.5, 0.5, **CPU))
    slow = float(trf.hot_tail_seed(3.0, 0.02, 0.5, 4.0, **CPU))
    assert fast > slow > 0.0
