"""Port parity: the voltage-driven FRC compression
(``models/physics/pulsed_compression``; row P's plain twin
``ops/cuda_compression.compression_run_plain``, differentiated by autograd).

In float64 on the CPU every trace row is within 1e-9 of JAX's (of the row's
largest magnitude; the five energy ledgers of their common scale, for the
radiated ledger without a loss channel is rounding noise that XLA does not
make exactly 0), the balance residual within 1e-12 absolutely (it is
rounding noise of a cancellation), and the diagnostics' counts equal: the
JAX tests' 4000-step drive at 4000 V (its first 3000 steps are the 3000-step
test's run: a scan's prefix), 1500 steps with and without the loss channel
and a time-dependent ramp from a nonzero start time (the Faraday
configuration runs in ``test_torch_frc.py``).  The gradient d min(radius)
/ d V at 500 steps is within 1e-8 of ``jax.grad``; the clip's ties give
JAX's half gradient; a start time that requires a gradient raises.  The
gates of ``tests/test_pulsed_compression.py`` hold for the port.  The drive
table's times equal the scan's accumulated times in float32 and float64,
and the wrapper's CPU path equals the module's own step loop with the drive
called each step.  The kernel's argument block, constants and rows list the
C source's.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np, c_struct_fields, ctypes_fields

from scpn_fusion_tpu.models.physics import pulsed_compression as jp
from scpn_fusion_tpu_torch.models.physics import pulsed_compression as tp
from scpn_fusion_tpu_torch.ops import _cuda_build as cb
from scpn_fusion_tpu_torch.ops import cuda_compression as cc

TOL = 1e-9
RESIDUAL_ATOL = 1e-12
F64 = torch.float64
CPU = dict(dtype=F64, device="cpu")
LEDGERS = ("thermal_energy_j", "compression_work_j", "radiated_loss_j", "ohmic_loss_j",
           "source_work_j")

# (label, config kwargs, coil kwargs, initial-state kwargs, drive (a + b t), dt_s, n_steps, t0)
CASES = {
    "4000 V, 4000 steps": ({}, {}, dict(radius_m=0.25), (4000.0, 0.0), 2e-8, 4000, 0.0),
    "adiabatic 1500": ({}, {}, dict(radius_m=0.25), (3000.0, 0.0), 2e-8, 1500, 0.0),
    "loss 1500": (dict(radial_loss_time_s=5e-6), {}, dict(radius_m=0.25), (3000.0, 0.0), 2e-8,
                  1500, 0.0),
    "ramp from t0": ({}, {}, dict(radius_m=0.25), (1000.0, 5e10), 2e-8, 400, 3e-8),
}


def _configs(cfg_kw, coil_kw):
    return (jp.CompressionConfig(coil=jp.CoilGeometry(**coil_kw), **cfg_kw),
            tp.CompressionConfig(coil=tp.CoilGeometry(**coil_kw), **cfg_kw))


def _runs(case):
    cfg_kw, coil_kw, s_kw, (a, b), dt, n, t0 = CASES[case]
    cj, ct = _configs(cfg_kw, coil_kw)
    sj = jp.initial_state(cj, **s_kw)._replace(t_s=jnp.asarray(t0))
    st = tp.initial_state(ct, **s_kw, **CPU)._replace(t_s=torch.tensor(t0, dtype=F64))
    if b == 0.0:
        drive_j, drive_t = (lambda t: jnp.asarray(a)), (lambda t: a)
    else:
        drive_j = drive_t = (lambda t: a + b * t)
    trj = jp.run_voltage_driven_compression(cj, sj, drive_j, dt_s=dt, n_steps=n)
    trt = tp.run_voltage_driven_compression(ct, st, drive_t, dt_s=dt, n_steps=n)
    r0 = s_kw["radius_m"]
    return (cj, ct, trj, trt, jp.trajectory_diagnostics(trj, cj, r0),
            tp.trajectory_diagnostics(trt, ct, r0))


@pytest.fixture(scope="module")
def runs():
    return {}


def _get(runs, case):
    if case not in runs:
        runs[case] = _runs(case)
    return runs[case]


def _rows_match(trt, trj):
    ledger_scale = max(float(np.max(np.abs(np.asarray(getattr(trj.state, f))))) for f in LEDGERS)
    for name in jp.CompressionState._fields:
        ours, ref = as_np(getattr(trt.state, name)), np.asarray(getattr(trj.state, name))
        scale = ledger_scale if name in LEDGERS else max(float(np.max(np.abs(ref))), 1e-300)
        assert np.max(np.abs(ours - ref)) <= TOL * scale, (name, np.max(np.abs(ours - ref)) / scale)
    for name in ("b_ext_t", "beta"):
        ours, ref = as_np(getattr(trt, name)), np.asarray(getattr(trj, name))
        assert np.max(np.abs(ours - ref)) <= TOL * np.max(np.abs(ref)), name
    res = np.max(np.abs(as_np(trt.balance_residual) - np.asarray(trj.balance_residual)))
    assert res <= RESIDUAL_ATOL, res


@pytest.mark.parametrize("case", list(CASES))
def test_trajectory_matches_jax(runs, case):
    _, _, trj, trt, dj, dt_ = _get(runs, case)
    assert trt.state.radius_m.shape == (CASES[case][5],) and trt.state.radius_m.dtype == F64
    _rows_match(trt, trj)
    for name in ("radial_turning_points", "floor_contact_count"):
        assert int(getattr(dt_, name)) == int(getattr(dj, name)), name
    for name in ("min_radius_m", "compression_ratio", "max_abs_acceleration"):
        assert abs(float(getattr(dt_, name)) - float(getattr(dj, name))) <= TOL * abs(
            float(getattr(dj, name))), name
    assert float(dt_.max_balance_residual) <= 1e-12 + float(dj.max_balance_residual)


def test_gates_of_the_jax_tests(runs):
    """``tests/test_pulsed_compression.py``'s trajectory gates on the port."""
    tr = _get(runs, "4000 V, 4000 steps")[3]
    s = tp.CompressionState(*(x[:3000] for x in tr.state))
    assert float(s.radius_m.min()) < 0.25 * 0.8
    i_min = int(torch.argmin(s.radius_m))
    assert float(s.t_i_ev[i_min]) > 150.0 and float(s.density_m3[i_min]) > 5.0e20 * 1.5
    assert float(tr.balance_residual[:3000].abs().max()) < 1e-8
    assert bool(torch.isfinite(s.radius_m).all())
    ct, tr = _get(runs, "adiabatic 1500")[1], _get(runs, "adiabatic 1500")[3]
    inv = as_np(tr.state.t_i_ev) * (np.pi * as_np(tr.state.radius_m) ** 2) ** (ct.gamma - 1.0)
    np.testing.assert_allclose(inv, inv[0], rtol=1e-6)
    loss = _get(runs, "loss 1500")[3]
    assert float(loss.state.radiated_loss_j[-1]) > 0.0
    assert float(loss.balance_residual.abs().max()) < 1e-8
    tr, d = _get(runs, "4000 V, 4000 steps")[3], _get(runs, "4000 V, 4000 steps")[5]
    assert int(d.radial_turning_points) >= 1 and float(d.max_balance_residual) < 1e-8
    np.testing.assert_allclose(float(d.compression_ratio), 0.25 / float(tr.state.radius_m.min()),
                               rtol=1e-6)
    # validation/run_pulsed_suppression.py lanes 1 and 2
    assert float(d.compression_ratio) > 1.3
    inv = as_np(tr.state.t_i_ev) * (np.pi * as_np(tr.state.radius_m) ** 2) ** (2.0 / 3.0)
    assert np.max(np.abs(inv / inv[0] - 1.0)) < 1e-6


def test_circuit_step_matches_jax():
    """``_circuit_step`` against JAX's, the exact R-L response, its ledger and
    the bank clamp (``test_pulsed_compression.py:28-51``)."""
    coil_j, coil_t = jp.CoilGeometry(), tp.CoilGeometry()
    for i0, v in ((0.0, 1000.0), (3.0e5, -2.0e3), (1.0e4, 7.0e3)):
        ref = jp._circuit_step(coil_j, jnp.asarray(i0), jnp.asarray(v), 1e-6)
        ours = tp._circuit_step(coil_t, torch.tensor(i0, dtype=F64), v, 1e-6)
        for a, b in zip(ours, ref):
            assert abs(float(a) - float(b)) <= TOL * max(abs(float(b)), 1e-300)
    i1, _, ohm, src = tp._circuit_step(coil_t, torch.tensor(0.0, dtype=F64), 1000.0, 1e-6)
    tau = coil_t.inductance_h / coil_t.resistance_ohm
    np.testing.assert_allclose(float(i1), 1000.0 / coil_t.resistance_ohm
                               * (1.0 - np.exp(-1e-6 / tau)), rtol=1e-12)
    np.testing.assert_allclose(float(src), float(ohm) + 0.5 * coil_t.inductance_h
                               * float(i1) ** 2, rtol=2e-2)
    coil = tp.CoilGeometry(bank_voltage_max_v=100.0)
    zero = torch.tensor(0.0, dtype=F64)
    assert float(tp._circuit_step(coil, zero, 1e6, 1e-6)[0]) == pytest.approx(
        float(tp._circuit_step(coil, zero, 100.0, 1e-6)[0]), rel=1e-12)
    b = float(tp.coil_field_t(tp.CoilGeometry(n_turns=40, l_coil_m=1.0), 1000.0))
    np.testing.assert_allclose(b, 4e-7 * np.pi * 40 * 1000.0, rtol=1e-12)


def test_drive_gradient_matches_jax():
    """d min(radius) / d V through 500 steps (``test_pulsed_compression.py:107-123``
    and lane 4 of ``validation/run_pulsed_suppression.py``): autograd through
    the plain twin within 1e-8 of ``jax.grad``, and negative."""
    cj, ct = jp.CompressionConfig(), tp.CompressionConfig()
    sj, st = jp.initial_state(cj, radius_m=0.25), tp.initial_state(ct, radius_m=0.25, **CPU)

    def min_radius_j(v):
        return jnp.min(jp.run_voltage_driven_compression(cj, sj, lambda t: v, dt_s=2e-8,
                                                         n_steps=500).state.radius_m)

    g_ref = float(jax.grad(min_radius_j)(jnp.asarray(3000.0)))
    v = torch.tensor(3000.0, dtype=F64, requires_grad=True)
    tr = tp.run_voltage_driven_compression(ct, st, lambda t: v, dt_s=2e-8, n_steps=500)
    (g,) = torch.autograd.grad(tr.state.radius_m.min(), v)
    assert abs(float(g) - g_ref) <= 1e-8 * abs(g_ref), (float(g), g_ref)
    assert float(g) < 0.0


@pytest.mark.parametrize("bound", [1.0, -1.0])
def test_clip_ties_give_jax_half_gradient(bound):
    """A drive exactly at +V_max (a tie of the minimum) or -V_max (a tie of
    the maximum): the gradient of I' by V is JAX's, half the unclipped one
    (``torch.clamp`` would give all of it)."""
    coil_j, coil_t = jp.CoilGeometry(), tp.CoilGeometry()
    v0 = bound * coil_t.bank_voltage_max_v
    g_ref = float(jax.grad(lambda v: jp._circuit_step(coil_j, jnp.asarray(0.0), v, 1e-6)[0])(
        jnp.asarray(v0)))
    v = torch.tensor(v0, dtype=F64, requires_grad=True)
    (g,) = torch.autograd.grad(tp._circuit_step(coil_t, torch.tensor(0.0, dtype=F64), v, 1e-6)[0],
                               v)
    inside = float(jax.grad(lambda v: jp._circuit_step(coil_j, jnp.asarray(0.0), v, 1e-6)[0])(
        jnp.asarray(0.5 * v0)))
    assert float(g) == pytest.approx(g_ref, rel=1e-12)
    assert g_ref == pytest.approx(0.5 * inside, rel=1e-12)


def test_start_time_gradient_raises():
    ct = tp.CompressionConfig()
    st = tp.initial_state(ct, **CPU)
    st = st._replace(t_s=torch.tensor(0.0, dtype=F64, requires_grad=True))
    with pytest.raises(ValueError, match="t_s"):
        tp.run_voltage_driven_compression(ct, st, lambda t: 4000.0, n_steps=5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_drive_table_times_are_the_scans(dtype):
    """The table's times are ``t_{k+1} = t_k + dt`` added in ``dtype`` from a
    nonzero start (numpy's sequential loop; JAX's scan in float64), and the
    trace's time row equals them."""
    npdt = np.float32 if dtype == torch.float32 else np.float64
    t0, dt, n = 3e-8, 2e-8, 700
    times, table = tp.drive_table(lambda t: 10.0 * t, torch.tensor(t0, dtype=dtype), dt, n,
                                  dtype, "cpu")
    want = [npdt(t0)]
    for _ in range(n):
        want.append(npdt(want[-1] + npdt(dt)))
    assert np.array_equal(times.numpy(), np.asarray(want, npdt))
    assert torch.equal(table, 10.0 * times[:-1])
    ct = tp.CompressionConfig()
    st = tp.initial_state(ct, dtype=dtype, device="cpu")._replace(t_s=torch.tensor(t0, dtype=dtype))
    tr = tp.run_voltage_driven_compression(ct, st, lambda t: 4000.0, dt_s=dt, n_steps=n)
    assert torch.equal(tr.state.t_s, times[1:])
    if dtype == torch.float64:
        cj = jp.CompressionConfig()
        trj = jp.run_voltage_driven_compression(
            cj, jp.initial_state(cj)._replace(t_s=jnp.asarray(t0)), lambda t: 4000.0, dt_s=dt,
            n_steps=n)
        assert np.array_equal(times[1:].numpy(), np.asarray(trj.state.t_s))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_twin_is_the_module_step_loop(dtype):
    """The CPU path (the drive tabulated, the plain twin over the table)
    equals the module's own step loop calling the drive at each step's time,
    bit for bit, and launches nothing."""
    ct = tp.CompressionConfig()
    st = tp.initial_state(ct, dtype=dtype, device="cpu")._replace(
        t_s=torch.tensor(3e-8, dtype=dtype))
    drive = lambda t: 1000.0 + 5e10 * t  # noqa: E731
    cb.reset_launch_counts()
    tr = tp.run_voltage_driven_compression(ct, st, drive, dt_s=2e-8, n_steps=300)
    assert cb.kernel_launches() == 0 and sum(cb.CALLS.values()) == 0
    c = tp.step_constants(ct, 2e-8, dtype, "cpu")
    s, rows = tuple(st), []
    for _ in range(300):
        s, extra = tp.compression_step(c, s, torch.as_tensor(drive(s[0]), dtype=dtype))
        rows.append((*s, *extra))
    want = torch.stack([torch.stack(col) for col in zip(*rows)])
    got = torch.stack([*tr.state, tr.b_ext_t, tr.beta, tr.balance_residual])
    assert got.dtype == dtype and torch.equal(got, want)


def test_kernel_layout_matches_the_c_source():
    """The ctypes argument block is ``CompressionArgs`` field for field, the
    step constants are ``Const`` in order, and the trace's rows ``Row``."""
    src = (Path(cc.__file__).resolve().parent.parent / "csrc" / "compression.cu").read_text()
    assert ctypes_fields(cc._Args) == c_struct_fields(src, "CompressionArgs")
    import re

    def enum(name):
        body = re.search(r"enum " + name + r" \{(.*?)\};", src, re.S).group(1)
        return [e.split("=")[0].strip() for e in body.replace("\n", " ").split(",") if e.strip()]

    camel = ["k" + "".join(w.capitalize() for w in n.split("_")) for n in tp.CONSTANTS]
    assert enum("Const")[:-1] == camel and enum("Const")[-1] == "kNConst"
    rows = enum("Row")
    assert rows[cc.N_STATE:] == ["kNState", "kB", "kBeta", "kRes", "kNRows"]
    assert cc.N_STATE == len(tp.CompressionState._fields) and cc.N_ROWS == cc.N_STATE + 3


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        tp.initial_state(tp.CompressionConfig())
