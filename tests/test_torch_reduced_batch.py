"""Port parity: the reduced flight-sim shot over a population of gain sets
(``control/flight_sim.run_shot_reduced_gains`` with gains ``(..., 6)``) and
the kernel wrapper ``ops/cuda_reduced_shot`` around its batched tick loop.

The same numpy-seeded gains go through ``jax.vmap`` of the JAX shot and the
port's batched call in float64 (4 shots x 250 ticks at 1 kHz, one of them
uncontrolled and disrupted throughout), within 1e-12 of each trace's and metric's scale;
a single ``(6,)`` call equals its row of the batch; on the CPU the wrapper
runs the plain loop and counts no launch; the argument block is the C
struct of ``csrc/reduced_shot.cu`` field for field.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np, rng

from scpn_fusion_tpu.control import flight_sim as jf
from scpn_fusion_tpu_torch.control import flight_sim as tf
from scpn_fusion_tpu_torch.ops import _cuda_build as cb
from scpn_fusion_tpu_torch.ops import cuda_reduced_shot as crs

TOL = 1e-12
KW = dict(control_hz=1000.0, shot_duration_s=0.25)


def _close(ours, ref, tol=TOL):
    a, b = as_np(ours), as_np(ref)
    assert a.shape == b.shape
    scale = max(float(np.max(np.abs(b))), 1e-300) if b.size else 1.0
    assert float(np.max(np.abs(a - b), initial=0.0)) <= tol * scale


def _gains(seed=5, p=4):
    g = rng(seed).uniform(0.05, 4.0, (p, 6))
    g[-1] = 0.0        # no control: the shot never comes back within 0.1 m
    return g


@pytest.mark.parametrize("delay_steps", [2, 0])
def test_batch_matches_jax_vmap(delay_steps):
    jparams = jf.FlightSimParams(**KW, delay_steps=delay_steps, disruption_limit_m=0.1)
    tparams = tf.FlightSimParams(**dataclasses.asdict(jparams))
    gains = _gains()
    j_tr, j_m = jax.vmap(lambda g: jf.run_shot_reduced_gains(jparams, g, dtype=jnp.float64))(
        jnp.asarray(gains))
    t_tr, t_m = tf.run_shot_reduced_gains(tparams, torch.tensor(gains), dtype=torch.float64)
    assert t_tr.r.shape == (4, 250)
    for name in j_tr._fields:
        _close(getattr(t_tr, name), getattr(j_tr, name))
    assert j_m.keys() == t_m.keys()
    for key in j_m:
        assert t_m[key].shape == (4,)
        _close(t_m[key], j_m[key])
    # the uncontrolled shot stays out of bounds; the controlled ones leave after two ticks
    assert float(t_m["disruption_fraction"][-1]) == 1.0
    assert float(t_m["disruption_fraction"][:-1].max()) < 0.05


def test_single_call_is_its_row_of_the_batch():
    params = tf.FlightSimParams(**KW)
    gains = torch.tensor(_gains(7, 3))
    batch, b_m = tf.run_shot_reduced_gains(params, gains, dtype=torch.float64)
    for i in range(3):
        one, o_m = tf.run_shot_reduced_gains(params, gains[i], dtype=torch.float64)
        assert one.r.shape == (250,) and o_m["r_err_p95"].shape == ()
        for name in one._fields:
            assert torch.equal(getattr(one, name), getattr(batch, name)[i])
        for key in o_m:
            assert torch.equal(o_m[key], b_m[key][i])


def test_leading_batch_shape():
    params = tf.FlightSimParams(control_hz=1000.0, shot_duration_s=0.05)
    gains = torch.tensor(rng(8).uniform(0.1, 3.0, (2, 3, 6)))
    tr, m = tf.run_shot_reduced_gains(params, gains, dtype=torch.float64)
    flat, fm = tf.run_shot_reduced_gains(params, gains.reshape(6, 6), dtype=torch.float64)
    assert tr.r.shape == tr.ip_ma.shape == (2, 3, 50) and m["r_err_final"].shape == (2, 3)
    assert torch.equal(tr.heating_mw.reshape(6, 50), flat.heating_mw)
    assert torch.equal(m["z_err_p95"].reshape(6), fm["z_err_p95"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wrapper_runs_the_plain_loop_on_the_cpu(dtype):
    params = tf.FlightSimParams(control_hz=1000.0, shot_duration_s=0.04, delay_steps=3)
    gains = torch.tensor(rng(9).uniform(0.0, 1.0, (5, 6)), dtype=dtype)
    heat = torch.linspace(20.0, 80.0, 40, dtype=dtype)
    cb.reset_launch_counts()
    out = crs.reduced_shot(params, gains, heat)
    ref = crs.reduced_shot_plain(params, gains, heat)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert out.r.shape == (5, 40) and out.r.dtype == dtype
    assert sum(cb.CALLS.values()) == 0 and sum(cb.LAUNCHES.values()) == 0


def test_kernel_checks():
    """What the kernel does not take raises before any launch: a delay line
    longer than its registers hold, CPU tensors, a stress call without its
    draws."""
    gains = torch.zeros((2, 6))
    heat = torch.zeros(5)
    long = tf.FlightSimParams(delay_steps=crs.MAX_DELAY + 1)
    with pytest.raises(ValueError, match="delay"):
        crs.check_reduced_shot(long, gains, heat, None, None, None)
    with pytest.raises(ValueError, match="CUDA"):
        crs.check_reduced_shot(tf.FlightSimParams(), gains, heat, None, None, None)
    with pytest.raises(ValueError, match="drift and draws"):
        crs.check_reduced_shot(tf.FlightSimParams(), gains[:1], heat, None, None, object())


def test_argument_block_matches_the_kernel_source():
    """``_Args`` lists ``ReducedShotArgs`` of ``csrc/reduced_shot.cu`` field
    for field, with C types of the same size; ``launch_args`` points every
    field at its tensor and passes the host-side constants as the plain
    loop computes them."""
    import re
    from pathlib import Path

    src = (Path(crs.__file__).resolve().parent.parent / "csrc" / "reduced_shot.cu").read_text()
    body = src[src.index("struct ReducedShotArgs {"):src.index("};", src.index("ReducedShotArgs"))]
    fields = []
    for ctype, names in re.findall(r"^\s*(const void\*|void\*|int|double)\s+([\w, ]+);", body,
                                   re.M):
        fields += [(n.strip(), "ptr" if "*" in ctype else ctype) for n in names.split(",")]
    kinds = {"c_void_p": "ptr", "c_int": "int", "c_double": "double"}
    assert fields == [(n, kinds[t.__name__]) for n, t in crs._Args._fields_]
    assert f"constexpr int MAX_DELAY = {crs.MAX_DELAY};" in src
    params = tf.FlightSimParams(control_hz=2000.0, delay_steps=3)
    gains, heat = torch.zeros((7, 6)), torch.zeros(11)
    args, out = crs.launch_args(params, gains, heat, None, None, None)
    assert (args.n_shots, args.n_ticks, args.gain_stride, args.n_delay, args.stress) == (
        7, 11, 6, 3, 0)
    assert args.gains == gains.data_ptr() and args.draws is None
    assert args.trace_heating == out[3].data_ptr() and out[3].shape == (11, 7)
    assert args.pf_slew == params.pf_rate_limit * params.control_dt
    assert args.z_step == 0.02 * params.control_dt and args.r0 == params.target_r + 0.1


def test_default_device_is_the_card():
    """With no ``device`` the reduced shot runs on CUDA; without a card it
    raises instead of falling back to the CPU."""
    params = tf.FlightSimParams(control_hz=1000.0, shot_duration_s=0.002)
    if torch.cuda.is_available():
        tr, _ = tf.run_shot_reduced(params)
        assert tr.r.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            tf.run_shot_reduced(params)
