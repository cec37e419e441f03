"""Port parity: the NEF spiking control channel (``control/nef_snn.py``).

The population makers take a numpy ``Generator`` as in the JAX package:
the same seed gives the same neurons (gains, biases and encoders equal).
Float64 (JAX x64): the steady rates and the Tikhonov decoders within 1e-9,
one LIF step within 1e-12, and a 400-tick ``run_channel`` of a step and of
a sine through the carried-across channel within 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel

from scpn_fusion_tpu.control import nef_snn as jn
from scpn_fusion_tpu_torch import interop
from scpn_fusion_tpu_torch.control import nef_snn as tn

F64 = torch.float64
CFG = dict(n_neurons=80, seed=3, gain=0.8)


def test_populations_and_decoders_match_jax():
    jcfg, tcfg = jn.NefConfig(**CFG), tn.NefConfig(**CFG)
    pop_j = jn.make_lif_population(jcfg, np.random.default_rng(5), jnp.float64)
    pop_t = tn.make_lif_population(tcfg, np.random.default_rng(5), F64, "cpu")
    for a, b in zip(pop_t, pop_j):
        assert np.array_equal(a.numpy(), np.asarray(b))
    x = np.linspace(-1, 1, 50)
    assert rel(tn.steady_rates(tcfg, pop_t, torch.from_numpy(x)),
                jn.steady_rates(jcfg, pop_j, jnp.asarray(x))) <= 1e-9
    ch_j = jn.make_channel(jcfg, jnp.float64)
    ch_t = tn.make_channel(tcfg, F64, "cpu")
    assert rel(ch_t.d_gain, ch_j.d_gain) <= 1e-9 and rel(ch_t.d_id, ch_j.d_id) <= 1e-9
    st_j, r_j = jn.lif_step(jcfg, pop_j, jn.lif_init(jcfg, jnp.float64), 0.4)
    st_t, r_t = tn.lif_step(tcfg, pop_t, tn.lif_init(tcfg, F64, "cpu"), 0.4)
    assert rel(st_t.voltage, st_j.voltage) <= 1e-12 and np.array_equal(r_t.numpy(),
                                                                       np.asarray(r_j))


@pytest.mark.parametrize("signal", ["step", "sine"])
def test_channel_run_matches_jax(signal):
    jcfg, tcfg = jn.NefConfig(**CFG), tn.NefConfig(**CFG)
    ch_j = jn.make_channel(jcfg, jnp.float64)
    t = np.arange(400) * jcfg.dt
    x = np.where(t > 0.05, 0.6, 0.0) if signal == "step" else 0.7 * np.sin(12.0 * t)
    ref = jn.run_channel(jcfg, ch_j, jnp.asarray(x))
    ours = tn.run_channel(tcfg, interop.nef_channel(ch_j, device="cpu"), torch.from_numpy(x))
    assert rel(ours, ref) <= 1e-9


def test_nengo_reported_as_in_jax():
    assert tn.nengo_available() == jn.nengo_available()


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert tn.make_channel(tn.NefConfig(n_neurons=8)).d_gain.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            tn.make_channel(tn.NefConfig(n_neurons=8))
