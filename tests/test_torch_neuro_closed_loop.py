"""Port parity: the neuro-symbolic closed loop
(``control/neuro_closed_loop.py``) and the closed-loop kernel's wrapper
(``ops/cuda_closed_loop.py``).

The R/Z controller of ``validation/run_control_latency.py:23-42`` against
the reduced plant from (6.5, 0.3), 500 ticks in float64, in fractional mode
(margin 0.5) and in binary mode, with and without a delay ring: the traces
and the final controller and plant states within 1e-12 of JAX.  On the CPU
the wrapper runs its plain version (the per-tick loop); its guards refuse a
configuration that draws random numbers and tensors off the card.  A
configuration that draws runs the per-tick loop, deterministic by tick.  The
custom-plant loop is held to JAX with a linear plant.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_np

from scpn_fusion_tpu.control import neuro_closed_loop as jn
from scpn_fusion_tpu.scpn import controller as jc
from scpn_fusion_tpu.scpn.structure import StochasticPetriNet as JNet
from scpn_fusion_tpu_torch.bench_config import RZ_SPECS, rz_net
from scpn_fusion_tpu_torch.control import neuro_closed_loop as tn
from scpn_fusion_tpu_torch.ops import cuda_closed_loop as ccl
from scpn_fusion_tpu_torch.scpn import controller as tc
from scpn_fusion_tpu_torch.scpn.structure import StochasticPetriNet as TNet

TOL = 1e-12
N_TICKS, DT = 500, 1e-3


def _pair(delays=False):
    """The R/Z controller in both packages; with ``delays`` the odd
    transitions fire one tick late."""
    ticks = (0, 1, 0, 1) if delays else (0, 0, 0, 0)
    ref = jc.build_controller(rz_net(JNet, ticks), dtype=jnp.float64, **RZ_SPECS)
    ours = tc.build_controller(rz_net(TNet, ticks), dtype=torch.float64, device="cpu",
                               **RZ_SPECS)
    return ref, ours


def _close(ours, ref, what):
    a, b = as_np(ours), np.asarray(ref, np.float64)
    assert a.shape == b.shape, what
    assert float(np.max(np.abs(a - b), initial=0.0)) <= TOL * max(np.max(np.abs(b)), 1.0), what


CASES = {
    "fractional": dict(firing_mode="fractional", firing_margin=0.5),
    "binary": dict(firing_mode="binary"),
    "fractional_delay": dict(firing_mode="fractional", firing_margin=0.5, max_delay_ticks=2),
    "binary_margin_one_pass": dict(firing_mode="binary", sc_binary_margin=0.1),
}


@pytest.mark.parametrize("name", list(CASES))
def test_closed_loop_500_ticks(name):
    kw = CASES[name]
    delays = kw.get("max_delay_ticks", 0) > 0
    ref_ctrl, ctrl = _pair(delays)
    jcfg, tcfg = jc.ControllerConfig(dt=DT, **kw), tc.ControllerConfig(dt=DT, **kw)
    assert not tc.needs_draws(tcfg)
    jcs, jps, jtr = jn.run_neuro_closed_loop(
        ref_ctrl, jcfg, jn.ReducedPlantState(jnp.float64(6.5), jnp.float64(0.3)),
        n_ticks=N_TICKS, dt=DT)
    cs, ps, tr = tn.run_neuro_closed_loop(
        ctrl, tcfg, tn.ReducedPlantState(torch.tensor(6.5, dtype=torch.float64),
                                         torch.tensor(0.3, dtype=torch.float64)),
        n_ticks=N_TICKS, dt=DT)
    for key in jtr:
        _close(tr[key], jtr[key], key)
    assert tr["firing"].shape == (N_TICKS, 4)
    for field in jcs._fields:
        _close(getattr(cs, field), getattr(jcs, field), field)
    for field in jps._fields:
        _close(getattr(ps, field), getattr(jps, field), field)


def test_sampled_loop_is_deterministic_by_tick():
    _, ctrl = _pair()
    tcfg = tc.ControllerConfig(firing_mode="fractional", firing_margin=0.5, sc_n_passes=8,
                               dt=DT)
    assert tc.needs_draws(tcfg)
    plant0 = tn.ReducedPlantState(torch.tensor(6.5, dtype=torch.float64),
                                  torch.tensor(0.3, dtype=torch.float64))
    runs = [tn.run_neuro_closed_loop(ctrl, tcfg, plant0, n_ticks=60, dt=DT) for _ in range(2)]
    for key in runs[0][2]:
        assert torch.equal(runs[0][2][key], runs[1][2][key])
    f = runs[0][2]["firing"]
    assert torch.all((f * 8) == torch.round(f * 8))     # counts of 8 passes


def test_wrapper_guards():
    _, ctrl = _pair()
    plant0 = (torch.tensor(6.5, dtype=torch.float64), torch.tensor(0.3, dtype=torch.float64))
    sampled = tc.ControllerConfig(firing_mode="fractional", sc_n_passes=4)
    flips = tc.ControllerConfig(firing_mode="fractional", sc_bitflip_rate=0.1)
    for cfg in (sampled, flips):
        with pytest.raises(ValueError, match="deterministic"):
            ccl.check_closed_loop(ctrl, cfg, plant0, 10)
    with pytest.raises(ValueError, match="CUDA"):
        ccl.check_closed_loop(ctrl, tc.ControllerConfig(firing_mode="fractional"), plant0, 10)


def test_custom_plant_matches_jax():
    ref_ctrl, ctrl = _pair()
    jcfg, tcfg = (m.ControllerConfig(firing_mode="fractional", firing_margin=0.5, dt=DT)
                  for m in (jc, tc))
    a = np.asarray([[0.99, 0.01], [0.0, 1.002]])

    def j_plant(x, u):
        x2 = jnp.asarray(a) @ x + DT * u
        return x2, x2

    def t_plant(x, u):
        x2 = torch.tensor(a) @ x + DT * u
        return x2, x2

    x0 = np.asarray([6.5, 0.3])
    jcs, jps, jtr = jn.run_closed_loop_custom_plant(ref_ctrl, jcfg, j_plant, jnp.asarray(x0),
                                                    jnp.asarray(x0), n_ticks=50)
    cs, ps, tr = tn.run_closed_loop_custom_plant(ctrl, tcfg, t_plant, torch.tensor(x0),
                                                 torch.tensor(x0), n_ticks=50)
    for key in jtr:
        _close(tr[key], jtr[key], key)
    _close(ps, jps, "plant")


def test_argument_block_matches_the_kernel_source():
    """``_Args`` lists ``ClosedLoopArgs`` of ``csrc/closed_loop.cu`` field
    for field, with C types of the same size; ``launch_args`` points every
    field at the tensor of that name and starts from the initial state."""
    import re
    from pathlib import Path

    src = (Path(ccl.__file__).resolve().parent.parent / "csrc" / "closed_loop.cu").read_text()
    body = src[src.index("struct ClosedLoopArgs {"):src.index("};", src.index("ClosedLoopArgs"))]
    fields = []
    for ctype, names in re.findall(r"^\s*(const void\*|void\*|const int\*|int\*|const unsigned "
                                   r"char\*|int|double)\s+([\w, ]+);", body, re.M):
        fields += [(n.strip(), "ptr" if "*" in ctype else ctype) for n in names.split(",")]
    kinds = {"c_void_p": "ptr", "c_int": "int", "c_double": "double"}
    assert fields == [(n, kinds[t.__name__]) for n, t in ccl._Args._fields_]
    _, ctrl = _pair(delays=True)
    cfg = tc.ControllerConfig(firing_mode="fractional", max_delay_ticks=2, dt=DT)
    plant0 = (torch.tensor(6.5, dtype=torch.float64), torch.tensor(0.3, dtype=torch.float64))
    args, state, trace, threads = ccl.launch_args(ctrl, cfg, plant0, n_ticks=7, dt=DT)
    assert (args.n_p, args.n_t, args.n_i, args.n_act, args.n_slots, args.n_ticks) == (
        8, 4, 4, 2, 3, 7)
    assert threads == 32 and args.mode == 0 and args.margin == cfg.firing_margin
    assert args.w_in == ctrl.w_in.data_ptr() and args.inj_is_pos == ctrl.inj_is_pos.data_ptr()
    assert args.trace_firing == trace["firing"].data_ptr() and trace["firing"].shape == (7, 4)
    assert torch.equal(state[0], ctrl.initial_marking) and state[1].shape == (3, 4)
    assert args.plant == state[4].data_ptr() and state[4].tolist() == [6.5, 0.3]
