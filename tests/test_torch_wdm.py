"""Port parity: the whole-device-model driver (``models/wdm``).

float64 on the CPU, the JAX package's discharge started from its float64
initial state.  ``tests/test_wdm.py``'s three discharges (40 steps with and
without impurity penetration; 60 steps of the radiative-collapse scenario,
whose latch trips mid-run): every trace within 1e-12 of JAX (relative to
its largest value), the latch flags and the collapse time EQUAL, the final
state within 1e-12.  The EOS and the redeposition fraction within 1e-15;
the JAX tests' gates hold on the port.  The collapse latch is a tensor
``torch.where``: no step reads the host.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel

from scpn_fusion_tpu.models import wdm as jw
from scpn_fusion_tpu.models.transport import solver as jsol
from scpn_fusion_tpu_torch import interop
from scpn_fusion_tpu_torch.models import wdm as tw

F64 = torch.float64
CASES = {
    "accumulates": (dict(dt_s=0.01, p_aux_mw=50.0, core_penetration=1e-2), 40),
    "collapse": (dict(dt_s=0.05, p_aux_mw=0.0, core_penetration=50.0, collapse_te_kev=0.5), 60),
    "clean": (dict(dt_s=0.01, p_aux_mw=50.0, core_penetration=0.0), 40),
}


def run_pair(case: str):
    kw, n = CASES[case]
    tp = jsol.TransportParams(nr=32, picard_max_iter=5)
    jcfg = jw.WDMConfig(transport=tp, **kw)
    ref = jw.run_discharge(jcfg, jsol.initial_state(tp, jnp.float64), n_steps=n)
    tcfg = tw.WDMConfig(transport=interop.transport_params(dataclasses.asdict(tp)), **kw)
    ours = tw.run_discharge(tcfg, tw.default_initial_state(tcfg, F64, "cpu"), n_steps=n)
    return ref, ours


@pytest.mark.parametrize("case", sorted(CASES))
def test_discharge_matches_jax(case):
    ref, ours = run_pair(case)
    for name in ref._fields[:-2]:
        assert rel(getattr(ours, name), getattr(ref, name)) <= 1e-12, name
    assert np.array_equal(ours.collapsed.numpy(), np.asarray(ref.collapsed))
    assert ours.collapsed.dtype == torch.bool
    for name, a in ours.final_state._asdict().items():
        assert rel(a, getattr(ref.final_state, name)) <= 1e-12, name
    assert tw.collapse_time_s(ours) == jw.collapse_time_s(ref)
    if case == "collapse":
        k = int(np.argmax(ours.collapsed.numpy()))
        assert 0 < k < 58
        te = ours.te_core_kev.numpy()
        assert np.all(te[k + 1:] == te[k + 1])                  # latched: frozen
        assert tw.collapse_time_s(ours) == pytest.approx(float(ours.time_s[k]), rel=1e-12)
    elif case == "clean":
        assert tw.collapse_time_s(ours) is None
        assert float(ours.w_impurity_total[-1]) == pytest.approx(0.0, abs=1e-8)
    else:
        w = ours.w_impurity_total.numpy()
        assert np.all(np.diff(w) >= -1e-6)
        f = ours.redeposition_fraction.numpy()
        assert np.all((f >= 0.0) & (f <= 0.99))
        assert np.allclose(ours.time_s.numpy(), 0.01 * np.arange(1, 41), rtol=1e-12)


def test_eos_and_redeposition_match_jax():
    n = np.array([1e19, 1e20, 1e30])
    t = np.array([1e4, 1.0, 0.0])
    assert rel(tw.thomas_fermi_pressure(n, t, dtype=F64, device="cpu"),
               jw.thomas_fermi_pressure(jnp.asarray(n), jnp.asarray(t))) <= 1e-15
    b = np.array([1.0, 5.0, 20.0])
    assert rel(tw.redeposition_fraction(b, 1e19, dtype=F64, device="cpu"),
               jw.redeposition_fraction(jnp.asarray(b), 1e19)) <= 1e-15
    p_hot = float(tw.thomas_fermi_pressure(1e20, 1e4, dtype=F64, device="cpu"))
    assert p_hot == pytest.approx(1e20 * 1e4 * 1.602176634e-19, rel=1e-3)
    f = tw.redeposition_fraction(5.0, 1e22, dtype=F64, device="cpu")
    assert float(f) == pytest.approx(0.95, abs=0.05)


def test_entry_points_default_to_cuda():
    cfg = tw.WDMConfig()
    for run in (lambda: tw.default_initial_state(cfg), lambda: tw.thomas_fermi_pressure(1.0, 1.0),
                lambda: tw.redeposition_fraction(5.0, 1e19)):
        with pytest.raises((RuntimeError, AssertionError)):
            run()
