"""Port parity: the local kinetic dispersion relation
(``models/gyrokinetics/local_dispersion.py``).

The most-unstable root matches JAX's within 1e-9 at the JAX tests' points
(CBC ITG, the stable gradient, kinetic trapped electrons with and without
the passing-electron Landau response and the boundary layer), and at four
k_y of the ITG spectrum of ``validation/run_gk_growth_rates.py:60-100`` as
one batch (the card runs all 11 in ``chip_smoke.py``'s (v)); a growing
root's omega_r is held too (a stable point's omega_r is whichever of the
round-off-converged roots the fallback picks, in JAX as here).  A batch of
k_y and gradients equals the single calls.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scpn_fusion_tpu.models.gyrokinetics import local_dispersion as jld
from scpn_fusion_tpu.models.gyrokinetics.species import VelocityGrid as JVG
from scpn_fusion_tpu_torch.models.gyrokinetics import local_dispersion as tld
from scpn_fusion_tpu_torch.models.gyrokinetics.species import VelocityGrid as TVG

TOL = 1e-9
CASES = {
    "cbc": dict(r_l_t=6.9, r_l_n=2.2),
    "stable": dict(r_l_t=1.0, r_l_n=2.2),
    "tem": dict(r_l_t=6.9, r_l_n=2.2, kinetic_electrons=True, r_l_te=6.9, nu_detrap=0.1),
    "landau": dict(r_l_t=6.9, r_l_n=2.2, kinetic_electrons=True, r_l_te=6.9, nu_detrap=0.1,
                   passing_landau=True, omega_bl=0.3, drift_envelope=0.35, s_hat=1.2),
}
SMALL = dict(n_energy=12, n_lambda=8)


def _same_root(ours, ref):
    assert bool(ours.converged) == bool(ref.converged)
    assert abs(float(ours.gamma) - float(ref.gamma)) <= TOL * max(abs(float(ref.gamma)), 1.0)
    if float(ref.gamma) > 0.0:
        assert abs(float(ours.omega_r) - float(ref.omega_r)) <= TOL * abs(float(ref.omega_r))
    assert float(ours.residual) < 1e-6 or not bool(ref.converged)


@pytest.mark.parametrize("case", list(CASES))
def test_root_matches(case):
    kw = CASES[case]
    grid = {} if case in ("cbc", "stable") else SMALL
    ours = tld.solve_local_kinetic_dispersion(0.5, device="cpu", vgrid=TVG(**grid) if grid
                                              else TVG(24, 16), **kw)
    ref = jld.solve_local_kinetic_dispersion(0.5, vgrid=JVG(**grid) if grid else JVG(24, 16),
                                             **kw)
    assert ours.gamma.dtype == torch.float64 and ours.gamma.shape == ()
    _same_root(ours, ref)
    if case == "cbc":
        assert float(ours.gamma) > 0.0 and float(ours.omega_r) < 0.0
    if case == "stable":
        assert float(ours.gamma) < 0.01


def test_itg_spectrum_of_the_growth_rate_campaign():
    """``run_gk_growth_rates.py``'s lane 1 at four of its 11 k_y on the ITG
    fixture, in one batch, against JAX's per-k_y calls."""
    import json
    from pathlib import Path
    fixture = json.loads((Path(__file__).resolve().parent.parent / "validation" / "configs"
                          / "tglf_reference" / "itg_dominated.json").read_text())
    p = fixture["input_parameters"]
    kys = np.linspace(0.15, 0.9, 11)[::3]
    kw = dict(r_l_t=p["R_LT_i"], r_l_n=p["R_Ln_e"], tau=1.0, q=p["q"])
    ours = tld.solve_local_kinetic_dispersion(torch.from_numpy(kys), **kw)
    assert ours.gamma.shape == (4,) and bool(ours.converged.all())
    for i, ky in enumerate(kys):
        ref = jld.solve_local_kinetic_dispersion(jnp.asarray(ky), **kw)
        _same_root(type(ours)(*(x[i] for x in ours)), ref)
    omega_r, gamma = tld.growth_rate_spectrum(kys, device="cpu", **kw)
    assert torch.equal(gamma, ours.gamma) and torch.equal(omega_r, ours.omega_r)


def test_batched_parameters_equal_single_calls():
    kys = torch.tensor([0.3, 0.6], dtype=torch.float64)
    r_l_t = torch.tensor([[6.9], [9.0]], dtype=torch.float64)
    out = tld.solve_local_kinetic_dispersion(kys, r_l_t=r_l_t, r_l_n=2.2, vgrid=TVG(**SMALL))
    assert out.gamma.shape == (2, 2)
    for i in range(2):
        for j in range(2):
            one = tld.solve_local_kinetic_dispersion(float(kys[j]), r_l_t=float(r_l_t[i, 0]),
                                                     r_l_n=2.2, vgrid=TVG(**SMALL),
                                                     device="cpu")
            assert abs(float(one.gamma) - float(out.gamma[i, j])) <= 1e-12
