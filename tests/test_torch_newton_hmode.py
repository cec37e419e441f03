"""Port parity: the Newton-Krylov solve in H-mode at 33^2, against the JAX
package on the CPU in float64 -- the same Newton iterations, the residual
history within 1e-6 relative, psi within 1e-9 span-relative (kept apart from
``tests/test_torch_newton.py``, whose check it uses, so each file stays
short); and the entry point's default device."""

import pytest
import torch
from test_torch_newton import assert_newton_parity, newton_cfgs

from scpn_fusion_tpu_torch.models.equilibrium import newton as tn


def test_newton_hmode_matches_jax():
    assert_newton_parity(33, "h-mode")


def test_default_device_is_the_card():
    """With no ``device`` the solve runs on CUDA; without a card it raises
    instead of falling back to the CPU."""
    _, cfg = newton_cfgs(17, "l-mode")
    if torch.cuda.is_available():
        assert tn.solve_equilibrium_newton(cfg, max_newton=1).psi.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            tn.solve_equilibrium_newton(cfg, max_newton=1)
