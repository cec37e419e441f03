"""The guiding-centre orbit as a hand-written CUDA kernel (``csrc/orbits.cu``;
row F).

:func:`gc_ensemble` integrates a whole fast-ion population -- every RK4
step of every guiding centre, with the wall and bounce flags and the energy
audit of the JAX package's ``follow_ensemble``
(``models/physics/fast_ions.py:146-227``) -- in ONE launch, one thread a
particle, and adds one to ``cb.CALLS["gc_ensemble"]``.  :func:`gc_orbit`
integrates one orbit of ``run_guiding_center`` (``orbits.py:90-123``) with
its (R, Z) trace in one launch of one thread, and adds one to
``cb.CALLS["gc_orbit"]``.  Both take the analytic field
``fast_ions.tokamak_field`` (its five parameters are constants of the
kernel).  The JAX package has no Pallas kernel here: its population is one
``vmap`` of a ``lax.scan`` in one compiled program, and this launch takes
that program's place.

On a CPU tensor the wrappers run the kernel's plain versions,
:func:`gc_ensemble_plain` and :func:`gc_orbit_plain`, the loops of the
port's ``fast_ions.ensemble_step`` and ``orbits.gc_rk4_step`` over the
particles as one batch, which also serve any other field callable.  On a
CUDA tensor they launch the kernel or raise; an input that requires a
gradient raises on every device (the kernel has no backward, and needs
none: no JAX caller differentiates through an orbit).
"""

from __future__ import annotations

import ctypes

import torch

from scpn_fusion_tpu_torch.ops import _cuda_build as cb

_ENSEMBLE = {torch.float32: "scpn_gc_ensemble_f32", torch.float64: "scpn_gc_ensemble_f64"}
_ORBIT = {torch.float32: "scpn_gc_orbit_f32", torch.float64: "scpn_gc_orbit_f64"}
# the constants the kernel reads, in the order of ``csrc/orbits.cu``'s ``Const``:
# ``orbits.step_constants``, ``TokamakField.constants``, the walls
STEP = ("m", "q", "dt", "half_dt", "dt6", "half_m")
WALLS = ("r_in", "r_out", "z_wall")


class _Args(ctypes.Structure):
    """``OrbitArgs`` of ``csrc/orbits.cu``, field for field."""

    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "consts", "state", "final", "lost", "bounced", "drift", "trace_r", "trace_z")]
        + [("n", ctypes.c_int), ("n_steps", ctypes.c_int)])


def gc_ensemble_plain(c: dict, b_field, state: torch.Tensor, n_steps: int):
    """The step loop the kernel replaces: from ``state`` (5, n) -- R, Z,
    phi, v_par, mu -- with the constants ``c``
    (``fast_ions.ensemble_constants``), (final (n, 4), lost (n,) bool,
    bounced (n,) bool, |E_f - E_0| / E_0 (n,))."""
    from scpn_fusion_tpu_torch.models.physics.fast_ions import ensemble_energy, ensemble_step

    *y, mu = state.unbind()
    y = tuple(y)
    sign0 = torch.sign(y[3])
    e0 = ensemble_energy(c, b_field, y, mu)
    lost = torch.zeros_like(mu, dtype=torch.bool)
    bounced = torch.zeros_like(lost)
    for _ in range(n_steps):
        y, lost, bounced = ensemble_step(c, b_field, y, mu, lost, bounced, sign0)
    drift = torch.div(torch.abs(ensemble_energy(c, b_field, y, mu) - e0), e0)
    return torch.stack(y, dim=1), lost, bounced, drift


def gc_orbit_plain(c: dict, b_field, state: torch.Tensor, n_steps: int):
    """The step loop of one orbit from ``state`` (5,) with the constants
    ``c`` (``orbits.step_constants``): (final (4,), R trace, Z trace), the
    traces (n_steps,)."""
    from scpn_fusion_tpu_torch.models.physics.orbits import gc_orbit_loop

    *y, mu = state.unbind()
    y, r_tr, z_tr = gc_orbit_loop(c, b_field, tuple(y), mu, n_steps)
    return torch.stack(y), r_tr, z_tr


def kernel_constants(c: dict, b_field, walls: bool) -> torch.Tensor:
    """The constants array the kernel reads: the step's, the field's and,
    for the ensemble, the walls'.  Row F evaluates the analytic field alone."""
    from scpn_fusion_tpu_torch.models.physics.fast_ions import TokamakField

    if not isinstance(b_field, TokamakField):
        raise TypeError(f"row F evaluates fast_ions.tokamak_field only, got {b_field!r}")
    field = b_field.constants(c["m"].dtype, c["m"].device)
    return torch.stack([*(c[k] for k in STEP), *(field[k] for k in b_field.CONSTANTS),
                        *((c[k] for k in WALLS) if walls else ())])


def check_inputs(name: str, consts: torch.Tensor, state: torch.Tensor, rows: int) -> None:
    """Raise unless row F takes these tensors: ``state`` a float32 or float64
    CUDA tensor of ``rows`` rows (and at least one column), the constants of
    its dtype."""
    if state.dtype not in _ENSEMBLE:
        raise TypeError(f"{name}: float32 or float64, got {state.dtype}")
    for arg, t in (("consts", consts), ("state", state)):
        if not t.is_cuda:
            raise ValueError(f"{name}: {arg} must be a CUDA tensor, got {t.device}")
        if t.dtype != state.dtype:
            raise TypeError(f"{name}: {arg} is {t.dtype}, the state {state.dtype}")
    if state.shape[0] != rows or (state.dim() == 2 and state.shape[1] < 1) or state.dim() > 2:
        raise ValueError(f"{name}: the state must be ({rows}, n) or ({rows},), got "
                         f"{tuple(state.shape)}")


def _reject_gradients(name: str, c: dict, state: torch.Tensor) -> None:
    for arg, t in (("state", state), *c.items()):
        if t.requires_grad:
            raise RuntimeError(f"{name}: row F has no backward; {arg} requires a gradient")


def _pointer(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def gc_ensemble(c: dict, b_field, state: torch.Tensor, n_steps: int):
    """:func:`gc_ensemble_plain`'s results, in one launch on the card."""
    _reject_gradients("gc_ensemble", c, state)
    if not state.is_cuda:
        return gc_ensemble_plain(c, b_field, state, n_steps)
    consts = kernel_constants(c, b_field, walls=True)
    check_inputs("gc_ensemble", consts, state, 5)
    state = state.contiguous()
    n = state.shape[1]
    final = torch.empty((n, 4), dtype=state.dtype, device=state.device)
    lost = torch.empty(n, dtype=torch.uint8, device=state.device)
    bounced = torch.empty_like(lost)
    drift = torch.empty(n, dtype=state.dtype, device=state.device)
    args = _Args(*(_pointer(t) for t in (consts, state, final, lost, bounced, drift, None, None)),
                 n=n, n_steps=n_steps)
    cb.launch(_ENSEMBLE[state.dtype], ctypes.addressof(args))
    cb.CALLS["gc_ensemble"] += 1
    return final, lost.bool(), bounced.bool(), drift


def gc_orbit(c: dict, b_field, state: torch.Tensor, n_steps: int):
    """:func:`gc_orbit_plain`'s results, in one launch of one thread on the
    card."""
    _reject_gradients("gc_orbit", c, state)
    if not state.is_cuda:
        return gc_orbit_plain(c, b_field, state, n_steps)
    consts = kernel_constants(c, b_field, walls=False)
    check_inputs("gc_orbit", consts, state, 5)
    state = state.contiguous()
    final = torch.empty(4, dtype=state.dtype, device=state.device)
    r_tr = torch.empty(n_steps, dtype=state.dtype, device=state.device)
    z_tr = torch.empty_like(r_tr)
    args = _Args(*(_pointer(t) for t in (consts, state, final, None, None, None, r_tr, z_tr)),
                 n=1, n_steps=n_steps)
    cb.launch(_ORBIT[state.dtype], ctypes.addressof(args))
    cb.CALLS["gc_orbit"] += 1
    return final, r_tr, z_tr
