"""One RK4 stage of the nonlinear gyrokinetic right-hand side as a
hand-written CUDA kernel (``csrc/gk_rhs.cu``, row G).

:func:`gk_stage` takes a stage's input ``fin``, the step's base ``f0``, the
RK accumulator and the terms made outside the kernel (:class:`StageTerms`:
the potentials, the masked ExB bracket, the conservative collision term and
the four ballooning-twisted theta planes), computes the right-hand side of
every species pointwise -- parallel streaming, magnetic drift, collisions,
hyperdiffusion, gradient drive, zonal damping -- and writes the next stage's
input and the accumulator, in ONE launch, complex64 or complex128, adding one
to ``cb.CALLS["gk_rhs"]``.  The JAX package has no Pallas kernel here: its
``gk_rhs`` and ``rk4_step`` (``models/gyrokinetics/nonlinear.py:395-461``) are
one jitted XLA program, and this launch takes the place of that program's
pointwise body.

On a CPU tensor the wrapper runs the kernel's plain version,
:func:`gk_stage_plain`: the same terms in the JAX package's operation order
on whole-array ops.  On a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from scpn_fusion_tpu_torch.ops import _cuda_build as cb

_ENTRIES = {torch.complex64: "scpn_gk_stage_c64", torch.complex128: "scpn_gk_stage_c128"}


class _Args(ctypes.Structure):
    """``GKStageArgs`` of ``csrc/gk_rhs.cu``, field for field."""

    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "f0", "fin", "acc_in", "next", "acc_out", "bracket", "coll", "tw", "phi", "a_par",
        "b_par", "dt", "vpar", "mu", "b_ratio", "kappa_n", "kappa_g", "b_dot_grad", "ky",
        "kperp2", "maxwellian", "energy")]
        + [("n_total", ctypes.c_longlong)]
        + [(name, ctypes.c_int) for name in (
            "n_species", "n_kx", "n_ky", "n_theta", "n_vpar", "n_mu", "n_acc", "stage",
            "electrons_active", "nonlinear", "krook", "coll_input", "electromagnetic",
            "hyper_p", "zonal")]
        + [(name, ctypes.c_double) for name in (
            "d_theta", "v_scale_e", "nu", "hyper_coeff", "zonal_rate", "r_l_ne", "eta_i",
            "eta_e")])


class GKStageSpec(NamedTuple):
    """What a stage needs of the configuration: the grids' tables (real
    tensors; ``grids`` is the run's ``GKGrids``) and the scalars as numbers
    rounded to the run's real dtype (``d_theta``, ``v_scale_e``) or as the
    configuration gives them."""

    grids: NamedTuple
    n_species: int
    electrons_active: bool       # kinetic electrons
    nonlinear: bool
    collision: str | None        # "krook", "conservative" or None
    electromagnetic: bool
    nu: float
    hyper_coeff: float
    hyper_p: int
    zonal_rate: float
    r_l_ne: float
    eta_i: float
    eta_e: float
    d_theta: float
    v_scale_e: float

    @property
    def n_acc(self) -> int:
        """The leading species whose right-hand side can be nonzero, which the
        RK accumulator holds: every species, or the ions alone when the
        electrons are adiabatic and undamped (their k is 0)."""
        return self.n_species if (self.electrons_active or self.zonal_rate > 0.0) else 1


class StageTerms(NamedTuple):
    """A stage's terms made outside the kernel.  ``bracket``, ``coll`` and
    ``tw`` hold the active species only (ions; electrons too when kinetic):
    ``tw`` (S_active, n_kx, n_ky, 4, n_vpar, n_mu) is e^{-i s ky x} of theta
    planes 0 and 1 and e^{+i s ky x} of planes n_theta-2 and n_theta-1."""

    phi: torch.Tensor
    tw: torch.Tensor
    bracket: torch.Tensor | None = None
    coll: torch.Tensor | None = None
    a_par: torch.Tensor | None = None
    b_par: torch.Tensor | None = None


def _theta_neighbours(f_s: torch.Tensor, tw_s: torch.Tensor):
    """f at theta + 2, + 1, - 1, - 2 (the planes of ``_roll_ballooning`` with
    shifts -2, -1, 1, 2), the wrapped planes taken from ``tw_s``."""
    return (torch.cat([f_s[:, :, 2:], tw_s[:, :, 0:2]], dim=2),
            torch.cat([f_s[:, :, 1:], tw_s[:, :, 0:1]], dim=2),
            torch.cat([tw_s[:, :, 3:4], f_s[:, :, :-1]], dim=2),
            torch.cat([tw_s[:, :, 2:4], f_s[:, :, :-2]], dim=2))


def drift_frequency(g) -> torch.Tensor:
    """omega_D, the curvature + grad-B drift frequency of every (ky, theta,
    vpar, mu), broadcast against one species' f: JAX's ``magnetic_drift``
    without its ``1j * ... * f``."""
    vpar2 = g.vpar[None, None, None, :, None] ** 2
    mu_b = g.mu[None, None, None, None, :] * g.b_ratio[None, None, :, None, None]
    energy = 0.5 * vpar2 + mu_b
    xi2 = torch.clamp(vpar2 / torch.clamp(vpar2 + 2.0 * mu_b, min=1e-30), min=0.0)
    kn = g.kappa_n[None, None, :, None, None]
    kg = g.kappa_g[None, None, :, None, None]
    return g.ky[None, :, None, None, None] * 2.0 * energy * (kn * xi2 + kg * torch.sqrt(xi2))


def gradient_drive(g, phi: torch.Tensor, a_par: torch.Tensor | None,
                   b_par: torch.Tensor | None, *, r_l_ne: float, eta_i: float, eta_e: float,
                   n_species: int, electrons_active: bool) -> torch.Tensor:
    """The omega_* drive of every species, stacked (JAX's ``gradient_drive``;
    ``a_par`` / ``b_par`` enter phi_eff where given)."""
    ky5 = g.ky[None, :, None, None, None]
    energy5 = g.energy[None, None, None, :, :]
    fm = g.maxwellian[None, None, None, :, :]
    phi_eff = phi[:, :, :, None, None]
    if a_par is not None:
        phi_eff = phi_eff - g.vpar[None, None, None, :, None] * a_par[:, :, :, None, None]
    if b_par is not None:
        phi_eff = phi_eff + g.mu[None, None, None, None, :] * b_par[:, :, :, None, None]
    omega_star_i = ky5 * r_l_ne * (1.0 + eta_i * (energy5 - 1.5))
    drive_i = -1j * omega_star_i * phi_eff * fm
    if n_species < 2:
        return drive_i[None]
    if electrons_active:
        omega_star_e = -ky5 * r_l_ne * (1.0 + eta_e * (energy5 - 1.5))
        drive_e = -1j * omega_star_e * phi_eff * fm
    else:
        drive_e = torch.zeros_like(drive_i)
    return torch.stack([drive_i, drive_e], dim=0)


def stage_rhs_plain(fin: torch.Tensor, terms: StageTerms, spec: GKStageSpec) -> torch.Tensor:
    """The right-hand side of every species, in ``gk_rhs``'s operation order
    (an inactive electron species: the zonal term alone)."""
    g = spec.grids
    vpar5 = g.vpar[None, None, None, :, None]
    bgrad5 = g.b_dot_grad[None, None, :, None, None]
    kperp5 = g.kperp2[:, :, None, None, None]
    omega_d = drift_frequency(g)
    out = []
    for s in range(fin.shape[0]):
        f_s = fin[s]
        if s > 0 and not spec.electrons_active:
            out.append(torch.zeros_like(f_s))
            continue
        p2, p1, m1, m2 = _theta_neighbours(f_s, terms.tw[s])
        dfdt = (-p2 + 8.0 * p1 - 8.0 * m1 + m2) / (12.0 * g.d_theta)
        stream = vpar5 * bgrad5 * dfdt
        t = -stream if s == 0 else -g.vth_ratio_e * stream
        drift = 1j * omega_d * f_s
        t = t - drift if s == 0 else t + drift
        if spec.nonlinear:
            t = t - terms.bracket[s]
        if spec.collision == "krook":
            t = t + -spec.nu * kperp5 * f_s
        elif spec.collision == "conservative":
            t = t + terms.coll[s]
        hyper = -spec.hyper_coeff * kperp5 ** spec.hyper_p * f_s
        out.append(t + hyper)
    dfdt = torch.stack(out, dim=0)
    dfdt = dfdt + gradient_drive(
        g, terms.phi, terms.a_par if spec.electromagnetic else None,
        terms.b_par if spec.electromagnetic else None, r_l_ne=spec.r_l_ne, eta_i=spec.eta_i,
        eta_e=spec.eta_e, n_species=fin.shape[0], electrons_active=spec.electrons_active)
    if spec.zonal_rate > 0.0:
        ky_zero = (torch.abs(g.ky)[None, :] < 1e-10).to(g.ky.dtype)
        dfdt = dfdt - spec.zonal_rate * fin * ky_zero[None, :, :, None, None, None]
    return dfdt


def _update(stage: int, f0, k, acc, dt, n_acc: int):
    """The RK4 bookkeeping of one stage: (next, acc); ``acc`` holds the first
    ``n_acc`` species of k1 + 2 k2 + 2 k3 (the rest of k is 0)."""
    k_acc = k[:n_acc]
    if stage == 3:
        return f0 + (dt / 6.0) * torch.cat([acc + k_acc, k[n_acc:]]), None
    acc = k_acc if stage == 0 else acc + 2.0 * k_acc
    c = dt if stage == 2 else 0.5 * dt
    return f0 + c * k, acc


def gk_stage_plain(stage: int, f0: torch.Tensor, fin: torch.Tensor, acc: torch.Tensor | None,
                   terms: StageTerms, dt: torch.Tensor, spec: GKStageSpec):
    """The kernel's plain version: (next stage's input, accumulator of the
    first ``spec.n_acc`` species); stage 3 returns (the new f, None)."""
    return _update(stage, f0, stage_rhs_plain(fin, terms, spec), acc, dt, spec.n_acc)


def check_spec(spec: GKStageSpec, shape, dtype: torch.dtype) -> None:
    """Raise unless the kernel takes this configuration for an f of ``shape``
    and ``dtype``: what is fixed for a run (the grids' tables, the scalars)."""
    if dtype not in _ENTRIES:
        raise TypeError(f"gk_rhs: complex64 or complex128, got {dtype}")
    real = torch.float32 if dtype == torch.complex64 else torch.float64
    s, nkx, nky, nth, nv, nm = shape
    if s not in (1, 2) or s != spec.n_species or nth < 4:
        raise ValueError(f"gk_rhs: shape {tuple(shape)} needs 1 or 2 species and "
                         "n_theta >= 4")
    if spec.collision not in (None, "krook", "conservative"):
        raise ValueError(f"gk_rhs: unknown collision model {spec.collision!r}")
    g = spec.grids
    _check("gk_rhs", (
        ("vpar", g.vpar, real, (nv,)), ("mu", g.mu, real, (nm,)),
        ("b_ratio", g.b_ratio, real, (nth,)), ("kappa_n", g.kappa_n, real, (nth,)),
        ("kappa_g", g.kappa_g, real, (nth,)), ("b_dot_grad", g.b_dot_grad, real, (nth,)),
        ("ky", g.ky, real, (nky,)), ("kperp2", g.kperp2, real, (nkx, nky)),
        ("maxwellian", g.maxwellian, real, (nv, nm)), ("energy", g.energy, real, (nv, nm))))


def _check(name: str, want) -> None:
    for arg, t, dtype, shape in want:
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{name}: {arg} is missing")
        if not t.is_cuda:
            raise ValueError(f"{name}: {arg} must be a CUDA tensor, got {t.device}")
        if t.dtype != dtype or t.shape != shape:
            raise ValueError(f"{name}: {arg} is {t.dtype} {tuple(t.shape)}, expected "
                             f"{dtype} {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def check_inputs(stage: int, f0, fin, acc, terms: StageTerms, dt, spec: GKStageSpec) -> None:
    """Raise unless the stage's own tensors are what the kernel reads, given
    a configuration that :func:`check_spec` took for f0's shape and dtype."""
    if not 0 <= stage <= 3:
        raise ValueError(f"gk_rhs: stage {stage} is not 0..3")
    shape, cdt = f0.shape, f0.dtype
    real = torch.float32 if cdt == torch.complex64 else torch.float64
    _, nkx, nky, nth, nv, nm = shape
    act = (2 if spec.electrons_active else 1, nkx, nky, nth, nv, nm)
    want = [("f0", f0, cdt, shape), ("fin", fin, cdt, shape),
            ("tw", terms.tw, cdt, (act[0], nkx, nky, 4, nv, nm)),
            ("phi", terms.phi, cdt, (nkx, nky, nth)), ("dt", dt, real, ())]
    if stage > 0:
        want.append(("acc", acc, cdt, (spec.n_acc,) + shape[1:]))
    if spec.nonlinear:
        want.append(("bracket", terms.bracket, cdt, act))
    if spec.collision == "conservative":
        want.append(("coll", terms.coll, cdt, act))
    if spec.electromagnetic:
        want += [("a_par", terms.a_par, cdt, (nkx, nky, nth)),
                 ("b_par", terms.b_par, cdt, (nkx, nky, nth))]
    _check("gk_rhs", want)


def check_stage(stage: int, f0, fin, acc, terms: StageTerms, dt, spec: GKStageSpec) -> None:
    """Raise unless the kernel takes this stage: :func:`check_spec` and
    :func:`check_inputs`."""
    if not 0 <= stage <= 3:
        raise ValueError(f"gk_rhs: stage {stage} is not 0..3")
    check_spec(spec, f0.shape, f0.dtype)
    check_inputs(stage, f0, fin, acc, terms, dt, spec)


def args_template(spec: GKStageSpec, shape) -> _Args:
    """The argument block's fields that are fixed for a run: the grids'
    tables, the sizes and the scalars."""
    g = spec.grids
    s, nkx, nky, nth, nv, nm = shape
    return _Args(
        vpar=g.vpar.data_ptr(), mu=g.mu.data_ptr(), b_ratio=g.b_ratio.data_ptr(),
        kappa_n=g.kappa_n.data_ptr(), kappa_g=g.kappa_g.data_ptr(),
        b_dot_grad=g.b_dot_grad.data_ptr(), ky=g.ky.data_ptr(), kperp2=g.kperp2.data_ptr(),
        maxwellian=g.maxwellian.data_ptr(), energy=g.energy.data_ptr(),
        n_total=s * nkx * nky * nth * nv * nm, n_species=s, n_kx=nkx, n_ky=nky, n_theta=nth,
        n_vpar=nv, n_mu=nm, n_acc=spec.n_acc, electrons_active=int(spec.electrons_active),
        nonlinear=int(spec.nonlinear), krook=int(spec.collision == "krook"),
        coll_input=int(spec.collision == "conservative"),
        electromagnetic=int(spec.electromagnetic), hyper_p=spec.hyper_p,
        zonal=int(spec.zonal_rate > 0.0), d_theta=spec.d_theta, v_scale_e=spec.v_scale_e,
        nu=spec.nu, hyper_coeff=spec.hyper_coeff, zonal_rate=spec.zonal_rate,
        r_l_ne=spec.r_l_ne, eta_i=spec.eta_i, eta_e=spec.eta_e)


def launch_args(stage: int, f0, fin, acc, terms: StageTerms, dt, spec: GKStageSpec,
                template: _Args):
    """The kernel's argument block (a copy of ``template``, the run's
    :func:`args_template`, with the stage's pointers) and its outputs (next,
    acc)."""
    nxt = torch.empty_like(f0)
    acc_out = None
    if stage == 0:
        acc_out = f0.new_empty((spec.n_acc,) + f0.shape[1:])
    elif stage < 3:
        acc_out = acc
    args = _Args.from_buffer_copy(template)
    args.f0, args.fin, args.next, args.dt = (
        f0.data_ptr(), fin.data_ptr(), nxt.data_ptr(), dt.data_ptr())
    args.tw, args.phi, args.stage = terms.tw.data_ptr(), terms.phi.data_ptr(), stage
    if stage > 0:
        args.acc_in = acc.data_ptr()
    if acc_out is not None:
        args.acc_out = acc_out.data_ptr()
    for name in ("bracket", "coll", "a_par", "b_par"):
        t = getattr(terms, name)
        if t is not None:
            setattr(args, name, t.data_ptr())
    return args, (nxt, acc_out)


# (id(spec), f's shape, f's dtype) -> (spec, argument template) of each
# configuration that check_spec took: a run checks each configuration once
# (a sharded run has one a shard), then each stage only its own tensors; the
# spec is kept beside its id, so a reused id is not taken for it
_CHECKED: dict = {}
_CHECKED_MAX = 64


def gk_stage(stage: int, f0: torch.Tensor, fin: torch.Tensor, acc: torch.Tensor | None,
             terms: StageTerms, dt: torch.Tensor, spec: GKStageSpec):
    """RK4 stage ``stage`` (0..3): (next stage's input, accumulator of the
    first ``spec.n_acc`` species); stage 3 returns (the new f, None).  The
    accumulator is updated in place on the card from stage 1 on."""
    if not f0.is_cuda:
        return gk_stage_plain(stage, f0, fin, acc, terms, dt, spec)
    key = (id(spec), tuple(f0.shape), f0.dtype)
    entry = _CHECKED.get(key)
    if entry is None or entry[0] is not spec:
        check_spec(spec, f0.shape, f0.dtype)
        if len(_CHECKED) >= _CHECKED_MAX:
            _CHECKED.clear()
        entry = _CHECKED[key] = (spec, args_template(spec, f0.shape))
    check_inputs(stage, f0, fin, acc, terms, dt, spec)
    args, out = launch_args(stage, f0, fin, acc, terms, dt, spec, entry[1])
    cb.launch(_ENTRIES[f0.dtype], ctypes.addressof(args))
    cb.CALLS["gk_rhs"] += 1
    return out
