"""Port parity: the nonlinear 5D flux-tube GK solver
(``models/gyrokinetics/nonlinear.py``) and row G's plain version
(``ops/cuda_gk.gk_stage_plain``).

At the JAX tests' small sizes (``tests/test_gk_nonlinear.py:27-30``: 8^5, 2
species, 20 steps, complex128) every operator matches the JAX function on the
same seeded state within 1e-12 of its max |value|, in the default,
kinetic-electron, electromagnetic, conservative-collision, zonal-damped and
Miller-geometry variants; the fused stage's plain version matches JAX's
``gk_rhs`` plus the RK4 stage update within 1e-12 (the whole runs:
``test_torch_gk_nonlinear_run.py``).  The public ``init_state`` draws from
a seeded torch generator and ``_init_state`` with JAX's draws equals JAX's
``init_state``.  On the CPU the stage wrapper runs its plain version; its
ctypes argument block lists ``GKStageArgs`` of ``csrc/gk_rhs.cu`` field for
field, and its guards refuse what the kernel does not take.
"""

import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import crel as rel

from scpn_fusion_tpu.models.gyrokinetics import geometry as jgeo
from scpn_fusion_tpu.models.gyrokinetics import nonlinear as jnl
from scpn_fusion_tpu_torch.bench_config import GK_VARIANT_MILLER
from scpn_fusion_tpu_torch.models.gyrokinetics import geometry as tgeo
from scpn_fusion_tpu_torch.models.gyrokinetics import nonlinear as tnl
from scpn_fusion_tpu_torch.ops import cuda_gk

TINY = dict(n_kx=8, n_ky=8, n_theta=8, n_vpar=8, n_mu=8, n_species=2, n_steps=20,
            save_interval=5, dt=0.02, dtype="complex128")
VARIANTS = {
    "default": {},
    "kinetic": dict(kinetic_electrons=True),
    "electromagnetic": dict(kinetic_electrons=True, electromagnetic=True),
    "conservative": dict(collision_model="conservative"),
    "zonal": dict(zonal_damping_rate=0.1),
    "all": dict(kinetic_electrons=True, electromagnetic=True, collision_model="conservative",
                zonal_damping_rate=0.05),
}
OP_TOL = 1e-12
RUN_TOL = 1e-10     # the whole runs (test_torch_gk_nonlinear_run.py)
MILLER = GK_VARIANT_MILLER     # a shaped surface (kappa 1.6, delta 0.3) at 8 theta points


def _cfgs(**kw):
    return jnl.NonlinearGKConfig(**{**TINY, **kw}), tnl.NonlinearGKConfig(**{**TINY, **kw})


def _pair(kw, geometry=False):
    """(JAX cfg, grids, state), (port cfg, grids, f) on JAX's seeded state."""
    jc, tc = _cfgs(**kw)
    jg = jnl.build_grids(jc, jgeo.miller_geometry(**MILLER) if geometry else None)
    tg = tnl.build_grids(tc, tgeo.miller_geometry(**MILLER, device="cpu") if geometry else None,
                         device="cpu")
    st = jnl.init_state(jc, jg, amplitude=1e-3, seed=0)
    return (jc, jg, st), (tc, tg, torch.from_numpy(np.array(st.f)))


def test_grids_match():
    (jc, jg, _), (tc, tg, _) = _pair({}, geometry=True)
    for name in jg._fields:
        assert rel(getattr(tg, name), getattr(jg, name)) <= 1e-15, name
        assert getattr(tg, name).dtype in (torch.float64, torch.complex128)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_field_solves_match(variant):
    (jc, jg, st), (tc, tg, f) = _pair(VARIANTS[variant])
    assert rel(tnl.field_solve(tc, tg, f), jnl.field_solve(jc, jg, st.f)) <= OP_TOL
    assert rel(tnl.ampere_solve(tc, tg, f), jnl.ampere_solve(jc, jg, st.f)) <= OP_TOL
    assert rel(tnl.bpar_solve(tc, tg, f), jnl.bpar_solve(jc, jg, st.f)) <= OP_TOL
    phi = jnl.field_solve(jc, jg, st.f)
    assert rel(tnl.cfl_dt(tc, tg, torch.from_numpy(np.array(phi))),
               jnl.cfl_dt(jc, jg, phi)) <= OP_TOL
    for ours, ref in zip(tnl.heat_flux(tc, tg, f, torch.from_numpy(np.array(phi))),
                         jnl.heat_flux(jc, jg, st.f, phi)):
        assert rel(ours, ref) <= OP_TOL
    ours = tnl.diagnostics(tc, tg, tnl.GKState(f, torch.tensor(0.0, dtype=torch.float64)))
    for a, b in zip(ours, jnl.diagnostics(jc, jg, st)):
        assert rel(a, b) <= OP_TOL


@pytest.mark.parametrize("geometry", [False, True], ids=["s-alpha", "miller"])
def test_species_operators_match(geometry):
    (jc, jg, st), (tc, tg, f) = _pair({}, geometry=geometry)
    phi = jnl.field_solve(jc, jg, st.f)
    phi_t = torch.from_numpy(np.array(phi))
    for s in range(2):
        assert rel(tnl.parallel_streaming(tg, f[s]), jnl.parallel_streaming(jg, st.f[s])) <= OP_TOL
        assert rel(tnl.magnetic_drift(tg, f[s]), jnl.magnetic_drift(jg, st.f[s])) <= OP_TOL
        assert rel(tnl.exb_bracket(tg, phi_t, f[s]), jnl.exb_bracket(jg, phi, st.f[s])) <= OP_TOL
        assert rel(tnl.collide_krook(tc, tg, f[s]), jnl.collide_krook(jc, jg, st.f[s])) <= OP_TOL
        assert rel(tnl.collide_conservative(tc, tg, f[s]),
                   jnl.collide_conservative(jc, jg, st.f[s])) <= OP_TOL
    # the species-batched bracket and collision term equal the per-species ones
    both = tnl.exb_bracket(tg, phi_t, f)
    assert all(torch.equal(both[s], tnl.exb_bracket(tg, phi_t, f[s])) for s in range(2))
    gi = tnl.conservative_gram_inverse(tg, f.dtype)
    both = tnl.collide_conservative(tc, tg, f, gi)
    assert all(rel(both[s], tnl.collide_conservative(tc, tg, f[s])) <= 1e-15 for s in range(2))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_gradient_drive_and_rhs_match(variant):
    (jc, jg, st), (tc, tg, f) = _pair(VARIANTS[variant])
    phi = jnl.field_solve(jc, jg, st.f)
    a_par, b_par = jnl.ampere_solve(jc, jg, st.f), jnl.bpar_solve(jc, jg, st.f)
    to = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    assert rel(tnl.gradient_drive(tc, tg, to(phi), to(a_par), to(b_par)),
               jnl.gradient_drive(jc, jg, phi, a_par, b_par)) <= OP_TOL
    assert rel(tnl.gk_rhs(tc, tg, f), jnl.gk_rhs(jc, jg, st.f)) <= OP_TOL


def test_ballooning_planes_are_the_wrapped_planes():
    """The four twisted planes are the planes ``_roll_ballooning`` takes
    from its kx-shifted copy at the theta boundary."""
    (_, _, _), (tc, tg, f) = _pair({})
    tw = tnl.ballooning_planes(tg, f)
    for s in range(2):
        assert rel(tw[s, :, :, 0], tnl._roll_ballooning(tg, f[s], -2)[:, :, -2]) <= 1e-15
        assert rel(tw[s, :, :, 1], tnl._roll_ballooning(tg, f[s], -2)[:, :, -1]) <= 1e-15
        assert rel(tw[s, :, :, 2], tnl._roll_ballooning(tg, f[s], 2)[:, :, 0]) <= 1e-15
        assert rel(tw[s, :, :, 3], tnl._roll_ballooning(tg, f[s], 1)[:, :, 0]) <= 1e-15


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_stage_plain_matches_jax_rhs_and_update(variant):
    """Four chained stages of ``gk_stage_plain`` against JAX's ``gk_rhs``
    and ``rk4_step``'s bookkeeping on the same stage inputs."""
    (jc, jg, st), (tc, tg, f) = _pair(VARIANTS[variant])
    spec = tnl.stage_spec(tc, tg)
    phi = tnl.field_solve(tc, tg, f)
    dt = tnl.cfl_dt(tc, tg, phi)
    dt_j = jnl.cfl_dt(jc, jg, jnl.field_solve(jc, jg, st.f))
    fin, acc, ks = f, None, []
    coef = (0.5, 0.5, 1.0)
    n = spec.n_acc      # the species whose k can be nonzero; the rest of k is 0
    assert n == (1 if variant in ("default", "conservative") else 2)
    for stage in range(4):
        terms = tnl.stage_terms(tc, tg, fin, tnl.field_solve(tc, tg, fin))
        k_ref = jnl.gk_rhs(jc, jg, jnp.asarray(fin.numpy()))
        assert rel(cuda_gk.stage_rhs_plain(fin, terms, spec), k_ref) <= OP_TOL
        ks.append(k_ref)
        fin, acc = cuda_gk.gk_stage_plain(stage, f, fin, acc, terms, dt, spec)
        if stage < 3:
            acc_ref = ks[0] if stage == 0 else sum(
                (1.0 if i == 0 else 2.0) * k for i, k in enumerate(ks))
            assert rel(acc, acc_ref[:n]) <= OP_TOL and not np.asarray(acc_ref[n:]).any()
            assert rel(fin, st.f + coef[stage] * dt_j * k_ref) <= OP_TOL
    new = st.f + (dt_j / 6.0) * (ks[0] + 2.0 * ks[1] + 2.0 * ks[2] + ks[3])
    assert acc is None and rel(fin, new) <= OP_TOL
    assert rel(tnl.rk4_step(tc, tg, tnl.GKState(f, torch.tensor(0.0, dtype=torch.float64))).f,
               jnl.rk4_step(jc, jg, st).f) <= OP_TOL


@pytest.mark.parametrize("dtype", ["complex128", "complex64"])
def test_init_state_with_jax_draws_equals_jax(dtype):
    jc, tc = _cfgs(dtype=dtype)
    jg, tg = jnl.build_grids(jc), tnl.build_grids(tc, device="cpu")
    ref = jnl.init_state(jc, jg, amplitude=1e-4, seed=11)
    kr, ki = jax.random.split(jax.random.PRNGKey(11))
    shape = ref.f.shape
    noise = np.asarray(jax.random.normal(kr, shape) + 1j * jax.random.normal(ki, shape))
    ours = tnl._init_state(tc, tg, torch.from_numpy(noise), amplitude=1e-4)
    assert ours.f.dtype == (torch.complex64 if dtype == "complex64" else torch.complex128)
    assert np.array_equal(ours.f.numpy(), np.asarray(ref.f))
    assert float(ours.time) == 0.0


def test_public_init_state_draws_from_a_seeded_generator():
    _, tc = _cfgs()
    tg = tnl.build_grids(tc, device="cpu")
    a, b = tnl.init_state(tc, tg, seed=3), tnl.init_state(tc, tg, seed=3)
    c = tnl.init_state(tc, tg, seed=4)
    assert torch.equal(a.f, b.f) and not torch.equal(a.f, c.f)
    assert bool((a.f[:, 0, 0] == 0).all())
    # the dealiased modes are zero
    mask = tg.dealias_mask
    assert bool((a.f[:, mask == 0] == 0).all())


def test_inactive_electrons_skip_their_terms():
    """Adiabatic electrons: the fused stage writes the zonal term alone where
    JAX multiplies the electron terms by 0 -- the same for finite f."""
    (jc, jg, st), (tc, tg, f) = _pair(dict(zonal_damping_rate=0.3))
    spec = tnl.stage_spec(tc, tg)
    assert not spec.electrons_active
    terms = tnl.stage_terms(tc, tg, f, tnl.field_solve(tc, tg, f))
    assert terms.bracket.shape[0] == 1 and terms.tw.shape[0] == 1
    k = cuda_gk.stage_rhs_plain(f, terms, spec)
    k_ref = np.asarray(jnl.gk_rhs(jc, jg, st.f))[1]
    ky0 = (np.abs(np.asarray(jg.ky)) < 1e-10)[None, :, None, None, None]
    assert np.array_equal(k[1].numpy(), -0.3 * f[1].numpy() * ky0)
    assert rel(k[1], k_ref) <= OP_TOL


def test_stage_wrapper_runs_plain_on_cpu_and_counts_nothing():
    from scpn_fusion_tpu_torch.ops import _cuda_build as cb
    (_, _, _), (tc, tg, f) = _pair({})
    spec = tnl.stage_spec(tc, tg)
    phi = tnl.field_solve(tc, tg, f)
    dt = tnl.cfl_dt(tc, tg, phi)
    terms = tnl.stage_terms(tc, tg, f, phi)
    cb.reset_launch_counts()
    a = cuda_gk.gk_stage(0, f, f, None, terms, dt, spec)
    b = cuda_gk.gk_stage_plain(0, f, f, None, terms, dt, spec)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert cb.CALLS["gk_rhs"] == 0 and cb.kernel_launches() == 0


def test_stage_guards_refuse_cpu_and_bad_shapes():
    (_, _, _), (tc, tg, f) = _pair({})
    spec = tnl.stage_spec(tc, tg)
    phi = tnl.field_solve(tc, tg, f)
    dt = tnl.cfl_dt(tc, tg, phi)
    terms = tnl.stage_terms(tc, tg, f, phi)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_gk.check_stage(0, f, f, None, terms, dt, spec)
    with pytest.raises(TypeError, match="complex64 or complex128"):
        cuda_gk.check_stage(0, f.real, f, None, terms, dt, spec)
    with pytest.raises(ValueError, match="stage 4"):
        cuda_gk.check_stage(4, f, f, None, terms, dt, spec)
    with pytest.raises(ValueError, match="n_theta >= 4"):
        cuda_gk.check_stage(0, f[:, :, :, :3], f, None, terms, dt, spec)
    with pytest.raises(ValueError, match="unknown collision model"):
        tnl.stage_spec(tnl.NonlinearGKConfig(collision_model="bgk"), tg)


def _c_fields(source: str, struct: str):
    body = source[source.index(f"struct {struct} {{"):source.index("};", source.index(struct))]
    fields = []
    for line in body.splitlines()[1:]:
        code = line.split("//")[0].strip().rstrip(";")
        if not code:
            continue
        ctype, names = re.match(r"((?:const )?(?:long long|\w+)\*?)\s+(\w[\w, ]*)$",
                                code).groups()
        fields += [(n.strip(), ctype.strip()) for n in names.split(",")]
    return fields


def test_args_struct_matches_c():
    src = (Path(cuda_gk.__file__).resolve().parent.parent / "csrc" / "gk_rhs.cu").read_text()
    c_fields = _c_fields(src, "GKStageArgs")
    py_fields = cuda_gk._Args._fields_
    assert [n for n, _ in c_fields] == [n for n, _ in py_fields]
    kinds = {"long long": ctypes.c_longlong, "int": ctypes.c_int, "double": ctypes.c_double}
    for (name, ctype), (_, pytype) in zip(c_fields, py_fields):
        assert pytype is (ctypes.c_void_p if ctype.endswith("*") else kinds[ctype]), name


def test_launch_args_point_at_the_tensors():
    (_, _, _), (tc, tg, f) = _pair(VARIANTS["all"])
    spec = tnl.stage_spec(tc, tg)
    phi = tnl.field_solve(tc, tg, f)
    dt = tnl.cfl_dt(tc, tg, phi)
    terms = tnl.stage_terms(tc, tg, f, phi, tnl.conservative_gram_inverse(tg, f.dtype))
    acc = torch.zeros_like(f)
    args, (nxt, acc_out) = cuda_gk.launch_args(2, f, f, acc, terms, dt, spec,
                                               cuda_gk.args_template(spec, f.shape))
    assert acc_out is acc and nxt.shape == f.shape
    for name, t in (("f0", f), ("acc_in", acc), ("next", nxt), ("bracket", terms.bracket),
                    ("coll", terms.coll), ("tw", terms.tw), ("phi", terms.phi),
                    ("a_par", terms.a_par), ("b_par", terms.b_par), ("dt", dt),
                    ("kperp2", tg.kperp2), ("energy", tg.energy)):
        assert getattr(args, name) == t.data_ptr(), name
    assert (args.n_total, args.n_acc, args.stage, args.electrons_active, args.coll_input,
            args.krook) == (f.numel(), 2, 2, 1, 1, 0)
    assert args.d_theta == float(np.float64(tg.d_theta)) and args.hyper_p == 2


@pytest.mark.parametrize("variant", ["default", "zonal"])
def test_accumulator_holds_the_species_with_a_k(variant):
    """Adiabatic, undamped electrons have k = 0: the accumulator holds the
    ions alone, and stage 3 gives the electrons back f0 (with zonal damping
    their k is nonzero at ky = 0, and the accumulator holds both)."""
    (_, _, _), (tc, tg, f) = _pair(VARIANTS[variant])
    spec = tnl.stage_spec(tc, tg)
    phi = tnl.field_solve(tc, tg, f)
    dt = tnl.cfl_dt(tc, tg, phi)
    terms = tnl.stage_terms(tc, tg, f, phi)
    n = 1 if variant == "default" else 2
    args, (nxt, acc_out) = cuda_gk.launch_args(0, f, f, None, terms, dt, spec,
                                               cuda_gk.args_template(spec, f.shape))
    assert spec.n_acc == args.n_acc == n and acc_out.shape == (n,) + f.shape[1:]
    fin, acc = f, None
    for stage in range(4):
        fin, acc = cuda_gk.gk_stage_plain(stage, f, fin, acc, terms, dt, spec)
        assert acc is None or acc.shape[0] == n
    if variant == "default":
        assert torch.equal(fin[1], f[1])
