"""Cross-implementation GS-kernel parity: C++ / NumPy / the port / the
card's kernel 1, the port's ``validation/run_implementation_parity.py``.

Counterpart of the reference's polyglot solver comparison
(``benchmarks/polyglot_gs_solver_comparison.py``: the SAME GS case solved
by several ports and cross-checked).  The implementation inventory here is
the port's C++ copy (``native/gs_runtime.cpp``, built with g++), the NumPy
twin (``utils/npref.py``) and the port's float64 ``ops/stencil.sor_step``
on ``device`` (reported as ``torch``, where the JAX script reports its own
``jax_cpu``), and, on a CUDA device, the hand-written SOR kernel
(``ops/cuda_stencil.sor_sweeps``, kernel 1) in float32.

Problem: manufactured solution on a 65x65 (R, Z) grid — psi_exact a
smooth Gaussian, source = GS*[psi_exact], Dirichlet boundary from
psi_exact — so every implementation solves the identical well-posed
elliptic problem with a known answer.

Lanes (fail-closed):

1. ``sweep_trajectory_parity`` — ONE red-black SOR sweep from the same
   perturbed state: C++ vs NumPy vs the port must agree to 1e-13 span-rel.
2. ``converged_cross_implementation`` — each implementation runs 4000 SOR
   sweeps; pairwise span-rel deviation <= 1e-8 AND every implementation's
   error vs psi_exact within 1.5x of the best.
3. ``tpu_f32_parity`` — kernel 1 runs the same 400 sweeps as the NumPy
   twin in one launch; span-rel deviation <= 1e-5 (f32).  Blocked (not
   passed) off a CUDA device, as the script's is off the TPU.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from scpn_fusion_tpu_torch.validation import REPORTS_DIR
from scpn_fusion_tpu_torch.validation._lanes import NO_CARD, exit_code, on_card

N_CONVERGED = 4000
N_KERNEL_SWEEPS = 400


def problem(n: int = 65) -> tuple:
    """The manufactured problem and its perturbed start: (r_1d, d_r, d_z,
    psi_exact, source, psi0)."""
    from scpn_fusion_tpu_torch.utils import npref
    r_1d = np.linspace(2.0, 10.0, n)
    z_1d = np.linspace(-4.0, 4.0, n)
    d_r, d_z = float(r_1d[1] - r_1d[0]), float(z_1d[1] - z_1d[0])
    rr, zz = np.meshgrid(r_1d, z_1d)
    psi_exact = np.exp(-((rr - 6.0) ** 2 + zz**2) / 3.0)
    source = npref.gs_operator_np(psi_exact, r_1d, d_r, d_z)
    psi0 = psi_exact + 0.1 * np.random.default_rng(42).standard_normal(psi_exact.shape)
    psi0[0, :], psi0[-1, :] = psi_exact[0, :], psi_exact[-1, :]
    psi0[:, 0], psi0[:, -1] = psi_exact[:, 0], psi_exact[:, -1]
    return r_1d, d_r, d_z, psi_exact, source, psi0


def kernel_sweeps(device, n_sweeps: int = N_KERNEL_SWEEPS, dtype: torch.dtype = torch.float32):
    """Kernel 1 on the problem in ``dtype`` (float32, one launch, on a CUDA
    device; its plain version elsewhere) and the NumPy twin's float64 sweeps:
    (kernel psi as float64 numpy, twin's)."""
    from scpn_fusion_tpu_torch.ops import cuda_stencil
    from scpn_fusion_tpu_torch.utils import npref
    r_1d, d_r, d_z, _, source, psi0 = problem()
    out = cuda_stencil.sor_sweeps(
        torch.tensor(psi0, dtype=dtype, device=device),
        torch.tensor(source, dtype=dtype, device=device),
        torch.tensor(r_1d, dtype=dtype, device=device), d_r, d_z, 1.6, n_sweeps)
    ref = psi0.copy()
    for _ in range(n_sweeps):
        ref = npref.sor_step_np(ref, source, r_1d, d_r, d_z, 1.6)
    return out.cpu().numpy().astype(np.float64), ref


def main(*, device: torch.device | str = "cuda", out_dir: str | Path = REPORTS_DIR) -> int:
    from scpn_fusion_tpu_torch.native import runtime as native_rt
    from scpn_fusion_tpu_torch.ops.stencil import sor_step
    from scpn_fusion_tpu_torch.utils import npref
    from scpn_fusion_tpu_torch.utils.evidence import LaneResult, write_report

    dev = torch.device(device)
    lanes = []
    r_1d, d_r, d_z, psi_exact, source, psi0 = problem()
    span = float(psi_exact.max() - psi_exact.min())
    native_ok = native_rt.is_available()

    def native_sweeps(n_sweeps, omega=1.6):
        solver = native_rt.NativeGSSolver(r_1d, d_r, d_z, nz=psi0.shape[0])
        solver.set_state(psi0, source)
        solver.set_boundary(psi_exact)
        solver.sweeps(n_sweeps, omega=omega)
        return solver.psi

    def numpy_sweeps(n_sweeps, omega=1.6):
        out = psi0.copy()
        for _ in range(n_sweeps):
            out = npref.sor_step_np(out, source, r_1d, d_r, d_z, omega)
        return out

    def torch_sweeps(n_sweeps, omega=1.6):
        f64 = torch.float64
        out = torch.tensor(psi0, dtype=f64, device=dev)
        s = torch.tensor(source, dtype=f64, device=dev)
        r = torch.tensor(r_1d, dtype=f64, device=dev)
        for _ in range(n_sweeps):
            out = sor_step(out, s, r, d_r, d_z, omega)
        return out.cpu().numpy()

    one_np = numpy_sweeps(1)
    dev_t = float(np.max(np.abs(one_np - torch_sweeps(1)))) / span
    metrics = {"numpy_vs_torch_span_rel": dev_t}
    dev_cpp = None
    if native_ok:
        dev_cpp = float(np.max(np.abs(one_np - native_sweeps(1)))) / span
        metrics["numpy_vs_cpp_span_rel"] = dev_cpp
    else:
        metrics["numpy_vs_cpp_span_rel"] = "skipped (no C++ toolchain)"
    ok = dev_t < 1e-13 and (dev_cpp is None or dev_cpp < 1e-13)
    lanes.append(LaneResult(
        name="sweep_trajectory_parity",
        status="pass" if ok else "fail",
        metrics=metrics,
        thresholds={"span_rel": 1e-13},
        notes="one red-black SOR sweep from the identical state: same "
              "update ordering across implementations (the reference's "
              "polyglot trajectory check)"))

    sols = {"numpy": numpy_sweeps(N_CONVERGED), "torch": torch_sweeps(N_CONVERGED)}
    if native_ok:
        sols["cpp"] = native_sweeps(N_CONVERGED)
    errs = {k: float(np.max(np.abs(v - psi_exact))) / span for k, v in sols.items()}
    keys = sorted(sols)
    pair_dev = {f"{a}_vs_{b}": float(np.max(np.abs(sols[a] - sols[b]))) / span
                for i, a in enumerate(keys) for b in keys[i + 1:]}
    best = min(errs.values())
    ok = (all(d < 1e-8 for d in pair_dev.values())
          and all(e <= 1.5 * best + 1e-12 for e in errs.values()))
    lanes.append(LaneResult(
        name="converged_cross_implementation",
        status="pass" if ok else "fail",
        metrics={**{f"err_vs_exact_{k}": v for k, v in errs.items()},
                 **{f"dev_{k}": v for k, v in pair_dev.items()},
                 "implementations": keys},
        thresholds={"pairwise_span_rel": 1e-8,
                    "err_vs_exact": "<= 1.5x best implementation"},
        notes=f"{N_CONVERGED} SOR sweeps to the discrete fixed point; every "
              "implementation lands on the same solution of the same "
              "manufactured problem"))

    if on_card(dev):
        out, ref = kernel_sweeps(dev)
        dev3 = float(np.max(np.abs(out - ref))) / span
        lanes.append(LaneResult(
            name="tpu_f32_parity",
            status="pass" if dev3 < 1e-5 else "fail",
            metrics={"span_rel_dev_vs_numpy_f64": dev3, "n_sweeps": N_KERNEL_SWEEPS},
            thresholds={"span_rel_dev_vs_numpy_f64": 1e-5},
            notes="Pallas VMEM-resident red-black kernel on the real chip "
                  "vs the f64 NumPy twin, same sweep count"))
    else:
        lanes.append(LaneResult(name="tpu_f32_parity", status="blocked", notes=NO_CARD))

    path = write_report("implementation_parity", lanes, out_dir=out_dir)
    print(f"wrote {path}")
    return exit_code(lanes)
