"""Pretrained surrogate artifacts: NPZ weights + checksummed metrics (port of
``scpn_fusion_tpu/models/surrogates/pretrained.py``).

Trained parameter sets ship in the repository as NPZ with a sidecar metrics
JSON (the sha256 of the weights, the training configuration, the held-out
error), and loading is fail-closed: a checksum mismatch or a missing metrics
file refuses to load.  The NPZ layouts are the JAX package's (``w{i}`` /
``b{i}`` and the normalisers; ``leaf_{i}`` in ``jax.tree.flatten(FNOParams)``
order), so each package loads the other's artifacts.

* ``neural_transport``: an MLP 7 -> 64 -> 64 -> 3 mapping the local
  dimensionless inputs [R/L_Ti, R/L_Te, R/L_ne, q, s_hat, Te/Ti, nu_star] to
  [chi_i, chi_e, D_e] in gyro-Bohm units, distilled from a reduced physics
  teacher (:func:`train_transport_surrogate`; loaded as a closure by
  :func:`load_transport_surrogate`, as the transport stepper's
  :class:`TransportSurrogate` by :func:`load_transport_surrogate_pytree`);
* ``fno_turbulence``: an FNO from GENE-like vorticity snapshots to the
  periodic streamfunction (:func:`train_fno_turbulence`,
  :func:`load_fno_turbulence`);
* ``neural_equilibrium``: PCA basis + MLP from 6 coil currents to a
  free-boundary psi map, trained on the port's own solves
  (:func:`train_equilibrium_artifact`, :func:`load_equilibrium_artifact`).

The trainers draw the initial parameters and the minibatch indices from
``torch.Generator().manual_seed(seed)`` and the data from numpy's
``default_rng(seed)`` (as JAX does), and write to ``out_dir``
(default: the committed ``weights/``).
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from scpn_fusion_tpu_torch.models.surrogates.mlp import (
    MLPParams,
    _train_mlp,
    batch_indices,
    init_mlp,
    mlp_apply,
)

WEIGHTS_DIR = Path(__file__).resolve().parents[3] / "weights"
N_IN, N_OUT = 7, 3


def _teacher_fluxes(x: np.ndarray) -> np.ndarray:
    """Reduced physics teacher (gyro-Bohm units).

    chi_i: critical-gradient ITG stiffness + neoclassical floor;
    chi_e: TEM-like fraction of chi_i driven by R/L_Te and collisionality;
    D_e: particle channel tied to R/L_ne with a pinch offset.
    """
    rlti, rlte, rlne, q, s_hat, te_ti, nu_star = x.T
    rlti_crit = 4.0 * (1.0 + 0.5 * np.maximum(s_hat, 0.0)) / np.maximum(
        te_ti, 0.3)
    itg = np.maximum(rlti - rlti_crit, 0.0)
    chi_i = 0.05 + 1.2 * q ** 1.5 * itg / (1.0 + 0.3 * nu_star)
    tem = np.maximum(rlte - 3.5, 0.0)
    chi_e = 0.03 + 0.6 * q * tem / (1.0 + 0.5 * nu_star) + 0.2 * chi_i
    d_e = 0.02 + 0.3 * np.maximum(rlne - 1.0, 0.0) + 0.1 * chi_e
    return np.stack([chi_i, chi_e, d_e], axis=1)


def _sample_inputs(n: int, rng: np.random.Generator) -> np.ndarray:
    """Training envelope: covers the clipped bands the transport loop feeds
    the closure, so in-loop inputs are in-distribution by construction."""
    return np.stack([
        rng.uniform(0.0, 20.0, n),    # R/L_Ti
        rng.uniform(0.0, 20.0, n),    # R/L_Te
        rng.uniform(0.0, 20.0, n),    # R/L_ne
        rng.uniform(0.8, 6.0, n),     # q
        rng.uniform(-1.0, 4.0, n),    # s_hat
        rng.uniform(0.05, 3.0, n),    # Te/Ti
        10.0 ** rng.uniform(-3.0, 2.0, n),   # nu_star (log-uniform)
    ], axis=1)


def train_transport_surrogate(*, name: str = "neural_transport", n_train: int = 20_000,
                              n_test: int = 2000, hidden=(64, 64), n_steps: int = 4000,
                              seed: int = 0, out_dir: Path | None = None,
                              device: torch.device | str = "cuda") -> dict:
    """Train on ``device``, evaluate, and write the NPZ + metrics artifact
    pair; returns the metrics."""
    generator = torch.Generator().manual_seed(seed)
    params = init_mlp(generator, (N_IN, *hidden, N_OUT), device=device)
    idx = batch_indices(generator, n_steps, 512, n_train, device)
    return _train_transport_surrogate(params, idx, name=name, n_train=n_train, n_test=n_test,
                                      seed=seed, out_dir=out_dir)


def _train_transport_surrogate(params: MLPParams, batch_idx: torch.Tensor, *,
                               name: str = "neural_transport", n_train: int = 20_000,
                               n_test: int = 2000, seed: int = 0,
                               out_dir: Path | None = None) -> dict:
    """:func:`train_transport_surrogate` from the given initial parameters (their
    hidden widths are the artifact's) and (n_steps, 512) minibatch indices, on
    the parameters' device."""
    device = params.weights[0].device
    rng = np.random.default_rng(seed)
    x_tr = _sample_inputs(n_train, rng)
    x_te = _sample_inputs(n_test, rng)
    y_tr = _teacher_fluxes(x_tr)
    y_te = _teacher_fluxes(x_te)

    x_mean, x_std = x_tr.mean(0), x_tr.std(0) + 1e-9
    y_mean, y_std = y_tr.mean(0), y_tr.std(0) + 1e-9

    def f32(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    res = _train_mlp(params, f32((x_tr - x_mean) / x_std), f32((y_tr - y_mean) / y_std),
                     batch_idx, lr=1e-3)
    pred = mlp_apply(res.params, f32((x_te - x_mean) / x_std)).cpu().numpy()
    pred = pred * y_std + y_mean
    rel_l2 = float(np.linalg.norm(pred - y_te) / max(np.linalg.norm(y_te), 1e-30))

    arrays = {**_mlp_arrays(res.params), "x_mean": x_mean, "x_std": x_std, "y_mean": y_mean,
              "y_std": y_std}
    return _save_artifact(name, arrays, {
        "test_rel_l2": rel_l2,
        "inputs": ["R_L_Ti", "R_L_Te", "R_L_ne", "q", "s_hat", "Te_Ti", "nu_star"],
        "outputs": ["chi_i_gb", "chi_e_gb", "d_e_gb"],
        "hidden": [int(w.shape[1]) for w in params.weights[:-1]],
        "n_train": n_train,
        "seed": seed,
    }, out_dir)


def _save_artifact(name: str, arrays: dict, metrics: dict,
                   out_dir: Path | None = None) -> dict:
    """Write the NPZ + checksummed metrics pair for any named artifact;
    returns the metrics with ``artifact`` and ``sha256`` added."""
    out = out_dir or WEIGHTS_DIR
    out.mkdir(parents=True, exist_ok=True)
    npz_path = out / f"{name}.npz"
    np.savez(npz_path, **{k: np.asarray(v) for k, v in arrays.items()})
    metrics = dict(metrics)
    metrics["artifact"] = name
    metrics["sha256"] = hashlib.sha256(npz_path.read_bytes()).hexdigest()
    (out / f"{name}.metrics.json").write_text(json.dumps(metrics, indent=2))
    return metrics


class TransportSurrogate(NamedTuple):
    """The neural-transport closure the transport stepper takes."""

    params: MLPParams
    x_mean: torch.Tensor
    x_std: torch.Tensor
    y_mean: torch.Tensor
    y_std: torch.Tensor

    def fluxes_gb(self, x: torch.Tensor) -> torch.Tensor:
        """(n, 7) local inputs -> (n, 3) gyro-Bohm fluxes, non-negative.  The
        normalised inputs are cast to the artifact's float32, also inside a
        float64 step, as in JAX."""
        xn = (x - self.x_mean) / self.x_std
        y = mlp_apply(self.params, xn.to(self.x_mean.dtype)) * self.y_std + self.y_mean
        return torch.clamp(y, min=0.0)

    def max_abs_z(self, x: torch.Tensor) -> torch.Tensor:
        """Per-row max |z-score| against the TRAINING envelope: the OOD index."""
        return torch.amax(((x - self.x_mean) / self.x_std).abs(), dim=-1)


def _load_artifact(name: str, weights_dir: Path | None = None) -> tuple[dict, dict]:
    """Fail-closed NPZ + metrics load (the sha256 must match): (arrays, metrics)."""
    out = weights_dir or WEIGHTS_DIR
    npz_path = out / f"{name}.npz"
    metrics_path = out / f"{name}.metrics.json"
    if not npz_path.exists() or not metrics_path.exists():
        raise FileNotFoundError(f"missing artifact pair for {name!r} under {out}")
    metrics = json.loads(metrics_path.read_text())
    actual = hashlib.sha256(npz_path.read_bytes()).hexdigest()
    if metrics.get("sha256") != actual:
        raise RuntimeError(
            f"surrogate artifact checksum mismatch for {name!r}: "
            "refusing to load (retrain with train_transport_surrogate)")
    with np.load(npz_path) as data:
        return {k: np.asarray(data[k]) for k in data.files}, metrics


def _mlp_arrays(params: MLPParams) -> dict:
    """An MLP as the NPZ's ``w{i}`` / ``b{i}`` arrays, in JAX's order."""
    return {f"{kind}{i}": t.detach().cpu().numpy()
            for i, layer in enumerate(zip(params.weights, params.biases))
            for kind, t in zip("wb", layer)}


def _mlp_from(arrays: dict, device) -> MLPParams:
    n_layers = sum(1 for k in arrays if k.startswith("w"))

    def t(a):
        return torch.from_numpy(np.array(a)).to(device)

    return MLPParams(weights=tuple(t(arrays[f"w{i}"]) for i in range(n_layers)),
                     biases=tuple(t(arrays[f"b{i}"]) for i in range(n_layers)))


def load_transport_surrogate_pytree(
    name: str = "neural_transport",
    weights_dir: Path | None = None,
    *,
    device: torch.device | str = "cuda",
) -> tuple[TransportSurrogate, dict]:
    """Fail-closed load of the artifact as a :class:`TransportSurrogate` on
    ``device``; returns it and the metrics."""
    arrays, metrics = _load_artifact(name, weights_dir)
    surrogate = TransportSurrogate(
        params=_mlp_from(arrays, device),
        **{k: torch.from_numpy(np.array(arrays[k], dtype=np.float32)).to(device)
           for k in ("x_mean", "x_std", "y_mean", "y_std")})
    return surrogate, metrics


def load_equilibrium_artifact(name: str = "neural_equilibrium", weights_dir: Path | None = None,
                              *, device: torch.device | str = "cuda"):
    """Fail-closed load of the committed equilibrium surrogate (PCA basis +
    MLP, ``weights/neural_equilibrium.npz``) on ``device``; returns
    (surrogate, metrics)."""
    from scpn_fusion_tpu_torch.models.surrogates.equilibrium_surrogate import (
        EquilibriumSurrogate,
    )

    arrays, metrics = _load_artifact(name, weights_dir)
    n = int(metrics["grid"])
    sur = EquilibriumSurrogate(
        mlp=_mlp_from(arrays, device),
        **{k: torch.from_numpy(np.array(arrays[k])).to(device)
           for k in ("components", "psi_mean", "x_mean", "x_std", "coeff_scale")},
        shape=(n, n))
    return sur, metrics


def load_transport_surrogate(name: str = "neural_transport", weights_dir: Path | None = None,
                             *, dtype=torch.float32, device: torch.device | str = "cuda"):
    """Fail-closed load: (predict_fn, metrics), where predict_fn maps (n, 7)
    inputs to (n, 3) non-negative gyro-Bohm fluxes.  The normalisers are in
    ``dtype`` (JAX's default float), the MLP in the artifact's float32."""
    arrays, metrics = _load_artifact(name, weights_dir)
    params = _mlp_from(arrays, device)
    x_mean, x_std, y_mean, y_std = (torch.from_numpy(np.array(arrays[k])).to(dtype=dtype,
                                                                              device=device)
                                    for k in ("x_mean", "x_std", "y_mean", "y_std"))

    def predict(x: torch.Tensor) -> torch.Tensor:
        xn = (torch.atleast_2d(x) - x_mean) / x_std
        y = mlp_apply(params, xn.to(torch.float32)) * y_std + y_mean
        # Diffusivities are non-negative by physical contract; the raw
        # regressor can undershoot near the stiff critical gradient.
        return torch.clamp(y, min=0.0)

    return predict, metrics


# ── FNO turbulence artifact ──


def _gene_like_field(grid: int, regime: str, rng: np.random.Generator) -> np.ndarray:
    """Physics-informed GENE-like turbulence snapshot: an anisotropic
    power-law spectrum a regime."""
    k = np.fft.fftfreq(grid)
    kx, ky = np.meshgrid(k, k)
    alpha, aniso = {"ITG": (3.5, 1.0), "ETG": (2.2, 4.0),
                    "TEM": (2.8, 1.5)}[regime]
    k_eff = np.maximum(np.sqrt(kx**2 + (ky / aniso) ** 2), 1e-4)
    spectrum = k_eff**-alpha * np.exp(-(kx**2 + ky**2) / 0.5)
    noise = rng.standard_normal((grid, grid)) \
        + 1j * rng.standard_normal((grid, grid))
    field = np.real(np.fft.ifft2(noise * spectrum))
    return field / (np.abs(field).max() + 1e-9)


def _periodic_streamfunction(vort: np.ndarray) -> np.ndarray:
    """phi = -inv_Laplacian(vorticity) on the periodic box (the polarisation
    closure the FNO learns)."""
    grid = vort.shape[0]
    k = 2.0 * np.pi * np.fft.fftfreq(grid)
    kx, ky = np.meshgrid(k, k)
    k2 = kx**2 + ky**2
    k2[0, 0] = 1.0
    phi_ft = np.fft.fft2(vort) / k2
    phi_ft[0, 0] = 0.0
    return np.real(np.fft.ifft2(phi_ft))


def train_fno_turbulence(*, name: str = "fno_turbulence", n_train: int = 384,
                         n_test: int = 48, grid: int = 64, width: int = 24, modes: int = 12,
                         n_layers: int = 3, n_steps: int = 2500, seed: int = 0,
                         out_dir: Path | None = None,
                         device: torch.device | str = "cuda") -> dict:
    """Train and write the FNO turbulence artifact: GENE-like vorticity
    snapshots (ITG/TEM/ETG spectral regimes) -> periodic streamfunction.  One
    cosine-annealed Adam run (3e-3 -> 1e-5, batches of 16) in segments of at
    most 1500 steps that carry the parameters and the Adam state, as the JAX
    trainer runs it; evaluated on ``device``.  Returns the metrics."""
    from scpn_fusion_tpu_torch.models.surrogates.fno import (
        fno_apply_batched,
        fno_leaves,
        init_fno,
        train_fno,
    )

    rng = np.random.default_rng(seed)
    regimes = ["ITG", "TEM", "ETG"]

    def make(n, scale=None):
        x = np.stack([_gene_like_field(grid, regimes[i % 3], rng) for i in range(n)])
        y = np.stack([_periodic_streamfunction(f) for f in x])
        scale = y.std() if scale is None else scale
        return (x[..., None].astype(np.float32),
                (y / scale)[..., None].astype(np.float32), scale)

    x_tr, y_tr, scale = make(n_train)
    x_te, y_te, _ = make(n_test, scale)

    generator = torch.Generator().manual_seed(seed)
    params = init_fno(generator, width=width, modes=modes, n_layers=n_layers, device=device)
    seg = 1500
    x_tr_d, y_tr_d = torch.from_numpy(x_tr).to(device), torch.from_numpy(y_tr).to(device)
    res = None
    done = 0
    while done < n_steps:
        k_steps = min(seg, n_steps - done)
        res = train_fno(params, x_tr_d, y_tr_d, generator, n_steps=k_steps, batch_size=16,
                        lr=3e-3, schedule="cosine", total_steps=n_steps,
                        opt_state=None if res is None else res.opt_state)
        params = res.params
        done += k_steps

    x_te_d = torch.from_numpy(x_te).to(device)
    with torch.no_grad():
        pred = torch.cat([fno_apply_batched(params, x_te_d[i:i + 8])
                          for i in range(0, len(x_te), 8)]).cpu().numpy()
    rel_l2 = float(np.linalg.norm(pred - y_te) / max(np.linalg.norm(y_te), 1e-30))

    arrays = {f"leaf_{i}": leaf.cpu().numpy() for i, leaf in enumerate(fno_leaves(params))}
    return _save_artifact(name, arrays, {
        "test_rel_l2": rel_l2,
        "task": "GENE-like vorticity -> periodic streamfunction",
        "grid": grid, "width": width, "modes": modes,
        "n_layers": n_layers, "n_train": n_train, "seed": seed,
        # Output normalisation: predictions are streamfunction / y_scale;
        # users denormalise with this, NOT their own batch std.
        "y_scale": float(scale),
    }, out_dir)


def load_fno_turbulence(name: str = "fno_turbulence", weights_dir: Path | None = None, *,
                        device: torch.device | str = "cuda"):
    """Fail-closed load; returns (predict_fn, metrics) where predict_fn maps
    (n, H, W, 1) vorticity to the normalised streamfunction."""
    from scpn_fusion_tpu_torch.models.surrogates.fno import fno_apply_batched, fno_from_leaves

    arrays, metrics = _load_artifact(name, weights_dir)
    n_layers = int(metrics["n_layers"])
    n_leaves = 2 + 5 * n_layers + 4
    if sum(1 for k in arrays if k.startswith("leaf_")) != n_leaves:
        raise ValueError(f"{name!r}: expected {n_leaves} leaves for {n_layers} layers")
    params = fno_from_leaves([torch.from_numpy(arrays[f"leaf_{i}"]).to(device)
                              for i in range(n_leaves)], n_layers)

    def predict(x: torch.Tensor) -> torch.Tensor:
        return fno_apply_batched(params, x)

    return predict, metrics


# ── Neural-equilibrium artifact ──

BASE_COILS = ((3.5, 4.8, -1.0), (8.0, 4.8, 4.0), (10.8, 0.0, 6.0),
              (8.0, -4.8, 4.0), (3.5, -4.8, -1.0), (10.8, 2.5, 3.0))


def equilibrium_training_config(grid_n: int):
    """The standard 6-coil configuration the equilibrium artifact is trained
    on (Ip 150, mu0 = 1, (2, 10) x (-4, 4), the multigrid Picard solve)."""
    from scpn_fusion_tpu_torch.core.config import (
        Coil,
        Dimensions,
        PhysicsParams,
        ReactorConfig,
        SolverParams,
    )

    return ReactorConfig(
        reactor_name="surrogate-train",
        grid_resolution=(grid_n, grid_n),
        dimensions=Dimensions(R_min=2.0, R_max=10.0, Z_min=-4.0, Z_max=4.0),
        coils=tuple(Coil(r=r, z=z, current=c) for r, z, c in BASE_COILS),
        physics=PhysicsParams(plasma_current_target=150.0, vacuum_permeability=1.0),
        solver=SolverParams(max_iterations=80, convergence_threshold=1e-4,
                            relaxation_factor=0.1, solver_method="multigrid"))


def train_equilibrium_artifact(*, name: str = "neural_equilibrium", n_train: int = 160,
                               n_test: int = 20, grid_n: int = 65, n_modes: int = 12,
                               n_steps: int = 2500, seed: int = 0,
                               out_dir: Path | None = None,
                               device: torch.device | str = "cuda") -> dict:
    """Train and write the PCA+MLP equilibrium surrogate on the port's own
    converged float32 free-boundary solves: random coil currents (x0.7-1.3
    around the standard six) -> psi maps.  On the card every inner Picard
    iteration of a solve runs the fused source and the fused V-cycle.
    Returns the metrics."""
    from scpn_fusion_tpu_torch.core.grid import Grid
    from scpn_fusion_tpu_torch.models.equilibrium.free_boundary import (
        coilset_from_config,
        solve_free_boundary,
    )
    from scpn_fusion_tpu_torch.models.surrogates.equilibrium_surrogate import (
        train_equilibrium_surrogate,
    )

    cfg = equilibrium_training_config(grid_n)
    grid = Grid.from_config(cfg, dtype=torch.float32, device=device)
    coils0 = coilset_from_config(cfg, torch.float32, device)

    rng = np.random.default_rng(seed)
    n_total = n_train + n_test
    base_i = coils0.currents.cpu().numpy()
    # Inputs = the 6 coil currents only (Ip stays the config's)
    inputs = (base_i[None, :] * rng.uniform(0.7, 1.3, (n_total, base_i.size))
              ).astype(np.float32)

    def solve_one(currents):
        c = coils0._replace(currents=torch.from_numpy(currents).to(device))
        res = solve_free_boundary(cfg, c, grid=grid, mu0_green=1.0, dtype=torch.float32,
                                  device=device)
        return res.psi.detach()

    psi_maps = torch.stack([solve_one(row) for row in inputs])
    x = torch.from_numpy(inputs).to(device)

    sur = train_equilibrium_surrogate(
        x[:n_train], psi_maps[:n_train], torch.Generator().manual_seed(seed),
        n_modes=n_modes, n_steps=n_steps)

    with torch.no_grad():
        pred = torch.stack([sur.predict(xi) for xi in x[n_train:]]).cpu().numpy()
    truth = psi_maps[n_train:].cpu().numpy()
    rel_l2 = float(np.linalg.norm(pred - truth) / max(np.linalg.norm(truth), 1e-30))

    arrays = {**{k: getattr(sur, k).cpu().numpy()
                 for k in ("components", "psi_mean", "x_mean", "x_std", "coeff_scale")},
              **_mlp_arrays(sur.mlp)}
    return _save_artifact(name, arrays, {
        "test_rel_l2": rel_l2,
        "task": "6 coil currents -> free-boundary psi map (Ip fixed 150)",
        "grid": grid_n, "n_modes": n_modes,
        "n_train": n_train, "seed": seed,
    }, out_dir)
