"""GyroSwin-like core-turbulence surrogate and the GENE-like proxy's speed
benchmark (port of ``scpn_fusion_tpu/models/surrogates/gyro_swin.py``).

A random-feature ridge regression (several tanh feature banks at different
bandwidths, one linear readout) learns a critical-gradient ITG closure, and
is timed against a deliberately iterative "GENE-like proxy" that relaxes a
self-consistent saturation fixed point a sample.

The dataset and the random features are drawn with numpy's
``default_rng``, as in JAX, so they need no generator.  The ridge solve
stays in float64 numpy on the host, as in JAX: the ~1.5k-feature Gram
system is ill-conditioned.  The proxy's 20,000-iteration loop runs as ONE
launch of row W (``ops/cuda_proxy.gene_proxy``, ``csrc/gene_proxy.cu``) on
the card; on a CPU tensor it runs the plain loop.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

N_FEATURES = 6   # [R/L_Ti, R/L_Te, R/L_ne, q, s_hat, nu_star]


def synthetic_core_turbulence_target(features: torch.Tensor) -> torch.Tensor:
    """chi_i closure the surrogate learns: critical-gradient ITG drive with q
    amplification, shear and collisional damping, and a smooth saturation.
    Row W's kernel repeats these operations in this order."""
    x = torch.atleast_2d(features)
    rlti, rlte, rlne, q, s_hat, nu = (x[:, i] for i in range(N_FEATURES))
    crit = 4.0 + 0.8 * torch.clamp(s_hat, min=0.0)
    drive = torch.clamp(rlti - crit, min=0.0)
    chi = (0.1 + 1.1 * q * drive / (1.0 + 0.4 * nu)
           + 0.15 * torch.clamp(rlte - 4.0, min=0.0)
           + 0.05 * rlne)
    return torch.tanh(chi / 8.0) * 8.0          # smooth saturation


def generate_synthetic_dataset(seed: int, samples: int, *, dtype=torch.float32):
    """(x, y) as float32 numpy arrays; y is the closure computed in ``dtype``
    (JAX computes it in its default float, float64 under x64), then cast."""
    rng = np.random.default_rng(seed)
    x = np.stack([
        rng.uniform(1.0, 12.0, samples),   # R/L_Ti
        rng.uniform(1.0, 12.0, samples),   # R/L_Te
        rng.uniform(0.0, 6.0, samples),    # R/L_ne
        rng.uniform(1.0, 5.0, samples),    # q
        rng.uniform(-0.5, 2.5, samples),   # s_hat
        10.0 ** rng.uniform(-2.0, 1.0, samples),   # nu_star
    ], axis=1)
    y = synthetic_core_turbulence_target(torch.from_numpy(x).to(dtype)).numpy()
    return x.astype(np.float32), y.astype(np.float32)


class GyroSwinSurrogate(NamedTuple):
    """Multi-bandwidth random-feature ridge model."""

    w_random: torch.Tensor     # (n_banks, N_FEATURES, hidden)
    b_random: torch.Tensor     # (n_banks, hidden)
    x_mean: torch.Tensor
    x_std: torch.Tensor
    weights: torch.Tensor      # (n_banks * hidden + 1,) ridge solution

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        xn = (torch.atleast_2d(x) - self.x_mean) / self.x_std
        h = torch.tanh(torch.einsum("nf,bfh->bnh", xn, self.w_random)
                       + self.b_random[:, None, :])
        h = h.permute(1, 0, 2).reshape(xn.shape[0], -1)
        return torch.cat([h, torch.ones((h.shape[0], 1), dtype=h.dtype, device=h.device)],
                         dim=1)

    def predict(self, features: torch.Tensor) -> torch.Tensor:
        return self._features(features) @ self.weights


def fit_gyro_swin(x, y, *, hidden: int = 512, sigmas: tuple = (0.5, 1.5, 3.0),
                  ridge: float = 5e-4, seed: int = 42,
                  device: torch.device | str = "cuda") -> GyroSwinSurrogate:
    """Closed-form ridge fit on the multi-bandwidth feature map: the features
    in float32 on ``device``, the normal equations in float64 on the host."""
    rng = np.random.default_rng(seed)
    w_r = torch.from_numpy(np.stack([
        rng.normal(0, s, (N_FEATURES, hidden)) for s in sigmas]).astype(np.float32)).to(device)
    b_r = torch.from_numpy(np.stack([
        rng.uniform(-2, 2, hidden) for _ in sigmas]).astype(np.float32)).to(device)
    x = torch.as_tensor(np.asarray(x)).to(device)
    x_mean = x.mean(dim=0)
    x_std = torch.clamp(x.std(dim=0, correction=0), min=1e-9)
    model = GyroSwinSurrogate(
        w_random=w_r, b_random=b_r, x_mean=x_mean, x_std=x_std,
        weights=torch.zeros((len(sigmas) * hidden + 1,), dtype=torch.float32, device=device))
    h1 = model._features(x).cpu().numpy().astype(np.float64)
    y64 = np.asarray(y, dtype=np.float64)
    gram = h1.T @ h1 + ridge * np.eye(h1.shape[1])
    weights = np.linalg.solve(gram, h1.T @ y64)
    return model._replace(weights=torch.from_numpy(weights.astype(np.float32)).to(device))


def gene_proxy_predict(features: torch.Tensor, iterations: int = 20_000) -> torch.Tensor:
    """Deliberately iterative 'GENE-like proxy': ``iterations`` steps of
    ``chi <- chi + 0.05 (target(x (1 + 0.005 tanh chi)) - chi)`` a sample,
    from chi = 0.  The closure depends on the evolving chi, so every step pays
    the full nonlinear evaluation.  ONE launch of row W on a CUDA tensor."""
    from scpn_fusion_tpu_torch.ops.cuda_proxy import gene_proxy

    return gene_proxy(torch.atleast_2d(features), iterations)


class SpeedBenchmark(NamedTuple):
    gene_proxy_s_per_sample: float
    surrogate_s_per_sample: float
    speedup: float
    rmse_percent: float


def rmse_percent(y_true, y_pred) -> float:
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    rms = float(np.sqrt(np.mean((y_true - y_pred) ** 2)))
    scale = float(np.sqrt(np.mean(y_true**2)))
    return 100.0 * rms / max(scale, 1e-12)


def _timed(fn, device: torch.device):
    """(result, seconds) of ``fn()``, the card synchronised on both sides."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def run_speed_benchmark(*, samples: int = 1024, seed: int = 7, iterations: int = 20_000,
                        device: torch.device | str = "cuda") -> SpeedBenchmark:
    """Accuracy and per-sample time of the surrogate against the proxy, each
    timed on its second call."""
    device = torch.device(device)
    x, y = generate_synthetic_dataset(seed, samples)
    model = fit_gyro_swin(x, y, ridge=5e-3, device=device)
    xd = torch.from_numpy(x).to(device)

    _timed(lambda: model.predict(xd), device)
    pred, t_sur = _timed(lambda: model.predict(xd), device)
    _timed(lambda: gene_proxy_predict(xd, iterations), device)
    _, t_gene = _timed(lambda: gene_proxy_predict(xd, iterations), device)
    t_sur, t_gene = t_sur / samples, t_gene / samples
    return SpeedBenchmark(
        gene_proxy_s_per_sample=t_gene,
        surrogate_s_per_sample=t_sur,
        speedup=t_gene / max(t_sur, 1e-12),
        rmse_percent=rmse_percent(y, pred.cpu().numpy()))
