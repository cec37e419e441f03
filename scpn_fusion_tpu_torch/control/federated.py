"""Federated disruption-predictor training (FedAvg / FedProx + DP-SGD)
(port of ``scpn_fusion_tpu/control/federated.py``).

Clients sit on a leading axis, as JAX stacks them: each client's MLP is one
slice of batched weights (M, in, out), a local epoch of minibatch SGD runs
every client at once, the FedAvg reduction is a data-weighted sum over the
client axis, and the DP clip (global norm, summed in float32 as JAX does)
and Gaussian noise apply to each client's update.

The draws rule: :func:`train_federated` draws the initial weights, every
(round, client, epoch) permutation and every (round, client) DP noise from a
``torch.Generator``; :func:`_run_federation` takes them as tensors, so a test
can feed it JAX's ``permutation`` and ``normal`` draws.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from scpn_fusion_tpu_torch.models.surrogates.mlp import MLPParams, init_mlp, leaves, mlp_apply

# Feature layout: [locked_mode_amp, dbp_dt, q95, n_over_ngw, li, beta_n]
N_FEATURES = 6

MACHINE_SIGNATURES = {
    # machine: (locked_base, dbp_base, q95_base, ngw_base, li, beta_n)
    "diiid": (0.10, 0.12, 4.2, 0.55, 0.9, 1.9),
    "jet": (0.14, 0.15, 3.6, 0.62, 1.0, 1.7),
    "cmod": (0.08, 0.20, 4.6, 0.70, 1.1, 1.2),
    "aug": (0.11, 0.14, 4.0, 0.58, 0.95, 1.8),
}


@dataclasses.dataclass(frozen=True)
class FederatedConfig:
    machines: tuple[str, ...] = ("diiid", "jet", "cmod", "aug")
    n_samples: int = 256
    disruption_fraction: float = 0.3
    hidden: tuple[int, ...] = (32, 16)
    local_epochs: int = 5
    batch_size: int = 64
    learning_rate: float = 1e-2
    n_rounds: int = 10
    aggregation: str = "fedavg"        # "fedavg" | "fedprox"
    fedprox_mu: float = 0.1
    dp_enabled: bool = True
    dp_max_norm: float = 5.0
    dp_noise_sigma: float = 1e-3

    def __post_init__(self):
        if not self.machines:
            raise ValueError("at least one machine required")
        if not 0.0 < self.disruption_fraction < 1.0:
            raise ValueError("disruption_fraction must be in (0, 1)")
        if self.aggregation not in ("fedavg", "fedprox"):
            raise ValueError(f"unknown aggregation {self.aggregation!r}")


def generate_disruption_data(machine: str, n_samples: int, disruption_fraction: float,
                             seed: int):
    """Synthetic labelled shots for one machine, as numpy float32 (x (n, 6),
    y (n,)): the JAX package's generator, whose arrays it hands to JAX."""
    if machine not in MACHINE_SIGNATURES:
        raise ValueError(f"unknown machine {machine!r}")
    lm, db, q95, ngw, li, bn = MACHINE_SIGNATURES[machine]
    rng = np.random.default_rng(seed)
    n_dis = int(n_samples * disruption_fraction)
    n_safe = n_samples - n_dis
    safe = np.stack([
        rng.normal(lm, 0.03, n_safe),
        rng.normal(db, 0.04, n_safe),
        rng.normal(q95, 0.4, n_safe),
        rng.normal(ngw, 0.08, n_safe),
        rng.normal(li, 0.08, n_safe),
        rng.normal(bn, 0.2, n_safe),
    ], axis=1)
    dis = np.stack([
        rng.normal(lm * 4.0, 0.08, n_dis),
        rng.normal(db * 3.0, 0.08, n_dis),
        rng.normal(q95 - 1.2, 0.4, n_dis),
        rng.normal(min(ngw + 0.35, 0.98), 0.06, n_dis),
        rng.normal(li + 0.25, 0.1, n_dis),
        rng.normal(bn + 0.6, 0.25, n_dis),
    ], axis=1)
    x = np.concatenate([safe, dis], axis=0).astype(np.float32)
    y = np.concatenate([np.zeros(n_safe), np.ones(n_dis)]).astype(np.float32)
    perm = rng.permutation(n_samples)
    return x[perm], y[perm]


# Fixed per-feature standardisation (constants of the model contract)
_FEAT_MEAN = np.asarray([0.2, 0.2, 3.8, 0.65, 1.0, 1.9], np.float32)
_FEAT_SCALE = np.asarray([0.15, 0.15, 0.8, 0.15, 0.15, 0.4], np.float32)


def _featurize(x: torch.Tensor) -> torch.Tensor:
    mean = torch.from_numpy(_FEAT_MEAN).to(device=x.device, dtype=x.dtype)
    scale = torch.from_numpy(_FEAT_SCALE).to(device=x.device, dtype=x.dtype)
    return (x - mean) / scale


def _mlp_clients(params: MLPParams, x: torch.Tensor) -> torch.Tensor:
    """The MLP of every client on its own rows: weights (M, in, out), x (M, n, in)."""
    h = x
    n = len(params.weights)
    for i, (w, b) in enumerate(zip(params.weights, params.biases)):
        h = torch.baddbmm(b[:, None, :], h, w)
        if i < n - 1:
            h = F.gelu(h, approximate="tanh")
    return h


def _bce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Numerically stable BCE with logits clipped to +-30, elementwise."""
    z = torch.clamp(logits, -30.0, 30.0)
    return torch.clamp(z, min=0.0) - z * y + torch.log1p(torch.exp(-z.abs()))


def _client_losses(params: MLPParams, x, y) -> torch.Tensor:
    """(M,) mean BCE of each client's model on its rows."""
    return _bce(_mlp_clients(params, _featurize(x))[..., 0], y).mean(-1)


def dp_clip_and_noise(update: list, max_norm: float, sigma: float, noise: list) -> list:
    """Global-norm clip + Gaussian noise on one model update (a list of
    leaves), the norm summed in float32 as JAX; ``noise`` holds a standard
    normal tensor per leaf."""
    total = sum((g.to(torch.float32) ** 2).sum() for g in update)
    total = torch.sqrt(total)
    norm = torch.tensor(max_norm, dtype=total.dtype, device=total.device)
    factor = torch.clamp(norm / torch.clamp(total, min=1e-12), max=1.0)
    return [g * factor + sigma * z for g, z in zip(update, noise)]


class FederatedTrace(NamedTuple):
    loss: torch.Tensor          # (n_rounds, n_machines) local post-train loss
    global_loss: torch.Tensor   # (n_rounds,) mean eval loss of global model
    accuracy: torch.Tensor      # (n_rounds,) global-model accuracy


def _local_train(cfg: FederatedConfig, gp: MLPParams, xs, ys, perms: torch.Tensor):
    """local_epochs of minibatch SGD of every client from the global model
    (optionally FedProx-proximal); ``perms`` (M, epochs, n).  Returns the
    local models (leaves with a leading client axis) and their losses."""
    m, n = xs.shape[0], xs.shape[1]
    n_layers = len(gp.weights)
    g_leaves = leaves(gp)
    flat = [p[None].expand(m, *p.shape).clone() for p in g_leaves]
    n_batches = max(n // cfg.batch_size, 1)
    rows = torch.arange(m, device=xs.device)[:, None]
    for e in range(cfg.local_epochs):
        for i in range(n_batches):
            idx = perms[:, e, i * cfg.batch_size:(i + 1) * cfg.batch_size]
            live = [p.requires_grad_(True) for p in flat]
            params = MLPParams(tuple(live[:n_layers]), tuple(live[n_layers:]))
            loss = _client_losses(params, xs[rows, idx], ys[rows, idx])
            if cfg.aggregation == "fedprox":
                prox = sum(((a - b[None]) ** 2).flatten(1).sum(-1)
                           for a, b in zip(live, g_leaves))
                loss = loss + 0.5 * cfg.fedprox_mu * prox
            grads = torch.autograd.grad(loss.sum(), live)
            flat = [(w - cfg.learning_rate * g).detach() for w, g in zip(flat, grads)]
    local = MLPParams(tuple(flat[:n_layers]), tuple(flat[n_layers:]))
    with torch.no_grad():
        return flat, _client_losses(local, xs, ys)


def _run_federation(cfg: FederatedConfig, global_params: MLPParams, xs, ys, weights,
                    perms: torch.Tensor, dp_noise: list | None):
    """All federation rounds.  xs, ys: (M, n, ...) stacked client datasets;
    weights (M,) the FedAvg weights; perms (n_rounds, M, epochs, n); dp_noise
    one (n_rounds, M, *leaf) standard-normal tensor per leaf (weights, then
    biases), or None without DP."""
    n_layers = len(global_params.weights)
    gp = MLPParams(*(tuple(p.detach() for p in part) for part in global_params))
    losses, gl, acc = [], [], []
    for r in range(cfg.n_rounds):
        local, loss_r = _local_train(cfg, gp, xs, ys, perms[r])
        updates = [lp - g[None] for lp, g in zip(local, leaves(gp))]
        if cfg.dp_enabled:
            per_client = [dp_clip_and_noise([u[c] for u in updates], cfg.dp_max_norm,
                                            cfg.dp_noise_sigma, [z[r, c] for z in dp_noise])
                          for c in range(xs.shape[0])]
            updates = [torch.stack([pc[j] for pc in per_client]) for j in range(len(updates))]
        w = weights / weights.sum()
        new = [(g + torch.tensordot(w.to(u.dtype), u, dims=([0], [0]))).to(g.dtype)
               for g, u in zip(leaves(gp), updates)]
        gp = MLPParams(tuple(new[:n_layers]), tuple(new[n_layers:]))
        with torch.no_grad():
            lead = xs.shape[:2]
            logits = mlp_apply(gp, _featurize(xs).reshape(-1, xs.shape[-1]))[:, 0].reshape(lead)
            z = torch.clamp(logits, -30.0, 30.0)
            gl.append(_bce(z, ys).mean())
            acc.append(((torch.sigmoid(z) > 0.5) == (ys > 0.5)).to(torch.float32).mean())
        losses.append(loss_r)
    return gp, FederatedTrace(torch.stack(losses), torch.stack(gl), torch.stack(acc))


def client_datasets(cfg: FederatedConfig, seed: int):
    """The stacked per-machine datasets (numpy float32), as JAX builds them."""
    data = [generate_disruption_data(m, cfg.n_samples, cfg.disruption_fraction,
                                     seed=seed + 17 * i) for i, m in enumerate(cfg.machines)]
    return np.stack([x for x, _ in data]), np.stack([y for _, y in data])


def train_federated(cfg: FederatedConfig, seed: int = 0, *, dtype=torch.float32,
                    device: torch.device | str = "cuda"):
    """Build per-machine datasets, run all rounds, return (params, trace);
    the initial weights, permutations and DP noise are drawn from a CPU
    ``torch.Generator`` seeded with ``seed`` (the same draws on every
    device).  ``dtype`` is the model's and the data's: float32, which JAX
    fixes, by default."""
    xs_np, ys_np = client_datasets(cfg, seed)
    xs = torch.from_numpy(xs_np).to(device=device, dtype=dtype)
    ys = torch.from_numpy(ys_np).to(device=device, dtype=dtype)
    m = len(cfg.machines)
    weights = torch.full((m,), float(cfg.n_samples), dtype=dtype, device=device)
    gen = torch.Generator().manual_seed(seed)
    params = init_mlp(gen, (N_FEATURES, *cfg.hidden, 1), dtype=dtype, device=device)
    perms = torch.stack([torch.stack([torch.stack([
        torch.randperm(cfg.n_samples, generator=gen) for _ in range(cfg.local_epochs)])
        for _ in range(m)]) for _ in range(cfg.n_rounds)]).to(device)
    noise = None
    if cfg.dp_enabled:
        noise = [torch.randn((cfg.n_rounds, m, *p.shape), generator=gen, dtype=dtype).to(device)
                 for p in leaves(params)]
    return _run_federation(cfg, params, xs, ys, weights, perms, noise)


def predict_disruption_risk(params: MLPParams, features) -> torch.Tensor:
    """Sigmoid risk in [0, 1] for raw feature rows."""
    return torch.sigmoid(mlp_apply(params, _featurize(torch.atleast_2d(features)))[:, 0])
