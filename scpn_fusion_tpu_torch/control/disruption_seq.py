"""Causal-transformer disruption predictor + hard overlapping-cohort bench
(port of ``scpn_fusion_tpu/control/disruption_seq.py``).

The model is the JAX package's at its published width (d_model 32, 4 heads,
feed-forward 64, 2 layers): pre-norm layers with a population-variance
layer norm (``rsqrt(var + 1e-6)``), causal multi-head attention whose mask
is JAX's ``-1e9`` (not ``-inf``), the tanh GELU and a per-tick logit head.
Every function takes a leading batch of shots where JAX ``vmap``s one shot.
Its products are ``torch.matmul`` and its softmax ``torch.softmax``: the
JAX package computes them outside any Pallas kernel, as XLA's products.

Training is optax's chain written out: ``adamw(lr, weight_decay,
mask=decay_mask)`` (Adam's moments and bias corrections, then the decayed
weights of the masked leaves, then ``-lr``) and ``masked(set_to_zero)`` on
the normalisation statistics, which therefore never move and take no
gradient here.  The loss is optax's ``sigmoid_binary_cross_entropy`` (the
log-sigmoid form), weighted and normalised by the weights' sum.

The draws rule: :func:`init_seq_predictor` and :func:`train_seq_predictor`
draw from a ``torch.Generator``; :func:`_train_seq_predictor` takes the
initial parameters and the (n_steps, batch) minibatch indices, so a test can
feed it JAX's.  The cohort generators are numpy and carried over as they
are.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

D_MODEL = 32
N_HEADS = 4
D_FF = 64
N_LAYERS = 2


class LayerParams(NamedTuple):
    wq: torch.Tensor
    wk: torch.Tensor
    wv: torch.Tensor
    wo: torch.Tensor
    ln1_g: torch.Tensor
    ln1_b: torch.Tensor
    ln2_g: torch.Tensor
    ln2_b: torch.Tensor
    ff1_w: torch.Tensor
    ff1_b: torch.Tensor
    ff2_w: torch.Tensor
    ff2_b: torch.Tensor


class SeqPredictorParams(NamedTuple):
    embed_w: torch.Tensor      # (C, d)
    embed_b: torch.Tensor      # (d,)
    pos: torch.Tensor          # (T_max, d) learned positional encoding
    layers: tuple              # N_LAYERS x LayerParams
    head_w: torch.Tensor       # (d, 1)
    head_b: torch.Tensor       # (1,)
    x_mean: torch.Tensor       # (C,) channel normalisation
    x_std: torch.Tensor        # (C,)


# optax.adamw's decay mask of train_seq_predictor: the matrices of the
# embedding, the attention and the feed-forward decay; biases, norms, the
# positional table and the head do not
LAYER_DECAY = dict(wq=True, wk=True, wv=True, wo=True, ln1_g=False, ln1_b=False, ln2_g=False,
                   ln2_b=False, ff1_w=True, ff1_b=False, ff2_w=True, ff2_b=False)
TOP_DECAY = dict(embed_w=True, embed_b=False, pos=False, head_w=False, head_b=False)


def init_seq_predictor(generator: torch.Generator, n_channels: int, seq_len: int,
                       dtype=torch.float32, device: torch.device | str = "cuda"
                       ) -> SeqPredictorParams:
    """Xavier-initialised causal transformer (reference dims: 32/4/64/2),
    the normals drawn from ``generator``."""
    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=generator.device).to(device)

    def lin(fan_in, fan_out):
        return math.sqrt(2.0 / (fan_in + fan_out)) * normal(fan_in, fan_out)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=device)

    layers = tuple(LayerParams(
        wq=lin(D_MODEL, D_MODEL), wk=lin(D_MODEL, D_MODEL), wv=lin(D_MODEL, D_MODEL),
        wo=lin(D_MODEL, D_MODEL), ln1_g=ones(D_MODEL), ln1_b=zeros(D_MODEL),
        ln2_g=ones(D_MODEL), ln2_b=zeros(D_MODEL), ff1_w=lin(D_MODEL, D_FF), ff1_b=zeros(D_FF),
        ff2_w=lin(D_FF, D_MODEL), ff2_b=zeros(D_MODEL)) for _ in range(N_LAYERS))
    return SeqPredictorParams(
        embed_w=lin(n_channels, D_MODEL), embed_b=zeros(D_MODEL),
        pos=0.02 * normal(seq_len, D_MODEL), layers=layers, head_w=lin(D_MODEL, 1),
        head_b=zeros(1), x_mean=zeros(n_channels), x_std=ones(n_channels))


def _layernorm(x, g, b):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return g * (x - mu) * torch.rsqrt(var + 1e-6) + b


def _causal_attention(h: torch.Tensor, lp: LayerParams) -> torch.Tensor:
    """Multi-head causal self-attention, h: (..., T, d)."""
    t_len = h.shape[-2]
    d_head = D_MODEL // N_HEADS
    lead = h.shape[:-2]
    q = (h @ lp.wq).reshape(*lead, t_len, N_HEADS, d_head).transpose(-2, -3)
    k = (h @ lp.wk).reshape(*lead, t_len, N_HEADS, d_head).transpose(-2, -3)
    v = (h @ lp.wv).reshape(*lead, t_len, N_HEADS, d_head).transpose(-2, -3)
    scores = (q @ k.transpose(-1, -2)) / torch.sqrt(
        torch.tensor(d_head, dtype=h.dtype, device=h.device))
    causal = torch.tril(torch.ones((t_len, t_len), dtype=torch.bool, device=h.device))
    scores = torch.where(causal, scores, torch.tensor(-1e9, dtype=h.dtype, device=h.device))
    attn = torch.softmax(scores, dim=-1)
    out = (attn @ v).transpose(-2, -3).reshape(*lead, t_len, D_MODEL)
    return out @ lp.wo


def seq_logits(params: SeqPredictorParams, signals: torch.Tensor) -> torch.Tensor:
    """Per-tick disruption logits, (..., T, C) -> (..., T).

    Pre-norm transformer with a causal mask: logit[t] depends only on
    signals[:t+1], so the trace is a valid online risk signal.
    """
    xn = (signals - params.x_mean) / params.x_std
    h = xn @ params.embed_w + params.embed_b + params.pos[: signals.shape[-2]]
    for lp in params.layers:
        h = h + _causal_attention(_layernorm(h, lp.ln1_g, lp.ln1_b), lp)
        hh = _layernorm(h, lp.ln2_g, lp.ln2_b)
        h = h + F.gelu(hh @ lp.ff1_w + lp.ff1_b, approximate="tanh") @ lp.ff2_w + lp.ff2_b
    return (h @ params.head_w + params.head_b)[..., 0]


def seq_risk(params: SeqPredictorParams, signals: torch.Tensor) -> torch.Tensor:
    """Per-tick disruption risk in [0, 1], (..., T, C) -> (..., T)."""
    return torch.sigmoid(seq_logits(params, signals))


# ── Hard synthetic cohort (overlapping classes, VERDICT r3 #5) ──────────

MODES = ("ntm", "density_limit", "vde")


@dataclasses.dataclass(frozen=True)
class CohortConfig:
    """Generator configuration; train vs test use DIFFERENT instances
    (the held-out generator-config split)."""
    n_shots: int = 64
    t_len: int = 240
    noise: float = 0.4
    onset_lo_frac: float = 0.33
    onset_hi_frac: float = 0.66
    amp_lo: float = 0.5          # disruptive precursor amplitude range …
    amp_hi: float = 1.6
    benign_amp_hi: float = 1.0   # … overlaps safe benign-transient range
    benign_rate: float = 2.0     # mean benign transients per safe shot
    growth_tau: float = 40.0
    label_flip: float = 0.0      # fraction of SHOT labels flipped (train)


TRAIN_CONFIG = CohortConfig(n_shots=96, noise=0.4, label_flip=0.08)
# Domain-randomised training family: four generator configs spanning
# noise / growth-rate / onset / clutter ranges.  The held-out TEST_CONFIG
# sits at-or-past the edge of every range SIMULTANEOUSLY (noisier, slower
# growth, later onset, weaker amps, more clutter) — a combination no
# training shot was drawn from.
TRAIN_CONFIGS = (
    CohortConfig(n_shots=64, noise=0.35, label_flip=0.08),
    CohortConfig(n_shots=64, noise=0.50, growth_tau=50.0, amp_lo=0.5,
                 amp_hi=1.4, benign_rate=2.5, label_flip=0.08),
    CohortConfig(n_shots=64, noise=0.45, onset_lo_frac=0.40,
                 onset_hi_frac=0.72, growth_tau=45.0, label_flip=0.08),
    CohortConfig(n_shots=64, noise=0.40, amp_lo=0.45, amp_hi=1.2,
                 benign_amp_hi=1.1, benign_rate=3.0, label_flip=0.08),
)
TEST_CONFIG = CohortConfig(n_shots=64, noise=0.55, onset_lo_frac=0.45,
                           onset_hi_frac=0.75, amp_lo=0.45, amp_hi=1.3,
                           benign_amp_hi=1.1, benign_rate=3.0,
                           growth_tau=55.0)


def generate_training_family(seed: int, configs=TRAIN_CONFIGS):
    """Concatenated domain-randomised training cohort."""
    shots, clean, noisy, onsets = [], [], [], []
    for j, cfg in enumerate(configs):
        s, c, nz, o = generate_hard_cohort(cfg, seed + 1000 * j)
        shots.append(s)
        clean.append(c)
        noisy.append(nz)
        onsets.append(o)
    return (np.concatenate(shots), np.concatenate(clean),
            np.concatenate(noisy), np.concatenate(onsets))


def generate_hard_cohort(cfg: CohortConfig, seed: int):
    """Balanced cohort where the classes genuinely overlap.

    Safe shots receive Poisson-count benign transients — decaying bursts
    in the same channels, amplitude U(0.2, benign_amp_hi) — overlapping
    the weak tail of the disruptive amplitude distribution U(amp_lo,
    amp_hi).  Disruptive shots get one of three growing precursor modes
    (reference ``disruption_roc_analysis.py`` scenario batch).  Returns
    (shots (N,T,C) f32, clean_labels (N,), noisy_labels (N,), onsets (N,)).
    """
    rng = np.random.default_rng(seed)
    n, t_len = cfg.n_shots, cfg.t_len
    shots = rng.standard_normal((n, t_len, 3)).astype(np.float32) * cfg.noise
    labels = (np.arange(n) % 2 == 0).astype(np.float32)
    onsets = np.full(n, -1, dtype=np.int64)

    for i in range(n):
        # Benign clutter lands on BOTH classes (disruptive shots also have
        # unrelated transients), so transient presence alone is no signal.
        for _ in range(rng.poisson(cfg.benign_rate)):
            ch = int(rng.integers(3))
            t0 = int(rng.integers(0, t_len - 10))
            amp = float(rng.uniform(0.2, cfg.benign_amp_hi))
            dur = int(rng.integers(15, 45))
            t = np.arange(min(dur, t_len - t0), dtype=np.float32)
            burst = amp * np.exp(-t / (0.3 * dur))
            if ch == 0:
                burst = burst * np.sin(0.8 * t)
            shots[i, t0:t0 + len(t), ch] += burst

        if labels[i] < 0.5:
            continue
        mode = MODES[int(rng.integers(len(MODES)))]
        onset = int(rng.integers(int(cfg.onset_lo_frac * t_len),
                                 int(cfg.onset_hi_frac * t_len)))
        onsets[i] = onset
        amp = float(rng.uniform(cfg.amp_lo, cfg.amp_hi))
        t = np.arange(t_len - onset, dtype=np.float32)
        grow = 1.0 - np.exp(-t / cfg.growth_tau)
        if mode == "ntm":
            shots[i, onset:, 0] += amp * grow * np.sin(0.8 * t)
        elif mode == "density_limit":
            shots[i, onset:, 1] += amp * grow
        else:
            shots[i, onset:, 2] += amp * grow * (1.0 + 0.3 * np.sin(0.2 * t))

    noisy = labels.copy()
    if cfg.label_flip > 0.0:
        flip = rng.random(n) < cfg.label_flip
        noisy[flip] = 1.0 - noisy[flip]
    return shots, labels, noisy, onsets


# ── Training ────────────────────────────────────────────────────────────


class SeqTrainResult(NamedTuple):
    params: SeqPredictorParams
    loss_history: torch.Tensor


def flatten(params: SeqPredictorParams) -> tuple[list, list]:
    """(trained leaves, their decay flags) in a fixed order; the
    normalisation statistics are not among them."""
    leaves, decay = [], []
    for name, flag in TOP_DECAY.items():
        if name == "head_w":
            for lp in params.layers:
                for lname, lflag in LAYER_DECAY.items():
                    leaves.append(getattr(lp, lname))
                    decay.append(lflag)
        leaves.append(getattr(params, name))
        decay.append(flag)
    return leaves, decay


def unflatten(leaves: list, like: SeqPredictorParams) -> SeqPredictorParams:
    it = iter(leaves)
    top = {}
    layers = like.layers
    for name in TOP_DECAY:
        if name == "head_w":
            layers = tuple(LayerParams(*(next(it) for _ in LAYER_DECAY)) for _ in like.layers)
        top[name] = next(it)
    return like._replace(layers=layers, **top)


def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax's form: ``-y log_sigmoid(x) - (1 - y) log_sigmoid(-x)``."""
    labels = labels.to(logits.dtype)
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def _adamw_update(g, p, mu, nu, count: int, lr: float, weight_decay: float, decay: bool,
                  b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One step of ``optax.adamw(lr, weight_decay=..., mask=...)`` on one
    leaf: (update, mu, nu), the update to add to the parameter."""
    mu = (1 - b1) * g + b1 * mu
    nu = (1 - b2) * g**2 + b2 * nu
    count += 1
    mu_hat = mu / (1 - b1**count)
    nu_hat = nu / (1 - b2**count)
    u = mu_hat / (torch.sqrt(nu_hat) + eps)
    if decay:
        u = u + weight_decay * p
    return -lr * u, mu, nu


def tick_targets(labels: torch.Tensor, onsets: torch.Tensor, t_len: int,
                 pos_end: torch.Tensor | None = None):
    """(targets (N, T), weights (N, T)) of :func:`train_seq_predictor`."""
    dev = labels.device
    ticks = torch.arange(t_len, device=dev)
    fake_onset = int(0.75 * t_len)
    eff_onset = torch.where(onsets >= 0, onsets + 20, torch.full_like(onsets, fake_onset))
    dis = labels[:, None] > 0.5
    y = dis & (ticks[None, :] >= eff_onset[:, None])
    ambiguous = (dis & (ticks[None, :] >= torch.where(onsets >= 0, onsets,
                                                      torch.full_like(onsets, t_len))[:, None])
                 & (ticks[None, :] < eff_onset[:, None]))
    if pos_end is not None:
        ambiguous = ambiguous | (dis & (ticks[None, :] >= pos_end[:, None]))
    return y, ambiguous


def train_seq_predictor(shots: torch.Tensor, labels: torch.Tensor, onsets: torch.Tensor,
                        generator: torch.Generator, *, n_steps: int = 600, batch_size: int = 16,
                        lr: float = 3e-4, weight_decay: float = 1e-3,
                        pos_end: torch.Tensor | None = None) -> SeqTrainResult:
    """Per-tick BCE training (the JAX package's docstring holds: tick
    targets past onset + 20, a fake onset at 3/4 of the shot for flipped
    labels, the ramp ticks dropped, class-balanced weights, ``pos_end``
    masking the quench); the initial parameters and the minibatches are
    drawn from ``generator``."""
    n, t_len, c = shots.shape
    params0 = init_seq_predictor(generator, c, t_len, dtype=shots.dtype, device=shots.device)
    idx = torch.randint(0, n, (n_steps, batch_size), generator=generator,
                        device=generator.device).to(shots.device)
    return _train_seq_predictor(shots, labels, onsets, params0, idx, lr=lr,
                                weight_decay=weight_decay, pos_end=pos_end)


def _train_seq_predictor(shots: torch.Tensor, labels: torch.Tensor, onsets: torch.Tensor,
                         params0: SeqPredictorParams, batch_idx: torch.Tensor, *,
                         lr: float = 3e-4, weight_decay: float = 1e-3,
                         pos_end: torch.Tensor | None = None) -> SeqTrainResult:
    """:func:`train_seq_predictor` from ``params0`` (whose normalisation is
    replaced by the cohort's) with the (n_steps, batch) indices given."""
    n, t_len, c = shots.shape
    y, ambiguous = tick_targets(labels, onsets, t_len, pos_end)
    y = y.to(shots.dtype)
    w_pos = (1.0 - y).sum() / torch.clamp(y.sum(), min=1.0)
    weights = torch.where(y > 0.5, w_pos, torch.ones_like(y)) * (1.0 - ambiguous.to(y.dtype))

    x_mean = shots.mean(dim=(0, 1))
    x_std = torch.clamp(shots.std(dim=(0, 1), unbiased=False), min=1e-9)
    params = params0._replace(x_mean=x_mean, x_std=x_std)
    flat, decay = flatten(params)
    flat = [p.detach() for p in flat]
    mu = [torch.zeros_like(p) for p in flat]
    nu = [torch.zeros_like(p) for p in flat]
    losses = []
    for k in range(batch_idx.shape[0]):
        idx = batch_idx[k]
        live = [p.requires_grad_(True) for p in flat]
        logits = seq_logits(unflatten(live, params), shots[idx])
        wb = weights[idx]
        loss = (sigmoid_binary_cross_entropy(logits, y[idx]) * wb).sum() / wb.sum()
        grads = torch.autograd.grad(loss, live)
        new = []
        for i, (p, g) in enumerate(zip(flat, grads)):
            upd, mu[i], nu[i] = _adamw_update(g, p, mu[i], nu[i], k, lr, weight_decay,
                                              decay[i])
            new.append(p.detach() + upd)
        flat = new
        losses.append(loss.detach())
    return SeqTrainResult(unflatten(flat, params), torch.stack(losses))


def shot_scores(params: SeqPredictorParams, shots: torch.Tensor,
                settle: int = 24) -> torch.Tensor:
    """Shot-level disruption score: max per-tick risk after a settle-in
    period (the first ticks have no causal context)."""
    return seq_risk(params, shots)[:, settle:].amax(dim=1)


def roc_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Exact ROC AUC via the rank statistic (ties handled)."""
    pos = scores[labels > 0.5]
    neg = scores[labels <= 0.5]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    greater = (pos[:, None] > neg[None, :]).sum()
    equal = (pos[:, None] == neg[None, :]).sum()
    return float((greater + 0.5 * equal) / (len(pos) * len(neg)))
