"""Adaptive sigma-conditioned loss normalizer (MultiNoiseLoss).

Counterpart of autoregressive_diffusion_tpu/train/loss_weight.py: a rolling
history of (sigma, loss) pairs, log10(loss) fitted as a 7-basis Fourier
series in log10(sigma) by least squares.
  * `fourier_eval` runs inside the loss on torch tensors, taking the
    coefficient vector as a plain tensor;
  * `MultiNoiseState` lives on the host in numpy: it accumulates the
    (sigma, loss) outputs of each train step and refits every fit interval;
    the refreshed coefficients are fed back into the train state.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

NUM_TERMS = 4
NUM_BASIS = 2 * NUM_TERMS - 1  # 7: one constant + 3 cos/sin pairs
INTERVAL = (-np.pi, np.pi)     # in log10(sigma)
HISTORY_SIZE = 10_000


def fourier_basis(x_log10):
    """Basis [0.5, cos(n x), sin(n x)]_{n=1..3} evaluated at log10(sigma).
    Works for torch and numpy inputs; returns (..., NUM_BASIS)."""
    xp = torch if isinstance(x_log10, torch.Tensor) else np
    cols = [xp.ones_like(x_log10) * 0.5]
    for n in range(1, NUM_TERMS):
        cols.append(xp.cos(n * x_log10))
        cols.append(xp.sin(n * x_log10))
    return xp.stack(cols, -1)


def fourier_eval(coefs: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """mean_loss(sigma) = 10 ** (basis(log10 sigma) @ coefs). coefs: (7, 1).
    With zero coefs this is identically 1 (no normalization before the
    first fit)."""
    basis = fourier_basis(torch.log10(sigma))
    pred = basis.reshape(-1, NUM_BASIS) @ coefs.to(basis.dtype)
    return (10.0 ** pred).reshape(sigma.shape)


def init_coefs(device="cpu") -> torch.Tensor:
    return torch.zeros((NUM_BASIS, 1), dtype=torch.float32, device=device)


@dataclasses.dataclass
class MultiNoiseState:
    """Host-side rolling history + least-squares fit."""
    sigmas: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0,), np.float32))
    losses: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0,), np.float32))
    positions: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0,), np.int64))

    def add_data(self, sigmas, losses):
        """sigmas/losses: (b, t) arrays from the train step's metrics."""
        sigmas = np.asarray(sigmas, np.float32)
        losses = np.asarray(losses, np.float32)
        positions = np.arange(sigmas.size) % sigmas.shape[1]
        self.sigmas = np.concatenate([self.sigmas, sigmas.ravel()])[-HISTORY_SIZE:]
        self.losses = np.concatenate([self.losses, losses.ravel()])[-HISTORY_SIZE:]
        self.positions = np.concatenate([self.positions, positions])[-HISTORY_SIZE:]

    def fit(self) -> np.ndarray:
        """Least-squares fit of log10(loss) over the valid log-sigma
        interval. Returns (NUM_BASIS, 1) float32."""
        x, y = self.sigmas, self.losses
        xl = np.log10(x, where=x > 0, out=np.full_like(x, -np.inf))
        m = (xl >= INTERVAL[0]) & (xl <= INTERVAL[1]) & (y > 0)
        if m.sum() < NUM_BASIS:
            return np.zeros((NUM_BASIS, 1), np.float32)
        basis = np.asarray(fourier_basis(xl[m].astype(np.float64)))
        target = np.log10(y[m].astype(np.float64))[:, None]
        sol, *_ = np.linalg.lstsq(basis, target, rcond=None)
        return sol.astype(np.float32)


def fit_and_broadcast(state: MultiNoiseState) -> np.ndarray:
    """The fit, for every process: rank 0's, broadcast to every rank when
    a torch.distributed process group of several ranks is up (JAX package
    loss_weight.py), else the local fit."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return state.fit()
    box = [state.fit() if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]
