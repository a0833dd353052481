"""Magnitude-preserving numerics core (EDM2-style), PyTorch.

Counterpart of autoregressive_diffusion_tpu/ops/numerics.py, with the same
channels-LAST layouts: images (..., H, W, C), videos (B, T, H, W, C);
weights dense (in, out), conv2d HWIO, conv3d DHWIO. The output channel axis
is always last and weight normalization reduces over every other axis.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F


def normalize(x: torch.Tensor, dim=None, eps: float = 1e-4) -> torch.Tensor:
    """x / (eps + ||x||_dim * sqrt(1 / prod(reduced dims))), computed in fp32
    and cast back. The 1e-24 inside the sqrt keeps the norm differentiable
    at an exactly-zero vector (JAX package ops/numerics.py:30-48)."""
    if dim is None:
        dim = tuple(range(1, x.ndim))
    elif isinstance(dim, int):
        dim = (dim,)
    x32 = x.float()
    n = torch.sqrt(torch.sum(x32 * x32, dim=dim, keepdim=True) + 1e-24)
    reduced = 1
    for a in dim:
        reduced *= x.shape[a]
    n = eps + n * (1.0 / math.sqrt(reduced))
    return (x32 / n).to(x.dtype)


def mp_silu(x: torch.Tensor) -> torch.Tensor:
    """Magnitude-preserving SiLU (EDM2 Eq. 81)."""
    return F.silu(x) / 0.596


def bmult(x: torch.Tensor, t) -> torch.Tensor:
    """Broadcast multiply over leading dims, channels-last:
    t.ndim 0 -> scalar, 1 -> (b,) over the batch axis, 2 -> (b, c)."""
    t = torch.as_tensor(t, dtype=x.dtype, device=x.device)
    if t.ndim == 0:
        return x * t
    if t.ndim == 1:
        return x * t.reshape(t.shape + (1,) * (x.ndim - 1))
    b, c = t.shape
    return x * t.reshape((b,) + (1,) * (x.ndim - 2) + (c,))


def mp_sum(a: torch.Tensor, b: torch.Tensor, t=0.5) -> torch.Tensor:
    """Magnitude-preserving sum (EDM2 Eq. 88): lerp(a, b, t) / sqrt((1-t)^2 + t^2)."""
    if isinstance(t, (int, float)):
        return (a + (b - a) * t) / math.sqrt((1 - t) ** 2 + t ** 2)
    lerp = a + bmult(b - a, t)
    return bmult(lerp, ((1 - t) ** 2 + t ** 2) ** (-0.5))


def mp_cat(a: torch.Tensor, b: torch.Tensor, dim: int = -1,
           t: float = 0.5) -> torch.Tensor:
    """Magnitude-preserving concat (EDM2 Eq. 103) along `dim`."""
    na, nb = a.shape[dim], b.shape[dim]
    c = math.sqrt((na + nb) / ((1 - t) ** 2 + t ** 2))
    wa = c / math.sqrt(na) * (1 - t)
    wb = c / math.sqrt(nb) * t
    return torch.cat([wa * a, wb * b], dim=dim)


def mp_fourier(x: torch.Tensor, freqs: torch.Tensor,
               phases: torch.Tensor) -> torch.Tensor:
    """Magnitude-preserving Fourier features (EDM2 Eq. 75), fp32 inside."""
    y = torch.outer(x.float().reshape(-1), freqs.float())
    y = y.reshape(tuple(x.shape) + tuple(freqs.shape))
    y = torch.cos(y + phases.float()) * math.sqrt(2.0)
    return y.to(x.dtype)


def mp_weight(w: torch.Tensor, gain=1.0) -> torch.Tensor:
    """normalize(w) over all but the output (last) axis, times
    gain / sqrt(fan_in)."""
    dims = tuple(range(w.ndim - 1))
    w = normalize(w, dim=dims)
    fan_in = 1
    for a in dims:
        fan_in *= w.shape[a]
    return w * (gain / math.sqrt(fan_in))


def resample(x: torch.Tensor, f: Sequence[float] = (1, 1),
             mode: str = "keep") -> torch.Tensor:
    """Up/down-sampling of (..., H, W, C) with the separable [1, 1] filter:
    2x2 average pool down, nearest-neighbour repeat up."""
    if mode == "keep":
        return x
    if len(f) != 2:
        raise NotImplementedError("only the binomial [1,1] filter is supported")
    lead = x.shape[:-3]
    h, w, c = x.shape[-3:]
    x4 = x.reshape((-1, h, w, c))
    if mode == "down":
        y = x4.reshape(-1, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))
    elif mode == "up":
        y = x4.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    else:
        raise ValueError(f"unknown resample mode {mode!r}")
    return y.reshape(tuple(lead) + tuple(y.shape[1:]))


def gaussian_loss(mean: torch.Tensor, logvar: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Heteroscedastic Gaussian NLL, averaged: mean((logvar + (mean - target)^2
    * exp(-logvar)) / 2 + 0.918)."""
    return torch.mean((logvar + (mean - target) ** 2 * torch.exp(-logvar)) * 0.5 + 0.918)
