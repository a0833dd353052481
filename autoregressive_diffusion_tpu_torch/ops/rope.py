"""xPos-scaled rotary embedding over the FRAME (time) axis.

Counterpart of autoregressive_diffusion_tpu/ops/rope.py. Tables are fp32.
The xPos scale pivots at `center`; the pivot cancels exactly in q.k^T, so
attention outputs do not depend on it.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _rope_constants(head_dim: int, device: torch.device):
    """(inverse frequencies, log of the xPos scale vector), each (head_dim / 2,)
    fp32 on `device`: made once per head size and device, so that a call
    copies nothing from the host (a CUDA graph cannot capture such a copy)."""
    inv_freq = torch.as_tensor(
        1.0 / (10000.0 ** (np.arange(0, head_dim, 2) / head_dim)),
        dtype=torch.float32, device=device)
    scale_vec = torch.as_tensor(
        (np.arange(0, head_dim, 2) + 0.4 * head_dim) / (1.4 * head_dim),
        dtype=torch.float32, device=device)
    return inv_freq, torch.log(scale_vec)


def rope_tables(head_dim: int, positions: torch.Tensor, center,
                scale_base: float = 64.0):
    """cos, sin and xPos scale tables, each (P, head_dim) fp32, for the
    absolute frame `positions` (P,)."""
    inv_freq, log_scale_vec = _rope_constants(head_dim, positions.device)
    pos = positions.float()
    freqs = pos[:, None] * inv_freq[None, :]
    freqs = torch.cat([freqs, freqs], dim=-1)
    power = (pos - float(center)) / scale_base
    scale = torch.exp(power[:, None] * log_scale_vec[None, :])
    scale = torch.cat([scale, scale], dim=-1)
    return torch.cos(freqs), torch.sin(freqs), scale


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               scale: torch.Tensor) -> torch.Tensor:
    """x: (..., T, HW, C) with tables (T, C), cast to x's dtype."""
    dt = x.dtype
    cos = cos[:, None, :].to(dt)
    sin = sin[:, None, :].to(dt)
    scale = scale[:, None, :].to(dt)
    return (x * cos + rotate_half(x) * sin) * scale


def rope_qk(q: torch.Tensor, k: torch.Tensor, q_positions: torch.Tensor,
            k_positions: torch.Tensor, center, scale_base: float = 64.0):
    """Rotate q (scale^+1) and k (scale^-1) with absolute frame positions.
    q: (..., Tq, HW, C), k: (..., Tk, HW, C)."""
    head_dim = q.shape[-1]
    cos_k, sin_k, scale_k = rope_tables(head_dim, k_positions, center, scale_base)
    k = apply_rope(k, cos_k, sin_k, 1.0 / scale_k)
    cos_q, sin_q, scale_q = rope_tables(head_dim, q_positions, center, scale_base)
    q = apply_rope(q, cos_q, sin_q, scale_q)
    return q, k
