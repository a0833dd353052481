"""Core magnitude-preserving layers (PyTorch, channels-last).

Counterpart of autoregressive_diffusion_tpu/models/layers.py: MPConv,
Gating and MPCausalConv3d in train, eval, cached and just_2d modes, with the
same cache protocol -- y, new_cache = layer(x, ..., cache=..., update_cache=...).
Parameters hold the RAW weights under the JAX package's names and layouts;
every forward normalizes them (mp_weight), as the JAX forward does. In train
mode every MPCausalConv3d call goes through ops/fused_conv.fused_gated_conv
(the CUDA kernels on the card, their plain version on the CPU). The int8
decode weights belong to a later port slice.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_conv import fused_gated_conv
from ..ops.numerics import mp_weight


def mp_sum_gated(a: torch.Tensor, b: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """mp_sum with a per-(batch, frame) gate: a, b (B, T, H, W, C), gate (B, T)."""
    g = gate.to(a.dtype)[:, :, None, None, None]
    lerp = a + (b - a) * g
    return lerp * ((1 - g) ** 2 + g ** 2) ** -0.5


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Same-padded 2D conv of (..., H, W, C) with an HWIO weight."""
    kh, kw = w.shape[:2]
    lead = x.shape[:-3]
    x4 = x.reshape((-1,) + tuple(x.shape[-3:])).permute(0, 3, 1, 2)
    y = F.conv2d(x4, w.permute(3, 2, 0, 1), padding=(kh // 2, kw // 2))
    y = y.permute(0, 2, 3, 1)
    return y.reshape(tuple(lead) + tuple(y.shape[1:]))


class MPConv(nn.Module):
    """Magnitude-preserving dense (kernel=()) or 2D conv (kernel=(kh, kw)).
    Weight `w`: (in, out) dense, (kh, kw, in, out) conv."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: Tuple[int, ...] = ()):
        super().__init__()
        self.kernel = tuple(kernel)
        self.w = nn.Parameter(torch.empty(self.kernel + (in_channels, out_channels)))

    def weight(self, dtype, gain=1.0) -> torch.Tensor:
        return mp_weight(self.w, gain).to(dtype)

    def forward(self, x: torch.Tensor, gain=1.0) -> torch.Tensor:
        w = self.weight(x.dtype, gain)
        if not self.kernel:
            return x @ w
        if self.kernel == (1, 1):
            return x @ w[0, 0]
        return conv2d_nhwc(x, w)


class Gating(nn.Module):
    """Noise/position-conditioned gate between the 2D and context conv
    branches, positions log1p(arange % t + frames); in train mode c_noise
    is over the DART concat and both halves share the positions of t = T.
    gate = mn + (1-mn)*mx*sigmoid(mult . (c_noise, position) + offsets)."""

    def __init__(self):
        super().__init__()
        self.offset = nn.Parameter(torch.zeros(2))
        self.mult = nn.Parameter(torch.tensor([1.5, -0.5]))
        self.max_gating = nn.Parameter(torch.tensor(-5.0))
        self.min_gating = nn.Parameter(torch.tensor(-5.0))

    def forward(self, c_noise: torch.Tensor, n_context_frames: int = 0,
                just_2d: bool = False, train: bool = False) -> torch.Tensor:
        b, t = c_noise.shape
        if just_2d:
            positions = torch.zeros_like(c_noise)
        else:
            t_dim = t // 2 if train else t
            pos = torch.arange(b * t, device=c_noise.device) % t_dim
            pos = pos.reshape(b, t) + n_context_frames
            positions = torch.log1p(pos.to(c_noise.dtype))
        state = ((c_noise * self.mult[0] + self.offset[0])
                 + (positions * self.mult[1] + self.offset[1]))
        mn = torch.sigmoid(self.min_gating)
        mx = torch.sigmoid(self.max_gating)
        return mn + (1 - mn) * mx * torch.sigmoid(state)


class MPCausalConv3d(nn.Module):
    """Magnitude-preserving causal 3D gated conv: a 2D conv on each frame
    ("last_frame_conv") blended by the Gating with a (kt-1)xkhxkw conv over
    the STRICTLY PAST frames. In eval mode the last kt-1 frames of input
    activations live in the cache (a ones frame before the clip start). In
    train mode x is the DART concat (B, 2T, H, W, C): only the clean half
    feeds the context conv, ones frames stand before the clip start and the
    result serves both halves; `silu_in` and `cvec` ask for the input
    transform mp_silu(x * cvec) inside the fused conv.
    Weight `w`: (kt-1, kh, kw, in, out)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: Tuple[int, int, int] = (3, 3, 3)):
        super().__init__()
        kt, kh, kw = kernel
        self.kernel = tuple(kernel)
        self.last_frame_conv = MPConv(in_channels, out_channels, (kh, kw))
        self.w = nn.Parameter(torch.empty((kt - 1, kh, kw, in_channels, out_channels)))
        self.gating = Gating()

    def decode_weights(self, dtype, c_noise: torch.Tensor, frames: int):
        """(normalized 2D weight, normalized context weight, gate (B, T)) for
        the fused decode Block kernel."""
        return (self.last_frame_conv.weight(dtype), mp_weight(self.w).to(dtype),
                self.gating(c_noise, frames))

    def forward(self, x: torch.Tensor, c_noise: torch.Tensor, frames: int = 0,
                cache=None, update_cache: bool = False, just_2d: bool = False,
                mode: str = "eval", silu_in: bool = False, cvec=None):
        if mode == "train":
            return self._train(x, c_noise, frames, just_2d, silu_in, cvec), cache
        if silu_in or cvec is not None:
            raise ValueError("silu_in and cvec are train-mode arguments")
        b, t, h, w, cin = x.shape
        y2d = self.last_frame_conv(x)
        if just_2d:
            return y2d, cache
        kt_ctx = self.kernel[0] - 1
        w3 = mp_weight(self.w).to(x.dtype)
        gate = self.gating(c_noise, frames)
        if cache is None:
            pad = torch.ones((b, kt_ctx, h, w, cin), dtype=x.dtype, device=x.device)
        else:
            pad = cache["act"].to(x.dtype)
        ctx_in = torch.cat([pad, x], dim=1)
        new_cache = {"act": ctx_in[:, -kt_ctx:].clone()} if update_cache else cache
        # the (kt_ctx, kh, kw) conv over strictly past frames as ONE 2D conv
        # over the kt_ctx shifted windows concatenated on channels (JAX
        # package models/layers.py:282-305)
        x_ctx = ctx_in[:, :-1]
        t_out = x_ctx.shape[1] - kt_ctx + 1
        xs = torch.cat([x_ctx[:, j:j + t_out] for j in range(kt_ctx)], dim=-1)
        kh, kw = self.kernel[1:]
        wcat = w3.permute(1, 2, 0, 3, 4).reshape(kh, kw, kt_ctx * cin, -1)
        ctx = conv2d_nhwc(xs, wcat)
        return mp_sum_gated(y2d, ctx, gate), new_cache

    def _train(self, x, c_noise, frames, just_2d, silu_in, cvec):
        if self.kernel != (3, 3, 3):
            raise NotImplementedError("the fused conv is the 3x3x3 kernel")
        dt = x.dtype
        w2 = self.last_frame_conv.weight(dt)
        if cvec is not None:
            cvec = cvec.to(dt).contiguous()
        if just_2d:
            return fused_gated_conv(x.contiguous(), w2, None, cvec, None, silu_in, False)
        w3 = mp_weight(self.w).to(dt)
        gate = self.gating(c_noise, frames, train=True).float()
        return fused_gated_conv(x.contiguous(), w2, w3, cvec, gate, silu_in, True)
