"""Core magnitude-preserving layers (PyTorch, channels-last).

Counterpart of autoregressive_diffusion_tpu/models/layers.py: MPConv,
Gating and MPCausalConv3d in train, eval, cached and just_2d modes, with the
same cache protocol -- y, new_cache = layer(x, ..., cache=..., update_cache=...).
Parameters hold the RAW weights under the JAX package's names and layouts;
every forward normalizes them (mp_weight), as the JAX forward does. In train
mode every MPCausalConv3d call goes through ops/fused_conv.fused_gated_conv
(the CUDA kernels on the card, their plain version on the CPU); under a
sequence-parallel context (ops/flash_attention.set_sp_context) it runs on
this seq rank's frames extended by a 2-frame halo from the rank before
(parallel/collectives.exchange_halo). With quant=True (the int8 decode
weights, eval only) a module holds int8 `w_q` and an fp32 per-output-channel
`w_scale` as buffers in place of `w`: the baked weight normalize(w) /
sqrt(fan_in) of train/quantize.py, dequantized at use with no mp_weight.

Under tensor parallelism and FSDP (parallel/mesh.shard_train_state) a
module's `shard` is (mesh, spec) and `w` holds this rank's shard of the
weight. An FSDP axis is all-gathered over the data group at every use
(fsdp_gather; the backward reduce-scatters the gradient), and mp_weight
then runs on the gathered weight. A weight whose output channels are split
over the model group computes this rank's output channels, with every
replicated input (x, the gain, the conv's cvec and gates, whose gradients
sum over the output channels) passed through copy_to_model, and gathers
the channels of all model ranks after (gather_model; gather_model_partial
for head-sharded attention's qkv, models/attention.py). mp_weight's
per-output-channel norm is local to the rank's channels; its fan-in is the
whole input. A sharded module trains only: the eval and decode paths
serve unsharded weights (parallel.gather_to_host).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import sp_context
from ..ops.fused_conv import fused_gated_conv
from ..ops.numerics import mp_weight
from ..parallel.collectives import (HALO, copy_to_model, exchange_halo, fsdp_gather,
                                   gather_model, gather_model_partial)


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


def _weight_slot(module: nn.Module, shape, quant: bool):
    """The raw weight `w`, or under quant the int8 `w_q` and its fp32
    per-output-channel `w_scale` (buffers: they are never trained)."""
    if quant:
        module.register_buffer("w_q", torch.zeros(shape, dtype=torch.int8))
        module.register_buffer("w_scale", torch.ones(shape[-1]))
    else:
        module.w = nn.Parameter(torch.empty(shape))


def _gathered(module: nn.Module) -> torch.Tensor:
    """The module's raw weight with its FSDP axis, if any, gathered."""
    sh = module.shard
    if sh is not None and "data" in sh[1]:
        return fsdp_gather(module.w, sh[1].index("data"), sh[0].data_group)
    return module.w


def _model_group(module: nn.Module):
    """The model group a module's output channels are split over, or None."""
    sh = module.shard
    return sh[0].model_group if sh is not None and sh[1][-1] == "model" else None


def _gather(y: torch.Tensor, group) -> torch.Tensor:
    """All output channels from this rank's (`group` None: y itself)."""
    return y if group is None else gather_model(y, group)


def _dequantized(module: nn.Module, dtype, gain=1.0) -> torch.Tensor:
    """The int8 weight at use: (w_q * w_scale * gain) in `dtype`, with no
    mp_weight (JAX package models/layers.py:62-67)."""
    return (module.w_q.float() * module.w_scale * gain).to(dtype)


class MPConv(nn.Module):
    """Magnitude-preserving dense (kernel=()) or 2D conv (kernel=(kh, kw)).
    Weight `w`: (in, out) dense, (kh, kw, in, out) conv; int8 `w_q` and
    `w_scale` under quant."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: Tuple[int, ...] = (), quant: bool = False):
        super().__init__()
        self.kernel = tuple(kernel)
        self.quant = quant
        self.shard = None  # (mesh, spec) under TP/FSDP
        _weight_slot(self, self.kernel + (in_channels, out_channels), quant)

    def weight(self, dtype, gain=1.0) -> torch.Tensor:
        """The normalized weight (of this rank's output channels under TP)."""
        if self.quant:
            return _dequantized(self, dtype, gain)
        return mp_weight(_gathered(self), gain).to(dtype)

    def forward(self, x: torch.Tensor, gain=1.0, partial_use=None) -> torch.Tensor:
        """partial_use: the model group, when each of its ranks uses only a
        part of the output (head-sharded attention). The output's gradient
        then differs between those ranks, so it is summed over the group
        before it reaches the weight and x: by the reduce-scatter of
        gather_model_partial when the weight's output channels are split,
        else by copy_to_model on the replicated output."""
        group = _model_group(self)
        if group is not None:
            x = copy_to_model(x, group)
            if torch.is_tensor(gain):
                gain = copy_to_model(gain, group)
        w = self.weight(x.dtype, gain)
        if not self.kernel:
            y = x @ w
        elif self.kernel == (1, 1):
            y = x @ w[0, 0]
        else:
            y = conv2d_nhwc(x, w)
        if partial_use is None:
            return _gather(y, group)
        return (copy_to_model(y, partial_use) if group is None
                else gather_model_partial(y, group))


class Gating(nn.Module):
    """Noise/position-conditioned gate between the 2D and context conv
    branches, positions log1p(arange % t + frames); in train mode c_noise
    is over the DART concat and both halves share the positions of t = T
    (frames = the first frame's position in the clip: 0, or a seq rank's
    frame offset under sequence parallelism).
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
    Weight `w`: (kt-1, kh, kw, in, out); int8 `w_q` and `w_scale` under
    quant, in this module and in last_frame_conv."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: Tuple[int, int, int] = (3, 3, 3), quant: bool = False):
        super().__init__()
        kt, kh, kw = kernel
        self.kernel = tuple(kernel)
        self.quant = quant
        self.shard = None  # (mesh, spec) of `w` under TP/FSDP
        self.last_frame_conv = MPConv(in_channels, out_channels, (kh, kw), quant)
        _weight_slot(self, (kt - 1, kh, kw, in_channels, out_channels), quant)
        self.gating = Gating()

    def context_weight(self, dtype) -> torch.Tensor:
        """The normalized (or dequantized int8) context weight."""
        if self.quant:
            return _dequantized(self, dtype)
        return mp_weight(_gathered(self)).to(dtype)

    def decode_weights(self, dtype, c_noise: torch.Tensor, frames: int):
        """(normalized 2D weight, normalized context weight, gate (B, T)) for
        the fused decode Block kernel; under quant the dequantized weights,
        so the kernel runs unchanged (JAX package models/layers.py:180-200)."""
        return (self.last_frame_conv.weight(dtype), self.context_weight(dtype),
                self.gating(c_noise, frames))

    def forward(self, x: torch.Tensor, c_noise: torch.Tensor, frames: int = 0,
                cache=None, update_cache: bool = False, just_2d: bool = False,
                mode: str = "eval", silu_in: bool = False, cvec=None):
        if mode == "train":
            return self._train(x, c_noise, frames, just_2d, silu_in, cvec), cache
        if silu_in or cvec is not None:
            raise ValueError("silu_in and cvec are train-mode arguments")
        if self.shard is not None or self.last_frame_conv.shard is not None:
            raise ValueError("a sharded conv trains only: serve the weights gathered by "
                             "parallel.gather_to_host")
        b, t, h, w, cin = x.shape
        y2d = self.last_frame_conv(x)
        if just_2d:
            return y2d, cache
        kt_ctx = self.kernel[0] - 1
        w3 = self.context_weight(x.dtype)
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
        if self.quant:
            raise ValueError("int8 weights are a decode-only path: train with quant off")
        if self.kernel != (3, 3, 3):
            raise NotImplementedError("the fused conv is the 3x3x3 kernel")
        group = _model_group(self)
        if (group is None) != (_model_group(self.last_frame_conv) is None):
            raise ValueError("the 2D and context weights of a conv must share their TP split")
        dt = x.dtype
        w2 = self.last_frame_conv.weight(dt)
        if cvec is not None:
            cvec = cvec.to(dt).contiguous()
        if just_2d:
            return _gather(self._fused(group, x, w2, None, cvec, None, silu_in, False), group)
        w3 = self.context_weight(dt)
        mesh = sp_context()
        if mesh is not None and mesh.sp > 1:
            y = self._train_sp(x, c_noise, frames, silu_in, cvec, w2, w3, mesh, group)
        else:
            gate = self.gating(c_noise, frames, train=True).float()
            y = self._fused(group, x, w2, w3, cvec, gate, silu_in, True)
        return _gather(y, group)

    @staticmethod
    def _fused(group, x, w2, w3, cvec, gate, silu_in, with_ctx):
        """The fused conv of this rank's output channels (all of them
        without TP); under TP x, cvec and gate enter through copy_to_model."""
        if group is not None:
            x, cvec, gate = (None if a is None else copy_to_model(a, group)
                             for a in (x, cvec, gate))
        return fused_gated_conv(x.contiguous(), w2, w3, cvec, gate, silu_in, with_ctx)

    def _train_sp(self, x, c_noise, frames, silu_in, cvec, w2, w3, mesh, group):
        """The DART conv of this seq rank's frames (global positions from
        `frames`, the rank's offset): on rank r > 0 the conv runs on the
        concat extended by rank r - 1's last 2 clean frames, which their
        context reads, and drops the 2 extra outputs of each half; the halo
        gets its own cvec rows and gates at positions frames - 2, frames - 1.
        Costs (t_l + 2) / t_l of the conv work on those ranks."""
        t_l = x.shape[1] // 2
        x, cvec = exchange_halo(x, cvec, mesh.seq_group)
        if mesh.seq_rank == 0:
            gate = self.gating(c_noise, frames, train=True).float()
            return self._fused(group, x, w2, w3, cvec, gate, silu_in, True)
        # the halo's noise level: the clean frames of a sample share one sigma
        pad = [c_noise[:, :1].expand(-1, HALO), c_noise[:, :t_l],
               c_noise[:, t_l:t_l + 1].expand(-1, HALO), c_noise[:, t_l:]]
        gate = self.gating(torch.cat(pad, dim=1), frames - HALO, train=True).float()
        y = self._fused(group, x, w2, w3, cvec, gate, silu_in, True)
        return torch.cat([y[:, HALO:HALO + t_l], y[:, 2 * HALO + t_l:]], dim=1)
