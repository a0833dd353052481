"""Mixed 2D + 3D video discriminator for adversarial VAE training (PyTorch).

Counterpart of autoregressive_diffusion_tpu/models/discriminator.py, module
for module and with the same tree names, so that utils/bridge carries the
params and batch_stats across by renaming: a BatchNorm/LeakyReLU/BlurPool
2D discriminator over frames plus a GroupNorm/BlurPool3D temporal one,
judging which channel half of a 6-channel (frames || recon) stack is real
by a 2-class cross-entropy / log 2.

Videos are (b, t, h, w, c) channels-last at the public functions; inside,
the layers run channels-first on F.conv2d / F.conv3d in fp32, as the JAX
package runs them on lax.conv outside any Pallas kernel.

BatchNorm follows flax, not torch: in train mode it normalizes with the
batch's mean and biased variance and moves the running statistics as
running = 0.99 * running + 0.01 * batch, with the biased variance (torch's
BatchNorm2d uses momentum 0.1 and the unbiased variance); in eval mode it
normalizes with the running ones. Whether a call trains is its `train`
argument, as in flax, since one step calls the discriminator both ways.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .vae import conv_uniform_

LRELU_SLOPE = 0.2


def _blur_filter(ndim: int) -> np.ndarray:
    f = np.array([1.0, 2.0, 1.0])
    k = f
    for _ in range(ndim - 1):
        k = np.multiply.outer(k, f)
    return (k / k.sum()).astype(np.float32)


def _blur_cf(x: torch.Tensor) -> torch.Tensor:
    """Depthwise [1, 2, 1] blur, stride 2, padding 1 over the spatial (and,
    for 5-d input, time) axes of a channels-first tensor."""
    nd = x.ndim - 2
    c = x.shape[1]
    k = torch.from_numpy(_blur_filter(nd)).to(x.device, x.dtype)
    k = k.expand((c, 1) + k.shape)
    conv = F.conv2d if nd == 2 else F.conv3d
    return conv(x, k, stride=2, padding=1, groups=c)


def blur_pool_2d(x: torch.Tensor) -> torch.Tensor:
    """Depthwise [1, 2, 1] blur + stride 2. x: (..., h, w, c)."""
    lead = x.shape[:-3]
    y = _blur_cf(x.reshape((-1,) + x.shape[-3:]).permute(0, 3, 1, 2))
    y = y.permute(0, 2, 3, 1)
    return y.reshape(lead + y.shape[1:])


def blur_pool_3d(x: torch.Tensor) -> torch.Tensor:
    """Depthwise 3D blur + stride 2 in (t, h, w). x: (b, t, h, w, c)."""
    return _blur_cf(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)


class BatchNorm(nn.Module):
    """flax nn.BatchNorm over the channel axis 1 of a channels-first tensor:
    momentum 0.99, eps 1e-5, the biased batch variance in the running
    average. Buffers `mean` and `var` are flax's batch_stats."""

    def __init__(self, channels: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if train:
            dims = (0,) + tuple(range(2, x.ndim))
            mean = x.mean(dim=dims)
            var = torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)  # flax's form
            with torch.no_grad():
                m = self.momentum
                self.mean.mul_(m).add_(mean.detach(), alpha=1 - m)
                self.var.mul_(m).add_(var.detach(), alpha=1 - m)
        else:
            mean, var = self.mean, self.var
        y = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + self.eps)
        return y * self.weight.reshape(shape) + self.bias.reshape(shape)


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LRELU_SLOPE)


class DiscriminatorBlock2D(nn.Module):
    """norm, lrelu, 3x3 conv, norm, lrelu, [blur pool], 3x3 conv, plus the
    shortcut (the blurred input through a 1x1 conv, or the input), over
    sqrt(2). Channels-first."""

    def __init__(self, in_channels: int, out_channels: int, add_downsample: bool = True,
                 output_scale_factor: float = math.sqrt(2)):
        super().__init__()
        self.add_downsample, self.scale = add_downsample, output_scale_factor
        self.norm1 = BatchNorm(in_channels)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = BatchNorm(out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if add_downsample:
            self.shortcut_conv = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        h = self.conv1(_lrelu(self.norm1(x, train)))
        h = _lrelu(self.norm2(h, train))
        if self.add_downsample:
            h = _blur_cf(h)
            shortcut = self.shortcut_conv(_blur_cf(x))
        else:
            shortcut = x
        return (self.conv2(h) + shortcut) / self.scale


class Discriminator2D(nn.Module):
    """Per-frame discriminator: (n, h, w, c) -> (n, h', w', 2) logits, every
    block but the last halving the frame."""

    def __init__(self, block_out_channels: Tuple[int, ...] = (64,), in_channels: int = 6):
        super().__init__()
        chans = tuple(block_out_channels)
        self.n_blocks = len(chans)
        self.conv_in = nn.Conv2d(in_channels, chans[0], 3, padding=1)
        cin = chans[0]
        for i, ch in enumerate(chans):
            self.add_module(f"block_{i}", DiscriminatorBlock2D(
                cin, ch, add_downsample=i < len(chans) - 1))
            cin = ch
        self.conv_out = nn.Conv2d(cin, 2, 3, padding=1)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = self.conv_in(x.permute(0, 3, 1, 2))
        for i in range(self.n_blocks):
            x = getattr(self, f"block_{i}")(x, train)
        return self.conv_out(x).permute(0, 2, 3, 1)


class DiscriminatorBlock3D(nn.Module):
    """The 3D block: GroupNorm (min(32, C) groups, eps 1e-5) in place of
    BatchNorm, 3x3x3 convs, and a 1x1x1 shortcut conv always (on the
    blurred input when the block downsamples). Channels-first."""

    def __init__(self, in_channels: int, out_channels: int, add_downsample: bool = True,
                 output_scale_factor: float = math.sqrt(2)):
        super().__init__()
        self.add_downsample, self.scale = add_downsample, output_scale_factor
        self.norm1 = nn.GroupNorm(min(32, in_channels), in_channels, eps=1e-5)
        self.conv1 = nn.Conv3d(in_channels, out_channels, 3, padding=1)
        self.norm2 = nn.GroupNorm(min(32, out_channels), out_channels, eps=1e-5)
        self.conv2 = nn.Conv3d(out_channels, out_channels, 3, padding=1)
        self.shortcut_conv = nn.Conv3d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(_lrelu(self.norm1(x)))
        h = _lrelu(self.norm2(h))
        if self.add_downsample:
            h = _blur_cf(h)
            x = _blur_cf(x)
        return (self.conv2(h) + self.shortcut_conv(x)) / self.scale


class Discriminator3D(nn.Module):
    """Temporal discriminator: (b, t, h, w, c) -> (b, t', h', w', 2); conv_in
    at stride 2 with explicit (1, 1) padding on every axis."""

    def __init__(self, block_out_channels: Tuple[int, ...] = (64,), in_channels: int = 6):
        super().__init__()
        chans = tuple(block_out_channels)
        self.n_blocks = len(chans)
        self.conv_in = nn.Conv3d(in_channels, chans[0], 3, stride=2, padding=1)
        cin = chans[0]
        for i, ch in enumerate(chans):
            self.add_module(f"block_{i}", DiscriminatorBlock3D(
                cin, ch, add_downsample=i < len(chans) - 1))
            cin = ch
        self.conv_out = nn.Conv3d(cin, 2, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x.permute(0, 4, 1, 2, 3))
        for i in range(self.n_blocks):
            x = getattr(self, f"block_{i}")(x)
        return self.conv_out(x).permute(0, 2, 3, 4, 1)


class MixedDiscriminator(nn.Module):
    """The per-frame 2D logits and the temporal 3D logits concatenated along
    the (downsampled) time axis: (b, t, h, w, 6) -> (b, t + t', h', w', 2)."""

    def __init__(self, in_channels: int = 6):
        super().__init__()
        self.discriminator3d = Discriminator3D((64, 64), in_channels)
        self.discriminator2d = Discriminator2D((64, 64, 64), in_channels)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        b, t = x.shape[:2]
        x3 = self.discriminator3d(x)
        x2 = self.discriminator2d(x.reshape((b * t,) + x.shape[2:]), train)
        return torch.cat([x2.reshape((b, t) + x2.shape[1:]), x3], dim=1)


@torch.no_grad()
def init_discriminator(disc: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights to train from, in place, by the JAX package's law:
    conv kernels U(+-1/sqrt(fan_in)), conv biases 0, norm scales 1 and
    biases 0, running mean 0 and variance 1."""
    for m in disc.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d)):
            conv_uniform_(m.weight, generator)
            m.bias.zero_()
        elif isinstance(m, (BatchNorm, nn.GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, BatchNorm):
                m.mean.zero_()
                m.var.fill_(1.0)
    return disc


def _cross_entropy(disc, frames, recon, flip: bool, train: bool) -> torch.Tensor:
    """The 2-class "which half is real" cross-entropy / log 2. flip (the
    VAE's loss): (frames || recon) is labelled 0 and (recon || frames) 1,
    with gradients to recon; otherwise (the discriminator's loss) the
    labels swap and the inputs are detached."""
    frames_recon = torch.cat([frames, recon], dim=-1)
    recon_frames = torch.cat([recon, frames], dim=-1)
    if flip:
        inputs = torch.cat([frames_recon, recon_frames], dim=0)
    else:
        inputs = torch.cat([recon_frames, frames_recon], dim=0).detach()
    logp = F.log_softmax(disc(inputs, train), dim=-1)
    n = frames.shape[0]
    ce = -torch.cat([logp[:n, ..., 0], logp[n:, ..., 1]], dim=0)
    return ce.mean() / math.log(2)


def vae_adversarial_loss(disc, frames, recon, train: bool = True) -> torch.Tensor:
    """The VAE's adversarial loss. In train mode the BatchNorm running
    statistics move, in place."""
    return _cross_entropy(disc, frames, recon, flip=True, train=train)


def discriminator_loss(disc, frames, recon, train: bool = True) -> torch.Tensor:
    """The discriminator's loss on detached inputs. In train mode the
    BatchNorm running statistics move, in place."""
    return _cross_entropy(disc, frames, recon, flip=False, train=train)
