"""Group-causal video VAE (PyTorch, channels-last at module boundaries).

Counterpart of autoregressive_diffusion_tpu/models/vae.py, module for
module and with the same tree names, so that utils/bridge.load_flax_variables
is a rename: flax's conv `kernel` (DHWIO) and Dense `kernel` (in, out)
become torch's `weight` (O, I, D, H, W) and (out, in).
  * GroupCausalConv3d: a conv3d with time stride = group size, then a time
    pixel-unshuffle; causal time padding carried as a streaming cache.
    Fully causal in latent space, group-causal in pixels.
  * VAEResBlock, EncoderDecoderBlock, EncoderDecoder, VAE.
Videos are (b, t, h, w, c), latents (b, t_lat, h_lat, w_lat, c_lat). The
JAX package computes these convolutions with lax.conv outside any Pallas
kernel, so here they are F.conv3d in fp32; the VAE has no kernel of its
own. A new VAE holds zeros: `init_vae` draws the weights to train from,
by the JAX package's law, and a trained VAE comes from a bundle
(utils/bridge.vae_from_bundle). frames_to_latents has the intended
(l - mean) / std semantics, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import einops
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.numerics import mp_fourier


def _conv(conv: nn.Conv3d, x: torch.Tensor) -> torch.Tensor:
    """A torch Conv3d on a channels-last video; 1x1x1 kernels as a matmul."""
    if conv.kernel_size == (1, 1, 1):
        return F.linear(x, conv.weight.flatten(1), conv.bias)
    return conv(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)


class GroupCausalConv3d(nn.Module):
    """Conv3d(in, out*g, kernel, stride=(g, 1, 1)) + time pixel-unshuffle.
    `cache` holds the last `time_padding` spatially padded input frames for
    streaming; without one the first frames pad themselves."""

    def __init__(self, in_channels: int, out_channels: int, kernel: Tuple[int, int, int],
                 group_size: int = 1, dilation: Tuple[int, int, int] = (1, 1, 1)):
        super().__init__()
        self.kernel, self.group_size, self.dilation = tuple(kernel), group_size, tuple(dilation)
        self.weight = nn.Parameter(torch.zeros((out_channels * group_size, in_channels)
                                               + self.kernel))
        self.bias = nn.Parameter(torch.zeros(out_channels * group_size))

    def forward(self, x: torch.Tensor, cache=None, streaming: bool = False):
        (kt, kh, kw), (dt, dh, dw), g = self.kernel, self.dilation, self.group_size
        time_padding = kt + (kt - 1) * (dt - 1) - g
        ph, pw = dh * (kh // 2), dw * (kw // 2)
        x = F.pad(x, (0, 0, pw, pw, ph, ph))  # spatial zeros; the cache includes them
        if cache is None:
            cache = x[:, :time_padding]  # self-padding: the first frames again
        x = torch.cat([cache, x], dim=1)
        new_cache = x[:, -time_padding:] if streaming else None
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), self.weight, self.bias, stride=(g, 1, 1),
                     dilation=self.dilation)
        y = y.permute(0, 2, 3, 4, 1)
        return einops.rearrange(y, "b t h w (c g) -> b (t g) h w c", g=g), new_cache


def rms_norm(x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Channel RMS pixel-norm."""
    return x / torch.sqrt(torch.mean(x ** 2, dim=-1, keepdim=True) + eps)


class VAEResBlock(nn.Module):
    """rms_norm, an optional modulation by the noise level t (Fourier
    features through a Dense layer: scale and shift), silu, the group-causal
    conv, rms_norm, silu, a 1x3x3 conv; plus the input."""

    def __init__(self, channels: int, kernel: Tuple[int, int, int] = (8, 3, 3),
                 group_size: int = 1, t_cond: bool = False):
        super().__init__()
        self.t_cond_on = t_cond
        if t_cond:
            self.register_buffer("freqs", torch.zeros(channels * 2))
            self.register_buffer("phases", torch.zeros(channels * 2))
            self.t_cond = nn.Linear(channels * 2, channels * 2)
        self.conv3d0 = GroupCausalConv3d(channels, channels, kernel, group_size)
        self.conv3d1 = nn.Conv3d(channels, channels, (1, 3, 3), padding=(0, 1, 1))

    def forward(self, x: torch.Tensor, t=None, cache=None, streaming: bool = False):
        cache = cache or {}
        y = rms_norm(x)
        if t is not None and self.t_cond_on:
            t_emb = self.t_cond(mp_fourier(t, self.freqs, self.phases))
            scale, shift = t_emb[:, None, None, None, :].chunk(2, dim=-1)
            y = y * (1 + scale) + shift
        y = F.silu(y)
        y, c0 = self.conv3d0(y, cache.get("conv3d0"), streaming)
        y = F.silu(rms_norm(y))
        y = _conv(self.conv3d1, y)
        return x + y, ({"conv3d0": c0} if streaming else None)


def _pool_matrix(c: int, out_channels: int) -> torch.Tensor:
    """torch F.interpolate(mode='area') over channels as a (c, out) matrix:
    exact adaptive average pooling."""
    mat = np.zeros((c, out_channels), np.float32)
    for j in range(out_channels):
        start = (j * c) // out_channels
        end = -((-(j + 1) * c) // out_channels)  # ceil
        mat[start:end, j] = 1.0 / (end - start)
    return torch.from_numpy(mat)


def adaptive_channel_pool(x: torch.Tensor, out_channels: int) -> torch.Tensor:
    c = x.shape[-1]
    if c == out_channels:
        return x
    return x @ _pool_matrix(c, out_channels).to(x.device, x.dtype)


def updown(x: torch.Tensor, time_c: int, spatial_c: int, direction: str) -> torch.Tensor:
    """Space/time pixel shuffle: "down" folds (tc, hc, wc) into channels,
    "up" unfolds them."""
    if time_c * spatial_c ** 2 == 1:
        return x
    if direction == "down":
        return einops.rearrange(x, "b (t tc) (h hc) (w wc) c -> b t h w (tc hc wc c)",
                                tc=time_c, hc=spatial_c, wc=spatial_c)
    return einops.rearrange(x, "b t h w (tc hc wc c) -> b (t tc) (h hc) (w wc) c",
                            tc=time_c, hc=spatial_c, wc=spatial_c)


class EncoderDecoderBlock(nn.Module):
    """Encoder: pixel-shuffle down, a 1x1x1 compression conv plus the
    channel-pooled input, then res blocks. Decoder: a 1x1x1 decompression
    conv, pixel-shuffle up, t-conditioned res blocks, a 1x1x1 final conv
    plus the channel-pooled input."""

    def __init__(self, in_channels: int, out_channels: int, time_compression: int,
                 spatial_compression: int, kernel: Tuple[int, int, int], group_size: int,
                 n_res_blocks: int, block_type: str = "encoder"):
        super().__init__()
        self.tc, self.sc = time_compression, spatial_compression
        self.is_dec = block_type == "decoder"
        total = time_compression * spatial_compression ** 2
        if self.is_dec:
            self.decompression_block = nn.Conv3d(in_channels, in_channels * total, 1)
            self.final_conv = nn.Conv3d(in_channels, out_channels, 1)
        else:
            self.compression_block = nn.Conv3d(in_channels * total, out_channels, 1)
        ch = in_channels if self.is_dec else out_channels
        for i in range(n_res_blocks):
            self.add_module(f"res_block_{i}",
                            VAEResBlock(ch, kernel, group_size, t_cond=self.is_dec))
        self.n_res_blocks = n_res_blocks

    def forward(self, x, t=None, cache=None, streaming: bool = False):
        cache = cache or {}
        if self.is_dec:
            x = updown(_conv(self.decompression_block, x), self.tc, self.sc, "up")
        else:
            x = updown(x, self.tc, self.sc, "down")
            y = _conv(self.compression_block, x)
            x = y + adaptive_channel_pool(x, y.shape[-1])
        new_cache = {}
        for i in range(self.n_res_blocks):
            name = f"res_block_{i}"
            x, new_cache[name] = getattr(self, name)(x, t if self.is_dec else None,
                                                     cache.get(name), streaming)
        if self.is_dec:
            y = _conv(self.final_conv, x)
            x = y + adaptive_channel_pool(x, y.shape[-1])
        return x, (new_cache if streaming else None)


class EncoderDecoder(nn.Module):
    """A stack of EncoderDecoderBlocks. Group sizes are the cumulative time
    compressions (reversed for the encoder), kernels (2g, 3, 3); the decoder
    reverses the channels, doubles the last (mean, logvar) and returns
    (mean, logvar * exp(logvar_multiplier), cache)."""

    def __init__(self, channels, n_res_blocks: int, time_compressions,
                 spatial_compressions, coder_type: str = "encoder"):
        super().__init__()
        if not len(channels) - 1 == len(time_compressions) == len(spatial_compressions):
            raise ValueError("channels must be one longer than the compressions")
        self.is_dec = coder_type == "decoder"
        channels = list(channels)
        group_sizes = [int(g) for g in np.cumprod(time_compressions)]
        if self.is_dec:
            channels = channels[::-1]
            channels[-1] *= 2  # (mean, logvar)
        else:
            group_sizes = group_sizes[::-1]
        self.n_blocks = len(group_sizes)
        for i, g in enumerate(group_sizes):
            self.add_module(f"encoder_block_{i}", EncoderDecoderBlock(
                channels[i], channels[i + 1], time_compressions[i], spatial_compressions[i],
                (2 * g, 3, 3), g, n_res_blocks, coder_type))
        if self.is_dec:
            self.logvar_multiplier = nn.Parameter(torch.tensor(-2.0))

    def forward(self, x, t=None, cache=None, streaming: bool = False):
        cache = cache or {}
        new_cache = {}
        for i in range(self.n_blocks):
            name = f"encoder_block_{i}"
            x, new_cache[name] = getattr(self, name)(x, t, cache.get(name), streaming)
        new_cache = new_cache if streaming else None
        if not self.is_dec:
            return x, new_cache
        mean, logvar = x.chunk(2, dim=-1)
        return mean, logvar * torch.exp(self.logvar_multiplier), new_cache


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    channels: Tuple[int, ...]
    n_res_blocks: int
    time_compressions: Tuple[int, ...] = (1, 2, 2)
    spatial_compressions: Tuple[int, ...] = (1, 2, 2)

    @property
    def time_compression(self):
        return int(np.prod(self.time_compressions))

    @property
    def spatial_compression(self):
        return int(np.prod(self.spatial_compressions))


class VAE(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        args = (cfg.channels, cfg.n_res_blocks, cfg.time_compressions,
                cfg.spatial_compressions)
        self.encoder = EncoderDecoder(*args, "encoder")
        self.decoder = EncoderDecoder(*args, "decoder")

    def forward(self, x, t=None, noise=None, generator: Optional[torch.Generator] = None,
                t_max: float = 0.1):
        """Noise-augmented autoencode: z = (1 - t) * mean + t * noise.
        t (b,) and noise (the latents' shape) are taken as given, or drawn
        from `generator` (t ~ U(0, t_max), noise ~ N(0, 1)); with neither,
        t = 0 and z = mean. Returns (recon mean, recon logvar, latent mean)."""
        mean, _ = self.encode(x)
        if t is None and generator is not None:
            t, noise = self.draw_t_noise(x, generator, t_max)
        elif t is None:
            t = torch.zeros((x.shape[0],), dtype=x.dtype, device=x.device)
        z = mean
        if noise is not None:
            tb = t[:, None, None, None, None]
            z = mean * (1 - tb) + noise * tb
        r_mean, r_logvar, _ = self.decode(z, t)
        return r_mean, r_logvar, mean

    def latent_shape(self, x_shape) -> Tuple[int, ...]:
        """The latents' shape of a (b, t, h, w, c) video's."""
        b, t, h, w, _ = x_shape
        tc, sc = self.cfg.time_compression, self.cfg.spatial_compression
        return (b, t // tc, h // sc, w // sc, self.cfg.channels[-1])

    def draw_t_noise(self, x, generator: torch.Generator, t_max: float = 0.1):
        """(t ~ U(0, t_max) of shape (b,), noise ~ N(0, 1) of the latents'
        shape), drawn in that order from `generator`, as forward draws them.
        A caller that recomputes the forward (activation checkpointing)
        draws them once here and passes them in."""
        t = torch.rand((x.shape[0],), generator=generator, device=x.device, dtype=x.dtype)
        noise = torch.randn(self.latent_shape(x.shape), generator=generator, device=x.device,
                            dtype=x.dtype)
        return t * t_max, noise

    def encode(self, x, cache=None, streaming: bool = False):
        return self.encoder(x, None, cache, streaming)

    def decode(self, z, t, cache=None, streaming: bool = False):
        return self.decoder(z, t, cache, streaming)


def conv_uniform_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Fill a torch-layout conv or Linear weight (out, in, *kernel) in place
    with U(-1/sqrt(fan_in), 1/sqrt(fan_in)), fan_in = in * prod(kernel): the
    JAX package's variance_scaling(1/3, "fan_in", "uniform"), which is torch's
    own conv default. Drawn on the generator's device, copied to w's."""
    bound = w[0].numel() ** -0.5
    u = torch.rand(w.shape, generator=generator, device=generator.device)
    return w.copy_((2 * u - 1) * bound)


@torch.no_grad()
def init_vae(vae: VAE, generator: torch.Generator) -> VAE:
    """Random weights to train from, in place, by the JAX package's law
    (models/vae.py): every conv kernel U(+-1/sqrt(fan_in)) and every bias 0;
    a GroupCausalConv3d's kernel with its kt - g oldest time taps zeroed,
    then all of it scaled by 32^-0.25; the res blocks' conv3d1 and t_cond
    Dense zero; Fourier freqs 2 pi N(0, 1), phases 2 pi U(0, 1); the logvar
    multiplier -2. Torch cannot draw JAX's bits: the law, not the values,
    is the JAX package's."""
    for m in vae.modules():
        if isinstance(m, GroupCausalConv3d):
            kt, g = m.kernel[0], m.group_size
            w = conv_uniform_(m.weight, generator)
            if kt > g:
                w[:, :, :kt - g] = 0  # (O, I, D, H, W): D is time, oldest first
            w.mul_(32 ** -0.25)
            m.bias.zero_()
        elif isinstance(m, VAEResBlock):
            for zeroed in (m.conv3d1,) + ((m.t_cond,) if m.t_cond_on else ()):
                zeroed.weight.zero_()
                zeroed.bias.zero_()
            if m.t_cond_on:
                dev = generator.device
                m.freqs.copy_(2 * math.pi * torch.randn(m.freqs.shape, generator=generator,
                                                        device=dev))
                m.phases.copy_(2 * math.pi * torch.rand(m.phases.shape, generator=generator,
                                                        device=dev))
        elif isinstance(m, EncoderDecoderBlock):
            for name in ("compression_block", "decompression_block", "final_conv"):
                conv = getattr(m, name, None)
                if conv is not None:
                    conv_uniform_(conv.weight, generator)
                    conv.bias.zero_()
        elif isinstance(m, EncoderDecoder) and m.is_dec:
            m.logvar_multiplier.fill_(-2.0)
    return vae


# ---------------------------------------------------------------------------
# Inference helpers around VAE (no gradients).

@torch.no_grad()
def encode_long_sequence(vae: VAE, frames: torch.Tensor, split_size: int = 256):
    """Chunked streaming encode with the carried cache: equals one encode
    of the whole clip (split_size a multiple of the time compression)."""
    means, cache = [], None
    for s in range(0, frames.shape[1], split_size):
        m, cache = vae.encode(frames[:, s:s + split_size], cache=cache, streaming=True)
        means.append(m)
    return torch.cat(means, dim=1)


def _stat(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, np.float32) if not torch.is_tensor(v) else v,
                           dtype=like.dtype, device=like.device)


@torch.no_grad()
def frames_to_latents(vae: VAE, frames: torch.Tensor, mean, std) -> torch.Tensor:
    """(b, t, h, w, rgb) uint8 or float in [0, 255] -> unit-std latents."""
    x = frames.float() / 127.5 - 1.0
    latents, _ = vae.encode(x)
    return (latents - _stat(mean, latents)) / _stat(std, latents)


@torch.no_grad()
def latents_to_pixels(vae: VAE, latents: torch.Tensor, mean, std,
                      t: float = 0.1) -> torch.Tensor:
    """Unit-std latents -> float pixels clipped to [0, 255], decoded at
    noise level t."""
    z = latents * _stat(std, latents) + _stat(mean, latents)
    tv = torch.full((latents.shape[0],), t, dtype=latents.dtype, device=latents.device)
    frames, _, _ = vae.decode(z, tv)
    return torch.clamp((frames + 1) * 127.5, 0, 255)


def latents_to_frames(vae: VAE, latents: torch.Tensor, mean, std,
                      t: float = 0.1) -> torch.Tensor:
    """Unit-std latents -> uint8 frames; the cast truncates, as numpy's
    astype does."""
    return latents_to_pixels(vae, latents, mean, std, t).to(torch.uint8)


def worst_k_percent_loss(recon: torch.Tensor, frames: torch.Tensor,
                         percent: float = 0.5) -> torch.Tensor:
    """Mean of the worst k% pixel squared errors."""
    losses = ((recon - frames) ** 2).reshape(-1)
    k = max(1, int(losses.numel() * percent / 100.0))
    return torch.topk(losses, k).values.mean()
