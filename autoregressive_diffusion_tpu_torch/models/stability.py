"""Bridge to the Stability `sd-vae-ft-mse` image VAE as another latent
source (PyTorch).

Counterpart of autoregressive_diffusion_tpu/models/stability.py: frames are
encoded frame by frame by a diffusers-style AutoencoderKL, and the latents
are affine-rescaled from the published raw statistics to (final_mean,
final_std). The rescale is pure numpy (`affine_from_stats`,
`rescale_to_final`, `rescale_from_final`). The VAE itself is injected
(`vae=`, any object with AutoencoderKL's `encode(x)["latent_dist"].mean /
.std` and `decode(z)["sample"]`), or downloaded through diffusers, which
the port does not need otherwise: without diffusers the default raises an
ImportError that names the package.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..utils.device import resolve_device


def affine_from_stats(raw_mean: Sequence[float], raw_std: Sequence[float],
                      final_mean: float, final_std: float):
    """Per-channel (scale, bias) taking raw latents of statistics (raw_mean,
    raw_std) to (final_mean, final_std): z' = z * scale + bias."""
    raw_mean = np.asarray(raw_mean, np.float32)
    raw_std = np.asarray(raw_std, np.float32)
    scale = np.float32(final_std) / raw_std
    bias = np.float32(final_mean) - raw_mean * scale
    return scale, bias


def rescale_to_final(z: np.ndarray, scale: np.ndarray, bias: np.ndarray) -> np.ndarray:
    """Raw channels-last latents -> final (rescaled) latents."""
    return z * scale + bias


def rescale_from_final(z: np.ndarray, scale: np.ndarray, bias: np.ndarray) -> np.ndarray:
    """The inverse of rescale_to_final."""
    return (z - bias) / scale


class StabilityVAEBridge:
    """uint8 frames (b, t, h, w, c) -> final latents (b, t, h/8, w/8, 4) as
    numpy arrays, channels-last, and back; the VAE runs on `device` in
    chunks of `batch_size` frames."""

    def __init__(self, vae_name: str = "stabilityai/sd-vae-ft-mse",
                 raw_mean: Sequence[float] = (5.81, 3.25, 0.12, -2.15),
                 raw_std: Sequence[float] = (4.17, 4.62, 3.71, 3.28),
                 final_mean: float = 0.0, final_std: float = 0.5, batch_size: int = 8,
                 device="cuda", vae: Optional[object] = None):
        self.scale, self.bias = affine_from_stats(raw_mean, raw_std, final_mean, final_std)
        self.batch_size = int(batch_size)
        self.device = resolve_device(device)
        if vae is None:
            try:
                from diffusers import AutoencoderKL
            except ImportError as e:
                raise ImportError(f"the default {vae_name} VAE needs the `diffusers` package "
                                  f"(or pass vae=)") from e
            vae = AutoencoderKL.from_pretrained(vae_name).requires_grad_(False).to(self.device)
        self._vae = vae

    @torch.no_grad()
    def _encode_raw(self, x_bchw: torch.Tensor) -> torch.Tensor:
        outs = []
        for chunk in x_bchw.split(self.batch_size):
            d = self._vae.encode(chunk)["latent_dist"]
            outs.append(torch.cat([d.mean, d.std], dim=1))
        return torch.cat(outs)

    def frames_to_latents(self, frames: np.ndarray, sample: bool = True,
                          seed: int = 0) -> np.ndarray:
        """uint8 (b, t, h, w, c) in [0, 255] -> final latents
        (b, t, h/8, w/8, 4): a draw from the posterior with noise from a CPU
        generator seeded `seed`, or its mean (sample=False)."""
        b, t = frames.shape[:2]
        x = torch.from_numpy(np.ascontiguousarray(frames.reshape((-1,) + frames.shape[2:])))
        x = x.to(self.device).permute(0, 3, 1, 2).float() / 255.0
        mean, std = self._encode_raw(x).chunk(2, dim=1)
        z = mean
        if sample:
            g = torch.Generator(device="cpu").manual_seed(seed)
            z = mean + torch.randn(mean.shape, generator=g).to(mean.device) * std
        z = rescale_to_final(z.permute(0, 2, 3, 1).cpu().numpy(), self.scale, self.bias)
        return z.reshape((b, t) + z.shape[1:])

    @torch.no_grad()
    def latents_to_frames(self, latents: np.ndarray) -> np.ndarray:
        """Final latents (b, t, h', w', 4) -> uint8 frames (b, t, 8h', 8w', 3)."""
        b, t = latents.shape[:2]
        z = rescale_from_final(latents.reshape((-1,) + latents.shape[2:]), self.scale,
                               self.bias)
        zt = torch.from_numpy(np.ascontiguousarray(z)).to(self.device).permute(0, 3, 1, 2)
        outs = [self._vae.decode(chunk)["sample"] for chunk in zt.float().split(self.batch_size)]
        x = torch.cat(outs).clamp(0, 1).mul(255).to(torch.uint8)
        x = x.permute(0, 2, 3, 1).cpu().numpy()
        return x.reshape((b, t) + x.shape[1:])
