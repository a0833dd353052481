"""The benchmark's generators: every input a cell feeds the program,
drawn on the card from the seed.

  * ar1_latents: the synthetic latent law of the CS training script, per
    clip an AR(1) process over frames (coefficient `rho`) of normal fields
    smoothed by the periodic 5-tap plus stencil (over sqrt 5, so unit
    variance);
  * edm_sigma_noise: the EDM2 training draws of one batch, a log-normal
    noise level a noisy frame (P_mean, P_std), one uniform context level
    in [0, context_noise_reduction) for a sample's clean frames, and unit
    normal noise;
  * draw_seed: the seed of one named stream of a run, so that every stream
    is the same in every run of a seed and differs between seeds.
"""
from __future__ import annotations

import hashlib
import math

import torch


def draw_seed(seed: int, stream: str, index: int = 0) -> int:
    """A 63-bit seed for stream `stream` (and `index`) of run seed `seed`."""
    h = hashlib.sha256(f"{int(seed)}/{stream}/{int(index)}".encode()).digest()
    return int.from_bytes(h[:8], "little") % (2 ** 63)


def ar1_latents(b, t, res, ch, law: dict, seed: int, device) -> torch.Tensor:
    """(b, t, res, res, ch) latents of the AR(1) law `law` = {"rho": r}."""
    rho = float(law["rho"])
    g = torch.Generator(device=device).manual_seed(seed)
    eps = torch.randn((t, b, res, res, ch), generator=g, device=device)
    eps = (eps + eps.roll(1, -3) + eps.roll(-1, -3) + eps.roll(1, -2)
           + eps.roll(-1, -2)) / math.sqrt(5.0)
    frames = [eps[0]]
    for e in eps[1:]:
        frames.append(rho * frames[-1] + math.sqrt(1 - rho ** 2) * e)
    return torch.stack(frames, dim=1)


def edm_sigma_noise(b, t, res, ch, loss: dict, just_2d: bool, seed: int, device):
    """(sigma (b, 2t) or (b, t) under just_2d, noise of the same frames) of
    one batch: the clean frames first, then the noisy ones."""
    g = torch.Generator(device=device).manual_seed(seed)
    sig = torch.exp(torch.randn((b, t), generator=g, device=device) * loss["P_std"]
                    + loss["P_mean"])
    if not just_2d:
        ctx = torch.rand((b, 1), generator=g, device=device) * loss["context_noise_reduction"]
        sig = torch.cat([ctx.expand(b, t), sig], 1)
    eps = torch.randn((b, sig.shape[1], res, res, ch), generator=g, device=device)
    return sig, sig[:, :, None, None, None] * eps
