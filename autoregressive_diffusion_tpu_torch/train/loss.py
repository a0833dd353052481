"""DART training loss + LR schedule.

Counterpart of autoregressive_diffusion_tpu/train/loss.py. The
MultiNoiseLoss statefulness is outside: the loss takes the current Fourier
coefficients as input and returns the (sigma, weighted-loss) pairs for the
host-side history. Randomness comes from explicit torch.Generators keyed by
(seed, sample index), where the JAX package folds the sample index into a
PRNG key; the two draw different numbers from the same seed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .loss_weight import fourier_eval


@dataclasses.dataclass(frozen=True)
class EDM2LossConfig:
    P_mean: float = 0.5
    P_std: float = 2.0
    sigma_data: float = 1.0
    context_noise_reduction: float = 0.1

    def __post_init__(self):
        if not 0 <= self.context_noise_reduction <= 1:
            raise ValueError("context_noise_reduction must be in [0, 1]")


# The dropout masks of a forward call come from the generator of (seed,
# DROPOUT_INDEX + the microbatch's first sample), the counterpart of the JAX
# package's fold_in(key, 0x7FFFFFFF): one draw a call, not a sample.
DROPOUT_INDEX = 0x7FFFFFFF


def _sample_generator(seed: int, index: int, device) -> torch.Generator:
    """The generator of sample `index` under `seed` (a 63-bit mix of both)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 0x9E3779B97F4A7C15 + int(index) * 0xD1B54A32D192ED03
                   + 0x2545F4914F6CDD1D) % (2 ** 63))
    return g


def draw_sigma_noise(seed: int, index: int, t: int, frame_shape, cfg: EDM2LossConfig,
                     just_2d: bool, device):
    """(sigma (2t | t,), eps (2t | t, H, W, C)) of one sample: log-normal
    sigmas for the noisy frames, one uniform context sigma for all clean
    frames of the sample, unit normal eps."""
    g = _sample_generator(seed, index, device)
    sig = torch.exp(torch.randn((t,), generator=g, device=device) * cfg.P_std + cfg.P_mean)
    if not just_2d:
        sig_ctx = torch.rand((), generator=g, device=device) * cfg.context_noise_reduction
        sig = torch.cat([sig_ctx.expand(t), sig])
    eps = torch.randn((sig.shape[0],) + tuple(frame_shape), generator=g, device=device)
    return sig, eps


def edm2_loss(model, images: torch.Tensor, seed: int, cfg: EDM2LossConfig,
              conditioning: Optional[torch.Tensor] = None,
              coefs: Optional[torch.Tensor] = None, just_2d: bool = False,
              sample_offset: int = 0, sigma: Optional[torch.Tensor] = None,
              noise: Optional[torch.Tensor] = None, mesh=None):
    """images: (b, t, h, w, c) latents. Returns (scalar loss, aux) where aux
    carries the per-frame sigmas and weighted losses for the loss-fit
    history plus the unweighted mean.

    With a `mesh` (parallel.Mesh; sequence-parallel training) images and
    conditioning are this rank's samples and frames (parallel.seq_slice),
    sample_offset is the global index of its first sample, and the loss
    and the unweighted mean are this rank's share of the global means: sums
    over its (sample, frame) terms over the count of the whole
    microbatch's (b * replicas * dp samples, t * sp frames), to be summed
    over the ranks of the mesh's grad group (the model ranks of a position
    compute the same terms). Each rank draws the whole sample's sigma and
    eps and keeps its frames, so the split step draws what the one-process
    step draws.

    sigma and noise are drawn per sample from generators keyed by
    (seed, sample_offset + i), so gradient accumulation over microbatch
    slices (train_state.py) samples exactly what the full batch would;
    dropout masks (cfg.dropout > 0) are the exception, drawn per call.
    Passing `sigma` (b, 2t or t) and `noise` (the shape of the DART concat)
    bypasses the sampling; with `sigma` alone the noise is sigma * eps from
    the generator of (seed, 0).
    """
    b, t = images.shape[:2]
    dev = images.device
    if just_2d:
        cat_images, cond = images, conditioning
    else:
        cat_images = torch.cat([images, images], dim=1)
        cond = (torch.cat([conditioning, conditioning], dim=1)
                if conditioning is not None else None)

    sp, dp = (1, 1) if mesh is None else (mesh.sp, mesh.batch_ranks)
    if sigma is None:
        draws = [draw_sigma_noise(seed, sample_offset + i, t * sp, images.shape[2:], cfg,
                                  just_2d, dev) for i in range(b)]
        sigma = torch.stack([d[0] for d in draws])
        eps = torch.stack([d[1] for d in draws]).to(cat_images.dtype)
        if sp > 1:  # this rank's frames of each half
            r = mesh.seq_rank
            keep = torch.arange(r * t, (r + 1) * t, device=dev)
            if not just_2d:
                keep = torch.cat([keep, keep + t * sp])
            sigma, eps = sigma[:, keep], eps[:, keep]
        noise = sigma[:, :, None, None, None] * eps
    elif noise is None:
        eps = torch.randn(cat_images.shape, generator=_sample_generator(seed, 0, dev),
                          device=dev).to(cat_images.dtype)
        noise = sigma[:, :, None, None, None] * eps
    drop_g = (_sample_generator(seed, DROPOUT_INDEX + sample_offset, dev)
              if model.cfg.dropout > 0 else None)
    out, _ = model(cat_images + noise, sigma, cond, mode="train", just_2d=just_2d,
                   dropout_generator=drop_g)
    denoised = out[:, -t:]
    errors = (denoised - images) ** 2
    losses = errors.mean(dim=(-1, -2, -3))  # (b, t)

    sig = sigma[:, -t:]
    sd = cfg.sigma_data
    weight = (sig ** 2 + sd ** 2) / (sig * sd) ** 2
    losses = losses * weight
    count = losses.numel() * sp * dp  # the (sample, frame) terms of all ranks
    unweighted = losses.sum() / count

    mean_loss = fourier_eval(coefs, sig) if coefs is not None else 1.0
    normalized = (losses / mean_loss).sum() / count
    aux = dict(sigma=sig.detach(), losses=losses.detach(), unweighted=unweighted.detach())
    return normalized, aux


def top_losses(errors: torch.Tensor, fraction: float) -> torch.Tensor:
    """Mean of the top-k pixel errors + overall mean (an unused alternative
    of the original). errors: (b, t, h, w, c)."""
    e = errors.mean(dim=-1).reshape(errors.shape[0], errors.shape[1], -1)
    k = int(e.shape[-1] * e.shape[-2] * fraction)
    top_k = torch.topk(e, k, dim=-1)[0]
    return top_k.mean(dim=-1) + e.mean(dim=-1)


def learning_rate_schedule(step, ref_lr: float = 1e-2, ref_step: float = 7e4,
                           rampup_steps: float = 1e3) -> float:
    """EDM2 inverse-sqrt decay + linear rampup, for a host step count. The
    arithmetic is fp32, as in the JAX package, so both give the same
    learning rate to the last bit."""
    f32 = np.float32
    step = f32(step)
    lr = f32(ref_lr)
    if ref_step > 0:
        lr = lr / np.sqrt(np.maximum(step / f32(ref_step), f32(1.0)))
    if rampup_steps > 0:
        lr = lr * np.minimum(step / f32(rampup_steps), f32(1.0))
    return float(lr)
