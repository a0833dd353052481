"""EDM (Karras) sampler with cache-carried autoregressive decode.

Counterpart of autoregressive_diffusion_tpu/sampling/sampler.py. One
`edm_sampler` call generates ONE frame (b, 1, h, w, c) against the cache:
num_steps-1 Euler+Heun steps (a Python loop where JAX has lax.scan), then a
final Euler step whose denoiser call writes the finished frame into the
cache. Noise comes from an explicit torch.Generator on the model's device;
`x_init` injects the initial noise (already scaled by sigma_max) instead.
`make_sampler_callback` is the training loop's eval-time feedback.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..utils.profiling import span


def karras_schedule(num_steps: int, sigma_min: float, sigma_max: float,
                    rho: float) -> np.ndarray:
    """t_i = (smax^(1/rho) + i/(N-1)(smin^(1/rho) - smax^(1/rho)))^rho, then 0."""
    i = np.arange(num_steps, dtype=np.float64)
    t = (sigma_max ** (1 / rho)
         + i / (num_steps - 1) * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))) ** rho
    return np.concatenate([t, [0.0]]).astype(np.float32)


@torch.no_grad()
def edm_sampler(model, cache, shape, conditioning=None,
                generator: Optional[torch.Generator] = None,
                num_steps: int = 32, sigma_min: float = 0.002,
                sigma_max: float = 80.0, rho: float = 7.0,
                guidance: float = 1.0, S_churn: float = 0.0,
                S_min: float = 0.0, S_max: float = float("inf"),
                S_noise: float = 1.0, update_cache: bool = True,
                target: Optional[torch.Tensor] = None,
                x_init: Optional[torch.Tensor] = None):
    """Sample one frame. Returns (x, mse_values, mse_pred_values, cache).

    `target`, if given, is added to the initial noise and per-step MSEs are
    tracked; the cache is then NOT updated. Noise is drawn from `generator`
    (on the model's device) only where a step needs it. The whole frame is
    one sampler.frame span (utils/profiling.span)."""
    with span("sampler.frame"):
        dev = next(model.parameters()).device
        b = shape[0]
        t_steps = karras_schedule(num_steps, sigma_min, sigma_max, rho)
        gamma = np.zeros(num_steps, np.float32)
        if S_churn > 0:
            g = min(S_churn / num_steps, math.sqrt(2) - 1)
            sel = (t_steps[:-1] >= S_min) & (t_steps[:-1] <= S_max)
            gamma[sel] = g
        t_hats = t_steps[:-1] * (1.0 + gamma)
        churn_scale = np.sqrt(np.maximum(t_hats ** 2 - t_steps[:-1] ** 2, 0.0)) * S_noise

        def noise():
            return torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)

        def denoise(x, t, do_update):
            sigma = torch.full((b, 1), float(t), dtype=torch.float32, device=dev)
            d_x, new_cache = model(x, sigma, conditioning, cache=cache,
                                   update_cache=do_update)
            if guidance != 1.0:
                ref_dx, _ = model(x, sigma, conditioning, just_2d=True)
                d_x = ref_dx + (d_x - ref_dx) * guidance
            return d_x, new_cache

        x_next = (noise() * float(t_steps[0]) if x_init is None
                  else x_init.to(device=dev, dtype=torch.float32))
        if target is not None:
            x_next = x_next + target.float()

        mses, mses_pred = [], []
        x_cur = x_next
        for i in range(num_steps - 1):
            t_hat, t_next = float(t_hats[i]), float(t_steps[i + 1])
            x_hat = x_cur + float(churn_scale[i]) * noise() if churn_scale[i] > 0 else x_cur
            x_pred, _ = denoise(x_hat, t_hat, False)
            d_cur = (x_hat - x_pred) / t_hat
            x_nxt = x_hat + (t_next - t_hat) * d_cur
            x_pred2, _ = denoise(x_nxt, t_next, False)
            d_prime = (x_nxt - x_pred2) / t_next
            x_cur = x_hat + (t_next - t_hat) * (0.5 * d_cur + 0.5 * d_prime)
            if target is not None:
                mses_pred.append(torch.mean((x_pred2 - target) ** 2))
                mses.append(torch.mean((x_cur - target) ** 2))

        # final step: Euler only; the cache is updated iff there is no target
        i = num_steps - 1
        x_hat = x_cur + float(churn_scale[i]) * noise() if churn_scale[i] > 0 else x_cur
        t_hat = float(t_hats[i])
        x_pred, cache = denoise(x_hat, t_hat, update_cache and target is None)
        x_next = x_hat + (0.0 - t_hat) * (x_hat - x_pred) / t_hat
        if target is not None:
            mses.append(torch.mean((x_next - target) ** 2))
            mses_pred.append(torch.mean((x_pred - target) ** 2))
            return x_next, torch.stack(mses), torch.stack(mses_pred), cache
        zeros = torch.zeros(num_steps - 1, device=dev)
        return x_next, zeros, zeros, cache


def generate(model, cache, n_frames: int, shape, conditioning=None,
             generator: Optional[torch.Generator] = None, **sampler_kwargs):
    """Autoregressive rollout: sample `n_frames` frames, each entering the
    cache. Returns (frames (b, n_frames, h, w, c), cache)."""
    sampler_kwargs.setdefault("num_steps", 32)
    frames = []
    for _ in range(n_frames):
        x, _, _, cache = edm_sampler(model, cache, shape, conditioning,
                                     generator=generator, **sampler_kwargs)
        frames.append(x)
    return torch.cat(frames, dim=1), cache


@torch.no_grad()
def prefill_fresh(model, frames: torch.Tensor, sigma: float = 0.05) -> dict:
    """A fresh cache for `model` with `frames` (b, t, h, w, c) prefilled at
    noise level `sigma`, without conditioning."""
    from ..models.cache import init_cache

    b, t = frames.shape[:2]
    cache = init_cache(model, b, device=frames.device)
    sig = torch.full((b, t), float(sigma), dtype=torch.float32, device=frames.device)
    _, cache = model(frames, sig, None, cache=cache, update_cache=True)
    return cache


@torch.no_grad()
def mse_probe(model, latents: torch.Tensor, generator: Optional[torch.Generator] = None,
              num_steps: int = 32, n_context: int = 4, sigma_prefill: float = 0.05,
              S_churn: float = 20.0, x_init: Optional[torch.Tensor] = None):
    """The callback's first half: prefill the first n_context frames of
    latents[:1] (at most t - 1) into a fresh cache, then denoise the next
    frame from sigma_max 3 (rho 7, S_churn) with per-step MSE against it,
    the cache left as it was; x_init, if given, is the initial noise.
    Returns (x, mses, mses_pred)."""
    lat = latents[:1]
    b, t_lat, h, w, c = lat.shape
    n_ctx = min(n_context, t_lat - 1)
    cache = prefill_fresh(model, lat[:, :n_ctx], sigma_prefill)
    x, mses, mses_pred, _ = edm_sampler(
        model, cache, (b, 1, h, w, c), generator=generator, num_steps=num_steps,
        sigma_max=3.0, rho=7.0, S_churn=S_churn, update_cache=False,
        target=lat[:, n_ctx:n_ctx + 1], x_init=x_init)
    return x, mses, mses_pred


def make_sampler_callback(model, num_mse_steps: int = 32, n_context: int = 4,
                          n_prefill: int = 2, n_rollout: int = 4,
                          sigma_prefill: float = 0.05):
    """Eval-time training feedback, the counterpart of the JAX package's
    make_sampler_callback. Returns callback(latents, generator=None) ->
    (mse_steps, mse_pred, rollout_latents) on the first sample of latents
    (b, t, h, w, c):
      1. mse_probe: prefill n_context frames at sigma_prefill, denoise the
         next frame in num_mse_steps steps (sigma_max 3, rho 7, S_churn 20)
         with per-step MSE against it (numpy arrays);
      2. prefill n_prefill frames into a fresh cache and roll out n_rollout
         frames (sigma_max 80, rho 7, S_churn 20), returning the prefill and
         generated latents (1, n_prefill + n_rollout, h, w, c) for the
         caller's VAE decode.
    `model` is the training model: the callback runs it in eval mode with
    no autograd graph and leaves its train/eval flag as it found it."""

    @torch.no_grad()
    def callback(latents: torch.Tensor, generator: Optional[torch.Generator] = None):
        was_training = model.training
        model.eval()
        try:
            _, mses, mses_pred = mse_probe(model, latents, generator, num_mse_steps,
                                           n_context, sigma_prefill)
            lat = latents[:1]
            b, t_lat, h, w, c = lat.shape
            pre = lat[:, :min(n_prefill, t_lat)]
            cache = prefill_fresh(model, pre, sigma_prefill)
            frames = [pre.float()]
            for _ in range(n_rollout):
                x, _, _, cache = edm_sampler(model, cache, (b, 1, h, w, c),
                                             generator=generator, num_steps=num_mse_steps,
                                             sigma_max=80.0, rho=7.0, S_churn=20.0)
                frames.append(x)
            return mses.cpu().numpy(), mses_pred.cpu().numpy(), torch.cat(frames, dim=1)
        finally:
            model.train(was_training)

    return callback
