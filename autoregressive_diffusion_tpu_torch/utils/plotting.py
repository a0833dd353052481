"""The training dashboard (matplotlib, imported only when drawing).

Counterpart of autoregressive_diffusion_tpu/utils/plotting.py: (1) loss
against sigma coloured by frame position with the Fourier fit, (2) the loss
history with its moving average, (3) the sampler's per-step MSE against a
held-out frame, (4) the decoded rollout. Missing inputs leave a panel
empty. `have_matplotlib` tells a caller whether a dashboard can be drawn;
where it cannot (the card's machine has no matplotlib), the callers keep
their PNG strips.
"""
from __future__ import annotations

import importlib.util
import os
from typing import Optional, Sequence

import numpy as np
import torch


def have_matplotlib() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def moving_average(x: Sequence[float], w: int) -> np.ndarray:
    x = np.asarray(x, np.float64)
    if len(x) < w:
        return x
    return np.convolve(x, np.ones(w) / w, mode="valid")


def plot_loss_vs_sigma(ax, noise_state, coefs):
    from ..train.loss_weight import fourier_eval

    if noise_state.sigmas.size:
        import matplotlib.colors as mcolors

        sc = ax.scatter(noise_state.sigmas, noise_state.losses,
                        c=np.maximum(noise_state.positions, 1), s=0.5, cmap="viridis",
                        alpha=1.0)
        sc.set_norm(mcolors.LogNorm())
    sig = np.logspace(-2, 2, 200, dtype=np.float32)
    fit = fourier_eval(torch.as_tensor(np.asarray(coefs, np.float32)),
                       torch.from_numpy(sig)).numpy()
    ax.plot(sig, fit, color="red", label="Fourier fit")
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("sigma")
    ax.set_ylabel("loss")
    ax.set_title("Loss vs noise level")
    ax.grid(True)


def plot_training_dashboard(save_path: str, losses_history, current_step: int,
                            noise_state=None, coefs=None,
                            mse_steps: Optional[Sequence[float]] = None,
                            rollout_frames: Optional[np.ndarray] = None,
                            unet_params: Optional[int] = None):
    """rollout_frames: (t, h, w, 3) uint8, tiled 8 to a row in panel 4."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 2, figsize=(14, 10))
    title = f"step {current_step}"
    if unet_params:
        title += f" | {unet_params / 1e6:.1f}M params"
    fig.suptitle(title)

    if noise_state is not None and coefs is not None:
        plot_loss_vs_sigma(axes[0, 0], noise_state, coefs)

    ax = axes[0, 1]
    if len(losses_history):
        ax.plot(losses_history, alpha=0.3, label="loss")
        ma = moving_average(losses_history, min(100, max(1, len(losses_history) // 10)))
        ax.plot(np.arange(len(losses_history) - len(ma), len(losses_history)), ma,
                label="moving avg")
        ax.set_yscale("log")
        ax.legend()
    ax.set_title("Loss history")
    ax.grid(True)

    ax = axes[1, 0]
    if mse_steps is not None and len(mse_steps):
        ax.plot(mse_steps, marker="o")
        ax.set_yscale("log")
        ax.set_xlabel("denoising step")
    ax.set_title("Sampler MSE vs target")
    ax.grid(True)

    ax = axes[1, 1]
    if rollout_frames is not None:
        t = rollout_frames.shape[0]
        cols = min(t, 8)
        rows = -(-t // cols)
        h, w = rollout_frames.shape[1:3]
        tile = np.zeros((rows * h, cols * w, 3), np.uint8)
        for i in range(t):
            r, c = divmod(i, cols)
            tile[r * h:(r + 1) * h, c * w:(c + 1) * w] = rollout_frames[i]
        ax.imshow(tile)
    ax.axis("off")
    ax.set_title("Autoregressive rollout")

    os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
    fig.savefig(save_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
