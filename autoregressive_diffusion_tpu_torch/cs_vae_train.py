"""Counter-Strike VAE training on the card (Gaussian NLL + perceptual).

    python -m autoregressive_diffusion_tpu_torch.cs_vae_train [--steps 10000]
        [--batch 2] [--clip-size 32] [--frame-size 256] [--lr 1e-4]
        [--shards DIR | --synthetic] [--small] [--ckpt-dir saved_models_cs]
        [--device cuda]

Counterpart of scripts/cs_vae_train.py, flag for flag: VAE(3, 32, 128,
512, 8) with 5 res blocks a level, space (1, 2, 2, 2) and time (1, 2, 2, 1)
(96x compression; --small: (3, 16, 32, 64, 8), 1 block); the loss is
ops.numerics.gaussian_loss of the decoded mean and log-variance against the
frames plus 0.1 x train.perceptual.perceptual_loss (trained AlexNet-LPIPS
with AD_TPU_LPIPS_WEIGHTS, the calibrated one when its file exists, else
the random-feature loss); a 0.5 global-norm clip, then AdamW (eps 1e-8,
weight decay 1e-4: optax's adamw default) on 100 warmup steps from lr 0,
then an exponential decay to 0.4 --lr at the end. Each step draws t ~
U(0, 0.1) and the latent noise from a torch generator seeded 2, as the JAX
script splits key 2 (the same law, not the same bits); the VAE starts from
init_vae with seed 0.

Data: --shards reads .npz shards with a 'frames' array (uint8 (t, h, w, 3))
through data.LocalLatentShards(key="frames") and two worker threads;
otherwise synthetic moving-square clips. Frames are normalized to [-1, 1].
The loss and its terms are read and printed every 20 steps; the VAE goes
to {ckpt-dir}/vae_cs.ad in the JAX package's tree every 1000 steps and,
unlike the JAX script, at the end of the run. --micro-batch is parsed and,
as in the JAX script, not used: a step takes the whole batch.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from .data import LocalLatentShards, SyntheticVideoGenerator, batched_latents
from .models.vae import VAE, VAEConfig, init_vae
from .ops.numerics import gaussian_loss
from .train.optim import ClippedAdamW
from .train.perceptual import perceptual_kind, perceptual_loss
from .utils.bridge import flax_variables
from .utils.checkpoint import save_model
from .utils.device import resolve_device

CS_VAE = VAEConfig(channels=(3, 32, 128, 512, 8), n_res_blocks=5,
                   time_compressions=(1, 2, 2, 1), spatial_compressions=(1, 2, 2, 2))
CS_VAE_SMALL = VAEConfig(channels=(3, 16, 32, 64, 8), n_res_blocks=1,
                         time_compressions=(1, 2, 2, 1), spatial_compressions=(1, 2, 2, 2))
VAE_SEED, STEP_SEED = 0, 2  # the JAX script's PRNGKeys
WARMUP = 100


def add_data_args(ap: argparse.ArgumentParser) -> None:
    """The flags both CS VAE scripts share."""
    ap.add_argument("--steps", type=int, default=10_000)
    ap.add_argument("--frame-size", type=int, default=256)
    ap.add_argument("--shards", default=None, help=".npz frame shards ('frames')")
    ap.add_argument("--ckpt-dir", default="saved_models_cs")
    ap.add_argument("--small", action="store_true", help="tiny channels, for smoke tests")
    ap.add_argument("--synthetic", action="store_true",
                    help="synthetic frames (also the default without --shards)")
    ap.add_argument("--device", default="cuda")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_data_args(ap)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--micro-batch", type=int, default=1,
                    help="parsed and not used, as in the JAX script: no accumulation")
    ap.add_argument("--clip-size", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-4)
    return ap.parse_args(argv)


def vae_config(small: bool) -> VAEConfig:
    return CS_VAE_SMALL if small else CS_VAE


def warmup_decay(lr: float, steps: int) -> Callable[[int], float]:
    """lr * count / 100 for the first 100 updates (0 at the first), then
    lr * gamma^(count - 100), gamma = 0.4^(1 / (steps - 100))."""
    gamma = 0.4 ** (1 / max(steps - WARMUP, 1))
    return lambda s: lr * (s / WARMUP if s < WARMUP else gamma ** (s - WARMUP))


@dataclasses.dataclass
class CSVAETrainer:
    """The VAE, its optimizer and the step state of a run."""
    args: argparse.Namespace
    device: torch.device
    cfg: VAEConfig
    vae: VAE
    tx: ClippedAdamW
    opt: torch.optim.Optimizer
    generator: torch.Generator  # each step's t and noise
    count: int = 0              # updates taken


def build_trainer(args: argparse.Namespace) -> CSVAETrainer:
    dev = resolve_device(args.device)
    cfg = vae_config(args.small)
    vae = init_vae(VAE(cfg), torch.Generator().manual_seed(VAE_SEED)).to(dev)
    tx = ClippedAdamW(warmup_decay(args.lr, args.steps), grad_clip=0.5, eps=1e-8,
                      weight_decay=1e-4)
    return CSVAETrainer(args, dev, cfg, vae, tx, tx.init(vae.parameters()),
                        torch.Generator(device=dev).manual_seed(STEP_SEED))


def reconstruction_loss(vae: VAE, frames: torch.Tensor, t: torch.Tensor,
                        noise: torch.Tensor):
    """(gaussian + 0.1 perceptual, {gaussian, perceptual, l1}, decoded
    mean) of the noise-augmented autoencode of [-1, 1] frames."""
    r_mean, r_logvar, _ = vae(frames, t, noise)
    g = gaussian_loss(r_mean, r_logvar, frames)
    perc = perceptual_loss(r_mean, frames)
    aux = {"gaussian": g.detach(), "perceptual": perc.detach(),
           "l1": torch.mean(torch.abs(r_mean - frames)).detach()}
    return g + 0.1 * perc, aux, r_mean


def train_step(tr: CSVAETrainer, frames: torch.Tensor, t=None, noise=None) -> dict:
    """One update on [-1, 1] frames (b, T, h, w, 3) on the card; t and noise
    as given, else drawn from the trainer's generator. Returns the loss
    terms on the card, unread."""
    if t is None:
        t, noise = tr.vae.draw_t_noise(frames, tr.generator)
    t, noise = t.to(frames), noise.to(frames)
    loss, aux, _ = reconstruction_loss(tr.vae, frames, t, noise)
    tr.opt.zero_grad(set_to_none=True)
    loss.backward()
    tr.tx.update(tr.opt, tr.count)
    tr.count += 1
    return dict(aux, loss=loss.detach())


def frame_batches(args: argparse.Namespace):
    """Endless batches of [-1, 1] fp32 frames (b, clip, h, w, 3) on the
    host: the 'frames' windows of --shards, else synthetic clips (the
    generator made anew, seed = epoch, whenever it runs out)."""
    b, clip = args.batch, args.clip_size
    if args.shards and not args.synthetic:
        ds = LocalLatentShards(args.shards, clip_size=clip, key="frames")
        yield from (item["frames"] / 127.5 - 1 for item in batched_latents(ds, b))
        return
    print("# synthetic frames (smoke mode)", flush=True)
    epoch = 0
    while True:
        gen = iter(SyntheticVideoGenerator(clip, args.frame_size, 4, 4, max(b, 64), seed=epoch))
        try:
            while True:
                u8 = np.stack([next(gen)[0] for _ in range(b)])
                yield u8.astype(np.float32) / 127.5 - 1
        except StopIteration:
            epoch += 1


def save(vae: VAE, cfg: VAEConfig, path: str) -> str:
    save_model(path, dataclasses.asdict(cfg), flax_variables(vae))
    return path


def train_loop(tr: CSVAETrainer, loader, on_step: Optional[Callable] = None) -> str:
    """Steps with the JAX script's cadence (printed when i % 20 == 0, saved
    when i % 1000 == 0, i > 0) and a save at the end. on_step(i, aux) after
    each step. Returns the bundle's path."""
    a = tr.args
    path = os.path.join(a.ckpt_dir, "vae_cs.ad")
    t0 = time.time()
    for i, frames in enumerate(loader):
        if i >= a.steps:
            break
        aux = train_step(tr, torch.from_numpy(frames).to(tr.device))
        if on_step is not None:
            on_step(i, aux)
        if i % 20 == 0:
            print(f"step {i}: gaussian={float(aux['gaussian']):.4f} l1={float(aux['l1']):.4f} "
                  f"perc={float(aux['perceptual']):.3f} "
                  f"({a.batch * (i + 1) / (time.time() - t0):.2f} clips/s)", flush=True)
        if i % 1000 == 0 and i > 0:
            save(tr.vae, tr.cfg, path)
            print("# saved VAE checkpoint", flush=True)
    save(tr.vae, tr.cfg, path)
    print("# final VAE checkpoint saved", flush=True)
    return path


def main(argv=None) -> CSVAETrainer:
    args = parse_args(argv)
    tr = build_trainer(args)
    n = sum(p.numel() for p in tr.vae.parameters())
    cfg = tr.cfg
    print(f"# VAE: {n / 1e6:.2f}M params, "
          f"{cfg.time_compression * cfg.spatial_compression ** 2 * 3 // cfg.channels[-1]}x "
          f"compression; perceptual loss: {perceptual_kind(3)}", flush=True)
    train_loop(tr, frame_batches(args))
    return tr


if __name__ == "__main__":
    main()
