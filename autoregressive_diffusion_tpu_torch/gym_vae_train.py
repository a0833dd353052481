"""LunarLander VAE + adversarial discriminator training on the card.

    python -m autoregressive_diffusion_tpu_torch.gym_vae_train [--steps 4000]
        [--batch 4] [--state-size 32] [--frame-size 256] [--lr 3e-4]
        [--synthetic] [--replay CAPACITY] [--remat] [--ckpt-dir saved_models]
        [--out-dir images_training] [--device cuda]

Counterpart of scripts/gym_vae_train.py, flag for flag: VAE(3, 8, 8, 8)
with 2 res blocks a level, time (1, 2, 2) and space (1, 2, 2); the loss is
the worst-0.2% pixel MSE, plus 1e-3 times the group KL of the latent mean
(variance over (b, t, h, w), biased, + 1e-8), plus the hinged adversarial
term 2e-5 * mean(relu(ce - 1)^2), where ce is the MixedDiscriminator's
per-element cross-entropy / log 2 on both channel orders, in eval mode. A
step (1) updates the VAE, (2) decodes the clip again with the updated VAE
without noise (t = 0) and (3) takes one discriminator step in train mode
on it, which moves the BatchNorm statistics. Each has its own 1.0
global-norm clip and AdamW (eps 1e-8, weight decay 1e-4: optax's adamw
default) on lr0 * gamma^count with gamma = 0.1^(1/steps); the
discriminator's lr0 is --lr * 8e-2.

Frames arrive as uint8 and are normalized on the card. Data: --synthetic
moving-square clips, else LunarLander from gymnasium, streamed by four
worker threads, or sampled from a host ring of --replay clips. --remat
recomputes the VAE's and the eval-mode discriminator's activations in the
backward (torch.utils.checkpoint), so a batch of 4 256-px clips of 32
frames needs less memory: the adversarial pass runs 8 clips of 32 frames
through 64-channel 256x256 layers.

Every 500 steps and at the end the VAE goes to
{ckpt-dir}/vae_lunar_lander.ad in the JAX package's tree (params, buffers),
which the JAX load_model, the port's vae_from_bundle and generate --vae
read, and the loss curves to {out-dir}/vae_losses_{tag}.npz (and a PNG
where matplotlib is installed). Weights are drawn from torch generators
seeded as the JAX script's keys (0 the VAE, 2 the discriminator, 3 the
steps' t and noise): the same law, not the same bits.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
import os
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .data import GymDataGenerator, ReplayLoader, SyntheticVideoGenerator, batched
from .models.discriminator import MixedDiscriminator, discriminator_loss, init_discriminator
from .models.vae import VAE, VAEConfig, init_vae, worst_k_percent_loss
from .train.optim import ClippedAdamW
from .utils.bridge import flax_variables
from .utils.checkpoint import save_model
from .utils.device import resolve_device

GYM_VAE = VAEConfig(channels=(3, 8, 8, 8), n_res_blocks=2, time_compressions=(1, 2, 2),
                    spatial_compressions=(1, 2, 2))
VAE_SEED, DISC_SEED, STEP_SEED = 0, 2, 3  # the JAX script's PRNGKeys
BUNDLE = "vae_lunar_lander.ad"
METRICS = ("recon", "kl_group", "adv", "disc")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--state-size", type=int, default=32, help="frames a clip")
    ap.add_argument("--env", default="LunarLander-v3")
    ap.add_argument("--frame-size", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="saved_models")
    ap.add_argument("--synthetic", action="store_true",
                    help="synthetic moving-square clips instead of gymnasium")
    ap.add_argument("--out-dir", default="images_training")
    ap.add_argument("--replay", type=int, default=0, metavar="CAPACITY",
                    help="sample batches from a host ring of this many clips (0: stream)")
    ap.add_argument("--remat", action="store_true",
                    help="recompute the VAE's and the eval-mode discriminator's activations "
                         "in the backward (torch.utils.checkpoint): less memory, more time")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


@dataclasses.dataclass
class GymVAETrainer:
    """The models, optimizers and step state of a run (build_trainer)."""
    args: argparse.Namespace
    device: torch.device
    vae: VAE
    disc: MixedDiscriminator
    tx_vae: ClippedAdamW
    tx_disc: ClippedAdamW
    opt_vae: torch.optim.Optimizer
    opt_disc: torch.optim.Optimizer
    generator: torch.Generator          # each step's t and noise
    count: int = 0                      # updates taken
    history: dict = dataclasses.field(default_factory=lambda: {k: [] for k in METRICS})
    pending: list = dataclasses.field(default_factory=list)  # metrics not read yet


def decay_schedule(lr0: float, steps: int) -> Callable[[int], float]:
    """lr0 * gamma^count, gamma = 0.1^(1/steps): down to 0.1 lr0 at the end."""
    gamma = 0.1 ** (1 / steps)
    return lambda count: lr0 * gamma ** count


def build_trainer(args: argparse.Namespace) -> GymVAETrainer:
    dev = resolve_device(args.device)
    vae = init_vae(VAE(GYM_VAE), torch.Generator().manual_seed(VAE_SEED)).to(dev)
    disc = init_discriminator(MixedDiscriminator(), torch.Generator().manual_seed(DISC_SEED))
    disc = disc.to(dev)
    tx_vae = ClippedAdamW(decay_schedule(args.lr, args.steps), grad_clip=1.0, eps=1e-8,
                          weight_decay=1e-4)
    tx_disc = ClippedAdamW(decay_schedule(args.lr * 8e-2, args.steps), grad_clip=1.0,
                           eps=1e-8, weight_decay=1e-4)
    return GymVAETrainer(args, dev, vae, disc, tx_vae, tx_disc, tx_vae.init(vae.parameters()),
                         tx_disc.init(disc.parameters()),
                         torch.Generator(device=dev).manual_seed(STEP_SEED))


@contextlib.contextmanager
def frozen(module: torch.nn.Module):
    """No gradients to module's parameters inside (the inputs still get
    theirs)."""
    flags = [p.requires_grad for p in module.parameters()]
    module.requires_grad_(False)
    try:
        yield module
    finally:
        for p, f in zip(module.parameters(), flags):
            p.requires_grad_(f)


def maybe_remat(fn, remat: bool, *args):
    return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)


def group_kl(mean: torch.Tensor) -> torch.Tensor:
    """KL of the per-channel statistics of the latent mean to N(0, 1): the
    biased variance over (b, t, h, w) + 1e-8."""
    var = mean.var(dim=(0, 1, 2, 3), unbiased=False) + 1e-8
    mu = mean.mean(dim=(0, 1, 2, 3))
    return -0.5 * torch.sum(1 + torch.log(var) - mu ** 2 - var)


def vae_loss(tr: GymVAETrainer, frames: torch.Tensor, t: torch.Tensor, noise: torch.Tensor):
    """(loss, (recon, kl_group, mean ce)) of the VAE on [-1, 1] frames at
    noise level t with latent noise `noise`, the discriminator in eval mode
    (the caller freezes its parameters)."""
    remat = tr.args.remat
    r_mean, _, mean = maybe_remat(lambda x: tr.vae(x, t, noise), remat, frames)
    recon = worst_k_percent_loss(r_mean, frames, percent=0.2)
    kl = group_kl(mean)
    # both channel orders, labelled as the generator wants them misjudged:
    # (frames || recon) as 0, (recon || frames) as 1; per element, for the hinge
    pairs = torch.cat([torch.cat([frames, r_mean], -1), torch.cat([r_mean, frames], -1)], 0)
    logits = maybe_remat(lambda x: tr.disc(x, False), remat, pairs)
    logp = F.log_softmax(logits, dim=-1)
    n = frames.shape[0]
    ce = -torch.cat([logp[:n, ..., 0], logp[n:, ..., 1]], 0) / math.log(2)
    adv = 2e-5 * torch.mean(F.relu(ce - 1) ** 2)
    return recon + kl * 1e-3 + adv, torch.stack([recon, kl, ce.mean()]).detach()


def train_step(tr: GymVAETrainer, frames_u8, t=None, noise=None) -> torch.Tensor:
    """One step on a uint8 batch (b, T, h, w, 3): the VAE update, the
    noise-free decode by the updated VAE, one discriminator step in train
    mode. t and noise as given, else drawn from the trainer's generator.
    Returns the (recon, kl_group, adv, disc) metrics on the card, unread."""
    dtype = tr.vae.decoder.logvar_multiplier.dtype  # fp32 as built; float64 in parity tests
    frames = torch.as_tensor(frames_u8).to(tr.device).to(dtype) / 127.5 - 1.0
    if t is None:
        t, noise = tr.vae.draw_t_noise(frames, tr.generator)
    t, noise = t.to(frames), noise.to(frames)
    with frozen(tr.disc):  # no gradient to the discriminator in the VAE's backward
        loss, metrics = vae_loss(tr, frames, t, noise)
        tr.opt_vae.zero_grad(set_to_none=True)
        loss.backward()
    tr.tx_vae.update(tr.opt_vae, tr.count)
    with torch.no_grad():
        r_mean = tr.vae(frames)[0]
    dl = discriminator_loss(tr.disc, frames, r_mean, train=True)
    tr.opt_disc.zero_grad(set_to_none=True)
    dl.backward()
    tr.tx_disc.update(tr.opt_disc, tr.count)
    tr.count += 1
    return torch.cat([metrics, dl.detach()[None]])


def flush(tr: GymVAETrainer) -> None:
    """Read the pending metrics in one copy and append them to history."""
    if tr.pending:
        for row in torch.stack(tr.pending).cpu().numpy():
            for name, val in zip(METRICS, row):
                tr.history[name].append(float(val))
        tr.pending.clear()


def make_loader(args: argparse.Namespace):
    """(loader of (frames, actions, rewards) uint8 batches, replay or None)."""
    if args.synthetic:
        gen = SyntheticVideoGenerator(args.state_size, args.frame_size, 4, 4, args.steps * 2)
    else:
        gen = GymDataGenerator(args.state_size, args.env, args.steps * 2, 4,
                               frame_size=args.frame_size)
    if args.replay > 0:
        replay = ReplayLoader(gen, args.batch, capacity=args.replay, seed=7)
        return replay, replay
    return batched(gen, args.batch, num_workers=4), None


def save(tr: GymVAETrainer, tag) -> str:
    """The VAE bundle and the loss curves; returns the bundle's path."""
    path = os.path.join(tr.args.ckpt_dir, BUNDLE)
    save_model(path, dataclasses.asdict(GYM_VAE), flax_variables(tr.vae))
    save_curves(tr.args.out_dir, tr.history, tag)
    return path


def save_curves(out_dir, history: dict, tag) -> None:
    """vae_losses_{tag}.npz, and a PNG of the four curves where matplotlib
    is installed."""
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, f"vae_losses_{tag}.npz"),
             **{k: np.asarray(v, np.float32) for k, v in history.items()})
    try:
        import matplotlib
    except ImportError:
        print("# matplotlib is not installed: loss curves kept as .npz only", flush=True)
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, axes = plt.subplots(2, 2, figsize=(12, 8))
    for ax, (name, vals) in zip(axes.ravel(), history.items()):
        ax.plot(vals, alpha=0.4)
        if len(vals) > 50:
            w = max(1, len(vals) // 50)
            ma = np.convolve(vals, np.ones(w) / w, mode="valid")
            ax.plot(np.arange(len(vals) - len(ma), len(vals)), ma)
        ax.set_title(name)
        ax.grid(True)
        if name == "recon":
            ax.set_yscale("log")
    fig.suptitle(f"gym VAE training (step {tag})")
    fig.savefig(os.path.join(out_dir, f"vae_losses_{tag}.png"), dpi=110, bbox_inches="tight")
    plt.close(fig)


def train_loop(tr: GymVAETrainer, loader, replay=None,
               on_step: Optional[Callable] = None) -> str:
    """Steps with the JAX script's cadence: metrics read and printed when
    i % 20 == 0, the bundle and curves saved when i % 500 == 0 (i > 0) and
    at the end. on_step(i, metrics) after each step. Returns the bundle's
    path."""
    a = tr.args
    t0 = time.time()
    for i, (frames, _, _) in enumerate(loader):
        if i >= a.steps:
            break
        tr.pending.append(train_step(tr, frames))
        if on_step is not None:
            on_step(i, tr.pending[-1])
        if i % 20 == 0:
            flush(tr)
            extra = ""
            if replay is not None:
                rs = replay.stats()
                extra = f" replay[{rs['produced']} fresh, x{rs['reuse_factor']:.1f} reuse]"
            h = tr.history
            print(f"step {i}: recon={h['recon'][-1]:.4f} kl_group={h['kl_group'][-1]:.3f} "
                  f"adv={h['adv'][-1]:.3f} disc={h['disc'][-1]:.3f} "
                  f"({a.batch * (i + 1) / (time.time() - t0):.2f} clips/s){extra}", flush=True)
        if i % 500 == 0 and i > 0:
            flush(tr)
            save(tr, i)
            print("# saved VAE checkpoint + loss curves", flush=True)
    flush(tr)
    path = save(tr, "final")
    print("# final VAE checkpoint saved", flush=True)
    return path


def main(argv=None) -> GymVAETrainer:
    args = parse_args(argv)
    tr = build_trainer(args)
    print(f"# VAE params: {sum(p.numel() for p in tr.vae.parameters()) / 1e3:.0f}K", flush=True)
    loader, replay = make_loader(args)
    try:
        train_loop(tr, loader, replay)
    finally:
        if replay is not None:
            replay.stop()
    return tr


if __name__ == "__main__":
    main()
