"""Counter-Strike VAE adversarial finetune on the card.

    python -m autoregressive_diffusion_tpu_torch.cs_vae_adversarial
        [--vae saved_models_cs/vae_cs.ad] [--steps 10000] [--batch 1]
        [--clip-size 16] [--frame-size 256] [--lr 5e-5] [--adv-weight 0.1]
        [--shards DIR | --synthetic] [--small] [--ckpt-dir saved_models_cs]
        [--device cuda]

Counterpart of scripts/cs_vae_adversarial.py, flag for flag: the VAE
(resumed from a cs_vae_train bundle with --vae, else init_vae seed 0 at the
--small or full CS config) trains on gaussian_loss + 0.1 x perceptual_loss
+ --adv-weight x vae_adversarial_loss, the MixedDiscriminator (init seed 2)
judging in eval mode; then the discriminator takes one step in train mode
on the same frames and the step's decoded mean, detached: the noised
reconstruction from before the VAE's update (the gym script decodes again
after it). The VAE has a 0.5 global-norm clip, the discriminator 1.0, then
each AdamW at --lr (eps 1e-8, weight decay 1e-4). t and the latent noise
come from a torch generator seeded 3. The terms are printed every 20 steps;
the VAE goes to {ckpt-dir}/vae_cs_adversarial.ad every 1000 steps and,
unlike the JAX script, at the end of the run.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Callable, Optional

import torch

from .cs_vae_train import add_data_args, frame_batches, reconstruction_loss, save, vae_config
from .gym_vae_train import frozen
from .models.discriminator import (MixedDiscriminator, discriminator_loss, init_discriminator,
                                   vae_adversarial_loss)
from .models.vae import VAE, VAEConfig, init_vae
from .train.optim import ClippedAdamW
from .train.perceptual import perceptual_kind
from .utils.bridge import vae_from_bundle
from .utils.device import resolve_device

VAE_SEED, DISC_SEED, STEP_SEED = 0, 2, 3  # the JAX script's PRNGKeys


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_data_args(ap)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--clip-size", type=int, default=16)
    ap.add_argument("--vae", default=None, help="resume from a cs_vae_train bundle")
    ap.add_argument("--lr", type=float, default=5e-5)
    ap.add_argument("--adv-weight", type=float, default=0.1)
    return ap.parse_args(argv)


@dataclasses.dataclass
class AdversarialTrainer:
    args: argparse.Namespace
    device: torch.device
    cfg: VAEConfig
    vae: VAE
    disc: MixedDiscriminator
    tx_vae: ClippedAdamW
    tx_disc: ClippedAdamW
    opt_vae: torch.optim.Optimizer
    opt_disc: torch.optim.Optimizer
    generator: torch.Generator
    count: int = 0


def build_trainer(args: argparse.Namespace) -> AdversarialTrainer:
    dev = resolve_device(args.device)
    if args.vae:
        vae, _ = vae_from_bundle(args.vae, dev)
        vae.train()
    else:
        vae = init_vae(VAE(vae_config(args.small)), torch.Generator().manual_seed(VAE_SEED))
        vae = vae.to(dev)
    disc = init_discriminator(MixedDiscriminator(), torch.Generator().manual_seed(DISC_SEED))
    disc = disc.to(dev)
    tx_vae = ClippedAdamW(args.lr, grad_clip=0.5, eps=1e-8, weight_decay=1e-4)
    tx_disc = ClippedAdamW(args.lr, grad_clip=1.0, eps=1e-8, weight_decay=1e-4)
    return AdversarialTrainer(args, dev, vae.cfg, vae, disc, tx_vae, tx_disc,
                              tx_vae.init(vae.parameters()), tx_disc.init(disc.parameters()),
                              torch.Generator(device=dev).manual_seed(STEP_SEED))


def train_step(tr: AdversarialTrainer, frames: torch.Tensor, t=None, noise=None) -> dict:
    """One VAE update and one discriminator update on [-1, 1] frames on the
    card; t and noise as given, else drawn from the trainer's generator.
    Returns the loss terms on the card, unread."""
    if t is None:
        t, noise = tr.vae.draw_t_noise(frames, tr.generator)
    t, noise = t.to(frames), noise.to(frames)
    with frozen(tr.disc):  # no gradient to the discriminator in the VAE's backward
        loss, aux, r_mean = reconstruction_loss(tr.vae, frames, t, noise)
        adv = vae_adversarial_loss(tr.disc, frames, r_mean, train=False)
        loss = loss + tr.args.adv_weight * adv
        tr.opt_vae.zero_grad(set_to_none=True)
        loss.backward()
    tr.tx_vae.update(tr.opt_vae, tr.count)
    dl = discriminator_loss(tr.disc, frames, r_mean.detach(), train=True)
    tr.opt_disc.zero_grad(set_to_none=True)
    dl.backward()
    tr.tx_disc.update(tr.opt_disc, tr.count)
    tr.count += 1
    return dict(aux, adv=adv.detach(), disc=dl.detach(), loss=loss.detach())


def train_loop(tr: AdversarialTrainer, loader, on_step: Optional[Callable] = None) -> str:
    """The JAX script's cadence (printed when i % 20 == 0, saved when
    i % 1000 == 0, i > 0) and a save at the end; returns the bundle's path."""
    a = tr.args
    path = os.path.join(a.ckpt_dir, "vae_cs_adversarial.ad")
    t0 = time.time()
    for i, frames in enumerate(loader):
        if i >= a.steps:
            break
        aux = train_step(tr, torch.from_numpy(frames).to(tr.device))
        if on_step is not None:
            on_step(i, aux)
        if i % 20 == 0:
            print(f"step {i}: gaussian={float(aux['gaussian']):.4f} "
                  f"perc={float(aux['perceptual']):.3f} adv={float(aux['adv']):.3f} "
                  f"disc={float(aux['disc']):.3f} "
                  f"({a.batch * (i + 1) / (time.time() - t0):.2f} clips/s)", flush=True)
        if i % 1000 == 0 and i > 0:
            save(tr.vae, tr.cfg, path)
            print("# saved VAE checkpoint", flush=True)
    save(tr.vae, tr.cfg, path)
    print("# final VAE checkpoint saved", flush=True)
    return path


def main(argv=None) -> AdversarialTrainer:
    args = parse_args(argv)
    tr = build_trainer(args)
    print(f"# VAE: {sum(p.numel() for p in tr.vae.parameters()) / 1e6:.2f}M params "
          f"({'from ' + args.vae if args.vae else 'fresh'}); perceptual loss: "
          f"{perceptual_kind(3)}", flush=True)
    train_loop(tr, frame_batches(args))
    return tr


if __name__ == "__main__":
    main()
