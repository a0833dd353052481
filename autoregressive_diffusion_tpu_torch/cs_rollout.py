"""Roll out a trained CS model against held-out clips.

    python -m autoregressive_diffusion_tpu_torch.cs_rollout --ckpt-dir D --mds DIR
        [--vae saved_models/vae_lunar_lander.ad] [--context 4] [--frames 12]
        [--clips 2] [--num-steps 32] [--ema 0] [--lat-mean M --lat-std S]
        [--use-actions] [--out run_artifacts/cs_rollout] [--device cuda]

Counterpart of scripts/cs_rollout.py: restores the newest train state that
cs_train wrote under --ckpt-dir (the CS UNet with max_frames 64), takes EMA
slot --ema (0: std 0.050) or with -1 the raw weights, and for each of
--clips windows of the MDS dataset prefills --context latent frames at
sigma 0.05 into a fresh cache, then samples --frames frames one at a time
(edm_sampler: --num-steps steps, sigma in [0.4, 80], rho 2, no churn),
conditioned on the clip's actions with --use-actions. It prints each
clip's latent MSE against the true continuation and against persistence
(the last context frame), writes the means to cs_rollout.npz and, with
--vae, the first clip's generated (top) and true (bottom) frames decoded to
pixels as one PNG strip (generate.write_png; the JAX script's matplotlib
panel is not drawn).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .cs_train import cs_config
from .data import streaming_dataset
from .generate import write_png
from .models import Precond, init_cache
from .models.vae import latents_to_frames
from .sampling import edm_sampler
from .train import create_train_state, make_optimizer
from .train.cli import DTYPES
from .utils.bridge import vae_from_bundle
from .utils.checkpoint import latest_step, restore_train_state
from .utils.device import resolve_device


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--mds", required=True)
    ap.add_argument("--vae", default=None)
    ap.add_argument("--model-channels", type=int, default=128)
    ap.add_argument("--context", type=int, default=4)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--clips", type=int, default=2)
    ap.add_argument("--num-steps", type=int, default=32)
    ap.add_argument("--ema", type=int, default=0, help="EMA slot (0: std 0.050); -1: raw")
    ap.add_argument("--lat-mean", type=float, default=0.0)
    ap.add_argument("--lat-std", type=float, default=1.0)
    ap.add_argument("--use-actions", action="store_true")
    ap.add_argument("--out", default="run_artifacts/cs_rollout")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bf16", help="body dtype")
    return ap.parse_args(argv)


def restore_model(ckpt_dir, model_channels: int, device, body_dtype, ema: int = -1):
    """(the CS denoiser in eval mode, with a 64-frame ring as the JAX script
    serves it, and the weights of the newest train state under ckpt_dir --
    EMA slot `ema`, or the raw ones with -1 --, the step). The train state
    is rebuilt as cs_train builds it (AdamW, two EMA copies) and dropped
    once its weights are in the model."""
    step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    model = Precond(cs_config(model_channels, max_frames=64), sigma_data=1.0,
                    body_dtype=body_dtype).to(device)
    state = create_train_state(model, make_optimizer(1e-3, grad_clip=0.1, eps=1e-4))
    state, _ = restore_train_state(ckpt_dir, step, state)
    if ema >= 0 and state.ema:
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(state.ema[ema][name])
    return model.eval(), step


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    model, step = restore_model(args.ckpt_dir, args.model_channels, dev, DTYPES[args.dtype],
                                args.ema)
    print(f"# restored step {step}, weights: "
          f"{'raw' if args.ema < 0 else f'EMA slot {args.ema}'}")
    return run(model, args)


def run(model, args: argparse.Namespace) -> dict:
    """The rollouts of `model` (in eval mode) on the clips of args.mds.
    Returns {"mse", "persistence" (per generated frame, means over the
    clips), "clips", "strip" (the PNG's path or None)}."""
    dev = next(model.parameters()).device
    os.makedirs(args.out, exist_ok=True)
    cfg = model.cfg
    shape = (1, 1, cfg.img_resolution, cfg.img_resolution, cfg.img_channels)

    need = args.context + args.frames
    clips = []
    for item in streaming_dataset(None, args.mds, clip_size=need, shuffle=False):
        clips.append(item)
        if len(clips) >= args.clips:
            break
    if not clips:
        raise ValueError(f"{args.mds} has no window of {need} frames")

    g = torch.Generator(device=dev).manual_seed(0)
    all_mse, all_persist, strip = [], [], None
    with torch.no_grad():
        for ci, item in enumerate(clips):
            lat = (np.asarray(item["latents"], np.float32) - args.lat_mean) / args.lat_std
            z = torch.from_numpy(lat)[None].to(dev)
            acts = np.asarray(item["actions"]) if item.get("actions") is not None \
                else np.zeros(need)
            acts = torch.from_numpy(acts[None].astype(np.int64)).to(dev)
            ctx, gt = z[:, :args.context], z[:, args.context:]
            cache = init_cache(model, 1, device=dev)
            sig = torch.full((1, args.context), 0.05, device=dev)
            _, cache = model(ctx, sig, acts[:, :args.context] if args.use_actions else None,
                             cache=cache, update_cache=True)
            gen = []
            for i in range(args.frames):
                cond = (acts[:, args.context + i:args.context + i + 1]
                        if args.use_actions else None)
                x, _, _, cache = edm_sampler(model, cache, shape, cond, generator=g,
                                             num_steps=args.num_steps, sigma_min=0.4,
                                             sigma_max=80.0, rho=2.0, S_churn=0.0)
                gen.append(x)
            gen = torch.cat(gen, dim=1)
            gn, tn = gen.cpu().numpy(), gt.cpu().numpy()
            mse = ((gn - tn) ** 2).mean(axis=(0, 2, 3, 4))
            persist = ((ctx[:, -1:].cpu().numpy() - tn) ** 2).mean(axis=(0, 2, 3, 4))
            all_mse.append(mse)
            all_persist.append(persist)
            print(f"# clip {ci}: mse frame1={mse[0]:.4f} frame{args.frames}={mse[-1]:.4f} "
                  f"(persistence {persist[-1]:.4f}) gen std={gn.std():.3f} "
                  f"gt std={tn.std():.3f}", flush=True)
            if ci == 0 and args.vae:
                vae, _ = vae_from_bundle(args.vae, dev)
                px_g = latents_to_frames(vae, gen, 0.0, args.lat_std)[0].cpu().numpy()
                px_t = latents_to_frames(vae, gt, 0.0, args.lat_std)[0].cpu().numpy()
                sel = np.linspace(0, px_g.shape[0] - 1, 8).astype(int)
                strip = np.concatenate([np.concatenate(list(px_g[sel]), axis=1),
                                        np.concatenate(list(px_t[sel]), axis=1)], axis=0)

    mse, persist = np.mean(all_mse, axis=0), np.mean(all_persist, axis=0)
    np.savez(os.path.join(args.out, "cs_rollout.npz"), mse=mse, persistence=persist)
    strip_path = None
    if strip is not None:
        strip_path = os.path.join(args.out, "cs_rollout_strip.png")
        write_png(strip_path, strip)
    print(f"# mean: frame1={mse[0]:.4f} frame{args.frames}={mse[-1]:.4f} "
          f"persistence@{args.frames}={persist[-1]:.4f} -> "
          f"{'BEATS' if mse[-1] < persist[-1] else 'worse than'} persistence", flush=True)
    return dict(mse=mse, persistence=persist, clips=len(clips), strip=strip_path)


if __name__ == "__main__":
    main()
