"""Per-channel VAE latent mean and std over dataset clips, saved into the
VAE bundle.

    python -m autoregressive_diffusion_tpu_torch.compute_latent_stats
        --vae-ckpt VAE.ad [--out OUT.ad] [--num-samples 64] [--state-size 32]
        [--frame-size 256] [--shard-dir DIR | --synthetic | --env LunarLander-v3]
        [--device cuda]

Counterpart of scripts/compute_latent_stats.py: encodes --num-samples clips
of --state-size frames (synthetic moving squares, raw-frame .npz shards
under key 'frames', or gymnasium episodes), sums the latent means' first
and second moments per channel in float64, and writes the bundle again
(--out, or over the input) with extra['latent_mean'] and
extra['latent_std'] (fp32), the normalization (latents - mean) / std that
the CS scripts take as --lat-mean/--lat-std.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .data import u8_to_pm1
from .utils.bridge import vae_from_bundle
from .utils.checkpoint import load_model, save_model
from .utils.device import resolve_device


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--vae-ckpt", required=True, help="VAE .ad bundle")
    ap.add_argument("--out", default=None, help="output bundle (default: overwrite the input)")
    ap.add_argument("--num-samples", type=int, default=64)
    ap.add_argument("--state-size", type=int, default=32)
    ap.add_argument("--env", default="LunarLander-v3")
    ap.add_argument("--frame-size", type=int, default=256)
    ap.add_argument("--shard-dir", default=None, help="local raw-frame .npz shards")
    ap.add_argument("--synthetic", action="store_true", help="synthetic frames, no gymnasium")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def clip_source(args):
    """The --num-samples clips of the chosen source, (t, h, w, 3) each."""
    if args.synthetic:
        from .data import SyntheticVideoGenerator
        gen = iter(SyntheticVideoGenerator(state_size=args.state_size,
                                           frame_size=args.frame_size))
        return (next(gen)[0] for _ in range(args.num_samples))
    if args.shard_dir:
        from .data import LocalLatentShards
        ds = iter(LocalLatentShards(args.shard_dir, clip_size=args.state_size, key="frames"))
        return (next(ds)["frames"] for _ in range(args.num_samples))
    from .data import GymDataGenerator
    gen = iter(GymDataGenerator(state_size=args.state_size, environment_name=args.env,
                                frame_size=args.frame_size))
    return (next(gen)[0] for _ in range(args.num_samples))


@torch.no_grad()
def latent_stats(vae, clips, device) -> tuple:
    """(mean, std) float64 per channel of the latent means of `clips`."""
    n, s1, s2 = 0, 0.0, 0.0
    for frames in clips:
        if frames.dtype == np.uint8:
            frames = u8_to_pm1(frames)
        lat, _ = vae.encode(torch.from_numpy(np.asarray(frames, np.float32))[None].to(device))
        flat = lat.reshape(-1, lat.shape[-1]).double().cpu().numpy()
        s1 = s1 + flat.sum(0)
        s2 = s2 + (flat ** 2).sum(0)
        n += flat.shape[0]
    mean = s1 / n
    return mean, np.sqrt(np.maximum(s2 / n - mean ** 2, 1e-12))


def main(argv=None) -> dict:
    """Returns the extra tree written into the bundle."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    vae, _ = vae_from_bundle(args.vae_ckpt, dev)
    kwargs, variables, extra = load_model(args.vae_ckpt, with_extra=True)
    mean, std = latent_stats(vae, clip_source(args), dev)
    print("latent mean:", np.round(mean, 4))
    print("latent std: ", np.round(std, 4))
    extra = dict(extra or {})
    extra["latent_mean"] = mean.astype(np.float32)
    extra["latent_std"] = std.astype(np.float32)
    out = args.out or args.vae_ckpt
    save_model(out, kwargs, variables, extra=extra)
    print(f"saved -> {out}")
    return extra


if __name__ == "__main__":
    main()
