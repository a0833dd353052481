"""Scrambled-context probe: does a trained CS world model use its context?

    python -m autoregressive_diffusion_tpu_torch.context_probe --ckpt-dir D
        --mds DIR [--use-actions] [--batches 4] [--batch 8] [--clip-size 16]
        [--lat-mean M --lat-std S] [--model-channels 128] [--device cuda]

Counterpart of tools/context_probe.py: the train-mode EDM2 loss (the CS
loss settings, unweighted) of the newest train state's raw weights on
batches of real clip windows, and on the same batches with the frames of
each index permuted over the batch (each frame's marginal kept, the
temporal order destroyed; an action travels with its frame), both under
the same sigma and noise draws. A model that ignores its context scores
the same on both; one that uses it scores worse on the scrambled batches.
--device cpu takes the place of the JAX tool's --cpu.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .cs_rollout import restore_model
from .cs_train import CS_LOSS
from .data import streaming_dataset
from .train import edm2_loss
from .train.cli import DTYPES
from .utils.device import resolve_device


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--mds", required=True)
    ap.add_argument("--model-channels", type=int, default=128)
    ap.add_argument("--clip-size", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--lat-mean", type=float, default=0.0)
    ap.add_argument("--lat-std", type=float, default=1.0)
    ap.add_argument("--use-actions", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bf16", help="body dtype")
    return ap.parse_args(argv)


def scramble(lat: np.ndarray, act: np.ndarray, rng) -> tuple:
    """(lat, act) with frame index i of the batch permuted by its own draw
    of rng, for every i."""
    slat, sact = lat.copy(), act.copy()
    for i in range(lat.shape[1]):
        perm = rng.permutation(lat.shape[0])
        slat[:, i], sact[:, i] = lat[perm, i], act[perm, i]
    return slat, sact


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    model, step = restore_model(args.ckpt_dir, args.model_channels, dev, DTYPES[args.dtype])
    print(f"# restored step {step} from {args.ckpt_dir}")
    return run(model, args)


def run(model, args: argparse.Namespace) -> dict:
    """The probe of `model` on the windows of args.mds. Returns {"real",
    "scrambled" (a loss a batch), "ratio"}."""
    dev = next(model.parameters()).device
    b, t = args.batch, args.clip_size
    wins = []
    for item in streaming_dataset(None, args.mds, clip_size=t, shuffle=True):
        wins.append(item)
        if len(wins) >= b * args.batches:
            break
    if len(wins) < b:
        raise ValueError(f"{args.mds} has {len(wins)} windows of {t} frames, fewer than a "
                         f"batch of {b}")

    def loss_of(lat, act, seed):
        cond = torch.from_numpy(act.astype(np.int64)).to(dev) if args.use_actions else None
        _, aux = edm2_loss(model, torch.from_numpy(lat).to(dev), seed, CS_LOSS, cond)
        return float(aux["unweighted"])

    rng = np.random.default_rng(0)
    real, scrambled = [], []
    with torch.no_grad():
        for bi in range(len(wins) // b):
            chunk = wins[bi * b:(bi + 1) * b]
            lat = np.stack([(np.asarray(w["latents"], np.float32) - args.lat_mean)
                            / args.lat_std for w in chunk])
            act = np.stack([np.asarray(w["actions"] if w.get("actions") is not None
                                       else np.zeros(t)) for w in chunk])
            slat, sact = scramble(lat, act, rng)
            real.append(loss_of(lat, act, bi))  # the same seed: paired sigma and noise
            scrambled.append(loss_of(slat, sact, bi))
            print(f"# batch {bi}: real={real[-1]:.4f} scrambled={scrambled[-1]:.4f}",
                  flush=True)
    mr, ms = float(np.mean(real)), float(np.mean(scrambled))
    print(f"# probe: real={mr:.4f} scrambled={ms:.4f} ratio={ms / mr:.3f}x "
          f"({'USES context' if ms > 1.05 * mr else 'context-FREE'})")
    return dict(real=real, scrambled=scrambled, ratio=ms / mr)


if __name__ == "__main__":
    main()
