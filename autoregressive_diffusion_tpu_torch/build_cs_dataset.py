"""Build a CS latent dataset: gameplay clips -> VAE latent shards.

    python -m autoregressive_diffusion_tpu_torch.build_cs_dataset --out DIR
        (--src CLIPS | --synthetic N) [--vae-ckpt saved_models/vae_lunar_lander.ad]
        [--raw] [--frame-size 256] [--split-size 512] [--mds] [--seed 0]
        [--clip-frames 64] [--n-actions 4] [--device cuda]

Counterpart of scripts/build_cs_dataset.py, flag for flag: each clip is
resized and mapped to [-1, 1] by the native resize (data/native.py), encoded
by the VAE's chunked streaming encoder (models/vae.py::encode_long_sequence)
on --device to fp16 latent means, and written as one .npz shard
(data/cs_data.py::write_latent_shard), or as MDS samples {'mean',
'action'} with --mds (zstd-compressed, as in the JAX script: that needs the
`zstandard` package). The latent stream is compressed in time, so each
latent frame keeps the action at the start of its group. --raw writes the
resized uint8 frames instead, with no VAE.

Sources: a directory of .h5 files with datasets 'frame_i' (needs h5py) or
of .npz files with 'frames' (+ 'actions'); or --synthetic N structured
camera-pan clips (`structured_clip`, the same numpy draws as the JAX
script, so the same seed gives the same bytes).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .data import MDSShardWriter, resize_frames_batch, write_latent_shard
from .models.vae import encode_long_sequence
from .utils.bridge import vae_from_bundle
from .utils.device import resolve_device


def structured_clip(rng, t, size=128, n_actions=4, tc=4):
    """(frames (t, size, size, 3) uint8, actions (t,) int64): an
    action-controlled camera pan over a fixed toroidal world (a blocky
    texture, a terrain band, bright landmarks), two drifting sprites and a
    player marker at the centre. The action (redrawn every tc frames) is
    the camera's velocity, so every pixel's next value depends on the past
    frames and the action: a world model has to use its context."""
    world = rng.normal(0, 1, (size // 8, size // 8, 3))
    world = np.kron(world, np.ones((8, 8, 1)))
    world = ((world - world.min()) / (np.ptp(world) + 1e-6) * 90).astype(np.uint8)
    band = size // 2 + int(rng.integers(0, size // 4))
    world[band:band + size // 6] = (120, 110, 80)  # terrain band
    for _ in range(6):  # landmarks the pan sweeps across
        ly, lx = rng.integers(0, size, 2)
        world[ly:ly + 6, lx:lx + 6] = rng.integers(120, 255, 3)
    frames = np.empty((t, size, size, 3), np.uint8)
    actions = np.empty((t,), np.int64)
    vel = [(0, 0), (4, 0), (0, 4), (-4, -4)][:n_actions]
    ox = oy = 0
    spr = [(rng.integers(0, size), rng.integers(0, size),
            int(rng.integers(1, 3)), int(rng.integers(1, 3))) for _ in range(2)]
    a = int(rng.integers(0, n_actions))
    for i in range(t):
        if i % tc == 0:
            a = int(rng.integers(0, n_actions))
        actions[i] = a
        dx, dy = vel[a % len(vel)]
        ox = (ox + dx) % size
        oy = (oy + dy) % size
        f = np.roll(np.roll(world, -oy, 0), -ox, 1).copy()
        for k, (sx, sy, sv, sw) in enumerate(spr):
            px = int((sx + sv * i - ox) % size)
            py = int((sy + sw * i - oy) % size)
            f[max(0, py - 3):py + 3, max(0, px - 3):px + 3] = (
                (200, 60, 60) if k == 0 else (60, 60, 220))
        c = size // 2  # player marker
        f[c - 4:c + 4, c - 4:c + 4] = (235, 235, 235)
        frames[i] = f
    return frames, actions


def _read_h5(path):
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"{path}: .h5 clips need the `h5py` package, which is not "
                          f"installed; convert them to .npz ('frames', 'actions')") from e
    with h5py.File(path, "r") as f:
        n = len([k for k in f.keys() if k.startswith("frame_")])
        frames = np.stack([np.asarray(f[f"frame_{i}_x"] if f"frame_{i}_x" in f
                                      else f[f"frame_{i}"]) for i in range(n)])
        actions = np.asarray(f["actions"]) if "actions" in f else np.zeros(n, np.int64)
    return frames, actions


def iter_clips(args):
    """(name, frames (t, h, w, 3) uint8, actions (t,)) of every source clip."""
    if args.synthetic:
        rng = np.random.default_rng(args.seed)
        for i in range(args.synthetic):
            frames, actions = structured_clip(rng, args.clip_frames, n_actions=args.n_actions)
            yield f"synthetic_{i}", frames, actions
        return
    for name in sorted(os.listdir(args.src)):
        path = os.path.join(args.src, name)
        if name.endswith((".h5", ".hdf5")):
            yield (name, *_read_h5(path))
        elif name.endswith(".npz"):
            with np.load(path) as z:
                yield name, z["frames"], (z["actions"] if "actions" in z
                                          else np.zeros(len(z["frames"]), np.int64))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=None, help="directory of .h5/.npz clips")
    ap.add_argument("--out", required=True, help="output shard directory")
    ap.add_argument("--vae-ckpt", default=None, help="VAE .ad bundle; omit with --raw")
    ap.add_argument("--raw", action="store_true", help="write resized frames, no VAE encode")
    ap.add_argument("--frame-size", type=int, default=256)
    ap.add_argument("--split-size", type=int, default=512,
                    help="frames a streaming-encode chunk")
    ap.add_argument("--mds", action="store_true", help="write MDS shards instead of .npz")
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0,
                    help="synthetic-clip seed (another seed gives a held-out split)")
    ap.add_argument("--clip-frames", type=int, default=64)
    ap.add_argument("--n-actions", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not (args.src or args.synthetic):
        ap.error("need --src or --synthetic")
    if not (args.raw or args.vae_ckpt):
        ap.error("--vae-ckpt is required unless --raw")
    return args


def main(argv=None) -> list:
    """Builds the dataset; returns [(name, shape, dtype)] of what it wrote."""
    args = parse_args(argv)
    encode = None
    if not args.raw:
        dev = resolve_device(args.device)
        vae, _ = vae_from_bundle(args.vae_ckpt, dev)

        def encode(frames_pm1):
            x = torch.from_numpy(frames_pm1)[None].to(dev)
            lat = encode_long_sequence(vae, x, split_size=args.split_size)
            return lat[0].cpu().numpy().astype(np.float16)

    os.makedirs(args.out, exist_ok=True)
    writer = None
    if args.mds:  # the MDS column schema of the CS dataset
        writer = MDSShardWriter(args.out, {("frames" if args.raw else "mean"): "ndarray",
                                           "action": "ndarray"}, compression="zstd")
    written = []
    for name, frames, actions in iter_clips(args):
        frames_pm1 = resize_frames_batch(frames, args.frame_size)
        if args.raw:
            data, key = (frames_pm1 * 127.5 + 127.5).astype(np.uint8), "frames"
        else:
            data, key = encode(frames_pm1), "latents"
            # one action a latent frame: the one at the start of its group
            tc = max(1, len(actions) // max(1, len(data)))
            actions = np.asarray(actions)[::tc][:len(data)]
        if writer is not None:
            writer.write({("frames" if args.raw else "mean"): data,
                          "action": np.asarray(actions, np.int64)})
        else:
            write_latent_shard(os.path.join(args.out, os.path.splitext(name)[0] + ".npz"),
                               data, actions, key=key)
        written.append((name, data.shape, data.dtype))
        print(f"{name}: {key} {data.shape} {data.dtype}", flush=True)
    if writer is not None:
        writer.finish()
    print(f"done -> {args.out}")
    return written


if __name__ == "__main__":
    main()
