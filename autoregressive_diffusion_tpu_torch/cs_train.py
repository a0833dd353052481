"""Counter-Strike latent diffusion training on the card.

    python -m autoregressive_diffusion_tpu_torch.cs_train [--steps 40000]
        [--mds DIR | --shards DIR | --synthetic] [--use-actions]
        [--lat-mean M --lat-std S] [--ckpt-dir saved_models_cs] [--resume]
        [--model-channels 128] [--device cuda] [--dtype bf16]
    torchrun --nproc-per-node N -m autoregressive_diffusion_tpu_torch.cs_train
        --sp SP [--backend nccl|gloo] ...   (data parallelism over N / SP)

Counterpart of scripts/cs_train.py, knob for knob: the CS UNet
(img_resolution 32, img_channels 8, label_dim 4, model_channels 128,
channel_mult 1/2/4/4, num_blocks 2, video attention at 4x4, frame attention
at 8x8, max_frames 128; about 310M parameters) in a bf16 body with
sigma_data 1, the EDM2 loss (P_mean 0.9, P_std 1, context noise reduction
0.1), AdamW (eps 1e-4) behind a 0.1 global-norm clip on the inverse-sqrt
schedule (ref_lr 1e-2, ramp-up and reference step steps/500, fp32), two
power-function EMA copies, batch 8 in microbatches of 2 of 16-frame
clips, a just_2d step when i % 4 == 0. The loss weight is refitted every
500 steps; the train state goes to step_{step:09d}/ every 2000 steps on a
background thread (three kept), at the end of the run and on SIGTERM;
metrics are read from the card every 20 steps, when the loss and the
sustained samples/s are printed.

Data: --mds reads a local MDS dataset (columns 'mean'/'action', data/mds.py)
epoch after epoch, --shards local .npz latent shards, both normalized as
(latents - --lat-mean) / --lat-std; otherwise (--synthetic) each step's
batch is made on the card: per clip an AR(1) process over frames (rho
0.95) of fields smoothed by a 5-tap plus stencil (unit variance), so the
context carries most of the next frame. Those latents come from a
torch.Generator seeded per step, so they follow the JAX script's law, not
its bits. --use-actions feeds the clips' actions to the label embedding
(the reference keeps label_dim 4 and passes none).

Parallelism: --sp splits each clip's frames over SP ranks and the world's
other factor is data parallelism, through parallel/ (as train/cli.py does);
every rank reads the same global batch and takes its slice, the metrics
are global, and rank 0 alone writes checkpoints. --mds and --shards are
read in order on every rank (no worker threads), so the ranks draw the
same windows from the same seed. --tp and --fsdp are not
ported (ROADMAP.md, Queue 1 item 4) and raise.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import signal
import time
from typing import Callable, Optional

import numpy as np
import torch

from .data import LocalLatentShards, batched_latents, streaming_dataset
from .gym_train import build_unet
from .models import UNetConfig
from .parallel import create_mesh, seq_slice
from .train import (ClippedAdamW, EDM2LossConfig, MultiNoiseState, create_train_state,
                    learning_rate_schedule, make_optimizer, make_train_step, step_seed)
from .train.cli import DTYPES
from .utils.checkpoint import (latest_step, restore_train_state, save_train_state,
                               wait_for_pending_saves)
from .utils.device import resolve_device

SEED = 7  # the steps' noise and the synthetic latents draw from it
CS_LOSS = EDM2LossConfig(P_mean=0.9, P_std=1.0, sigma_data=1.0, context_noise_reduction=0.1)
RHO = 0.95  # the synthetic latents' frame-to-frame correlation


def cs_config(model_channels: int = 128, max_frames: int = 128) -> UNetConfig:
    """The CS UNet (scripts/cs_train.py; max_frames 64 in the rollout)."""
    return UNetConfig(img_resolution=32, img_channels=8, label_dim=4,
                      model_channels=model_channels, channel_mult=(1, 2, 4, 4), num_blocks=2,
                      video_attn_resolutions=(4,), frame_attn_resolutions=(8,),
                      max_frames=max_frames)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=40_000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--micro-batch", type=int, default=2)
    ap.add_argument("--clip-size", type=int, default=16, help="latent frames a clip")
    ap.add_argument("--shards", default=None, help="local .npz latent shard directory")
    ap.add_argument("--mds", default=None, help="local MDS dataset directory")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor parallelism (not ported: ROADMAP.md, Queue 1 item 4)")
    ap.add_argument("--fsdp", action="store_true", help="fully sharded data parallelism "
                    "(not ported: ROADMAP.md, Queue 1 item 4)")
    ap.add_argument("--sp", type=int, default=1,
                    help="sequence parallelism: each clip's frames split over SP ranks")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl",
                    help="torch.distributed backend when the world has several ranks")
    ap.add_argument("--lat-mean", type=float, default=0.0)
    ap.add_argument("--lat-std", type=float, default=1.0)
    ap.add_argument("--ckpt-dir", default="saved_models_cs")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ref-lr", type=float, default=1e-2)
    ap.add_argument("--synthetic", action="store_true",
                    help="AR(1) latents made on the card (the default without --mds/--shards)")
    ap.add_argument("--model-channels", type=int, default=128)
    ap.add_argument("--use-actions", action="store_true",
                    help="condition the UNet on the clips' actions")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bf16", help="body dtype")
    args = ap.parse_args(argv)
    if args.tp != 1 or args.fsdp:
        ap.error("--tp and --fsdp are not ported (ROADMAP.md, Queue 1 item 4)")
    return args


@dataclasses.dataclass
class CSTrainer:
    """Everything the training loop needs, built by build_trainer."""
    args: argparse.Namespace
    device: torch.device
    mesh: object                        # parallel.Mesh or None
    cfg: UNetConfig
    n_params: int
    state: object                       # train.TrainState
    tx: ClippedAdamW                    # its learning rate is the run's schedule
    step_fn: Callable
    noise_state: MultiNoiseState = dataclasses.field(default_factory=MultiNoiseState)
    losses: list = dataclasses.field(default_factory=list)   # unweighted loss a step
    pending: list = dataclasses.field(default_factory=list)  # metrics not read yet
    start: int = 0
    last_ckpt_step: Optional[int] = None
    stop_requested: bool = False

    @property
    def lead(self) -> bool:
        return self.mesh is None or self.mesh.rank == 0

    def step(self, i: int, latents: torch.Tensor, actions: Optional[torch.Tensor]) -> dict:
        """Train step i on a global batch (just_2d when i % 4 == 0)."""
        if self.mesh is not None:
            latents = seq_slice(latents, self.mesh)
            actions = None if actions is None else seq_slice(actions, self.mesh)
        self.state, m = self.step_fn(self.state, latents, actions,
                                     step_seed(SEED, self.state.step), just_2d=i % 4 == 0)
        self.pending.append((m["unweighted"], m["sigma"], m["losses"]))
        return m

    def drain(self):
        """Read the pending metrics into the loss-weight history and the
        loss list: one read of the card for the steps since the last."""
        for unw, sig, lo in self.pending:
            self.noise_state.add_data(sig.float().cpu().numpy(), lo.float().cpu().numpy())
            self.losses.append(float(unw))
        self.pending.clear()

    def refit(self):
        """The loss weight fitted to the history, into the train state (every
        rank holds the same global history, so every rank fits the same)."""
        self.drain()
        self.state.coefs.copy_(torch.from_numpy(self.noise_state.fit()))

    def checkpoint(self, block: bool = True):
        self.drain()
        if self.lead:
            save_train_state(self.args.ckpt_dir, self.state.step, self.state,
                             {"losses": list(self.losses)}, keep=3, block=block)
        self.last_ckpt_step = self.state.step

    def resume(self) -> int:
        """Restore the newest checkpoint of --ckpt-dir, if any; the step to
        start from."""
        ls = latest_step(self.args.ckpt_dir)
        if ls is not None:
            self.state, extra = restore_train_state(self.args.ckpt_dir, ls, self.state)
            self.losses = np.asarray(extra.get("losses", [])).tolist()
            self.start = self.state.step
            if self.lead:
                print(f"# resumed at step {self.start}")
        return self.start


def build_trainer(args: argparse.Namespace) -> CSTrainer:
    """The mesh (under torchrun), the model, the train state and the step."""
    mesh, device = None, args.device
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 or args.sp > 1:
        if world % args.sp:
            raise ValueError(f"--sp {args.sp} does not divide the world of {world} ranks")
        mesh = create_mesh(world // args.sp, args.sp, args.backend, args.device)
        device = mesh.device
    dev = resolve_device(device)
    cfg = cs_config(args.model_channels)
    model = build_unet(cfg, dev, DTYPES[args.dtype])
    n_params = sum(p.numel() for p in model.parameters())
    tx = make_optimizer(learning_rate=lambda s: learning_rate_schedule(
        s, args.ref_lr, args.steps / 500, args.steps / 500), grad_clip=0.1, eps=1e-4)
    state = create_train_state(model, tx)
    dp = 1 if mesh is None else mesh.dp
    if args.micro_batch % dp:
        raise ValueError(f"--micro-batch {args.micro_batch} does not split over dp={dp}")
    step_fn = make_train_step(CS_LOSS, tx, args.batch, args.micro_batch // dp, mesh=mesh)
    if mesh is None or mesh.rank == 0:
        grid = "" if mesh is None else f", mesh dp={mesh.dp} x sp={mesh.sp} ({mesh.backend})"
        print(f"# UNet: {n_params / 1e6:.1f}M params on {dev}{grid}")
    return CSTrainer(args=args, device=dev, mesh=mesh, cfg=cfg, n_params=n_params,
                     state=state, tx=tx, step_fn=step_fn)


def synthetic_latents(b: int, t: int, res: int, ch: int, seed: int, device):
    """(latents (b, t, res, res, ch), actions (b, t)) of one synthetic
    batch: per clip an AR(1) process over frames (RHO) of iid normal fields
    smoothed by a 5-tap plus stencil (periodic, / sqrt(5)), marginal std 1;
    actions uniform in [0, 4)."""
    g = torch.Generator(device=device).manual_seed(seed)
    eps = torch.randn((t, b, res, res, ch), generator=g, device=device)
    eps = (eps + eps.roll(1, -3) + eps.roll(-1, -3) + eps.roll(1, -2)
           + eps.roll(-1, -2)) / math.sqrt(5.0)
    frames = [eps[0]]
    for e in eps[1:]:
        frames.append(RHO * frames[-1] + math.sqrt(1 - RHO ** 2) * e)
    act = torch.randint(0, 4, (b, t), generator=g, device=device)
    return torch.stack(frames, dim=1), act


def make_loader(tr: CSTrainer):
    """The run's batches: (latents on the card, actions or None), endless."""
    a, dev = tr.args, tr.device
    b, t = a.batch, a.clip_size

    def host_batches(loader):
        for batch in loader:
            lat = torch.from_numpy(batch["latents"]).to(dev)
            acts = batch.get("actions")
            yield lat, (torch.from_numpy(np.asarray(acts)).to(dev).long()
                        if a.use_actions and acts is not None else None)

    if a.mds is not None:
        def epochs():  # a pass over the dataset is finite: open it again
            while True:
                yield from streaming_dataset(None, a.mds, clip_size=t, shuffle=True)
        return host_batches(batched_latents(epochs(), b, normalize=(a.lat_mean, a.lat_std),
                                            num_workers=0))
    if a.shards is not None and not a.synthetic:
        # in order, as --mds: worker threads would stack each batch in the
        # order their items arrive, so ranks under a mesh would disagree
        ds = LocalLatentShards(a.shards, clip_size=t)
        return host_batches(batched_latents(ds, b, normalize=(a.lat_mean, a.lat_std),
                                            num_workers=0))

    def synthetic():
        i = tr.start
        while True:
            lat, act = synthetic_latents(b, t, tr.cfg.img_resolution, tr.cfg.img_channels,
                                         step_seed(SEED + 1, i), dev)
            yield lat, act if a.use_actions else None
            i += 1
    return synthetic()


def train_loop(tr: CSTrainer, loader, on_step: Optional[Callable] = None) -> int:
    """Steps from tr.start to --steps with the JAX script's cadence (by step
    index i: metrics read and logged at i % 20 == 0, refit at i % 500 == 0
    and background checkpoint at i % 2000 == 0 after the first step), a
    checkpoint on SIGTERM and at the end. on_step(i, metrics) after each
    step. Returns the step reached."""
    a = tr.args
    t0 = time.time()
    t_win, i_win = t0, tr.start
    for i, (latents, actions) in enumerate(loader, start=tr.start):
        if i >= a.steps:
            break
        m = tr.step(i, latents, actions)
        if on_step is not None:
            on_step(i, m)
        if i % 20 == 0:
            tr.drain()
            now = time.time()
            if tr.lead:
                print(f"step {i}: loss={np.mean(tr.losses[-20:]):.4f} "
                      f"{a.batch * (i + 1 - i_win) / (now - t_win):.2f} samples/s "
                      f"(avg {a.batch * (i + 1 - tr.start) / (now - t0):.2f})", flush=True)
            t_win, i_win = now, i + 1
        if i % 500 == 0 and i > tr.start:
            tr.refit()
        if i % 2000 == 0 and i > tr.start:
            tr.checkpoint(block=False)
            if tr.lead:
                print("# checkpoint save started (background)", flush=True)
        if tr.stop_requested:
            if tr.lead:
                print("# checkpoint on SIGTERM", flush=True)
            break
    tr.drain()
    if tr.last_ckpt_step != tr.state.step:
        tr.checkpoint(block=True)
    wait_for_pending_saves()
    if tr.lead:
        print(f"# done: {len(tr.losses)} steps recorded, final loss "
              f"{np.mean(tr.losses[-20:]) if tr.losses else float('nan'):.4f}; "
              f"checkpoint saved", flush=True)
    return tr.state.step


def main(argv=None) -> CSTrainer:
    args = parse_args(argv)
    tr = build_trainer(args)
    if args.resume:
        tr.resume()

    def on_sigterm(signum, frame):
        tr.stop_requested = True
        print("# SIGTERM: will checkpoint and exit", flush=True)

    previous = signal.signal(signal.SIGTERM, on_sigterm)
    try:
        train_loop(tr, make_loader(tr))
    finally:
        signal.signal(signal.SIGTERM, previous)
        if tr.mesh is not None:
            torch.distributed.destroy_process_group()
    return tr


if __name__ == "__main__":
    main()
