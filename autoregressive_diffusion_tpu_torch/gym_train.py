"""LunarLander world-model training of the gym denoiser on the card.

    python -m autoregressive_diffusion_tpu_torch.gym_train [--steps 80000]
        [--vae saved_models/vae_lunar_lander.ad] [--synthetic]
        [--replay CAPACITY [--replay-device]] [--resume] [--ckpt-dir D]
        [--device cuda] [--config gym|tiny] [--dtype bf16|fp32]

Counterpart of scripts/gym_train.py, flag for flag: frozen VAE latents
(std 1.45), the 46M UNet (model_channels 32, channel_mult 1/2/4/8,
num_blocks 2, label_dim 4, video attention at 8x8, frame attention at
16x16, max_frames 64) in a bf16 body, EDM2 loss (P_mean 1.2, P_std 1,
context noise reduction 0.5), AdamW behind a 0.1 global-norm clip on the
inverse-sqrt schedule (ref_lr 1e-2, ramp-up and reference step steps/50),
batch 16 in microbatches of 8, a just_2d step every 4th step, two
power-function EMA copies. Every `--dashboard-every` steps the loss weight
is refitted into the train state's coefs, the sampler callback runs on the
training model and its rollout is decoded to a PNG strip, and where
matplotlib is installed the JAX script's dashboard is drawn beside it
(dashboard_step_{i}.png: loss against sigma with the fit, the loss
history, the sampler's MSE a step, the rollout); every `--ckpt-every`
steps (and at the end of the run) the raw weights go to `unet_{n}M.ad`
and the train state to `step_{step:09d}/` (three kept); `--resume`
continues from the newest; SIGTERM writes a checkpoint and exits.

Data: LunarLander clips from gymnasium (256 px), or with --synthetic the
moving-square clips (64 px, as in the JAX script), streamed in batches by
worker threads; --replay samples from a ring of encoded clips on the host,
--replay-device from rings on the card, gathering each batch there and
running a group of steps a call (one just_2d step, then three others).

Differences from the JAX script: --vae defaults to the committed trained
VAE (the port builds no random VAE); a run ends with a checkpoint;
--device, --config tiny (a few-layer model for the CPU) and --dtype are
the port's. The functions below let a caller (chip_smoke.py) build the
trainer at another frame size and drive the loop.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import signal
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from .data import (DeviceReplay, GymDataGenerator, ReplayLoader, SyntheticVideoGenerator,
                   batched)
from .generate import write_png
from .models import Precond, UNetConfig, init_weights
from .models.vae import frames_to_latents, latents_to_frames
from .sampling import make_sampler_callback
from .train import (ClippedAdamW, MultiNoiseState, create_train_state,
                    learning_rate_schedule, make_optimizer, make_replay_train_step,
                    make_train_step, step_seed)
from .train.cli import DTYPES, GYM_LOSS, TINY_CONFIG
from .utils import plotting
from .utils.bridge import jax_variables, vae_from_bundle
from .utils.checkpoint import (latest_step, restore_train_state, save_model, save_train_state,
                               wait_for_pending_saves)
from .utils.device import resolve_device

ROOT = Path(__file__).resolve().parents[1]
VAE_BUNDLE = ROOT / "saved_models" / "vae_lunar_lander.ad"
SEED = 1234  # the steps' noise and the dashboard's sampler draw from it
GYM_UNET = dict(label_dim=4, model_channels=32, channel_mult=(1, 2, 4, 8), num_blocks=2,
                video_attn_resolutions=(8,), frame_attn_resolutions=(16,), max_frames=64)
TINY_UNET = dict(GYM_UNET, **{k: v for k, v in TINY_CONFIG.items()
                              if k not in ("img_resolution", "img_channels")})


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=80_000)
    ap.add_argument("--micro-batch", type=int, default=8)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--state-size", type=int, default=32, help="frames a clip")
    ap.add_argument("--env", default="LunarLander-v3")
    ap.add_argument("--vae", default=str(VAE_BUNDLE), help="VAE .ad bundle")
    ap.add_argument("--vae-std", type=float, default=1.45, help="latent std")
    ap.add_argument("--ckpt-dir", default="saved_models")
    ap.add_argument("--out-dir", default="images_training")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--synthetic", action="store_true",
                    help="synthetic moving-square clips (64 px) instead of gymnasium")
    ap.add_argument("--ref-lr", type=float, default=1e-2)
    ap.add_argument("--dashboard-every", type=int, default=500)
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint interval in steps (0: steps/40)")
    ap.add_argument("--replay", type=int, default=0, metavar="CAPACITY",
                    help="sample batches from a ring of this many encoded clips (0: stream)")
    ap.add_argument("--replay-device", action="store_true",
                    help="with --replay: the rings live on the card and batches are "
                         "gathered there, several steps a call")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", choices=("gym", "tiny"), default="gym",
                    help="gym: the 46M model; tiny: a few layers, for the CPU")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bf16", help="body dtype")
    return ap.parse_args(argv)


@dataclasses.dataclass
class GymTrainer:
    """Everything the training loop needs, built by build_trainer."""
    args: argparse.Namespace
    device: torch.device
    vae: torch.nn.Module
    unet_cfg: UNetConfig
    n_params: int
    state: object                       # train.TrainState
    tx: ClippedAdamW                    # its learning rate is the run's schedule
    step_fn: Callable
    replay_fn: Callable
    callback: Callable
    frame_size: int
    noise_state: MultiNoiseState = dataclasses.field(default_factory=MultiNoiseState)
    losses: list = dataclasses.field(default_factory=list)  # unweighted loss a step
    lrs: dict = dataclasses.field(default_factory=dict)     # step -> learning rate
    pending: list = dataclasses.field(default_factory=list)  # metrics not read yet
    start: int = 0
    last_ckpt_step: Optional[int] = None
    stop_requested: bool = False

    @property
    def time_compression(self) -> int:
        return self.vae.cfg.time_compression

    @torch.no_grad()
    def encode(self, frames) -> torch.Tensor:
        """(b, t, h, w, 3) uint8 frames (numpy or tensor) -> unit-std latents
        on the card, a microbatch of clips a VAE call (the activations of a
        whole batch of 256-px clips would take several GB). The frames cross
        as uint8."""
        x = torch.as_tensor(frames).to(self.device)
        n = self.args.micro_batch
        return torch.cat([frames_to_latents(self.vae, x[i:i + n], 0.0, self.args.vae_std)
                          for i in range(0, x.shape[0], n)])

    @torch.no_grad()
    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Unit-std latents -> uint8 frames."""
        return latents_to_frames(self.vae, latents.float(), 0.0, self.args.vae_std)

    def step(self, i: int, latents, actions) -> dict:
        """Train step i on one batch (just_2d when i % 4 == 0)."""
        self.lrs[i] = self.tx.lr_at(i)
        latents = torch.as_tensor(latents).to(self.device)
        actions = torch.as_tensor(actions).to(self.device).long()
        self.state, m = self.step_fn(self.state, latents, actions,
                                     step_seed(SEED, self.state.step),
                                     just_2d=i % 4 == 0)
        self.pending.append((m["unweighted"], m["sigma"], m["losses"]))
        return m

    def replay_steps(self, i: int, replay: DeviceReplay, g: int, just_2d: bool) -> dict:
        """g train steps from i on batches gathered from the rings on the card."""
        for j in range(g):
            self.lrs[i + j] = self.tx.lr_at(i + j)
        buf_z, buf_a = replay.buffers()
        self.state, m = self.replay_fn(self.state, buf_z, buf_a, replay.sample_idx(g), SEED,
                                       just_2d=just_2d)
        self.pending.append((m["unweighted"], m["sigma"], m["losses"]))
        return m

    def flush(self):
        """Read the pending metrics into the loss-weight history and the loss
        list (one read of the card for all the steps since the last)."""
        for unw, sig, lo in self.pending:
            self.noise_state.add_data(sig.float().cpu().numpy(), lo.float().cpu().numpy())
            self.losses.extend(np.atleast_1d(unw.float().cpu().numpy()).tolist())
        self.pending.clear()

    def log_window(self, i: int, t_start: float, replay=None):
        a = self.args
        sps = a.batch * (i + 1 - self.start) / (time.time() - t_start)
        extra = ""
        if replay is not None:
            rs = replay.stats()
            extra = (f" replay[{rs['buffered']} buf, {rs['produced']} fresh, "
                     f"x{rs['reuse_factor']:.1f} reuse]")
        accumulation = a.batch // a.micro_batch
        print(f"step {i}: loss={np.mean(self.losses[-accumulation:]):.4f} "
              f"lr={self.tx.lr_at(i):.6f} {sps:.1f} samples/s{extra}", flush=True)

    def dashboard(self, i: int, latents: torch.Tensor) -> dict:
        """Refit the loss weight into state.coefs, run the sampler callback on
        latents[:1] and write its decoded rollout as a PNG strip."""
        t0 = time.perf_counter()
        self.state.coefs.copy_(torch.from_numpy(self.noise_state.fit()))
        g = torch.Generator(device=self.device).manual_seed(step_seed(SEED + 1, i))
        mse_steps, _, roll = self.callback(latents, g)
        frames = self.decode(roll)[0].cpu().numpy()
        path = Path(self.args.out_dir) / f"rollout_step_{i}.png"
        write_png(path, np.concatenate(list(frames), axis=1))
        dash = None
        if plotting.have_matplotlib():
            dash = str(Path(self.args.out_dir) / f"dashboard_step_{i}.png")
            plotting.plot_training_dashboard(
                dash, self.losses, i, self.noise_state, self.state.coefs.cpu().numpy(),
                mse_steps=mse_steps, rollout_frames=frames, unet_params=self.n_params)
        return dict(seconds=time.perf_counter() - t0, mse_steps=mse_steps, png=str(path),
                    dashboard=dash)

    def checkpoint(self, i: int, block: bool = False) -> Path:
        """The raw weights as unet_{n}M.ad and the train state (three kept);
        the train state's directory."""
        d = Path(self.args.ckpt_dir)
        bundle = d / f"unet_{self.n_params // 10 ** 6}M.ad"
        save_model(bundle, dict(self.unet_cfg.__dict__), jax_variables(self.state.model))
        path = save_train_state(d, self.state.step, self.state, {"losses": self.losses},
                                keep=3, block=block)
        self.last_ckpt_step = self.state.step
        print(f"# checkpoint at step {i}", flush=True)
        return path

    def resume(self) -> int:
        """Restore the newest checkpoint of --ckpt-dir, if any; the step to
        start from."""
        ls = latest_step(self.args.ckpt_dir)
        if ls is not None:
            self.state, extra = restore_train_state(self.args.ckpt_dir, ls, self.state)
            self.losses = np.asarray(extra.get("losses", [])).tolist()
            self.start = self.state.step
            print(f"# resumed at optimizer step {self.start}")
        return self.start


def build_unet(unet_cfg: UNetConfig, device, body_dtype, seed: int = 42) -> Precond:
    """The denoiser with the JAX init's distributions (gains 0), in train mode."""
    model = Precond(unet_cfg, sigma_data=1.0, body_dtype=body_dtype)
    init_weights(model, seed, gains=0.0)
    return model.to(device).train()


def build_trainer(args: argparse.Namespace, frame_size: Optional[int] = None) -> GymTrainer:
    """The VAE, the model, the train state and the step functions of a run.
    frame_size defaults to the JAX script's rule: 256, or 64 with
    --synthetic."""
    dev = resolve_device(args.device)
    vae, _ = vae_from_bundle(args.vae, dev)
    vcfg = vae.cfg
    frame_size = frame_size or (64 if args.synthetic else 256)
    overrides = TINY_UNET if args.config == "tiny" else GYM_UNET
    unet_cfg = UNetConfig(img_resolution=frame_size // vcfg.spatial_compression,
                          img_channels=vcfg.channels[-1], **overrides)
    model = build_unet(unet_cfg, dev, DTYPES[args.dtype])
    n_params = sum(p.numel() for p in model.parameters())
    t_lat = args.state_size // vcfg.time_compression
    print(f"# UNet: {n_params / 1e6:.1f}M params, latents {unet_cfg.img_resolution}x"
          f"{unet_cfg.img_resolution}x{unet_cfg.img_channels}, T={t_lat}")
    tx = make_optimizer(learning_rate=lambda s: learning_rate_schedule(
        s, args.ref_lr, args.steps / 50, args.steps / 50), grad_clip=0.1)
    state = create_train_state(model, tx)
    return GymTrainer(
        args=args, device=dev, vae=vae, unet_cfg=unet_cfg, n_params=n_params, state=state,
        tx=tx, step_fn=make_train_step(GYM_LOSS, tx, args.batch, args.micro_batch),
        replay_fn=make_replay_train_step(GYM_LOSS, tx, args.batch, args.micro_batch),
        callback=make_sampler_callback(model), frame_size=frame_size)


def make_generator(tr: GymTrainer):
    """The clip source of the run: synthetic clips or LunarLander episodes."""
    a = tr.args
    if a.synthetic:
        return SyntheticVideoGenerator(a.state_size, tr.frame_size, 4, tr.time_compression,
                                       a.steps * 2)
    return GymDataGenerator(a.state_size, a.env, a.steps * 2, tr.time_compression,
                            return_anyways=False, frame_size=tr.frame_size)


def stream(tr: GymTrainer, gen, num_workers: Optional[int] = None):
    """(latents on the card, actions) batches, encoded as they come."""
    a = tr.args
    workers = a.micro_batch if num_workers is None else num_workers
    for frames, actions, _ in batched(gen, a.batch, num_workers=workers):
        yield tr.encode(frames), actions


def host_replay(tr: GymTrainer, gen) -> ReplayLoader:
    """Batches sampled from a host ring of encoded clips."""
    def to_latent(item):
        frames, actions, _ = item
        return tr.encode(frames[None])[0].float().cpu().numpy(), np.asarray(actions)
    return ReplayLoader(gen, tr.args.batch, capacity=tr.args.replay, transform=to_latent, seed=5)


def device_replay(tr: GymTrainer, gen) -> DeviceReplay:
    """Rings of encoded clips on the card; each clip crosses once, as uint8."""
    def to_latent(item):
        frames, actions, _ = item
        return tr.encode(frames[None])[0], np.asarray(actions, np.int32)
    return DeviceReplay(gen, to_latent, tr.args.batch, capacity=tr.args.replay, seed=5,
                        device=tr.device)


def train_loop(tr: GymTrainer, loader, on_step: Optional[Callable] = None) -> int:
    """Steps from tr.start to --steps on the batches of `loader`, with the
    log, dashboard and checkpoint cadence of the JAX script (by step index
    i: every 50th logs, every --dashboard-every-th and --ckpt-every-th after
    the first), and a checkpoint at the end. on_step(i, metrics) is called
    after each step. Returns the step reached."""
    a = tr.args
    ckpt_every = a.ckpt_every or max(a.steps // 40, 1)
    t_start = time.time()
    i = tr.start
    for i, (latents, actions) in enumerate(loader, start=tr.start):
        if i >= a.steps:
            break
        m = tr.step(i, latents, actions)
        if on_step is not None:
            on_step(i, m)
        if i % 50 == 0:
            tr.flush()
            tr.log_window(i, t_start)
        if i % a.dashboard_every == 0 and i > tr.start:
            tr.flush()
            tr.dashboard(i, torch.as_tensor(latents).to(tr.device))
        if i % ckpt_every == 0 and i > tr.start:
            tr.flush()
            tr.checkpoint(i)
        if tr.stop_requested:
            break
    return _finish(tr)


def replay_loop(tr: GymTrainer, replay: DeviceReplay, on_step: Optional[Callable] = None) -> int:
    """train_loop over rings on the card: one just_2d step at i % 4 == 0,
    then the rest of the group of 4 in one call. on_step(i, g, metrics)."""
    a = tr.args
    ckpt_every = a.ckpt_every or max(a.steps // 40, 1)
    i = tr.start
    t_start = t_fill = time.time()
    while i < a.steps:
        if tr.stop_requested and i == tr.start:
            break  # terminated during the first fill
        replay.ingest()
        if not replay.ready():
            if replay.exhausted():
                print("# generator exhausted before one batch filled")
                break
            if time.time() - t_fill > 30:
                t_fill = time.time()
                print(f"# filling replay buffer: {replay.stats()['buffered']}/"
                      f"{replay.min_fill}", flush=True)
            time.sleep(0.2)
            continue
        g, j2 = (1, True) if i % 4 == 0 else (4 - i % 4, False)
        g = min(g, a.steps - i)
        m = tr.replay_steps(i, replay, g, j2)
        if on_step is not None:
            on_step(i, g, m)
        i_new = i + g
        if i // 50 != i_new // 50:
            tr.flush()
            tr.log_window(i_new - 1, t_start, replay)
        if i // a.dashboard_every != i_new // a.dashboard_every:
            tr.flush()
            lat = replay.buffers()[0].index_select(
                0, torch.as_tensor(replay.sample_idx(1)[0], device=tr.device).long())
            tr.dashboard(i_new, lat)
        if i // ckpt_every != i_new // ckpt_every:
            tr.flush()
            tr.checkpoint(i_new)
        i = i_new
        if tr.stop_requested:
            break
    replay.stop()
    return _finish(tr)


def _finish(tr: GymTrainer) -> int:
    """The last checkpoint, written before returning (also after SIGTERM)."""
    tr.flush()
    if tr.state.step > tr.start and tr.last_ckpt_step != tr.state.step:
        tr.checkpoint(tr.state.step, block=True)
    wait_for_pending_saves()
    return tr.state.step


def main(argv=None) -> GymTrainer:
    args = parse_args(argv)
    tr = build_trainer(args)
    if args.resume:
        tr.resume()

    def on_sigterm(signum, frame):
        tr.stop_requested = True
        print("# SIGTERM: will checkpoint and exit", flush=True)

    previous = signal.signal(signal.SIGTERM, on_sigterm)
    try:
        os.makedirs(args.out_dir, exist_ok=True)
        gen = make_generator(tr)
        if args.replay > 0 and args.replay_device:
            replay_loop(tr, device_replay(tr, gen))
        elif args.replay > 0:
            loader = host_replay(tr, gen)
            try:
                train_loop(tr, iter(loader))
            finally:
                loader.stop()
        else:
            train_loop(tr, stream(tr, gen))
    finally:
        signal.signal(signal.SIGTERM, previous)
    return tr


if __name__ == "__main__":
    main()
