"""Rollout drift: how far a long autoregressive rollout strays, on the card.

    python -m autoregressive_diffusion_tpu_torch.rollout_drift \
        --unet saved_models/gym_r3/unet_46M_ema0.050_step40000_bfloat16.ad \
        --vae saved_models/vae_lunar_lander.ad \
        [--episodes-file run_artifacts/episodes/lunarlander_heuristic_seed0_256px.npz]
        [--frames 32] [--episodes 3] [--device cuda]

Counterpart of scripts/rollout_drift.py, flag for flag: the denoiser (bf16
body) generates --frames latent frames after --context ground-truth frames
of a recorded LunarLander episode, conditioned on the episode's own
actions, and the tool reports per generated frame the latent MSE against
the ground truth, the persistence baseline (the last context frame
repeated), the generated and true latent std, and the pixel MSE of the
decoded frames, averaged over --episodes episodes. It writes drift.npz
(latent_mse, persistence_mse, pixel_mse, gen_std, gt_std) under --out and
prints a per-episode line and a 0-based summary line, `latent MSE
frame0=... frame31=... (persistence ...); std drift ...x truth`, which
tools' drift_sweep parses. With matplotlib it draws drift_curves.png and
drift_strip.png as the JAX script does; without it (the card's machine) it
writes the strip (generated over true frames) as a PNG alone.

Episodes come from gymnasium (`collect_long_episode`, imported when
called) or, where gymnasium is absent as on the card's machine, from an
.npz that `save_episodes` wrote (--episodes-file; --save-episodes collects
and writes one). Without either the tool raises. The committed
run_artifacts/episodes/lunarlander_heuristic_seed0_256px.npz holds the
three heuristic episodes of the protocol (--seed 0, 144 frames at 256 px)
as gymnasium 1.2.2 gives them to both this collector and the JAX
script's: probe seeds 6, 15 and 33. The JAX run on the r3 weights
(logs/rollout_drift.log), made with another gymnasium, logged 6, 23 and
57; under 1.2.2 seeds 23 and 57 do not survive the probe.

Differences from the JAX script: the sampler's noise comes from one
torch.Generator seeded with --seed (the JAX script splits a PRNG key a
frame), so the two draw different noise and their series agree only in
distribution; --out defaults to run_artifacts/rollout_drift_torch, so that
a run does not overwrite the JAX run's committed drift.npz.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .data.gym_data import resize_frame
from .generate import write_png
from .models import init_cache
from .models.vae import frames_to_latents, latents_to_frames
from .sampling import edm_sampler
from .utils import plotting
from .utils.bridge import from_bundle, vae_from_bundle

EPISODES_FILE = "run_artifacts/episodes/lunarlander_heuristic_seed0_256px.npz"


def collect_long_episode(env_name, n_pixel_frames, tc, seed_start, frame_size=256, warmup=10,
                         max_probe=20000, policy="heuristic"):
    """(frames [n_pixel_frames, S, S, 3] uint8, actions [n_pixel_frames // tc]
    int64, next_seed) from ONE uninterrupted episode of at least warmup +
    2 * n_pixel_frames env steps, as the JAX script collects it: seeds from
    seed_start are probed without rendering until one survives, then it is
    replayed with rendering. policy 'heuristic' holds gymnasium's
    LunarLander controller's action for tc * 2 env steps; 'random' draws
    uniform actions at the same cadence."""
    import gymnasium as gym
    from gymnasium.envs.box2d.lunar_lander import heuristic

    frame_interval = 2
    hold = tc * frame_interval  # env steps a latent frame
    need_steps = n_pixel_frames * frame_interval

    probe_env = gym.make(env_name)
    actions = None
    seed = seed_start
    for seed in range(seed_start, seed_start + max_probe):
        s, _ = probe_env.reset(seed=seed)
        rng = np.random.default_rng(seed)
        acts, n, done, a = [], -(warmup - 1), False, 0
        while not done and n < need_steps:
            if n % hold == 0:
                a = (int(rng.integers(probe_env.action_space.n)) if policy == "random"
                     else int(heuristic(probe_env.unwrapped, s)))
                acts.append(a)
            s, _, term, trunc, _ = probe_env.step(a)
            done = term or trunc
            n += 1
        if n >= need_steps:
            actions = acts
            break
    probe_env.close()
    if actions is None:
        raise RuntimeError(f"no {policy} episode surviving {need_steps + warmup - 1} steps "
                           f"in {max_probe} probes")

    env = gym.make(env_name, render_mode="rgb_array")
    env.reset(seed=seed)
    frames, latent_actions = [], []
    action_iter = iter(actions)
    n, a = -(warmup - 1), 0
    while n < need_steps:
        if n % hold == 0:
            a = next(action_iter)
            if n >= 0:
                latent_actions.append(a)
        _, _, term, trunc, _ = env.step(a)
        if (term or trunc) and n < need_steps - 1:
            raise RuntimeError(f"episode ended at replay step {n} but its probe survived")
        if n >= 0 and n % frame_interval == 0:
            frames.append(resize_frame(env.render(), frame_size))
        n += 1
    env.close()
    if len(frames) != n_pixel_frames or len(latent_actions) != n_pixel_frames // tc:
        raise RuntimeError(f"collected {len(frames)} frames and {len(latent_actions)} "
                           f"actions, wanted {n_pixel_frames} and {n_pixel_frames // tc}")
    return np.stack(frames), np.asarray(latent_actions, np.int64), seed + 1


def save_episodes(path, episodes, **meta) -> None:
    """Write [(frames, actions, probe seed)] as one compressed .npz, with
    `meta` (env, policy, seed, tc) beside them."""
    arrays = {}
    for i, (frames, actions, seed) in enumerate(episodes):
        arrays[f"frames_{i}"] = np.asarray(frames, np.uint8)
        arrays[f"actions_{i}"] = np.asarray(actions, np.int64)
        arrays[f"seed_{i}"] = np.asarray(seed, np.int64)
    arrays.update({k: np.asarray(v) for k, v in meta.items()})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, n_episodes=np.asarray(len(episodes)), **arrays)


def load_episodes(path) -> tuple:
    """([(frames, actions, probe seed)], {meta}) from a save_episodes file."""
    with np.load(path) as z:
        n = int(z["n_episodes"])
        episodes = [(z[f"frames_{i}"], z[f"actions_{i}"], int(z[f"seed_{i}"]))
                    for i in range(n)]
        meta = {k: z[k].item() for k in z.files
                if k != "n_episodes" and not k.startswith(("frames_", "actions_", "seed_"))}
    return episodes, meta


@torch.no_grad()
def rollout_latents(model, z, acts, context: int, n_frames: int, generator=None,
                    x_inits=None, **sampler_kwargs) -> torch.Tensor:
    """Prefill z[:, :context] (b, t, h, w, c) at sigma 0.05 with their
    actions into a fresh cache, then sample n_frames frames, frame i
    conditioned on acts[:, context + i]; x_inits[i], if given, is frame i's
    initial noise. Returns the generated latents (b, n_frames, h, w, c)."""
    b, _, h, w, c = z.shape
    dev = z.device
    cache = init_cache(model, b, device=dev)
    sig = torch.full((b, context), 0.05, dtype=torch.float32, device=dev)
    _, cache = model(z[:, :context], sig, acts[:, :context], cache=cache, update_cache=True)
    frames = []
    for i in range(n_frames):
        cond = acts[:, context + i:context + i + 1]
        x, _, _, cache = edm_sampler(model, cache, (b, 1, h, w, c), cond, generator=generator,
                                     x_init=None if x_inits is None else x_inits[i],
                                     **sampler_kwargs)
        frames.append(x)
    return torch.cat(frames, dim=1)


def latent_series(gen: np.ndarray, gt: np.ndarray, last_ctx: np.ndarray) -> dict:
    """Per generated frame: latent MSE against the truth, the persistence
    baseline's MSE, the generated and true latent std."""
    axes = (0, 2, 3, 4)
    return dict(latent_mse=((gen - gt) ** 2).mean(axis=axes),
                persistence_mse=((last_ctx - gt) ** 2).mean(axis=axes),
                gen_std=gen.std(axis=axes), gt_std=gt.std(axis=axes))


def pixel_series(px_gen: np.ndarray, px_gt: np.ndarray, n_frames: int) -> np.ndarray:
    """Pixel MSE (normalized to [0, 1]) of decoded uint8 videos, averaged
    over the time_compression pixel frames of each latent frame."""
    per_frame = (((px_gen.astype(np.float32) - px_gt.astype(np.float32)) ** 2)
                 .mean(axis=(0, 2, 3, 4)) / 255.0 ** 2)
    return per_frame.reshape(n_frames, -1).mean(axis=1)


def summary_line(policy: str, mse, persist, std, gt_std) -> str:
    """The 0-based summary line that drift_sweep parses."""
    return (f"# [{policy}] latent MSE frame0={mse[0]:.4f} frame{len(mse) - 1}={mse[-1]:.4f} "
            f"(persistence {persist[-1]:.4f}); std drift "
            f"{std[-1] / max(gt_std[-1], 1e-8):.3f}x truth")


def episode_source(args, state_size: int, tc: int):
    """Yields (frames, actions, probe seed) for each of args.episodes episodes."""
    if args.episodes_file:
        episodes, meta = load_episodes(args.episodes_file)
        if meta.get("policy", args.policy) != args.policy:
            raise ValueError(f"{args.episodes_file} holds {meta['policy']} episodes, "
                             f"--policy is {args.policy}")
        if len(episodes) < args.episodes:
            raise ValueError(f"{args.episodes_file} holds {len(episodes)} episodes, "
                             f"--episodes is {args.episodes}")
        for frames, actions, seed in episodes[:args.episodes]:
            if len(frames) < state_size:
                raise ValueError(f"{args.episodes_file}: an episode of {len(frames)} frames, "
                                 f"{state_size} needed")
            yield frames[:state_size], actions[:state_size // tc], seed
        return
    try:
        import gymnasium  # noqa: F401
    except ImportError as e:
        raise RuntimeError("gymnasium is not installed: pass --episodes-file with "
                           "recorded episodes") from e
    collected, next_seed = [], args.seed
    for _ in range(args.episodes):
        frames, actions, next_seed = collect_long_episode(args.env, state_size, tc, next_seed,
                                                          policy=args.policy)
        collected.append((frames, actions, next_seed - 1))
        yield collected[-1]
    if args.save_episodes:
        save_episodes(args.save_episodes, collected, env=args.env, policy=args.policy,
                      seed=args.seed, tc=tc)


def write_plots(out, args, series, strips) -> list:
    """drift_curves.png and drift_strip.png with matplotlib, else the strip
    alone as a PNG; the paths written."""
    g, t = strips
    strip = np.concatenate([np.concatenate(list(g), axis=1),
                            np.concatenate(list(t), axis=1)], axis=0).astype(np.uint8)
    path_strip = os.path.join(out, "drift_strip.png")
    if not plotting.have_matplotlib():
        write_png(path_strip, strip)
        return [path_strip]
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    f = np.arange(1, args.frames + 1)
    axes[0].plot(f, series["latent_mse"], label="generated vs truth")
    axes[0].plot(f, series["persistence_mse"], "--", label="persistence baseline")
    axes[0].set(xlabel="generated frame", ylabel="latent MSE", title="Trajectory divergence")
    axes[0].legend()
    axes[1].plot(f, series["gen_std"], label="generated")
    axes[1].plot(f, series["gt_std"], "--", label="ground truth")
    axes[1].set(xlabel="generated frame", ylabel="latent std",
                title="Magnitude stability (flat = stable)")
    axes[1].legend()
    axes[2].plot(f, series["pixel_mse"])
    axes[2].set(xlabel="generated frame", ylabel="pixel MSE (norm.)",
                title="Decoded-pixel divergence")
    for ax in axes:
        ax.grid(alpha=0.3)
    fig.suptitle(f"AR rollout drift ({args.policy} actions): {args.frames} frames, "
                 f"{args.episodes} episodes, ctx {args.context}")
    fig.tight_layout()
    path_curves = os.path.join(out, "drift_curves.png")
    fig.savefig(path_curves, dpi=120)
    plt.close(fig)
    plt.figure(figsize=(16, 4))
    plt.imshow(strip)
    plt.axis("off")
    plt.title("top: generated (frames 1..N sampled), bottom: ground truth")
    plt.savefig(path_strip, dpi=120, bbox_inches="tight")
    plt.close()
    return [path_curves, path_strip]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--unet", required=True, help="UNet .ad bundle")
    ap.add_argument("--vae", required=True, help="VAE .ad bundle")
    ap.add_argument("--vae-std", type=float, default=1.45)
    ap.add_argument("--context", type=int, default=4, help="latent context frames")
    ap.add_argument("--frames", type=int, default=32, help="generated latent frames")
    ap.add_argument("--episodes", type=int, default=3)
    ap.add_argument("--num-steps", type=int, default=32, help="sampler steps (NFE / 2)")
    ap.add_argument("--env", default="LunarLander-v3")
    ap.add_argument("--out", default="run_artifacts/rollout_drift_torch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--policy", choices=("heuristic", "random"), default="heuristic",
                    help="ground-truth action source: 'heuristic' survives long horizons "
                         "but is out of the (random-action) training distribution; "
                         "'random' matches training but only short episodes survive")
    ap.add_argument("--guidance", type=float, default=1.0)
    ap.add_argument("--s-churn", type=float, default=20.0)
    ap.add_argument("--sigma-max", type=float, default=80.0)
    ap.add_argument("--sigma-min", type=float, default=0.002)
    ap.add_argument("--rho", type=float, default=7.0)
    ap.add_argument("--episodes-file", default=None, metavar="NPZ",
                    help=f"recorded episodes (save_episodes) in place of gymnasium, "
                         f"e.g. {EPISODES_FILE}")
    ap.add_argument("--save-episodes", default=None, metavar="NPZ",
                    help="write the episodes gymnasium collects to this .npz")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    model = from_bundle(args.unet, args.device, torch.bfloat16)
    dev = next(model.parameters()).device
    vae, _ = vae_from_bundle(args.vae, dev)
    tc = vae.cfg.time_compression
    state_size = (args.context + args.frames) * tc  # pixel frames needed
    os.makedirs(args.out, exist_ok=True)
    sampler_kwargs = dict(num_steps=args.num_steps, sigma_max=args.sigma_max,
                          sigma_min=args.sigma_min, rho=args.rho, S_churn=args.s_churn,
                          guidance=args.guidance)
    g = torch.Generator(device=dev).manual_seed(args.seed)

    per_episode, strips, seconds = [], None, []
    for ep, (frames, actions, probe_seed) in enumerate(episode_source(args, state_size, tc)):
        print(f"# episode {ep}: collected {len(frames)} frames (probe seed {probe_seed})",
              flush=True)
        t0 = time.perf_counter()
        with torch.no_grad():
            z = frames_to_latents(vae, torch.from_numpy(np.asarray(frames)).to(dev)[None],
                                  0.0, args.vae_std)
        acts = torch.from_numpy(np.asarray(actions, np.int64)).to(dev)[None]
        ctx, gt = z[:, :args.context], z[:, args.context:]
        gen = rollout_latents(model, z, acts, args.context, args.frames, g, **sampler_kwargs)
        with torch.no_grad():
            px_gen = latents_to_frames(vae, gen, 0.0, args.vae_std).cpu().numpy()
            px_gt = latents_to_frames(vae, gt, 0.0, args.vae_std).cpu().numpy()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds.append(time.perf_counter() - t0)
        series = latent_series(gen.float().cpu().numpy(), gt.float().cpu().numpy(),
                               ctx[:, -1:].float().cpu().numpy())
        series["pixel_mse"] = pixel_series(px_gen, px_gt, args.frames)
        per_episode.append(series)
        if strips is None:  # the first episode's strip
            sel = np.linspace(0, px_gen.shape[1] - 1, 8).astype(int)
            strips = (px_gen[0][sel], px_gt[0][sel])
        mse = series["latent_mse"]
        print(f"# episode {ep}: latent MSE frame0={mse[0]:.4f} "
              f"frame{args.frames - 1}={mse[-1]:.4f}", flush=True)

    keys = ("latent_mse", "persistence_mse", "pixel_mse", "gen_std", "gt_std")
    mean = {k: np.mean([s[k] for s in per_episode], axis=0) for k in keys}
    np.savez(os.path.join(args.out, "drift.npz"), **mean)
    written = write_plots(args.out, args, mean, strips)
    print(f"# wrote {', '.join(written)}, {os.path.join(args.out, 'drift.npz')}")
    line = summary_line(args.policy, mean["latent_mse"], mean["persistence_mse"],
                        mean["gen_std"], mean["gt_std"])
    print(line, flush=True)
    return dict(series=mean, per_episode=per_episode, episode_seconds=seconds,
                summary=line, device=str(dev))


if __name__ == "__main__":
    main()
