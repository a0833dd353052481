"""One fully sharded training step, a served rollout and an FSDP checkpoint
round trip on N local ranks.

    python -m autoregressive_diffusion_tpu_torch.parallel.dryrun --ranks N
        [--device cpu|cuda]

Counterpart of __graft_entry__.py::dryrun_multichip (:61-188): the grid is
tp = 2 when N is even, sp = 2 when N >= 8 and 2 tp divides it, the rest
data parallelism (8 ranks: dp 2 x sp 2 x tp 2), with FSDP on, on a tiny
model (8x8x4 latents, 16 channels) whose weights split at the JAX
dryrun's sizes (min_shard_size 32, fsdp_min_size 256). Three phases, each
of which raises on failure:

  1. one sharded DART step (batch N, T = 2 sp frames: a seq rank needs 2
     frames for the causal convs' halo, where the JAX dryrun's T is 2),
     loss finite, step 1; then the loss weight fitted on rank 0 and
     broadcast (train.fit_and_broadcast), equal on every rank, and the
     ranks that hold the same shard of a leaf hold the same numbers;
  2. a prefill of 2 context frames and a 2-frame rollout (4 sampler
     steps), the batch split over replica x data: each rank serves the
     weights gathered by gather_to_host, since a sharded model trains
     only (the JAX dryrun serves under the mesh here);
  3. save (gather_to_host, rank 0 writes) -> restore into a freshly built
     state on every rank -> shard it again: every rank's shards of the
     parameters, EMA copies and AdamW moments equal the saved state's bit
     for bit; then the next step on both states: equal losses.

The ranks are spawned by parallel.run_local_ranks (no torchrun); on the
card they share cuda:0 under gloo. Prints one line a phase and exits 0.
"""
from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

CFG = dict(img_resolution=8, img_channels=4, label_dim=4, model_channels=16,
           channel_mult=(1, 2), num_blocks=1, video_attn_resolutions=(4,),
           frame_attn_resolutions=(8,), channels_per_head=16, max_frames=8)
SHARD = dict(min_shard_size=32, fsdp=True, fsdp_min_size=256)


def grid(n: int):
    """(dp, sp, tp) of n ranks, as dryrun_multichip picks them."""
    tp = 2 if n % 2 == 0 else 1
    sp = 2 if n % (2 * tp) == 0 and n >= 8 else 1
    return n // (tp * sp), sp, tp


def _fresh(mesh, device, b):
    from ..models import Precond, UNetConfig, init_weights
    from ..train import EDM2LossConfig, create_train_state, make_optimizer, make_train_step
    model = init_weights(Precond(UNetConfig(**CFG), sigma_data=1.0), 0)
    model = model.to(device).train()
    tx = make_optimizer(learning_rate=1e-3)
    state = create_train_state(model, tx)
    return state, make_train_step(EDM2LossConfig(), tx, batch_size=b, mesh=mesh)


def _batch(seed, b, t, device):
    g = torch.Generator().manual_seed(seed)
    images = torch.randn((b, t, 8, 8, 4), generator=g)
    return images.to(device), torch.zeros((b, t), dtype=torch.long, device=device)


def rank_main(n: int, device: str, ckpt_dir: str) -> list:
    """The three phases on this rank; returns rank 0's lines."""
    from ..models import Precond, UNetConfig, init_cache
    from ..sampling import generate
    from ..train import MultiNoiseState, fit_and_broadcast
    from ..utils.bridge import load_jax_variables
    from ..utils.checkpoint import restore_train_state, save_train_state
    from . import (check_replica_consistency, create_mesh, gather_to_host, seq_slice,
                   shard_train_state, train_state_leaves)
    from .collectives import all_gather_flat

    torch.set_num_threads(1)
    dp, sp, tp = grid(n)
    mesh = create_mesh(dp, sp, "gloo", device, tp=tp)
    dev = mesh.device
    b, t = n, 2 * sp
    lines = []

    # phase 1: one sharded step, then the fitted loss weight on every rank
    state, step = _fresh(mesh, dev, b)
    _, specs = shard_train_state(state, mesh, **SHARD)
    n_model = sum("model" in s for s in specs.values())
    n_data = sum("data" in s for s in specs.values())
    if not (n_model and n_data and any("model" in s and "data" in s for s in specs.values())):
        raise RuntimeError(f"phase 1: no weight split over model and data ({specs})")
    images, cond = _batch(1, b, t, dev)
    state, m = step(state, seq_slice(images, mesh), seq_slice(cond, mesh), 2)
    loss = float(m["loss"])
    if not np.isfinite(loss) or state.step != 1:
        raise RuntimeError(f"phase 1: loss {loss}, step {state.step}")
    ns = MultiNoiseState()
    ns.add_data(m["sigma"].float().cpu().numpy(), m["losses"].float().cpu().numpy())
    state.coefs.copy_(torch.from_numpy(fit_and_broadcast(ns)))
    every = all_gather_flat(state.coefs.contiguous(), None)
    if not bool((every == every[0]).all()):
        raise RuntimeError("phase 1: the fitted coefs differ between ranks")
    named, leaf_specs = train_state_leaves(state)
    bad = check_replica_consistency(named, mesh, specs=leaf_specs)
    if bad:
        raise RuntimeError(f"phase 1: the ranks' shards disagree: {bad[:4]}")
    lines.append(f"dryrun({n}): mesh dp={dp} x sp={sp} x tp={tp} (fsdp: {n_model} weights over "
                 f"model, {n_data} over data) train loss={loss:.4f} coefs replicated over "
                 f"{every.shape[0]} ranks OK")

    # phase 2: prefill + 2-frame rollout on the gathered weights, the batch
    # split over replica x data
    host = gather_to_host(state)
    served = Precond(UNetConfig(**CFG), sigma_data=1.0)
    load_jax_variables(served, {"params": host["params"], "buffers": host["buffers"]})
    served = served.to(dev).eval()
    bl = b // mesh.batch_ranks
    g = torch.Generator(device=dev).manual_seed(3 + mesh.batch_rank)
    with torch.no_grad():
        cache = init_cache(served, bl, device=dev)
        ctx = torch.randn((bl, 2, 8, 8, 4), generator=g, device=dev)
        cnd = torch.zeros((bl, 2), dtype=torch.long, device=dev)
        _, cache = served(ctx, torch.full((bl, 2), 0.05, device=dev), cnd, cache=cache,
                          update_cache=True)
        frames, cache = generate(served, cache, 2, (bl, 1, 8, 8, 4), conditioning=cnd[:, :1],
                                 generator=g, num_steps=4)
    if tuple(frames.shape) != (bl, 2, 8, 8, 4) or not bool(torch.isfinite(frames).all()):
        raise RuntimeError(f"phase 2: frames {tuple(frames.shape)}, finite "
                           f"{bool(torch.isfinite(frames).all())}")
    if int(cache["frames"]) != 4:
        raise RuntimeError(f"phase 2: cache at {cache['frames']} frames, want 4")
    lines.append(f"dryrun({n}): prefill + 2-frame rollout on the gathered weights, "
                 f"{bl} samples a batch rank, OK (cache at {int(cache['frames'])} frames)")

    # phase 3: save -> restore -> re-shard -> the next step on both states
    if mesh.rank == 0:
        save_train_state(ckpt_dir, state.step, host)
    dist.barrier()
    restored, step2 = _fresh(mesh, dev, b)
    restore_train_state(ckpt_dir, state.step, restored)
    shard_train_state(restored, mesh, **SHARD)
    mine, _ = train_state_leaves(state)
    back, _ = train_state_leaves(restored)
    differ = sorted(k for k in mine if k not in back or not torch.equal(mine[k], back[k]))
    if differ or set(back) != set(mine):
        worst = max((float((mine[k].double() - back[k].double()).abs().max()) for k in differ
                     if k in back), default=float("nan"))
        raise RuntimeError(f"phase 3: rank {mesh.rank}: {len(differ)} restored shards differ, "
                           f"max |diff| {worst:.3e}: {differ[:4]}")
    images2, cond2 = _batch(5, b, t, dev)
    images2, cond2 = seq_slice(images2, mesh), seq_slice(cond2, mesh)
    _, m_orig = step(state, images2, cond2, 6)
    _, m_rest = step2(restored, images2, cond2, 6)
    l_orig, l_rest = float(m_orig["loss"]), float(m_rest["loss"])
    if l_orig != l_rest:
        raise RuntimeError(f"phase 3: the restored state diverged: {l_orig} vs {l_rest}")
    lines.append(f"dryrun({n}): FSDP save->restore->re-shard->step equality OK ({len(mine)} "
                 f"shards bit for bit, loss {l_rest:.6f})")
    dist.destroy_process_group()
    return lines if mesh.rank == 0 else []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from ..utils.device import resolve_device
    resolve_device(args.device)  # raises when the card is asked for and absent
    from .launch import run_local_ranks
    with tempfile.TemporaryDirectory() as ckpt_dir:
        results = run_local_ranks(rank_main, args.ranks, (args.ranks, args.device, ckpt_dir))
    for line in results[0]:
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
