"""Rank functions of tests/test_torch_sp.py, test_torch_cs_train.py and
test_torch_utils.py (no tests of its own).

They run in processes started by parallel.run_local_ranks (spawn), which
import this module by name: it imports torch and the port only, never JAX.
Each rank runs on the CPU under gloo and returns numpy arrays.
"""
import os

import numpy as np
import torch

from autoregressive_diffusion_tpu_torch.ops import flash_attention as fa
from autoregressive_diffusion_tpu_torch.ops.masks import shard_frame
from autoregressive_diffusion_tpu_torch.parallel import (check_replica_consistency, create_mesh,
                                                         seq_slice)
from autoregressive_diffusion_tpu_torch.train import build_trainer

# A tiny model with every layer kind (video attention at 8x8, frame
# attention at 16x16) and action labels, so that cvec differs per frame.
CONFIG = dict(img_resolution=16, img_channels=4, label_dim=4, model_channels=16,
              channel_mult=(1, 2), num_blocks=1, video_attn_resolutions=(8,),
              frame_attn_resolutions=(16,), max_frames=8, channels_per_head=16)


def clip_tokens(kind, n_frames, hw, sp, rank):
    """The clip's token indices of rank `rank`'s rows in the sequence-
    parallel layout (its local DART concat, or its run of frames)."""
    s = (2 if kind == "dart" else 1) * n_frames * hw // sp
    j = np.arange(rank * s, (rank + 1) * s)
    return shard_frame(j // hw, n_frames // sp, n_frames, kind) * hw + j % hw


def batch(b, t, seed):
    """Seeded latents (b, t, 16, 16, 4) and action labels (b, t) in [0, 4)."""
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.normal(size=(b, t, 16, 16, 4)).astype(np.float32))
    cond = torch.from_numpy(rng.integers(0, 4, size=(b, t)))
    return images, cond


def attention(cases):
    """For each (kind, n_frames, hw, q, k, v) with q, k, v (b, h, S, d) in
    the clip's token order: this rank's rows of o and of the gradients of
    sum(o^2) over all ranks in q, k, v, through dart_attention_sp /
    causal_frame_attention_sp on a seq group of all ranks."""
    torch.set_num_threads(1)
    mesh = create_mesh(1, int(os.environ["WORLD_SIZE"]), "gloo", "cpu")
    fn = {"dart": fa.dart_attention_sp, "causal": fa.causal_frame_attention_sp}
    out = []
    for kind, n_frames, hw, q, k, v in cases:
        idx = clip_tokens(kind, n_frames, hw, mesh.sp, mesh.seq_rank)
        leaves = [torch.from_numpy(a[:, :, idx]).requires_grad_(True) for a in (q, k, v)]
        o = fn[kind](*leaves, n_frames, hw, mesh.seq_group)
        (o ** 2).sum().backward()
        out.append([o.detach().numpy()] + [a.grad.numpy() for a in leaves])
    torch.distributed.destroy_process_group()
    return out


def train_steps(dp, sp, b, t, seed):
    """One DART step and one just_2d step of the data x seq parallel trainer
    (fp32, CONFIG, seeded weights and batch): the losses, the parameters
    after each step and the ranks' replica mismatches (parameters and EMA)."""
    torch.set_num_threads(1)
    mesh = create_mesh(dp, sp, "gloo", "cpu")
    state, step = build_trainer("cpu", torch.float32, seed=seed, batch=b, mesh=mesh, **CONFIG)
    images, cond = batch(b, t, seed + 1)
    images, cond = seq_slice(images, mesh), seq_slice(cond, mesh)
    losses, params = [], []
    for i, just_2d in enumerate((False, True)):
        state, m = step(state, images, cond, seed * 1000 + i, just_2d=just_2d)
        losses.append(float(m["loss"]))
        params.append({n: p.detach().numpy().copy() for n, p in state.model.named_parameters()})
    named = dict(state.model.named_parameters())
    named.update({f"ema{i}.{n}": v for i, e in enumerate(state.ema) for n, v in e.items()})
    bad = check_replica_consistency(named, mesh)
    sigma = m["sigma"].numpy()
    torch.distributed.destroy_process_group()
    return dict(losses=losses, params=params, mismatches=bad, sigma=sigma)


def cs_train_run(argv):
    """cs_train.main(argv) on this rank: (the losses, the parameters' float64
    sums by name)."""
    from autoregressive_diffusion_tpu_torch import cs_train
    torch.set_num_threads(1)  # two ranks beside the other test workers
    tr = cs_train.main(argv)
    return (list(tr.losses), {n: float(p.detach().double().sum())
                              for n, p in tr.state.model.named_parameters()})


def stats_rank(values):
    """utils/stats over a gloo group of all ranks: this rank reports its
    values[rank] under "x" and 10 x its rank under "r0" through report0; a
    Collector's update pools both. Returns (num, mean, std) of each name."""
    import torch.distributed as dist

    from autoregressive_diffusion_tpu_torch.utils import stats
    dist.init_process_group("gloo")
    rank = dist.get_rank()
    c = stats.Collector(regex="(x|r0)")
    stats.report("x", torch.tensor(values[rank]))
    stats.report0("r0", 10.0 * (rank + 1))
    c.update()
    out = {n: (c.num(n), c.mean(n), c.std(n)) for n in ("x", "r0")}
    dist.destroy_process_group()
    return out
