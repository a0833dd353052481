"""Rank functions of tests/test_torch_tp_fsdp.py (no tests of its own).

They run in processes started by parallel.run_local_ranks (spawn), which
import this module by name: it imports torch and the port only, never JAX.
Each rank runs on the CPU under gloo, with one torch thread, and returns
numpy arrays.
"""
import numpy as np
import torch

from autoregressive_diffusion_tpu_torch.models import Precond, UNetConfig
from autoregressive_diffusion_tpu_torch.models.attention import VideoAttention
from autoregressive_diffusion_tpu_torch.ops import flash_attention as fa
from autoregressive_diffusion_tpu_torch.parallel import (check_replica_consistency, create_mesh,
                                                         gather_model, gather_model_partial,
                                                         gather_to_host,
                                                         seq_slice, shard_train_state,
                                                         train_state_leaves)
from autoregressive_diffusion_tpu_torch.parallel.mesh import is_sharded
from autoregressive_diffusion_tpu_torch.train import (EDM2LossConfig, create_train_state,
                                                      make_optimizer, make_train_step)
from autoregressive_diffusion_tpu_torch.utils.bridge import (load_jax_train_state,
                                                             load_train_state_tree)

# the test CFG of tests/test_sharding.py with action labels (so that a
# conv's cvec differs per frame); T = 4 frames, 2 a seq rank under sp = 2
CFG = dict(img_resolution=8, img_channels=4, label_dim=4, model_channels=16,
           channel_mult=(1, 2), num_blocks=1, video_attn_resolutions=(4,),
           frame_attn_resolutions=(8,), channels_per_head=16, max_frames=8)
B, T, MICRO = 4, 4, 2
LR, EPS = 1e-3, 1e-4  # the CS run's AdamW eps
LOSS = dict(P_mean=0.9, P_std=1.0, sigma_data=1.0, context_noise_reduction=0.1)
# tests/test_sharding.py's sizes, so that the tiny model's weights split
SHARD = dict(min_shard_size=32, fsdp_min_size=256)


def make_state(start, mesh=None, microbatch=MICRO):
    """(state, step) of the tiny model from `start` = (params, buffers,
    coefs) numpy trees under the JAX package's names."""
    params, buffers, coefs = start
    model = Precond(UNetConfig(**CFG), sigma_data=1.0).train()
    tx = make_optimizer(LR, eps=EPS)
    state = create_train_state(model, tx)
    load_jax_train_state(state, params, buffers, coefs=coefs)
    return state, make_train_step(EDM2LossConfig(**LOSS), tx, B, microbatch, mesh=mesh)


def local_draw(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows and DART frames of a (B, 2T, ...) sigma or noise."""
    b, t2 = x.shape[:2]
    t, sp = t2 // 2, mesh.sp
    tl = t // sp
    keep = torch.arange(mesh.seq_rank * tl, (mesh.seq_rank + 1) * tl)
    bl = b // mesh.batch_ranks
    rows = x[mesh.batch_rank * bl:(mesh.batch_rank + 1) * bl]
    return rows[:, torch.cat([keep, keep + t])].contiguous()


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def record_sp_heads() -> list:
    """Wrap the SP attention entry points (row 8) so that every call
    appends (entry point, q heads, k heads); returns the list they fill."""
    seen = []
    for name in ("flash_attention_sp_fwd", "flash_attention_sp_bwd"):
        def recorded(qs, k, *args, _fn=getattr(fa, name), _name=name):
            seen.append((_name, qs.shape[1], k.shape[1]))
            return _fn(qs, k, *args)
        setattr(fa, name, recorded)
    return seen


def partial_gather_check(mesh) -> dict:
    """gather_model_partial against its definition on the model group:
    every model rank weighs only its own strided column ranges of the
    gathered tensor (as head-sharded attention keeps its heads' q, k, v of
    the (s m c) qkv), so the gradient at rank r's chunk is the sum over the
    ranks of their weights there. Also the plain gather_model's backward,
    which takes this rank's slice of its own gradient only."""
    tp, r, c = mesh.tp, mesh.model_rank, 4
    g = torch.Generator().manual_seed(7)
    chunks = torch.randn((tp, 3, 5, c), generator=g)  # every rank's chunk
    weights = torch.randn((tp, 3, 5, tp * c), generator=g)
    used = (torch.arange(tp * c) // 2) % tp  # the rank that uses each column
    weights = weights * (used[None, None, None, :] == torch.arange(tp)[:, None, None, None])
    want = weights.sum(0)[..., r * c:(r + 1) * c]
    out = {}
    for name, fn in (("partial", gather_model_partial), ("plain", gather_model)):
        y = chunks[r].clone().requires_grad_(True)
        full = fn(y, mesh.model_group)
        (full * weights[r]).sum().backward()
        out[name] = dict(forward=bool(torch.equal(full.detach(),
                                                  chunks.movedim(0, -2).reshape(3, 5, tp * c))),
                         grad_err=float((y.grad - want).abs().max()))
    return out


def sharded_steps(grids, start, draws):
    """For each (name, grid) of `grids` in turn (dp, sp, tp, slices, fsdp;
    the process group stays, each grid makes its own groups): two steps of
    the tiny model on this rank from `start`, with the injected draws
    [(images, cond, sigma, noise)] of the global batch. Returns {name: the
    losses, and on rank 0 the gathered parameters after each step}. Then:
    the ranks' replica check on the sharded state; gather_to_host loaded
    into a fresh state and sharded again, against this rank's leaves bit for
    bit; the replica check after rank 1 perturbs one shard; the heads of
    every SP attention call of the steps (record_sp_heads) and, with tp > 1,
    partial_gather_check on the grid's model group."""
    torch.set_num_threads(1)
    out = {}
    sp_calls = record_sp_heads()
    for name, grid in grids:
        mesh = create_mesh(grid["dp"], grid["sp"], "gloo", "cpu", tp=grid["tp"],
                           num_slices=grid["slices"])
        state, step = make_state(start, mesh, MICRO // mesh.batch_ranks)
        _, specs = shard_train_state(state, mesh, fsdp=grid["fsdp"], **SHARD)
        losses, params = [], []
        sp_calls.clear()
        for images, cond, sigma, noise in draws:
            state, m = step(state, seq_slice(images, mesh), seq_slice(cond, mesh), 0,
                            sigma=local_draw(sigma, mesh), noise=local_draw(noise, mesh))
            losses.append(float(m["loss"]))
            host = gather_to_host(state)
            params.append(flat(host["params"]) if mesh.rank == 0 else None)
        named, leaf_specs = train_state_leaves(state)
        before = check_replica_consistency(named, mesh, specs=leaf_specs)

        fresh, _ = make_state(start, mesh)
        load_train_state_tree(fresh, host)
        shard_train_state(fresh, mesh, fsdp=grid["fsdp"], **SHARD)
        again, _ = train_state_leaves(fresh)
        roundtrip = (set(again) == set(named) and fresh.step == state.step
                     and all(torch.equal(again[k], named[k]) for k in named))

        victim = next(n for n, s in specs.items()
                      if is_sharded(s) and not ("model" in s and "data" in s))
        if mesh.rank == 1:
            with torch.no_grad():
                state.params[victim].view(-1)[0] += 1.0
        after = check_replica_consistency(named, mesh, specs=leaf_specs)
        out[name] = dict(losses=losses, params=params, before=before, after=after,
                         victim=victim, roundtrip=roundtrip,
                         n_sharded={k: sum(1 for s in specs.values() if k in (s or ()))
                                    for k in ("model", "data")},
                         local_numel=sum(p.numel() for p in state.model.parameters()),
                         sp_calls=sorted(set(sp_calls)), n_sp_calls=len(sp_calls),
                         video_heads=sorted({m.num_heads for m in state.model.modules()
                                             if isinstance(m, VideoAttention)}),
                         partial_gather=partial_gather_check(mesh) if mesh.tp > 1 else None)
    torch.distributed.destroy_process_group()
    return out


def cs_train_ranks(argv):
    """cs_train's loop on this rank (parse_args, build_trainer, train_loop:
    its final save gathers the state on every rank), then gather_to_host
    once more; rank 0 returns the gathered tree and the losses."""
    from autoregressive_diffusion_tpu_torch import cs_train
    torch.set_num_threads(1)
    args = cs_train.parse_args(argv)
    tr = cs_train.build_trainer(args)
    cs_train.train_loop(tr, cs_train.make_loader(tr))
    tree = gather_to_host(tr.state)
    specs = tr.state.specs
    rank = tr.mesh.rank
    torch.distributed.destroy_process_group()
    return (dict(losses=list(tr.losses), tree=tree,
                 n_sharded={k: sum(1 for s in specs.values() if k in (s or ()))
                            for k in ("model", "data")})
            if rank == 0 else None)

