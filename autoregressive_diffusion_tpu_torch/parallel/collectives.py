"""The collectives of sequence-parallel training, under autograd.

The JAX package leaves these to XLA: inside its shard_map the K/V
all-gather of the sequence-parallel attention (ops/flash_attention.py:
315-318), whose autodiff is a reduce-scatter of dK and dV, and, around it,
whatever resharding the causal convs need across the frame axis. Here they
are explicit torch.distributed calls on a `seq` process group:

  * gather_kv: K and V of every seq rank, rank-major along the token axis;
    the backward reduce-scatters (sums) dK and dV back to their owners;
  * exchange_halo: the 2-frame halo of the causal convs. Seq rank r holds
    clean frames [r t_l, (r + 1) t_l) of the clip, and its first frames'
    context reads the 2 clean frames before them, which rank r - 1 holds.
    The forward hands each rank the last 2 clean frames (and their cvec
    rows) of the rank before it and returns the extended DART concat; the
    backward returns their gradient to that rank.

Transport: on a gloo group, CUDA tensors cross the host (`_host_staged`):
they are copied to host memory, the collective runs there, and the result
is copied back; a reduction then sums in fp32. That is how several ranks
share one card (NCCL refuses two ranks on one device); the kernels still
run on the card, and a failed collective raises. On an NCCL group the
tensors stay on the card.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

HALO = 2  # past frames the 3x3x3 causal conv reads (kt - 1)


def _host_staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_gather_flat(t: torch.Tensor, group) -> torch.Tensor:
    """The flattened `t` of every rank of `group`, stacked: (size, t.numel())."""
    n = dist.get_world_size(group)
    src = t.detach().reshape(-1)
    staged = _host_staged(src, group)
    if staged:
        src = src.cpu()
    out = src.new_empty((n * src.numel(),))
    dist.all_gather_into_tensor(out, src, group=group)
    if staged:
        out = out.to(t.device)
    return out.view(n, -1)


def reduce_scatter_flat(t: torch.Tensor, group) -> torch.Tensor:
    """Chunk `rank` of the sum over the ranks of `group` of the flat `t`
    (its numel a multiple of the group size), in t's type."""
    src = t.detach().reshape(-1)
    staged = _host_staged(src, group)
    if staged:
        src = src.to("cpu", torch.float32)
    out = src.new_empty((src.numel() // dist.get_world_size(group),))
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.to(t.device, t.dtype) if staged else out


def all_reduce_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum `t` over the ranks of `group` (default: all ranks), in place."""
    if _host_staged(t, group):
        host = t.detach().to("cpu", torch.float32)
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


class _GatherKV(torch.autograd.Function):
    """(k, v) (b, h, S, d) of this rank -> (k, v) (b, h, sp*S, d) of all
    ranks, rank-major; backward: the summed dK, dV of this rank's rows."""

    @staticmethod
    def forward(ctx, k, v, group):
        ctx.group = group
        sp = dist.get_world_size(group)
        b, h, s, d = k.shape
        g = all_gather_flat(torch.stack([k, v]), group).view(sp, 2, b, h, s, d)
        g = g.permute(1, 2, 3, 0, 4, 5).reshape(2, b, h, sp * s, d)
        return g[0].contiguous(), g[1].contiguous()

    @staticmethod
    def backward(ctx, dk, dv):
        sp = dist.get_world_size(ctx.group)
        b, h, ssp, d = dk.shape
        grads = torch.stack([dk, dv]).view(2, b, h, sp, ssp // sp, d)
        grads = grads.permute(3, 0, 1, 2, 4, 5).contiguous()
        mine = reduce_scatter_flat(grads, ctx.group).view(2, b, h, ssp // sp, d)
        return mine[0], mine[1], None


def gather_kv(k: torch.Tensor, v: torch.Tensor, group):
    """K and V of every rank of the seq group, rank-major on the token axis:
    (b, h, S, d) each -> (b, h, sp*S, d) each. Differentiable: the backward
    reduce-scatters dK and dV."""
    return _GatherKV.apply(k, v, group)


class _ExchangeHalo(torch.autograd.Function):
    """The halo exchange of exchange_halo (all tensors (B, 2 t_l, ...) DART
    concats of one type)."""

    @staticmethod
    def forward(ctx, group, *xs):
        rank, sp = dist.get_rank(group), dist.get_world_size(group)
        t_l = xs[0].shape[1] // 2
        ctx.group, ctx.t_l = group, t_l
        tails = [x[:, t_l - HALO:t_l] for x in xs]
        got = all_gather_flat(torch.cat([t.reshape(-1) for t in tails]), group)
        if rank == 0:  # ones frames precede the clip: no halo
            return tuple(x.view_as(x) for x in xs)
        halos = torch.split(got[rank - 1], [t.numel() for t in tails])
        out = []
        for x, tail, halo in zip(xs, tails, halos):
            dummy = torch.zeros_like(tail)  # noisy-half padding; its outputs are dropped
            out.append(torch.cat([halo.view_as(tail), x[:, :t_l], dummy, x[:, t_l:]], dim=1))
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        group, t_l = ctx.group, ctx.t_l
        rank, sp = dist.get_rank(group), dist.get_world_size(group)
        if rank == 0:
            local = list(gs)
            halo = [torch.zeros_like(g[:, :HALO]) for g in gs]
        else:
            local = [torch.cat([g[:, HALO:HALO + t_l], g[:, 2 * HALO + t_l:]], dim=1) for g in gs]
            halo = [g[:, :HALO] for g in gs]
        got = all_gather_flat(torch.cat([h.reshape(-1) for h in halo]), group)
        if rank + 1 < sp:  # the next rank's halo is this rank's last clean frames
            back = torch.split(got[rank + 1], [h.numel() for h in halo])
            local = [g.clone() for g in local]
            for g, b, h in zip(local, back, halo):
                g[:, t_l - HALO:t_l] += b.view_as(h)
        return (None, *local)


def exchange_halo(x: torch.Tensor, cvec, group):
    """The causal convs' halo under sequence parallelism. x (B, 2 t_l, H, W,
    C) is this seq rank's local DART concat of conv inputs, cvec (B, 2 t_l,
    C) their per-frame scales or None. On rank r > 0 returns (x_ext,
    cvec_ext) of 2 (t_l + 2) frames: [the last 2 clean frames of rank r - 1,
    the clean frames, 2 zero frames, the noisy frames]; the caller runs the
    conv on it and drops the first 2 outputs of each half. Rank 0 gets its
    own tensors back (the conv's ones frames stand before the clip). Every
    rank of the group must call it; the backward adds rank r + 1's halo
    gradient to this rank's last 2 clean frames."""
    t_l = x.shape[1] // 2
    if t_l < HALO:
        raise ValueError(f"the conv halo needs at least {HALO} frames a rank, got {t_l}")
    if cvec is None:
        return _ExchangeHalo.apply(group, x)[0], None
    return _ExchangeHalo.apply(group, x, cvec)
