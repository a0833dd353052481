"""A data x seq grid of torch.distributed ranks.

Counterpart of autoregressive_diffusion_tpu/parallel/mesh.py (create_mesh
:31-82, seq_sharding, check_replica_consistency :180-210) for training
with data parallelism and sequence parallelism. Where the JAX package
shards arrays over a ('replica', 'data', 'seq', 'model') device mesh and
lets XLA insert the collectives, each process here is one rank holding its
own slice of the batch (over `data`) and of the clip's frames (over `seq`),
and the model's collectives run on the process groups of this grid
(parallel/collectives.py). Rank = data_rank * sp + seq_rank, so the seq
ranks of one data replica are neighbours. Tensor parallelism (`model`),
FSDP and the multi-slice `replica` axis are not ported.

Processes are started by torchrun (or any launcher that sets RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT). Rank i runs on
cuda:{LOCAL_RANK % device_count}, so several ranks can share one card
under the gloo backend.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .collectives import all_gather_flat, all_reduce_sum_


@dataclasses.dataclass(frozen=True)
class Mesh:
    dp: int                 # data-parallel replicas
    sp: int                 # seq ranks a clip's frames are split over
    rank: int               # = data_rank * sp + seq_rank
    data_rank: int
    seq_rank: int
    data_group: object      # the ranks of this seq position, one per replica
    seq_group: object       # the sp ranks of this data replica
    device: torch.device
    backend: str

    @property
    def world(self) -> int:
        return self.dp * self.sp


def create_mesh(dp: int = 1, sp: int = 1, backend: str = "nccl", device: str = "cuda") -> Mesh:
    """The data x seq grid of this process group, from torchrun's
    environment. Initializes the default process group with `backend` if
    none is, and builds one `seq` group per replica and one `data` group
    per seq position (every rank takes part in creating every group).
    device "cuda": rank i runs on cuda:{LOCAL_RANK % device_count}; "cpu":
    on the CPU (gloo only). The backend is never switched: NCCL refuses two
    ranks on one card, so several ranks on one card need backend="gloo"."""
    if dp < 1 or sp < 1:
        raise ValueError(f"dp={dp}, sp={sp}: both must be >= 1")
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        raise RuntimeError("create_mesh reads RANK and WORLD_SIZE (and LOCAL_RANK, "
                           "MASTER_ADDR, MASTER_PORT) from the environment: start the "
                           "ranks with torchrun")
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    if dp * sp != world:
        raise ValueError(f"dp * sp = {dp} * {sp} != WORLD_SIZE {world}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    elif backend != "gloo":
        raise ValueError(f"backend {backend!r} on the CPU: use gloo")
    if not dist.is_initialized():
        dist.init_process_group(backend, rank=rank, world_size=world)
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, not {backend}")
    seq_group = data_group = None
    for d in range(dp):
        ranks = [d * sp + s for s in range(sp)]
        g = dist.new_group(ranks, backend=backend)
        if rank in ranks:
            seq_group = g
    for s in range(sp):
        ranks = [d * sp + s for d in range(dp)]
        g = dist.new_group(ranks, backend=backend)
        if rank in ranks:
            data_group = g
    return Mesh(dp=dp, sp=sp, rank=rank, data_rank=rank // sp, seq_rank=rank % sp,
                data_group=data_group, seq_group=seq_group, device=dev, backend=backend)


def seq_slice(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's samples (axis 0, split over `data`) and frames (axis 1,
    split over `seq`) of a (B, T, ...) batch: the counterpart of placing it
    with the JAX package's seq_sharding."""
    b, t = x.shape[:2]
    if b % mesh.dp or t % mesh.sp:
        raise ValueError(f"batch {b} x {t} frames does not split over dp={mesh.dp} x "
                         f"sp={mesh.sp}")
    bl, tl = b // mesh.dp, t // mesh.sp
    return x[mesh.data_rank * bl:(mesh.data_rank + 1) * bl,
             mesh.seq_rank * tl:(mesh.seq_rank + 1) * tl].contiguous()


def gather_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The inverse of seq_slice on every rank: (b_l, t_l, ...) of each rank
    -> (B, T, ...)."""
    bl, tl = x.shape[:2]
    g = all_gather_flat(x.contiguous(), None).view((mesh.dp, mesh.sp) + tuple(x.shape))
    g = g.transpose(1, 2)  # (dp, b_l, sp, t_l, ...)
    return g.reshape((mesh.dp * bl, mesh.sp * tl) + tuple(x.shape[2:]))


def all_reduce_grads(params, mesh: Mesh) -> None:
    """Sum the gradients of `params` over all ranks, in place, in one
    collective over one flat buffer: after it every rank holds the gradient
    of the global loss. A parameter without a gradient gets a zero one."""
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    all_reduce_sum_(flat, None)
    i = 0
    for p in params:
        n = p.numel()
        p.grad.copy_(flat[i:i + n].view_as(p.grad))
        i += n


def check_replica_consistency(named: dict, mesh: Mesh, rtol: float = 0.0) -> list:
    """Whether every rank holds the same values: per-leaf float64 sums of
    {name: tensor}, gathered from all ranks and compared with rank 0's, as
    the JAX package's check_replica_consistency. Returns the mismatches
    (empty: consistent)."""
    names = list(named)
    sums = torch.tensor([float(named[n].detach().double().sum()) for n in names],
                        dtype=torch.float64, device=mesh.device)
    rows = all_gather_flat(sums, None).cpu()
    bad = []
    for i, name in enumerate(names):
        col = rows[:, i]
        tol = rtol * max(abs(float(col[0])), 1e-30)
        if bool(((col - col[0]).abs() > tol).any()):
            bad.append(f"{name}: per-rank sums {col.tolist()}")
    return bad
