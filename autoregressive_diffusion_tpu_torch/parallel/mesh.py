"""A replica x data x seq x model grid of torch.distributed ranks.

Counterpart of autoregressive_diffusion_tpu/parallel/mesh.py (create_mesh
:31-69, seq_sharding, param_sharding :89-130, shard_train_state :133-150,
gather_to_host :153-177, check_replica_consistency :180-210). Where the JAX
package shards arrays over a ('replica', 'data', 'seq', 'model') device mesh
and lets XLA insert the collectives, each process here is one rank holding
its own slice of the batch (over replica x data), of the clip's frames
(over `seq`) and of the sharded weights (output channels over `model`, the
FSDP axis over `data`), and the model's collectives run on the process
groups of this grid (parallel/collectives.py). As in the JAX mesh `model`
is the minor axis:

    rank = ((replica * dp + data) * sp + seq) * tp + model

so the model ranks of one (replica, data, seq) position are neighbours.
The groups: `model` (TP), `seq` (SP), `data` (the dp ranks of one replica:
FSDP), `grad` (replica x data x seq: the sums of replicated and TP-sharded
gradients and of the metrics, one collective where a replica x data group
and a seq group would take two) and `fsdp_sum` (replica x seq: the sums of
FSDP gradients after their reduce-scatter over `data`). The model ranks of
one position see the same samples and frames.

Processes are started by torchrun (or any launcher that sets RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT). Rank i runs on
cuda:{LOCAL_RANK % device_count}, so several ranks can share one card
under the gloo backend.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .collectives import all_gather_flat, all_reduce_sum_, broadcast_

WEIGHT_NAMES = ("w", "kernel")  # the leaves param_sharding may split


@dataclasses.dataclass(frozen=True)
class Mesh:
    dp: int = 1             # data ranks of one replica
    sp: int = 1             # seq ranks a clip's frames are split over
    tp: int = 1             # model ranks a weight's output channels are split over
    replicas: int = 1       # the outermost, pure data-parallel axis
    rank: int = 0
    replica_rank: int = 0
    data_rank: int = 0
    seq_rank: int = 0
    model_rank: int = 0
    model_group: object = None
    seq_group: object = None
    data_group: object = None      # the dp ranks of this replica, seq and model position
    grad_group: object = None      # replica x data x seq
    fsdp_sum_group: object = None  # replica x seq
    device: torch.device = torch.device("cpu")
    backend: str = "gloo"

    @property
    def world(self) -> int:
        return self.replicas * self.dp * self.sp * self.tp

    @property
    def batch_ranks(self) -> int:
        """The ways the batch is split: replica x data."""
        return self.replicas * self.dp

    @property
    def batch_rank(self) -> int:
        return self.replica_rank * self.dp + self.data_rank

    def coords(self, rank: int):
        """(replica, data, seq, model) of global rank `rank`."""
        model, rest = rank % self.tp, rank // self.tp
        seq, rest = rest % self.sp, rest // self.sp
        return rest // self.dp, rest % self.dp, seq, model

    def global_rank(self, replica: int, data: int, seq: int, model: int) -> int:
        return ((replica * self.dp + data) * self.sp + seq) * self.tp + model


def _group_of(mesh: Mesh, key, backend: str):
    """Create one process group per value of key(coords) (every rank
    creates every group, in the same order) and return this rank's. A
    group's ranks are ascending, so its rank order follows the grid."""
    parts = {}
    for r in range(mesh.world):
        parts.setdefault(key(*mesh.coords(r)), []).append(r)
    mine = None
    for k in sorted(parts):
        g = dist.new_group(parts[k], backend=backend)
        if mesh.rank in parts[k]:
            mine = g
    return mine


def create_mesh(dp: int = 1, sp: int = 1, backend: str = "nccl", device: str = "cuda", *,
                tp: int = 1, num_slices: int = 1) -> Mesh:
    """The replica x data x seq x model grid of this process group, from
    torchrun's environment (WORLD_SIZE = num_slices * dp * sp * tp).
    Initializes the default process group with `backend` if none is, and
    builds the grid's groups (module docstring; every rank takes part in
    creating every group). device "cuda": rank i runs on
    cuda:{LOCAL_RANK % device_count}; "cpu": on the CPU (gloo only). The
    backend is never switched: NCCL refuses two ranks on one card, so
    several ranks on one card need backend="gloo"."""
    if min(dp, sp, tp, num_slices) < 1:
        raise ValueError(f"dp={dp}, sp={sp}, tp={tp}, num_slices={num_slices}: all must be >= 1")
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        raise RuntimeError("create_mesh reads RANK and WORLD_SIZE (and LOCAL_RANK, "
                           "MASTER_ADDR, MASTER_PORT) from the environment: start the "
                           "ranks with torchrun")
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    if num_slices * dp * sp * tp != world:
        raise ValueError(f"num_slices * dp * sp * tp = {num_slices} * {dp} * {sp} * {tp} != "
                         f"WORLD_SIZE {world}")
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
    mesh = Mesh(dp=dp, sp=sp, tp=tp, replicas=num_slices, rank=rank, device=dev,
                backend=backend)
    replica, data, seq, model = mesh.coords(rank)
    groups = dict(
        model_group=_group_of(mesh, lambda r, d, s, m: (r, d, s), backend),
        seq_group=_group_of(mesh, lambda r, d, s, m: (r, d, m), backend),
        data_group=_group_of(mesh, lambda r, d, s, m: (r, s, m), backend),
        grad_group=_group_of(mesh, lambda r, d, s, m: m, backend),
        fsdp_sum_group=_group_of(mesh, lambda r, d, s, m: (d, m), backend))
    return dataclasses.replace(mesh, replica_rank=replica, data_rank=data, seq_rank=seq,
                               model_rank=model, **groups)


def seq_slice(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's samples (axis 0, split over replica x data) and frames
    (axis 1, split over `seq`) of a (B, T, ...) batch: the counterpart of
    placing it with the JAX package's seq_sharding. The model ranks of one
    position get the same slice."""
    b, t = x.shape[:2]
    nb = mesh.batch_ranks
    if b % nb or t % mesh.sp:
        raise ValueError(f"batch {b} x {t} frames does not split over replica x data = {nb} "
                         f"x sp={mesh.sp}")
    bl, tl, br = b // nb, t // mesh.sp, mesh.batch_rank
    return x[br * bl:(br + 1) * bl, mesh.seq_rank * tl:(mesh.seq_rank + 1) * tl].contiguous()


def gather_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The inverse of seq_slice on every rank: (b_l, t_l, ...) of each rank
    -> (B, T, ...)."""
    bl, tl = x.shape[:2]
    nb = mesh.batch_ranks
    g = all_gather_flat(x.contiguous(), mesh.grad_group).view((nb, mesh.sp) + tuple(x.shape))
    g = g.transpose(1, 2)  # (nb, b_l, sp, t_l, ...)
    return g.reshape((nb * bl, mesh.sp * tl) + tuple(x.shape[2:]))


# ---------------------------------------------------------------------------
# sharding specs: one entry per axis, None, "model" or "data" (JAX's
# PartitionSpec of the leaf, padded with None to the leaf's rank)

def is_sharded(spec) -> bool:
    return spec is not None and any(a is not None for a in spec)


def param_sharding(mesh, named_params: dict, min_shard_size: int = 128, fsdp: bool = False,
                   fsdp_min_size: int = 2 ** 16) -> dict:
    """{name: spec} for {name: tensor or shape}, by the JAX package's rule:
    the last (output-channel) axis of every >= 2-D weight named `w` goes to
    `model` when tp divides it and it is at least `min_shard_size`; with
    fsdp (and dp > 1), a weight of at least `fsdp_min_size` elements also
    puts its largest free axis that dp divides (the first of equals) on
    `data`. Everything else is replicated. `replica` never carries FSDP.
    Reads mesh.tp and mesh.dp only."""
    tp, dp = mesh.tp, mesh.dp
    specs = {}
    for name, p in named_params.items():
        shape = tuple(getattr(p, "shape", p))
        is_w = name.rsplit(".", 1)[-1] in WEIGHT_NAMES and len(shape) >= 2
        spec = [None] * len(shape)
        if tp > 1 and is_w and shape[-1] % tp == 0 and shape[-1] >= min_shard_size:
            spec[-1] = "model"
        if fsdp and dp > 1 and is_w and math.prod(shape) >= fsdp_min_size:
            free = [ax for ax in range(len(shape)) if spec[ax] is None and shape[ax] % dp == 0]
            if free:
                spec[max(free, key=lambda ax: shape[ax])] = "data"
        specs[name] = tuple(spec)
    return specs


def _axis_chunk(mesh, axis_name: str):
    return ((mesh.model_rank, mesh.tp) if axis_name == "model" else
            (mesh.data_rank, mesh.dp))


def local_shard(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's contiguous chunk of the full tensor `t` on each sharded
    axis of `spec` (JAX's device order: rank (d, m) holds the shard of
    device (d, m)). A copy. Reads mesh.tp, dp, model_rank, data_rank."""
    out = t
    for axis, name in enumerate(spec or ()):
        if name is not None:
            i, n = _axis_chunk(mesh, name)
            size = t.shape[axis] // n
            out = out.narrow(axis, i * size, size)
    return out.contiguous().clone()


def full_tensors(tensors, specs, mesh: Mesh) -> list:
    """The full tensors from every rank's shards (one spec a tensor): one
    all-gather over the model group for all the tensors split over
    `model`, then one over the data group for those split over `data`.
    Every rank of those groups calls it with the same specs."""
    out = list(tensors)
    for axis_name, group, n in (("model", mesh.model_group, mesh.tp),
                                ("data", mesh.data_group, mesh.dp)):
        idx = [i for i, s in enumerate(specs) if axis_name in (s or ())]
        if not idx or n == 1:
            continue
        moved = [out[i].movedim(specs[i].index(axis_name), 0).contiguous() for i in idx]
        g = all_gather_flat(torch.cat([m.reshape(-1) for m in moved]), group)  # (n, total)
        off = 0
        for i, m in zip(idx, moved):
            part = g[:, off:off + m.numel()].reshape((n * m.shape[0],) + tuple(m.shape[1:]))
            out[i] = part.movedim(0, specs[i].index(axis_name)).contiguous()
            off += m.numel()
    return out


def _opt_moments(state, p) -> dict:
    return {k: v for k, v in state.opt_state.state.get(p, {}).items()
            if k in ("exp_avg", "exp_avg_sq")}


def _install(model: torch.nn.Module, mesh: Optional[Mesh], specs: Optional[dict]) -> None:
    """Hand every module holding a weight `w` its (mesh, spec), or None;
    mark the modules that refuse sharded serving."""
    for mname, mod in model.named_modules():
        w = getattr(mod, "w", None)
        if isinstance(w, torch.nn.Parameter):
            spec = None if specs is None else specs[f"{mname}.w" if mname else "w"]
            mod.shard = (mesh, spec) if is_sharded(spec) else None
        if hasattr(mod, "sharded"):
            mod.sharded = specs is not None and any(is_sharded(s) for s in specs.values())


@torch.no_grad()
def shard_train_state(state, mesh: Mesh, min_shard_size: int = 128, fsdp: bool = False,
                      fsdp_min_size: int = 2 ** 16):
    """Keep this rank's shards of a full TrainState, in place: the
    parameters, both EMA copies and the AdamW moments follow the
    param_sharding rule; the step, the coefs and the buffers stay
    replicated (JAX shard_train_state, _match_params). The model's weight
    modules get their specs (models/layers.py gathers and splits around
    them). fsdp=True turns data parallelism into fully sharded data
    parallelism. Returns (state, specs)."""
    if state.specs is not None:
        raise ValueError("the train state is already sharded")
    named = dict(state.model.named_parameters())
    specs = param_sharding(mesh, named, min_shard_size, fsdp, fsdp_min_size)
    for name, p in named.items():
        spec = specs[name]
        if not is_sharded(spec):
            continue
        p.data = local_shard(p.data, spec, mesh)
        for e in state.ema:
            e[name] = local_shard(e[name], spec, mesh)
        st = state.opt_state.state.get(p, {})
        for k in _opt_moments(state, p):
            st[k] = local_shard(st[k], spec, mesh)
    _install(state.model, mesh, specs)
    state.mesh, state.specs = mesh, specs
    return state, specs


@torch.no_grad()
def unshard_train_state(state):
    """The inverse of shard_train_state, in place: every sharded leaf
    gathered to its full tensor on this rank's device. Every rank calls it."""
    if state.specs is None:
        return state
    mesh = state.mesh
    named = [(n, p) for n, p in state.model.named_parameters()
             if is_sharded(state.specs[n])]
    specs = [state.specs[n] for n, _ in named]
    for k in ("exp_avg", "exp_avg_sq"):
        have = [(n, p) for n, p in named if k in _opt_moments(state, p)]
        full = full_tensors([state.opt_state.state[p][k] for _, p in have],
                            [state.specs[n] for n, _ in have], mesh)
        for (_, p), t in zip(have, full):
            state.opt_state.state[p][k] = t
    for e in state.ema:
        for (n, _), t in zip(named, full_tensors([e[n] for n, _ in named], specs, mesh)):
            e[n] = t
    for (_, p), t in zip(named, full_tensors([p.data for _, p in named], specs, mesh)):
        p.data = t
    _install(state.model, None, None)
    state.specs = None
    return state


def gather_to_host(state) -> dict:
    """The train state as full host numpy arrays in the tree that
    utils/checkpoint.save_train_state writes (utils/bridge.train_state_tree):
    every sharded leaf (parameter, EMA copy, AdamW moment) all-gathered
    first, two collectives a tree. Every rank calls it and gets the whole
    tree."""
    from ..utils.bridge import train_state_tree
    if state.specs is None:
        return train_state_tree(state)
    return train_state_tree(state, gather=lambda names, ts: full_tensors(
        ts, [state.specs[n] for n in names], state.mesh))


def all_reduce_grads(params, mesh: Mesh, specs: Optional[dict] = None) -> None:
    """Sum the gradients over the ranks that hold the same leaf, in place,
    one collective over one flat buffer a kind: replicated and TP-sharded
    leaves over the `grad` group (replica x data x seq), FSDP leaves (whose
    data-axis reduce-scatter ran in the backward) over `fsdp_sum` (replica
    x seq). Then every leaf not split over `model` is broadcast from model
    rank 0, so the model ranks hold it bit for bit (a kernel that sums in
    another order on another rank cannot split them). After it every rank
    holds its shard of the gradient of the global loss. params: {name:
    parameter} with `specs`, or any iterable of parameters without. A
    parameter without a gradient gets a zero one."""
    named = list(params.items()) if isinstance(params, dict) else [(None, p) for p in params]
    for _, p in named:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    spec_of = (lambda n: None) if specs is None else specs.__getitem__
    fsdp = [p for n, p in named if "data" in (spec_of(n) or ())]
    rest = [p for n, p in named if "data" not in (spec_of(n) or ())]
    _sum_flat(rest, mesh.grad_group)
    _sum_flat(fsdp, mesh.fsdp_sum_group)
    if mesh.tp > 1:
        src = mesh.global_rank(*mesh.coords(mesh.rank)[:3], 0)
        _flat_op([p for n, p in named if "model" not in (spec_of(n) or ())],
                 lambda flat: broadcast_(flat, src, mesh.model_group))


def _flat_op(params, op) -> None:
    if not params:
        return
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    op(flat)
    i = 0
    for p in params:
        n = p.numel()
        p.grad.copy_(flat[i:i + n].view_as(p.grad))
        i += n


def _sum_flat(params, group) -> None:
    if group is not None and dist.get_world_size(group) == 1:
        return
    _flat_op(params, lambda flat: all_reduce_sum_(flat, group))


def train_state_leaves(state) -> tuple:
    """({name: tensor}, {name: spec}) of the parameters, both EMA copies
    (ema0., ema1.) and the AdamW moments (mu., nu.) of a TrainState: what
    check_replica_consistency compares."""
    named, specs = {}, {}
    spec_of = (lambda n: None) if state.specs is None else state.specs.__getitem__
    for n, p in state.model.named_parameters():
        named[n], specs[n] = p, spec_of(n)
        for i, e in enumerate(state.ema):
            named[f"ema{i}.{n}"], specs[f"ema{i}.{n}"] = e[n], spec_of(n)
        for k, v in _opt_moments(state, p).items():
            key = f"{'mu' if k == 'exp_avg' else 'nu'}.{n}"
            named[key], specs[key] = v, spec_of(n)
    return named, specs


def check_replica_consistency(named: dict, mesh: Mesh, rtol: float = 0.0,
                              specs: Optional[dict] = None) -> list:
    """Whether the ranks that should hold the same values do: per-leaf
    float64 sums of {name: tensor}, gathered from all ranks; a leaf is
    compared among the ranks that hold the same shard of it (same model
    rank if its spec in `specs` puts an axis on `model`, same data rank if
    on `data`; every rank for a replicated leaf), each against the first
    of them, as the JAX package's check_replica_consistency compares the
    processes' sums. Returns the mismatches (empty: consistent)."""
    names = list(named)
    sums = torch.tensor([float(named[n].detach().double().sum()) for n in names],
                        dtype=torch.float64, device=mesh.device)
    rows = all_gather_flat(sums, None).cpu()
    coords = [mesh.coords(r) for r in range(rows.shape[0])]
    bad = []
    for i, name in enumerate(names):
        spec = (specs or {}).get(name) or ()

        def holder(c):
            return (c[3] if "model" in spec else None, c[1] if "data" in spec else None)

        classes = {}
        for r, c in enumerate(coords):
            classes.setdefault(holder(c), []).append(r)
        for ranks in classes.values():
            col = rows[ranks, i]
            tol = rtol * max(abs(float(col[0])), 1e-30)
            if bool(((col - col[0]).abs() > tol).any()):
                bad.append(f"{name}: per-rank sums {dict(zip(ranks, col.tolist()))}")
    return bad
