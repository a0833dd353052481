"""Optimizer assembly: AdamW + global-norm clip + forced weight normalization.

Counterpart of autoregressive_diffusion_tpu/train/optim.py. The forward
always uses normalize(w) (ops/numerics.mp_weight), so gradients flow through
the normalized weight, and after each optimizer update the raw parameter is
renormalized: normalize(w) inside the forward then sees an already-unit-norm
weight.

Under tensor parallelism and FSDP (parallel/mesh.shard_train_state) each
rank holds shards: the global norm sums the squares of a sharded leaf over
the ranks that hold its shards and counts a replicated leaf once, and the
forced weight norm sums a weight's squares over the data group when its
FSDP axis is one of the reduced ones (the TP output axis stays local).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Union

import torch

from ..ops.numerics import normalize
from ..parallel.collectives import all_reduce_sum_


def _is_normalized_weight(name: str) -> bool:
    """All magnitude-preserving conv/dense kernels are named 'w'."""
    return name.rsplit(".", 1)[-1] == "w"


@torch.no_grad()
def forced_weight_norm(params: dict, specs=None, mesh=None) -> dict:
    """Renormalize, in place, every MP weight of {name: tensor} to unit
    magnitude per output channel (the output axis is last; the norm reduces
    over the rest). specs ({name: spec}) and mesh: the leaves are shards
    (parallel/mesh.py); the weights with their FSDP axis among the reduced
    ones sum their squares over the data group (one collective for all of
    them), and their fan-in is the full one."""
    split = []
    for name, p in params.items():
        if not _is_normalized_weight(name):
            continue
        spec = None if specs is None else specs.get(name)
        if spec is None or "data" not in spec[:-1]:
            p.copy_(normalize(p, dim=tuple(range(p.ndim - 1))))
        else:
            split.append(p)
    if not split:
        return params
    squares = [torch.sum(p.float() ** 2, dim=tuple(range(p.ndim - 1))) for p in split]
    total = all_reduce_sum_(torch.cat(squares), mesh.data_group)
    for p, ss in zip(split, torch.split(total, [s.numel() for s in squares])):
        fan_in = math.prod(p.shape[:-1]) * mesh.dp
        n = 1e-4 + torch.sqrt(ss + 1e-24) * (1.0 / math.sqrt(fan_in))
        p.copy_((p.float() / n).to(p.dtype))
    return params


def global_norm(tensors, specs=None, mesh=None) -> torch.Tensor:
    """sqrt(sum of squares) over a list of tensors, fp32. specs (one spec
    a tensor, parallel/mesh.py) and mesh: the tensors are this rank's
    shards; the squares of a leaf split over `model` are summed over the
    model group, over `data` over the data group, and a replicated leaf
    counts once."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    if specs is None or all(not s or all(a is None for a in s) for s in specs):
        return torch.linalg.vector_norm(torch.stack(norms))
    # squares by kind: replicated, over model, over data, over both; a
    # masked sum, not index_add_, whose atomics on the card could round the
    # same squares differently on two ranks and split the replicas
    kind = torch.tensor([("model" in (s or ())) + 2 * ("data" in (s or ())) for s in specs],
                        device=norms[0].device)
    onehot = (kind[None, :] == torch.arange(4, device=kind.device)[:, None]).float()
    sums = (onehot * (torch.stack(norms) ** 2)[None, :]).sum(dim=1)
    if mesh.tp > 1:
        sums[1::2] = all_reduce_sum_(sums[1::2].contiguous(), mesh.model_group)
    if mesh.dp > 1:
        sums[2:] = all_reduce_sum_(sums[2:].contiguous(), mesh.data_group)
    return torch.sqrt(sums.sum())


@dataclasses.dataclass
class ClippedAdamW:
    """Global-norm clip, then AdamW. learning_rate is a float or a function
    of the number of updates taken so far (0 at the first update)."""
    learning_rate: Union[float, Callable[[int], float]]
    grad_clip: float = 0.1
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init(self, params) -> torch.optim.Optimizer:
        return torch.optim.AdamW(list(params), lr=self.lr_at(0), betas=(0.9, 0.999),
                                 eps=self.eps, weight_decay=self.weight_decay)

    def lr_at(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    @torch.no_grad()
    def update(self, opt: torch.optim.Optimizer, count: int, specs=None,
               mesh=None) -> torch.Tensor:
        """Clip the gradients held by opt's parameters in place, take one
        AdamW step at the learning rate of update `count`, and return the
        gradients' global norm before the clip. The clip scales by
        clip / max(norm, clip): at or below the threshold the gradients are
        untouched, above it the norm becomes exactly the threshold.
        Parameters without a gradient get a zero one. specs (one a
        parameter, in opt's order) and mesh: the parameters are shards
        (global_norm)."""
        params = [p for group in opt.param_groups for p in group["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        norm = global_norm(grads, specs, mesh)
        torch._foreach_mul_(grads, self.grad_clip / torch.clamp(norm, min=self.grad_clip))
        for group in opt.param_groups:
            group["lr"] = self.lr_at(count)
        opt.step()
        return norm


def make_optimizer(learning_rate, grad_clip: float = 0.1, eps: float = 1e-8,
                   weight_decay: float = 0.0) -> ClippedAdamW:
    """clip_grad_norm(grad_clip) -> AdamW(lr, eps). learning_rate may be a
    scalar or a schedule (update count -> learning rate)."""
    return ClippedAdamW(learning_rate, grad_clip, eps, weight_decay)
