"""Optimizer assembly: AdamW + global-norm clip + forced weight normalization.

Counterpart of autoregressive_diffusion_tpu/train/optim.py. The forward
always uses normalize(w) (ops/numerics.mp_weight), so gradients flow through
the normalized weight, and after each optimizer update the raw parameter is
renormalized: normalize(w) inside the forward then sees an already-unit-norm
weight.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Union

import torch

from ..ops.numerics import normalize


def _is_normalized_weight(name: str) -> bool:
    """All magnitude-preserving conv/dense kernels are named 'w'."""
    return name.rsplit(".", 1)[-1] == "w"


@torch.no_grad()
def forced_weight_norm(params: dict) -> dict:
    """Renormalize, in place, every MP weight of {name: tensor} to unit
    magnitude per output channel (the output axis is last; the norm reduces
    over the rest)."""
    for name, p in params.items():
        if _is_normalized_weight(name):
            p.copy_(normalize(p, dim=tuple(range(p.ndim - 1))))
    return params


def global_norm(tensors) -> torch.Tensor:
    """sqrt(sum of squares) over a list of tensors, fp32."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


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
    def update(self, opt: torch.optim.Optimizer, count: int) -> torch.Tensor:
        """Clip the gradients held by opt's parameters in place, take one
        AdamW step at the learning rate of update `count`, and return the
        gradients' global norm before the clip. The clip scales by
        clip / max(norm, clip): at or below the threshold the gradients are
        untouched, above it the norm becomes exactly the threshold.
        Parameters without a gradient get a zero one."""
        params = [p for group in opt.param_groups for p in group["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        norm = global_norm(grads)
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
