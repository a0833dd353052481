"""Training statistics pooled over ranks.

Counterpart of autoregressive_diffusion_tpu/utils/stats.py: `report(name,
values)` adds the per-name moments [n, sum x, sum x^2] of the finite values
to a pending set; a `Collector` drains it and gives each name's mean and std
over the period. Where the JAX package sums the pending moments over JAX
processes, this one sums them over the ranks of the default
torch.distributed group when one is initialised (every rank must call
`Collector.update` at the same point, as with any collective); a single
process pools nothing. Names one rank never reported count as zero there.
"""
from __future__ import annotations

import re
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

_NUM_MOMENTS = 3  # [num, sum x, sum x^2]

_counters: Dict[str, np.ndarray] = {}
_cumulative: Dict[str, np.ndarray] = {}


def _world() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def report(name: str, value) -> object:
    """Accumulate the values under `name`, NaN and Inf left out; returns
    value unchanged so it can be used inline."""
    v = value.detach().float().cpu().numpy() if isinstance(value, torch.Tensor) else value
    elems = np.asarray(v, dtype=np.float64).ravel()
    if elems.size:
        finite = np.isfinite(elems)
        moments = np.array([finite.sum(), elems[finite].sum(),
                            np.square(elems[finite]).sum()], np.float64)
        _counters[name] = _counters.get(name, np.zeros(_NUM_MOMENTS)) + moments
    elif name not in _counters:
        _counters[name] = np.zeros(_NUM_MOMENTS)
    return value


def report0(name: str, value) -> object:
    """Accumulate on rank 0 only (every rank still knows the name)."""
    rank0 = _world() == 1 or dist.get_rank() == 0
    report(name, value if rank0 else [])
    return value


def _drain_synced() -> Dict[str, np.ndarray]:
    """Take the pending moments, summed over the ranks, and reset them."""
    global _counters
    pending, _counters = _counters, {}
    if _world() > 1:
        gathered = [None] * _world()
        dist.all_gather_object(gathered, pending)
        summed: Dict[str, np.ndarray] = {}
        for rank_moments in gathered:
            for name, m in rank_moments.items():
                summed[name] = summed.get(name, np.zeros(_NUM_MOMENTS)) + m
        pending = summed
    for name, moments in pending.items():
        _cumulative[name] = _cumulative.get(name, np.zeros(_NUM_MOMENTS)) + moments
    return pending


class Collector:
    """Period averages of the reported statistics."""

    def __init__(self, regex: str = ".*", keep_previous: bool = True):
        self._regex = re.compile(regex)
        self._keep_previous = keep_previous
        self._moments: Dict[str, np.ndarray] = {}
        self.update()
        self._moments.clear()

    def names(self) -> List[str]:
        return [n for n in _cumulative if self._regex.fullmatch(n)]

    def update(self) -> None:
        if not self._keep_previous:
            self._moments.clear()
        for name, delta in _drain_synced().items():
            if not self._regex.fullmatch(name):
                continue
            if delta[0] or name not in self._moments:
                self._moments[name] = delta

    def _get(self, name: str) -> np.ndarray:
        return self._moments.get(name, np.zeros(_NUM_MOMENTS))

    def num(self, name: str) -> int:
        return int(self._get(name)[0])

    def mean(self, name: str) -> float:
        m = self._get(name)
        return float(m[1] / m[0]) if m[0] else float("nan")

    def std(self, name: str) -> float:
        m = self._get(name)
        if m[0] == 0 or not np.isfinite(m[1]):
            return float("nan")
        if m[0] == 1:
            return 0.0
        mean = m[1] / m[0]
        return float(np.sqrt(max(m[2] / m[0] - mean ** 2, 0)))

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {n: dict(num=self.num(n), mean=self.mean(n), std=self.std(n))
                for n in self.names()}

    def __getitem__(self, name: str) -> float:
        return self.mean(name)
