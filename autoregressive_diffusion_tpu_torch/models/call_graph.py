"""The cached denoiser call replayed as a CUDA graph.

A rollout's frame step calls the denoiser 2 * num_steps - 1 times with one
frame against a cache that only the last call writes. Eagerly the host
launches about 4,100 kernels a call, and at the rollouts' widths the card
waits on them. `CallGraph` records one such call as a
torch.cuda.CUDAGraph and replays it while nothing it reads has changed, so
a call costs the host a few copies and one graph launch.

Which calls (`CallGraph.plan`): mode "eval", autograd off, one frame
(x.shape[1] == 1) against a cache, no cache update, not just_2d, and every
input tensor on a CUDA device. Every other call runs eagerly as before. The
graph is the eager call itself, recorded: both paths run the same Python
and the same kernels.

When it is recorded again: a graph is valid for one key, made of the
cache's frame counter, each cache tensor's address, shape and dtype, the
shapes, dtypes and devices of x, sigma and conditioning, and each
parameter's and buffer's identity, address and in-place version (a
sampler callback runs between optimizer steps). The first call of a new
set of shapes runs eagerly on the capture stream (its lazy set-up, such as
cuBLAS's workspace for that stream, must not happen inside a capture); a
later call with a new key records, then replays. So a rollout records
once a frame step, in its first call.

Memory: a new graph is recorded into the pool of the graph it replaces,
which is then dropped, so one call's intermediates are held, not one per
frame step. The live graph holds every tensor it reads (cache, weights),
so their memory cannot pass to another tensor while it may replay. A
train-mode call or a prefill that writes several frames into a cache
drops the live graph (no later call replays it: the weights are about to
change, or a new context begins), so its pool, its inputs and the cache it
read are freed. Inputs are copied into the graph's own; the output is
returned as a fresh tensor, so no result aliases a later call's; the cache
returned is the input cache, which a non-updating call leaves as it is
(checked once a recording). A replay runs no Python: the ops wrappers'
launch counters count the calls that ran eagerly or were recorded, and a
profiler's device trace shows a replay's kernels.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


def _leaves(tree: dict, out: list) -> list:
    for v in tree.values():
        if isinstance(v, dict):
            _leaves(v, out)
        elif torch.is_tensor(v):
            out.append(v)
    return out


def _spec(t: Optional[torch.Tensor]):
    return None if t is None else (tuple(t.shape), t.dtype, t.device)


class _Live(NamedTuple):
    key: tuple
    graph: object          # torch.cuda.CUDAGraph
    inputs: tuple          # the graph's x, sigma, conditioning (or None)
    out: torch.Tensor      # the graph's output
    held: tuple            # every tensor the graph reads: cache, parameters, buffers


class Plan(NamedTuple):
    """How one call runs: `kind` "eager", "capture" or "replay"; `key`
    None for a call that never takes the graph (it runs eagerly on the
    current stream); `held` the cache's tensors and the model's."""
    kind: str
    key: Optional[tuple]
    held: tuple


class CallGraph:
    """One model's live graph of its cached call (see the module docstring)."""

    def __init__(self):
        self.live: Optional[_Live] = None
        self.warm = set()  # the shape sets whose first call ran on the capture stream
        self.stream = None

    @staticmethod
    def on_card(*tensors) -> bool:
        return all(t is None or t.is_cuda for t in tensors)

    def plan(self, model, x, sigma, conditioning, cache, update_cache, mode,
             just_2d) -> Plan:
        """The plan of model(x, sigma, conditioning, cache, ...). A
        train-mode call, or one that writes several frames into a cache,
        drops the live graph."""
        if mode == "train" or (update_cache and x.shape[1] > 1):
            self.live = None
        if (mode != "eval" or cache is None or x.shape[1] != 1 or update_cache or just_2d
                or torch.is_grad_enabled() or not self.on_card(x, sigma, conditioning)):
            return Plan("eager", None, ())
        leaves = _leaves(cache, [])
        tensors = list(model.parameters()) + list(model.buffers())
        shapes = (_spec(x), _spec(sigma), _spec(conditioning),
                  tuple((t.shape, t.dtype) for t in leaves))
        key = (shapes, int(cache.get("frames", 0)), tuple(t.data_ptr() for t in leaves),
               tuple((id(t), t.data_ptr(), t._version) for t in tensors))
        if self.live is not None and self.live.key == key:
            kind = "replay"
        else:
            kind = "capture" if shapes in self.warm else "eager"
        return Plan(kind, key, (leaves, tensors))

    def run(self, plan: Plan, body, x, sigma, conditioning) -> torch.Tensor:
        """The output of body(x, sigma, conditioning), the model's eager
        call, run as the plan says: "eager" on the capture stream (the
        first call of its shapes), "capture" records the call and replays
        it, "replay" replays the live graph."""
        if plan.kind == "eager":
            out = self.on_capture_stream(lambda: body(x, sigma, conditioning)[0])
            self.warm.add(plan.key[0])
            return out
        if plan.kind == "capture":
            self._record(plan, body, x, sigma, conditioning)
        live = self.live
        for dst, src in zip(live.inputs, (x, sigma, conditioning)):
            if dst is not None:
                dst.copy_(src)
        live.graph.replay()
        return live.out.clone()

    def _record(self, plan, body, x, sigma, conditioning):
        inputs = tuple(None if t is None else t.clone() for t in (x, sigma, conditioning))
        pool = None if self.live is None else self.live.graph.pool()
        graph, (out, new_cache) = self.capture(lambda: body(*inputs), pool)
        if {id(t) for t in _leaves(new_cache, [])} != {id(t) for t in plan.held[0]}:
            raise RuntimeError("a call that updates no cache returned new cache tensors: "
                               "it cannot be replayed as a graph")
        self.live = _Live(plan.key, graph, inputs, out, plan.held)  # drops the old one

    def _side_stream(self):
        if self.stream is None:
            self.stream = torch.cuda.Stream()
        return self.stream

    def on_capture_stream(self, fn):
        """fn() run eagerly on the capture stream, ordered after and before
        the current stream's work."""
        cur, side = torch.cuda.current_stream(), self._side_stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = fn()
        cur.wait_stream(side)
        out.record_stream(cur)
        return out

    def capture(self, fn, pool):
        """(graph, fn()) with fn's CUDA work recorded into a new graph on
        the capture stream, its memory from `pool` (None: a new pool)."""
        graph = torch.cuda.CUDAGraph()
        cur, side = torch.cuda.current_stream(), self._side_stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            graph.capture_begin(pool=pool)
            try:
                result = fn()
            finally:
                graph.capture_end()
        cur.wait_stream(side)
        return graph, result
