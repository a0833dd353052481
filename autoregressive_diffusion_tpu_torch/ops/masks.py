"""Frame-granular attention masks for training and inference prefill.

Counterpart of the causal and ring-prefill masks of
autoregressive_diffusion_tpu (ops/masks.py causal_frame_mask,
ops/flash_attention.py PrefillMask); the causal mask is the ring mask with
offset 0 and f_total = t_new. Masks are boolean numpy matrices at FRAME granularity; the
plain attention path broadcasts them to tokens, the prefill kernel
evaluates the same predicate from frame indices alone.

The DART training mask (JAX package ops/masks.py train_frame_mask) is over
a 2T-frame sequence, clean copy = frames [0, T), noisy copy = [T, 2T):
clean query i attends clean frames <= i; noisy query i+T attends clean
frames < i plus only itself in the noisy half. `frame_visible` states the
same rule per (query frame, key frame) pair, as the flash-attention kernels
(csrc/flash_tile.cuh) evaluate it. Under sequence parallelism the kernels
first map each frame index to its global frame with `shard_frame`.
"""
from __future__ import annotations

import functools

import numpy as np


def ring_slot_position(slot, end: int, f_total: int):
    """Absolute frame position held by ring slot `slot` (an int, numpy or
    torch integer array) once frames [0, end) have been written to an
    f_total-slot ring: the newest p < end with p % f_total == slot.
    Negative = never written."""
    return end - 1 - ((end - 1 - slot) % f_total)


@functools.lru_cache(maxsize=64)
def prefill_frame_mask(t_new: int, f_total: int, offset: int) -> np.ndarray:
    """(t_new, f_total) bool warm-prefill mask: query frame i (absolute
    position offset + i) sees ring slot s iff 0 <= p(s) <= offset + i, with
    p(s) the slot's position after the t_new frames land (the wrapped ring
    included). The fresh causal mask is the case offset=0, f_total=t_new."""
    p = ring_slot_position(np.arange(f_total), offset + t_new, f_total)
    qpos = offset + np.arange(t_new)
    return (p[None, :] <= qpos[:, None]) & (p[None, :] >= 0)


@functools.lru_cache(maxsize=32)
def train_frame_mask(n_frames: int) -> np.ndarray:
    """(2T, 2T) bool DART mask at frame granularity."""
    t = n_frames
    q = np.arange(2 * t)[:, None]
    k = np.arange(2 * t)[None, :]
    clean_q, clean_k = q < t, k < t
    both_clean = clean_q & clean_k & (k <= q)
    noisy_to_clean = (~clean_q) & clean_k & (k < q - t)
    noisy_self = (~clean_q) & (~clean_k) & (q == k)
    return both_clean | noisy_to_clean | noisy_self


def frame_visible(kind: str, qf, kf, n_frames: int):
    """Whether query frame qf sees key frame kf (ints or broadcastable
    numpy integer arrays). "dart": the DART rule over 2T = 2*n_frames
    frames, as the JAX package's DartMask (ops/flash_attention.py:47-54): a
    clean query frame (qf < T) sees frames kf <= qf; a noisy one sees clean
    frames kf < qf - T and itself. "causal": frames kf <= qf, as its
    CausalFrameMask (:70-84). "full": every frame."""
    qf, kf = np.asarray(qf), np.asarray(kf)
    if kind == "full":
        return np.ones(np.broadcast_shapes(qf.shape, kf.shape), bool)
    if kind == "causal":
        return kf <= qf
    if kind != "dart":
        raise ValueError(f"unknown mask kind {kind!r}")
    clean_q = qf < n_frames
    return (clean_q & (kf <= qf)) | (~clean_q & ((kf == qf) | (kf < qf - n_frames)))


def shard_frame(j, t_local: int, n_frames: int, kind: str):
    """Global frame index of frame j of the sequence-parallel layout (an int
    or a numpy integer array). Under "dart" each of the sp seq ranks holds
    a local DART concat -- its t_local clean frames, then the same frames
    noisy -- and the K/V gathered over the ranks come rank-major: [clean_0
    noisy_0 clean_1 noisy_1 ...]. Local or gathered frame j of rank
    rho = j // (2 t_local) is clean global frame rho*t_local + (j mod
    2 t_local) in its first half, noisy global frame T + rho*t_local +
    (j mod 2 t_local - t_local) in its second. With t_local = n_frames (one
    rank) the map is the identity. The "causal" and "full" layouts are
    contiguous runs of frames: the identity."""
    j = np.asarray(j)
    if kind != "dart":
        return j
    rho, r = j // (2 * t_local), j % (2 * t_local)
    return np.where(r < t_local, rho * t_local + r, n_frames + rho * t_local + r - t_local)


def expand_to_tokens(frame_mask: np.ndarray, tokens_per_frame: int) -> np.ndarray:
    """Broadcast a frame-level mask to token granularity."""
    m = np.repeat(frame_mask, tokens_per_frame, axis=0)
    return np.repeat(m, tokens_per_frame, axis=1)
