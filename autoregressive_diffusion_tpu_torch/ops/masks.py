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
frames < i plus only itself in the noisy half.
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


def expand_to_tokens(frame_mask: np.ndarray, tokens_per_frame: int) -> np.ndarray:
    """Broadcast a frame-level mask to token granularity."""
    m = np.repeat(frame_mask, tokens_per_frame, axis=0)
    return np.repeat(m, tokens_per_frame, axis=1)
