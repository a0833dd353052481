"""Video / frame self-attention: train mode and the fixed-shape ring KV cache.

Counterpart of autoregressive_diffusion_tpu/models/attention.py:
  * the KV cache is a preallocated ring of `max_frames` slots; frame p goes
    to slot p % max_frames, so attention sees a sliding window of the last
    max_frames frames and rollouts are unbounded;
  * K/V are cached un-rotated and RoPE is re-applied with absolute frame
    positions; the xPos pivot sits at the frame counter;
  * prefill (t > 1, or a fresh cacheless call) runs the frame-masked
    prefill kernel (ops/flash_attention.py); the t == 1 cached decode step
    is a plain two-dot biased joint softmax over the precomputed decode
    tables (decode_tables), as in the JAX package;
  * train mode is dense attention under the DART mask over the S = 2*T*hw
    tokens of the concat (ops/masks.train_frame_mask), the clean and noisy
    replicas sharing RoPE positions; autograd differentiates it;
  * just_2d and FrameAttention are per-frame dense attention.
The qkv channel split is (s m c), as in the JAX package.
"""
from __future__ import annotations

import math

import einops
import torch
from torch import nn

from ..ops.attention import dense_attention
from ..ops.flash_attention import causal_frame_attention, prefill_cache_attention
from ..ops.masks import expand_to_tokens, ring_slot_position, train_frame_mask
from ..ops.numerics import mp_sum, normalize
from ..ops.rope import apply_rope, rope_qk, rope_tables
from .layers import MPConv


def ring_slot_positions(frames: int, capacity: int, device=None) -> torch.Tensor:
    """Absolute frame position held by each ring slot after `frames` frames
    were written (negative -> never written)."""
    return ring_slot_position(torch.arange(capacity, device=device), frames, capacity)


def ring_write(buf: torch.Tensor, new: torch.Tensor, frames: int) -> torch.Tensor:
    """A copy of `buf` with `new` (t frames on axis 2) written at slots
    (frames + j) % capacity; only the last `capacity` frames are kept."""
    capacity, t = buf.shape[2], new.shape[2]
    out = buf.clone()
    t0 = max(0, t - capacity)
    slots = (frames + torch.arange(t0, t, device=buf.device)) % capacity
    out[:, :, slots] = new[:, :, t0:].to(buf.dtype)
    return out


def decode_tables(kbuf: torch.Tensor, vbuf: torch.Tensor, new_frames: int,
                  dtype) -> dict:
    """The decode-attention view of the ring, computed once per cache
    update: RoPE-rotated keys at absolute slot positions (pivot at
    `new_frames`), token-flattened keys/values and an additive slot-validity
    bias (0 or -inf)."""
    b, m, f, hw, c = kbuf.shape
    slot_pos = ring_slot_positions(new_frames, f, kbuf.device)
    cos_k, sin_k, scale_k = rope_tables(c, slot_pos, new_frames)
    kc = apply_rope(kbuf.to(dtype), cos_k, sin_k, 1.0 / scale_k)
    bias = torch.where(slot_pos >= 0, 0.0, float("-inf")).float()
    return {"kr": kc.reshape(b, m, f * hw, c),
            "vr": vbuf.to(dtype).reshape(b, m, f * hw, c),
            "bias": bias[:, None].expand(f, hw).reshape(f * hw)}


def _split_qkv(y: torch.Tensor, num_heads: int):
    y = einops.rearrange(y, "b t h w (s m c) -> s b m t (h w) c", s=3, m=num_heads)
    q, k, v = normalize(y, dim=-1).contiguous()  # per-head pixel norm
    return q, k, v


class VideoAttention(nn.Module):
    """Spatiotemporal self-attention over frames."""

    def __init__(self, channels: int, num_heads: int, attn_balance: float = 0.3,
                 max_frames: int = 64):
        super().__init__()
        self.channels = channels
        self.num_heads = num_heads
        self.attn_balance = attn_balance
        self.max_frames = max_frames
        self.attn_qkv = MPConv(channels, channels * 3, (1, 1))
        self.attn_proj = MPConv(channels, channels, (1, 1))

    def forward(self, x: torch.Tensor, cache=None, update_cache: bool = False,
                frames: int = 0, just_2d: bool = False, mode: str = "eval"):
        b, t, h, w = x.shape[:4]
        hw = h * w
        q, k, v = _split_qkv(self.attn_qkv(x), self.num_heads)
        if just_2d:
            o = dense_attention(q, k, v)  # (b, m, t) are batch dims
        elif mode == "train":
            o = self._train_attention(q, k, v, b, t, hw)
        else:
            o = self._eval_attention(q, k, v, cache, frames, b, t, hw)
            if update_cache:
                if cache is None:
                    shape = (b, self.num_heads, self.max_frames, hw, k.shape[-1])
                    kbuf = torch.zeros(shape, dtype=k.dtype, device=k.device)
                    vbuf = torch.zeros_like(kbuf)
                else:
                    kbuf, vbuf = cache["k"], cache["v"]
                kbuf = ring_write(kbuf, k, frames)
                vbuf = ring_write(vbuf, v, frames)
                cache = {"k": kbuf, "v": vbuf,
                         **decode_tables(kbuf, vbuf, frames + t, k.dtype)}
        y = einops.rearrange(o, "b m t (h w) c -> b t h w (m c)", h=h, w=w)
        y = self.attn_proj(y)
        return mp_sum(x, y, t=self.attn_balance), cache

    def _train_attention(self, q, k, v, b, t, hw):
        m, t_half = self.num_heads, t // 2
        pos = torch.arange(t_half, device=q.device)
        # the clean and noisy replicas share positions
        qs, ks = rope_qk(q.reshape(b, m, 2, t_half, hw, -1),
                         k.reshape(b, m, 2, t_half, hw, -1), pos, pos,
                         center=t_half // 2)
        mask = torch.as_tensor(expand_to_tokens(train_frame_mask(t_half), hw),
                               device=q.device)
        o = dense_attention(qs.reshape(b, m, t * hw, -1), ks.reshape(b, m, t * hw, -1),
                            v.reshape(b, m, t * hw, -1), mask)
        return o.reshape(b, m, t, hw, -1)

    def _eval_attention(self, q, k, v, cache, frames, b, t, hw):
        m = self.num_heads
        dev = q.device
        q_pos = frames + torch.arange(t, device=dev)
        if cache is not None and t == 1:
            # decode: two dots against the precomputed tables plus the
            # fresh frame's own keys, one joint fp32 softmax
            kr, vr, bias = cache["kr"], cache["vr"], cache["bias"]
            fhw = kr.shape[2]
            scale = 1.0 / math.sqrt(q.shape[-1])
            qr, kfr = rope_qk(q, k, q_pos, q_pos, center=frames)
            q0 = qr[:, :, 0].float()
            lc = torch.einsum("bmqc,bmkc->bmqk", q0, kr.to(k.dtype).float()) * scale
            lc = lc + bias
            lf = torch.einsum("bmqc,bmyc->bmqy", q0, kfr[:, :, 0].float()) * scale
            wts = torch.softmax(torch.cat([lc, lf], dim=-1), dim=-1).to(v.dtype).float()
            o = torch.einsum("bmqk,bmkc->bmqc", wts[..., :fhw], vr.to(v.dtype).float())
            o = o + torch.einsum("bmqy,bmyc->bmqc", wts[..., fhw:], v[:, :, 0].float())
            return o.to(v.dtype).reshape(b, m, t, hw, -1)
        if cache is None:
            # fresh prefill: frame-causal over the new frames only
            qr, kr = rope_qk(q, k, q_pos, q_pos, center=(frames + t) // 2)
            o = causal_frame_attention(qr.reshape(b, m, t * hw, -1),
                                       kr.reshape(b, m, t * hw, -1),
                                       v.reshape(b, m, t * hw, -1), t, hw)
        else:
            # warm prefill: the new frames over the whole ring after they
            # land, masked by slot position (the wrapped ring included)
            f = cache["k"].shape[2]
            kk = ring_write(cache["k"].to(k.dtype), k, frames)
            vv = ring_write(cache["v"].to(v.dtype), v, frames)
            k_pos = ring_slot_positions(frames + t, f, dev)
            qr, kr = rope_qk(q, kk, q_pos, k_pos, center=frames)
            o = prefill_cache_attention(qr.reshape(b, m, t * hw, -1),
                                        kr.reshape(b, m, f * hw, -1),
                                        vv.reshape(b, m, f * hw, -1),
                                        t, f, frames, hw)
        return o.reshape(b, m, t, hw, -1)


class FrameAttention(nn.Module):
    """Per-frame (spatial-only) self-attention; no mask, cache or RoPE."""

    def __init__(self, channels: int, num_heads: int, attn_balance: float = 0.3):
        super().__init__()
        self.num_heads = num_heads
        self.attn_balance = attn_balance
        self.attn_qkv = MPConv(channels, channels * 3, (1, 1))
        self.attn_proj = MPConv(channels, channels, (1, 1))

    def forward(self, x: torch.Tensor, cache=None, update_cache: bool = False,
                frames: int = 0, just_2d: bool = True, mode: str = "eval"):
        h, w = x.shape[2:4]
        q, k, v = _split_qkv(self.attn_qkv(x), self.num_heads)
        o = dense_attention(q, k, v)
        y = einops.rearrange(o, "b m t (h w) c -> b t h w (m c)", h=h, w=w)
        y = self.attn_proj(y)
        return mp_sum(x, y, t=self.attn_balance), cache
