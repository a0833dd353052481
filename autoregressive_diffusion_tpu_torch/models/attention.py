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
  * train mode is DART flash attention (ops/flash_attention.dart_attention)
    over the S = 2*T*hw tokens of the concat, the clean and noisy replicas
    sharing RoPE positions; under a sequence-parallel context
    (ops/flash_attention.set_sp_context) each seq rank's local concat
    attends the K/V of all ranks (dart_attention_sp), at the global RoPE
    positions of its frames; when the context's tp > 1 divides the heads
    (sp_head_shards, the JAX package's head_axis='model') each model rank
    runs its own num_heads / tp heads, [r m/tp, (r+1) m/tp): it keeps those
    heads' q, k, v of the gathered qkv, whose backward reduce-scatters over
    the model group (MPConv partial_use), and gathers the heads' outputs
    over the model group before attn_proj;
  * just_2d and FrameAttention are unmasked flash attention within each
    frame (ops/flash_attention.full_attention), frames folded into the
    batch.
On CUDA tensors these run the flash-attention kernels at every shape; the
TPU package's shape gates (flash_supported, full_flash_supported, b*t >= 16)
are TPU measurements and are not carried over.
The qkv channel split is (s m c), as in the JAX package. Under quant (the
int8 decode weights) the K/V rings are int8 at the JAX package's fixed 127
scale over [-1, 1] (_quant_kv); every read of a ring dequantizes it, and
the decode tables kr/vr stay in the body dtype. K and V are pixel-normed to
unit RMS per head, not unit norm, so about a third of their components lie
outside [-1, 1] and are clipped, in both packages (ROADMAP.md, Queue 3).
"""
from __future__ import annotations

import math

import einops
import torch
from torch import nn

from ..ops.flash_attention import (causal_frame_attention, dart_attention, dart_attention_sp,
                                   full_attention, prefill_cache_attention, sp_context,
                                   sp_flash_supported, sp_head_shards)
from ..ops.masks import ring_slot_position
from ..ops.numerics import mp_sum, normalize
from ..ops.rope import apply_rope, rope_qk, rope_tables
from ..parallel.collectives import gather_model
from ..utils.profiling import span
from .layers import MPConv


def _quant_kv(x: torch.Tensor) -> torch.Tensor:
    """K/V -> int8 at a fixed 127 scale; components outside [-1, 1] clip."""
    return torch.clamp(torch.round(x * 127.0), -127, 127).to(torch.int8)


def _dequant_kv(buf: torch.Tensor, dtype) -> torch.Tensor:
    """A ring in `dtype`: int8 times 1/127, the scale rounded to `dtype`
    as the JAX package rounds it; any other ring is a plain cast."""
    if buf.dtype == torch.int8:
        return buf.to(dtype) * torch.tensor(1.0 / 127.0, dtype=dtype).item()
    return buf.to(dtype)


def _to_cache_dtype(x: torch.Tensor, buf: torch.Tensor) -> torch.Tensor:
    return _quant_kv(x) if buf.dtype == torch.int8 else x.to(buf.dtype)


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
    update: dequantized, RoPE-rotated keys at absolute slot positions (pivot
    at `new_frames`), token-flattened keys/values and an additive
    slot-validity bias (0 or -inf)."""
    b, m, f, hw, c = kbuf.shape
    slot_pos = ring_slot_positions(new_frames, f, kbuf.device)
    cos_k, sin_k, scale_k = rope_tables(c, slot_pos, new_frames)
    kc = apply_rope(_dequant_kv(kbuf, dtype), cos_k, sin_k, 1.0 / scale_k)
    bias = torch.where(slot_pos >= 0, 0.0, float("-inf")).float()
    return {"kr": kc.reshape(b, m, f * hw, c),
            "vr": _dequant_kv(vbuf, dtype).reshape(b, m, f * hw, c),
            "bias": bias[:, None].expand(f, hw).reshape(f * hw)}


def _split_qkv(y: torch.Tensor, num_heads: int, heads: slice = slice(None)):
    """q, k, v (b, m, t, hw, c) of the heads `heads`, contiguous (the
    kernels refuse strided inputs); under the (s m c) split a set of heads
    is three strided column ranges of y, so the slice follows the rearrange."""
    y = einops.rearrange(y, "b t h w (s m c) -> s b m t (h w) c", s=3, m=num_heads)
    q, k, v = normalize(y[:, :, heads], dim=-1).contiguous()  # per-head pixel norm
    return q, k, v


def _per_frame_attention(q, k, v):
    """Unmasked attention within each frame of (b, m, t, hw, c) q, k, v:
    the frames fold into the kernel's batch, the heads stay its own."""
    t = q.shape[2]
    qf, kf, vf = (einops.rearrange(a, "b m t y c -> (b t) m y c") for a in (q, k, v))
    return einops.rearrange(full_attention(qf, kf, vf), "(b t) m y c -> b m t y c", t=t)


class VideoAttention(nn.Module):
    """Spatiotemporal self-attention over frames."""

    def __init__(self, channels: int, num_heads: int, attn_balance: float = 0.3,
                 max_frames: int = 64, quant: bool = False):
        super().__init__()
        self.channels = channels
        self.num_heads = num_heads
        self.attn_balance = attn_balance
        self.max_frames = max_frames
        self.quant = quant
        self.attn_qkv = MPConv(channels, channels * 3, (1, 1), quant)
        self.attn_proj = MPConv(channels, channels, (1, 1), quant)

    def forward(self, x: torch.Tensor, cache=None, update_cache: bool = False,
                frames: int = 0, just_2d: bool = False, mode: str = "eval"):
        """The layer inside a model.attention span (kind "video";
        ring_frames: the frames its ring holds when the call starts, 0
        without a cache), the ring write and decode tables included."""
        ring = 0 if cache is None else min(frames, self.max_frames)
        with span("model.attention", kind="video", ring_frames=ring):
            b, t, h, w = x.shape[:4]
            hw = h * w
            shards = sp_head_shards(self.num_heads) if mode == "train" and not just_2d else 1
            if shards == 1:
                q, k, v = _split_qkv(self.attn_qkv(x), self.num_heads)
            else:
                mesh = sp_context()
                m_l = self.num_heads // shards
                q, k, v = _split_qkv(self.attn_qkv(x, partial_use=mesh.model_group),
                                     self.num_heads, slice(mesh.model_rank * m_l,
                                                           (mesh.model_rank + 1) * m_l))
            if just_2d:
                o = _per_frame_attention(q, k, v)
            elif mode == "train":
                o = self._train_attention(q, k, v, b, t, hw, frames)
            else:
                o = self._eval_attention(q, k, v, cache, frames, b, t, hw)
                if update_cache:
                    if cache is None:
                        shape = (b, self.num_heads, self.max_frames, hw, k.shape[-1])
                        kbuf = torch.zeros(shape, dtype=torch.int8 if self.quant else k.dtype,
                                           device=k.device)
                        vbuf = torch.zeros_like(kbuf)
                    else:
                        kbuf, vbuf = cache["k"], cache["v"]
                    kbuf = ring_write(kbuf, _to_cache_dtype(k, kbuf), frames)
                    vbuf = ring_write(vbuf, _to_cache_dtype(v, vbuf), frames)
                    cache = {"k": kbuf, "v": vbuf,
                             **decode_tables(kbuf, vbuf, frames + t, k.dtype)}
            y = einops.rearrange(o, "b m t (h w) c -> b t h w (m c)", h=h, w=w)
            if shards > 1:
                # every model rank's heads, rank-major = the (m c) order. The
                # backward takes this rank's heads' slice, which is right because
                # the gradient arriving here is the same on every model rank:
                # attn_proj's input passes copy_to_model when its weight is split,
                # and everything after it is replicated when it is not.
                y = gather_model(y, sp_context().model_group)
            y = self.attn_proj(y)
            return mp_sum(x, y, t=self.attn_balance), cache

    def _train_attention(self, q, k, v, b, t, hw, frames):
        """DART attention over the concat of t = 2 t_half frames, at clip
        positions frames + [0, t_half): frames = 0, or this seq rank's
        offset when the clip's T = sp * t_half frames are split over ranks."""
        m, t_half = q.shape[1], t // 2  # this model rank's heads
        sp = sp_flash_supported(t_half)
        n_frames = t_half * (sp_context().sp if sp else 1)
        pos = frames + torch.arange(t_half, device=q.device)
        # the clean and noisy replicas share positions
        qs, ks = rope_qk(q.reshape(b, m, 2, t_half, hw, -1),
                         k.reshape(b, m, 2, t_half, hw, -1), pos, pos,
                         center=n_frames // 2)
        qs, ks, vs = (a.reshape(b, m, t * hw, -1) for a in (qs, ks, v))
        if sp:
            o = dart_attention_sp(qs, ks, vs, n_frames, hw, sp_context().seq_group)
        else:
            o = dart_attention(qs, ks, vs, n_frames, hw)
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
            kk = ring_write(_dequant_kv(cache["k"], k.dtype), k, frames)
            vv = ring_write(_dequant_kv(cache["v"], v.dtype), v, frames)
            k_pos = ring_slot_positions(frames + t, f, dev)
            qr, kr = rope_qk(q, kk, q_pos, k_pos, center=frames)
            o = prefill_cache_attention(qr.reshape(b, m, t * hw, -1),
                                        kr.reshape(b, m, f * hw, -1),
                                        vv.reshape(b, m, f * hw, -1),
                                        t, f, frames, hw)
        return o.reshape(b, m, t, hw, -1)


class FrameAttention(nn.Module):
    """Per-frame (spatial-only) self-attention; no mask, cache or RoPE."""

    def __init__(self, channels: int, num_heads: int, attn_balance: float = 0.3,
                 quant: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.attn_balance = attn_balance
        self.attn_qkv = MPConv(channels, channels * 3, (1, 1), quant)
        self.attn_proj = MPConv(channels, channels, (1, 1), quant)

    def forward(self, x: torch.Tensor, cache=None, update_cache: bool = False,
                frames: int = 0, just_2d: bool = True, mode: str = "eval"):
        with span("model.attention", kind="frame", ring_frames=0):
            h, w = x.shape[2:4]
            q, k, v = _split_qkv(self.attn_qkv(x), self.num_heads)
            o = _per_frame_attention(q, k, v)
            y = einops.rearrange(o, "b m t (h w) c -> b t h w (m c)", h=h, w=w)
            y = self.attn_proj(y)
            return mp_sum(x, y, t=self.attn_balance), cache
