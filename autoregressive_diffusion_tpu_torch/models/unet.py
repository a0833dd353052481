"""EDM2 magnitude-preserving UNet denoiser + preconditioner.

Counterpart of autoregressive_diffusion_tpu/models/unet.py with the same
module names (so the weight bridge is a rename), channels-last videos
(B, T, H, W, C) and the same cache pytree (nested dicts of tensors; the
frame counter is a host int, since eager PyTorch has no static/traced
split). Blocks follow the JAX package's unfused semantics. In eval mode the
T=1 cached decode step of every attention-free Block, and the T=1 just_2d
step, run the fused decode Block (ops/fused_conv.py). In train mode (x is
the DART concat of clean and noisy frames, or plain frames with just_2d)
every causal conv runs the fused gated conv with its input transform
folded in, and video attention is DART flash attention. Under a
sequence-parallel context (ops/flash_attention.set_sp_context) x holds one
seq rank's frames, and the rank's frame offset in the clip reaches every
Block as `frames`, so gates and RoPE see global positions. The TPU
packed-chain planner and its lane layout are not carried over.

Train-mode dropout (cfg.dropout > 0) sits between a Block's two convs, as in
the original: conv_res0 stays fused, then y * c, mp_silu and the dropout run
in torch, and conv_res1 runs the fused conv with no input transform. Its
keep masks come from the explicit generator the caller passes
(`dropout_generator`); UNet.dropout_mask draws them, one per Block, before
the Block runs. cfg.remat runs every Block of a train-mode call under
torch.utils.checkpoint (JAX's nn.remat(Block)): its activations are
recomputed in the backward, the conv and attention kernels launched again,
and the recomputed Block reads the mask drawn before it, so the gradients
equal the plain ones. cfg.decode_quant serves int8 decode weights (every
MPConv and MPCausalConv3d, models/layers.py) and int8 K/V rings, in eval
mode only. A model sharded by parallel.shard_train_state (tensor
parallelism, FSDP: models/layers.py) trains only; eval mode raises.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.flash_attention import sp_context
from ..ops.fused_conv import fused_decode_block
from ..ops.numerics import mp_cat, mp_fourier, mp_silu, mp_sum, normalize, resample
from ..utils.profiling import span
from .attention import FrameAttention, VideoAttention
from .layers import Gating, MPConv, MPCausalConv3d


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Knob set of the JAX package's UNetConfig (models/unet.py:34-125)."""
    img_resolution: int
    img_channels: int
    label_dim: int = 0
    model_channels: int = 128
    channel_mult: Tuple[int, ...] = (1, 2, 2, 4)
    channel_mult_noise: Optional[int] = None
    channel_mult_emb: Optional[int] = None
    num_blocks: int = 3
    video_attn_resolutions: Tuple[int, ...] = (8,)
    frame_attn_resolutions: Tuple[int, ...] = (16,)
    label_balance: float = 0.5
    concat_balance: float = 0.5
    channels_per_head: int = 64
    res_balance: float = 0.3
    attn_balance: float = 0.3
    clip_act: float = 256.0
    dropout: float = 0.0
    max_frames: int = 64
    remat: bool = False         # recompute each Block in the backward (train mode)
    decode_quant: bool = False  # int8 decode weights and K/V (train/quantize.py)

    @property
    def cblock(self):
        return [self.model_channels * m for m in self.channel_mult]

    @property
    def cnoise(self):
        return (self.model_channels * self.channel_mult_noise
                if self.channel_mult_noise is not None else self.cblock[0])

    @property
    def cemb(self):
        return (self.model_channels * self.channel_mult_emb
                if self.channel_mult_emb is not None else max(self.cblock))

    def block_layout(self):
        """[(side, name, spec)] in execution order: 'enc' | 'dec' | 'out',
        spec = dict(cin, cout, res, kind, [flavor, resample, attention])."""
        out = []
        cout = self.img_channels + 1
        for level, channels in enumerate(self.cblock):
            res = self.img_resolution >> level
            if level == 0:
                cin, cout = cout, channels
                out.append(("enc", f"{res}x{res}_conv",
                            dict(cin=cin, cout=cout, res=res, kind="conv")))
            else:
                out.append(("enc", f"{res}x{res}_down",
                            dict(cin=cout, cout=cout, res=res, kind="block",
                                 flavor="enc", resample="down", attention=None)))
            for idx in range(self.num_blocks):
                cin, cout = cout, channels
                out.append(("enc", f"{res}x{res}_block{idx}",
                            dict(cin=cin, cout=cout, res=res, kind="block",
                                 flavor="enc", resample="keep",
                                 attention=self._attn(res))))
        skips = [spec["cout"] for (_, _, spec) in out]
        for level, channels in reversed(list(enumerate(self.cblock))):
            res = self.img_resolution >> level
            if level == len(self.cblock) - 1:
                out.append(("dec", f"{res}x{res}_in0",
                            dict(cin=cout, cout=cout, res=res, kind="block",
                                 flavor="dec", resample="keep", attention="video")))
                out.append(("dec", f"{res}x{res}_in1",
                            dict(cin=cout, cout=cout, res=res, kind="block",
                                 flavor="dec", resample="keep", attention=None)))
            else:
                out.append(("dec", f"{res}x{res}_up",
                            dict(cin=cout, cout=cout, res=res, kind="block",
                                 flavor="dec", resample="up", attention=None)))
            for idx in range(self.num_blocks + 1):
                cin = cout + skips.pop()
                cout = channels
                out.append(("dec", f"{res}x{res}_block{idx}",
                            dict(cin=cin, cout=cout, res=res, kind="block",
                                 flavor="dec", resample="keep",
                                 attention=self._attn(res))))
        out.append(("out", "out_conv",
                    dict(cin=cout, cout=self.img_channels, res=self.img_resolution,
                         kind="conv")))
        return out

    def _attn(self, res):
        return ("video" if res in self.video_attn_resolutions else
                "frame" if res in self.frame_attn_resolutions else None)

    def num_heads(self, spec) -> int:
        return spec["cout"] // self.channels_per_head if spec.get("attention") else 0


class MPFourier(nn.Module):
    """Random Fourier features; freqs/phases are fixed buffers."""

    def __init__(self, num_channels: int):
        super().__init__()
        self.register_buffer("freqs", torch.empty(num_channels))
        self.register_buffer("phases", torch.empty(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mp_fourier(x, self.freqs, self.phases)


class Block(nn.Module):
    """UNet residual block (JAX package models/unet.py:149-377)."""

    def __init__(self, in_channels: int, out_channels: int, emb_channels: int,
                 flavor: str = "enc", resample_mode: str = "keep",
                 attention: Optional[str] = None, channels_per_head: int = 64,
                 res_balance: float = 0.3, attn_balance: float = 0.3,
                 clip_act: Optional[float] = 256.0, max_frames: int = 64,
                 quant: bool = False, dropout: float = 0.0):
        super().__init__()
        self.out_channels = out_channels
        self.dropout = dropout
        self.flavor = flavor
        self.resample_mode = resample_mode
        self.attention = attention
        self.res_balance = res_balance
        self.clip_act = clip_act
        self.emb_gain = nn.Parameter(torch.zeros(()))
        self.emb_linear = MPConv(emb_channels, out_channels, quant=quant)
        c0_in = out_channels if flavor == "enc" else in_channels
        self.conv_res0 = MPCausalConv3d(c0_in, out_channels, quant=quant)
        self.conv_res1 = MPCausalConv3d(out_channels, out_channels, quant=quant)
        if in_channels != out_channels:
            self.conv_skip = MPConv(in_channels, out_channels, (1, 1), quant)
        num_heads = out_channels // channels_per_head if attention else 0
        if attention == "video" and num_heads:
            self.attn = VideoAttention(out_channels, num_heads, attn_balance, max_frames,
                                       quant)
        elif attention == "frame" and num_heads:
            self.attn = FrameAttention(out_channels, num_heads, attn_balance, quant)

    def forward(self, x, emb, c_noise, frames: int = 0, cache=None,
                update_cache: bool = False, just_2d: bool = False,
                mode: str = "eval", dropout_mask: Optional[torch.Tensor] = None):
        """dropout_mask: the train-mode keep mask (B, F, res, res, Co) of a
        Block with dropout > 0 (UNet.dropout_mask)."""
        cache = cache or {}
        in_channels = x.shape[-1]
        x = resample(x, mode=self.resample_mode)
        c = self.emb_linear(emb, gain=self.emb_gain) + 1  # (B, T, Co), emb's type
        if mode == "train":
            return self._train(x, c, c_noise, frames, just_2d, in_channels,
                               dropout_mask), cache
        cache0, cache1 = cache.get("conv_res0"), cache.get("conv_res1")
        if (self.attention is None and x.shape[1] == 1
                and (just_2d or (cache0 is not None and cache1 is not None))):
            return self._fused_decode(x, c, c_noise, frames, cache0, cache1,
                                      update_cache, just_2d)

        if self.flavor == "enc":
            if in_channels != self.out_channels:
                x = self.conv_skip(x)
            x = normalize(x, dim=-1)  # pixel norm
        y, c0 = self.conv_res0(mp_silu(x), c_noise, frames, cache0, update_cache, just_2d)
        y = y * c[:, :, None, None, :].to(y.dtype)
        y = mp_silu(y)
        y, c1 = self.conv_res1(y, c_noise, frames, cache1, update_cache, just_2d)
        if self.flavor == "dec" and in_channels != self.out_channels:
            x = self.conv_skip(x)
        x = mp_sum(x, y, t=self.res_balance)

        attn_cache = cache.get("attn")
        if hasattr(self, "attn"):
            x, attn_cache = self.attn(x, attn_cache, update_cache, frames, just_2d)
        if self.clip_act is not None:
            x = torch.clamp(x, -self.clip_act, self.clip_act)
        new_cache = dict(conv_res0=c0, conv_res1=c1)
        if attn_cache is not None:
            new_cache["attn"] = attn_cache
        return x, new_cache

    def _train(self, x, c, c_noise, frames, just_2d, in_channels, dropout_mask):
        """Train mode: mp_silu and the modulation by c run inside the fused
        convs (silu_in, cvec); with dropout they run in torch before it, and
        conv_res1 takes the dropped activations as they are (flax's
        nn.Dropout: kept values / keep, the rest 0)."""
        if self.flavor == "enc":
            if in_channels != self.out_channels:
                x = self.conv_skip(x)
            x = normalize(x, dim=-1)  # pixel norm
        y, _ = self.conv_res0(x, c_noise, frames, just_2d=just_2d, mode="train",
                              silu_in=True)
        if self.dropout > 0:
            if dropout_mask is None:
                raise ValueError("a Block with dropout needs its keep mask in train mode")
            y = mp_silu(y * c[:, :, None, None, :].to(y.dtype))
            y = torch.where(dropout_mask, y / (1.0 - self.dropout), 0.0)
            y, _ = self.conv_res1(y, c_noise, frames, just_2d=just_2d, mode="train")
        else:
            y, _ = self.conv_res1(y, c_noise, frames, just_2d=just_2d, mode="train",
                                  silu_in=True, cvec=c)
        if self.flavor == "dec" and in_channels != self.out_channels:
            x = self.conv_skip(x)
        x = mp_sum(x, y, t=self.res_balance)
        if hasattr(self, "attn"):
            x, _ = self.attn(x, None, False, frames, just_2d, mode="train")
        if self.clip_act is not None:
            x = torch.clamp(x, -self.clip_act, self.clip_act)
        return x

    def _fused_decode(self, x, c, c_noise, frames, cache0, cache1, update_cache,
                      just_2d):
        """The attention-free Block's T=1 step as one fused-Block call."""
        dt = x.dtype
        w20, w30, g0 = self.conv_res0.decode_weights(dt, c_noise, frames)
        w21, w31, g1 = self.conv_res1.decode_weights(dt, c_noise, frames)
        wsk = self.conv_skip.weight(dt)[0, 0] if hasattr(self, "conv_skip") else None
        a0 = a1 = None
        if not just_2d:
            a0, a1 = cache0["act"].to(dt), cache1["act"].to(dt)
        gates = torch.stack([g0[:, 0], g1[:, 0]], dim=1).float()
        y, t0, t1 = fused_decode_block(
            x.contiguous(), a0, a1, wsk, w20, w30, w21, w31,
            c[:, 0].to(dt).contiguous(), gates, self.flavor, self.res_balance,
            self.clip_act, not just_2d)
        if update_cache and not just_2d:
            cache0 = {"act": torch.cat([a0[:, 1:], t0], dim=1)}
            cache1 = {"act": torch.cat([a1[:, 1:], t1], dim=1)}
        return y, dict(conv_res0=cache0, conv_res1=cache1)


def _spanned_block(label, mod, x, emb, c_noise, frames, sub, update_cache, just_2d, mode,
                   mask):
    """Block `mod` (UNet attribute `label`) inside its model.block span."""
    with span("model.block", name=label):
        return mod(x, emb, c_noise, frames, sub, update_cache, just_2d, mode=mode,
                   dropout_mask=mask)


class UNet(nn.Module):
    """Encoder/decoder (JAX package models/unet.py:380-569)."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        self.sharded = False  # set by parallel.shard_train_state
        self.out_gain = nn.Parameter(torch.zeros(()))
        self.out_res = Gating()  # frame bookkeeping only; kept for parameter parity
        self.emb_fourier_sigma = MPFourier(cfg.cnoise)
        quant = cfg.decode_quant
        self.emb_noise = MPConv(cfg.cnoise, cfg.cemb, quant=quant)
        if cfg.label_dim:
            self.emb_label = MPConv(cfg.label_dim, cfg.cemb, quant=quant)
        self.layout = cfg.block_layout()
        for side, name, spec in self.layout:
            if spec["kind"] == "conv":
                mod = MPCausalConv3d(spec["cin"], spec["cout"], quant=quant)
            else:
                mod = Block(spec["cin"], spec["cout"], cfg.cemb, flavor=spec["flavor"],
                            resample_mode=spec["resample"], attention=spec["attention"],
                            channels_per_head=cfg.channels_per_head,
                            res_balance=cfg.res_balance, attn_balance=cfg.attn_balance,
                            clip_act=cfg.clip_act, max_frames=cfg.max_frames,
                            quant=quant, dropout=cfg.dropout)
            self.add_module(name if side == "out" else f"{side}_{name}", mod)

    def dropout_mask(self, name: str, shape, device,
                     generator: torch.Generator) -> torch.Tensor:
        """The keep mask of Block `name` (enc_8x8_block0, ...): True with
        probability 1 - cfg.dropout, drawn from `generator`. The hook tests
        replace to inject masks."""
        return torch.rand(shape, generator=generator, device=device) < 1.0 - self.cfg.dropout

    def forward(self, x, c_noise, conditioning=None, cache=None,
                update_cache: bool = False, just_2d: bool = False,
                mode: str = "eval", dropout_generator: Optional[torch.Generator] = None):
        cfg = self.cfg
        if mode not in ("eval", "train"):
            raise ValueError(f"unknown mode {mode!r}")
        drop = mode == "train" and cfg.dropout > 0.0
        if drop and dropout_generator is None:
            raise ValueError("train mode with dropout > 0 draws its masks from an explicit "
                             "generator: pass dropout_generator")
        if mode != "train" and self.sharded:
            raise ValueError("a model sharded for training serves no eval call: build one from "
                             "parallel.gather_to_host's weights")
        if mode == "train" and cfg.decode_quant:
            raise ValueError("int8 weights are a decode-only path: train with "
                             "decode_quant=False")
        cache = cache or {}
        t = x.shape[1]
        frames = int(cache.get("frames", 0))
        mesh = sp_context()
        if mode == "train" and not just_2d and mesh is not None:
            frames = mesh.seq_rank * (t // 2)  # this rank's first frame in the clip

        emb = self.emb_noise(self.emb_fourier_sigma(c_noise))
        if cfg.label_dim and conditioning is not None:
            one_hot = F.one_hot(conditioning.long(), cfg.label_dim).to(c_noise.dtype)
            lab = self.emb_label(one_hot * math.sqrt(cfg.label_dim))
            emb = mp_sum(emb, lab, t=1 / 3)
        emb = mp_silu(emb)

        x = torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)
        new_cache = {"frames": frames + t if update_cache else frames,
                     "enc": {}, "dec": {}}
        skips = []
        for side, name, spec in self.layout:
            if side == "out":
                with span("model.block", name="out_conv"):
                    x, new_cache["out_conv"] = self.out_conv(
                        x, c_noise, frames, cache.get("out_conv"), update_cache, just_2d,
                        mode=mode)
                continue
            label = f"{side}_{name}"
            mod = getattr(self, label)
            sub = cache.get(side, {}).get(name)
            if side == "dec" and "block" in name:
                x = mp_cat(x, skips.pop(), t=cfg.concat_balance)
            if spec["kind"] == "conv":
                with span("model.block", name=label):
                    x, c = mod(x, c_noise, frames, sub, update_cache, just_2d, mode=mode)
            else:
                mask = None
                if drop:
                    shape = (x.shape[0], x.shape[1], spec["res"], spec["res"], spec["cout"])
                    mask = self.dropout_mask(label, shape, x.device, dropout_generator)
                if mode == "train" and cfg.remat:
                    # the Block draws no random numbers (its mask is drawn
                    # above), so there is no RNG state to restore; its span
                    # is inside the checkpointed function, so the recompute
                    # records one too
                    x, c = checkpoint(_spanned_block, label, mod, x, emb, c_noise, frames,
                                      sub, update_cache, just_2d, mode, mask,
                                      use_reentrant=False, preserve_rng_state=False)
                else:
                    x, c = _spanned_block(label, mod, x, emb, c_noise, frames, sub,
                                          update_cache, just_2d, mode, mask)
            new_cache[side][name] = c
            if side == "enc":
                skips.append(x)
        return x.float() * self.out_gain, new_cache  # fp32, as JAX promotes


class Precond(nn.Module):
    """EDM preconditioner: c_skip = sd^2/(s^2+sd^2), c_out = s*sd/sqrt(s^2+sd^2),
    c_in = 1/sqrt(sd^2+s^2), c_noise = log(s)/4. The body runs in
    `body_dtype`; the preconditioning stays fp32. Each call is a model.call
    span (utils/profiling.span) whose `mode` is "cached" (one frame against
    a cache), "prefill" (any other eval call) or "train"."""

    def __init__(self, cfg: UNetConfig, sigma_data: float = 0.5,
                 body_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.sigma_data = sigma_data
        self.body_dtype = body_dtype
        self.unet = UNet(cfg)

    def forward(self, x, sigma, conditioning=None, cache=None,
                update_cache: bool = False, mode: str = "eval",
                just_2d: bool = False,
                dropout_generator: Optional[torch.Generator] = None):
        call = ("train" if mode == "train" else
                "cached" if cache is not None and x.shape[1] == 1 else "prefill")
        with span("model.call", mode=call, update_cache=update_cache):
            x = x.float()
            sigma = sigma.float()
            s = sigma[:, :, None, None, None]
            sd = self.sigma_data
            c_skip = sd ** 2 / (s ** 2 + sd ** 2)
            c_out = s * sd / torch.sqrt(s ** 2 + sd ** 2)
            c_in = 1 / torch.sqrt(sd ** 2 + s ** 2)
            c_noise = torch.log(sigma) / 4
            f_x, cache = self.unet((c_in * x).to(self.body_dtype), c_noise, conditioning,
                                   cache, update_cache, just_2d, mode, dropout_generator)
            return c_skip * x + c_out * f_x.float(), cache


@torch.no_grad()
def init_weights(model: nn.Module, seed: int, gains: float = 1.0) -> nn.Module:
    """Seeded random weights with the JAX package's init distributions: raw
    weights N(0, 1), Fourier freqs 2*pi*N(0, 1) and phases 2*pi*U[0, 1),
    gating offsets 0, mults (1.5, -0.5), min/max gating -5 -- except the
    emb_gain and out_gain scalars, which are `gains`: 1 by default where the
    JAX init has 0, since a zero out_gain hides the UNet body from the
    output and a random model is only a useful check when its output
    depends on every layer; gains=0 is the JAX init, from which training
    starts."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("emb_gain", "out_gain"):
            v = torch.full(p.shape, float(gains))
        elif leaf == "offset":
            v = torch.zeros(p.shape)
        elif leaf == "mult":
            v = torch.tensor([1.5, -0.5])
        elif leaf in ("max_gating", "min_gating"):
            v = torch.full(p.shape, -5.0)
        else:
            v = torch.randn(p.shape, generator=g)
        p.copy_(v)
    for name, buf in model.named_buffers():
        if name.endswith("freqs"):
            buf.copy_(2 * math.pi * torch.randn(buf.shape, generator=g))
        elif name.endswith("phases"):
            buf.copy_(2 * math.pi * torch.rand(buf.shape, generator=g))
    return model
