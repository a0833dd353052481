"""The plain reference that decides `correct`: the denoiser, its sampler and its training step.

Plain PyTorch, float32, written from the model's equations (EDM2's
magnitude-preserving layers, the gated causal 3D conv, RoPE/xPos frame
attention over a ring of past frames, the EDM preconditioner and Heun
sampler, the DART loss, AdamW behind a global-norm clip, the forced
weight norm and the power-function EMA). It imports nothing of the
program and takes no tensor the program made: its weights are the
benchmark's seeded weights (`init_params`), its inputs the benchmark's.

Every product (conv, dense, attention) passes its operands through
`Ref.rnd`: the identity for float32 (TF32 off), and for the control a
rounding to a lower precision (`fp8_round`: float8 e4m3 with a per-tensor
scale), whose gradient passes straight through.

Layouts are channels-last, videos (B, T, H, W, C); weight names and
shapes are the program's state-dict names (`param_shapes`).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from perf_bench.spec import cemb, cnoise, full, heads, layout

# ---------------------------------------------------------------------------
# Weights


def param_shapes(cfg) -> dict:
    """{state-dict name: shape} of the denoiser (Precond) for cfg, parameters
    and buffers, in the program's naming."""
    cfg = full(cfg)
    out = {"unet.out_gain": (), **_gating("unet.out_res"),
           "unet.emb_fourier_sigma.freqs": (cnoise(cfg),),
           "unet.emb_fourier_sigma.phases": (cnoise(cfg),),
           "unet.emb_noise.w": (cnoise(cfg), cemb(cfg))}
    if cfg["label_dim"]:
        out["unet.emb_label.w"] = (cfg["label_dim"], cemb(cfg))

    def conv3(p, cin, co):
        out[f"{p}.last_frame_conv.w"] = (3, 3, cin, co)
        out[f"{p}.w"] = (2, 3, 3, cin, co)
        out.update(_gating(f"{p}.gating"))

    for side, name, spec in layout(cfg):
        p = "unet." + (name if side == "out" else f"{side}_{name}")
        cin, co = spec["cin"], spec["cout"]
        if spec["kind"] == "conv":
            conv3(p, cin, co)
            continue
        out[f"{p}.emb_gain"] = ()
        out[f"{p}.emb_linear.w"] = (cemb(cfg), co)
        conv3(f"{p}.conv_res0", co if spec["flavor"] == "enc" else cin, co)
        conv3(f"{p}.conv_res1", co, co)
        if cin != co:
            out[f"{p}.conv_skip.w"] = (1, 1, cin, co)
        if heads(cfg, spec):
            out[f"{p}.attn.attn_qkv.w"] = (1, 1, co, 3 * co)
            out[f"{p}.attn.attn_proj.w"] = (1, 1, co, co)
    return out


def _gating(p):
    return {f"{p}.offset": (2,), f"{p}.mult": (2,), f"{p}.max_gating": (),
            f"{p}.min_gating": ()}


def init_params(cfg, seed: int, device, gains: float = 1.0) -> dict:
    """Seeded float32 weights on `device`, in a few large draws: every raw
    weight `w` normal, then normalized per output channel to unit RMS (as
    training's forced weight norm keeps them); Fourier frequencies 2 pi N(0,
    1), phases 2 pi U[0, 1); gating offsets 0, mults (1.5, -0.5), min/max
    gating -5; the emb_gain and out_gain scalars `gains`."""
    shapes = param_shapes(cfg)
    g = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    ws = [n for n in shapes if n.endswith(".w")]
    flat = torch.randn(sum(math.prod(shapes[n]) for n in ws), generator=g, device=device)
    out, at = {}, 0
    for n in ws:
        k = math.prod(shapes[n])
        out[n] = normalize(flat[at:at + k].view(shapes[n]), dims=tuple(range(len(shapes[n]) - 1)))
        at += k
    del flat
    nf = shapes["unet.emb_fourier_sigma.freqs"][0]
    out["unet.emb_fourier_sigma.freqs"] = 2 * math.pi * torch.randn(nf, generator=g, device=device)
    out["unet.emb_fourier_sigma.phases"] = 2 * math.pi * torch.rand(nf, generator=g, device=device)
    for n, s in shapes.items():
        leaf = n.rsplit(".", 1)[-1]
        if n in out:
            continue
        if leaf in ("emb_gain", "out_gain"):
            out[n] = torch.full(s, float(gains), device=device)
        elif leaf == "offset":
            out[n] = torch.zeros(s, device=device)
        elif leaf == "mult":
            out[n] = torch.tensor([1.5, -0.5], device=device)
        else:  # max_gating, min_gating
            out[n] = torch.full(s, -5.0, device=device)
    return {n: out[n] for n in shapes}


# ---------------------------------------------------------------------------
# Magnitude-preserving numerics (EDM2)


def normalize(x, dims=(-1,), eps: float = 1e-4):
    """x / (eps + ||x||_dims / sqrt(prod of the reduced sizes))."""
    n = torch.sqrt(torch.sum(x * x, dim=dims, keepdim=True) + 1e-24)
    reduced = math.prod(x.shape[d] for d in dims)
    return x / (eps + n / math.sqrt(reduced))


def mp_silu(x):
    return F.silu(x) / 0.596


def mp_sum(a, b, t):
    return (a + (b - a) * t) / math.sqrt((1 - t) ** 2 + t ** 2)


def mp_cat(a, b, t):
    na, nb = a.shape[-1], b.shape[-1]
    c = math.sqrt((na + nb) / ((1 - t) ** 2 + t ** 2))
    return torch.cat([a * (c / math.sqrt(na) * (1 - t)), b * (c / math.sqrt(nb) * t)], dim=-1)


def mp_weight(w, gain=1.0):
    dims = tuple(range(w.ndim - 1))
    return normalize(w, dims) * (gain / math.sqrt(math.prod(w.shape[:-1])))


def resample(x, mode):
    if mode == "keep":
        return x
    b, t, h, w, c = x.shape
    if mode == "down":
        return x.reshape(b, t, h // 2, 2, w // 2, 2, c).mean(dim=(3, 5))
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def fp8_round(x):
    """x rounded to float8 e4m3 under a per-tensor scale (its largest
    magnitude at 448); the gradient passes straight through."""
    s = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    q = (x.detach() / s).to(torch.float8_e4m3fn).float() * s
    return x + (q - x).detach()


def rope(x, pos, center, base: float = 64.0):
    """xPos-scaled rotary embedding of x (..., T, HW, C) at frame positions
    pos (T,): cos/sin over the channel pairs, scaled by
    ((2i + 0.4 C) / 1.4 C) ** ((pos - center) / 64) for queries (sign +1)."""
    c = x.shape[-1]
    half = torch.arange(0, c, 2, dtype=torch.float64, device=x.device)
    inv = (1.0 / 10000.0 ** (half / c)).float()
    p = pos.float()
    fr = p[:, None] * inv[None, :]
    fr = torch.cat([fr, fr], -1)
    sv = ((half + 0.4 * c) / (1.4 * c)).float()
    sc = torch.exp(((p - float(center)) / base)[:, None] * torch.log(sv)[None, :])
    sc = torch.cat([sc, sc], -1)
    x1, x2 = x.chunk(2, -1)
    rot = torch.cat([-x2, x1], -1)
    cos, sin, sc = (a[:, None, :] for a in (torch.cos(fr), torch.sin(fr), sc))
    return (x * cos + rot * sin), sc


def rope_q(x, pos, center):
    y, sc = rope(x, pos, center)
    return y * sc


def rope_k(x, pos, center):
    y, sc = rope(x, pos, center)
    return y / sc


def ring_positions(end: int, capacity: int, device):
    """Absolute frame held by each ring slot once frames [0, end) were
    written (negative: never written)."""
    s = torch.arange(capacity, device=device)
    return end - 1 - torch.remainder(end - 1 - s, capacity)


def dart_visible(n_frames, device):
    """(2T, 2T) DART frame mask: clean query i sees clean frames <= i,
    noisy query T + i sees clean frames < i and itself."""
    t = n_frames
    q = torch.arange(2 * t, device=device)[:, None]
    k = torch.arange(2 * t, device=device)[None, :]
    cq, ck = q < t, k < t
    return (cq & ck & (k <= q)) | (~cq & ck & (k < q - t)) | (~cq & ~ck & (q == k))


def std_to_exp(std: float) -> float:
    """The power-function EMA's exponent for a relative std (EDM2 Eq. 126)."""
    return float(np.roots([1, 7, 16 - std ** -2, 12 - std ** -2]).real.max())


def karras_steps(num_steps, sigma_min, sigma_max, rho):
    i = np.arange(num_steps, dtype=np.float64)
    t = (sigma_max ** (1 / rho)
         + i / (num_steps - 1) * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))) ** rho
    return np.concatenate([t, [0.0]]).astype(np.float32)


# ---------------------------------------------------------------------------
# The denoiser


class Ref:
    """The denoiser on float32 weights `params` ({name: tensor}), eval
    (cached) and train mode. `rnd` rounds every product's operands (None:
    float32). A cache is {"frames": int, name: layer state}: a conv's
    state is its last two input frames (ones before the first frame), a
    video attention layer's its K and V rings (unrotated, max_frames slots)."""

    def __init__(self, cfg, params: dict, rnd: Optional[Callable] = None):
        self.cfg = full(cfg)
        self.p = params
        self.rnd = rnd or (lambda x: x)
        self.layout = layout(self.cfg)

    # products
    def w(self, name, gain=1.0):
        return self.rnd(mp_weight(self.p[name], gain))

    def dense(self, x, name, gain=1.0):
        w = self.w(name, gain)
        return self.rnd(x) @ w.reshape(-1, w.shape[-1])

    def conv2d(self, x, w):
        """Same-padded 3x3 conv of (..., H, W, C) with an HWIO weight."""
        lead, (h, wd, c) = x.shape[:-3], x.shape[-3:]
        y = F.conv2d(self.rnd(x).reshape(-1, h, wd, c).permute(0, 3, 1, 2),
                     w.permute(3, 2, 0, 1), padding=1)
        return y.permute(0, 2, 3, 1).reshape(*lead, h, wd, -1)

    def attend(self, q, k, v, mask):
        """softmax(q k^T / sqrt(d) + mask) v over the last two axes."""
        s = torch.einsum("...qc,...kc->...qk", self.rnd(q), self.rnd(k)) / math.sqrt(q.shape[-1])
        s = s.masked_fill(~mask, float("-inf"))
        return torch.einsum("...qk,...kc->...qc", torch.softmax(s, -1), self.rnd(v))

    def gate(self, p, c_noise, frames, t_dim):
        """Per-(sample, frame) gate of the conv `p`: positions
        log1p(frame index mod t_dim + frames)."""
        b, f = c_noise.shape
        pos = (torch.arange(f, device=c_noise.device) % t_dim) + frames
        pos = torch.log1p(pos.float())[None].expand(b, f)
        mult, off = self.p[f"{p}.gating.mult"], self.p[f"{p}.gating.offset"]
        state = c_noise * mult[0] + off[0] + pos * mult[1] + off[1]
        mn = torch.sigmoid(self.p[f"{p}.gating.min_gating"])
        mx = torch.sigmoid(self.p[f"{p}.gating.max_gating"])
        return mn + (1 - mn) * mx * torch.sigmoid(state)

    def causal_conv(self, p, a, c_noise, frames, state, just_2d, train):
        """The gated causal conv of transformed input a (B, F, H, W, C):
        3x3 on each frame, blended by the gate with a 2x3x3 conv over the
        two frames before. Eval: the frames before come from `state` (the
        last two inputs, updated); train: a is the DART concat, the clean
        half's context (ones before the clip) serves both halves.
        Returns (y, new state)."""
        y2d = self.conv2d(a, self.w(f"{p}.last_frame_conv.w"))
        if just_2d:
            return y2d, state
        w3 = self.w(f"{p}.w")
        b, f = a.shape[:2]
        if train:
            t = f // 2
            hist = torch.cat([torch.ones_like(a[:, :2]), a[:, :t - 1]], 1)
            ctx = self.conv2d(hist[:, :t], w3[0]) + self.conv2d(hist[:, 1:t + 1], w3[1])
            ctx = torch.cat([ctx, ctx], 1)
            g = self.gate(p, c_noise, frames, t)
        else:
            ring = torch.cat([state, a], 1)
            ctx = self.conv2d(ring[:, :f], w3[0]) + self.conv2d(ring[:, 1:f + 1], w3[1])
            state = ring[:, -2:]
            g = self.gate(p, c_noise, frames, f)
        g = g[:, :, None, None, None]
        return (y2d + (ctx - y2d) * g) / torch.sqrt((1 - g) ** 2 + g ** 2), state

    def video_attention(self, p, x, frames, kv, train, just_2d):
        """Spatiotemporal attention. Eval, t = 1 (decode): the frame's
        queries over the ring's written slots and its own keys, then the
        frame written; eval, t > 1 (prefill): the frames written first,
        then each query frame over the slots holding frames up to its own;
        train: the DART mask over the concat, both halves at positions
        0..T-1. Returns (out, new K/V rings)."""
        b, t, h, w, c = x.shape
        m = heads(self.cfg, {"cout": c, "attention": "video"})
        hw = h * w
        qkv = self.dense(x, f"{p}.attn_qkv.w").reshape(b, t, hw, 3, m, c // m)
        q, k, v = (normalize(qkv[:, :, :, i].permute(0, 3, 1, 2, 4)) for i in range(3))
        if just_2d:
            o = self.attend(q, k, v, torch.ones(hw, hw, dtype=torch.bool, device=x.device))
        elif train:
            th = t // 2
            pos = torch.arange(th, device=x.device).repeat(2)
            qr, kr = rope_q(q, pos, th // 2), rope_k(k, pos, th // 2)
            fm = dart_visible(th, x.device)
            mask = fm.repeat_interleave(hw, 0).repeat_interleave(hw, 1)
            o = self.attend(qr.reshape(b, m, t * hw, -1), kr.reshape(b, m, t * hw, -1),
                            v.reshape(b, m, t * hw, -1), mask).reshape(q.shape)
        else:
            kbuf, vbuf = kv
            cap = kbuf.shape[2]
            qpos = frames + torch.arange(t, device=x.device)
            if t == 1:
                spos = ring_positions(frames, cap, x.device)
                keys = torch.cat([kbuf, k], 2)
                vals = torch.cat([vbuf, v], 2)
                kpos = torch.cat([spos, qpos])
                fmask = (kpos >= 0)[None, :]
            else:
                slots = (frames + torch.arange(t, device=x.device)) % cap
                kbuf, vbuf = kbuf.clone(), vbuf.clone()
                kbuf[:, :, slots], vbuf[:, :, slots] = k, v
                keys, vals = kbuf, vbuf
                kpos = ring_positions(frames + t, cap, x.device)
                fmask = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] >= 0)
            kr = rope_k(keys, kpos.clamp(min=0), frames)
            qr = rope_q(q, qpos, frames)
            mask = fmask.repeat_interleave(hw, 0).repeat_interleave(hw, 1)
            o = self.attend(qr.reshape(b, m, t * hw, -1), kr.reshape(b, m, -1, c // m),
                            vals.reshape(b, m, -1, c // m), mask).reshape(q.shape)
            if t == 1:
                slot = frames % cap
                kbuf, vbuf = kbuf.clone(), vbuf.clone()
                kbuf[:, :, slot:slot + 1], vbuf[:, :, slot:slot + 1] = k, v
            kv = (kbuf, vbuf)
        y = o.permute(0, 2, 3, 1, 4).reshape(b, t, h, w, c)
        y = self.dense(y, f"{p}.attn_proj.w")
        return mp_sum(x, y, self.cfg["attn_balance"]), kv

    def frame_attention(self, p, x):
        b, t, h, w, c = x.shape
        m = heads(self.cfg, {"cout": c, "attention": "frame"})
        qkv = self.dense(x, f"{p}.attn_qkv.w").reshape(b, t, h * w, 3, m, c // m)
        q, k, v = (normalize(qkv[:, :, :, i].permute(0, 1, 3, 2, 4)) for i in range(3))
        o = self.attend(q, k, v, torch.ones(h * w, h * w, dtype=torch.bool, device=x.device))
        y = self.dense(o.permute(0, 1, 3, 2, 4).reshape(b, t, h, w, c), f"{p}.attn_proj.w")
        return mp_sum(x, y, self.cfg["attn_balance"])

    def block(self, p, spec, x, emb, c_noise, frames, st, just_2d, train):
        cfg = self.cfg
        cin, co = x.shape[-1], spec["cout"]
        x = resample(x, spec["resample"])
        c = self.dense(emb, f"{p}.emb_linear.w", gain=self.p[f"{p}.emb_gain"]) + 1
        if spec["flavor"] == "enc":
            if cin != co:
                x = self.dense(x, f"{p}.conv_skip.w")
            x = normalize(x)
        st = dict(st or {})
        y, st["c0"] = self.causal_conv(f"{p}.conv_res0", mp_silu(x), c_noise, frames,
                                       st.get("c0"), just_2d, train)
        y = mp_silu(y * c[:, :, None, None, :])
        y, st["c1"] = self.causal_conv(f"{p}.conv_res1", y, c_noise, frames, st.get("c1"),
                                       just_2d, train)
        if spec["flavor"] == "dec" and cin != co:
            x = self.dense(x, f"{p}.conv_skip.w")
        x = mp_sum(x, y, cfg["res_balance"])
        if heads(cfg, spec):
            if spec["attention"] == "video":
                x, st["kv"] = self.video_attention(f"{p}.attn", x, frames, st.get("kv"), train,
                                                   just_2d)
            else:
                x = self.frame_attention(f"{p}.attn", x)
        if cfg["clip_act"] is not None:
            x = x.clamp(-cfg["clip_act"], cfg["clip_act"])
        return x, st

    def unet(self, x, c_noise, cond, cache, just_2d, train):
        cfg = self.cfg
        frames = 0 if cache is None else cache["frames"]
        fr = self.p["unet.emb_fourier_sigma.freqs"]
        ph = self.p["unet.emb_fourier_sigma.phases"]
        emb = torch.cos(c_noise[..., None] * fr + ph) * math.sqrt(2.0)
        emb = self.dense(emb, "unet.emb_noise.w")
        if cfg["label_dim"] and cond is not None:
            oh = F.one_hot(cond.long(), cfg["label_dim"]).float() * math.sqrt(cfg["label_dim"])
            emb = mp_sum(emb, self.dense(oh, "unet.emb_label.w"), 1 / 3)
        emb = mp_silu(emb)
        x = torch.cat([x, torch.ones_like(x[..., :1])], -1)
        new = None if cache is None else {"frames": frames + x.shape[1]}
        skips = []
        for side, name, spec in self.layout:
            p = "unet." + (name if side == "out" else f"{side}_{name}")
            st = None if cache is None else cache.get(p)
            if side == "dec" and "block" in name:
                x = mp_cat(x, skips.pop(), cfg["concat_balance"])
            if spec["kind"] == "conv":
                x, s = self.causal_conv(p, x, c_noise, frames, st, just_2d, train)
            else:
                x, s = self.block(p, spec, x, emb, c_noise, frames, st, just_2d, train)
            if new is not None:
                new[p] = s
            if side == "enc":
                skips.append(x)
        return x * self.p["unet.out_gain"], new

    def __call__(self, x, sigma, cond=None, cache=None, just_2d=False, train=False,
                 sigma_data: float = 1.0):
        """The preconditioned denoiser D(x; sigma): x (B, T, H, W, C),
        sigma (B, T). Returns (D, the cache after these frames)."""
        s = sigma[:, :, None, None, None]
        sd = sigma_data
        c_skip = sd ** 2 / (s ** 2 + sd ** 2)
        c_out = s * sd / torch.sqrt(s ** 2 + sd ** 2)
        c_in = 1 / torch.sqrt(sd ** 2 + s ** 2)
        f, new = self.unet(c_in * x, torch.log(sigma) / 4, cond, cache, just_2d, train)
        return c_skip * x + c_out * f, new

    def init_cache(self, b, device):
        """A fresh cache for b sessions: conv states ones, K/V rings zeros."""
        cfg = self.cfg
        cache = {"frames": 0}

        def ones(res, c):
            return torch.ones(b, 2, res, res, c, device=device)

        for side, name, spec in self.layout:
            p = "unet." + (name if side == "out" else f"{side}_{name}")
            r, cin, co = spec["res"], spec["cin"], spec["cout"]
            if spec["kind"] == "conv":
                cache[p] = ones(r, cin)
                continue
            st = {"c0": ones(r, co if spec["flavor"] == "enc" else cin), "c1": ones(r, co)}
            nh = heads(cfg, spec)
            if spec["attention"] == "video" and nh:
                kv = torch.zeros(b, nh, cfg["max_frames"], r * r, co // nh, device=device)
                st["kv"] = (kv, kv.clone())
            cache[p] = st
        return cache


# ---------------------------------------------------------------------------
# Serving: Heun sampler, one frame at a time against the cache


@torch.no_grad()
def sample_frame(ref: Ref, cache, x_init, cond, steps):
    """The EDM Heun sampler of one frame from x_init (already at sigma_max)
    over the schedule `steps` (karras_steps): Heun steps, then a final Euler
    step. Returns (frame, the final step's input x_hat)."""
    b = x_init.shape[0]

    def d(x, t):
        return ref(x, torch.full((b, 1), float(t), device=x.device), cond, cache)[0]

    x = x_init
    n = len(steps) - 1
    for i in range(n - 1):
        t, tn = float(steps[i]), float(steps[i + 1])
        dc = (x - d(x, t)) / t
        xn = x + (tn - t) * dc
        dp = (xn - d(xn, tn)) / tn
        x = x + (tn - t) * (0.5 * dc + 0.5 * dp)
    t = float(steps[n - 1])
    return x + (0.0 - t) * (x - d(x, t)) / t, x


@torch.no_grad()
def cache_update(ref: Ref, cache, x_hat, cond, sigma: float):
    """The cache after frame x_hat (B, 1, ...) enters it at noise level sigma."""
    b = x_hat.shape[0]
    return ref(x_hat, torch.full((b, 1), float(sigma), device=x_hat.device), cond, cache)[1]


# ---------------------------------------------------------------------------
# Training: DART loss, clip + AdamW, forced weight norm, power-function EMA


def dart_loss(ref: Ref, images, cond, sigma, noise, just_2d, sigma_data=1.0):
    """Mean weighted denoising loss of one microbatch (loss-weight fit at its
    start: a mean loss of 1 at every sigma). DART: the model sees the clean
    frames (noised at the context level) followed by the noisy ones and is
    scored on the noisy half."""
    t = images.shape[1]
    if just_2d:
        x, c = images, cond
    else:
        x = torch.cat([images, images], 1)
        c = None if cond is None else torch.cat([cond, cond], 1)
    out, _ = ref(x + noise, sigma, c, just_2d=just_2d, train=True, sigma_data=sigma_data)
    losses = ((out[:, -t:] - images) ** 2).mean(dim=(-1, -2, -3))
    sig = sigma[:, -t:]
    w = (sig ** 2 + sigma_data ** 2) / (sig * sigma_data) ** 2
    return (losses * w).mean()


class RefTrainer:
    """One training step as a function of float32 state: the microbatches'
    loss and gradients, the global-norm clip, AdamW (no weight decay), the
    forced weight norm of every `w` and the EMA copies."""

    def __init__(self, ref: Ref, lr: Callable[[int], float], clip: float, eps: float,
                 betas, ema_stds, batch: int, micro: int, sigma_data: float = 1.0):
        self.ref, self.lr, self.clip, self.eps = ref, lr, clip, eps
        self.b1, self.b2 = betas
        self.batch, self.micro, self.sd = batch, micro, sigma_data
        self.names = [n for n in ref.p if not n.endswith(("freqs", "phases"))]
        for n in self.names:
            ref.p[n].requires_grad_(True)
        self.m = {n: torch.zeros_like(ref.p[n]) for n in self.names}
        self.v = {n: torch.zeros_like(ref.p[n]) for n in self.names}
        self.ema = [{n: ref.p[n].detach().clone() for n in self.names} for _ in ema_stds]
        self.gammas = [std_to_exp(s) for s in ema_stds]
        self.step_count = 0

    def step(self, images, cond, sigma, noise, just_2d):
        """Returns (loss, {name: clipped gradient}). The loss is the mean over
        the microbatches of `images` (the batch, or a part of it)."""
        p = self.ref.p
        for n in self.names:
            p[n].grad = None
        k = images.shape[0] // self.micro
        total = 0.0
        for j in range(k):
            sl = slice(j * self.micro, (j + 1) * self.micro)
            loss = dart_loss(self.ref, images[sl], None if cond is None else cond[sl],
                             sigma[sl], noise[sl], just_2d, self.sd)
            (loss / k).backward()
            total += float(loss.detach()) / k
        with torch.no_grad():
            grads = {n: (p[n].grad if p[n].grad is not None else torch.zeros_like(p[n]))
                     for n in self.names}
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
            scale = self.clip / torch.clamp(norm, min=self.clip)
            grads = {n: g * scale for n, g in grads.items()}
            count = self.step_count + 1
            lr = self.lr(self.step_count)
            for n in self.names:
                g = grads[n]
                self.m[n].mul_(self.b1).add_(g, alpha=1 - self.b1)
                self.v[n].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
                denom = (self.v[n] / (1 - self.b2 ** count)).sqrt() + self.eps
                p[n].sub_(lr / (1 - self.b1 ** count) * self.m[n] / denom)
                if n.endswith(".w"):
                    p[n].copy_(normalize(p[n], dims=tuple(range(p[n].ndim - 1))))
            nimg = count * self.batch
            for ema, gamma in zip(self.ema, self.gammas):
                beta = (1.0 - self.batch / nimg) ** (gamma + 1.0)
                for n in self.names:
                    ema[n].lerp_(p[n], 1.0 - beta)
        self.step_count = count
        return total, grads
