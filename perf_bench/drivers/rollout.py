"""Rollout window: many game sessions generated in lock-step, frame by frame.

Set-up: the denoiser at the configuration's widths with the benchmark's
seeded weights, a cache for `sessions` sessions, each session's ring
prefilled with `context_frames` seeded latent frames in chunks of
`prefill_chunk` (so that the window runs on a full ring and crosses its
wrap), and one cached call without and one with a cache update as
warm-up. The window: whole frame steps, each one `sampling.generate` call
for one frame of every session (the Heun sampler over `num_steps` steps,
its last call writing the frame into the cache), from initial noise and
actions drawn from the seed. A step whose expected end (the previous
step's duration) falls after the window is not started; at least one runs.

Checked after the window against the plain reference (reference.py), for
CHECK_SESSIONS sessions drawn from the seed (`checked_sessions`), on
CHECK_FRAMES frame steps drawn from the seed and the last: the reference
prefills its own cache from the same context, samples each checked frame
from the same noise and actions, and compares the served frame and the
last sampler call's input (`frame_gap`, `xhat_gap`: the root mean square
over the checked sessions and frames of ||program - reference|| /
||reference||); then it writes the program's last-call input into its
cache, as the program's last call did, and goes on to the next frame.
After the last frame it compares the program's cache with its own
(`cache_gap`: the worst session's gap of any conv state or K/V ring): a
stale or misplaced cache entry moves the served frames too little to
show among round-off, the cache itself a lot. `control=True` serves the
program's own int8 path (int8 decode weights and K/V rings) in place of
the bf16 one.
"""
from __future__ import annotations

import math
import time

import torch
from torch import nn

from perf_bench import harness
from perf_bench.reference import Ref, cache_update, init_params, karras_steps, sample_frame
from perf_bench.traffic_law import ar1_latents, draw_seed

KIND = "rollout"
CHECK_SESSIONS = 4  # sessions the reference follows
CHECK_FRAMES = 2  # frame steps drawn for the check, besides the last
TRACE_FIRST_CALL = 8  # the traced run profiles cached calls [8, 8 + 24)
TRACE_CALLS = 24
MAX_WINDOW_FRAMES = 64  # frame steps a window may run (actions are drawn for as many)


class Denoiser(nn.Module):
    """The model as `generate` calls it, with the benchmark's span around each
    call, the last-call inputs of the checked sessions kept, and the profiled
    sub-window opened and closed at given calls."""

    def __init__(self, model, spans, check_idx, window=None, trace_calls=(0, 0)):
        super().__init__()
        self.model = model
        self.spans = spans
        self.idx = check_idx
        self.kept = []
        self.calls = 0
        self.window = window
        self.trace_calls = trace_calls
        self.traced = 0

    def forward(self, x, sigma, conditioning=None, cache=None, update_cache=False, **kw):
        first, n = self.trace_calls
        if self.window is not None and self.calls == first:
            self.window.start()
        with self.spans.span("denoiser_call"):
            out = self.model(x, sigma, conditioning, cache=cache, update_cache=update_cache, **kw)
        if update_cache:
            self.kept.append(x[self.idx].detach().float().clone())
        self.calls += 1
        if self.window is not None and self.calls == first + n:
            self.window.stop()
            self.traced = n
        return out


def build(cfg_json, params, device, control):
    from autoregressive_diffusion_tpu_torch.models import Precond, UNetConfig
    m = cfg_json["model"]
    cfg = UNetConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in m.items()})
    dtype = getattr(torch, cfg_json["body_dtype"])
    with torch.device(device):
        model = Precond(cfg, sigma_data=cfg_json["sigma_data"], body_dtype=dtype)
    model.load_state_dict(params)
    model.eval()
    if control:
        from autoregressive_diffusion_tpu_torch.generate import int8_model
        model = int8_model(model)
    return model


def inputs(cfg, tr, seed, device, n_frames):
    """(context latents (B, C, H, W, ch), actions (B, C + n_frames) or None),
    drawn on the device from the seed."""
    m = cfg["model"]
    b, c = tr["sessions"], tr["context_frames"]
    lat = ar1_latents(b, c, m["img_resolution"], m["img_channels"], tr["latents"],
                      draw_seed(seed, "context"), device)
    acts = None
    if tr["actions"] > 0:
        g = torch.Generator(device=device).manual_seed(draw_seed(seed, "actions"))
        acts = torch.randint(0, tr["actions"], (b, c + n_frames), generator=g, device=device)
    return lat, acts


def noise_stream(tr, cfg, seed, device):
    m = cfg["model"]
    shape = (tr["sessions"], 1, m["img_resolution"], m["img_resolution"], m["img_channels"])
    g = torch.Generator(device=device).manual_seed(draw_seed(seed, "noise"))
    while True:
        yield torch.randn(shape, generator=g, device=device) * tr["sigma_max"]


def checked_sessions(seed, sessions):
    """The sorted indices of the CHECK_SESSIONS sessions the check follows."""
    g = torch.Generator(device="cpu").manual_seed(draw_seed(seed, "check"))
    return torch.randperm(sessions, generator=g)[:CHECK_SESSIONS].sort().values


def serving(cfg: dict) -> dict:
    """The configuration as it is served: its `serve` sizes over `model`'s."""
    return {**cfg, "model": {**cfg["model"], **cfg.get("serve", {})}}


def run(cell, seed, seconds, trace, device, t0, control=False):
    from autoregressive_diffusion_tpu_torch.models import init_cache
    from autoregressive_diffusion_tpu_torch.sampling import generate

    cfg, tr = serving(cell["config_spec"]), cell["traffic_spec"]
    m = cfg["model"]
    b, c = tr["sessions"], tr["context_frames"]
    res, ch = m["img_resolution"], m["img_channels"]
    is_cuda = torch.device(device).type == "cuda"

    def sync():
        if is_cuda:
            torch.cuda.synchronize()

    spans = harness.Spans()
    check_idx = checked_sessions(seed, b).to(device)

    params = init_params(m, draw_seed(seed, "weights"), device)
    model = build(cfg, params, device, control)
    del params
    context, acts = inputs(cfg, tr, seed, device, MAX_WINDOW_FRAMES)
    cache = init_cache(model, b, device=device)
    with torch.no_grad():
        for j in range(0, c, tr["prefill_chunk"]):
            k = min(tr["prefill_chunk"], c - j)
            sig = torch.full((b, k), tr["context_sigma"], device=device)
            cond = None if acts is None else acts[:, j:j + k]
            _, cache = model(context[:, j:j + k], sig, cond, cache=cache, update_cache=True)
        # warm-up: the window's two call shapes, results discarded
        x1 = torch.zeros((b, 1, res, res, ch), device=device)
        s1 = torch.full((b, 1), tr["sigma_min"], device=device)
        c1 = None if acts is None else acts[:, c:c + 1]
        model(x1, s1, c1, cache=cache)
        model(x1, s1, c1, cache=cache, update_cache=True)
    del context, x1
    sync()

    window = harness.Window(torch) if trace else None
    den = Denoiser(model, spans, check_idx, window, (TRACE_FIRST_CALL, TRACE_CALLS))
    noise = noise_stream(tr, cfg, seed, device)
    shape = (b, 1, res, res, ch)
    bad = torch.zeros((), dtype=torch.long, device=device)
    served = []
    setup_s = time.perf_counter() - t0
    usage = harness.host_usage()
    start = time.perf_counter()
    steps, last, durations = 0, 0.0, []
    while steps < MAX_WINDOW_FRAMES:
        now = time.perf_counter()
        if not harness.start_next(steps, now, last, start, seconds):
            break
        with spans.span("frame_step"):
            cond = None if acts is None else acts[:, c + steps:c + steps + 1]
            x, cache = generate(den, cache, 1, shape, conditioning=cond,
                                num_steps=tr["num_steps"], sigma_max=tr["sigma_max"],
                                sigma_min=tr["sigma_min"], rho=tr["rho"], x_init=next(noise))
            bad += (~torch.isfinite(x).flatten(1).all(1)).sum()
            served.append(x[check_idx].float().clone())
            sync()
        last = time.perf_counter() - now
        durations.append(last)
        steps += 1
    window_s = time.perf_counter() - start
    host = harness.host_window(usage, window_s)

    out = {"kind": KIND, "setup_s": setup_s, "window_s": window_s,
           "attempted": b * steps, "failed": int(bad),
           "e2e": {"rollout_frames_per_s": (b * steps / window_s, "frames/s")},
           "step_s": durations, "host": host, "sessions": b, "frame_steps": steps, "cfg": m,
           "traffic": tr, "body_dtype": cfg["body_dtype"]}
    if trace and window is not None and den.traced:
        out["trace"] = harness.window_record(window, spans)
        out["trace"]["calls"] = den.traced
        out["trace"]["ring_frames"] = min(c, m["max_frames"])
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if is_cuda else 0
    kept = den.kept
    state = program_state(cache, check_idx)
    del den, model, cache, x, window
    if is_cuda:
        harness.free_device(torch)
    out["checks"], out["info"] = check(cell, seed, steps, served, kept, state, check_idx,
                                       device)
    return out


def program_state(cache: dict, idx) -> dict:
    """The program's cache for the sessions `idx`, float32, under the
    reference's names ("unet.<side>_<layer>" -> a conv's last two inputs,
    or a Block's {"c0", "c1", "kv": (K ring, V ring)}); int8 rings
    dequantized (value / 127)."""
    def f32(t):
        t = t[idx]
        return t.float() / 127.0 if t.dtype == torch.int8 else t.float()

    out = {"unet.out_conv": f32(cache["out_conv"]["act"])}
    for side in ("enc", "dec"):
        for name, e in cache[side].items():
            p = f"unet.{side}_{name}"
            if "act" in e:
                out[p] = f32(e["act"])
                continue
            out[p] = {"c0": f32(e["conv_res0"]["act"]), "c1": f32(e["conv_res1"]["act"])}
            if "attn" in e:
                out[p]["kv"] = (f32(e["attn"]["k"]), f32(e["attn"]["v"]))
    return out


def state_gaps(prog: dict, ref: dict) -> list:
    """[(leaf, session, gap)] between two caches in the reference's layout:
    each session's ||program - reference|| / ||reference|| of each leaf."""
    out = []

    def walk(name, p, r):
        if isinstance(r, dict):
            for k in r:
                walk(f"{name}.{k}", p[k], r[k])
        elif isinstance(r, tuple):
            for k, (a, b) in zip("kv", zip(p, r)):
                walk(f"{name}.{k}", a, b)
        else:
            out.extend((name, s, harness.rel_gap(p[s], r[s])) for s in range(r.shape[0]))
    for name in ref:
        if name != "frames":
            walk(name, prog[name], ref[name])
    return out


@torch.no_grad()
def check(cell, seed, steps, served, kept, state, idx, device):
    """([(name, reading, limit)], info) of the served frames and the final
    cache against the reference: the root mean square over the checked
    (session, frame) pairs of each pair's gap, and the worst (leaf,
    session) gap of the cache; info holds the worst pair's and the leaf."""
    cfg, tr = serving(cell["config_spec"]), cell["traffic_spec"]
    m = cfg["model"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = Ref(m, init_params(m, draw_seed(seed, "weights"), device))
    context, acts = inputs(cfg, tr, seed, device, MAX_WINDOW_FRAMES)
    c = tr["context_frames"]
    k = idx.numel()
    ctx = context[idx]
    a = None if acts is None else acts[idx]
    del context, acts
    cache = ref.init_cache(k, device)
    sig = torch.full((k, c), tr["context_sigma"], device=device)
    _, cache = ref(ctx, sig, None if a is None else a[:, :c], cache)
    sched = karras_steps(tr["num_steps"], tr["sigma_min"], tr["sigma_max"], tr["rho"])
    g = torch.Generator(device="cpu").manual_seed(draw_seed(seed, "check_frames"))
    order = torch.randperm(steps, generator=g).tolist()
    checked = set(order[:CHECK_FRAMES]) | {steps - 1}
    noise = noise_stream(tr, cfg, seed, device)
    frame, xhat = [], []
    for j in range(steps):
        x_init = next(noise)[idx]
        cond = None if a is None else a[:, c + j:c + j + 1]
        if j in checked:
            x_ref, xhat_ref = sample_frame(ref, cache, x_init, cond, sched)
            frame += [harness.rel_gap(served[j][s], x_ref[s]) for s in range(k)]
            xhat += [harness.rel_gap(kept[j][s], xhat_ref[s]) for s in range(k)]
        cache = cache_update(ref, cache, kept[j], cond, sched[-2])
    lim = cfg["checks"][KIND]
    leaf, _, cache_gap = max(state_gaps(state, cache), key=lambda t: t[2])
    info = {"frame_gap_max": max(frame), "xhat_gap_max": max(xhat), "compared": len(frame),
            "cache_gap_leaf": leaf}
    return [("frame_gap", rms(frame), lim["frame_gap"]),
            ("xhat_gap", rms(xhat), lim["xhat_gap"]),
            ("cache_gap", cache_gap, lim["cache_gap"])], info


def rms(values) -> float:
    return math.sqrt(sum(v * v for v in values) / len(values))
