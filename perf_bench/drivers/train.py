"""Training window: one process trains the denoiser step after step.

Set-up builds one train state (the model at the configuration's widths on
the benchmark's seeded float32 weights, a bf16 body; AdamW behind the
global-norm clip; the EMA copies) and one step function
(`train_state.make_train_step`, with microbatches), and drives them
through the first SETUP_STEPS steps: these are the warm-up (both step
shapes: a just_2d step every `just_2d_every`, the DART steps between) and
the steps the check reads. Every step's batch is made on the card from the
seed inside the step (`make_batch`): latents by the AR(1) law, actions,
and the EDM noise levels and noise, which the step takes as given. The
window then runs whole cycles of `just_2d_every` steps; a cycle whose
expected end (the previous cycle's duration) falls after the window is
not started, and at least one runs.

Checked against the plain reference's first three steps, from the same
weights and batches: the first two steps' clipped gradients as AdamW got
them, read from its moments (`grad_gap`), and the change of the parameters
and of the EMA copies over the three steps (`change_gap`, `ema_gap`). Each
is the worst weight leaf's gap between the norms, over the larger of the
leaf's and the median weight leaf's reference norm. Weight leaves are
those of MIN_LEAF elements or more: every conv, dense and attention weight;
the gains and gating parameters (1 or 2 elements) are left out, their
norms swing by round-off alone. The change also leaves out the leaves
whose reference gradients are under a thousandth of the median leaf's:
they move by round-off alone.
"""
from __future__ import annotations

import math
import statistics
import time

import torch

from perf_bench import harness
from perf_bench.reference import Ref, RefTrainer, fp8_round, init_params, param_shapes
from perf_bench.traffic_law import ar1_latents, draw_seed, edm_sigma_noise

KIND = "train"
SETUP_STEPS = 4  # both step shapes warmed up; steps 0-2 are the ones the check reads
TRACE_CYCLE = 1  # the traced run profiles the window's second cycle
MIN_LEAF = 64  # the fewest elements of a leaf that is compared leaf by leaf


def lr_schedule(opt: dict):
    """The EDM2 inverse-square-root schedule with a linear ramp-up, float32
    as the training script computes it: ref_lr / sqrt(max(count / ref_step,
    1)) * min(count / rampup, 1)."""
    import numpy as np
    f32 = np.float32

    def lr(count):
        s = f32(count)
        v = f32(opt["ref_lr"]) / np.sqrt(np.maximum(s / f32(opt["ref_step"]), f32(1.0)))
        return float(v * np.minimum(s / f32(opt["rampup_steps"]), f32(1.0)))
    return lr


def make_batch_fn(cfg, tr, seed, device):
    m = cfg["model"]
    b, t = tr["batch"], tr["frames"]

    def make_batch(i):
        lat = ar1_latents(b, t, m["img_resolution"], m["img_channels"], tr["latents"],
                          draw_seed(seed, "latents", i), device)
        acts = None
        if tr["actions"] > 0:
            g = torch.Generator(device=device).manual_seed(draw_seed(seed, "actions", i))
            acts = torch.randint(0, tr["actions"], (b, t), generator=g, device=device)
        sig, noise = edm_sigma_noise(b, t, m["img_resolution"], m["img_channels"], cfg["loss"],
                                     is_2d(tr, i), draw_seed(seed, "noise", i), device)
        return lat, acts, sig, noise
    return make_batch


def is_2d(tr, i):
    return i % tr["just_2d_every"] == 0


def build(cfg, tr, params, device):
    from autoregressive_diffusion_tpu_torch.models import Precond, UNetConfig
    from autoregressive_diffusion_tpu_torch.train import (EDM2LossConfig, create_train_state,
                                                          make_optimizer, make_train_step)
    m = cfg["model"]
    ucfg = UNetConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in m.items()})
    with torch.device(device):
        model = Precond(ucfg, sigma_data=cfg["sigma_data"],
                        body_dtype=getattr(torch, cfg["body_dtype"]))
    model.load_state_dict(params)
    model.train()
    opt = cfg["optimizer"]
    tx = make_optimizer(learning_rate=lr_schedule(opt), grad_clip=opt["grad_clip"],
                        eps=opt["eps"])
    state = create_train_state(model, tx, tuple(opt["ema_stds"]))
    step_fn = make_train_step(EDM2LossConfig(**cfg["loss"]), tx, tr["batch"], tr["micro_batch"])
    return state, step_fn


def _norms(tensors: dict) -> dict:
    return {n: float(t.double().norm()) for n, t in tensors.items()}


def run(cell, seed, seconds, trace, device, t0):
    cfg, tr = cell["config_spec"], cell["traffic_spec"]
    m = cfg["model"]
    is_cuda = torch.device(device).type == "cuda"

    def sync():
        if is_cuda:
            torch.cuda.synchronize()

    spans = harness.Spans()
    make_batch = make_batch_fn(cfg, tr, seed, device)
    params = init_params(m, draw_seed(seed, "weights"), device)
    state, step_fn = build(cfg, tr, params, device)
    del params
    losses = []

    def step(i):
        with spans.span("train_step"):
            with spans.span("make_batch"):
                lat, acts, sig, noise = make_batch(i)
            st, met = step_fn(state, lat, acts, i, just_2d=is_2d(tr, i), sigma=sig, noise=noise)
            losses.append(met["loss"].detach())
        return st

    # set-up: the first steps, read for the check
    names = [n for n, _ in state.model.named_parameters()]
    p0 = {n: p.detach().to("cpu", copy=True) for n, p in state.model.named_parameters()}
    opt = state.opt_state

    def moments():
        """AdamW's first moments by leaf (zeros where it holds none)."""
        return {n: opt.state[p]["exp_avg"] if "exp_avg" in opt.state[p] else torch.zeros_like(p)
                for n, p in state.model.named_parameters()}

    b1 = cfg["optimizer"]["betas"][0]
    prog = {}
    m_prev = None
    for i in range(SETUP_STEPS):
        state = step(i)
        if i < 2:
            mom = moments()
            if i == 0:
                prog["grad0"] = {n: float(mom[n].double().norm() / (1 - b1)) for n in names}
                m_prev = {n: mom[n].detach().to("cpu", copy=True) for n in names}
            else:
                prog["grad1"] = {n: float(((mom[n].double() - b1 * m_prev[n].to(mom[n].device)
                                            .double()) / (1 - b1)).norm()) for n in names}
                m_prev = None
        if i == 2:
            ps = dict(state.model.named_parameters())
            prog["change"] = {n: float((ps[n].detach().double()
                                        - p0[n].to(ps[n].device).double()).norm()) for n in names}
            prog["ema"] = [{n: float((e[n].double() - p0[n].to(e[n].device).double()).norm())
                            for n in names} for e in state.ema]
    prog["loss"] = [float(v) for v in losses[:3]]
    del p0
    sync()

    every = tr["just_2d_every"]
    window = harness.Window(torch) if trace else None
    setup_s = time.perf_counter() - t0
    usage = harness.host_usage()
    start = time.perf_counter()
    i, cycles, last = SETUP_STEPS, 0, 0.0
    traced_steps, durations = 0, []
    while True:
        now = time.perf_counter()
        if not harness.start_next(cycles, now, last, start, seconds):
            break
        profile = window is not None and cycles == TRACE_CYCLE
        if profile:
            window.start()
        for _ in range(every):
            state = step(i)
            i += 1
        sync()
        if profile:
            window.stop()
            traced_steps = every
        last = time.perf_counter() - now
        durations.append(last)
        cycles += 1
    window_s = time.perf_counter() - start
    host = harness.host_window(usage, window_s)
    steps = cycles * every
    loss_all = torch.stack(losses)
    bad = int((~torch.isfinite(loss_all[SETUP_STEPS:])).sum())

    out = {"kind": KIND, "setup_s": setup_s, "window_s": window_s,
           "attempted": steps * tr["batch"], "failed": bad * tr["batch"],
           "e2e": {"train_samples_per_s": (tr["batch"] * steps / window_s, "samples/s")},
           "step_s": durations, "host": host, "steps": steps, "cfg": m, "traffic": tr,
           "body_dtype": cfg["body_dtype"]}
    if traced_steps:
        out["trace"] = harness.window_record(window, spans)
        out["trace"]["steps"] = traced_steps
        out["trace"]["first_step"] = SETUP_STEPS + TRACE_CYCLE * every
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if is_cuda else 0
    del state, step_fn, opt, window, losses, loss_all
    if is_cuda:
        harness.free_device(torch)
    out["program_readings"] = prog
    ref = reference_readings(cfg, tr, seed, device, None)
    out["checks"] = compare(cfg, prog, ref)
    out["info"] = {"loss_gap": loss_gap(prog, ref), "small_gap": small_gap(cfg, prog, ref)}
    return out


def reference_readings(cfg, tr, seed, device, rnd, keep: float = 1.0):
    """The reference's losses, clipped gradient norms of the first two steps,
    and changes of the parameters and EMA copies over three steps. rnd:
    None (float32) or "fp8"; keep < 1 trains each step on that share of
    its batch (a fault)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m = cfg["model"]
    opt = cfg["optimizer"]
    params = init_params(m, draw_seed(seed, "weights"), device)
    p0 = {n: t.clone() for n, t in params.items()}
    ref = Ref(m, params, fp8_round if rnd == "fp8" else None)
    rows = int(tr["batch"] * keep)
    trainer = RefTrainer(ref, lr_schedule(opt), opt["grad_clip"], opt["eps"], opt["betas"],
                         opt["ema_stds"], tr["batch"], min(tr["micro_batch"], rows),
                         cfg["sigma_data"])
    make_batch = make_batch_fn(cfg, tr, seed, device)
    out = {"loss": []}
    for i in range(3):
        lat, acts, sig, noise = (None if a is None else a[:rows] for a in make_batch(i))
        loss, grads = trainer.step(lat, acts, sig, noise, is_2d(tr, i))
        out["loss"].append(loss)
        if i < 2:
            out[f"grad{i}"] = _norms(grads)
    with torch.no_grad():
        out["change"] = _norms({n: ref.p[n] - p0[n] for n in trainer.names})
        out["ema"] = [_norms({n: e[n] - p0[n] for n in trainer.names}) for e in trainer.ema]
    return out


def leaf_gaps(prog: dict, ref: dict, names) -> list:
    """Each leaf's gap between two norms: |program - reference| over the
    larger of the reference's norm of that leaf and of the median leaf."""
    med = statistics.median(ref[n] for n in names)
    return [abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names]


def weight_leaves(cfg, names) -> list:
    """The leaves of MIN_LEAF elements or more."""
    shapes = param_shapes(cfg["model"])
    return [n for n in names if math.prod(shapes[n]) >= MIN_LEAF]


def counted(ref, names) -> list:
    """Of `names`, the leaves whose change is compared: those whose reference
    gradient, in either step, reaches a thousandth of their median leaf's."""
    g = {n: max(ref["grad0"][n], ref["grad1"][n]) for n in names}
    med = statistics.median(g.values())
    return [n for n in names if g[n] >= 1e-3 * med]


def loss_gap(prog, ref) -> float:
    """The worst relative gap of the first three steps' losses. Read, not
    compared: no control or fault reads far enough above sound runs
    (PERF.md)."""
    return max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"]))


def small_gap(cfg, prog, ref) -> float:
    """The gap between the joint norms of the leaves under MIN_LEAF
    elements, over the reference's, worst of the five readings. Read, not
    compared (PERF.md)."""
    names = list(ref["grad0"])
    small = [n for n in names if n not in set(weight_leaves(cfg, names))]

    def joint(d):
        return math.sqrt(sum(d[n] ** 2 for n in small))
    pairs = [(prog[k], ref[k]) for k in ("grad0", "grad1", "change")]
    pairs += list(zip(prog["ema"], ref["ema"]))
    return max(abs(joint(p) - joint(r)) / max(joint(r), 1e-30) for p, r in pairs)


def compare(cfg, prog, ref, pick=max):
    """[(name, reading, limit)] of the program's readings against the
    reference's: the worst weight leaf's gap (`pick` over the leaves)."""
    lim = cfg["checks"][KIND]
    names = weight_leaves(cfg, list(ref["grad0"]))
    moved = counted(ref, names)
    grad_gap = max(pick(leaf_gaps(prog[k], ref[k], names)) for k in ("grad0", "grad1"))
    change_gap = pick(leaf_gaps(prog["change"], ref["change"], moved))
    ema_gap = max(pick(leaf_gaps(p, r, moved)) for p, r in zip(prog["ema"], ref["ema"]))
    return [("grad_gap", grad_gap, lim["grad_gap"]), ("change_gap", change_gap, lim["change_gap"]),
            ("ema_gap", ema_gap, lim["ema_gap"])]
