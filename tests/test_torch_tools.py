"""The port's cost model (utils/roofline.py) and its three tools, on the CPU.

(1) The cost model's operations against torch.utils.flop_counter's
    FlopCounterMode over the plain versions, at small shapes where the
    plain version does the kernel's work: the train-mode fused conv's
    forward and backward, with and without the context conv (the plain
    backward's input gradient of the ones frames before the clip, which the
    kernel skips, counted apart), the
    decode Block (encoder with skip, decoder, and without context), full
    flash attention forward and backward, and a whole cached and just_2d
    denoiser call of a tiny model; the call's weight bytes against the
    model's weights.
(2) decode_budget, kernel_bench and profile_train: main([..., "--device",
    "cpu", small flags]) runs and prints its lines and its JSON line.
About 15 s on one worker.
"""
import json
import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from autoregressive_diffusion_tpu_torch import decode_budget, kernel_bench, profile_train
from autoregressive_diffusion_tpu_torch.generate import build_model
from autoregressive_diffusion_tpu_torch.models import init_cache
from autoregressive_diffusion_tpu_torch.ops import flash_attention as fa
from autoregressive_diffusion_tpu_torch.ops import fused_conv as fc
from autoregressive_diffusion_tpu_torch.train.cli import TINY_CONFIG
from autoregressive_diffusion_tpu_torch.utils.roofline import (block_cost, conv_cost,
                                                               denoiser_call_cost, flash_cost)


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Hold torch to 2 threads beside the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("b,t,h,w,c,co,has_cv,with_ctx", [
    (2, 3, 6, 5, 4, 8, True, True), (1, 2, 4, 4, 16, 8, False, True),
    (2, 3, 6, 5, 4, 8, True, False), (1, 1, 4, 4, 8, 16, False, True)])
def test_conv_cost_matches_flop_counter(b, t, h, w, c, co, has_cv, with_ctx):
    f = 2 * t if with_ctx else t
    args, gout = fc.conv_inputs(b, f, h, w, c, co, has_cv, with_ctx, torch.float32,
                                          torch.device("cpu"), seed=3)
    leaves = [None if a is None else a.requires_grad_(True) for a in args]
    (fwd, _), (bwd, _) = conv_cost(b, f, h, w, c, co, has_cv, with_ctx, torch.float32)
    out = []
    assert counted(lambda: out.append(fc.fused_gated_conv_plain(*leaves, True, with_ctx))) == fwd
    need = [a for a in leaves if a is not None]
    # with the context conv, the plain backward also takes the input gradient
    # of the ones frames before the clip, which the kernel skips: 2t context
    # frame-taps of the forward against the t - 1 + t - 2 that exist
    ones = 2 * t - max(t - 1, 0) - max(t - 2, 0) if with_ctx else 0
    extra = 2 * b * h * w * c * co * 9 * ones
    assert counted(lambda: torch.autograd.grad(out[0], need, gout)) == bwd + extra


@pytest.mark.parametrize("shape,with_ctx", [((8, 16, 32, 32, "enc", True), True),
                                            ((8, 48, 48, 16, "dec", True), True),
                                            ((4, 16, 16, 16, "enc", False), False)])
def test_block_cost_matches_flop_counter(shape, with_ctx):
    h, cin, c0, co, flavor, skip = shape
    g = torch.Generator().manual_seed(0)

    def rn(*s):
        return torch.randn(s, generator=g)

    args = (rn(1, 1, h, h, cin), rn(1, 2, h, h, c0) if with_ctx else None,
            rn(1, 2, h, h, co) if with_ctx else None, rn(cin, co) if skip else None,
            rn(3, 3, c0, co), rn(2, 3, 3, c0, co), rn(3, 3, co, co), rn(2, 3, 3, co, co),
            rn(1, co), torch.rand((1, 2), generator=g))
    flops, _ = block_cost(shape, torch.float32, with_ctx)
    assert counted(lambda: fc.fused_decode_block_plain(*args, flavor, 0.3, 256.0,
                                                       with_ctx)) == flops


def test_full_attention_cost_matches_flop_counter():
    b, heads, hw, d = 3, 2, 20, 16
    g = torch.Generator().manual_seed(1)
    qs, k, v, do = (torch.randn((b, heads, hw, d), generator=g) for _ in range(4))
    (fwd, _), (bwd, _) = flash_cost("full", b, heads, 1, hw, d, torch.float32)
    res = []
    assert counted(lambda: res.append(fa.flash_attention_fwd_plain(qs, k, v, "full", 1,
                                                                   hw))) == fwd
    o, lse = res[0]
    assert counted(lambda: fa.flash_attention_bwd_plain(qs, k, v, o, lse, do, "full", 1,
                                                        hw)) == bwd


@pytest.mark.parametrize("just_2d", [False, True])
def test_denoiser_call_cost_matches_flop_counter(just_2d):
    """Every product of a T = 1 call of the tiny model (plain versions on
    the CPU), and its weights' bytes."""
    model = build_model("cpu", torch.float32, 0, **TINY_CONFIG)
    cfg = model.cfg
    r, ch = cfg.img_resolution, cfg.img_channels
    g = torch.Generator().manual_seed(2)
    ctx = torch.randn((1, 3, r, r, ch), generator=g)
    x, s, c = (torch.randn((1, 1, r, r, ch), generator=g), torch.ones(1, 1),
               torch.zeros((1, 1), dtype=torch.long))
    with torch.no_grad():
        _, cache = model(ctx, torch.full((1, 3), 0.05), torch.zeros((1, 3), dtype=torch.long),
                         cache=init_cache(model, 1, device="cpu"), update_cache=True)
        got = counted(lambda: model(x, s, c, just_2d=True) if just_2d
                      else model(x, s, c, cache=cache))
    rows = denoiser_call_cost(cfg, torch.float32, cfg.max_frames, just_2d=just_2d)
    assert sum(row[2] for row in rows) == got
    if not just_2d:  # a cached call reads every weight (just_2d: not the context taps)
        no_weights = denoiser_call_cost(cfg, torch.float32, cfg.max_frames, 0)
        n_w = sum(p.numel() for n, p in model.named_parameters() if n.endswith(".w"))
        assert sum(row[3] for row in rows) - sum(row[3] for row in no_weights) == 4 * n_w
    assert {row[1] for row in rows} == {"plain", "decode_block", "full_attention"}


def last_json(text: str, key: str) -> dict:
    line = [ln for ln in text.splitlines() if ln.startswith("{")][-1]
    return json.loads(line)[key]


def test_decode_budget_runs(capsys):
    res = decode_budget.main(["--device", "cpu", "--config", "tiny", "--num-steps", "2",
                              "--frames", "2"])
    out = capsys.readouterr().out
    assert out.startswith("# card: cpu")
    for part in ("3 NFE/frame", "cost model / NFE", "H100 floors / NFE", "launches / NFE",
                 "us/NFE", "residual over the floor"):
        assert part in out, part
    summary = last_json(out, "decode_budget")
    # a marginal time on a busy CPU can come out negative: only its form is held here
    assert summary["nfe_per_frame"] == 3 and summary["finite"]
    assert math.isfinite(res["us_per_nfe"]) and res["us_per_nfe"] == summary["us_per_nfe"]
    assert summary["gflop_per_nfe"] > 0 and summary["floor_hbm_us"] > 0
    assert decode_budget.nfe_per_frame(64, 1.5) == 254


def test_kernel_bench_runs(capsys, tmp_path):
    csv = tmp_path / "k.csv"
    res = kernel_bench.main(["--device", "cpu", "--config", "tiny", "--batch", "1",
                             "--frames", "2", "--iters", "1", "--csv", str(csv)])
    out = capsys.readouterr().out
    assert out.startswith("# card: cpu") and "a DART step's convs" in out
    calls = fc.conv_calls(build_model("cpu", torch.float32, 0, **TINY_CONFIG).cfg)
    assert len(res["shapes"]) == len({s for _, s in calls})
    assert sum(r["calls_a_step"] for r in res["shapes"]) == len(calls)
    assert len(csv.read_text().splitlines()) == 1 + 4 * len(res["shapes"])
    assert last_json(out, "kernel_bench")["shapes"] == len(res["shapes"])


def test_profile_train_runs(capsys):
    res = profile_train.main(["--device", "cpu", "--config", "tiny", "--batch", "1",
                              "--frames", "2", "--scan", "1", "--top", "5"])
    out = capsys.readouterr().out
    assert out.startswith("# card: cpu") and "TOTAL(top5)" in out
    assert len(res["top"]) == 5 and res["where"].startswith("host")
    assert last_json(out, "profile_train")["scan"] == 1
