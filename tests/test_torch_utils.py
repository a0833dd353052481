"""The port's remaining utilities against the JAX package on the CPU:
utils/misc.py (EasyDict, assert_shape, tile_images, find_nonfinite,
nan_guard, compare_caches over the port's cache dicts), utils/stats.py (the
moments against the JAX Collector in one process, and pooled over two gloo
ranks spawned by parallel.run_local_ranks), utils/plotting.py (the moving
average and the loss-vs-sigma fit's numbers against the JAX functions, the
dashboard written), train/ema.traditional_ema_beta (rtol 1e-6: both are
fp32 host arithmetic) and utils/profiling.py (a trace window, a span as
its record_function range, its top kernels, and the benchmark timer)."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoregressive_diffusion_tpu.train.ema import traditional_ema_beta as j_beta
from autoregressive_diffusion_tpu.train.loss_weight import fourier_eval as j_fourier_eval
from autoregressive_diffusion_tpu.utils import misc as jmisc
from autoregressive_diffusion_tpu.utils import plotting as jplot
from autoregressive_diffusion_tpu.utils import stats as jstats
from autoregressive_diffusion_tpu_torch.models import Precond, UNetConfig, init_cache
from autoregressive_diffusion_tpu_torch.parallel import run_local_ranks
from autoregressive_diffusion_tpu_torch.train import MultiNoiseState
from autoregressive_diffusion_tpu_torch.train.ema import traditional_ema_beta
from autoregressive_diffusion_tpu_torch.utils import misc, plotting, profiling, stats

from test_torch_sp_workers import stats_rank


def test_easydict_and_assert_shape():
    d = misc.EasyDict(a=1)
    d.b = 2
    assert d == {"a": 1, "b": 2} and d.a == 1
    del d.a
    with pytest.raises(AttributeError):
        _ = d.a
    misc.assert_shape(torch.zeros((2, 3, 4)), (2, None, 4))
    for shape in ((2, 4), (2, 3, 5)):
        with pytest.raises(AssertionError):
            misc.assert_shape(torch.zeros((2, 3, 4)), shape)


@pytest.mark.parametrize("grid", [dict(grid_w=3), dict(grid_h=2), {}])
def test_tile_images_equals_jax(grid):
    imgs = np.arange(5 * 2 * 3 * 1).reshape(5, 2, 3, 1).astype(np.float32)
    want = jmisc.tile_images(imgs, **grid)
    np.testing.assert_array_equal(misc.tile_images(torch.from_numpy(imgs), **grid), want)


def test_find_nonfinite_and_nan_guard(capsys):
    state = {"a": torch.ones(3), "b.c": torch.tensor([1.0, float("nan"), float("inf")]),
             "n": torch.tensor([1, 2]), "nested": {"d": torch.full((2,), float("nan"))}}
    bad = misc.find_nonfinite(state)
    assert bad == ["b.c: 2/3 non-finite", "nested.d: 2/2 non-finite"]
    want = jmisc.find_nonfinite({k: np.asarray(v) for k, v in state.items() if k != "nested"})
    assert len(want) == 1 and "2/3" in want[0]
    x = torch.tensor([1.0, float("nan")])
    assert misc.nan_guard(x, "y") is x
    assert misc.nan_guard(torch.ones(2), "z") is not None
    out = capsys.readouterr().out.splitlines()
    assert out == ["NaN-guard [y]: non_finite=True", "NaN-guard [z]: non_finite=False"]


def test_compare_caches_on_port_caches():
    cfg = UNetConfig(img_resolution=8, img_channels=4, model_channels=8, channel_mult=(1, 2),
                     num_blocks=1, video_attn_resolutions=(4,), frame_attn_resolutions=(),
                     max_frames=4, channels_per_head=8)
    model = Precond(cfg, body_dtype=torch.bfloat16)
    a, b = init_cache(model, 1, device="cpu"), init_cache(model, 1, device="cpu")
    assert misc.compare_caches(a, b) == []
    b["enc"]["4x4_block0"]["conv_res1"]["act"] += 0.5
    b["frames"] = 3
    diffs = misc.compare_caches(a, b)
    assert diffs == ["/enc/4x4_block0/conv_res1/act: max abs diff 5.000e-01",
                     "/frames: values differ"]
    del b["dec"]
    assert "/dec: present in only one cache" in misc.compare_caches(a, b)
    ja = {"x": jnp.ones(3), "sub": {"y": jnp.zeros(2)}}
    jb = {"x": jnp.ones(3), "sub": {"y": jnp.zeros(2) + 1e-2}}
    ta = {"x": torch.ones(3), "sub": {"y": torch.zeros(2)}}
    tb = {"x": torch.ones(3), "sub": {"y": torch.zeros(2) + 1e-2}}
    assert misc.compare_caches(ta, tb) == jmisc.compare_caches(ja, jb)


def test_stats_moments_equal_jax():
    values = [[1.0, 2.0, 3.0], [4.0], [np.nan, np.inf, -2.5], []]
    jc, tc = jstats.Collector(regex="t_mom_j.*"), stats.Collector(regex="t_mom.*")
    for v in values:
        jstats.report("t_mom_j/x", v)
        stats.report("t_mom/x", torch.tensor(v) if v else v)
    stats.report0("t_mom/r0", 5.0)
    jc.update()
    tc.update()
    for f in ("num", "mean", "std"):
        assert getattr(tc, f)("t_mom/x") == pytest.approx(getattr(jc, f)("t_mom_j/x"), rel=1e-12)
    assert tc.num("t_mom/x") == 5 and tc.mean("t_mom/r0") == 5.0
    assert tc["t_mom/x"] == tc.mean("t_mom/x")
    assert set(tc.as_dict()) == {"t_mom/x", "t_mom/r0"}
    tc.update()  # nothing new: keep_previous keeps the last period
    assert tc.num("t_mom/x") == 5


def test_stats_pool_over_two_gloo_ranks():
    values = [[1.0, 2.0, float("nan")], [3.0, 4.0, 5.0, 6.0]]
    flat = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    for res in run_local_ranks(stats_rank, 2, (values,), timeout=120):
        num, mean, std = res["x"]
        assert num == 6 and mean == pytest.approx(np.mean(flat))
        assert std == pytest.approx(np.std(flat))
        assert res["r0"] == (1, 10.0, 0.0)  # report0: rank 0's value alone


def test_plotting_numbers_and_dashboard(tmp_path):
    losses = np.abs(np.sin(np.arange(57))) + 0.1
    for w in (1, 5, 100):
        np.testing.assert_allclose(plotting.moving_average(losses, w),
                                   jplot.moving_average(losses, w), rtol=1e-12)
    coefs = np.random.default_rng(0).normal(size=(7, 1)).astype(np.float32) * 0.1
    sig = np.logspace(-2, 2, 200, dtype=np.float32)
    from autoregressive_diffusion_tpu_torch.train.loss_weight import fourier_eval
    np.testing.assert_allclose(
        fourier_eval(torch.from_numpy(coefs), torch.from_numpy(sig)).numpy(),
        np.asarray(j_fourier_eval(jnp.asarray(coefs), jnp.asarray(sig))), rtol=1e-5)
    assert plotting.have_matplotlib()
    ns = MultiNoiseState()
    ns.add_data(np.exp(np.random.default_rng(1).normal(size=(4, 6))).astype(np.float32),
                np.ones((4, 6), np.float32))
    path = tmp_path / "dash" / "dashboard_step_3.png"
    plotting.plot_training_dashboard(str(path), losses.tolist(), 3, ns, coefs,
                                     mse_steps=[0.5, 0.2, 0.1],
                                     rollout_frames=np.zeros((3, 8, 8, 3), np.uint8),
                                     unet_params=46_000_000)
    assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("args", [(0, 32), (1000, 32), (1e6, 256, 0.5),
                                  (5e6, 64, 10.0, None), (123456, 16, 0.05, 0.2)])
def test_traditional_ema_beta_equals_jax(args):
    assert traditional_ema_beta(*args) == pytest.approx(float(j_beta(*args)), rel=1e-6)


def test_profiling_trace_top_ops_and_benchmark(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path), "t.json") as prof:
        with profiling.span("my_range", kind="x"):  # a record_function range in the window
            (x @ x).sum()
    names = [e.get("name") for e in json.loads((tmp_path / "t.json").read_text())["traceEvents"]]
    assert "my_range" in names and "aten::mm" in names
    assert profiling.top_ops(prof) == []  # no card: no device-side events
    # the raw-event counts behind every sum, against key_averages()
    counts, device = profiling.event_totals(prof)
    averaged = {e.key: e.count for e in prof.key_averages()}
    assert device == {} and counts["aten::mm"] == averaged["aten::mm"] == 1
    assert counts["my_range"] == averaged["my_range"]
    calls = []
    r = profiling.benchmark(lambda: calls.append(1), warmup=2, iters=10)
    assert len(calls) == 2 + 1 + 1 + 10 and r["iters"] == 10.0 and r["device"] == "cpu"
    assert r["long_s"] > 0 and r["short_s"] > 0
