"""A run with its timed path broken underneath comes out not correct: each
fault a cell can have, at a tiny size on the CPU (the harness's look for a
card is skipped; the rest of the run is the cell's own)."""
import time

import pytest
import torch
from conftest import tiny_cell

from perf_bench import harness
from perf_bench.control import planted


def run(cell, **kw):
    return harness.measure(cell, 20231118, 1, False, "cpu", time.perf_counter(), **kw)


@pytest.fixture(scope="module")
def port():
    import autoregressive_diffusion_tpu_torch.sampling as sampling
    import autoregressive_diffusion_tpu_torch.train as train
    import autoregressive_diffusion_tpu_torch.train.train_state as train_state
    return sampling, train, train_state


@pytest.mark.parametrize("cell", ["gym_rollout", "cs_rollout"])
def test_rollout_sound_run_is_correct(cell):
    assert run(tiny_cell(cell))["correct"]


@pytest.mark.parametrize("cell", ["gym_rollout", "cs_rollout"])
@pytest.mark.parametrize("fault", ["cache_unchanged", "one_session_cache", "half_the_sessions",
                                   "frame_altered"])
def test_rollout_fault_is_not_correct(cell, fault, port, monkeypatch):
    sampling = port[0]
    real = sampling.generate

    def altered(model, cache, n, shape, conditioning=None, generator=None, **kw):
        x, new = real(model, cache, n, shape, conditioning, generator, **kw)
        x = x.clone()
        x[..., 0] = -x[..., 0]
        return x, new

    broken = altered if fault == "frame_altered" else planted(fault, 0, 4, real)
    monkeypatch.setattr(sampling, "generate", broken)
    res = run(tiny_cell(cell))
    assert not res["correct"]
    if "cache" in fault:  # the cache check catches a stale cache by itself
        assert res["checks"]["cache_gap"]["value"] > res["checks"]["cache_gap"]["limit"]


def test_train_sound_run_is_correct():
    assert run(tiny_cell("cs_train"))["correct"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch"])
def test_train_fault_is_not_correct(fault, port, monkeypatch):
    _, train, train_state = port
    if fault == "state_unchanged":
        def update(self, opt, count, specs=None, mesh=None):
            with torch.no_grad():
                for g in opt.param_groups:
                    for p in g["params"]:
                        p.grad = None
            return torch.zeros(())
        monkeypatch.setattr(train.ClippedAdamW, "update", update)
        monkeypatch.setattr(train_state, "forced_weight_norm", lambda *a, **k: None)
        monkeypatch.setattr(train_state, "ema_update", lambda *a, **k: None)
    else:
        real = train_state.edm2_loss

        def half(model, images, seed, cfg, conditioning=None, coefs=None, just_2d=False,
                 sample_offset=0, sigma=None, noise=None, mesh=None):
            loss, aux = real(model, images, seed, cfg, conditioning, coefs, just_2d,
                             sample_offset, sigma, noise, mesh)
            keep = sample_offset < 1  # the first of the two samples; the mean over it
            return loss * (2.0 if keep else 0.0), aux
        monkeypatch.setattr(train_state, "edm2_loss", half)
    assert not run(tiny_cell("cs_train"))["correct"]
