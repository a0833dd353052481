"""The port's drift tools (rollout_drift.py, drift_sweep.py) on the CPU:

  * the drift loop (prefill the context at sigma 0.05, sample each next
    frame conditioned on the episode's action) and its latent series
    against the JAX script's loop, restated here from the functions it
    calls (scripts/rollout_drift.py:185-216), at a tiny random config with
    S_churn=0 and each frame's initial noise injected, at std-of-diff
    <= 1e-3 (the repo's bound for sampler trajectories); the pixel series
    against the script's formula on the same uint8 videos;
  * collect_long_episode's frames, actions and next seed equal the JAX
    script's function for one short episode of each policy (gymnasium);
  * the committed episodes file round-trips through save_episodes and
    load_episodes, and drift_sweep runs one cell in process on it (the
    tool reading episodes, not gymnasium) with a tiny bundle, parsing the
    tool's 0-based summary line, which the JAX tool's regex misses;
    without the file and without gymnasium the tool raises."""
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoregressive_diffusion_tpu.models import Precond as JPrecond
from autoregressive_diffusion_tpu.models import UNetConfig as JConfig
from autoregressive_diffusion_tpu.models.cache import init_cache as j_init_cache
from autoregressive_diffusion_tpu.sampling.sampler import edm_sampler as j_edm_sampler
from autoregressive_diffusion_tpu_torch import drift_sweep, rollout_drift
from autoregressive_diffusion_tpu_torch.models import Precond, UNetConfig, init_weights
from autoregressive_diffusion_tpu_torch.utils import jax_variables, save_model

ROOT = Path(__file__).resolve().parent.parent
CFG = dict(img_resolution=16, img_channels=4, label_dim=4, model_channels=16,
           channel_mult=(1, 2), num_blocks=1, video_attn_resolutions=(8,),
           frame_attn_resolutions=(16,), max_frames=8, channels_per_head=16)
KW = dict(num_steps=4, sigma_max=80.0, sigma_min=0.002, rho=7.0, S_churn=0.0, guidance=1.0)


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads: the tier-1 run shares the cores among its
    workers, and torch's default of one thread a core then oversubscribes
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def sdiff(a, b):
    return float(np.std(np.asarray(a, np.float64) - np.asarray(b, np.float64)))


def jax_script():
    spec = importlib.util.spec_from_file_location("jax_rollout_drift",
                                                  ROOT / "scripts" / "rollout_drift.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_drift_loop_equals_jax_script_loop():
    context, n_frames, b = 2, 2, 1
    model = init_weights(Precond(UNetConfig(**CFG), sigma_data=1.0), seed=5).eval()
    jm = JPrecond(JConfig(**CFG), sigma_data=1.0)
    v = jax.tree.map(jnp.asarray, jax_variables(model))
    rng = np.random.default_rng(3)
    z = rng.normal(size=(b, context + n_frames, 16, 16, 4)).astype(np.float32)
    acts = rng.integers(0, 4, size=(b, context + n_frames)).astype(np.int64)
    x_inits = [(rng.normal(size=(b, 1, 16, 16, 4)) * KW["sigma_max"]).astype(np.float32)
               for _ in range(n_frames)]

    # the JAX script's loop (scripts/rollout_drift.py:185-216), x_init injected
    prefill = jax.jit(lambda v_, x_, s_, c_, ca: jm.apply(
        v_, x_, s_, c_, cache=ca, mode="eval", update_cache=True, prefill_offset=0))
    sampler = jax.jit(lambda v_, ca, c_, xi: j_edm_sampler(
        jm, v_, ca, jax.random.PRNGKey(0), shape=(b, 1, 16, 16, 4), conditioning=c_,
        x_init=xi, **KW))
    zj, aj = jnp.asarray(z), jnp.asarray(acts, jnp.int32)
    ctx, gt = zj[:, :context], zj[:, context:]
    cache = j_init_cache(jm, v, batch_size=b)
    _, cache = prefill(v, ctx, jnp.full((b, context), 0.05, jnp.float32), aj[:, :context],
                       cache)
    gen_frames = []
    for i in range(n_frames):
        x, _, _, cache = sampler(v, cache, aj[:, context + i:context + i + 1],
                                 jnp.asarray(x_inits[i]))
        gen_frames.append(x)
    gen_j = np.asarray(jnp.concatenate(gen_frames, axis=1))
    gt_np, last_ctx = np.asarray(gt), np.asarray(ctx[:, -1:])
    want = dict(latent_mse=((gen_j - gt_np) ** 2).mean(axis=(0, 2, 3, 4)),
                persistence_mse=((last_ctx - gt_np) ** 2).mean(axis=(0, 2, 3, 4)),
                gen_std=gen_j.std(axis=(0, 2, 3, 4)), gt_std=gt_np.std(axis=(0, 2, 3, 4)))

    gen = rollout_drift.rollout_latents(
        model, torch.from_numpy(z), torch.from_numpy(acts), context, n_frames,
        x_inits=[torch.from_numpy(x) for x in x_inits], **KW).numpy()
    assert float(np.std(gen_j)) > 0.1
    assert sdiff(gen, gen_j) <= 1e-3
    got = rollout_drift.latent_series(gen, z[:, context:], z[:, context - 1:context])
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-3, err_msg=k)

    tc = 4
    px_gen, px_gt = (rng.integers(0, 256, size=(1, n_frames * tc, 8, 8, 3)).astype(np.uint8)
                     for _ in range(2))
    per_px_frame = (((px_gen.astype(np.float32) - px_gt.astype(np.float32)) ** 2)
                    .mean(axis=(0, 2, 3, 4)) / 255.0 ** 2)
    np.testing.assert_allclose(rollout_drift.pixel_series(px_gen, px_gt, n_frames),
                               per_px_frame.reshape(n_frames, -1).mean(axis=1), rtol=1e-6)


@pytest.mark.parametrize("policy", ["heuristic", "random"])
def test_collect_long_episode_equals_jax(policy):
    want = jax_script().collect_long_episode("LunarLander-v3", 8, 4, 0, frame_size=32,
                                             policy=policy)
    got = rollout_drift.collect_long_episode("LunarLander-v3", 8, 4, 0, frame_size=32,
                                             policy=policy)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] and got[0].shape == (8, 32, 32, 3)


def test_episodes_file_and_sweep_cell(tmp_path, monkeypatch):
    path = ROOT / rollout_drift.EPISODES_FILE
    episodes, meta = rollout_drift.load_episodes(path)
    assert meta == {"env": "LunarLander-v3", "policy": "heuristic", "seed": 0, "tc": 4}
    assert [s for _, _, s in episodes] == [6, 15, 33]
    assert all(f.shape == (144, 256, 256, 3) and a.shape == (36,) for f, a, _ in episodes)
    small = [(f[:8, ::8, ::8], a[:2], s) for f, a, s in episodes[:2]]
    rollout_drift.save_episodes(tmp_path / "e.npz", small, policy="heuristic")
    back, _ = rollout_drift.load_episodes(tmp_path / "e.npz")
    for (f, a, s), (f2, a2, s2) in zip(small, back):
        assert np.array_equal(f, f2) and np.array_equal(a, a2) and s == s2

    # a tiny denoiser on the trained VAE's 64x64x8 latents of the 256-px frames
    cfg = dict(img_resolution=64, img_channels=8, label_dim=4, model_channels=8,
               channel_mult=(1, 2), num_blocks=1, video_attn_resolutions=(),
               frame_attn_resolutions=(), max_frames=8)
    model = init_weights(Precond(UNetConfig(**cfg), sigma_data=1.0), seed=0)
    bundle = tmp_path / "unet_tiny.ad"
    save_model(bundle, {k: list(v) if isinstance(v, tuple) else v for k, v in cfg.items()},
               jax_variables(model))
    monkeypatch.setattr(drift_sweep, "REPO", str(tmp_path))
    results = drift_sweep.main(["--in-process", "--cells", "no-churn", "--episodes", "1",
                                "--frames", "1", "--unet", str(bundle),
                                "--vae", str(ROOT / "saved_models" / "vae_lunar_lander.ad"),
                                "--episodes-file", str(path), "--device", "cpu"])
    assert [r[0] for r in results] == ["no-churn"] and np.isfinite(results[0][1:]).all()
    with np.load(tmp_path / "build" / "drift_sweep" / "no-churn" / "drift.npz") as z:
        assert sorted(z.files) == sorted(["latent_mse", "persistence_mse", "pixel_mse",
                                          "gen_std", "gt_std"])
        assert z["latent_mse"].shape == (1,)

    line = rollout_drift.summary_line("heuristic", [0.0149, 0.03, 0.0472], [0.0289] * 3,
                                      [1.0, 1.0, 1.025], [1.0] * 3)
    assert line == ("# [heuristic] latent MSE frame0=0.0149 frame2=0.0472 "
                    "(persistence 0.0289); std drift 1.025x truth")
    assert drift_sweep.parse_summary(line) == (0.0149, 2, 0.0472, 0.0289, 1.025)
    spec = importlib.util.spec_from_file_location("jax_drift_sweep",
                                                  ROOT / "tools" / "drift_sweep.py")
    jsweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jsweep)
    assert jsweep.SUMMARY.search(line) is None  # the JAX tool reads frame1=

    monkeypatch.setitem(sys.modules, "gymnasium", None)  # no gymnasium, no file
    with pytest.raises(RuntimeError, match="gymnasium is not installed"):
        rollout_drift.main(["--unet", str(bundle), "--vae",
                            str(ROOT / "saved_models" / "vae_lunar_lander.ad"),
                            "--device", "cpu", "--out", str(tmp_path / "none")])
