"""The port's gym training loop on the CPU, fp32, tiny configs: the
scanned and replay train steps against plain loops of make_train_step (bit
for bit, with injected sigma and noise); the sampler callback's prefill and
MSE sampler against the JAX package's edm_sampler (S_churn=0, injected
x_init, std-of-diff <= 1e-3, the repo's bound for multi-call sampler
trajectories) and its shapes; and gym_train run for 8 steps and resumed,
its learning rates against the JAX package's schedule, and its two replay
modes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoregressive_diffusion_tpu.models import Precond as JPrecond
from autoregressive_diffusion_tpu.models import UNetConfig as JConfig
from autoregressive_diffusion_tpu.models import init_cache as j_init_cache
from autoregressive_diffusion_tpu.sampling import edm_sampler as j_edm_sampler
from autoregressive_diffusion_tpu.train import learning_rate_schedule as j_schedule
from autoregressive_diffusion_tpu_torch import gym_train
from autoregressive_diffusion_tpu_torch.models import Precond, UNetConfig, init_weights
from autoregressive_diffusion_tpu_torch.sampling import make_sampler_callback, mse_probe
from autoregressive_diffusion_tpu_torch.train import (EDM2LossConfig, create_train_state,
                                                      make_optimizer, make_replay_train_step,
                                                      make_scanned_train_step,
                                                      make_train_step, step_seed)
from autoregressive_diffusion_tpu_torch.utils import (latest_step, load_jax_variables,
                                                      train_state_tree)

CFG = dict(img_resolution=16, img_channels=4, label_dim=4, model_channels=16,
           channel_mult=(1, 2), num_blocks=1, video_attn_resolutions=(8,),
           frame_attn_resolutions=(16,), max_frames=8, channels_per_head=16)
LOSS = EDM2LossConfig(P_mean=1.2, P_std=1.0, context_noise_reduction=0.5)
B, T, G = 2, 3, 3


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


def fresh_state(lr=1e-2):
    model = init_weights(Precond(UNetConfig(**CFG), sigma_data=1.0), 3, gains=0.7).train()
    tx = make_optimizer(lr)
    return create_train_state(model, tx), tx


def assert_trees_equal(a, b, prefix=""):
    assert set(a) == set(b), prefix
    for k in a:
        if isinstance(a[k], dict):
            assert_trees_equal(a[k], b[k], f"{prefix}{k}/")
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=prefix + k)


@pytest.mark.parametrize("kind,just_2d", [("replay", False), ("replay", True),
                                          ("scanned", False)])
def test_grouped_steps_equal_single_steps_bit_for_bit(kind, just_2d):
    rng = np.random.default_rng(0)
    buf = torch.from_numpy(rng.normal(size=(7, T, 16, 16, 4)).astype(np.float32))
    buf_cond = torch.from_numpy(rng.integers(0, 4, size=(7, T)).astype(np.int32))
    idx = np.stack([rng.choice(7, B, replace=False) for _ in range(G)]).astype(np.int32)
    f = T if just_2d else 2 * T
    sigma = torch.from_numpy(np.exp(rng.normal(size=(G, B, f)) * 0.8).astype(np.float32))
    noise = sigma[..., None, None, None] * torch.from_numpy(
        rng.normal(size=(G, B, f, 16, 16, 4)).astype(np.float32))

    state_a, tx_a = fresh_state()
    state_b, tx_b = fresh_state()
    # a refitted loss weight, as after a dashboard
    state_a.coefs.copy_(torch.from_numpy((0.1 * rng.normal(size=(7, 1))).astype(np.float32)))
    state_b.coefs.copy_(state_a.coefs)
    step = make_train_step(LOSS, tx_a, B)
    rows = []
    for j in range(G):
        ix = torch.from_numpy(idx[j]).long()
        state_a, m = step(state_a, buf[ix], buf_cond[ix].long(), step_seed(11, state_a.step),
                          just_2d, sigma[j], noise[j])
        rows.append(m)
    if kind == "replay":
        grouped = make_replay_train_step(LOSS, tx_b, B)
        state_b, mg = grouped(state_b, buf, buf_cond, idx, 11, just_2d, sigma, noise)
        np.testing.assert_array_equal(mg["unweighted"].numpy(),
                                      np.stack([m["unweighted"].numpy() for m in rows]))
    else:
        grouped = make_scanned_train_step(LOSS, tx_b, B)
        ix = torch.from_numpy(idx).long()
        state_b, mg = grouped(state_b, buf[ix], buf_cond[ix].long(), 11, just_2d, sigma, noise)
        assert mg["unweighted"].shape == ()
    assert state_a.step == state_b.step == G
    assert_trees_equal(train_state_tree(state_a), train_state_tree(state_b))
    np.testing.assert_array_equal(mg["loss_per_step"].numpy(),
                                  np.stack([m["loss"].numpy() for m in rows]))
    assert mg["sigma"].shape == mg["losses"].shape == (G * B, T)
    np.testing.assert_array_equal(mg["sigma"].numpy(),
                                  torch.cat([m["sigma"] for m in rows]).numpy())
    np.testing.assert_array_equal(mg["grad_norm"].numpy(), rows[-1]["grad_norm"].numpy())


def test_replay_step_draws_its_own_noise_from_the_step_seeds():
    """Without injected noise, step j of a group draws what a single step
    seeded with step_seed(seed, step) draws."""
    rng = np.random.default_rng(1)
    buf = torch.from_numpy(rng.normal(size=(5, T, 16, 16, 4)).astype(np.float32))
    buf_cond = torch.zeros((5, T), dtype=torch.int32)
    idx = np.array([[0, 3], [4, 1]], np.int32)
    state_a, tx_a = fresh_state()
    state_b, tx_b = fresh_state()
    step = make_train_step(LOSS, tx_a, B)
    for j in range(2):
        ix = torch.from_numpy(idx[j]).long()
        state_a, _ = step(state_a, buf[ix], buf_cond[ix].long(), step_seed(5, state_a.step))
    state_b, _ = make_replay_train_step(LOSS, tx_b, B)(state_b, buf, buf_cond, idx, 5)
    assert_trees_equal(train_state_tree(state_a), train_state_tree(state_b))


@pytest.fixture(scope="module")
def bridged():
    jm = JPrecond(JConfig(**CFG), sigma_data=1.0)
    v = jax.jit(jm.init, static_argnames=("mode",))(
        jax.random.PRNGKey(2), jnp.zeros((1, 1, 16, 16, 4)), jnp.ones((1, 1)),
        jnp.zeros((1, 1), jnp.int32), mode="eval")
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: (jnp.full_like(a, 0.5) if str(p[-1].key) in ("emb_gain", "out_gain")
                      else a), v["params"])
    v = {"params": params, "buffers": v["buffers"]}
    tm = load_jax_variables(Precond(UNetConfig(**CFG), sigma_data=1.0),
                            jax.tree.map(np.asarray, v)).train()
    return jm, v, tm


def test_callback_mse_probe_matches_jax(bridged):
    """The callback's prefill (4 frames at sigma 0.05, no conditioning) and
    its MSE sampler (sigma_max 3, rho 7, the target added to x_init, cache
    not updated) against the JAX package's, with S_churn=0 so no noise is
    drawn."""
    jm, v, tm = bridged
    rng = np.random.default_rng(6)
    lat = rng.normal(size=(2, 5, 16, 16, 4)).astype(np.float32)
    x_init = (rng.normal(size=(1, 1, 16, 16, 4)) * 3.0).astype(np.float32)
    n_ctx, steps = 4, 4

    prefill = jax.jit(lambda v_, x_, s_, ca: jm.apply(v_, x_, s_, cache=ca, update_cache=True,
                                                      mode="eval"))
    _, jc = prefill(v, jnp.asarray(lat[:1, :n_ctx]), jnp.full((1, n_ctx), 0.05),
                    j_init_cache(jm, v, 1))
    sampler = jax.jit(lambda v_, ca, xi, tg: j_edm_sampler(
        jm, v_, ca, jax.random.PRNGKey(0), (1, 1, 16, 16, 4), num_steps=steps,
        sigma_max=3.0, rho=7.0, S_churn=0.0, update_cache=False, target=tg, x_init=xi))
    jx, jmses, jmses_pred, _ = sampler(v, jc, jnp.asarray(x_init),
                                       jnp.asarray(lat[:1, n_ctx:n_ctx + 1]))

    x, mses, mses_pred = mse_probe(tm, torch.from_numpy(lat), None, num_steps=steps,
                                   n_context=n_ctx, S_churn=0.0,
                                   x_init=torch.from_numpy(x_init))
    assert sdiff(x, jx) <= 1e-3
    np.testing.assert_allclose(mses.numpy(), np.asarray(jmses), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(mses_pred.numpy(), np.asarray(jmses_pred), rtol=1e-3, atol=1e-4)
    assert float(mses[-1]) < float(mses[0])


@pytest.mark.parametrize("training", [True, False])
def test_callback_shapes_and_mode(bridged, training):
    """Finite per-step MSEs and a rollout of prefill + generated latents, as
    tests/test_sampler.py holds the JAX callback; the model keeps its mode
    and no autograd graph is built."""
    _, _, tm = bridged
    tm.train(training)
    cb = make_sampler_callback(tm, num_mse_steps=4, n_context=3, n_prefill=2, n_rollout=2)
    latents = torch.randn((2, 5, 16, 16, 4), generator=torch.Generator().manual_seed(5))
    mses, mses_pred, roll = cb(latents, torch.Generator().manual_seed(6))
    assert mses.shape == mses_pred.shape == (4,)
    assert np.isfinite(mses).all() and np.isfinite(mses_pred).all()
    assert tuple(roll.shape) == (1, 4, 16, 16, 4) and bool(torch.isfinite(roll).all())
    assert not roll.requires_grad
    np.testing.assert_array_equal(roll[:, :2].numpy(), latents[:1, :2].numpy())
    assert tm.training == training
    assert all(p.grad is None for p in tm.parameters())
    tm.train()


def test_gym_train_runs_resumes_and_follows_the_schedule(tmp_path):
    common = ["--device", "cpu", "--config", "tiny", "--synthetic", "--batch", "2",
              "--micro-batch", "2", "--state-size", "8", "--ckpt-every", "4",
              "--ckpt-dir", str(tmp_path / "ck"), "--out-dir", str(tmp_path / "img")]
    first = gym_train.main(common + ["--steps", "8"])
    assert first.state.step == 8 and first.state.model.training
    assert first.unet_cfg.img_resolution == 16 and first.unet_cfg.img_channels == 8
    assert sorted(first.lrs) == list(range(8))
    for i, lr in first.lrs.items():
        assert lr == float(j_schedule(i, 1e-2, 8 / 50, 8 / 50))
    assert first.lrs[0] == 0.0 and len(first.losses) == 8
    assert np.isfinite(first.losses).all()
    assert latest_step(tmp_path / "ck") == 8
    assert (tmp_path / "ck" / "unet_0M.ad").exists()

    second = gym_train.main(common + ["--steps", "12", "--resume"])
    assert second.start == 8 and second.state.step == 12
    assert sorted(second.lrs) == list(range(8, 12))
    for i, lr in second.lrs.items():
        assert lr == float(j_schedule(i, 1e-2, 12 / 50, 12 / 50))
    assert len(second.losses) == 12 and second.losses[:8] == first.losses
    assert latest_step(tmp_path / "ck") == 12
    steps = sorted(p.name for p in (tmp_path / "ck").iterdir() if p.name.startswith("step_"))
    assert steps == ["step_000000005", "step_000000008", "step_000000012"]


def test_gym_train_refuses_to_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gym_train.build_trainer(gym_train.parse_args(["--synthetic"]))


@pytest.mark.parametrize("mode", [["--replay", "8"], ["--replay", "8", "--replay-device"]])
def test_gym_train_replay_modes(tmp_path, mode):
    """--replay samples encoded clips from a host ring, --replay-device from
    rings on the device in groups of steps (one just_2d step, then three):
    both reach --steps with one loss a step."""
    tr = gym_train.main(["--device", "cpu", "--config", "tiny", "--synthetic", "--batch", "2",
                         "--micro-batch", "2", "--state-size", "8", "--steps", "5",
                         "--ckpt-every", "100", "--ckpt-dir", str(tmp_path / "ck"),
                         "--out-dir", str(tmp_path / "img"), *mode])
    assert tr.state.step == 5 and len(tr.losses) == 5 and np.isfinite(tr.losses).all()
    assert sorted(tr.lrs) == list(range(5))
    assert latest_step(tmp_path / "ck") == 5
