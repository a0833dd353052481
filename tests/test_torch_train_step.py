"""Two full train steps of the port against the JAX package's
make_train_step on the CPU, fp32, tiny config, bridged state. The JAX step
draws sigma and noise from its PRNG key; the test repeats those draws with
the same jax.random calls and injects them into the port's step. Compared:
loss, per-frame losses, the gradient norm before the clip, the clipped
gradient (through Adam's first moment), the parameters and both EMA trees
after each step.

Tolerances. Adam's first update is lr * g / (|g| + eps): where |g| is near
eps = 1e-8 a last-bit difference in g flips the update, so parameters and
EMA are compared where the JAX side's clipped |g| > 1e-7 = 10 eps, at
0.05 * lr. (The clip leaves a gradient of norm 0.1 over 0.49M elements;
its distribution is heavy-tailed and a good part of them lies below that.)"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoregressive_diffusion_tpu.models import Precond as JPrecond
from autoregressive_diffusion_tpu.models import UNetConfig as JConfig
from autoregressive_diffusion_tpu import train as j_train
from autoregressive_diffusion_tpu_torch.models import Precond, UNetConfig
from autoregressive_diffusion_tpu_torch.train import (EDM2LossConfig, create_train_state,
                                                      make_optimizer, make_train_step)
from autoregressive_diffusion_tpu_torch.utils import load_jax_train_state, to_jax_names

CFG = dict(img_resolution=16, img_channels=4, label_dim=4, model_channels=16,
           channel_mult=(1, 2), num_blocks=1, video_attn_resolutions=(8,),
           frame_attn_resolutions=(16,), max_frames=8, channels_per_head=16)
B, T, LR = 2, 3, 1e-3
LOSS = dict(P_mean=1.2, P_std=1.0, sigma_data=1.0, context_noise_reduction=0.5)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def jax_draws(key, cfg, shape):
    """sigma (b, 2t) and noise (b, 2t, h, w, c) as edm2_loss draws them for
    the DART step from `key`."""
    b, t = shape[:2]

    def draw(i):
        k_sig, k_ctx, k_noise = jax.random.split(jax.random.fold_in(key, i), 3)
        sig_noisy = jnp.exp(jax.random.normal(k_sig, (t,)) * cfg.P_std + cfg.P_mean)
        sig_ctx = jax.random.uniform(k_ctx, ()) * cfg.context_noise_reduction
        sig = jnp.concatenate([jnp.broadcast_to(sig_ctx, (t,)), sig_noisy])
        eps = jax.random.normal(k_noise, (2 * t,) + tuple(shape[2:]), jnp.float32)
        return sig, eps

    sigma, eps = jax.vmap(draw)(jnp.arange(b))
    return np.asarray(sigma), np.asarray(sigma[:, :, None, None, None] * eps)


def adam_mu(opt_state):
    """The first-moment tree of optax's chain(clip, adamw) state."""
    found = []

    def walk(node):
        if hasattr(node, "mu"):
            found.append(node.mu)
        elif isinstance(node, (tuple, list)):
            for n in node:
                walk(n)

    walk(opt_state)
    assert len(found) == 1
    return found[0]


@pytest.fixture(scope="module")
def steps():
    """[(jax state, jax metrics, torch snapshot, torch metrics)] after step
    1 and step 2, plus the start parameters."""
    mp = pytest.MonkeyPatch()
    mp.setenv("AD_TPU_FUSED_CONV", "0")
    mp.setenv("AD_TPU_FLASH", "0")
    try:
        jm = JPrecond(JConfig(**CFG), sigma_data=1.0)
        variables = jax.jit(jm.init, static_argnames=("mode",))(
            jax.random.PRNGKey(0), jnp.zeros((1, 1, 16, 16, 4)), jnp.ones((1, 1)),
            jnp.zeros((1, 1), jnp.int32), mode="eval")
        params = jax.tree_util.tree_map_with_path(
            lambda p, v: (jnp.full_like(v, 0.7) if str(p[-1].key) in ("emb_gain", "out_gain")
                          else v), variables["params"])
        variables = {"params": params, "buffers": variables["buffers"]}
        cfg_j = j_train.EDM2LossConfig(**LOSS)
        tx_j = j_train.make_optimizer(learning_rate=LR)
        state_j = j_train.create_train_state(jm, variables, tx_j)
        coefs = (0.1 * np.random.default_rng(1).normal(size=(7, 1))).astype(np.float32)
        state_j = state_j.replace(coefs=jnp.asarray(coefs))
        step_j = jax.jit(j_train.make_train_step(jm, cfg_j, tx_j, batch_size=B),
                         static_argnames=("just_2d",))

        tm = Precond(UNetConfig(**CFG), sigma_data=1.0).train()
        tx_t = make_optimizer(LR)
        state_t = create_train_state(tm, tx_t)
        np_tree = lambda tr: jax.tree.map(np.asarray, tr)
        load_jax_train_state(state_t, np_tree(state_j.params), np_tree(state_j.buffers),
                             [np_tree(e) for e in state_j.ema], coefs)
        step_t = make_train_step(EDM2LossConfig(**LOSS), tx_t, B)

        rng = np.random.default_rng(0)
        out = [flat(np_tree(state_j.params))]
        for i in range(2):
            images = rng.normal(size=(B, T, 16, 16, 4)).astype(np.float32)
            cond = rng.integers(0, 4, size=(B, T)).astype(np.int32)
            key = jax.random.PRNGKey(100 + i)
            sigma, noise = jax_draws(key, cfg_j, images.shape)
            state_j, m_j = step_j(state_j, jnp.asarray(images), jnp.asarray(cond), key)
            state_t, m_t = step_t(state_t, torch.from_numpy(images),
                                  torch.from_numpy(cond).long(), seed=0,
                                  sigma=torch.from_numpy(sigma.copy()),
                                  noise=torch.from_numpy(noise.copy()))
            snap = dict(params=to_jax_names(state_t.params),
                        ema=[to_jax_names(e) for e in state_t.ema],
                        exp_avg={n.replace(".", "/"):
                                 state_t.opt_state.state[p]["exp_avg"].numpy().copy()
                                 for n, p in state_t.params.items()},
                        step=state_t.step)
            out.append((jax.tree.map(np.asarray, state_j), jax.tree.map(np.asarray, m_j),
                        snap, {k: np.asarray(v) for k, v in m_t.items()}))
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("i", [1, 2])
def test_step_metrics_match_jax(steps, i):
    state_j, m_j, snap, m_t = steps[i]
    assert snap["step"] == int(state_j.step) == i
    assert abs(float(m_t["loss"]) - float(m_j["loss"])) <= 3e-4 * max(1.0, float(m_j["loss"]))
    np.testing.assert_allclose(m_t["sigma"], m_j["sigma"], rtol=1e-6)
    np.testing.assert_allclose(m_t["losses"], m_j["losses"], rtol=1e-3, atol=3e-4)
    # the global norm before the clip
    assert abs(float(m_t["grad_norm"]) - float(m_j["grad_norm"])) \
        <= 1e-3 * float(m_j["grad_norm"])


def test_clipped_gradient_matches_jax(steps):
    """After step 1 Adam's first moment is 0.1 * the clipped gradient: its
    global norm is 0.1 * the clip threshold on both sides (the raw norm is
    far above 0.1), and the leaves agree."""
    state_j, m_j, snap, _ = steps[1]
    assert float(m_j["grad_norm"]) > 0.1
    mu_j = flat(adam_mu(state_j.opt_state))
    mu_t = snap["exp_avg"]
    assert set(mu_j) == set(mu_t)
    for mu in (mu_j, mu_t):
        norm = np.sqrt(sum(float(np.sum(np.square(v.astype(np.float64)))) for v in mu.values()))
        assert abs(norm - 0.1 * 0.1) <= 1e-5
    for name, want in mu_j.items():
        scale = float(np.abs(want).max())
        assert float(np.abs(mu_t[name] - want).max()) <= 2e-3 * scale + 1e-9, name


@pytest.mark.parametrize("i", [1, 2])
def test_parameters_and_ema_after_the_step_match_jax(steps, i):
    state_j, _, snap, _ = steps[i]
    start = steps[0]
    params_j = flat(state_j.params)
    mu_j = flat(adam_mu(state_j.opt_state))
    tol = 0.05 * LR
    compared = moved = 0
    for name, want in params_j.items():
        # the clipped gradients that went into the moment so far
        live = np.abs(mu_j[name]) > (1e-8 if i == 1 else 2e-8)
        got = snap["params"][name]
        assert got.shape == want.shape, name
        assert float(np.abs(got - want)[live].max(initial=0.0)) <= tol, name
        compared += int(live.sum())
        moved += int((np.abs(want - start[name]) > 0.5 * LR)[live].sum())
        for k, ema_j in enumerate(state_j.ema):
            e_want = flat(ema_j)[name]
            assert float(np.abs(snap["ema"][k][name] - e_want)[live].max(initial=0.0)) <= tol, \
                (name, k)
    total = sum(v.size for v in params_j.values())
    assert compared > 0.5 * total, compared / total
    assert moved > 0.8 * compared  # the step did move those weights, by about lr each


def test_ema_trees_differ_from_the_parameters_after_two_steps(steps):
    """beta is 0 at step 1 (the EMA copies the weights) and positive at step
    2: there the EMA lags, by std-dependent amounts, as in JAX."""
    state_j, _, snap, _ = steps[2]
    lag = [float(np.mean([np.abs(snap["ema"][k][n] - snap["params"][n]).mean()
                          for n in snap["params"]])) for k in range(2)]
    lag_j = [float(np.mean([np.abs(flat(state_j.ema[k])[n] - flat(state_j.params)[n]).mean()
                            for n in snap["params"]])) for k in range(2)]
    assert lag[0] > 0 and lag[1] > 0 and lag[0] != lag[1]
    np.testing.assert_allclose(lag, lag_j, rtol=1e-2)
