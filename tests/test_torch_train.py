"""The port's training slice against the JAX package on the CPU, fp32, at
the tiny config of tests/test_torch_model.py with bridged weights: the
train-mode Precond (DART and just_2d), edm2_loss with injected sigma and
noise, and every gradient leaf against jax.grad (AD_TPU_FUSED_CONV=0: the
JAX package's CPU path), at std-of-diff <= 3e-4 (of the leaf's std, for
gradients); the host-side helpers (schedule, EMA exponents, Fourier loss
weight, forced weight norm) at 1e-6; and microbatch accumulation against
the full batch. One jitted JAX function per mode gives the output, the loss
and the gradients, so the file pays two JAX compiles."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoregressive_diffusion_tpu.models import Precond as JPrecond
from autoregressive_diffusion_tpu.models import UNetConfig as JConfig
from autoregressive_diffusion_tpu.train import ema as j_ema
from autoregressive_diffusion_tpu.train import loss as j_loss
from autoregressive_diffusion_tpu.train import loss_weight as j_lw
from autoregressive_diffusion_tpu.train import optim as j_optim
from autoregressive_diffusion_tpu_torch.models import Precond, UNetConfig
from autoregressive_diffusion_tpu_torch.train import (
    EDM2LossConfig, MultiNoiseState, create_train_state, edm2_loss, exp_to_std,
    fit_and_broadcast, forced_weight_norm, fourier_eval, learning_rate_schedule,
    make_optimizer, make_train_step, power_function_beta, std_to_exp, top_losses)
from autoregressive_diffusion_tpu_torch.train import cli
from autoregressive_diffusion_tpu_torch.utils import load_jax_variables, to_jax_names

TOL = 3e-4
CFG = dict(img_resolution=16, img_channels=4, label_dim=4, model_channels=16,
           channel_mult=(1, 2), num_blocks=1, video_attn_resolutions=(8,),
           frame_attn_resolutions=(16,), max_frames=8, channels_per_head=16)
B, T = 2, 3
LOSS = dict(P_mean=1.2, P_std=1.0, sigma_data=1.0, context_noise_reduction=0.5)


def sdiff(a, b):
    return float(np.std(np.asarray(a, np.float64) - np.asarray(b, np.float64)))


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def batch(just_2d, seed=0):
    rng = np.random.default_rng(seed)
    f = T if just_2d else 2 * T
    images = rng.normal(size=(B, T, 16, 16, 4)).astype(np.float32)
    sigma = np.exp(rng.normal(size=(B, f)) * 0.8).astype(np.float32)
    noise = (sigma[:, :, None, None, None]
             * rng.normal(size=(B, f, 16, 16, 4))).astype(np.float32)
    cond = rng.integers(0, 4, size=(B, T)).astype(np.int32)
    coefs = (0.1 * rng.normal(size=(7, 1))).astype(np.float32)
    return images, sigma, noise, cond, coefs


class Tap:
    """The JAX model with its last output kept, so that one traced function
    returns the denoiser output beside the loss."""

    def __init__(self, model):
        self.model, self.out = model, None

    def apply(self, *args, **kwargs):
        res = self.model.apply(*args, **kwargs)
        self.out = res[0]
        return res


@pytest.fixture(scope="module")
def models():
    jm = JPrecond(JConfig(**CFG), sigma_data=1.0)
    variables = jax.jit(jm.init, static_argnames=("mode",))(
        jax.random.PRNGKey(0), jnp.zeros((1, 1, 16, 16, 4)), jnp.ones((1, 1)),
        jnp.zeros((1, 1), jnp.int32), mode="eval")
    # nonzero gains so the UNet body reaches the output
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: (jnp.full_like(v, 0.7) if str(p[-1].key) in ("emb_gain", "out_gain")
                      else v), variables["params"])
    variables = {"params": params, "buffers": variables["buffers"]}
    tm = Precond(UNetConfig(**CFG), sigma_data=1.0)
    load_jax_variables(tm, jax.tree.map(np.asarray, variables))
    return jm, variables, tm.train()


@pytest.fixture(scope="module")
def both_sides(models):
    """{just_2d: (jax results, torch results)}: output, loss, per-frame
    losses and gradients of one loss call from the same inputs."""
    jm, variables, tm = models
    mp = pytest.MonkeyPatch()
    mp.setenv("AD_TPU_FUSED_CONV", "0")
    mp.setenv("AD_TPU_FLASH", "0")
    cfg_j = j_loss.EDM2LossConfig(**LOSS)
    out = {}
    try:
        for just_2d in (False, True):
            images, sigma, noise, cond, coefs = batch(just_2d)

            def f(params, images, sigma, noise, cond, coefs):
                tap = Tap(jm)
                loss, aux = j_loss.edm2_loss(
                    tap, {"params": params, "buffers": variables["buffers"]}, images,
                    jax.random.PRNGKey(0), cfg_j, cond, coefs, just_2d, sigma=sigma,
                    noise=noise)
                return loss, (aux, tap.out)

            (loss_j, (aux_j, out_j)), grads_j = jax.jit(jax.value_and_grad(f, has_aux=True))(
                variables["params"], *map(jnp.asarray, (images, sigma, noise, cond, coefs)))
            res_j = dict(loss=float(loss_j), losses=np.asarray(aux_j["losses"]),
                         sigma=np.asarray(aux_j["sigma"]),
                         unweighted=float(aux_j["unweighted"]), out=np.asarray(out_j),
                         grads=flat(grads_j))

            tm.zero_grad(set_to_none=True)
            tap_out = {}
            hook = tm.register_forward_hook(lambda m, a, r: tap_out.update(out=r[0].detach()))
            loss_t, aux_t = edm2_loss(
                tm, torch.from_numpy(images), 0, EDM2LossConfig(**LOSS),
                torch.from_numpy(cond).long(), torch.from_numpy(coefs), just_2d,
                sigma=torch.from_numpy(sigma), noise=torch.from_numpy(noise))
            hook.remove()
            loss_t.backward()
            res_t = dict(loss=float(loss_t.detach()), losses=aux_t["losses"].numpy(),
                         sigma=aux_t["sigma"].numpy(), unweighted=float(aux_t["unweighted"]),
                         out=tap_out["out"].numpy(),
                         grads=to_jax_names({n: p.grad for n, p in tm.named_parameters()}))
            out[just_2d] = (res_j, res_t)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("just_2d", [False, True], ids=["dart", "just_2d"])
def test_precond_train_mode_matches_jax(both_sides, just_2d):
    res_j, res_t = both_sides[just_2d]
    assert res_t["out"].shape == res_j["out"].shape == (B, T if just_2d else 2 * T, 16, 16, 4)
    assert sdiff(res_t["out"], res_j["out"]) <= TOL
    assert float(np.std(res_j["out"])) > 0.1  # the body reaches the output


@pytest.mark.parametrize("just_2d", [False, True], ids=["dart", "just_2d"])
def test_edm2_loss_matches_jax(both_sides, just_2d):
    res_j, res_t = both_sides[just_2d]
    assert abs(res_t["loss"] - res_j["loss"]) <= TOL * max(1.0, abs(res_j["loss"]))
    assert abs(res_t["unweighted"] - res_j["unweighted"]) <= TOL * max(1.0, res_j["unweighted"])
    np.testing.assert_allclose(res_t["sigma"], res_j["sigma"], rtol=1e-6)
    np.testing.assert_allclose(res_t["losses"], res_j["losses"], rtol=1e-3, atol=TOL)


@pytest.mark.parametrize("just_2d", [False, True], ids=["dart", "just_2d"])
def test_gradients_match_jax_leaf_by_leaf(both_sides, just_2d):
    res_j, res_t = both_sides[just_2d]
    gj, gt = res_j["grads"], res_t["grads"]
    # leaves no gradient reaches are absent on the torch side and zero in JAX
    for name in set(gj) - set(gt):
        assert float(np.abs(gj[name]).max()) == 0.0, name
    assert set(gt) <= set(gj)
    checked = 0
    for name, want in gj.items():
        if name not in gt:
            continue
        got = gt[name]
        assert got.shape == want.shape, name
        # a leaf's scale: its std; its rms where the std is 0 (a scalar, or
        # the two gating offsets, whose gradients are equal by construction)
        scale = float(np.std(want)) or float(np.sqrt(np.mean(np.square(want))))
        if scale == 0.0:
            assert float(np.abs(got).max()) <= 1e-7, name
            continue
        err = float(np.sqrt(np.mean(np.square(got - want)))) / scale
        assert err <= TOL, (name, err)
        checked += 1
    # just_2d leaves the context weights and the gatings without a gradient
    assert checked > (50 if just_2d else 100)


def test_learning_rate_schedule_matches_jax():
    for step in (0, 1, 10, 500, 1000, 5e4, 7e4, 2e5, 1e6):
        for kw in ({}, dict(ref_lr=3e-3, ref_step=1e3, rampup_steps=0),
                   dict(ref_lr=1e-2, ref_step=0, rampup_steps=100)):
            want = float(j_loss.learning_rate_schedule(step, **kw))
            assert abs(learning_rate_schedule(step, **kw) - want) <= 1e-6 * max(want, 1e-3)


def test_ema_helpers_match_jax():
    stds = np.array([0.01, 0.05, 0.1, 0.2])
    np.testing.assert_allclose(std_to_exp(stds), j_ema.std_to_exp(stds), rtol=1e-6)
    exps = np.array([0.5, 3.0, 17.0])
    np.testing.assert_allclose(exp_to_std(exps), j_ema.exp_to_std(exps), rtol=1e-6)
    np.testing.assert_allclose(exp_to_std(std_to_exp(stds)), stds, rtol=1e-6)
    for std in (0.05, 0.1):
        assert abs(power_function_beta(std, 64.0, 8.0)
                   - j_ema.power_function_beta(std, 64.0, 8.0)) <= 1e-6


def test_fourier_loss_weight_matches_jax():
    rng = np.random.default_rng(4)
    coefs = (0.3 * rng.normal(size=(7, 1))).astype(np.float32)
    sigma = np.exp(rng.normal(size=(3, 5))).astype(np.float32)
    got = fourier_eval(torch.from_numpy(coefs), torch.from_numpy(sigma)).numpy()
    want = np.asarray(j_lw.fourier_eval(jnp.asarray(coefs), jnp.asarray(sigma)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    sig = np.exp(rng.normal(size=(40, 5))).astype(np.float32)
    los = (sig ** -0.7 * np.exp(0.1 * rng.normal(size=sig.shape))).astype(np.float32)
    mine, theirs = MultiNoiseState(), j_lw.MultiNoiseState()
    for chunk in range(4):
        mine.add_data(sig[chunk * 10:(chunk + 1) * 10], los[chunk * 10:(chunk + 1) * 10])
        theirs.add_data(sig[chunk * 10:(chunk + 1) * 10], los[chunk * 10:(chunk + 1) * 10])
    np.testing.assert_allclose(fit_and_broadcast(mine), j_lw.fit_and_broadcast(theirs),
                               atol=1e-6)
    assert fit_and_broadcast(MultiNoiseState()).shape == (7, 1)


def test_forced_weight_norm_matches_jax(models):
    _, variables, _ = models
    rng = np.random.default_rng(5)
    tree = jax.tree.map(lambda v: np.asarray(v) * rng.uniform(0.5, 2.0), variables["params"])
    want = flat(j_optim.forced_weight_norm(jax.tree.map(jnp.asarray, tree)))
    named = {k.replace("/", "."): torch.from_numpy(np.array(v, np.float32))
             for k, v in flat(tree).items()}
    got = to_jax_names(forced_weight_norm(named))
    assert set(got) == set(want)
    n_w = 0
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=1e-6, atol=1e-6, err_msg=name)
        n_w += name.endswith("/w")
    assert n_w > 30


def test_top_losses_matches_jax():
    err = np.random.default_rng(6).uniform(size=(2, 3, 4, 4, 2)).astype(np.float32)
    np.testing.assert_allclose(top_losses(torch.from_numpy(err), 0.25).numpy(),
                               np.asarray(j_loss.top_losses(jnp.asarray(err), 0.25)), atol=1e-6)


def test_optimizer_clip_is_optax_clip():
    """clip / max(norm, clip): untouched below the threshold, exactly the
    threshold above it (torch's clip_grad_norm_ divides by norm + 1e-6)."""
    for scale, want_norm in ((1e-3, None), (10.0, 0.1)):
        p = torch.nn.Parameter(torch.ones(4, 4))
        tx = make_optimizer(1e-3)
        opt = tx.init([p])
        g = scale * torch.arange(16.0).reshape(4, 4)
        p.grad = g.clone()
        norm = tx.update(opt, 0)
        assert abs(float(norm) - float(g.norm())) <= 1e-6 * float(g.norm())
        if want_norm is None:
            assert torch.equal(p.grad, g)
        else:
            assert abs(float(p.grad.norm()) - want_norm) <= 1e-7


def test_train_step_microbatch_matches_full(models):
    """Accumulating over microbatch slices equals the full batch: every
    sample draws sigma and noise from its own (seed, index) generator."""
    _, variables, _ = models
    rng = np.random.default_rng(7)
    images = torch.from_numpy(rng.normal(size=(4, T, 16, 16, 4)).astype(np.float32))
    cond = torch.from_numpy(rng.integers(0, 4, size=(4, T))).long()
    results = []
    for microbatch in (None, 2):
        tm = Precond(UNetConfig(**CFG), sigma_data=1.0)
        load_jax_variables(tm, jax.tree.map(np.asarray, variables))
        tx = make_optimizer(1e-3)
        state = create_train_state(tm.train(), tx)
        step = make_train_step(EDM2LossConfig(**LOSS), tx, 4, microbatch)
        state, m = step(state, images, cond, seed=11)
        grads = {n: p.grad.clone() for n, p in tm.named_parameters()}  # after the clip
        results.append((m, grads, state))
    (m_full, g_full, s_full), (m_acc, g_acc, s_acc) = results
    assert s_full.step == s_acc.step == 1
    assert torch.equal(m_full["sigma"], m_acc["sigma"])
    assert abs(float(m_full["loss"]) - float(m_acc["loss"])) <= 1e-5
    assert abs(float(m_full["grad_norm"]) - float(m_acc["grad_norm"])) \
        <= 1e-4 * float(m_full["grad_norm"])
    torch.testing.assert_close(m_full["losses"], m_acc["losses"], rtol=1e-4, atol=1e-6)
    for n, g in g_full.items():
        scale = float(g.abs().max())
        assert float((g - g_acc[n]).abs().max()) <= 1e-4 * scale + 1e-9, n
    # the weights moved and stayed unit-norm; the first EMA update copies them
    moved = [n for n, p in s_full.params.items()
             if n.endswith(".w") and not np.allclose(
                 p.detach().numpy(), flat(jax.tree.map(np.asarray, variables["params"]))[
                     n.replace(".", "/")])]
    assert len(moved) > 30
    for n, p in s_full.params.items():
        assert torch.equal(s_full.ema[0][n], p.detach()), n


@pytest.mark.parametrize("source,group", [("fused_conv_fwd.cu", "conv_forward"),
                                          ("fused_conv_bwd.cu", "conv_backward")])
def test_profile_groups_hold_every_conv_kernel(source, group):
    """Every kernel of the conv sources lands in its conv group of `train
    --profile` (the groups match kernels by name, so a renamed or new kernel
    would otherwise count as elementwise work)."""
    text = (Path(cli.__file__).parents[1] / "csrc" / source).read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", text)
    assert len(names) >= 4, names
    for name in names:
        # as the profiler names it: demangled, with namespaces, template arguments and parameters
        key = f"void (anonymous namespace)::tc::{name}<64, true>(int, float const*)"
        assert cli.kernel_group(key) == group, name
