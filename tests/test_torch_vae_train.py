"""VAE training in the port against the JAX package on the CPU, fp32:
gaussian_loss, the seeded VAE and discriminator inits (their law), the
blur pools, the MixedDiscriminator in train and eval mode (logits and the
batch_stats it moves, flax's way) and its two losses, the discriminator
against the original torch model's recorded tensors
(tests/reference_parity/fixtures/vae_discriminator.npz), the bridge both
ways, and one step of each training script (gym_vae_train, cs_vae_train,
cs_vae_adversarial) against the JAX script's step restated from its lines,
with t and the latent noise injected: losses and every gradient, then the
parameters, Adam moments and batch_stats after the step, then the losses of
three steps. JAX's variables come across through the bridge; each JAX step
is compiled once. Inputs come from numpy seeds."""
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from autoregressive_diffusion_tpu.models import discriminator as jdisc
from autoregressive_diffusion_tpu.models import vae as jvae
from autoregressive_diffusion_tpu.ops import numerics as jnum
from autoregressive_diffusion_tpu.train import perceptual as jperc
from autoregressive_diffusion_tpu.utils.checkpoint import load_model as j_load_model
from autoregressive_diffusion_tpu_torch import cs_vae_adversarial, cs_vae_train, gym_vae_train
from autoregressive_diffusion_tpu_torch.models import discriminator as tdisc
from autoregressive_diffusion_tpu_torch.models import vae as tvae
from autoregressive_diffusion_tpu_torch.ops.numerics import gaussian_loss
from autoregressive_diffusion_tpu_torch.utils import (flax_variables, load_flax_variables,
                                                      to_flax_names, vae_from_bundle)

ROOT = Path(__file__).resolve().parent.parent
FIX = ROOT / "tests" / "reference_parity" / "fixtures"
TOL = 3e-4       # tests/test_reference_parity.py
TOL_MULTI = 1e-3  # the repo's bound for several chained calls
B, T, HW = 2, 8, 16  # gym: batch 2 of 8 frames at 16x16


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads: the tier-1 run shares the cores among its
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def random_feature_perceptual(monkeypatch):
    """Both packages' perceptual_loss on their random-feature branch."""
    monkeypatch.delenv("AD_TPU_LPIPS_WEIGHTS", raising=False)
    monkeypatch.setenv("AD_TPU_LPIPS_CALIBRATED", "0")


def sdiff(a, b):
    return float(np.std(np.asarray(a, np.float64) - np.asarray(b, np.float64)))


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def rms(a):
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


def assert_leaves_close(got: dict, want: dict, tol: float, what: str):
    """Every leaf's rms difference over its rms, or over 1% of the whole
    tree's rms where that is larger (a leaf whose values are the remainder
    of a cancellation keeps the roundoff of the terms that cancelled); a
    leaf below 0.1% of the whole tree's rms is held against the whole's: the
    gradient of a bias ahead of a train-mode BatchNorm is 0 in exact
    arithmetic, and what both sides compute there is roundoff."""
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want))[:6])
    whole = rms(np.concatenate([np.ravel(v) for v in want.values()]))
    for name, w in want.items():
        r = rms(w)
        scale = whole if r < 1e-3 * whole else max(r, 1e-2 * whole)
        assert rms(got[name] - w) / scale <= tol, (what, name, rms(got[name] - w) / scale)


def grads_of(module):
    """The gradients in flax's names; a parameter no gradient reached (the
    logvar multiplier of a loss without the log-variance) as zeros, as JAX
    gives them."""
    return to_flax_names({n: p.grad if p.grad is not None else torch.zeros_like(p)
                          for n, p in module.named_parameters()})


def moments(opt, module, key):
    return to_flax_names({n: opt.state[p][key] for n, p in module.named_parameters()})


def adam_state(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


def capture_grads(monkeypatch, tx, module, into: dict, key: str):
    """Keep a copy of module's gradients as tx.update receives them (before
    its clip)."""
    update = tx.update

    def spy(opt, count):
        into[key] = grads_of(module)
        return update(opt, count)
    monkeypatch.setattr(tx, "update", spy)


def apply_vae(model, variables, frames, t, noise):
    """VAE.__call__ (models/vae.py:287-300) with t and noise injected, through
    VAE.encode and VAE.decode as the call does."""
    mean, _ = model.apply(variables, frames, method=jvae.VAE.encode)
    tb = t[:, None, None, None, None]
    r_mean, r_logvar, _ = model.apply(variables, mean * (1 - tb) + noise * tb, t,
                                      method=jvae.VAE.decode)
    return r_mean, r_logvar, mean


@functools.lru_cache(maxsize=None)
def _jax_init(cfg, hw):
    """The JAX scripts' inits (keys 0 and 1 the VAE, 2 the discriminator),
    jitted: one compile each for the whole module."""
    if cfg is None:
        model = jdisc.MixedDiscriminator()
        variables = jax.jit(model.init)(jax.random.PRNGKey(2), jnp.zeros((1, 8, hw, hw, 6)))
    else:
        model = jvae.VAE(jvae.VAEConfig(**cfg.__dict__))
        variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, hw, hw, 3)),
                                        key=jax.random.PRNGKey(1))
    return model, jax.tree.map(np.asarray, variables)


def jax_vae(cfg: tvae.VAEConfig, hw: int):
    """(JAX VAE, a fresh numpy copy of its initial variables)."""
    model, variables = _jax_init(cfg, hw)
    return model, jax.tree.map(np.array, variables)


def jax_disc(hw: int):
    model, variables = _jax_init(None, hw)
    return model, jax.tree.map(np.array, variables)


def step_inputs(seed, latent_shape, b=B, t=T, hw=HW):
    """uint8 frames of moving blobs and noise, a step's t and latent noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:hw, :hw] / hw
    base = np.stack([np.sin(5 * xx + k) * np.cos(3 * yy - k) for k in range(3)], -1)
    frames = np.clip(127.5 * (1 + base[None, None] + 0.4 * rng.normal(size=(b, t, hw, hw, 3))),
                     0, 255).astype(np.uint8)
    tt = (rng.uniform(size=(b,)) * 0.1).astype(np.float32)
    noise = rng.normal(size=latent_shape).astype(np.float32)
    return frames, tt, noise


# ---------------------------------------------------------------------------
# modules

def test_gaussian_loss_matches_jax():
    rng = np.random.default_rng(0)
    m, lv, x = (rng.normal(size=(2, 4, 8, 8, 3)).astype(np.float32) for _ in range(3))
    want = float(jnum.gaussian_loss(jnp.asarray(m), jnp.asarray(lv), jnp.asarray(x)))
    got = float(gaussian_loss(*map(torch.from_numpy, (m, lv, x))))
    assert abs(got - want) <= TOL * abs(want)


@pytest.mark.parametrize("cfg", [gym_vae_train.GYM_VAE, cs_vae_train.CS_VAE_SMALL],
                         ids=["gym", "cs_small"])
def test_init_vae_follows_the_jax_law(cfg):
    """init_vae's tree is the JAX init's (names, shapes, the same exact
    zeros: the kt - g oldest taps, biases, conv3d1, t_cond), its draws lie
    within the JAX bounds, the Fourier buffers follow 2 pi N(0, 1) and
    2 pi U(0, 1), the logvar multiplier is -2."""
    _, jv = jax_vae(cfg, 16)
    vae = tvae.init_vae(tvae.VAE(cfg), torch.Generator().manual_seed(0))
    tv = flax_variables(vae)
    want, got = flat(jv), flat(tv)
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    for name, w in want.items():
        # the zeros the law puts there: whole leaves, and whole time taps
        # (axis 0 of DHWIO) of the group-causal kernels
        assert (got[name] == 0).all() == (w == 0).all(), name
        if "conv3d0/kernel" in name:
            np.testing.assert_array_equal(np.all(got[name] == 0, axis=(1, 2, 3, 4)),
                                          np.all(w == 0, axis=(1, 2, 3, 4)), err_msg=name)
        if name.endswith("kernel"):
            fan_in = int(np.prod(w.shape[:-1]))
            scale = 32 ** -0.25 if "conv3d0" in name else 1.0
            assert np.abs(got[name]).max() <= scale * fan_in ** -0.5, name
            assert np.abs(w).max() <= scale * fan_in ** -0.5 * (1 + 1e-6), name
    for name, g in got.items():
        if name.endswith("freqs"):
            assert abs(g.std() / (2 * np.pi) - 1) < 0.6 and g.std() > 0
        if name.endswith("phases"):
            assert 0 <= g.min() and g.max() < 2 * np.pi
    assert float(vae.decoder.logvar_multiplier.detach()) == -2.0


def test_init_draws_have_the_uniform_std():
    """At a width with many draws a kernel: std = bound / sqrt(3) within 5%,
    on the group-causal kernel's live taps (scaled by 32^-0.25) and on the
    discriminator's convs; BatchNorm starts at scale 1, bias 0, mean 0,
    var 1."""
    vae = tvae.init_vae(tvae.VAE(cs_vae_train.CS_VAE_SMALL), torch.Generator().manual_seed(3))
    conv = vae.encoder.encoder_block_2.res_block_0.conv3d0  # 64 -> 2 x 64, kernel (4, 3, 3)
    w = conv.weight.detach()
    assert conv.group_size == 2 and torch.all(w[:, :, :2] == 0)
    want = w[0].numel() ** -0.5 / 3 ** 0.5 * 32 ** -0.25
    assert abs(float(w[:, :, 2:].std()) / want - 1) < 0.05
    disc = tdisc.init_discriminator(tdisc.MixedDiscriminator(), torch.Generator().manual_seed(4))
    w = disc.discriminator2d.block_0.conv1.weight.detach()
    assert abs(float(w.std()) / (w[0].numel() ** -0.5 / 3 ** 0.5) - 1) < 0.05
    bn = disc.discriminator2d.block_1.norm2
    assert float(bn.weight.detach().min()) == 1 == float(bn.var.max())
    assert float(bn.mean.abs().max()) == 0
    _, jv = jax_disc(16)
    assert {k: v.shape for k, v in flat(flax_variables(disc, "batch_stats")).items()} == \
        {k: v.shape for k, v in flat(jv).items()}


@pytest.mark.parametrize("dims", [2, 3])
def test_blur_pools_match_jax(dims):
    """Odd and even sizes, a leading axis for the 2D pool."""
    shape = (2, 3, 9, 10, 5) if dims == 2 else (2, 7, 9, 10, 5)
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    jf, tf = ((jdisc.blur_pool_2d, tdisc.blur_pool_2d) if dims == 2 else
              (jdisc.blur_pool_3d, tdisc.blur_pool_3d))
    want = np.asarray(jf(jnp.asarray(x)))
    got = tf(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and sdiff(got, want) <= TOL


@pytest.fixture(scope="module")
def discs():
    """The JAX discriminator's init with random running statistics, and the
    port's through the bridge."""
    jm, jv = jax_disc(16)
    rng = np.random.default_rng(5)

    def stats(tree):
        if "mean" in tree:
            return {"mean": rng.normal(0, 0.5, tree["mean"].shape).astype(np.float32),
                    "var": rng.uniform(0.5, 2.0, tree["var"].shape).astype(np.float32)}
        return {k: stats(v) for k, v in tree.items()}
    jv["batch_stats"] = stats(jv["batch_stats"])
    return jm, jv


def fresh_port_disc(jv):
    return load_flax_variables(tdisc.MixedDiscriminator(), jv, "discriminator bridge")


def test_discriminator_bridge_round_trip(discs):
    _, jv = discs
    back = flax_variables(fresh_port_disc(jv), "batch_stats")
    want, got = flat(jv), flat(back)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_discriminator_matches_jax(discs, train):
    """Logits (2D per frame ++ 3D along time) and, in train mode, the moved
    batch_stats."""
    jm, jv = discs
    x = np.random.default_rng(6).normal(size=(2, 8, 16, 16, 6)).astype(np.float32)
    if train:
        want, mutated = jm.apply(jv, jnp.asarray(x), True, mutable=["batch_stats"])
    else:
        want = jm.apply(jv, jnp.asarray(x), False)
    td = fresh_port_disc(jv)
    with torch.no_grad():
        got = td(torch.from_numpy(x), train).numpy()
    assert got.shape == want.shape == (2, 10, 4, 4, 2)
    assert sdiff(got, want) <= TOL and float(np.std(want)) > 1e-2
    stats = flat(flax_variables(td, "batch_stats")["batch_stats"])
    ref = flat(jax.tree.map(np.asarray, mutated["batch_stats"]) if train else jv["batch_stats"])
    assert_leaves_close(stats, ref, TOL, "batch_stats")
    if train:
        moved = flat(jv["batch_stats"])
        assert all(np.abs(stats[k] - moved[k]).max() > 0 for k in moved)


def test_discriminator_losses_match_jax(discs):
    """vae_adversarial_loss (eval mode) and discriminator_loss (train mode):
    the values, the VAE loss's gradient to recon and the discriminator
    loss's gradients to the parameters."""
    jm, jv = discs
    rng = np.random.default_rng(7)
    frames, recon = (rng.uniform(-1, 1, size=(2, 8, 16, 16, 3)).astype(np.float32)
                     for _ in range(2))
    f, r = jnp.asarray(frames), jnp.asarray(recon)

    @jax.jit
    def both(variables, f, r):
        (adv, _), drecon = jax.value_and_grad(
            lambda r_: jdisc.vae_adversarial_loss(jm, variables, f, r_, train=False),
            has_aux=True)(r)
        (dl, mut), dparams = jax.value_and_grad(
            lambda p: jdisc.discriminator_loss(jm, dict(variables, params=p), f, r, train=True),
            has_aux=True)(variables["params"])
        return adv, drecon, dl, mut, dparams

    adv_j, drecon_j, dl_j, mut, dparams_j = both(jv, f, r)
    td = fresh_port_disc(jv)
    rt = torch.from_numpy(recon).requires_grad_(True)
    adv_t = tdisc.vae_adversarial_loss(td, torch.from_numpy(frames), rt, train=False)
    adv_t.backward()
    td.zero_grad(set_to_none=True)
    dl_t = tdisc.discriminator_loss(td, torch.from_numpy(frames), rt, train=True)
    dl_t.backward()
    assert abs(float(adv_t.detach()) - float(adv_j)) <= TOL * abs(float(adv_j))
    assert abs(float(dl_t.detach()) - float(dl_j)) <= TOL * abs(float(dl_j))
    assert sdiff(rt.grad.numpy(), drecon_j) / float(np.std(drecon_j)) <= TOL
    assert_leaves_close(grads_of(td), flat(jax.tree.map(np.asarray, dparams_j)), TOL, "grads")
    assert_leaves_close(flat(flax_variables(td, "batch_stats")["batch_stats"]),
                        flat(jax.tree.map(np.asarray, mut["batch_stats"])), TOL, "stats")


def test_torch_batchnorm_would_move_other_statistics():
    """flax moves the running statistics by 1% of the batch's, with the
    biased variance; torch.nn.BatchNorm2d by its momentum (0.1) with the
    unbiased one, so its own update would give other batch_stats even at
    momentum 0.01. The port's BatchNorm gives flax's."""
    import flax.linen as nn

    x = np.random.default_rng(8).normal(1.0, 2.0, size=(2, 2, 2, 5)).astype(np.float32)
    jbn = nn.BatchNorm(use_running_average=False)
    jvars = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    _, mut = jbn.apply(jvars, jnp.asarray(x), mutable=["batch_stats"])
    want_mean = np.asarray(mut["batch_stats"]["mean"])
    want_var = np.asarray(mut["batch_stats"]["var"])
    xc = torch.from_numpy(x).permute(0, 3, 1, 2)  # channels-first
    port = tdisc.BatchNorm(5)
    port(xc, train=True)
    np.testing.assert_allclose(port.mean.numpy(), want_mean, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port.var.numpy(), want_var, rtol=1e-5, atol=1e-6)
    for momentum in (0.1, 0.01):  # torch's default, and flax's momentum in torch's terms
        bn = torch.nn.BatchNorm2d(5, momentum=momentum).train()
        bn(xc)
        assert np.abs(bn.running_var.numpy() / want_var - 1).max() > 10 * TOL
    assert np.abs(bn.running_mean.numpy() - want_mean).max() <= 1e-5  # at 0.01 only var


def test_discriminator_matches_the_original_fixture():
    """The original torch MixedDiscriminator in eval mode (recorded tensors),
    its state dict laid out as the JAX test lays it out
    (tests/test_reference_parity.py::test_vae_discriminator_parity)."""
    fx = dict(np.load(FIX / "vae_discriminator.npz"))

    def conv(p):
        w = fx[f"{p}/weight"]
        perm = (2, 3, 1, 0) if w.ndim == 4 else (2, 3, 4, 1, 0)
        return {"kernel": np.transpose(w, perm), "bias": fx[f"{p}/bias"]}

    def norm(p):
        return {"scale": fx[f"{p}/weight"], "bias": fx[f"{p}/bias"]}

    d2, d2s = {"conv_in": conv("discriminator2d/conv_in"),
               "conv_out": conv("discriminator2d/conv_out")}, {}
    for i in range(3):
        p = f"discriminator2d/blocks/{i}"
        d2[f"block_{i}"] = {"norm1": norm(f"{p}/norm1"), "norm2": norm(f"{p}/norm2"),
                            "conv1": conv(f"{p}/conv1"), "conv2": conv(f"{p}/conv2")}
        if i < 2:
            d2[f"block_{i}"]["shortcut_conv"] = conv(f"{p}/shortcut/1")
        d2s[f"block_{i}"] = {n: {"mean": fx[f"{p}/{n}/running_mean"],
                                 "var": fx[f"{p}/{n}/running_var"]} for n in ("norm1", "norm2")}
    d3 = {"conv_in": conv("discriminator3d/conv_in"), "conv_out": conv("discriminator3d/conv_out")}
    for i in range(2):
        p = f"discriminator3d/blocks/{i}"
        d3[f"block_{i}"] = {"norm1": norm(f"{p}/norm1"), "norm2": norm(f"{p}/norm2"),
                            "conv1": conv(f"{p}/conv1"), "conv2": conv(f"{p}/conv2"),
                            "shortcut_conv": conv(f"{p}/shortcut/{1 if i == 0 else 0}")}
    td = fresh_port_disc({"params": {"discriminator2d": d2, "discriminator3d": d3},
                          "batch_stats": {"discriminator2d": d2s}})
    x = np.transpose(fx["x"], (0, 2, 3, 4, 1))  # torch (b, c, t, h, w) -> (b, t, h, w, c)
    with torch.no_grad():
        got = td(torch.from_numpy(np.ascontiguousarray(x)), False).numpy()
    want = np.transpose(fx["y"], (0, 2, 3, 4, 1))  # torch (b, 2, t', h', w')
    assert got.shape == want.shape and sdiff(got, want) <= TOL


# ---------------------------------------------------------------------------
# one step of each script against the JAX script's step

def gym_jax_step(vm, vae_vars, dm, lr, steps):
    """scripts/gym_vae_train.py's step (:85-90 the optimizers, :92-121 the
    VAE loss, :123-128 the discriminator loss, :131-150 the step), with the
    key's t and noise injected; returns the gradients too."""
    gamma = 0.1 ** (1 / steps)
    sched = lambda lr0: (lambda s: lr0 * gamma ** s)  # noqa: E731
    tx_vae = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(sched(lr), eps=1e-8))
    tx_disc = optax.chain(optax.clip_by_global_norm(1.0),
                          optax.adamw(sched(lr * 8e-2), eps=1e-8))

    def vae_loss_fn(vp, dv, frames, t, noise):
        r_mean, r_logvar, mean = apply_vae(vm, dict(vae_vars, params=vp), frames, t, noise)
        recon = jvae.worst_k_percent_loss(r_mean, frames, percent=0.2)
        group_var = jnp.var(mean, axis=(0, 1, 2, 3)) + 1e-8
        group_mean = jnp.mean(mean, axis=(0, 1, 2, 3))
        kl_group = -0.5 * jnp.sum(1 + jnp.log(group_var) - group_mean ** 2 - group_var)
        fr = jnp.concatenate([frames, r_mean], axis=-1)
        rf = jnp.concatenate([r_mean, frames], axis=-1)
        logits = dm.apply(dv, jnp.concatenate([fr, rf], axis=0), False)
        n = frames.shape[0]
        logp = jax.nn.log_softmax(logits, axis=-1)
        ce = -jnp.concatenate([logp[:n, ..., 0], logp[n:, ..., 1]], axis=0) / np.log(2)
        adv = 2e-5 * jnp.mean(jax.nn.relu(ce - 1) ** 2)
        return recon + kl_group * 1e-3 + adv, jnp.stack([recon, kl_group, jnp.mean(ce)])

    def disc_loss_fn(dp, dvars, frames, recon):
        return jdisc.discriminator_loss(dm, dict(dvars, params=dp), frames, recon, train=True)

    @jax.jit
    def step(vp, opt_v, dp, opt_d, dvars, frames_u8, t, noise):
        frames = frames_u8.astype(t.dtype) / 127.5 - 1.0  # float32 in the script
        (_, aux), gv = jax.value_and_grad(vae_loss_fn, has_aux=True)(
            vp, dict(dvars, params=dp), frames, t, noise)
        upd, opt_v = tx_vae.update(gv, opt_v, vp)
        vp = optax.apply_updates(vp, upd)
        zero = jnp.zeros_like(t)  # key=None: t = 0, z = mean
        r_mean, _, _ = apply_vae(vm, dict(vae_vars, params=vp), frames, zero, jnp.zeros_like(noise))
        (dl, mutated), gd = jax.value_and_grad(disc_loss_fn, has_aux=True)(
            dp, dvars, frames, jax.lax.stop_gradient(r_mean))
        upd_d, opt_d = tx_disc.update(gd, opt_d, dp)
        dp = optax.apply_updates(dp, upd_d)
        metrics = jnp.concatenate([aux, dl[None]])
        return vp, opt_v, dp, opt_d, dict(dvars, params=dp, **mutated), metrics, gv, gd

    return tx_vae, tx_disc, step


def f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


@pytest.fixture
def float64():
    """The gym step in float64 on both sides: JAX under x64, the port's
    modules in double. Its discriminator update reads the VAE just updated,
    and there fp32 does not decide agreement at 3e-4: JAX's own fp32
    discriminator gradients lie 8.7e-4 (rms, of 2D conv kernels) from its
    float64 ones, and the port's fp32 ones from 3e-7 to 8.7e-4, by thread
    count. In float64 the two sides agree to about 1e-8; fp32 agreement of
    the discriminator's train-mode step alone is held above."""
    with jax.enable_x64(True):
        yield


def gym_trainer(argv, vv, dv):
    tr = gym_vae_train.build_trainer(gym_vae_train.parse_args(argv))
    load_flax_variables(tr.vae, vv)
    load_flax_variables(tr.disc, dv)
    tr.vae.double()
    tr.disc.double()
    return tr


def test_gym_vae_step_matches_jax(monkeypatch, float64):
    args = gym_vae_train.parse_args(["--device", "cpu", "--synthetic", "--frame-size", str(HW),
                                     "--state-size", str(T), "--batch", str(B), "--steps", "3"])
    vm, vv = jax_vae(gym_vae_train.GYM_VAE, HW)
    dm, dv = jax_disc(HW)
    tx_vae, tx_disc, step = gym_jax_step(vm, f64(vv), dm, args.lr, args.steps)
    vp, dp, dvars = f64(vv["params"]), f64(dv["params"]), f64(dv)
    opt_v, opt_d = tx_vae.init(vp), tx_disc.init(dp)
    tr = gym_trainer(["--device", "cpu", "--frame-size", str(HW), "--batch", str(B), "--steps",
                      "3"], vv, dv)
    grads = {}
    capture_grads(monkeypatch, tr.tx_vae, tr.vae, grads, "vae")
    capture_grads(monkeypatch, tr.tx_disc, tr.disc, grads, "disc")
    latent = (B, T // 4, HW // 4, HW // 4, 8)
    for i in range(3):
        frames, t, noise = step_inputs(10 + i, latent)
        vp, opt_v, dp, opt_d, dvars, m_j, gv, gd = step(
            vp, opt_v, dp, opt_d, dvars, jnp.asarray(frames), *map(jnp.asarray, f64((t, noise))))
        m_t = gym_vae_train.train_step(tr, frames, *map(torch.from_numpy, f64((t, noise))))
        m_j = np.asarray(m_j)
        np.testing.assert_allclose(m_t.numpy(), m_j, rtol=TOL if i == 0 else TOL_MULTI)
        if i:
            continue
        assert_leaves_close(grads["vae"], flat(jax.tree.map(np.asarray, gv)), TOL, "VAE grads")
        assert_leaves_close(grads["disc"], flat(jax.tree.map(np.asarray, gd)), TOL, "D grads")
        tv, td = flax_variables(tr.vae), flax_variables(tr.disc, "batch_stats")
        for got, want in ((tv["params"], vp), (td["params"], dp),
                          (td["batch_stats"], dvars["batch_stats"])):
            got, want = flat(got), flat(jax.tree.map(np.asarray, want))
            assert max(sdiff(got[k], want[k]) for k in want) <= TOL
        assert_leaves_close(flat(td["batch_stats"]), flat(jax.tree.map(
            np.asarray, dvars["batch_stats"])), TOL, "batch_stats")
        for opt, mod, st in ((tr.opt_vae, tr.vae, opt_v), (tr.opt_disc, tr.disc, opt_d)):
            adam = adam_state(st)
            assert_leaves_close(moments(opt, mod, "exp_avg"),
                                flat(jax.tree.map(np.asarray, adam.mu)), TOL, "mu")
            assert_leaves_close(moments(opt, mod, "exp_avg_sq"),
                                flat(jax.tree.map(np.asarray, adam.nu)), TOL, "nu")
    assert tr.count == 3


def cs_jax_step(vm, variables, lr, steps):
    """scripts/cs_vae_train.py's step (:64-71 the schedule and optimizer,
    :73-86 the loss and step), t and noise injected."""
    warmup = 100
    gamma = 0.4 ** (1 / max(steps - warmup, 1))

    def sched(s):
        return lr * jnp.where(s < warmup, s / warmup, gamma ** (s - warmup))

    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adamw(sched, eps=1e-8))

    def loss_fn(p, frames, t, noise):
        r_mean, r_logvar, _ = apply_vae(vm, dict(variables, params=p), frames, t, noise)
        g = jnum.gaussian_loss(r_mean, r_logvar, frames)
        perc = jperc.perceptual_loss(r_mean, frames)
        return g + 0.1 * perc, jnp.stack([g, perc, jnp.mean(jnp.abs(r_mean - frames))])

    @jax.jit
    def step(p, opt_state, frames, t, noise):
        (l, aux), g = jax.value_and_grad(loss_fn, has_aux=True)(p, frames, t, noise)
        upd, opt_state = tx.update(g, opt_state, p)
        return optax.apply_updates(p, upd), opt_state, aux, g

    return tx, step


CS_LATENT = (B, T // 4, HW // 8, HW // 8, 8)


def cs_inputs(seed):
    """[-1, 1] frames, t and latent noise of a CS step."""
    frames, t, noise = step_inputs(seed, CS_LATENT)
    return frames.astype(np.float32) / 127.5 - 1, t, noise


def test_cs_vae_step_matches_jax(monkeypatch):
    """cs_vae_train --small at 16x16, T = 8: the warmup's lr is 0 at the
    first update, so the moments carry the first step and the parameters
    move from the second."""
    args = cs_vae_train.parse_args(["--device", "cpu", "--small", "--frame-size", str(HW),
                                    "--clip-size", str(T), "--steps", "300"])
    vm, vv = jax_vae(cs_vae_train.CS_VAE_SMALL, HW)
    tx, step = cs_jax_step(vm, vv, args.lr, args.steps)
    p = vv["params"]
    opt = tx.init(p)
    tr = cs_vae_train.build_trainer(args)
    load_flax_variables(tr.vae, vv)
    grads = {}
    capture_grads(monkeypatch, tr.tx, tr.vae, grads, "vae")
    for i in range(3):
        frames, t, noise = cs_inputs(20 + i)
        p, opt, aux_j, g = step(p, opt, *map(jnp.asarray, (frames, t, noise)))
        aux_t = cs_vae_train.train_step(tr, *map(torch.from_numpy, (frames, t, noise)))
        got = np.array([float(aux_t[k]) for k in ("gaussian", "perceptual", "l1")])
        np.testing.assert_allclose(got, np.asarray(aux_j), rtol=TOL if i == 0 else TOL_MULTI)
        if i == 0:
            assert_leaves_close(grads["vae"], flat(jax.tree.map(np.asarray, g)), TOL, "grads")
            adam = adam_state(opt)
            assert_leaves_close(moments(tr.opt, tr.vae, "exp_avg"),
                                flat(jax.tree.map(np.asarray, adam.mu)), TOL, "mu")
            assert_leaves_close(moments(tr.opt, tr.vae, "exp_avg_sq"),
                                flat(jax.tree.map(np.asarray, adam.nu)), TOL, "nu")
        got_p, want_p = flat(flax_variables(tr.vae)["params"]), flat(jax.tree.map(np.asarray, p))
        assert max(sdiff(got_p[k], want_p[k]) for k in want_p) <= TOL
    moved = flat(jax.tree.map(np.asarray, vv["params"]))
    assert max(np.abs(got_p[k] - moved[k]).max() for k in moved) > 0


def adv_jax_step(vm, vae_vars, dm, lr, adv_weight):
    """scripts/cs_vae_adversarial.py's step (:66-69 the optimizers, :75-83
    the VAE loss, :85-101 the step), t and noise injected."""
    tx_vae = optax.chain(optax.clip_by_global_norm(0.5), optax.adamw(lr, eps=1e-8))
    tx_disc = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(lr, eps=1e-8))

    def vae_loss_fn(p, dvars, frames, t, noise):
        r_mean, r_logvar, _ = apply_vae(vm, dict(vae_vars, params=p), frames, t, noise)
        g = jnum.gaussian_loss(r_mean, r_logvar, frames)
        perc = jperc.perceptual_loss(r_mean, frames)
        adv, _ = jdisc.vae_adversarial_loss(dm, dvars, frames, r_mean, train=False)
        return g + 0.1 * perc + adv_weight * adv, (jnp.stack([g, perc, adv]), r_mean)

    @jax.jit
    def step(vp, opt_v, dp, opt_d, dvars, frames, t, noise):
        (_, (aux, recon)), gv = jax.value_and_grad(vae_loss_fn, has_aux=True)(
            vp, dict(dvars, params=dp), frames, t, noise)
        upd, opt_v = tx_vae.update(gv, opt_v, vp)
        vp = optax.apply_updates(vp, upd)
        recon = jax.lax.stop_gradient(recon)

        def d_loss(p):
            return jdisc.discriminator_loss(dm, dict(dvars, params=p), frames, recon, train=True)
        (dl, mutated), gd = jax.value_and_grad(d_loss, has_aux=True)(dp)
        upd_d, opt_d = tx_disc.update(gd, opt_d, dp)
        dp = optax.apply_updates(dp, upd_d)
        return (vp, opt_v, dp, opt_d, dict(dvars, params=dp, **mutated),
                jnp.concatenate([aux, dl[None]]), gv, gd)

    return tx_vae, tx_disc, step


def test_cs_vae_adversarial_step_matches_jax(monkeypatch, tmp_path):
    """cs_vae_adversarial --vae <a cs_vae_train --small bundle> at 16x16,
    T = 8: the discriminator steps on the pre-update, noised
    reconstruction."""
    vm, vv = jax_vae(cs_vae_train.CS_VAE_SMALL, HW)
    bundle = tmp_path / "vae_cs.ad"
    vae = load_flax_variables(tvae.VAE(cs_vae_train.CS_VAE_SMALL), vv)
    cs_vae_train.save(vae, cs_vae_train.CS_VAE_SMALL, str(bundle))
    args = cs_vae_adversarial.parse_args(["--device", "cpu", "--vae", str(bundle), "--batch",
                                          str(B), "--frame-size", str(HW), "--clip-size", str(T)])
    dm, dv = jax_disc(HW)
    tx_vae, tx_disc, step = adv_jax_step(vm, vv, dm, args.lr, args.adv_weight)
    vp, dp, dvars = vv["params"], dv["params"], dv
    opt_v, opt_d = tx_vae.init(vp), tx_disc.init(dp)
    tr = cs_vae_adversarial.build_trainer(args)
    load_flax_variables(tr.disc, dv)
    grads = {}
    capture_grads(monkeypatch, tr.tx_vae, tr.vae, grads, "vae")
    capture_grads(monkeypatch, tr.tx_disc, tr.disc, grads, "disc")
    for i in range(3):
        frames, t, noise = cs_inputs(40 + i)
        vp, opt_v, dp, opt_d, dvars, m_j, gv, gd = step(vp, opt_v, dp, opt_d, dvars,
                                                         *map(jnp.asarray, (frames, t, noise)))
        aux = cs_vae_adversarial.train_step(tr, *map(torch.from_numpy, (frames, t, noise)))
        got = np.array([float(aux[k]) for k in ("gaussian", "perceptual", "adv", "disc")])
        np.testing.assert_allclose(got, np.asarray(m_j), rtol=TOL if i == 0 else TOL_MULTI)
        if i:
            continue
        assert_leaves_close(grads["vae"], flat(jax.tree.map(np.asarray, gv)), TOL, "VAE grads")
        assert_leaves_close(grads["disc"], flat(jax.tree.map(np.asarray, gd)), TOL, "D grads")
        tv, td = flax_variables(tr.vae), flax_variables(tr.disc, "batch_stats")
        for got_t, want in ((tv["params"], vp), (td["params"], dp)):
            got_t, want = flat(got_t), flat(jax.tree.map(np.asarray, want))
            assert max(sdiff(got_t[k], want[k]) for k in want) <= TOL
        assert_leaves_close(flat(td["batch_stats"]), flat(jax.tree.map(
            np.asarray, dvars["batch_stats"])), TOL, "batch_stats")
        for opt, mod, st in ((tr.opt_vae, tr.vae, opt_v), (tr.opt_disc, tr.disc, opt_d)):
            adam = adam_state(st)
            assert_leaves_close(moments(opt, mod, "exp_avg"),
                                flat(jax.tree.map(np.asarray, adam.mu)), TOL, "mu")
            assert_leaves_close(moments(opt, mod, "exp_avg_sq"),
                                flat(jax.tree.map(np.asarray, adam.nu)), TOL, "nu")


# ---------------------------------------------------------------------------
# the script end to end

def test_gym_vae_train_bundle_is_read_by_jax(tmp_path):
    """gym_vae_train --device cpu --synthetic at 16x16 writes
    vae_lunar_lander.ad and its loss curves; the JAX load_model + VAE
    decode of it equals the port's vae_from_bundle decode."""
    tr = gym_vae_train.main(["--device", "cpu", "--synthetic", "--frame-size", str(HW),
                             "--state-size", str(T), "--batch", str(B), "--steps", "2",
                             "--ckpt-dir", str(tmp_path), "--out-dir", str(tmp_path)])
    assert tr.count == 2 and len(tr.history["recon"]) == 2
    curves = np.load(tmp_path / "vae_losses_final.npz")
    assert sorted(curves.files) == sorted(gym_vae_train.METRICS)
    kwargs, variables = j_load_model(str(tmp_path / gym_vae_train.BUNDLE))
    jm = jvae.VAE(jvae.VAEConfig(**{k: tuple(v) if isinstance(v, list) else v
                                    for k, v in kwargs.items()}))
    tm, _ = vae_from_bundle(tmp_path / gym_vae_train.BUNDLE, "cpu")
    z = np.random.default_rng(9).normal(size=(1, 2, 4, 4, 8)).astype(np.float32)
    t = np.full((1,), 0.1, np.float32)
    want = jm.apply(variables, jnp.asarray(z), jnp.asarray(t), method=jvae.VAE.decode)
    with torch.no_grad():
        got = tm.decode(torch.from_numpy(z), torch.from_numpy(t))
    for a, b in zip(got[:2], want[:2]):
        assert a.shape == (1, 8, 16, 16, 3) and sdiff(a.numpy(), b) <= TOL
    trained = flat(flax_variables(tr.vae))
    for name, leaf in flat(variables).items():
        np.testing.assert_array_equal(np.asarray(leaf), trained[name], err_msg=name)


def test_cs_vae_scripts_read_frame_shards(tmp_path):
    """--shards: .npz shards with a uint8 'frames' array through
    LocalLatentShards(key="frames"), normalized to [-1, 1]; cs_vae_train
    writes vae_cs.ad and cs_vae_adversarial resumes from it."""
    from autoregressive_diffusion_tpu_torch.data import write_latent_shard

    shards = tmp_path / "shards"
    shards.mkdir()
    rng = np.random.default_rng(12)
    for i in range(2):
        write_latent_shard(str(shards / f"clip_{i}.npz"),
                           rng.integers(0, 256, size=(16, HW, HW, 3), dtype=np.uint8), key="frames")
    args = cs_vae_train.parse_args(["--device", "cpu", "--small", "--shards", str(shards),
                                    "--clip-size", str(T), "--batch", "1"])
    batch = next(cs_vae_train.frame_batches(args))
    assert batch.shape == (1, T, HW, HW, 3) and batch.min() >= -1 and batch.max() <= 1
    common = ["--device", "cpu", "--shards", str(shards), "--frame-size", str(HW),
              "--clip-size", str(T), "--batch", "1", "--steps", "1", "--ckpt-dir", str(tmp_path)]
    tr = cs_vae_train.main(common + ["--small"])
    assert tr.count == 1 and (tmp_path / "vae_cs.ad").exists()
    adv = cs_vae_adversarial.main(common + ["--vae", str(tmp_path / "vae_cs.ad")])
    assert adv.count == 1 and (tmp_path / "vae_cs_adversarial.ad").exists()
    assert adv.cfg == cs_vae_train.CS_VAE_SMALL
