"""The port's CS path on the CPU: the decode Block's shape check at the CS
layout (the 16x16 dec Block with C0 = 768 among its Blocks), the CS UNet
at a narrow width against the JAX package (edm2_loss and its gradients with
injected sigma and noise; a prefill and a cached decode step) at
std-of-diff <= 3e-4, the synthetic AR(1) latents' law, and the entry
points cs_train (with resume), cs_rollout, context_probe and cs_eval_suite
on a tiny model and a seeded MDS dataset. The JAX model takes the port's
seeded weights through the bridge; one jitted JAX function for the loss
and gradients and two for the eval calls: three JAX compiles."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoregressive_diffusion_tpu.models import Precond as JPrecond
from autoregressive_diffusion_tpu.models import UNetConfig as JConfig
from autoregressive_diffusion_tpu.models import init_cache as j_init_cache
from autoregressive_diffusion_tpu.train import loss as j_loss
from autoregressive_diffusion_tpu_torch import (context_probe, cs_eval_suite, cs_rollout,
                                                cs_train)
from autoregressive_diffusion_tpu_torch.data import MDSShardWriter
from autoregressive_diffusion_tpu_torch.models import Precond, UNetConfig, init_cache, init_weights
from autoregressive_diffusion_tpu_torch.ops.fused_conv import check_decode_block_shape
from autoregressive_diffusion_tpu_torch.train import EDM2LossConfig, edm2_loss
from autoregressive_diffusion_tpu_torch.utils import jax_variables, latest_step, to_jax_names

TOL = 3e-4  # tests/test_reference_parity.py
# the CS layout (32x32x8 latents, channel_mult 1/2/4/4, video attention at
# 4x4, frame attention at 8x8) at 16 channels, 16 a head
CFG = dict(img_resolution=32, img_channels=8, label_dim=4, model_channels=16,
           channel_mult=(1, 2, 4, 4), num_blocks=2, video_attn_resolutions=(4,),
           frame_attn_resolutions=(8,), max_frames=8, channels_per_head=16)
LOSS = dict(P_mean=0.9, P_std=1.0, sigma_data=1.0, context_noise_reduction=0.1)
B, T = 1, 4
TINY = ["--model-channels", "16", "--device", "cpu", "--dtype", "fp32"]


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads: the tier-1 run shares the cores among its
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


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


def attention_free_blocks(cfg):
    for side, name, spec in cfg.block_layout():
        if spec["kind"] == "block" and spec["attention"] is None:
            cin, co = spec["cin"], spec["cout"]
            yield f"{side}_{name}", (spec["res"], cin, co if spec["flavor"] == "enc" else cin,
                                     co, spec["flavor"], cin != co)


def test_every_cs_block_passes_the_decode_block_shape_check():
    """The decode Block takes every attention-free Block of the CS model, so
    no cached denoiser call of a CS rollout raises."""
    blocks = dict(attention_free_blocks(cs_train.cs_config()))
    assert len(blocks) == 17
    assert blocks["dec_16x16_block0"] == (16, 768, 768, 256, "dec", True)
    for name, (h, cin, c0, co, flavor, skip) in blocks.items():
        check_decode_block_shape(1, 1, h, h, cin, c0, co, flavor, skip)


@pytest.mark.parametrize("shape,match", [
    ((1, 1, 8, 8, 1025, 1025, 512, "dec", True), "Cin=1025"),
    ((1, 2, 8, 8, 64, 64, 64, "enc", False), "T=2"),
    ((1, 1, 8, 8, 64, 32, 64, "enc", True), "C0 == Co"),
    ((1, 1, 8, 8, 64, 32, 32, "dec", True), "C0 == Cin"),
    ((1, 1, 8, 8, 64, 64, 32, "dec", False), "no skip weight"),
    ((1, 1, 8, 8, 64, 64, 64, "mid", False), "flavor"),
    ((4096, 1, 64, 64, 64, 64, 1024, "dec", True), "rows of blocks"),
])
def test_decode_block_shape_check_refuses_what_the_kernel_cannot_take(shape, match):
    with pytest.raises(ValueError, match=match):
        check_decode_block_shape(*shape)
    check_decode_block_shape(1, 1, 4, 4, 1024, 1024, 1024, "dec", False)  # the widest taken


@pytest.fixture(scope="module")
def models():
    """The port's seeded init (gains 0.7, so the UNet body reaches the
    output) and the JAX model on the same weights, through the bridge."""
    tm = init_weights(Precond(UNetConfig(**CFG), sigma_data=1.0), 1, gains=0.7)
    variables = jax.tree.map(jnp.asarray, jax_variables(tm))
    return JPrecond(JConfig(**CFG), sigma_data=1.0), variables, tm


def test_cs_loss_and_gradients_match_jax(models, monkeypatch):
    """One DART edm2_loss of the CS layout (T=4, actions) with injected
    sigma and noise: the loss, the per-frame losses and every gradient leaf
    (JAX's CPU path: no Pallas conv, dense attention)."""
    jm, variables, tm = models
    monkeypatch.setenv("AD_TPU_FUSED_CONV", "0")
    monkeypatch.setenv("AD_TPU_FLASH", "0")
    rng = np.random.default_rng(0)
    images = rng.normal(size=(B, T, 32, 32, 8)).astype(np.float32)
    sigma = np.exp(rng.normal(size=(B, 2 * T)) * 0.8).astype(np.float32)
    noise = (sigma[:, :, None, None, None] * rng.normal(size=(B, 2 * T, 32, 32, 8))
             ).astype(np.float32)
    cond = rng.integers(0, 4, size=(B, T)).astype(np.int32)
    coefs = (0.1 * rng.normal(size=(7, 1))).astype(np.float32)

    def f(params, *arrays):
        return j_loss.edm2_loss(jm, {"params": params, "buffers": variables["buffers"]},
                                arrays[0], jax.random.PRNGKey(0), j_loss.EDM2LossConfig(**LOSS),
                                arrays[3], arrays[4], False, sigma=arrays[1], noise=arrays[2])

    (loss_j, aux_j), grads_j = jax.jit(jax.value_and_grad(f, has_aux=True))(
        variables["params"], *map(jnp.asarray, (images, sigma, noise, cond, coefs)))
    tm.train().zero_grad(set_to_none=True)
    loss_t, aux_t = edm2_loss(tm, torch.from_numpy(images), 0, EDM2LossConfig(**LOSS),
                              torch.from_numpy(cond).long(), torch.from_numpy(coefs),
                              sigma=torch.from_numpy(sigma), noise=torch.from_numpy(noise))
    loss_t.backward()
    assert abs(float(loss_t.detach()) - float(loss_j)) <= TOL * max(1.0, abs(float(loss_j)))
    np.testing.assert_allclose(aux_t["losses"].numpy(), np.asarray(aux_j["losses"]),
                               rtol=1e-3, atol=TOL)
    gj = flat(grads_j)
    gt = to_jax_names({n: p.grad for n, p in tm.named_parameters()})
    assert set(gt) <= set(gj)
    whole = float(np.sqrt(np.mean(np.concatenate([np.square(v).ravel() for v in gj.values()]))))
    checked = 0
    for name, want in gj.items():
        if name not in gt:  # no gradient reaches it: zero in JAX
            assert float(np.abs(want).max()) == 0.0, name
            continue
        # a leaf's scale: its rms, or 1% of the whole gradient's rms where
        # it is smaller (a gating leaf's gradient can be the remainder of a
        # cancellation, 1/1500 of the whole here, and fp32 roundoff is set
        # by the size of the terms that cancelled)
        scale = max(float(np.sqrt(np.mean(np.square(want)))), 1e-2 * whole)
        assert float(np.sqrt(np.mean(np.square(gt[name] - want)))) / scale <= TOL, name
        checked += 1
    assert checked > 200


def test_cs_prefill_and_cached_decode_match_jax(models):
    """A prefill of 4 frames into a fresh cache, then one cached decode step
    (the port's decode-Block path, 17 Blocks), against the JAX package."""
    jm, variables, tm = models
    tm.eval()
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 5, 32, 32, 8)).astype(np.float32)
    s = np.full((1, 5), 0.05, np.float32)
    s[:, 4] = 2.0
    c = rng.integers(0, 4, size=(1, 5)).astype(np.int32)

    def run_j(x_, s_, c_, cache, **static):
        fn = jax.jit(lambda v_, x_, s_, c_, cache_: jm.apply(
            v_, x_, s_, c_, cache=cache_, mode="eval", update_cache=True, **static))
        return fn(variables, jnp.asarray(x_), jnp.asarray(s_), jnp.asarray(c_), cache)

    yj0, jc = run_j(x[:, :4], s[:, :4], c[:, :4], j_init_cache(jm, variables, batch_size=1),
                    prefill_offset=0)
    yj1, _ = run_j(x[:, 4:], s[:, 4:], c[:, 4:], jc)
    with torch.no_grad():
        tc = init_cache(tm, 1, device="cpu")
        yt0, tc = tm(torch.from_numpy(x[:, :4]), torch.from_numpy(s[:, :4]),
                     torch.from_numpy(c[:, :4]).long(), cache=tc, update_cache=True)
        yt1, tc = tm(torch.from_numpy(x[:, 4:]), torch.from_numpy(s[:, 4:]),
                     torch.from_numpy(c[:, 4:]).long(), cache=tc, update_cache=True)
    assert tc["frames"] == 5
    for got, want in ((yt0, yj0), (yt1, yj1)):
        assert got.shape == want.shape
        assert sdiff(got.numpy(), want) <= TOL and float(np.std(np.asarray(want))) > 0.1


def test_synthetic_latents_follow_the_ar1_law():
    """Marginal std 1 in every frame, frame-to-frame correlation rho = 0.95,
    spatial correlation of neighbours 2/5 (the plus stencil), actions in
    [0, 4)."""
    lat, act = cs_train.synthetic_latents(64, 6, 32, 8, seed=3, device="cpu")
    assert lat.shape == (64, 6, 32, 32, 8) and act.shape == (64, 6)
    x = lat.double()
    for i in range(6):
        assert abs(float(x[:, i].std()) - 1.0) < 0.02
    lag1 = float((x[:, 1:] * x[:, :-1]).mean() / x.var())
    assert abs(lag1 - cs_train.RHO) < 0.01
    nb = float((x * x.roll(1, -2)).mean() / x.var())
    assert abs(nb - 0.4) < 0.02
    assert int(act.min()) >= 0 and int(act.max()) <= 3
    again, _ = cs_train.synthetic_latents(64, 6, 32, 8, seed=3, device="cpu")
    assert torch.equal(lat, again)


@pytest.fixture(scope="module")
def mds(tmp_path_factory):
    """A seeded MDS dataset of 4 clips of 8 latent frames at 32x32x8."""
    out = tmp_path_factory.mktemp("mds")
    rng = np.random.default_rng(5)
    with MDSShardWriter(str(out), {"mean": "ndarray", "action": "ndarray"}) as w:
        for _ in range(4):
            w.write({"mean": rng.normal(size=(8, 32, 32, 8)).astype(np.float16),
                     "action": rng.integers(0, 4, 8).astype(np.int64)})
    return str(out)


def test_cs_train_resume_rollout_and_probe(tmp_path, mds):
    ck = str(tmp_path / "ck")
    common = TINY + ["--batch", "2", "--micro-batch", "1", "--clip-size", "4", "--mds", mds,
                     "--use-actions", "--ckpt-dir", ck]
    first = cs_train.main(common + ["--steps", "3"])
    assert first.state.step == 3 and len(first.losses) == 3
    assert np.isfinite(first.losses).all()
    assert first.tx.lr_at(0) == 0.0 and latest_step(ck) == 3
    want_lr = float(j_loss.learning_rate_schedule(2, 1e-2, 3 / 500, 3 / 500))
    assert first.tx.lr_at(2) == want_lr
    second = cs_train.main(common + ["--steps", "4", "--resume"])
    assert second.start == 3 and second.state.step == 4 and latest_step(ck) == 4
    assert len(second.losses) == 4 and second.losses[:3] == first.losses

    out = cs_rollout.main(TINY + ["--ckpt-dir", ck, "--mds", mds, "--context", "2",
                                  "--frames", "2", "--clips", "1", "--num-steps", "3",
                                  "--ema", "0", "--use-actions", "--out",
                                  str(tmp_path / "roll")])
    assert out["clips"] == 1 and out["mse"].shape == out["persistence"].shape == (2,)
    assert np.isfinite(out["mse"]).all() and np.isfinite(out["persistence"]).all()
    assert (tmp_path / "roll" / "cs_rollout.npz").exists()

    probe = context_probe.main(TINY + ["--ckpt-dir", ck, "--mds", mds, "--batch", "2",
                                       "--clip-size", "4", "--batches", "2", "--use-actions"])
    assert len(probe["real"]) == len(probe["scrambled"]) == 2
    assert np.isfinite(probe["real"] + probe["scrambled"]).all()
    assert probe["real"] != probe["scrambled"]


def test_cs_eval_suite_runs_the_probe_and_the_rollout_on_one_restore(tmp_path, mds,
                                                                      monkeypatch):
    """The suite restores the raw weights once and runs context_probe and
    cs_rollout on them (here with fewer windows and sampler steps)."""
    ck = str(tmp_path / "ck")
    cs_train.main(TINY + ["--batch", "2", "--micro-batch", "2", "--clip-size", "4",
                          "--steps", "1", "--ckpt-dir", ck, "--synthetic"])
    restores = []
    restore = cs_rollout.restore_model
    monkeypatch.setattr(cs_rollout, "restore_model",
                        lambda *a, **k: restores.append(a) or restore(*a, **k))
    for mod, extra in ((context_probe, ["--batch", "2", "--clip-size", "4", "--batches", "1"]),
                       (cs_rollout, ["--num-steps", "3", "--dtype", "fp32"])):
        monkeypatch.setattr(mod, "parse_args",
                            lambda argv, parse=mod.parse_args, extra=extra: parse(argv + extra))
    res = cs_eval_suite.main(["--ckpt-dir", ck, "--mds", mds, "--frames", "1", "--out",
                              str(tmp_path / "roll"), "--device", "cpu",
                              "--model-channels", "16"])
    assert len(restores) == 1
    assert len(res["probe"]["real"]) == 1 and np.isfinite(res["probe"]["scrambled"]).all()
    assert res["rollout"]["clips"] == 2 and np.isfinite(res["rollout"]["mse"]).all()


@pytest.mark.parametrize("data", ["synthetic", "shards"])
def test_cs_train_over_two_ranks_equals_one_process(tmp_path, data):
    """cs_train --sp 2 on two gloo ranks (each clip's frames split) takes
    the steps one process takes: the same losses and weights, within the
    SP tests' rtol of 2e-4. With --shards every rank must read the same
    global batch (the windows in the seed's order), as the one process
    does."""
    import test_torch_sp_workers as workers
    from autoregressive_diffusion_tpu_torch.data import write_latent_shard
    from autoregressive_diffusion_tpu_torch.parallel import run_local_ranks

    if data == "shards":
        shards = tmp_path / "shards"
        shards.mkdir()
        rng = np.random.default_rng(11)
        for i in range(6):  # 2 windows of 4 frames a shard
            write_latent_shard(str(shards / f"clip_{i:02d}.npz"),
                               rng.normal(size=(8, 32, 32, 8)).astype(np.float32),
                               rng.integers(0, 4, size=(8,)))
        source = ["--shards", str(shards)]
    else:
        source = ["--synthetic"]
    argv = TINY + ["--batch", "2", "--micro-batch", "2", "--clip-size", "4", "--steps", "3",
                   *source, "--use-actions", "--backend", "gloo", "--sp", "2"]
    ranks = run_local_ranks(workers.cs_train_run, 2,
                            (argv + ["--ckpt-dir", str(tmp_path / "ranks")],), timeout=300)
    one = cs_train.main(argv[:-2] + ["--ckpt-dir", str(tmp_path / "one")])
    sums = {n: float(p.detach().double().sum()) for n, p in one.state.model.named_parameters()}
    for losses, rank_sums in ranks:
        np.testing.assert_allclose(losses, one.losses, rtol=2e-4)
        for n, v in sums.items():
            assert abs(rank_sums[n] - v) <= 2e-4 * max(1.0, abs(v)), n
    assert latest_step(tmp_path / "ranks") == 3  # written by rank 0


def test_cs_entry_points_refuse_what_is_not_ported(monkeypatch):
    # --tp and --fsdp are ported (tests/test_torch_tp_fsdp.py): they parse,
    # and a grid that does not divide the world of ranks is refused
    args = cs_train.parse_args(["--tp", "2", "--fsdp", "--device", "cpu", "--backend", "gloo",
                                "--model-channels", "16"])
    assert args.tp == 2 and args.fsdp
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="does not divide the world of 1 ranks"):
        cs_train.build_trainer(args)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cs_train.build_trainer(cs_train.parse_args(["--model-channels", "16"]))
