"""The port's perceptual losses, calibration tool and Stability-VAE bridge
against the JAX package on the CPU, fp32: random_feature_perceptual_loss
(value and gradient), AlexNet-LPIPS on seeded random weights (the distance,
the log-compressed loss and its gradient), lpips_params_from_torch on
synthetic state dicts of every key style, the perceptual_loss dispatch in
the JAX package's order, calibrate_lpips on a small corpus against the JAX
tool's functions (tools/calibrate_lpips.py, loaded from its file), and the
Stability bridge's rescale and plumbing with an injected fake VAE (the
cases of tests/test_stability.py). No trained LPIPS weights and no
calibrated file are in the repository; nothing here writes
saved_models/lpips_alex_calibrated.npz."""
import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoregressive_diffusion_tpu.models import stability as jstab
from autoregressive_diffusion_tpu.train import perceptual as jperc
from autoregressive_diffusion_tpu_torch import calibrate_lpips
from autoregressive_diffusion_tpu_torch.models import stability as tstab
from autoregressive_diffusion_tpu_torch.train import perceptual as tperc

ROOT = Path(__file__).resolve().parent.parent
TOL = 3e-4  # tests/test_reference_parity.py
SHAPES = [(64, 3, 11, 11), (192, 64, 5, 5), (384, 192, 3, 3), (256, 384, 3, 3), (256, 256, 3, 3)]


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


def torch_weights(seed=0):
    """Seeded random AlexNet convs (OIHW) and LPIPS heads (1, c, 1, 1)."""
    g = torch.Generator().manual_seed(seed)
    convs = [(torch.randn(s, generator=g) * 0.1, torch.randn(s[0], generator=g) * 0.1)
             for s in SHAPES]
    lins = [torch.rand((1, s[0], 1, 1), generator=g) for s in SHAPES]
    return convs, lins


def torchvision_dict(convs, lins):
    sd = {}
    for i, (w, b) in enumerate(convs):
        sd[f"features.{i}.weight"], sd[f"features.{i}.bias"] = w, b
    for i, lin in enumerate(lins):
        sd[f"lin{i}.model.1.weight"] = lin
    return sd


def images(seed, shape):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def test_random_feature_loss_and_gradient_match_jax():
    import jax
    recon, frames = images(1, (2, 3, 32, 32, 3)), images(2, (2, 3, 32, 32, 3))
    want, dwant = jax.jit(jax.value_and_grad(
        lambda r: jperc.random_feature_perceptual_loss(r, jnp.asarray(frames))))(
        jnp.asarray(recon))
    rt = torch.from_numpy(recon).requires_grad_(True)
    got = tperc.random_feature_perceptual_loss(rt, torch.from_numpy(frames))
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= TOL * abs(float(want))
    assert sdiff(rt.grad.numpy(), dwant) / float(np.std(dwant)) <= TOL
    plain = tperc.random_feature_perceptual_loss(rt, torch.from_numpy(frames), log_compress=False)
    want_plain = jperc.random_feature_perceptual_loss(jnp.asarray(recon), jnp.asarray(frames),
                                                      log_compress=False)
    assert abs(float(plain.detach()) - float(want_plain)) <= TOL * abs(float(want_plain))


def test_alexnet_lpips_matches_jax():
    """The distance on seeded random weights, the loss (log-compressed mean
    over frames) and the loss's gradient to recon; identical inputs give
    zero."""
    import jax
    convs, lins = torch_weights(0)
    sd = torchvision_dict(convs, lins)
    jp, tp = jperc.lpips_params_from_torch(sd), tperc.lpips_params_from_torch(sd)
    x, y = images(3, (2, 64, 64, 3)), images(4, (2, 64, 64, 3))
    want = np.asarray(jax.jit(jperc.alexnet_lpips_distance)(jnp.asarray(x), jnp.asarray(y), jp))
    got = tperc.alexnet_lpips_distance(torch.from_numpy(x), torch.from_numpy(y), tp).numpy()
    assert got.shape == (2,)
    np.testing.assert_allclose(got, want, rtol=TOL)
    recon, frames = x.reshape(1, 2, 64, 64, 3), y.reshape(1, 2, 64, 64, 3)
    lw, dlw = jax.jit(jax.value_and_grad(
        lambda r: jperc.alexnet_lpips_loss(r, jnp.asarray(frames), jp)))(jnp.asarray(recon))
    rt = torch.from_numpy(recon).requires_grad_(True)
    lt = tperc.alexnet_lpips_loss(rt, torch.from_numpy(frames), tperc.lpips_params_to(tp, "cpu"))
    lt.backward()
    assert abs(float(lt.detach()) - float(lw)) <= TOL * abs(float(lw))
    assert sdiff(rt.grad.numpy(), dlw) / float(np.std(dlw)) <= TOL
    same = tperc.alexnet_lpips_distance(torch.from_numpy(x), torch.from_numpy(x), tp)
    assert float(same.abs().max()) < 1e-12


def test_lpips_params_from_torch_matches_jax():
    """torchvision keys, pip-lpips keys split over two dicts (the two
    256-channel heads kept in order), and missing pieces raising."""
    convs, lins = torch_weights(5)
    sd = torchvision_dict(convs, lins)
    net = {}
    for (name, j), (w, b) in zip([("slice1", 0), ("slice2", 1), ("slice3", 1), ("slice4", 0),
                                  ("slice5", 0)], convs):
        net[f"net.{name}.{j}.weight"], net[f"net.{name}.{j}.bias"] = w, b
    heads = {f"lin{i}.model.1.weight": lin for i, lin in enumerate(lins)}
    want = jperc.lpips_params_from_torch(sd)
    for got in (tperc.lpips_params_from_torch(sd), tperc.lpips_params_from_torch(net, heads)):
        for (w1, b1), (w2, b2) in zip(got["convs"], want["convs"]):
            np.testing.assert_array_equal(w1, w2)
            np.testing.assert_array_equal(b1, b2)
        for l1, l2 in zip(got["lins"], want["lins"]):
            np.testing.assert_array_equal(l1, l2)
    np.testing.assert_array_equal(got["lins"][4], lins[4].numpy()[0, :, 0, 0])
    with pytest.raises(ValueError, match="linear heads"):
        tperc.lpips_params_from_torch({k: v for k, v in sd.items() if not k.startswith("lin")})
    with pytest.raises(ValueError, match="no bias"):
        tperc.lpips_params_from_torch({"features.0.weight": convs[0][0]})


@pytest.fixture
def no_lpips_env(monkeypatch):
    """No LPIPS environment; the params caches emptied after the test, so no
    params of a temporary file stay behind in either package."""
    monkeypatch.delenv("AD_TPU_LPIPS_WEIGHTS", raising=False)
    monkeypatch.delenv("AD_TPU_LPIPS_CALIBRATED", raising=False)
    yield monkeypatch
    for fn in (tperc.calibrated_lpips_params, tperc._params_on, tperc.load_lpips_params,
               jperc.calibrated_lpips_params, jperc.load_lpips_params):
        fn.cache_clear()


def test_perceptual_loss_dispatch(no_lpips_env, tmp_path):
    """The JAX package's order: the weights in AD_TPU_LPIPS_WEIGHTS, then the
    calibrated file for RGB (here a file in tmp_path standing in for
    saved_models/lpips_alex_calibrated.npz) unless AD_TPU_LPIPS_CALIBRATED
    is 0, then the random features; each equal to the JAX dispatch."""
    mp = no_lpips_env
    recon, frames = images(7, (1, 2, 64, 64, 3)), images(8, (1, 2, 64, 64, 3))
    r, f = torch.from_numpy(recon), torch.from_numpy(frames)
    rj, fj = jnp.asarray(recon), jnp.asarray(frames)
    calibrated = tmp_path / "lpips_alex_calibrated.npz"
    mp.setattr(tperc, "CALIBRATED_NPZ", str(calibrated))
    mp.setattr(jperc, "_CALIBRATED_NPZ", str(calibrated))
    assert tperc.perceptual_kind(3) == "random-feature"  # no file
    want = float(jperc.perceptual_loss(rj, fj))
    assert abs(float(tperc.perceptual_loss(r, f)) - want) <= TOL * abs(want)

    convs, lins = torch_weights(9)
    calibrate_lpips.write_params(str(calibrated), tperc.lpips_params_from_torch(
        torchvision_dict(convs, lins)))
    for fn in (tperc.calibrated_lpips_params, tperc._params_on, jperc.calibrated_lpips_params):
        fn.cache_clear()
    assert tperc.perceptual_kind(3) == "calibrated" and tperc.perceptual_kind(8) == \
        "random-feature"
    want = float(jperc.perceptual_loss(rj, fj))
    got = float(tperc.perceptual_loss(r, f))
    assert abs(got - want) <= TOL * abs(want)
    assert abs(got - float(tperc.random_feature_perceptual_loss(r, f))) > 1e-3
    mp.setenv("AD_TPU_LPIPS_CALIBRATED", "0")
    assert tperc.perceptual_kind(3) == "random-feature"

    path = tmp_path / "alex.pth"
    torch.save(torchvision_dict(*torch_weights(10)), str(path))
    mp.setenv("AD_TPU_LPIPS_WEIGHTS", str(path))
    assert tperc.perceptual_kind(3) == "lpips"
    want = float(jperc.perceptual_loss(rj, fj))
    assert abs(float(tperc.perceptual_loss(r, f)) - want) <= TOL * abs(want)


@pytest.fixture(scope="module")
def jax_tool():
    """tools/calibrate_lpips.py as a module (its main, which writes into
    saved_models/, is not called)."""
    spec = importlib.util.spec_from_file_location("jax_calibrate_lpips",
                                                  ROOT / "tools" / "calibrate_lpips.py")
    mod = importlib.util.module_from_spec(spec)
    path = list(sys.path)
    spec.loader.exec_module(mod)
    sys.path[:] = path
    return mod


def test_calibration_matches_the_jax_tool(jax_tool, monkeypatch):
    """On a small corpus (4 images of 48 px): the backbone, corpus and
    distortions bit for bit, each layer's diffs and the calibrated heads at
    3e-4, the checks passing; a wrong weighting is refused. The JAX tool's
    distance calls are jitted (one compile)."""
    import jax
    monkeypatch.setattr(jax_tool, "alexnet_lpips_distance", jax.jit(jperc.alexnet_lpips_distance))
    imgs = calibrate_lpips.corpus(4, 48)
    np.testing.assert_array_equal(imgs, jax_tool.corpus(4, 48))
    convs, jconvs = calibrate_lpips.he_backbone(), jax_tool.he_backbone()
    for (w, b), (jw, jb) in zip(convs, jconvs):
        np.testing.assert_array_equal(w, jw)
        np.testing.assert_array_equal(b, jb)
    for fam in calibrate_lpips.FAMILIES:
        np.testing.assert_array_equal(calibrate_lpips.distort(imgs, fam, 0.66),
                                      jax_tool.distort(imgs, fam, 0.66))
    d = calibrate_lpips.distort(imgs, "noise", 1.0)
    for got, want in zip(calibrate_lpips.layer_diffs(imgs, d, convs),
                         jax_tool.layer_diffs(imgs, d, jconvs)):
        np.testing.assert_allclose(got, want, rtol=TOL)
    params, scales = calibrate_lpips.calibrate(convs, imgs)
    contrib = np.zeros(5)  # the JAX tool's main, restated (calibrate_lpips.py:119-129)
    for fam in ["noise", "blur", "shift", "contrast"]:
        for s in [0.33, 0.66, 1.0]:
            dd = jax_tool.distort(imgs, fam, s)
            for i, v in enumerate(jax_tool.layer_diffs(imgs, dd, jconvs)):
                contrib[i] += v.mean()
    np.testing.assert_allclose(scales, contrib.mean() / np.maximum(contrib, 1e-12), rtol=TOL)
    result = calibrate_lpips.check(params, scales, imgs)
    np.testing.assert_allclose(result["contribution"], 1.0, atol=0.01)
    with pytest.raises(ValueError, match="equally"):
        calibrate_lpips.check(params, scales * np.array([2, 1, 1, 1, 1]), imgs)


def test_calibrate_lpips_writes_what_both_packages_read(tmp_path, monkeypatch):
    """The tool end to end on a smaller corpus, written to --out: the file
    loads through both packages' calibrated_lpips_params and behaves
    (zero for identical inputs, growing with noise)."""
    small = calibrate_lpips.corpus(4, 48)
    monkeypatch.setattr(calibrate_lpips, "corpus", lambda: small)
    out = tmp_path / "cal.npz"
    calibrate_lpips.main(["--out", str(out), "--device", "cpu"])
    got = tperc.calibrated_lpips_params.__wrapped__(str(out))
    want = jperc.calibrated_lpips_params.__wrapped__(str(out))
    for (w1, b1), (w2, b2) in zip(got["convs"], want["convs"]):
        np.testing.assert_array_equal(w1, w2)
        np.testing.assert_array_equal(b1, b2)
    x = torch.from_numpy(images(11, (2, 64, 64, 3)))
    n1, n2 = (torch.clamp(x + s * torch.randn(x.shape, generator=torch.Generator().manual_seed(0)),
                          -1, 1) for s in (0.05, 0.2))
    d0, d1, d2 = (tperc.alexnet_lpips_distance(x, y, got) for y in (x, n1, n2))
    assert float(d0.max()) < 1e-8 and bool((d1 > 0).all()) and bool((d2 > d1).all())
    assert not (ROOT / "saved_models" / "lpips_alex_calibrated.npz").exists()


# ---------------------------------------------------------------------------
# Stability bridge (tests/test_stability.py's cases, with the port's class)

class FakeLatentDist:
    def __init__(self, mean, std):
        self.mean, self.std = mean, std


class FakeVAE:
    """A deterministic stand-in for AutoencoderKL: encode = 8x8 average pool
    to 4 channels, decode = nearest upsample; records its chunk sizes."""

    def __init__(self):
        self.encode_chunks, self.decode_chunks = [], []

    def encode(self, x):
        self.encode_chunks.append(int(x.shape[0]))
        b, c, h, w = x.shape
        p = x.reshape(b, c, h // 8, 8, w // 8, 8).mean(dim=(3, 5))
        mean = torch.cat([p, p[:, :1] * 0.5], dim=1)
        return {"latent_dist": FakeLatentDist(mean, torch.ones_like(mean) * 0.25)}

    def decode(self, z):
        self.decode_chunks.append(int(z.shape[0]))
        return {"sample": z[:, :3].repeat_interleave(8, dim=2).repeat_interleave(8, dim=3)}


def bridges(batch_size=3, **stats):
    stats = stats or dict(raw_mean=(0.0,) * 4, raw_std=(1.0,) * 4, final_mean=0.0,
                          final_std=1.0)
    return (tstab.StabilityVAEBridge(batch_size=batch_size, device="cpu", vae=FakeVAE(), **stats),
            jstab.StabilityVAEBridge(batch_size=batch_size, vae=FakeVAE(), **stats))


def test_stability_rescale_matches_jax():
    raw_mean, raw_std = (5.81, 3.25, 0.12, -2.15), (4.17, 4.62, 3.71, 3.28)
    for got, want in zip(tstab.affine_from_stats(raw_mean, raw_std, 0.0, 0.5),
                         jstab.affine_from_stats(raw_mean, raw_std, 0.0, 0.5)):
        np.testing.assert_array_equal(got, want)
    scale, bias = tstab.affine_from_stats(raw_mean, raw_std, 0.0, 0.5)
    z = np.random.default_rng(0).normal(size=(4096, 4)).astype(np.float32)
    z = (z - z.mean(0)) / z.std(0) * raw_std + raw_mean
    out = tstab.rescale_to_final(z, scale, bias)
    np.testing.assert_allclose(out.mean(0), 0.0, atol=1e-5)
    np.testing.assert_allclose(out.std(0), 0.5, atol=1e-5)
    np.testing.assert_allclose(tstab.rescale_from_final(out, scale, bias), z, rtol=1e-5,
                               atol=1e-5)


def test_stability_bridge_matches_jax():
    """Shapes, chunking, the affine, the seeded posterior draw and the
    decode, each equal to the JAX package's bridge on the same fake VAE."""
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 256, size=(2, 4, 32, 32, 3), dtype=np.uint8)
    tb, jb = bridges(batch_size=3, raw_mean=(1.0, 2.0, 3.0, 4.0), raw_std=(2.0,) * 4,
                     final_mean=0.0, final_std=0.5)
    for sample in (False, True):
        got = tb.frames_to_latents(frames, sample=sample, seed=7)
        want = jb.frames_to_latents(frames, sample=sample, seed=7)
        assert got.shape == (2, 4, 4, 4, 4)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert tb._vae.encode_chunks == [3, 3, 2] * 2
    mean = tb.frames_to_latents(frames, sample=False)
    assert np.abs(tb.frames_to_latents(frames, seed=7) - tb.frames_to_latents(frames, seed=8)
                  ).max() > 1e-3
    assert 0.05 < (tb.frames_to_latents(frames, seed=7) - mean).std() < 0.2  # 0.25 x 0.5 / 2
    lat = rng.normal(size=(2, 3, 4, 4, 4)).astype(np.float32)
    tb, jb = bridges(batch_size=4)
    px = tb.latents_to_frames(lat)
    assert px.shape == (2, 3, 32, 32, 3) and px.dtype == np.uint8
    assert tb._vae.decode_chunks == [4, 2]
    np.testing.assert_array_equal(px, jb.latents_to_frames(lat))


def test_stability_default_needs_diffusers(monkeypatch):
    monkeypatch.setitem(sys.modules, "diffusers", None)
    with pytest.raises(ImportError, match="diffusers"):
        tstab.StabilityVAEBridge(device="cpu")
