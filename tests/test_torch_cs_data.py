"""The port's CS data path against the JAX package on the CPU: the MDS
writer (byte for byte) and reader (each package reads the other's
shards), the .npz and MDS window readers, batching, the shard-index merge,
build_cs_dataset's synthetic clips (bit for bit), its sources and its
shards (encoded by the committed VAE), and compute_latent_stats on a
seeded VAE. Inputs come from numpy seeds. The JAX side's native library is
built into a temporary directory, so the tests write nothing into
native/."""
import importlib.util
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from autoregressive_diffusion_tpu.data import cs_data as j_cs
from autoregressive_diffusion_tpu.data import mds as j_mds
from autoregressive_diffusion_tpu.data import native as j_native
from autoregressive_diffusion_tpu.models import vae as j_vae
from autoregressive_diffusion_tpu.utils.checkpoint import load_model as j_load_model
from autoregressive_diffusion_tpu.utils.checkpoint import save_model as j_save_model
from autoregressive_diffusion_tpu_torch import build_cs_dataset, compute_latent_stats
from autoregressive_diffusion_tpu_torch.data import (LocalLatentShards, MDSLocalReader,
                                                     MDSShardWriter, batched_latents,
                                                     merge_shard_index, streaming_dataset,
                                                     write_latent_shard)
from autoregressive_diffusion_tpu_torch.utils import load_model

ROOT = Path(__file__).resolve().parent.parent
VAE_BUNDLE = ROOT / "saved_models" / "vae_lunar_lander.ad"
TOL = 3e-4  # tests/test_reference_parity.py
COLUMNS = {"mean": "ndarray", "action": "ndarray"}


def jax_script(name):
    """A module of scripts/ (the JAX package's entry points), by path."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax_main(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [mod.__name__] + argv)
    mod.main()


@pytest.fixture(scope="module", autouse=True)
def jax_native_in_tmp(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setattr(j_native, "_SO", str(tmp_path_factory.mktemp("native") / "libadx_data.so"))
    mp.setattr(j_native, "_lib", None)
    mp.setattr(j_native, "_build_failed", False)
    mp.delenv("AD_TPU_NATIVE", raising=False)
    yield
    mp.undo()


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads: the tier-1 run shares the cores among its
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def samples(seed, n=5, t=12, hw=4, c=8):
    rng = np.random.default_rng(seed)
    return [{"mean": rng.normal(size=(t, hw, hw, c)).astype(np.float16),
             "action": rng.integers(0, 4, t).astype(np.int64)} for _ in range(n)]


def write_mds(writer_cls, out, items, size_limit=1 << 26, compression=None):
    with writer_cls(str(out), COLUMNS, size_limit=size_limit, compression=compression) as w:
        for s in items:
            w.write(s)


@pytest.mark.parametrize("size_limit", [1 << 26, 3000])  # one shard; a sample a shard
def test_mds_writer_is_byte_for_byte_the_jax_writer(tmp_path, size_limit):
    items = samples(0)
    write_mds(MDSShardWriter, tmp_path / "t", items, size_limit)
    write_mds(j_mds.MDSShardWriter, tmp_path / "j", items, size_limit)
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == names
    assert len(names) == (2 if size_limit == 1 << 26 else 6)  # and index.json
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()


@pytest.mark.parametrize("compression", [None, "zstd"])
def test_each_package_reads_the_others_mds(tmp_path, compression):
    if compression:
        pytest.importorskip("zstandard")
    items = samples(1)
    write_mds(MDSShardWriter, tmp_path / "t", items, 3000, compression)
    write_mds(j_mds.MDSShardWriter, tmp_path / "j", items, 3000, compression)
    for reader, d in ((j_mds.MDSLocalReader, "t"), (MDSLocalReader, "j")):
        r = reader(str(tmp_path / d))
        assert len(r) == len(items)
        for got, want in zip(r, items):
            assert sorted(got) == ["action", "mean"]
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
    order = [int(s["action"][0]) for s in MDSLocalReader(str(tmp_path / "j"), shuffle=True,
                                                         seed=3)]
    assert order == [int(s["action"][0]) for s in j_mds.MDSLocalReader(
        str(tmp_path / "t"), shuffle=True, seed=3)]


def test_zstd_without_the_package_names_it(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "zstandard", None)  # import zstandard raises
    with pytest.raises(ImportError, match="zstandard"):
        MDSShardWriter(str(tmp_path / "w"), COLUMNS, compression="zstd")
    index = {"version": 2, "shards": [{
        "column_names": ["mean"], "column_encodings": ["ndarray"], "column_sizes": [None],
        "samples": 1, "compression": "zstd", "raw_data": {"basename": "shard.00000.mds"},
        "zip_data": {"basename": "shard.00000.mds.zstd"}}]}
    (tmp_path / "r").mkdir()
    (tmp_path / "r" / "index.json").write_text(json.dumps(index))
    (tmp_path / "r" / "shard.00000.mds.zstd").write_bytes(b"\0")
    with pytest.raises(ImportError, match="zstandard"):
        MDSLocalReader(str(tmp_path / "r"))[0]


def test_local_latent_shards_give_the_jax_windows_in_order(tmp_path):
    rng = np.random.default_rng(2)
    for i, t in enumerate((40, 33, 24)):
        lat = rng.normal(size=(t, 4, 4, 8)).astype(np.float32)
        act = rng.integers(0, 4, t)
        write_latent_shard(str(tmp_path / f"c{i}.npz"), lat, act)
        j_cs.write_latent_shard(str(tmp_path / f"j{i}.npz"), lat, act)
        with np.load(tmp_path / f"c{i}.npz") as a, np.load(tmp_path / f"j{i}.npz") as b:
            assert sorted(a) == sorted(b) == ["actions", "latents"]
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
    for p in tmp_path.glob("j*.npz"):
        p.unlink()
    for kw in (dict(seed=5), dict(seed=5, rank=1, num_replicas=2), dict(shuffle=False)):
        got = iter(LocalLatentShards(str(tmp_path), clip_size=8, **kw))
        want = iter(j_cs.LocalLatentShards(str(tmp_path), clip_size=8, **kw))
        for _ in range(25):  # past the end of a pass: the stream goes on
            g, w = next(got), next(want)
            np.testing.assert_array_equal(g["latents"], w["latents"])
            np.testing.assert_array_equal(g["actions"], w["actions"])


def test_streaming_dataset_and_batches_match_jax(tmp_path):
    items = samples(3, n=4, t=20)
    write_mds(MDSShardWriter, tmp_path / "m", items, 3000)
    for shuffle in (False, True):
        got = list(streaming_dataset(None, str(tmp_path / "m"), clip_size=6, shuffle=shuffle))
        want = list(j_cs.streaming_dataset(None, str(tmp_path / "m"), clip_size=6,
                                           shuffle=shuffle))
        assert len(got) == len(want) == 12
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w) == ["actions", "latents"]
            np.testing.assert_array_equal(g["latents"], w["latents"])
            np.testing.assert_array_equal(g["actions"], w["actions"])
    norm = (0.25, 1.5)
    got = batched_latents(streaming_dataset(None, str(tmp_path / "m"), clip_size=6), 4,
                          normalize=norm, num_workers=0)
    want = j_cs.batched_latents(j_cs.streaming_dataset(None, str(tmp_path / "m"), clip_size=6),
                                4, normalize=norm, num_workers=0)
    for _ in range(3):
        g, w = next(got), next(want)
        assert g["latents"].dtype == np.float32 and g["latents"].shape == (4, 6, 4, 4, 8)
        np.testing.assert_array_equal(g["latents"], w["latents"])
        np.testing.assert_array_equal(g["actions"], w["actions"])
    with pytest.raises(StopIteration):  # 12 windows: three batches, then the end
        next(got)
    with pytest.raises(ImportError, match="streaming"):
        next(streaming_dataset("s3://bucket/cs", str(tmp_path / "m")))


def test_merged_index_matches_jax(tmp_path):
    for i in range(2):
        write_mds(MDSShardWriter, tmp_path / f"w{i}", samples(4 + i, n=3), 3000)
    dirs = [str(tmp_path / "w0"), str(tmp_path / "w1")]
    got = merge_shard_index(str(tmp_path / "merged"), dirs)
    want = j_cs.merge_shard_index(str(tmp_path / "jmerged"), dirs)
    assert json.loads(Path(got).read_text()) == json.loads(Path(want).read_text())
    assert len(MDSLocalReader(str(tmp_path / "merged"))) == 6
    np.testing.assert_array_equal(MDSLocalReader(str(tmp_path / "merged"))[3]["mean"],
                                  samples(5, n=3)[0]["mean"])


@pytest.mark.parametrize("seed,t,size,n_actions", [(0, 12, 128, 4), (3, 9, 64, 3)])
def test_structured_clip_is_the_jax_scripts_bit_for_bit(seed, t, size, n_actions):
    j_build = jax_script("build_cs_dataset")
    got = build_cs_dataset.structured_clip(np.random.default_rng(seed), t, size, n_actions)
    want = j_build.structured_clip(np.random.default_rng(seed), t, size, n_actions)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_iter_clips_reads_npz_and_h5_sources(tmp_path, monkeypatch):
    j_build = jax_script("build_cs_dataset")
    rng = np.random.default_rng(6)
    frames = rng.integers(0, 256, (5, 10, 12, 3), dtype=np.uint8)
    np.savez(tmp_path / "a.npz", frames=frames, actions=np.arange(5))
    np.savez(tmp_path / "b.npz", frames=frames[:3])
    args = build_cs_dataset.parse_args(["--src", str(tmp_path), "--out", "x", "--raw"])
    got = list(build_cs_dataset.iter_clips(args))
    want = list(j_build.iter_clips(args))
    assert [g[0] for g in got] == [w[0] for w in want] == ["a.npz", "b.npz"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_array_equal(g[2], w[2])
    h5py = pytest.importorskip("h5py")
    with h5py.File(tmp_path / "c.h5", "w") as f:
        for i in range(3):
            f[f"frame_{i}_x"] = frames[i]
        f["actions"] = np.array([2, 1, 0])
    got = dict((n, (fr, ac)) for n, fr, ac in build_cs_dataset.iter_clips(args))
    want = dict((n, (fr, ac)) for n, fr, ac in j_build.iter_clips(args))
    np.testing.assert_array_equal(got["c.h5"][0], want["c.h5"][0])
    np.testing.assert_array_equal(got["c.h5"][1], [2, 1, 0])
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        list(build_cs_dataset.iter_clips(args))


@pytest.mark.parametrize("mds", [False, True])
def test_build_cs_dataset_matches_the_jax_script(tmp_path, monkeypatch, mds):
    """Two synthetic clips of 16 frames at 32 px through the committed VAE:
    the same shards (fp16 latents within 3e-4, actions one a latent frame)
    as scripts/build_cs_dataset.py writes."""
    if mds:
        pytest.importorskip("zstandard")
    argv = ["--synthetic", "2", "--clip-frames", "16", "--frame-size", "32", "--vae-ckpt",
            str(VAE_BUNDLE), "--split-size", "8", "--seed", "4"] + (["--mds"] if mds else [])
    written = build_cs_dataset.main(argv + ["--out", str(tmp_path / "t"), "--device", "cpu"])
    assert [(n, s, str(d)) for n, s, d in written] == [
        (f"synthetic_{i}", (4, 8, 8, 8), "float16") for i in range(2)]
    run_jax_main(jax_script("build_cs_dataset"), argv + ["--out", str(tmp_path / "j")],
                 monkeypatch)
    if mds:
        got, want = MDSLocalReader(str(tmp_path / "t")), MDSLocalReader(str(tmp_path / "j"))
        pairs = [((g["mean"], g["action"]), (w["mean"], w["action"]))
                 for g, w in zip(got, want)]
    else:
        pairs = []
        for i in range(2):
            with np.load(tmp_path / "t" / f"synthetic_{i}.npz") as g, \
                    np.load(tmp_path / "j" / f"synthetic_{i}.npz") as w:
                pairs.append(((g["latents"], g["actions"]), (w["latents"], w["actions"])))
    assert len(pairs) == 2
    for (gl, ga), (wl, wa) in pairs:
        assert gl.dtype == wl.dtype == np.float16 and gl.shape == wl.shape == (4, 8, 8, 8)
        assert np.std(gl.astype(np.float64) - wl.astype(np.float64)) <= TOL
        assert np.std(wl.astype(np.float64)) > 0.1
        np.testing.assert_array_equal(ga, wa)
        assert ga.shape == (4,)


def test_compute_latent_stats_matches_jax(tmp_path, monkeypatch):
    """A seeded VAE written by the JAX package: the port's latent mean and
    std over 3 synthetic clips within 3e-4 of the JAX script's, written
    into a bundle that keeps the VAE's kwargs and weights."""
    cfg = j_vae.VAEConfig(channels=(3, 8, 8), n_res_blocks=1, time_compressions=(1, 2),
                          spatial_compressions=(1, 2))
    x = jax.numpy.zeros((1, 4, 16, 16, 3))
    variables = jax.jit(j_vae.VAE(cfg).init)(jax.random.PRNGKey(3), x)
    kwargs = dict(channels=[3, 8, 8], n_res_blocks=1, time_compressions=[1, 2],
                  spatial_compressions=[1, 2])
    j_save_model(str(tmp_path / "vae.ad"), kwargs, variables)
    argv = ["--vae-ckpt", str(tmp_path / "vae.ad"), "--synthetic", "--num-samples", "3",
            "--state-size", "8", "--frame-size", "16"]
    extra = compute_latent_stats.main(argv + ["--out", str(tmp_path / "t.ad"),
                                              "--device", "cpu"])
    run_jax_main(jax_script("compute_latent_stats"), argv + ["--out", str(tmp_path / "j.ad")],
                 monkeypatch)
    _, _, want = j_load_model(str(tmp_path / "j.ad"), with_extra=True)
    got_kwargs, got_vars, got = load_model(tmp_path / "t.ad", with_extra=True)
    assert got_kwargs == kwargs
    for k in ("latent_mean", "latent_std"):
        assert got[k].dtype == np.float32 and got[k].shape == (8,)
        np.testing.assert_array_equal(got[k], extra[k])
        np.testing.assert_allclose(got[k], want[k], atol=TOL)
    assert np.all(np.asarray(want["latent_std"]) > 1e-3)
    leaves = jax.tree.leaves(variables)
    assert sum(np.size(v) for v in jax.tree.leaves(got_vars)) == sum(np.size(v) for v in leaves)
