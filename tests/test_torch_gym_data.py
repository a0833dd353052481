"""The port's gym data pipeline against the JAX package on the CPU: the
native resize and conversions (the same C++ source, each side's build), the
synthetic and gymnasium clip generators, batching, and both replay buffers.
The JAX side's native library is built into a temporary directory, so the
test writes nothing into native/."""
import time

import numpy as np
import pytest
import torch

from autoregressive_diffusion_tpu.data import gym_data as j_gym
from autoregressive_diffusion_tpu.data import native as j_native
from autoregressive_diffusion_tpu.data import replay as j_replay
from autoregressive_diffusion_tpu_torch.data import (DeviceReplay, GymDataGenerator,
                                                     ReplayLoader, SyntheticVideoGenerator,
                                                     batched, native, pm1_to_u8,
                                                     resize_area_batch, resize_frame,
                                                     resize_frames_batch, u8_to_pm1)


@pytest.fixture(scope="module", autouse=True)
def jax_native_in_tmp(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setattr(j_native, "_SO", str(tmp_path_factory.mktemp("native") / "libadx_data.so"))
    mp.setattr(j_native, "_lib", None)
    mp.setattr(j_native, "_build_failed", False)
    mp.delenv("AD_TPU_NATIVE", raising=False)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(0).integers(0, 256, (3, 97, 131, 3), dtype=np.uint8)


def test_jax_side_uses_its_native_library():
    assert j_native.get_lib() is not None


@pytest.mark.parametrize("size", [64, (64, 48), (97, 131)])
def test_resize_area_batch_matches_jax_and_the_plain_version(frames, size):
    got = resize_area_batch(frames, size)
    np.testing.assert_allclose(got, j_native.resize_area_batch(frames, size), atol=1e-4)
    dh, dw = (size, size) if isinstance(size, int) else size
    np.testing.assert_allclose(got, native._resize_area_numpy(frames, dh, dw), atol=2e-3)
    fused = resize_area_batch(frames, size, scale=1 / 127.5, offset=-1.0)
    np.testing.assert_allclose(fused, j_native.resize_area_batch(frames, size, 1 / 127.5, -1.0),
                               atol=1e-4)


def test_conversions_match_jax(frames):
    x = u8_to_pm1(frames)
    np.testing.assert_allclose(x, j_native.u8_to_pm1(frames), atol=1e-4)
    np.testing.assert_allclose(x, frames.astype(np.float32) / 127.5 - 1.0, atol=2e-3)
    np.testing.assert_array_equal(pm1_to_u8(x), frames)
    y = np.random.default_rng(1).uniform(-1.2, 1.2, (5, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(pm1_to_u8(y), j_native.pm1_to_u8(y))
    np.testing.assert_array_equal(resize_frame(frames[0], 32), j_gym.resize_frame(frames[0], 32))
    np.testing.assert_allclose(resize_frames_batch(frames, 32),
                               j_gym.resize_frames_batch(frames, 32), atol=1e-4)


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "adx_data.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed for adx_data.cpp.*error"):
        resize_area_batch(np.zeros((1, 4, 4, 3), np.uint8), 2)


@pytest.mark.parametrize("workers", [0, 2])
def test_synthetic_clips_and_batches_equal_jax(workers):
    args = (8, 32, 4, 4)
    got = list(batched(SyntheticVideoGenerator(*args, training_examples=6, seed=3), 2,
                       num_workers=workers))
    want = list(j_gym.batched(j_gym.SyntheticVideoGenerator(*args, training_examples=6, seed=3),
                              2, num_workers=workers))
    assert len(got) == len(want) == (3 if workers == 0 else 6)
    if workers:  # the threads interleave: the same clips, in some order
        key = lambda b: [c.tobytes() for c in b[0]]
        got = sorted(sum((key(b) for b in got), []))
        want = sorted(sum((key(b) for b in want), []))
        assert got == want
        return
    for (f, a, r), (jf, ja, jr) in zip(got, want):
        assert f.dtype == np.uint8 and f.shape == (2, 8, 32, 32, 3)
        assert f.tobytes() == jf.tobytes() and a.tobytes() == ja.tobytes()
        np.testing.assert_array_equal(r, jr)


def test_gym_clip_matches_jax():
    pytest.importorskip("gymnasium")
    kw = dict(state_size=8, training_examples=1, autoencoder_time_compression=4,
              frame_size=64, seed=7)
    frames, actions, reward = next(iter(GymDataGenerator(**kw)))
    jframes, jactions, jreward = next(iter(j_gym.GymDataGenerator(**kw)))
    assert frames.shape == (8, 64, 64, 3) and frames.dtype == np.uint8
    assert int(np.abs(frames.astype(int) - jframes.astype(int)).max()) <= 1
    np.testing.assert_array_equal(actions, jactions)
    assert reward == jreward
    assert frames.std() > 0  # a rendered scene, not a blank frame


def _wait_done(loader):
    loader._thread.join(timeout=60)
    assert loader._producer_done


def test_replay_loader_samples_equal_jax():
    """Once the producer is done, the draws depend only on the seed and the
    ring: the same batches on both sides."""
    args = (8, 16, 4, 4)
    port = ReplayLoader(SyntheticVideoGenerator(*args, training_examples=11, seed=2), 4,
                        capacity=8, min_fill=4, seed=9)
    jax_ = j_replay.ReplayLoader(j_gym.SyntheticVideoGenerator(*args, training_examples=11,
                                                               seed=2),
                                 4, capacity=8, min_fill=4, seed=9)
    _wait_done(port)
    _wait_done(jax_)
    for buf, jbuf in zip(port._buffers, jax_._buffers):
        np.testing.assert_array_equal(buf, jbuf)
    it, jit = iter(port), iter(jax_)
    for _ in range(5):
        for x, y in zip(next(it), next(jit)):
            np.testing.assert_array_equal(x, y)
    assert port.stats() == jax_.stats() == {"produced": 11, "drawn": 20, "reuse_factor": 20 / 11,
                                            "buffered": 8}
    port.stop()
    jax_.stop()


def test_replay_loader_transforms_on_the_consumer_and_raises_producer_errors():
    import threading
    seen = []

    def transform(item):
        seen.append(threading.current_thread() is threading.main_thread())
        return item[0].astype(np.float32) / 255, item[1]

    gen = SyntheticVideoGenerator(8, 16, 4, 4, training_examples=6)
    loader = ReplayLoader(gen, batch_size=2, capacity=4, transform=transform)
    x, a = next(iter(loader))
    assert x.dtype == np.float32 and x.shape == (2, 8, 16, 16, 3) and all(seen)
    loader.stop()

    def bad_gen():
        yield (np.zeros((2, 2)),)
        raise ValueError("boom")

    with pytest.raises(RuntimeError, match="replay producer failed"):
        next(iter(ReplayLoader(bad_gen(), batch_size=4, capacity=4, min_fill=4)))


def test_device_replay_rings_and_indices_equal_jax():
    """After 13 inserts into 8 slots (the ring wrapped) the rings hold the
    same items, and sample_idx draws the same (g, b) matrices as JAX's."""
    gen_args = (8, 16, 4, 4)

    def to_items(item):
        frames, actions, _ = item
        return frames.astype(np.float32) / 255.0, np.asarray(actions, np.int32)

    port = DeviceReplay(SyntheticVideoGenerator(*gen_args, training_examples=13, seed=4),
                        lambda it: tuple(torch.from_numpy(np.asarray(f))
                                         for f in to_items(it)),
                        batch_size=4, capacity=8, seed=5, device="cpu")
    jax_ = j_replay.DeviceReplay(j_gym.SyntheticVideoGenerator(*gen_args, training_examples=13,
                                                               seed=4),
                                 to_items, batch_size=4, capacity=8, seed=5)
    for r in (port, jax_):
        deadline = time.time() + 60
        while r._count < 13 and time.time() < deadline:
            r.ingest()
            time.sleep(0.01)
        assert r._count == 13 and r.ready() and not r.exhausted()
    for buf, jbuf in zip(port.buffers(), jax_.buffers()):
        assert buf.shape == tuple(jbuf.shape)
        np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    assert port.buffers()[1].dtype == torch.int32
    for g in (1, 3, 2):
        idx = port.sample_idx(g)
        assert idx.shape == (g, 4) and idx.dtype == np.int32
        np.testing.assert_array_equal(idx, jax_.sample_idx(g))
        assert all(len(set(row)) == 4 for row in idx)
    assert port.stats() == jax_.stats()
    port.stop()
    jax_.stop()


def test_device_replay_reports_an_exhausted_generator_and_producer_errors():
    short = DeviceReplay(SyntheticVideoGenerator(8, 16, 4, 4, training_examples=3),
                         lambda it: (it[0], it[1]), batch_size=4, capacity=8, device="cpu")
    short._thread.join(timeout=60)
    short.ingest()
    assert short.exhausted() and not short.ready()

    def bad_gen():
        yield (np.zeros((2, 2)),)
        raise ValueError("boom")

    bad = DeviceReplay(bad_gen(), lambda it: it, batch_size=1, capacity=2, device="cpu")
    bad._thread.join(timeout=60)
    with pytest.raises(RuntimeError, match="replay producer failed"):
        bad.ingest()
