"""Gymnasium on-the-fly video data (LunarLander et al.) and a synthetic
stand-in.

Counterpart of autoregressive_diffusion_tpu/data/gym_data.py, with the same
numpy semantics, so the same seed gives the same bytes: a plain Python
generator of clips, batched on the host; the training loop moves each batch
to the card. GymDataGenerator:
  * resamples a random action every (time_compression * frame_interval)
    env steps and captures every `frame_interval`-th frame, resized by
    INTER_AREA (the native library of data/native.py);
  * drops clips where the lander leaves the frame unless `return_anyways`;
  * warms up `evolution_time` steps before capturing and caps an episode at
    `terminate_size` steps.
gymnasium is imported when a generator is iterated, not at import.
"""
from __future__ import annotations

import copy
import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

from .native import resize_area_batch


def resize_frame(frame: np.ndarray, size: int = 256) -> np.ndarray:
    """INTER_AREA resize of one HWC uint8 frame, rounded to uint8."""
    out = resize_area_batch(frame[None], size)
    return np.clip(out[0] + 0.5, 0, 255).astype(np.uint8)


def resize_frames_batch(frames: np.ndarray, size: int = 256) -> np.ndarray:
    """Resize and [-1, 1] normalization of a clip of uint8 frames in one
    native call, OpenMP-parallel over the frames."""
    return resize_area_batch(frames, size, scale=np.float32(1 / 127.5),
                             offset=np.float32(-1.0))


class GymDataGenerator:
    """Yields (frames [state_size, frame_size, frame_size, 3] uint8, actions
    [state_size // time_compression] int64, reward float)."""

    def __init__(self, state_size: int = 32, environment_name: str = "LunarLander-v3",
                 training_examples: int = 10_000, autoencoder_time_compression: int = 4,
                 return_anyways: bool = True, frame_size: int = 256,
                 seed: Optional[int] = None):
        if state_size % autoencoder_time_compression:
            raise ValueError("state_size must be a multiple of the time compression")
        self.state_size = state_size
        self.environment_name = environment_name
        self.evolution_time = 10
        self.terminate_size = 512
        self.training_examples = training_examples
        self.time_compression = autoencoder_time_compression
        self.frame_interval = 2
        self.return_anyways = return_anyways
        self.frame_size = frame_size
        self.seed = seed

    @staticmethod
    def _lander_in_frame(state) -> bool:
        x, y = state[0], state[1]
        return y < 1.4 and abs(x) < 1.0

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, float]]:
        import gymnasium as gym
        env = gym.make(self.environment_name, render_mode="rgb_array")
        if self.seed is not None:
            env.reset(seed=self.seed)
            env.action_space.seed(self.seed)
        terminated = True
        n_yielded = 0
        step_count = 0
        frames, states, actions = [], [], []
        reward, action = 0.0, 0

        while n_yielded < self.training_examples:
            if (not terminated and step_count > 0
                    and step_count % (self.state_size * self.frame_interval) == 0):
                if self.return_anyways or all(self._lander_in_frame(s) for s in states):
                    yield np.stack(frames), np.asarray(actions, np.int64), reward
                    n_yielded += 1
                frames, states, actions = [], [], []

            if terminated:
                env.reset()
                terminated = False
                reward, action = 0.0, 0
                frames, states, actions = [], [], []
                step_count = -self.evolution_time
            else:
                if step_count % (self.time_compression * self.frame_interval) == 0:
                    action = env.action_space.sample()
                    if step_count >= 0:
                        actions.append(action)
                state, reward, terminated, _, _ = env.step(action)

            if step_count >= 0 and step_count % self.frame_interval == 0:
                frames.append(resize_frame(env.render(), self.frame_size))
                states.append(state)

            if step_count > self.terminate_size:
                terminated = True
            step_count += 1

    def __len__(self):
        return self.training_examples


def batched(generator, batch_size: int, num_workers: int = 0, prefetch: int = 4):
    """(frames [b, t, h, w, 3], actions [b, t'], rewards [b]) batches. With
    num_workers > 0, `num_workers` copies of the generator (seeds seed + i)
    run in background threads behind a prefetch queue; their items
    interleave in the order the threads deliver them, so only num_workers=0
    gives a fixed order. The incomplete tail batch is dropped."""
    if num_workers <= 0:
        it = iter(generator)
        while True:
            items = []
            for _ in range(batch_size):
                try:
                    items.append(next(it))
                except StopIteration:
                    return
            yield _collate(items)

    q: queue.Queue = queue.Queue(maxsize=max(prefetch * batch_size, batch_size))
    done = object()  # end-of-stream sentinel, one per worker

    def worker(gen):
        for item in gen:
            q.put(item)
        q.put(done)

    for i in range(num_workers):
        g = copy.copy(generator)
        g.seed = None if generator.seed is None else generator.seed + i
        threading.Thread(target=worker, args=(g,), daemon=True).start()

    finished = 0
    items = []
    while True:
        while len(items) < batch_size:
            item = q.get()
            if item is done:
                finished += 1
                if finished == num_workers:
                    return
                continue
            items.append(item)
        yield _collate(items)
        items = []


def _collate(items):
    frames = np.stack([it[0] for it in items])
    actions = np.stack([it[1] for it in items])
    rewards = np.asarray([it[2] for it in items], np.float32)
    return frames, actions, rewards


class SyntheticVideoGenerator:
    """Deterministic moving-square videos, for tests and for machines without
    gymnasium; the same interface as GymDataGenerator."""

    def __init__(self, state_size=32, frame_size=64, n_actions=4, time_compression=4,
                 training_examples=1000, seed=0):
        self.state_size = state_size
        self.frame_size = frame_size
        self.n_actions = n_actions
        self.time_compression = time_compression
        self.training_examples = training_examples
        self.seed = seed

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        vel = {0: (0, 0), 1: (2, 0), 2: (0, 2), 3: (-2, -2)}
        for _ in range(self.training_examples):
            t, s = self.state_size, self.frame_size
            actions = rng.integers(0, self.n_actions, t // self.time_compression)
            frames = np.zeros((t, s, s, 3), np.uint8)
            x, y = s // 2, s // 2
            for i in range(t):
                a = actions[min(i // self.time_compression, len(actions) - 1)]
                dx, dy = vel[int(a) % 4]
                x = (x + dx) % s
                y = (y + dy) % s
                frames[i, max(0, y - 4):y + 4, max(0, x - 4):x + 4] = 255
            yield frames, actions, 0.0

    def __len__(self):
        return self.training_examples
