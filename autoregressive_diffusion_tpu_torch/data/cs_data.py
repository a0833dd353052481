"""Counter-Strike latent datasets: clip windows of VAE-encoded latents.

Counterpart of autoregressive_diffusion_tpu/data/cs_data.py, window for
window in the same order. Each sample is a `clip_size` window of fp16
latent means (and actions) cut from a longer encoded clip, read from
  * a local directory of .npz shards (`LocalLatentShards`, written by
    `write_latent_shard`), or
  * a local MDS dataset (`streaming_dataset`, through data/mds.py; the
    `streaming` package and remote object stores are not supported: a
    `remote` other than None or the local path raises).
`batched_latents` stacks windows into fp32 batches on the host, normalized
as (latents - mean) / std.
"""
from __future__ import annotations

import copy
import json
import os
import queue
import threading
from typing import Iterator, Optional

import numpy as np

from .mds import MDSLocalReader


class LocalLatentShards:
    """Clip windows from .npz shards with arrays 'latents' (t, h, w, c) (or
    'frames') and 'actions' (t,); an endless stream, reshuffled each pass.
    rank/num_replicas stride the shard order over data-parallel processes
    (every rank draws the same order from the seed)."""

    def __init__(self, shard_dir: str, clip_size: int = 64, key: str = "latents",
                 seed: int = 0, shuffle: bool = True, rank: int = 0, num_replicas: int = 1):
        self.paths = sorted(os.path.join(shard_dir, f) for f in os.listdir(shard_dir)
                            if f.endswith(".npz"))
        if not self.paths:
            raise FileNotFoundError(f"no .npz shards in {shard_dir}")
        self.clip_size = clip_size
        self.key = key
        self.seed = seed
        self.shuffle = shuffle
        self.rank = rank
        self.num_replicas = num_replicas

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed)
        order = np.arange(len(self.paths))
        while True:
            if self.shuffle:
                rng.shuffle(order)
            for i in order[self.rank::self.num_replicas]:
                with np.load(self.paths[i]) as z:
                    data = z[self.key]
                    actions = z["actions"] if "actions" in z else None
                starts = np.arange(data.shape[0] // self.clip_size) * self.clip_size
                if self.shuffle:
                    rng.shuffle(starts)
                for s in starts:
                    item = {self.key: data[s:s + self.clip_size]}
                    if actions is not None:
                        item["actions"] = actions[s:s + self.clip_size]
                    yield item


def write_latent_shard(path: str, latents: np.ndarray, actions: Optional[np.ndarray] = None,
                       key: str = "latents"):
    """One clip as a compressed .npz shard: fp16 latents (or, under
    key='frames', the array as given) and the actions."""
    arrays = {key: latents.astype(np.float16) if key == "latents" else latents}
    if actions is not None:
        arrays["actions"] = actions
    np.savez_compressed(path, **arrays)


def merge_shard_index(out_dir: str, shard_dirs) -> str:
    """One MDS index.json in out_dir over the datasets in shard_dirs: their
    shard entries concatenated, each file's basename made relative to
    out_dir. Returns the merged index's path."""
    merged = {"version": 2, "shards": []}
    for d in shard_dirs:
        f = os.path.join(d, "index.json")
        with open(f) as fh:
            idx = json.load(fh)
        if idx.get("version", 2) != 2:
            raise ValueError(f"unsupported index version in {f}")
        rel = os.path.relpath(os.path.abspath(d), os.path.abspath(out_dir))
        for shard in idx["shards"]:
            shard = dict(shard)
            for k in ("raw_data", "zip_data", "raw_meta", "zip_meta"):
                v = shard.get(k)
                if v and v.get("basename"):
                    v = dict(v)
                    v["basename"] = (os.path.join(rel, v["basename"]) if rel != "."
                                     else v["basename"])
                    shard[k] = v
            merged["shards"].append(shard)
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "index.json")
    with open(out, "w") as fh:
        json.dump(merged, fh)
    return out


# the MDS column names of the CS dataset ('mean', 'action') under this
# package's batch keys
_MDS_KEY_ALIASES = {"latents": ("mean",), "frames": ("frames",), "actions": ("action",)}


def _mds_column(sample: dict, key: str):
    if key in sample:
        return np.asarray(sample[key])
    for alias in _MDS_KEY_ALIASES.get(key, ()):
        if alias in sample:
            return np.asarray(sample[alias])
    return None


def streaming_dataset(remote: Optional[str], local: str, clip_size: int = 64,
                      key: str = "latents", shuffle: bool = True):
    """The windows of a local MDS dataset (one pass), as LocalLatentShards
    yields them. Columns 'mean'/'action' or 'latents'/'actions'."""
    if remote not in (None, local):
        raise ImportError("remote MDS streams need the `streaming` package, which the port "
                          "does not use; data/mds.py reads local datasets only")
    for sample in MDSLocalReader(local, shuffle=shuffle):
        data = _mds_column(sample, key)
        if data is None:
            raise KeyError(f"MDS sample has none of {(key,) + _MDS_KEY_ALIASES.get(key, ())}; "
                           f"columns: {sorted(sample)}")
        if isinstance(data, (bytes, bytearray)):
            data = np.frombuffer(data, dtype=np.float16)
        actions = _mds_column(sample, "actions")
        for s in range(0, data.shape[0] - clip_size + 1, clip_size):
            item = {key: data[s:s + clip_size]}
            if actions is not None:
                item["actions"] = actions[s:s + clip_size]
            yield item


def batched_latents(dataset, batch_size: int, normalize=None, num_workers: int = 2,
                    prefetch: int = 4):
    """(b, t, h, w, c) fp32 batches {'latents' | 'frames', ['actions']},
    (x - mean) / std with normalize=(mean, std). num_workers > 0 copies the
    dataset into that many threads (seed + w each) behind a queue, in the
    order they deliver; num_workers=0 reads it in order and stops when it
    ends (the tail batch dropped)."""
    if num_workers > 0:
        q: queue.Queue = queue.Queue(maxsize=prefetch * batch_size)

        def worker(it):
            for item in it:
                q.put(item)

        for w in range(num_workers):
            ds = copy.copy(dataset)
            if hasattr(ds, "seed"):
                ds.seed = dataset.seed + w
            threading.Thread(target=worker, args=(iter(ds),), daemon=True).start()
        items_of = iter(q.get, None)
    else:
        items_of = iter(dataset)
    while True:
        items = []
        for _ in range(batch_size):
            try:
                items.append(next(items_of))
            except StopIteration:
                return
        key = "latents" if "latents" in items[0] else "frames"
        arr = np.stack([np.asarray(it[key], np.float32) for it in items])
        if normalize is not None:
            mean, std = normalize
            arr = (arr - mean) / std
        out = {key: arr}
        if "actions" in items[0]:
            out["actions"] = np.stack([it["actions"] for it in items])
        yield out
