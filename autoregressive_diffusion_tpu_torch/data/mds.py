"""A local MosaicML-MDS (v2) shard writer and reader.

Counterpart of autoregressive_diffusion_tpu/data/mds.py, byte for byte on
uncompressed shards and their index: the CS dataset is stored as MDS shards
with the columns {'mean': 'ndarray', 'action': 'ndarray'}, and this module
writes and reads enough of the format that the CS path needs neither the
`streaming` package nor a network.

  shard file (.mds):   [num_samples: u32][offsets: (n+1) x u32, absolute]
                       [sample bytes ...]
  sample encoding:     u32 size prefix per *variable-size* column (in column
                       order), then each column's raw bytes
  'ndarray' codec:     dtype id (u8) + ndim (u8) + ndim x u32 shape + raw data
  index.json:          {"version": 2, "shards": [{format: "mds",
                       column_names/encodings/sizes, samples, raw_data:
                       {basename, bytes}, zip_data, compression}, ...]}

Compression 'zstd' goes through the `zstandard` package when it imports
(shards stored as `<name>.mds.zstd`, unzipped into the directory on first
read); without it, writing or reading a zstd shard raises an ImportError
that names the package.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional

import numpy as np

# the MDS ndarray codec's dtype table (ids start at 1)
_DTYPES = ["uint8", "uint16", "uint32", "uint64",
           "int8", "int16", "int32", "int64",
           "float16", "float32", "float64"]
_DTYPE_TO_ID = {d: i + 1 for i, d in enumerate(_DTYPES)}


def _zstandard():
    try:
        import zstandard
    except ImportError as e:
        raise ImportError("zstd-compressed MDS shards need the `zstandard` package, which is "
                          "not installed; write them with compression=None") from e
    return zstandard


def _encode_ndarray(arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name not in _DTYPE_TO_ID:
        raise TypeError(f"unsupported ndarray dtype {arr.dtype}")
    head = (np.uint8(_DTYPE_TO_ID[arr.dtype.name]).tobytes()
            + np.uint8(arr.ndim).tobytes()
            + np.asarray(arr.shape, np.uint32).tobytes())
    return head + arr.tobytes()


def _decode_ndarray(data: bytes) -> np.ndarray:
    dtype_id = int(np.frombuffer(data[:1], np.uint8)[0])
    ndim = int(np.frombuffer(data[1:2], np.uint8)[0])
    shape = np.frombuffer(data[2:2 + 4 * ndim], np.uint32).astype(np.int64)
    return np.frombuffer(data[2 + 4 * ndim:], _DTYPES[dtype_id - 1]).reshape(shape)


def _codec(encoding: str):
    """(encode, decode, fixed size or None) of a column encoding."""
    if encoding == "ndarray":
        return _encode_ndarray, _decode_ndarray, None
    if encoding == "bytes":
        return bytes, (lambda b: b), None
    if encoding == "str":
        return (lambda s: s.encode("utf-8")), (lambda b: b.decode("utf-8")), None
    if encoding in ("int", "int64"):
        return ((lambda v: np.int64(v).tobytes()),
                (lambda b: int(np.frombuffer(b, np.int64)[0])), 8)
    raise ValueError(f"unsupported MDS column encoding: {encoding}")


class MDSShardWriter:
    """Writes one local MDS dataset directory: shard.NNNNN.mds[.zstd] files
    and index.json. Use as a context manager, or call finish()."""

    def __init__(self, out_dir: str, columns: Dict[str, str], size_limit: int = 1 << 26,
                 compression: Optional[str] = None):
        if compression not in (None, "zstd"):
            raise ValueError(f"unsupported compression {compression}")
        if compression == "zstd":
            _zstandard()  # fail before any sample is encoded
        self.out_dir = out_dir
        self.columns = dict(columns)
        self.names = sorted(columns)  # MDS sorts the column names
        self.size_limit = size_limit
        self.compression = compression
        os.makedirs(out_dir, exist_ok=True)
        self._samples: List[bytes] = []
        self._bytes = 0
        self._shards: List[dict] = []

    def write(self, sample: dict) -> None:
        sizes, blobs = [], []
        for name in self.names:
            enc, _, fixed = _codec(self.columns[name])
            blob = enc(sample[name])
            if fixed is None:
                sizes.append(len(blob))
            elif len(blob) != fixed:
                raise ValueError(f"column {name}: got {len(blob)} bytes, fixed size {fixed}")
            blobs.append(blob)
        data = np.asarray(sizes, np.uint32).tobytes() + b"".join(blobs)
        self._samples.append(data)
        self._bytes += len(data)
        if self._bytes >= self.size_limit:
            self._flush_shard()

    def _flush_shard(self) -> None:
        if not self._samples:
            return
        n = len(self._samples)
        offsets = np.empty(n + 1, np.uint32)
        offsets[0] = 4 + 4 * (n + 1)
        for i, s in enumerate(self._samples):
            offsets[i + 1] = offsets[i] + len(s)
        raw = np.uint32(n).tobytes() + offsets.tobytes() + b"".join(self._samples)
        basename = f"shard.{len(self._shards):05d}.mds"
        entry = {
            "version": 2, "format": "mds", "compression": self.compression,
            "hashes": [], "size_limit": self.size_limit, "samples": n,
            "column_names": self.names,
            "column_encodings": [self.columns[c] for c in self.names],
            "column_sizes": [_codec(self.columns[c])[2] for c in self.names],
            "raw_data": {"basename": basename, "bytes": len(raw), "hashes": {}},
            "zip_data": None,
        }
        if self.compression == "zstd":
            zipped = _zstandard().ZstdCompressor().compress(raw)
            entry["zip_data"] = {"basename": basename + ".zstd", "bytes": len(zipped),
                                 "hashes": {}}
            with open(os.path.join(self.out_dir, basename + ".zstd"), "wb") as f:
                f.write(zipped)
        else:
            with open(os.path.join(self.out_dir, basename), "wb") as f:
                f.write(raw)
        self._shards.append(entry)
        self._samples, self._bytes = [], 0

    def finish(self) -> str:
        """Write the last shard and index.json; the index's path."""
        self._flush_shard()
        index = os.path.join(self.out_dir, "index.json")
        with open(index, "w") as f:
            json.dump({"version": 2, "shards": self._shards}, f)
        return index

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.finish()


class MDSLocalReader:
    """Random access to, and iteration over, a local MDS dataset directory
    (shuffled with a seeded numpy permutation when asked)."""

    def __init__(self, local: str, shuffle: bool = False, seed: int = 0):
        self.local = local
        self.shuffle = shuffle
        self.seed = seed
        with open(os.path.join(local, "index.json")) as f:
            index = json.load(f)
        if index.get("version") != 2:
            raise ValueError(f"unsupported MDS index version {index.get('version')}")
        self.shards = index["shards"]
        self._starts = np.cumsum([0] + [s["samples"] for s in self.shards])

    def __len__(self) -> int:
        return int(self._starts[-1])

    def _shard_path(self, shard: dict) -> str:
        raw = os.path.join(self.local, shard["raw_data"]["basename"])
        if os.path.exists(raw):
            return raw
        zd = shard.get("zip_data")
        if zd and (shard.get("compression") or "").startswith("zstd"):
            with open(os.path.join(self.local, zd["basename"]), "rb") as f:
                data = _zstandard().ZstdDecompressor().decompress(
                    f.read(), max_output_size=shard["raw_data"]["bytes"])
            os.makedirs(os.path.dirname(raw), exist_ok=True)
            with open(raw, "wb") as f:  # unzipped once, beside the shard
                f.write(data)
            return raw
        raise FileNotFoundError(raw)

    def __getitem__(self, idx: int) -> dict:
        if not 0 <= idx < len(self):
            raise IndexError(idx)
        si = int(np.searchsorted(self._starts, idx, side="right")) - 1
        shard = self.shards[si]
        local_idx = idx - int(self._starts[si])
        with open(self._shard_path(shard), "rb") as f:
            f.seek(4 + 4 * local_idx)
            begin, end = np.frombuffer(f.read(8), np.uint32)
            f.seek(int(begin))
            data = f.read(int(end) - int(begin))
        fixed = shard["column_sizes"]
        n_var = sum(1 for s in fixed if s is None)
        var_sizes = np.frombuffer(data[:4 * n_var], np.uint32)
        pos, vi = 4 * n_var, 0
        sample = {}
        for name, enc, size in zip(shard["column_names"], shard["column_encodings"], fixed):
            if size is None:
                size = int(var_sizes[vi])
                vi += 1
            sample[name] = _codec(enc)[1](data[pos:pos + size])
            pos += size
        return sample

    def __iter__(self) -> Iterator[dict]:
        order = np.arange(len(self))
        if self.shuffle:
            np.random.default_rng(self.seed).shuffle(order)
        for i in order:
            yield self[int(i)]
