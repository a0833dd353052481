"""Kwargs-bundle model checkpoints (`.ad` files), read and written without
JAX, flax or msgpack.

Counterpart of autoregressive_diffusion_tpu/utils/checkpoint.py.
The first half is `save_model` / `load_model`. A bundle is a msgpack map with
bytes keys: b"kwargs" (the model's constructor knobs as JSON), b"variables"
and, optionally, b"extra", each of the last two a bin blob that holds flax's
`serialization.to_bytes` of a tree: a map with str keys whose leaves are
ext-typed arrays. This module implements the subset of msgpack that flax
writes there:
  * nil, bool, every int and float width, str8/16/32, bin8/16/32,
    fixarray/array16/32, fixmap/map16/32, fixext1-16 and ext8/16/32;
  * ext type 1, an ndarray: packb((shape, dtype name, C-order bytes));
    type 3, a numpy scalar (the same payload, unpacked to a scalar);
    type 2, a complex number: packb((real, imag));
  * flax's `__msgpack_chunked_array__` maps, which hold arrays larger than
    its 1 GiB chunk size as flat chunks.
The file is read once into a buffer, and every array leaf is a numpy view
of that buffer: the only copy of a leaf is the one its consumer makes.
numpy has no bfloat16, so a bfloat16 leaf comes back as a `BFloat16Leaf`
holding its uint16 bit patterns; `np.asarray` widens it exactly to fp32.
Remote (s3://, gs://) paths are not carried over.

The second half is resumable train-state checkpoints (`save_train_state`,
`restore_train_state`, `latest_step`, `wait_for_pending_saves`). A
checkpoint is a directory `step_{step:09d}/` under the checkpoint directory,
holding one msgpack file, `train_state.msgpack`: a map {"state", "extra"}
written by this module's writer. "state" is the TrainState as a tree of
arrays under the JAX package's names (utils/bridge.train_state_tree:
params, buffers, both EMA trees, the AdamW moments and count, coefs, step);
"extra" is a schema-free map of arrays (the loss history). The JAX package
writes its train states with Orbax (tensorstore, OCDBT); this format is not
Orbax's, and neither side reads the other's directories.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import struct
import threading
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class BFloat16Leaf:
    """A bfloat16 array held as its uint16 bit patterns (`bits`). It widens
    to fp32 exactly (a bf16 value is the top half of an fp32 word), both by
    `float32()` and wherever numpy converts it (`np.asarray(leaf)`), so
    arithmetic never sees the raw bits."""

    def __init__(self, bits: np.ndarray):
        if bits.dtype != np.uint16:
            raise TypeError(f"bfloat16 bits must be uint16, not {bits.dtype}")
        self.bits = bits

    shape = property(lambda self: self.bits.shape)
    ndim = property(lambda self: self.bits.ndim)
    size = property(lambda self: self.bits.size)

    def float32(self) -> np.ndarray:
        wide = self.bits.astype(np.uint32)
        wide <<= 16  # in place: a 0-d array stays an array
        return wide.view(np.float32)

    def __array__(self, dtype=None, copy=None):
        out = self.float32()
        return out if dtype is None else out.astype(dtype)

    def __repr__(self):
        return f"BFloat16Leaf(shape={self.shape})"


class _Reader:
    """Recursive msgpack decoder over a memoryview; bin payloads and array
    leaves are views of it."""

    def __init__(self, buf: memoryview, what: str):
        self.buf, self.pos, self.what = buf, 0, what

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if n < 0 or end > len(self.buf):
            raise ValueError(f"{self.what}: truncated msgpack data (needs {n} bytes at "
                             f"offset {self.pos} of {len(self.buf)})")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b in _FIXED:
            return _FIXED[b]
        kind, fmt = _SIZED.get(b, (None, None))
        if kind is None:
            raise ValueError(f"{self.what}: msgpack type byte {b:#04x} at offset "
                             f"{self.pos - 1} is not one flax writes")
        if kind == "num":
            return self.unpack(fmt)
        if kind == "fixext":
            code = self.unpack(">b")
            return self.ext(code, self.take(fmt))
        n = self.unpack(fmt)
        if kind == "bin":
            return self.take(n)
        if kind == "str":
            return self.str(n)
        if kind == "array":
            return [self.value() for _ in range(n)]
        if kind == "map":
            return self.map(n)
        code = self.unpack(">b")  # ext8/16/32
        return self.ext(code, self.take(n))

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            if isinstance(key, memoryview):
                key = bytes(key)
            out[key] = self.value()
        return out

    def ext(self, code: int, data: memoryview):
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            arr = _ndarray(data, self.what)
            return arr if code == _EXT_NDARRAY else arr[()]
        if code == _EXT_COMPLEX:
            real, imag = _decode(data, self.what)
            return complex(real, imag)
        raise ValueError(f"{self.what}: msgpack ext type {code} is not one flax writes")


_FIXED = {0xC0: None, 0xC2: False, 0xC3: True}
_SIZED = {
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
    0xCA: ("num", ">f"), 0xCB: ("num", ">d"),
    0xCC: ("num", ">B"), 0xCD: ("num", ">H"), 0xCE: ("num", ">I"), 0xCF: ("num", ">Q"),
    0xD0: ("num", ">b"), 0xD1: ("num", ">h"), 0xD2: ("num", ">i"), 0xD3: ("num", ">q"),
    0xD4: ("fixext", 1), 0xD5: ("fixext", 2), 0xD6: ("fixext", 4), 0xD7: ("fixext", 8),
    0xD8: ("fixext", 16),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}


def _decode(buf: memoryview, what: str):
    reader = _Reader(buf, what)
    out = reader.value()
    if reader.pos != len(buf):
        raise ValueError(f"{what}: {len(buf) - reader.pos} bytes after the msgpack object")
    return _unchunk(out)


def _ndarray(data: memoryview, what: str):
    """flax's _ndarray_from_bytes: (shape, dtype name, bytes) -> a view."""
    shape, name, raw = _decode(data, what)
    name = bytes(name) if isinstance(name, memoryview) else name.encode()
    if name == b"bfloat16":
        return BFloat16Leaf(np.frombuffer(raw, np.uint16).reshape(shape))
    return np.frombuffer(raw, np.dtype(name.decode())).reshape(shape)


def _unchunk(tree):
    """Reassemble flax's chunked-array maps (serialization._unchunk)."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], BFloat16Leaf):
            return BFloat16Leaf(np.concatenate([c.bits for c in chunks]).reshape(shape))
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def load_model(path, with_extra: bool = False):
    """(kwargs, variables) -- or (kwargs, variables, extra) with
    `with_extra`, extra None when the bundle has none -- from a bundle that
    the JAX package's save_model (or this module's) wrote. variables and
    extra are nested dicts of numpy arrays (BFloat16Leaf for bfloat16)."""
    path = os.fspath(path)
    size = os.path.getsize(path)
    buf = bytearray(size)
    with open(path, "rb") as f:
        if f.readinto(buf) != size:
            raise ValueError(f"{path}: short read")
    payload = _decode(memoryview(buf), path)
    if not isinstance(payload, dict) or b"kwargs" not in payload or b"variables" not in payload:
        raise ValueError(f"{path}: not a kwargs bundle (no kwargs/variables map)")
    kwargs = json.loads(bytes(payload[b"kwargs"]).decode())
    variables = _decode(payload[b"variables"], path)
    if not with_extra:
        return kwargs, variables
    extra = _decode(payload[b"extra"], path) if b"extra" in payload else None
    return kwargs, variables, extra


# ---------------------------------------------------------------------------
# writing: msgpack as the msgpack package packs what flax hands it

class _Writer:
    def __init__(self):
        self.parts = []

    def head(self, n: int, fix: int, fix_max: int, codes):
        """A length header: fix form, then 8/16/32-bit forms (codes)."""
        if fix is not None and n <= fix_max:
            self.parts.append(struct.pack(">B", fix | n))
            return
        for code, fmt in codes:
            if n < 1 << (8 * struct.calcsize(fmt)):
                self.parts.append(struct.pack(">B" + fmt[1:], code, n))
                return
        raise ValueError(f"msgpack object of length {n} is too large")

    def value(self, v):
        if v is None:
            self.parts.append(b"\xc0")
        elif v is True or v is False:
            self.parts.append(b"\xc3" if v else b"\xc2")
        elif type(v) is int:
            self.int(v)
        elif type(v) is float:
            self.parts.append(struct.pack(">Bd", 0xCB, v))
        elif type(v) is str:
            raw = v.encode("utf-8")
            self.head(len(raw), 0xA0, 31, ((0xD9, ">B"), (0xDA, ">H"), (0xDB, ">I")))
            self.parts.append(raw)
        elif isinstance(v, (bytes, bytearray, memoryview)):
            self.head(len(v), None, 0, ((0xC4, ">B"), (0xC5, ">H"), (0xC6, ">I")))
            self.parts.append(bytes(v))
        elif isinstance(v, (list, tuple)):
            self.head(len(v), 0x90, 15, ((0xDC, ">H"), (0xDD, ">I")))
            for x in v:
                self.value(x)
        elif isinstance(v, dict):
            self.head(len(v), 0x80, 15, ((0xDE, ">H"), (0xDF, ">I")))
            for k, x in v.items():
                self.value(k)
                self.value(x)
        elif isinstance(v, (np.ndarray, BFloat16Leaf)):
            self.ext(_EXT_NDARRAY, _ndarray_bytes(v))
        elif isinstance(v, np.generic):
            self.ext(_EXT_NPSCALAR, _ndarray_bytes(np.asarray(v)))
        elif type(v) is complex:
            self.ext(_EXT_COMPLEX, _encode((v.real, v.imag)))
        else:
            raise TypeError(f"cannot write {type(v).__name__} into a bundle")

    def int(self, v: int):
        if 0 <= v <= 0x7F or -32 <= v < 0:
            self.parts.append(struct.pack(">b" if v < 0 else ">B", v))
            return
        forms = (((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")) if v >= 0 else
                 ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q")))
        for code, fmt in forms:
            try:
                self.parts.append(struct.pack(">B" + fmt[1:], code, v))
                return
            except struct.error:
                continue
        raise ValueError(f"integer {v} does not fit in 64 bits")

    def ext(self, code: int, data: bytes):
        n = len(data)
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixed:
            self.parts.append(struct.pack(">Bb", fixed[n], code))
        else:
            self.head(n, None, 0, ((0xC7, ">B"), (0xC8, ">H"), (0xC9, ">I")))
            self.parts.append(struct.pack(">b", code))
        self.parts.append(data)


def _encode(v) -> bytes:
    w = _Writer()
    w.value(v)
    return b"".join(w.parts)


def _ndarray_bytes(arr) -> bytes:
    """flax's _ndarray_to_bytes: packb((shape, dtype name, C-order bytes))."""
    if isinstance(arr, BFloat16Leaf):
        return _encode((arr.shape, "bfloat16", np.ascontiguousarray(arr.bits).tobytes()))
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be written into a bundle")
    return _encode((arr.shape, arr.dtype.name, arr.tobytes("C")))


def _state_dict(tree):
    """What the JAX package's save_model hands flax: every leaf through
    np.asarray (a Python or numpy scalar becomes a 0-d array; None stays),
    dict keys sorted as JAX's tree functions order them, sequences as
    {"0": ..., "1": ...} maps (flax to_state_dict), keys as str."""
    if isinstance(tree, dict):
        return {str(k): _state_dict(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    if tree is None or isinstance(tree, BFloat16Leaf):
        return tree
    return np.asarray(tree)


def save_model(path, kwargs: Dict[str, Any], variables,
               extra: Optional[Dict[str, Any]] = None) -> None:
    """Write a {kwargs, variables[, extra]} bundle that the JAX package's
    load_model (and this module's) reads. kwargs must be JSON-serializable;
    variables and extra are nested dicts of arrays. No leaf may exceed
    flax's 1 GiB chunk size (the chunked form is read, not written)."""
    trees = {"variables": variables, **({"extra": extra} if extra else {})}
    payload = {b"kwargs": json.dumps(kwargs).encode()}
    for name, tree in trees.items():
        state = _state_dict(tree)
        _check_leaf_sizes(state)
        payload[name.encode()] = _encode(state)
    path = Path(os.fspath(path))
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(_encode({k: payload[k] for k in sorted(payload)}))  # as flax orders it


def _check_leaf_sizes(tree):
    for v in tree.values():
        if isinstance(v, dict):
            _check_leaf_sizes(v)
        elif isinstance(v, (np.ndarray, BFloat16Leaf)) and v.size * _itemsize(v) > 1 << 30:
            raise ValueError("a leaf over 1 GiB needs flax's chunked form, which is not written")


def _itemsize(v) -> int:
    return 2 if isinstance(v, BFloat16Leaf) else v.dtype.itemsize


# ---------------------------------------------------------------------------
# train-state checkpoints

TRAIN_STATE_FILE = "train_state.msgpack"
_STEP_DIR = re.compile(r"step_(\d+)")
_pending: Optional[threading.Thread] = None
_pending_error: list = []


class _FileParts:
    """A _Writer's parts list that writes each part to a file at once, so a
    train state is never held twice on the host (a 310M-parameter state is
    6 GB)."""

    def __init__(self, f):
        self.append = f.write


def _write_msgpack(path: Path, tree) -> None:
    """Write a tree of arrays as one msgpack object, part by part."""
    w = _Writer()
    state = _state_dict(tree)
    _check_leaf_sizes(state)
    with open(path, "wb") as f:
        w.parts = _FileParts(f)
        w.value(state)


def _read_msgpack(path: Path):
    size = os.path.getsize(path)
    buf = bytearray(size)
    with open(path, "rb") as f:
        if f.readinto(buf) != size:
            raise ValueError(f"{path}: short read")
    return _decode(memoryview(buf), str(path))


def _step_dirs(ckpt_dir) -> list:
    d = Path(os.fspath(ckpt_dir))
    if not d.is_dir():
        return []
    return sorted(int(m.group(1)) for n in os.listdir(d) if (m := _STEP_DIR.fullmatch(n)))


def wait_for_pending_saves() -> None:
    """Join the checkpoint write in flight, if any, and raise its error.
    save/restore_train_state and latest_step call it first; call it before
    the process exits when the last save used block=False."""
    global _pending
    if _pending is not None:
        _pending.join()
        _pending = None
    if _pending_error:
        raise RuntimeError("a background checkpoint write failed") from _pending_error.pop()


def save_train_state(ckpt_dir, step: int, state, extra: Optional[dict] = None,
                     keep: Optional[int] = None, block: bool = True) -> Path:
    """Write `state` (a train/train_state.TrainState, or the host tree of
    one that utils/bridge.train_state_tree or parallel.gather_to_host
    made) to ckpt_dir/step_{step:09d}/, replacing a checkpoint of the same
    step.
    `extra` is a flat map of array-likes (a list becomes a 1-d array), read
    back by restore_train_state as numpy arrays.

    `keep` -- if given, only the newest `keep` step directories are kept
    after a successful write.

    `block=False` -- copy the state to the host now (a copy even of CPU
    tensors, which the next in-place train step would otherwise change under
    the writer), then encode and write on a background thread, so training
    goes on at once. At most one write is in flight: a new save waits for
    the last. Keep block=True where the process exits next. The write goes
    to a temporary directory renamed into place, so a crash leaves either
    the old checkpoint or the new one."""
    from .bridge import train_state_tree

    wait_for_pending_saves()
    root = Path(os.fspath(ckpt_dir)).absolute()
    final = root / f"step_{step:09d}"
    tree = {"state": state if isinstance(state, dict) else train_state_tree(state),
            "extra": {str(k): np.asarray(v) for k, v in (extra or {}).items()}}

    def write():
        root.mkdir(parents=True, exist_ok=True)
        tmp = root / f".step_{step:09d}.{os.getpid()}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        _write_msgpack(tmp / TRAIN_STATE_FILE, tree)
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        if keep is not None and keep > 0:
            for s in _step_dirs(root)[:-keep]:
                shutil.rmtree(root / f"step_{s:09d}", ignore_errors=True)

    if block:
        write()
    else:
        def run():
            try:
                write()
            except BaseException as e:  # re-raised by wait_for_pending_saves
                _pending_error.append(e)

        global _pending
        _pending = threading.Thread(target=run, name=f"ckpt-write-{step}")
        _pending.start()
    return final


def restore_train_state(ckpt_dir, step: int, state, extra_template=None):
    """Load checkpoint `step` into `state` (a TrainState built as the saved
    one was: same model config, optimizer and EMA stds), in place. Returns
    (state, extra), extra a dict of numpy arrays. `extra_template` is
    accepted, as in the JAX package, and ignored: extra restores without
    a schema."""
    from .bridge import load_train_state_tree

    wait_for_pending_saves()
    path = Path(os.fspath(ckpt_dir)) / f"step_{step:09d}" / TRAIN_STATE_FILE
    tree = _read_msgpack(path)
    load_train_state_tree(state, tree["state"])
    return state, {k: np.array(v) for k, v in tree.get("extra", {}).items()}


def latest_step(ckpt_dir) -> Optional[int]:
    """The newest checkpoint's step under ckpt_dir, or None."""
    wait_for_pending_saves()
    steps = _step_dirs(ckpt_dir)
    return steps[-1] if steps else None
