"""Checkpoint and resume for filter banks — the counterpart of
``slam_uwv_kalman_filters_tpu/parallel/checkpoint.py``.

A bank (state, parameters, or both) is a tree of NamedTuples of tensors; a
checkpoint is that tree in the byte format of flax's
``serialization.to_bytes``, so either package restores what the other saved.
The format is a msgpack map (NamedTuple fields by name, plain tuples as
``"0"``, ``"1"``, …) whose array leaves are msgpack ext type 1 holding the
msgpack of ``(shape, dtype name, C-order bytes)``; numpy scalars are ext
type 3; an array over ``MAX_CHUNK_SIZE`` bytes is split into a
``{"__msgpack_chunked_array__": True, "shape": …, "chunks": …}`` map. The
small encoder and decoder below cover exactly that subset (the port does not
depend on ``msgpack`` or ``flax``), and stream array bytes to and from the
file without building the whole checkpoint in memory twice.

Resume is the reference's construct-from-state path: :func:`restore` fills
the structure of a template tree, each tensor on its template leaf's device.
"""

from __future__ import annotations

import os
import struct
from pathlib import Path
from typing import Any, BinaryIO

import numpy as np
import torch

__all__ = ["MAX_CHUNK_SIZE", "save", "restore", "save_sharded", "restore_sharded"]

# flax splits array leaves above this many bytes (msgpack's per-object limit
# is 2**31 - 1; flax leaves a margin)
MAX_CHUNK_SIZE = 2**30

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


def _refuse_orbax() -> None:
    raise NotImplementedError(
        "the orbax checkpoint backend is not ported (it imports JAX; ROADMAP.md 'Not to port'): "
        "use the default msgpack backend"
    )


# ---------------------------------------------------------------------------
# tree → flax state dict
# ---------------------------------------------------------------------------


def _state_dict(tree: Any) -> Any:
    """flax ``to_state_dict`` of a port tree: NamedTuples as maps by field
    name, tuples and lists as maps keyed ``"0"``, ``"1"``, …, tensors as
    numpy arrays (on the host)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {name: _state_dict(getattr(tree, name)) for name in tree._fields}
    if isinstance(tree, (tuple, list)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        return {str(k): _state_dict(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def _chunked(arr: np.ndarray) -> dict:
    """flax's ``_chunk``: a flat array split into ``MAX_CHUNK_SIZE``-byte
    pieces (views, no copy)."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = np.ascontiguousarray(arr).reshape(-1)
    return {
        _CHUNKED: True,
        "shape": {str(i): d for i, d in enumerate(arr.shape)},
        "chunks": {str(k): flat[i : i + size] for k, i in enumerate(range(0, flat.size, size))},
    }


# ---------------------------------------------------------------------------
# msgpack encoding (the subset flax writes)
# ---------------------------------------------------------------------------


def _int(v: int) -> bytes:
    if 0 <= v < 0x80 or -0x20 <= v < 0:
        return struct.pack(">b" if v < 0 else ">B", v)
    for lo, hi, code, fmt in ((0, 0xFF, 0xCC, ">B"), (-0x80, -1, 0xD0, ">b"), (0, 0xFFFF, 0xCD, ">H"),
                              (-0x8000, -1, 0xD1, ">h"), (0, 0xFFFFFFFF, 0xCE, ">I"),
                              (-0x80000000, -1, 0xD2, ">i"), (0, 0xFFFFFFFFFFFFFFFF, 0xCF, ">Q"),
                              (-0x8000000000000000, -1, 0xD3, ">q")):
        if lo <= v <= hi:
            return bytes([code]) + struct.pack(fmt, v)
    raise OverflowError(f"integer {v} does not fit msgpack")


def _sized(n: int, fix: int | None, fix_max: int, codes: tuple) -> bytes:
    """Header of a sized msgpack object: the fix form below ``fix_max``,
    else the 8-, 16- or 32-bit length form (``codes``; None where a form
    does not exist)."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"msgpack object of length {n} is too large")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _sized(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + b


def _bin_header(n: int) -> bytes:
    return _sized(n, None, -1, (0xC4, 0xC5, 0xC6))


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = bytes([fixed[n]]) if n in fixed else _sized(n, None, -1, (0xC7, 0xC8, 0xC9))
    return head + bytes([code])


def _array_pieces(arr: np.ndarray, code: int) -> list:
    """flax's ``_ndarray_to_bytes`` inside its ext type: the msgpack of
    ``(shape, dtype name, C-order bytes)``, the bytes as a view."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct or arr.dtype.names is not None:
        raise ValueError("object and structured dtypes are not supported in a checkpoint")
    data = memoryview(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
    head = (_sized(3, 0x90, 15, (None, 0xDC, 0xDD)) + _sized(arr.ndim, 0x90, 15, (None, 0xDC, 0xDD))
            + b"".join(_int(d) for d in arr.shape) + _str(arr.dtype.name) + _bin_header(data.nbytes))
    return [_ext_header(code, len(head) + data.nbytes), head, data]


def _pack(obj: Any, out: list) -> None:
    """Append the msgpack pieces of ``obj`` (bytes and memoryviews) to
    ``out``, as ``msgpack.packb(obj, default=flax's ext packer,
    strict_types=True)`` writes them."""
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif type(obj) is int:
        out.append(_int(obj))
    elif type(obj) is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif type(obj) is str:
        out.append(_str(obj))
    elif type(obj) is bytes:
        out.extend((_bin_header(len(obj)), obj))
    elif type(obj) is dict:
        out.append(_sized(len(obj), 0x80, 15, (None, 0xDE, 0xDF)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        if obj.nbytes > MAX_CHUNK_SIZE:
            _pack(_chunked(obj), out)
        else:
            out.extend(_array_pieces(obj, _EXT_NDARRAY))
    elif isinstance(obj, np.generic):
        out.extend(_array_pieces(np.asarray(obj), _EXT_NPSCALAR))
    else:
        raise TypeError(f"cannot checkpoint a leaf of type {type(obj).__name__}")


# ---------------------------------------------------------------------------
# msgpack decoding
# ---------------------------------------------------------------------------


_CONSTANTS = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
            0xD2: ">i", 0xD3: ">q"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
# the length prefix of bin (c4–c6), ext (c7–c9), str (d9–db), array (dc–dd), map (de–df)
_LENGTHS = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xC7: ">B", 0xC8: ">H", 0xC9: ">I", 0xD9: ">B", 0xDA: ">H",
            0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}


class _Reader:
    """msgpack decoder over a writable buffer; arrays come back as numpy
    views of it (no copy)."""

    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated checkpoint")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F or b >= 0xE0:  # positive and negative fixint
            return b if b <= 0x7F else b - 0x100
        if b <= 0x8F:
            return self._map(b & 0x0F)
        if b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b in _CONSTANTS:
            return _CONSTANTS[b]
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        if b in _FIXEXT:
            return self._ext(_FIXEXT[b])
        if b not in _LENGTHS:
            raise ValueError(f"unsupported msgpack type byte 0x{b:02x} in checkpoint")
        n = self.unpack(_LENGTHS[b])
        if b <= 0xC6:
            return self.take(n)
        if b <= 0xC9:
            return self._ext(n)
        if b <= 0xDB:
            return str(self.take(n), "utf-8")
        if b <= 0xDD:
            return [self.read() for _ in range(n)]
        return self._map(n)

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, n: int) -> Any:
        """An ext record of ``n`` payload bytes: flax's ndarray (type 1) or
        numpy scalar (type 3), the msgpack of (shape, dtype name, bytes)."""
        code = self.unpack(">b")
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code} in checkpoint")
        end = self.pos + n
        rec = self.read()
        if self.pos != end or not isinstance(rec, list) or len(rec) != 3:
            raise ValueError("malformed array record in checkpoint")
        shape, name, data = rec
        if name == "bfloat16":
            raise ValueError("bfloat16 arrays are not supported in a checkpoint of the port")
        arr = np.frombuffer(data, dtype=np.dtype(name)).reshape(shape)
        return arr if code == _EXT_NDARRAY else arr[()]


# ---------------------------------------------------------------------------
# flax state dict → template tree
# ---------------------------------------------------------------------------


def _tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy view of the file buffer as a tensor on ``device``; a view at
    an offset unaligned for its dtype is copied first where it stays on the
    CPU (a copy to the card reads it as bytes)."""
    if device.type == "cpu" and arr.ctypes.data % max(1, arr.dtype.itemsize):
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def _leaf(target: Any, sd: Any) -> Any:
    if not isinstance(target, torch.Tensor):
        return bytes(sd) if isinstance(sd, memoryview) else sd
    if isinstance(sd, dict) and sd.get(_CHUNKED) is True:
        shape = tuple(sd["shape"][str(i)] for i in range(len(sd["shape"])))
        chunks = [sd["chunks"][str(i)] for i in range(len(sd["chunks"]))]
        out = torch.empty(shape, dtype=torch.from_numpy(chunks[0][:0]).dtype, device=target.device)
        flat, start = out.view(-1), 0
        for c in chunks:
            flat[start : start + c.size].copy_(torch.from_numpy(c))  # into the aligned, whole leaf
            start += c.size
        return out
    if isinstance(sd, np.generic):
        sd = np.asarray(sd)
    if not isinstance(sd, np.ndarray):
        raise ValueError(f"checkpoint holds a {type(sd).__name__} where the template has a tensor")
    return _tensor(sd, target.device)


def _restore_tree(target: Any, sd: Any, path: str = "") -> Any:
    if isinstance(target, tuple) and hasattr(target, "_fields"):
        if not isinstance(sd, dict) or set(sd) != set(target._fields):
            got = sorted(sd) if isinstance(sd, dict) else type(sd).__name__
            raise ValueError(f"checkpoint fields {got} do not match {type(target).__name__} at '{path}'")
        return type(target)(**{k: _restore_tree(getattr(target, k), sd[k], f"{path}/{k}") for k in target._fields})
    if isinstance(target, (tuple, list)):
        if not isinstance(sd, dict) or len(sd) != len(target):
            raise ValueError(f"checkpoint and template differ in length at '{path}'")
        return type(target)(_restore_tree(t, sd[str(i)], f"{path}/{i}") for i, t in enumerate(target))
    if isinstance(target, dict):
        missing = set(map(str, target)) - set(sd)
        if missing:
            raise ValueError(f"checkpoint lacks keys {sorted(missing)} at '{path}'")
        return {k: _restore_tree(v, sd[str(k)], f"{path}/{k}") for k, v in target.items()}
    return _leaf(target, sd)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def _write(f: BinaryIO, tree: Any) -> None:
    pieces: list = []
    _pack(_state_dict(tree), pieces)
    for p in pieces:
        f.write(p)


def save(path: str | os.PathLike, tree: Any, *, backend: str = "msgpack") -> None:
    """Serialize a tree (filter state, params, or both) to ONE file in the
    flax msgpack format, published atomically (written to ``path.tmp``,
    then renamed). Device tensors are copied to the host leaf by leaf.
    ``backend="orbax"`` is refused: it is not ported."""
    if backend == "orbax":
        _refuse_orbax()
    if backend != "msgpack":
        raise ValueError(f"unknown checkpoint backend {backend!r}")
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        _write(f, tree)
    os.replace(tmp, path)  # atomic publish


def restore(path: str | os.PathLike, target: Any) -> Any:
    """Restore into the structure of ``target`` (a template tree with the
    right layout, e.g. a freshly initialized filter bank): each tensor on
    its template leaf's device, with the dtype it was saved in. A directory
    (an Orbax checkpoint) is refused."""
    path = Path(path)
    if path.is_dir():
        _refuse_orbax()
    buf = np.empty(path.stat().st_size, dtype=np.uint8)  # writable, and not zero-filled first
    with open(path, "rb") as f:
        if f.readinto(memoryview(buf)) != len(buf):
            raise ValueError(f"short read of checkpoint {path}")
    reader = _Reader(buf)
    sd = reader.read()
    if reader.pos != len(buf):
        raise ValueError(f"trailing bytes in checkpoint {path}")
    return _restore_tree(target, sd)


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _shard_path(path: Path, rank: int) -> Path:
    return path.with_name(f"{path.name}.shard{rank}")


def save_sharded(path: str | os.PathLike, tree: Any) -> None:
    """Each process saves the part of a sharded bank it holds (its shard of
    ``parallel.sharding.shard_bank`` and its copy of replicated leaves) to
    ``path.shard{rank}``; the rank is ``torch.distributed``'s, 0 without a
    process group."""
    save(_shard_path(Path(path), _rank()), tree)


def restore_sharded(path: str | os.PathLike, target: Any) -> Any:
    """Restore this process's shard into ``target``, a template with this
    process's layout (e.g. the freshly initialized local shard). Every
    restored leaf's shape is checked against the template's, so a template
    of the wrong bank size fails loudly instead of carrying mismatched
    shards. The tensors land on the template's devices (JAX's ``place``
    step is what :func:`restore` always does here)."""
    restored = restore(_shard_path(Path(path), _rank()), target)
    _check_shapes(restored, target)
    return restored


def _check_shapes(r: Any, t: Any) -> None:
    if isinstance(t, dict):
        for k in t:
            _check_shapes(r[k], t[k])
    elif isinstance(t, (tuple, list)):
        for a, b in zip(r, t):
            _check_shapes(a, b)
    elif isinstance(t, torch.Tensor) and tuple(r.shape) != tuple(t.shape):
        raise ValueError(
            f"checkpoint shard shape {tuple(r.shape)} does not match the template's local shape "
            f"{tuple(t.shape)}: pass a target with this process's bank layout (same global size and "
            "sharding as at save time)"
        )
