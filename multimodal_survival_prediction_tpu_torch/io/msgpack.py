"""A pure-Python msgpack codec for the subset that flax fold checkpoints use.

The JAX package writes each fold checkpoint with
``flax.serialization.to_bytes({"params": ..., "batch_stats": ...})``
(``multimodal_survival_prediction_tpu/io/checkpoint.py``), which is
``msgpack.packb(tree, default=<ext hook>, strict_types=True)``. The card's
machine has neither flax nor msgpack, so the port reads and writes that
format here:

  * maps (string keys), arrays, str, bin, ints, floats, nil and bool;
  * ext 1, an ndarray: its payload is itself msgpack, the triple
    ``[shape, dtype name, C-order bytes]``;
  * ext 3, a numpy scalar: the same triple with shape ``[]``.

:func:`packb` writes the bytes that flax writes for the same tree: keys
sorted at every level (JAX's ``device_get`` rebuilds every dict in sorted
order before flax sees it), the smallest header for every value, and
leaves over :data:`MAX_CHUNK_SIZE` bytes split into flax's chunked form
(``{"__msgpack_chunked_array__": True, "shape": ..., "chunks": ...}``, in
flax's own key order). :func:`unpackb` slices a ``memoryview``, copies each
leaf out with ``np.frombuffer(...).copy()`` and joins chunked leaves again.
"""

from __future__ import annotations

import struct

import numpy as np

# flax.serialization.MAX_CHUNK_SIZE: leaves of more bytes are chunked
MAX_CHUNK_SIZE = 2 ** 30
EXT_NDARRAY = 1
EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


# --------------------------------------------------------------------------
# writer
# --------------------------------------------------------------------------

def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v <= 0x7F:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v > 0:
        for fmt, code in ((">B", 0xCC), (">H", 0xCD), (">I", 0xCE),
                          (">Q", 0xCF)):
            if v < 1 << (8 * struct.calcsize(fmt)):
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"integer {v} does not fit msgpack's uint64")
    else:
        for fmt, code in ((">b", 0xD0), (">h", 0xD1), (">i", 0xD2),
                          (">q", 0xD3)):
            if v >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"integer {v} does not fit msgpack's int64")


def _pack_len(out: bytearray, n: int, fix, codes) -> None:
    """A length header: ``fix`` = (base, limit) of the fix form or None,
    ``codes`` the 8/16/32-bit forms' first bytes (None: no 8-bit form)."""
    if fix is not None and n < fix[1]:
        out.append(fix[0] | n)
        return
    for fmt, code in zip((">B", ">H", ">I"), codes):
        if code is not None and n < 1 << (8 * struct.calcsize(fmt)):
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} does not fit msgpack's 32-bit headers")


def _pack_str(out: bytearray, s: str) -> None:
    b = s.encode("utf-8")
    _pack_len(out, len(b), (0xA0, 32), (0xD9, 0xDA, 0xDB))
    out += b


def _pack_bin(out: bytearray, b) -> None:
    _pack_len(out, len(b), None, (0xC4, 0xC5, 0xC6))
    out += b


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(fixext[n])
    else:
        _pack_len(out, n, None, (0xC7, 0xC8, 0xC9))
    out.append(code)
    out += data


def _ndarray_payload(arr: np.ndarray) -> bytes:
    """flax ``_ndarray_to_bytes``: ``packb((shape, dtype.name, bytes))``."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError(f"cannot serialize an array of dtype {arr.dtype}")
    inner = bytearray()
    inner.append(0x93)
    _pack_len(inner, arr.ndim, (0x90, 16), (None, 0xDC, 0xDD))
    for d in arr.shape:
        _pack_int(inner, int(d))
    _pack_str(inner, arr.dtype.name)
    _pack_bin(inner, arr.tobytes("C"))
    return bytes(inner)


def _pack_chunked(out: bytearray, arr: np.ndarray) -> None:
    """flax ``_chunk``: the leaf flattened into pieces of at most
    MAX_CHUNK_SIZE bytes, keys in flax's insertion order."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    out.append(0x83)
    _pack_str(out, _CHUNKED)
    out.append(0xC3)
    _pack_str(out, "shape")
    _pack_len(out, arr.ndim, (0x80, 16), (None, 0xDE, 0xDF))
    for i, d in enumerate(arr.shape):
        _pack_str(out, str(i))
        _pack_int(out, int(d))
    _pack_str(out, "chunks")
    _pack_len(out, len(chunks), (0x80, 16), (None, 0xDE, 0xDF))
    for i, c in enumerate(chunks):
        _pack_str(out, str(i))
        _pack_ext(out, EXT_NDARRAY, _ndarray_payload(c))


def _pack(out: bytearray, obj) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, np.ndarray):
        if obj.size * obj.dtype.itemsize > MAX_CHUNK_SIZE:
            _pack_chunked(out, obj)
        else:
            _pack_ext(out, EXT_NDARRAY, _ndarray_payload(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)))
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        _pack_str(out, obj)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        _pack_bin(out, obj)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), (0x80, 16), (None, 0xDE, 0xDF))
        for k in sorted(obj):
            if not isinstance(k, str):
                raise TypeError(f"map keys must be str, got {k!r}")
            _pack_str(out, k)
            _pack(out, obj[k])
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), (0x90, 16), (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__} to msgpack")


def packb(tree) -> bytes:
    """Encode a tree of dicts, lists, scalars and numpy arrays as flax's
    ``to_bytes`` encodes it after ``jax.device_get``. A numpy scalar is
    written as flax's ext 3; ``device_get`` would have made it a 0-d array
    (ext 1) first, but fold trees hold none."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


# --------------------------------------------------------------------------
# reader
# --------------------------------------------------------------------------

class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("truncated msgpack data")
        view = self.buf[self.pos:end]
        self.pos = end
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            return self.take(self.unpack((">B", ">H", ">I")[b - 0xC4]))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack((">B", ">H", ">I")[b - 0xC7])
            return self.ext(self.unpack(">b"), n)
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        if 0xCC <= b <= 0xD3:
            return self.unpack((">B", ">H", ">I", ">Q",
                                ">b", ">h", ">i", ">q")[b - 0xCC])
        if 0xD4 <= b <= 0xD8:
            n = 1 << (b - 0xD4)
            return self.ext(self.unpack(">b"), n)
        if b in (0xD9, 0xDA, 0xDB):
            n = self.unpack((">B", ">H", ">I")[b - 0xD9])
            return str(self.take(n), "utf-8")
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"byte 0x{b:02x} starts no msgpack value")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def ext(self, code: int, n: int):
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray_from_payload(data)
        if code == EXT_NPSCALAR:
            return _ndarray_from_payload(data)[()]
        raise ValueError(
            f"msgpack ext type {code} is not one a fold checkpoint holds "
            f"(ndarray = {EXT_NDARRAY}, numpy scalar = {EXT_NPSCALAR})")


def _dtype(name: str) -> np.dtype:
    try:
        dt = np.dtype(name)
    except TypeError:
        raise ValueError(
            f"array of dtype {name!r}: not a numpy dtype") from None
    if dt.hasobject:
        raise ValueError(f"array of dtype {name!r}: object arrays are refused")
    return dt


def _ndarray_from_payload(data: memoryview) -> np.ndarray:
    r = _Reader(data)
    triple = r.read()
    if not (isinstance(triple, list) and len(triple) == 3):
        raise ValueError("an ndarray ext holds no [shape, dtype, bytes] triple")
    shape, name, buf = triple
    if isinstance(name, memoryview):  # written without use_bin_type
        name = str(name, "utf-8")
    count = int(np.prod(shape, dtype=np.int64))
    if name == "bfloat16":  # flax's name for JAX's bfloat16: widened exactly
        bits = np.frombuffer(buf, np.uint16, count).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    dt = _dtype(name)
    return np.frombuffer(buf, dt, count).reshape(shape).copy()


def _finish(tree):
    """Chunked leaves joined (flax ``_unchunk_array_leaves_in_place``, as
    a new tree) and bin values copied out of the reader's memoryview."""
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _finish(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_finish(v) for v in tree]
    if isinstance(tree, memoryview):
        return bytes(tree)
    return tree


def unpackb(data):
    """Decode flax msgpack bytes into dicts, lists, scalars and numpy
    arrays (each array a copy that owns its memory). bfloat16 leaves come
    back as float32, exactly."""
    r = _Reader(data)
    tree = r.read()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack value")
    return _finish(tree)
