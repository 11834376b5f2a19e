"""The JAX package's params file, read and written without ``msgpack`` and
without ``flax``.

``fdgan_tpu/io/checkpoint.py:21-34`` writes a model's parameter tree as
``flax.serialization.msgpack_serialize({str(i): leaf})`` over the tree's
leaves in JAX's flatten order. That is a msgpack map whose keys come in
sorted string order ("0", "1", "10", …), each value an ext type 1 (an
array) or 3 (a numpy scalar) whose payload is the msgpack array (shape,
dtype name, C-order bytes). flax splits a leaf above 2³⁰ bytes into a map
of chunks; no leaf of these models comes near that, and such a leaf raises.

:func:`pack_leaves` gives the bytes flax gives for the same leaves, and
:func:`unpack_leaves` reads them back as CPU tensors; ``bfloat16`` leaves
decode through ``torch.frombuffer``, since numpy has no bf16 of its own.
:func:`packb` and :func:`unpackb` are the msgpack subset these need, with
msgpack-python's choices (the smallest integer and length formats, ``str``
as str, ``bytes`` as bin).
"""

from __future__ import annotations

import struct
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

EXT_ARRAY, EXT_SCALAR = 1, 3
CHUNKED = "__msgpack_chunked_array__"

_NUMPY_NAME = {torch.float32: "float32", torch.float64: "float64", torch.float16: "float16",
               torch.bfloat16: "bfloat16", torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
               torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool"}
_TORCH_DTYPE = {v: k for k, v in _NUMPY_NAME.items()}


class Ext:
    """A msgpack extension value: a type code and its payload."""

    def __init__(self, code: int, data: bytes):
        self.code, self.data = code, data


def _head(out: bytearray, n: int, fix: Optional[Tuple[int, int]], codes: Sequence[Tuple[int, str]]) -> None:
    """A length header: the fix format ``(base, limit)`` when n < limit, else
    the first of ``codes`` ((byte, struct format)) whose width holds n."""
    if fix is not None and n < fix[1]:
        out.append(fix[0] | n)
        return
    for code, fmt in codes:
        if n < 1 << (8 * struct.calcsize(fmt)):
            out.append(code)
            out += struct.pack(">" + fmt, n)
            return
    raise ValueError(f"length {n} too large for msgpack")


def _pack(obj: Any, out: bytearray) -> None:
    if isinstance(obj, int) and obj >= 0:  # a shape's extents
        _head(out, obj, (0x00, 128), ((0xCC, "B"), (0xCD, "H"), (0xCE, "I"), (0xCF, "Q")))
    elif isinstance(obj, str):
        data = obj.encode()
        _head(out, len(data), (0xA0, 32), ((0xD9, "B"), (0xDA, "H"), (0xDB, "I")))
        out += data
    elif isinstance(obj, (bytes, bytearray)):
        _head(out, len(obj), None, ((0xC4, "B"), (0xC5, "H"), (0xC6, "I")))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), (0x90, 16), ((0xDC, "H"), (0xDD, "I")))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _head(out, len(obj), (0x80, 16), ((0xDE, "H"), (0xDF, "I")))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, Ext):
        n = len(obj.data)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            out.append(fixext[n])
        else:
            _head(out, n, None, ((0xC7, "B"), (0xC8, "H"), (0xC9, "I")))
        out += struct.pack(">b", obj.code)
        out += obj.data
    else:
        raise TypeError(f"cannot msgpack {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """msgpack of what a params file holds: non-negative ints, str, bytes,
    lists and tuples, dicts and ``Ext``."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.num(">B")
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b < 0x90:
            return self.map(b & 0x0F)
        if b < 0xA0:
            return [self.value() for _ in range(b & 0x0F)]
        if b < 0xC0:
            return bytes(self.take(b & 0x1F)).decode()
        if b in _FIXED:
            return self.num(_FIXED[b])
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if 0xC4 <= b <= 0xC6:
            return bytes(self.take(self.num(">" + "BHI"[b - 0xC4])))
        if 0xC7 <= b <= 0xC9 or 0xD4 <= b <= 0xD8:
            n = self.num(">" + "BHI"[b - 0xC7]) if b <= 0xC9 else 1 << (b - 0xD4)
            code = self.num(">b")
            return Ext(code, bytes(self.take(n)))
        if 0xD9 <= b <= 0xDB:
            return bytes(self.take(self.num(">" + "BHI"[b - 0xD9]))).decode()
        if b in (0xDC, 0xDD):
            return [self.value() for _ in range(self.num(">" + "HI"[b - 0xDC]))]
        if b in (0xDE, 0xDF):
            return self.map(self.num(">" + "HI"[b - 0xDE]))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def unpackb(data: bytes) -> Any:
    """Any msgpack value but timestamps; an extension value as ``Ext``."""
    reader = _Reader(data)
    obj = reader.value()
    if reader.pos != len(data):
        raise ValueError(f"{len(data) - reader.pos} bytes after the msgpack value")
    return obj


def _leaf_payload(leaf) -> Ext:
    """flax's ``_msgpack_ext_pack``: a numpy scalar → ext 3, a tensor → ext
    1, each over (shape, dtype name, C-order bytes)."""
    if isinstance(leaf, np.generic):
        arr = np.asarray(leaf)
        return Ext(EXT_SCALAR, packb((arr.shape, arr.dtype.name, arr.tobytes("C"))))
    t = leaf.detach().cpu().contiguous()
    if t.dtype not in _NUMPY_NAME:
        raise TypeError(f"no params-file dtype for {t.dtype}")
    raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes("C")
    return Ext(EXT_ARRAY, packb((tuple(t.shape), _NUMPY_NAME[t.dtype], raw)))


def pack_leaves(leaves: Sequence) -> bytes:
    """The bytes of ``msgpack_serialize({str(i): leaf})`` for tensors and
    numpy scalars: flax first maps the dict through JAX's tree, which sorts
    its keys as strings."""
    return packb({k: _leaf_payload(leaves[int(k)]) for k in sorted(str(i) for i in range(len(leaves)))})


def _decode(payload: bytes) -> torch.Tensor:
    shape, name, raw = unpackb(payload)
    if name not in _TORCH_DTYPE:
        raise ValueError(f"unsupported leaf dtype {name!r}")
    dtype = _TORCH_DTYPE[name]
    if len(raw) == 0:
        return torch.empty(shape, dtype=dtype)
    if dtype == torch.bfloat16:
        return torch.frombuffer(bytearray(raw), dtype=torch.bfloat16).reshape(shape)
    return torch.from_numpy(np.frombuffer(raw, dtype=np.dtype(name)).copy()).reshape(shape)


def unpack_leaves(data: bytes, names: Optional[Sequence[str]] = None) -> List[torch.Tensor]:
    """The leaves of a params file, in order, as CPU tensors (a numpy
    scalar as a 0-d tensor). ``names`` (the leaves' JAX paths) name a leaf
    in the errors: a chunked leaf, or a value that is no array."""
    flat = unpackb(data)
    if not isinstance(flat, dict) or set(flat) != {str(i) for i in range(len(flat))}:
        raise ValueError("not a params file: expected a map {'0': leaf, '1': leaf, ...}")
    leaves = []
    for i in range(len(flat)):
        what = f"leaf {i}" + (f" ({names[i]})" if names is not None and i < len(names) else "")
        leaf = flat[str(i)]
        if isinstance(leaf, dict) and CHUNKED in leaf:
            raise ValueError(f"{what} is a chunked array (a leaf over 2^30 bytes), which the port does not read")
        if not isinstance(leaf, Ext) or leaf.code not in (EXT_ARRAY, EXT_SCALAR):
            raise ValueError(f"{what} is not an array")
        leaves.append(_decode(leaf.data))
    return leaves
