"""flax's msgpack checkpoint format, read and written without the
``msgpack`` or ``flax`` packages (counterpart of ``save_pytree`` /
``load_pytree``, ``lns_tpu/train/checkpoint.py:21-32``).

``flax.serialization.to_bytes`` writes a parameter tree as one msgpack map
with str keys (lists and tuples become maps keyed "0", "1", ...), numpy
arrays as ext type 1 and numpy scalars as ext type 3, both holding a
msgpack array (shape, dtype name, C-order bytes). ``unpackb`` reads maps,
arrays, str, bin, int, float, bool, nil and those two ext types: ndarrays
come back as numpy arrays, ``bfloat16`` ones (which numpy lacks) as
``torch.bfloat16`` tensors read from the raw bytes; any other ext type
raises. ``packb`` writes such a tree (numpy arrays and scalars, tensors of
any dtype) with the encodings msgpack-python picks, so a tree of dicts and
arrays gives flax's bytes.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

EXT_NDARRAY, EXT_NPSCALAR = 1, 3

_TORCH_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float16: "float16",
                      torch.float32: "float32", torch.float64: "float64", torch.int8: "int8",
                      torch.int16: "int16", torch.int32: "int32", torch.int64: "int64",
                      torch.uint8: "uint8", torch.bool: "bool"}


# -- reading --------------------------------------------------------------------

def unpackb(data: bytes) -> Any:
    """The object that msgpack bytes `data` encode (flax's ext types read
    as arrays)."""
    buf = memoryview(data)
    obj, pos = _unpack(buf, 0)
    if pos != len(buf):
        raise ValueError(f"msgpack: {len(buf) - pos} bytes after the object")
    return obj


def _take(buf: memoryview, pos: int, n: int) -> Tuple[memoryview, int]:
    if pos + n > len(buf):
        raise ValueError("msgpack: the data ends inside an object")
    return buf[pos: pos + n], pos + n


def _unpack(buf: memoryview, pos: int) -> Tuple[Any, int]:
    b, pos = buf[pos], pos + 1
    if b <= 0x7F:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8F:
        return _map(buf, pos, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _array(buf, pos, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        raw, pos = _take(buf, pos, b & 0x1F)
        return str(raw, "utf-8"), pos
    if b == 0xC0:
        return None, pos
    if b in (0xC2, 0xC3):
        return b == 0xC3, pos
    fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
             0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in fixed:
        fmt = fixed[b]
        raw, pos = _take(buf, pos, struct.calcsize(fmt))
        return struct.unpack(fmt, raw)[0], pos
    sized = {0xC4: (1, "bin"), 0xC5: (2, "bin"), 0xC6: (4, "bin"), 0xD9: (1, "str"),
             0xDA: (2, "str"), 0xDB: (4, "str"), 0xDC: (2, "array"), 0xDD: (4, "array"),
             0xDE: (2, "map"), 0xDF: (4, "map"), 0xC7: (1, "ext"), 0xC8: (2, "ext"),
             0xC9: (4, "ext")}
    if b in sized:
        width, kind = sized[b]
        raw, pos = _take(buf, pos, width)
        n = int.from_bytes(raw, "big")
        if kind == "array":
            return _array(buf, pos, n)
        if kind == "map":
            return _map(buf, pos, n)
        if kind == "ext":
            return _ext(buf, pos, n)
        raw, pos = _take(buf, pos, n)
        return (bytes(raw) if kind == "bin" else str(raw, "utf-8")), pos
    if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
        return _ext(buf, pos, 1 << (b - 0xD4))
    raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")


def _array(buf, pos, n):
    out = []
    for _ in range(n):
        v, pos = _unpack(buf, pos)
        out.append(v)
    return out, pos


def _map(buf, pos, n):
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        out[k], pos = _unpack(buf, pos)
    return out, pos


def _ext(buf, pos, n):
    code, pos = struct.unpack(">b", buf[pos: pos + 1])[0], pos + 1
    data, pos = _take(buf, pos, n)
    if code not in (EXT_NDARRAY, EXT_NPSCALAR):
        raise ValueError(f"msgpack: ext type {code} is not one that flax writes for arrays "
                         f"(ndarray {EXT_NDARRAY}, numpy scalar {EXT_NPSCALAR})")
    shape, name, raw = unpackb(bytes(data))
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        arr = torch.from_numpy(np.frombuffer(raw, np.int16).copy()).view(torch.bfloat16)
    else:
        arr = np.frombuffer(raw, np.dtype(name)).copy()
    arr = arr.reshape(tuple(shape))
    return (arr[()] if code == EXT_NPSCALAR else arr), pos


# -- writing ----------------------------------------------------------------------

def packb(obj: Any) -> bytes:
    """msgpack bytes of `obj`: dicts (str keys), lists and tuples, str,
    bytes, int, float, bool and None, numpy arrays (ext 1) and scalars
    (ext 3), and tensors of any dtype (ext 1; bf16 by its raw bytes)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _head(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    """A length header: the fix form below `fix_max`, else the first of
    (code, width) that holds `n`."""
    if n <= fix_max:
        out.append(fix | n)
        return
    for code, width in codes:
        if n < 1 << (8 * width):
            out.append(code)
            out += n.to_bytes(width, "big")
            return
    raise ValueError(f"msgpack: length {n} is too large")


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80 or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
        return
    for lo, hi, code, fmt in ((0, 0xFF, 0xCC, ">B"), (-0x80, -1, 0xD0, ">b"),
                              (0, 0xFFFF, 0xCD, ">H"), (-0x8000, -1, 0xD1, ">h"),
                              (0, 0xFFFFFFFF, 0xCE, ">I"), (-0x80000000, -1, 0xD2, ">i"),
                              (0, 0xFFFFFFFFFFFFFFFF, 0xCF, ">Q"),
                              (-0x8000000000000000, -1, 0xD3, ">q")):
        if lo <= v <= hi:
            out.append(code)
            out += struct.pack(fmt, v)
            return
    raise ValueError(f"msgpack: integer {v} does not fit in 64 bits")


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _head(out, n, 0, -1, ((0xC7, 1), (0xC8, 2), (0xC9, 4)))
    out += struct.pack(">b", code)
    out += data


def _array_bytes(shape, name: str, raw: bytes) -> bytes:
    return packb([list(shape), name, raw])


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif type(obj) is int:
        _pack_int(obj, out)
    elif type(obj) is float:
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif type(obj) is str:
        raw = obj.encode("utf-8")
        _head(out, len(raw), 0xA0, 31, ((0xD9, 1), (0xDA, 2), (0xDB, 4)))
        out += raw
    elif type(obj) is bytes:
        _head(out, len(obj), 0, -1, ((0xC4, 1), (0xC5, 2), (0xC6, 4)))
        out += obj
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 15, ((0xDE, 2), (0xDF, 4)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 15, ((0xDC, 2), (0xDD, 4)))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        if obj.dtype.hasobject or obj.dtype.isalignedstruct:
            raise ValueError("msgpack: object and structured arrays are not written")
        _pack_ext(EXT_NDARRAY, _array_bytes(obj.shape, obj.dtype.name, obj.tobytes("C")), out)
    elif isinstance(obj, np.generic):
        a = np.asarray(obj)
        _pack_ext(EXT_NPSCALAR, _array_bytes(a.shape, a.dtype.name, a.tobytes("C")), out)
    elif isinstance(obj, torch.Tensor):
        t = obj.detach().cpu().contiguous()
        if t.dtype not in _TORCH_DTYPE_NAMES:
            raise ValueError(f"msgpack: tensors of {t.dtype} are not written")
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes("C")
        _pack_ext(EXT_NDARRAY, _array_bytes(tuple(t.shape), _TORCH_DTYPE_NAMES[t.dtype], raw),
                  out)
    else:
        raise TypeError(f"msgpack: cannot write a {type(obj).__name__}")
