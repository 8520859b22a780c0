"""GGUF writer (v3), inverse of reader.py; the test fixtures use it.

Format parity: reference ggml/include/gguf.h:1-30 and ggml/src/gguf.cpp writer.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np

from .constants import (
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_KEY_GENERAL_ALIGNMENT,
    GGUF_MAGIC,
    GGUF_VERSION,
    GGMLType,
    GGUFValueType,
    type_size_bytes,
)

_NP_TO_VT = {
    np.dtype(np.uint8): GGUFValueType.UINT8,
    np.dtype(np.int8): GGUFValueType.INT8,
    np.dtype(np.uint16): GGUFValueType.UINT16,
    np.dtype(np.int16): GGUFValueType.INT16,
    np.dtype(np.uint32): GGUFValueType.UINT32,
    np.dtype(np.int32): GGUFValueType.INT32,
    np.dtype(np.float32): GGUFValueType.FLOAT32,
    np.dtype(np.uint64): GGUFValueType.UINT64,
    np.dtype(np.int64): GGUFValueType.INT64,
    np.dtype(np.float64): GGUFValueType.FLOAT64,
}

_VT_FMT = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}


def _pack_string(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack("<Q", len(b)) + b


def _infer_vtype(value: Any) -> GGUFValueType:
    if isinstance(value, (bool, np.bool_)):
        return GGUFValueType.BOOL
    if isinstance(value, str):
        return GGUFValueType.STRING
    if isinstance(value, int):
        if 0 <= value < 2**32:
            return GGUFValueType.UINT32
        return GGUFValueType.INT64 if value < 0 else GGUFValueType.UINT64
    if isinstance(value, float):
        return GGUFValueType.FLOAT32
    if isinstance(value, np.generic):
        return _NP_TO_VT[value.dtype]
    if isinstance(value, (np.ndarray, list, tuple)):
        return GGUFValueType.ARRAY
    raise TypeError(f"cannot store {type(value)} in GGUF metadata")


def _pack_value(value: Any, vtype: GGUFValueType) -> bytes:
    if vtype == GGUFValueType.STRING:
        return _pack_string(value)
    if vtype == GGUFValueType.BOOL:
        return struct.pack("<b", 1 if value else 0)
    if vtype == GGUFValueType.ARRAY:
        if isinstance(value, np.ndarray):
            etype = _NP_TO_VT[value.dtype]
            return (struct.pack("<iQ", int(etype), value.size)
                    + np.ascontiguousarray(value).tobytes())
        if len(value) == 0:
            return struct.pack("<iQ", int(GGUFValueType.INT32), 0)
        etype = _infer_vtype(value[0])
        out = [struct.pack("<iQ", int(etype), len(value))]
        out.extend(_pack_value(v, etype) for v in value)
        return b"".join(out)
    return struct.pack(_VT_FMT[vtype], value)


@dataclass
class _PendingTensor:
    name: str
    ne: tuple[int, ...]
    dtype: GGMLType
    data: bytes | np.ndarray


class GGUFWriter:
    """Add metadata + tensors, then `write(path)`."""

    def __init__(self, alignment: int = GGUF_DEFAULT_ALIGNMENT):
        self.alignment = alignment
        self._kv: dict[str, tuple[Any, GGUFValueType]] = {}
        self._tensors: list[_PendingTensor] = []

    def add(self, key: str, value: Any, vtype: GGUFValueType | None = None):
        self._kv[key] = (value, vtype if vtype is not None else _infer_vtype(value))
        return self

    def add_all(self, kv: dict[str, Any]):
        for k, v in kv.items():
            self.add(k, v)
        return self

    def add_tensor(self, name: str, data: bytes | np.ndarray,
                   ne: Sequence[int], dtype: GGMLType):
        """`ne` is in ggml order (ne[0] = contiguous row dim); quantized
        tensors pass raw packed bytes."""
        n_elements = int(np.prod(ne)) if len(ne) else 1
        expect = type_size_bytes(dtype, n_elements)
        nbytes = data.nbytes if isinstance(data, np.ndarray) else len(data)
        if nbytes != expect:
            raise ValueError(f"tensor {name}: got {nbytes} bytes, expected "
                             f"{expect} for {dtype.name} x {n_elements}")
        if len(name.encode()) >= 64:
            raise ValueError(f"tensor name too long (>=64 bytes): {name}")
        self._tensors.append(_PendingTensor(name, tuple(ne), dtype, data))
        return self

    def write(self, path: str):
        if (GGUF_KEY_GENERAL_ALIGNMENT not in self._kv
                and self.alignment != GGUF_DEFAULT_ALIGNMENT):
            self.add(GGUF_KEY_GENERAL_ALIGNMENT, np.uint32(self.alignment))
        align = self.alignment
        header = [GGUF_MAGIC, struct.pack("<I", GGUF_VERSION),
                  struct.pack("<qq", len(self._tensors), len(self._kv))]
        for key, (value, vtype) in self._kv.items():
            header.append(_pack_string(key))
            header.append(struct.pack("<i", int(vtype)))
            header.append(_pack_value(value, vtype))

        offset = 0
        offsets = []
        for t in self._tensors:
            offsets.append(offset)
            size = t.data.nbytes if isinstance(t.data, np.ndarray) else len(t.data)
            offset += (size + align - 1) // align * align
        for t, off in zip(self._tensors, offsets):
            header.append(_pack_string(t.name))
            header.append(struct.pack("<I", len(t.ne)))
            header.append(struct.pack(f"<{len(t.ne)}q", *t.ne))
            header.append(struct.pack("<iQ", int(t.dtype), off))

        head = b"".join(header)
        data_start = (len(head) + align - 1) // align * align
        with open(path, "wb") as f:
            f.write(head)
            f.write(b"\x00" * (data_start - len(head)))
            pos = 0
            for t, off in zip(self._tensors, offsets):
                if pos < off:
                    f.write(b"\x00" * (off - pos))
                    pos = off
                raw = (np.ascontiguousarray(t.data).tobytes()
                       if isinstance(t.data, np.ndarray) else t.data)
                f.write(raw)
                pos += len(raw)
