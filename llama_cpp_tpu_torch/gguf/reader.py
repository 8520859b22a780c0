"""GGUF reader: zero-copy mmap of the tensor blob + full metadata parse.

File layout parity: reference ggml/include/gguf.h:1-30 (magic, version, tensor
count, KV pairs, tensor infos, aligned data blob).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from .constants import (
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_KEY_GENERAL_ALIGNMENT,
    GGUF_MAGIC,
    GGMLType,
    GGUFValueType,
    type_size_bytes,
)

_SCALAR_FMT = {
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

_SCALAR_NP = {
    GGUFValueType.UINT8: np.uint8,
    GGUFValueType.INT8: np.int8,
    GGUFValueType.UINT16: np.uint16,
    GGUFValueType.INT16: np.int16,
    GGUFValueType.UINT32: np.uint32,
    GGUFValueType.INT32: np.int32,
    GGUFValueType.FLOAT32: np.float32,
    GGUFValueType.UINT64: np.uint64,
    GGUFValueType.INT64: np.int64,
    GGUFValueType.FLOAT64: np.float64,
}


@dataclass
class GGUFTensorInfo:
    name: str
    ne: tuple[int, ...]  # ggml dim order: ne[0] is the contiguous (row) dim
    dtype: GGMLType
    offset: int  # relative to data-section start
    data: np.ndarray | None = None  # raw bytes view (uint8), mmapped

    @property
    def shape(self) -> tuple[int, ...]:
        """numpy C-order shape (reverse of ggml ne order)."""
        return tuple(reversed(self.ne))

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.ne:
            n *= d
        return n

    @property
    def n_bytes(self) -> int:
        return type_size_bytes(self.dtype, self.n_elements)


class _Cursor:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: memoryview, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def read(self, n: int) -> memoryview:
        out = self.buf[self.pos : self.pos + n]
        if len(out) != n:
            raise EOFError("truncated GGUF file")
        self.pos += n
        return out

    def scalar(self, fmt: str):
        size = struct.calcsize(fmt)
        (val,) = struct.unpack(fmt, self.read(size))
        return val

    def string(self) -> str:
        n = self.scalar("<Q")
        if n > len(self.buf):
            raise ValueError("corrupt GGUF: string length exceeds file size")
        return bytes(self.read(n)).decode("utf-8", errors="replace")


def _read_value(cur: _Cursor, vtype: GGUFValueType) -> Any:
    if vtype == GGUFValueType.STRING:
        return cur.string()
    if vtype == GGUFValueType.BOOL:
        return bool(cur.scalar("<b"))
    if vtype == GGUFValueType.ARRAY:
        etype = GGUFValueType(cur.scalar("<i"))
        n = cur.scalar("<Q")
        if etype in _SCALAR_NP:
            np_t = _SCALAR_NP[etype]
            return np.frombuffer(cur.read(n * np.dtype(np_t).itemsize), dtype=np_t)
        return [_read_value(cur, etype) for _ in range(n)]
    if vtype in _SCALAR_FMT:
        return cur.scalar(_SCALAR_FMT[vtype])
    raise ValueError(f"unknown GGUF value type {vtype}")


@dataclass
class GGUFFile:
    path: str
    version: int
    alignment: int
    metadata: dict[str, Any]
    tensors: dict[str, GGUFTensorInfo]
    data_offset: int
    _mmaps: list[np.memmap] = field(default_factory=list)

    def get(self, key: str, default: Any = None) -> Any:
        return self.metadata.get(key, default)


def read_gguf(path: str) -> GGUFFile:
    """Read one GGUF file; tensor data are zero-copy uint8 memmap views."""
    with open(path, "rb") as f:
        head = f.read(4)
        if head != GGUF_MAGIC:
            raise ValueError(f"{path}: not a GGUF file (magic {head!r})")
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    cur = _Cursor(memoryview(mm), 4)
    version = cur.scalar("<I")
    if version not in (2, 3):
        raise ValueError(f"{path}: unsupported GGUF version {version}")
    n_tensors = cur.scalar("<q")
    n_kv = cur.scalar("<q")

    metadata: dict[str, Any] = {}
    for _ in range(n_kv):
        key = cur.string()
        vtype = GGUFValueType(cur.scalar("<i"))
        metadata[key] = _read_value(cur, vtype)

    alignment = int(metadata.get(GGUF_KEY_GENERAL_ALIGNMENT, GGUF_DEFAULT_ALIGNMENT))

    tensors: dict[str, GGUFTensorInfo] = {}
    for _ in range(n_tensors):
        name = cur.string()
        n_dims = cur.scalar("<I")
        ne = tuple(cur.scalar("<q") for _ in range(n_dims))
        dtype = GGMLType(cur.scalar("<i"))
        offset = cur.scalar("<Q")
        if offset % alignment != 0:
            raise ValueError(f"{path}: tensor {name} offset {offset} not aligned")
        tensors[name] = GGUFTensorInfo(name=name, ne=ne, dtype=dtype, offset=offset)

    data_offset = cur.pos
    if n_tensors > 0:
        data_offset = (data_offset + alignment - 1) // alignment * alignment

    for t in tensors.values():
        start = data_offset + t.offset
        t.data = mm[start : start + t.n_bytes]

    out = GGUFFile(path=path, version=version, alignment=alignment,
                   metadata=metadata, tensors=tensors, data_offset=data_offset)
    out._mmaps.append(mm)
    return out
