"""Bit-exact vectorized dequantization of the K-quant blocks the llama main
path stores (Q4_K, Q6_K), plus the dense F32/F16/BF16 storage types.

Semantics parity: reference ggml/src/ggml-quants.c dequantize_row_q4_K /
dequantize_row_q6_K and the block layouts of ggml/src/ggml-common.h:327-376.
Each function takes a flat uint8 array of packed blocks and the element count
and returns float32 of shape [n]. This is the load-time codec and the test
oracle; the compute path uses the planes of repack.py.
"""

from __future__ import annotations

import numpy as np

from ..gguf.constants import GGML_BLOCK_LAYOUT, GGMLType


def _f16(b: np.ndarray) -> np.ndarray:
    """View pairs of bytes as little-endian fp16, convert to fp32."""
    return np.ascontiguousarray(b).view(np.float16).astype(np.float32)


def _blocks(raw: np.ndarray, dtype: GGMLType, n: int) -> np.ndarray:
    layout = GGML_BLOCK_LAYOUT[dtype]
    if n % layout.block_size != 0:
        raise ValueError(f"{dtype.name}: n={n} not multiple of {layout.block_size}")
    nb = n // layout.block_size
    if isinstance(raw, (bytes, memoryview)):
        raw = np.frombuffer(raw, dtype=np.uint8)
    raw = raw.reshape(-1)[: nb * layout.type_size]
    return raw.reshape(nb, layout.type_size)


def _k4_scale_min(scales12: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unpack 12-byte 6-bit scales/mins into ([nb,8] sc, [nb,8] m).

    Packing per reference get_scale_min_k4 (ggml-quants.c:880)."""
    q = scales12.astype(np.int32)
    sc_lo = q[:, 0:4] & 63
    m_lo = q[:, 4:8] & 63
    sc_hi = (q[:, 8:12] & 0xF) | ((q[:, 0:4] >> 6) << 4)
    m_hi = (q[:, 8:12] >> 4) | ((q[:, 4:8] >> 6) << 4)
    return np.concatenate([sc_lo, sc_hi], axis=1), np.concatenate([m_lo, m_hi], axis=1)


def dequant_q4_K(raw, n):
    b = _blocks(raw, GGMLType.Q4_K, n)
    d = _f16(b[:, 0:2])
    dmin = _f16(b[:, 2:4])
    sc, mn = _k4_scale_min(b[:, 4:16])  # [nb,8]
    qs = b[:, 16:144].reshape(-1, 4, 32)  # 4 chunks of 32 bytes = 64 elems each
    lo = (qs & 0xF).astype(np.float32)  # sub-block 2j
    hi = (qs >> 4).astype(np.float32)  # sub-block 2j+1
    q = np.stack([lo, hi], axis=2).reshape(-1, 8, 32)  # [nb, 8 sub-blocks, 32]
    vals = d[:, :, None] * sc[:, :, None] * q - dmin[:, :, None] * mn[:, :, None]
    return vals.astype(np.float32).reshape(-1)


def dequant_q6_K(raw, n):
    b = _blocks(raw, GGMLType.Q6_K, n)
    ql = b[:, 0:128].reshape(-1, 2, 2, 32).astype(np.int32)  # [nb, half, lohalf32, l]
    qh = b[:, 128:192].reshape(-1, 2, 32).astype(np.int32)  # [nb, half, l]
    sc = b[:, 192:208].view(np.int8).reshape(-1, 2, 8).astype(np.float32)
    d = _f16(b[:, 208:210])
    # per half: q_k for k in 0..3 over 32 lanes (reference ggml-quants.c:1939)
    q1 = (ql[:, :, 0] & 0xF) | (((qh >> 0) & 3) << 4)
    q2 = (ql[:, :, 1] & 0xF) | (((qh >> 2) & 3) << 4)
    q3 = (ql[:, :, 0] >> 4) | (((qh >> 4) & 3) << 4)
    q4 = (ql[:, :, 1] >> 4) | (((qh >> 6) & 3) << 4)
    q = np.stack([q1, q2, q3, q4], axis=2) - 32  # [nb, half, 4, 32]
    # scale index within the half's 8 scales: 2*k + l//16
    scale_idx = (np.arange(4) * 2)[:, None] + (np.arange(32) // 16)[None, :]  # [4,32]
    scales = sc[:, :, scale_idx]  # [nb, 2, 4, 32]
    vals = d[:, :, None, None] * scales * q.astype(np.float32)
    return vals.astype(np.float32).reshape(-1)


_DEQUANT = {
    GGMLType.Q4_K: dequant_q4_K,
    GGMLType.Q6_K: dequant_q6_K,
}


def dequantize(raw: np.ndarray, dtype: GGMLType, n: int) -> np.ndarray:
    """Dequantize `n` elements of packed `dtype` data to float32 [n]."""
    if dtype == GGMLType.F32:
        return np.frombuffer(raw, dtype=np.float32, count=n).copy()
    if dtype == GGMLType.F16:
        return np.frombuffer(raw, dtype=np.float16, count=n).astype(np.float32)
    if dtype == GGMLType.BF16:
        u = np.frombuffer(raw, dtype=np.uint16, count=n).astype(np.uint32) << 16
        return u.view(np.float32).copy()
    fn = _DEQUANT.get(dtype)
    if fn is None:
        raise NotImplementedError(f"dequantize: {GGMLType(dtype).name}")
    return fn(raw, n)


def dequantize_tensor(raw: np.ndarray, dtype: GGMLType, shape: tuple[int, ...]) -> np.ndarray:
    """Dequantize to float32 with numpy C-order `shape` (rows are contiguous)."""
    n = int(np.prod(shape)) if shape else 1
    return dequantize(raw, dtype, n).reshape(shape)
