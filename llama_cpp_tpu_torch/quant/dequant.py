"""Bit-exact vectorized dequantization of every ggml storage type the JAX
package reads: the legacy 32-element quants, the K-quants, the IQ codebook
formats, the ternary and FP4 formats, and the dense float and integer types.

Semantics parity: reference ggml/src/ggml-quants.c dequantize_row_* and the
block layouts of ggml/src/ggml-common.h:178-460. Each function takes a flat
uint8 array of packed blocks and the element count and returns float32 of
shape [n], as vectorized numpy over a [n_blocks, type_size] byte matrix; the
results equal the JAX package's llama_cpp_tpu/quant/dequant.py bit for bit.
This is the load-time codec and the test oracle; the compute path uses the
planes of repack.py. The IQ codebooks are this package's own copy
(iq_grids.npz).
"""

from __future__ import annotations

import importlib.resources

import numpy as np

from ..gguf.constants import GGML_BLOCK_LAYOUT, QK_K, GGMLType

# ---------------------------------------------------------------------------
# LUTs (codebook grids of the IQ formats, reference ggml-common.h)
# ---------------------------------------------------------------------------

with importlib.resources.files(__package__).joinpath("iq_grids.npz").open("rb") as _f:
    _G = dict(np.load(_f))

KMASK_IQ2XS = _G["kmask_iq2xs"]  # [8] bit masks
KSIGNS_IQ2XS = _G["ksigns_iq2xs"]  # [128] sign bytes
IQ2XXS_GRID = _G["iq2xxs_grid"].view(np.uint8).reshape(256, 8)
IQ2XS_GRID = _G["iq2xs_grid"].view(np.uint8).reshape(512, 8)
IQ2S_GRID = _G["iq2s_grid"].view(np.uint8).reshape(1024, 8)
IQ3XXS_GRID = _G["iq3xxs_grid"].view(np.uint8).reshape(256, 4)
IQ3S_GRID = _G["iq3s_grid"].view(np.uint8).reshape(512, 4)
IQ1S_GRID = _G["iq1s_grid"].view(np.int8).reshape(2048, 8)
KVALUES_IQ4NL = _G["kvalues_iq4nl"]  # [16] int8
KVALUES_FP4 = _G["kvalues_fp4"]  # [16] int8 (E2M1 doubled)

IQ1S_DELTA = 0.125
# sign bits expanded: SIGNS_EXPANDED[s, j] = -1.0 if bit j of ksigns[s] else 1.0
_SIGNS_EXPANDED = np.where(
    (KSIGNS_IQ2XS[:, None] & KMASK_IQ2XS[None, :]) != 0, -1.0, 1.0
).astype(np.float32)


def _f16(b: np.ndarray) -> np.ndarray:
    """View pairs of bytes as little-endian fp16, convert to fp32."""
    return np.ascontiguousarray(b).view(np.float16).astype(np.float32)


def _e8m0_half(e: np.ndarray) -> np.ndarray:
    """E8M0 exponent byte -> 2^(e-127) * 0.5 (reference ggml-impl.h:498)."""
    e = e.astype(np.int64)
    bits = np.where(e < 2, 0x00200000 << e, (np.maximum(e - 1, 0)) << 23).astype(
        np.uint32
    )
    return bits.view(np.float32)


def _ue4m3(x: np.ndarray) -> np.ndarray:
    """UE4M3 byte -> fp32 * 0.5 (reference ggml-impl.h:502)."""
    x = x.astype(np.int32)
    exp = (x >> 3) & 0xF
    man = (x & 0x7).astype(np.float32)
    raw = np.where(
        exp == 0,
        man * 2.0**-9,
        (1.0 + man / 8.0) * np.exp2((exp - 7).astype(np.float32)),
    )
    raw = np.where((x == 0) | (x == 0x7F), 0.0, raw * 0.5)
    return raw.astype(np.float32)


def _blocks(raw: np.ndarray, dtype: GGMLType, n: int) -> np.ndarray:
    layout = GGML_BLOCK_LAYOUT[dtype]
    if n % layout.block_size != 0:
        raise ValueError(f"{dtype.name}: n={n} not multiple of {layout.block_size}")
    nb = n // layout.block_size
    raw = np.frombuffer(raw, dtype=np.uint8) if isinstance(raw, (bytes, memoryview)) else raw
    raw = raw.reshape(-1)[: nb * layout.type_size]
    return raw.reshape(nb, layout.type_size)


def _nibbles(qs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    return (qs & 0x0F).astype(np.int32), (qs >> 4).astype(np.int32)


# ---------------------------------------------------------------------------
# simple 32-element blocks
# ---------------------------------------------------------------------------


def dequant_q4_0(raw, n):
    b = _blocks(raw, GGMLType.Q4_0, n)
    d = _f16(b[:, 0:2])  # [nb,1]
    lo, hi = _nibbles(b[:, 2:18])
    q = np.concatenate([lo, hi], axis=1) - 8
    return (q * d).astype(np.float32).reshape(-1)


def dequant_q4_1(raw, n):
    b = _blocks(raw, GGMLType.Q4_1, n)
    d = _f16(b[:, 0:2])
    m = _f16(b[:, 2:4])
    lo, hi = _nibbles(b[:, 4:20])
    q = np.concatenate([lo, hi], axis=1)
    return (q * d + m).astype(np.float32).reshape(-1)


def _q5_high_bits(qh_bytes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """qh as uint32 -> the 0x10 bits for elements [0..16) and [16..32)."""
    qh = np.ascontiguousarray(qh_bytes).view(np.uint32).astype(np.uint64)  # [nb,1]
    j = np.arange(16, dtype=np.uint64)
    xh0 = ((qh >> j) << np.uint64(4)) & np.uint64(0x10)
    xh1 = (qh >> (j + np.uint64(12))) & np.uint64(0x10)
    return xh0.astype(np.int32), xh1.astype(np.int32)


def dequant_q5_0(raw, n):
    b = _blocks(raw, GGMLType.Q5_0, n)
    d = _f16(b[:, 0:2])
    xh0, xh1 = _q5_high_bits(b[:, 2:6])
    lo, hi = _nibbles(b[:, 6:22])
    q = np.concatenate([lo | xh0, hi | xh1], axis=1) - 16
    return (q * d).astype(np.float32).reshape(-1)


def dequant_q5_1(raw, n):
    b = _blocks(raw, GGMLType.Q5_1, n)
    d = _f16(b[:, 0:2])
    m = _f16(b[:, 2:4])
    xh0, xh1 = _q5_high_bits(b[:, 4:8])
    lo, hi = _nibbles(b[:, 8:24])
    q = np.concatenate([lo | xh0, hi | xh1], axis=1)
    return (q * d + m).astype(np.float32).reshape(-1)


def dequant_q8_0(raw, n):
    b = _blocks(raw, GGMLType.Q8_0, n)
    d = _f16(b[:, 0:2])
    q = b[:, 2:34].view(np.int8).astype(np.int32)
    return (q * d).astype(np.float32).reshape(-1)


def dequant_q8_1(raw, n):
    b = _blocks(raw, GGMLType.Q8_1, n)
    d = _f16(b[:, 0:2])
    q = b[:, 4:36].view(np.int8).astype(np.int32)
    return (q * d).astype(np.float32).reshape(-1)


def dequant_mxfp4(raw, n):
    b = _blocks(raw, GGMLType.MXFP4, n)
    d = _e8m0_half(b[:, 0:1])
    lo, hi = _nibbles(b[:, 1:17])
    q = KVALUES_FP4[np.concatenate([lo, hi], axis=1)].astype(np.float32)
    return (q * d).astype(np.float32).reshape(-1)


def dequant_nvfp4(raw, n):
    b = _blocks(raw, GGMLType.NVFP4, n)
    d = _ue4m3(b[:, 0:4])  # [nb,4] per-16 sub-block scales
    lo, hi = _nibbles(b[:, 4:36])  # [nb,32] each
    lo = lo.reshape(-1, 4, 8)
    hi = hi.reshape(-1, 4, 8)
    q = np.concatenate([lo, hi], axis=2)  # [nb,4,16] per sub-block
    vals = KVALUES_FP4[q].astype(np.float32) * d[:, :, None]
    return vals.astype(np.float32).reshape(-1)


def dequant_iq4_nl(raw, n):
    b = _blocks(raw, GGMLType.IQ4_NL, n)
    d = _f16(b[:, 0:2])
    lo, hi = _nibbles(b[:, 2:18])
    q = KVALUES_IQ4NL[np.concatenate([lo, hi], axis=1)].astype(np.float32)
    return (q * d).astype(np.float32).reshape(-1)


def dequant_q1_0(raw, n):
    b = _blocks(raw, GGMLType.Q1_0, n)
    d = _f16(b[:, 0:2])
    bits = np.unpackbits(b[:, 2:18], axis=1, bitorder="little").astype(np.float32)
    return ((bits * 2.0 - 1.0) * d).astype(np.float32).reshape(-1)


def dequant_q2_0(raw, n):
    b = _blocks(raw, GGMLType.Q2_0, n)
    d = _f16(b[:, 0:2])
    qs = b[:, 2:18].astype(np.int32)  # [nb,16] bytes, 4 elems each
    shifts = np.arange(4) * 2
    q = ((qs[:, :, None] >> shifts[None, None, :]) & 3) - 1  # [nb,16,4]
    return (q.reshape(len(b), 64) * d).astype(np.float32).reshape(-1)


# ---------------------------------------------------------------------------
# K-quants (256-element superblocks)
# ---------------------------------------------------------------------------


def _k4_scale_min(scales12: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unpack 12-byte 6-bit scales/mins into ([nb,8] sc, [nb,8] m).

    Packing per reference get_scale_min_k4 (ggml-quants.c:880).
    """
    q = scales12.astype(np.int32)
    sc_lo = q[:, 0:4] & 63
    m_lo = q[:, 4:8] & 63
    sc_hi = (q[:, 8:12] & 0xF) | ((q[:, 0:4] >> 6) << 4)
    m_hi = (q[:, 8:12] >> 4) | ((q[:, 4:8] >> 6) << 4)
    sc = np.concatenate([sc_lo, sc_hi], axis=1)
    m = np.concatenate([m_lo, m_hi], axis=1)
    return sc, m


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


def dequant_q5_K(raw, n):
    b = _blocks(raw, GGMLType.Q5_K, n)
    d = _f16(b[:, 0:2])
    dmin = _f16(b[:, 2:4])
    sc, mn = _k4_scale_min(b[:, 4:16])
    qh = b[:, 16:48].astype(np.int32)  # [nb,32]
    qs = b[:, 48:176].reshape(-1, 4, 32)
    lo = (qs & 0xF).astype(np.int32)
    hi = (qs >> 4).astype(np.int32)
    jj = np.arange(4)
    u1 = (1 << (2 * jj)).astype(np.int32)  # bit for even sub-block of chunk j
    u2 = (2 << (2 * jj)).astype(np.int32)
    hbit_lo = ((qh[:, None, :] & u1[None, :, None]) != 0).astype(np.int32) * 16
    hbit_hi = ((qh[:, None, :] & u2[None, :, None]) != 0).astype(np.int32) * 16
    q = np.stack([lo + hbit_lo, hi + hbit_hi], axis=2).reshape(-1, 8, 32).astype(np.float32)
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


def dequant_q8_K(raw, n):
    b = _blocks(raw, GGMLType.Q8_K, n)
    d = b[:, 0:4].view(np.float32)
    q = b[:, 4 : 4 + QK_K].view(np.int8).astype(np.float32)
    return (q * d).astype(np.float32).reshape(-1)


def dequant_q2_K(raw, n):
    b = _blocks(raw, GGMLType.Q2_K, n)
    scales = b[:, 0:16].astype(np.int32)  # [nb,16]
    qs = b[:, 16:80].reshape(-1, 2, 32).astype(np.int32)  # [nb, half, byte]
    d = _f16(b[:, 80:82])
    dmin = _f16(b[:, 82:84])
    shifts = (np.arange(4) * 2).astype(np.int32)
    # q[nb, half, j(shift), byte] -> elements (half*128 + j*32 + byte%16 ... )
    q = (qs[:, :, None, :] >> shifts[None, None, :, None]) & 3  # [nb,2,4,32]
    q = q.reshape(-1, 2, 4, 2, 16)  # split 32 bytes into two groups of 16
    sc = scales.reshape(-1, 2, 4, 2)  # is index order matches (half, j, group)
    dl = d[:, :, None, None] * (sc & 0xF).reshape(-1, 2, 4, 2)
    ml = dmin[:, :, None, None] * (sc >> 4).reshape(-1, 2, 4, 2)
    vals = dl[..., None] * q.astype(np.float32) - ml[..., None]
    return vals.astype(np.float32).reshape(-1)


def _q3_scales(scales12: np.ndarray) -> np.ndarray:
    """12-byte packed 6-bit scales -> [nb,16] int (already minus nothing).

    Bit packing per reference dequantize_row_q3_K (ggml-quants.c:1305).
    """
    a = np.ascontiguousarray(scales12).view(np.uint32).astype(np.uint64)  # [nb,3]
    kmask1, kmask2 = 0x03030303, 0x0F0F0F0F
    tmp = a[:, 2]
    out = np.empty((len(a), 4), dtype=np.uint32)
    out[:, 0] = (a[:, 0] & kmask2) | (((tmp >> 0) & kmask1) << 4)
    out[:, 1] = (a[:, 1] & kmask2) | (((tmp >> 2) & kmask1) << 4)
    out[:, 2] = ((a[:, 0] >> 4) & kmask2) | (((tmp >> 4) & kmask1) << 4)
    out[:, 3] = ((a[:, 1] >> 4) & kmask2) | (((tmp >> 6) & kmask1) << 4)
    return out.view(np.int8).astype(np.int32)  # [nb,16]


def dequant_q3_K(raw, n):
    b = _blocks(raw, GGMLType.Q3_K, n)
    hmask = b[:, 0:32].astype(np.int32)  # [nb,32]
    qs = b[:, 32:96].reshape(-1, 2, 32).astype(np.int32)
    scales = _q3_scales(b[:, 96:108]).astype(np.float32)  # [nb,16]
    d = _f16(b[:, 108:110])
    shifts = (np.arange(4) * 2).astype(np.int32)
    low = (qs[:, :, None, :] >> shifts[None, None, :, None]) & 3  # [nb,2,4,32]
    # hmask bit m = 1 << (half*4 + j), per byte l in 0..31
    mbit = (np.arange(8).reshape(2, 4))[None, :, :, None]
    high = (hmask[:, None, None, :] >> mbit) & 1
    q = low - np.where(high != 0, 0, 4)
    q = q.reshape(-1, 2, 4, 2, 16).astype(np.float32)
    sc = scales.reshape(-1, 2, 4, 2) - 32.0
    vals = d[:, :, None, None, None] * sc[..., None] * q
    return vals.astype(np.float32).reshape(-1)


def dequant_iq4_xs(raw, n):
    b = _blocks(raw, GGMLType.IQ4_XS, n)
    d = _f16(b[:, 0:2])
    scales_h = np.ascontiguousarray(b[:, 2:4]).view(np.uint16).astype(np.int32)  # [nb,1]
    scales_l = b[:, 4:8].astype(np.int32)  # [nb,4] two 4-bit each
    qs = b[:, 8:136].reshape(-1, 8, 16)  # [nb, ib32, 16 bytes]
    ib = np.arange(8)
    ls_l = (scales_l[:, ib // 2] >> (4 * (ib % 2))[None, :]) & 0xF
    ls_h = (scales_h >> (2 * ib)[None, :]) & 3
    ls = (ls_l | (ls_h << 4)) - 32  # [nb,8]
    lo = KVALUES_IQ4NL[qs & 0xF].astype(np.float32)
    hi = KVALUES_IQ4NL[qs >> 4].astype(np.float32)
    q = np.concatenate([lo, hi], axis=2)  # [nb,8,32]
    vals = d[:, :, None] * ls[:, :, None].astype(np.float32) * q
    return vals.astype(np.float32).reshape(-1)


# ---------------------------------------------------------------------------
# ternary
# ---------------------------------------------------------------------------


def dequant_tq1_0(raw, n):
    b = _blocks(raw, GGMLType.TQ1_0, n)
    nb = len(b)
    qs = b[:, 0:48].astype(np.uint16)
    qh = b[:, 48:52].astype(np.uint16)
    d = _f16(b[:, 52:54])
    pow3 = np.array([1, 3, 9, 27, 81], dtype=np.uint16)
    out = np.empty((nb, QK_K), dtype=np.float32)
    # bytes 0..31: 5 elems each, stride-32 layout
    q = ((qs[:, None, 0:32] * pow3[None, :, None]) & 0xFF) * 3 >> 8  # [nb,5,32]
    out[:, 0:160] = (q.astype(np.int32) - 1).reshape(nb, 160)
    # bytes 32..47: 5 elems each, stride-16
    q = ((qs[:, None, 32:48] * pow3[None, :, None]) & 0xFF) * 3 >> 8  # [nb,5,16]
    out[:, 160:240] = (q.astype(np.int32) - 1).reshape(nb, 80)
    # qh: 4 elems each, stride-4
    q = ((qh[:, None, :] * pow3[None, :4, None]) & 0xFF) * 3 >> 8  # [nb,4,4]
    out[:, 240:256] = (q.astype(np.int32) - 1).reshape(nb, 16)
    return (out * d).astype(np.float32).reshape(-1)


def dequant_tq2_0(raw, n):
    b = _blocks(raw, GGMLType.TQ2_0, n)
    nb = len(b)
    qs = b[:, 0:64].reshape(nb, 2, 32).astype(np.int32)
    d = _f16(b[:, 64:66])
    shifts = (np.arange(4) * 2).astype(np.int32)
    q = ((qs[:, :, None, :] >> shifts[None, None, :, None]) & 3) - 1  # [nb,2,4,32]
    return (q.reshape(nb, QK_K).astype(np.float32) * d).astype(np.float32).reshape(-1)


# ---------------------------------------------------------------------------
# IQ codebook formats
# ---------------------------------------------------------------------------


def dequant_iq2_xxs(raw, n):
    b = _blocks(raw, GGMLType.IQ2_XXS, n)
    d = _f16(b[:, 0:2])  # [nb,1]
    data = np.ascontiguousarray(b[:, 2:66]).view(np.uint32).reshape(-1, 8, 2)
    aux0 = data[:, :, 0]  # 4 grid-index bytes
    aux1 = data[:, :, 1].astype(np.uint64)  # signs + scale
    db = d * ((0.5 + (aux1 >> 28).astype(np.float32)) * 0.25)  # [nb,8]
    idx = aux0[:, :, None] >> (np.arange(4, dtype=np.uint32) * 8)[None, None, :] & 0xFF
    grid = IQ2XXS_GRID[idx].astype(np.float32)  # [nb,8,4,8]
    sidx = (aux1[:, :, None] >> (7 * np.arange(4, dtype=np.uint64))[None, None, :]) & 127
    signs = _SIGNS_EXPANDED[sidx.astype(np.int32)]  # [nb,8,4,8]
    vals = db[:, :, None, None] * grid * signs
    return vals.astype(np.float32).reshape(-1)


def dequant_iq2_xs(raw, n):
    b = _blocks(raw, GGMLType.IQ2_XS, n)
    d = _f16(b[:, 0:2])
    qs = np.ascontiguousarray(b[:, 2:66]).view(np.uint16).reshape(-1, 8, 4)
    scales = b[:, 66:74].astype(np.int32)  # [nb,8]
    db = np.stack(
        [(scales & 0xF).astype(np.float32), (scales >> 4).astype(np.float32)], axis=2
    )  # [nb,8,2]
    db = d[:, :, None] * (0.5 + db) * 0.25
    grid = IQ2XS_GRID[(qs & 511).astype(np.int32)].astype(np.float32)  # [nb,8,4,8]
    signs = _SIGNS_EXPANDED[(qs >> 9).astype(np.int32)]
    lscale = db[:, :, (np.arange(4) // 2)]  # [nb,8,4]
    vals = lscale[:, :, :, None] * grid * signs
    return vals.astype(np.float32).reshape(-1)


def dequant_iq2_s(raw, n):
    b = _blocks(raw, GGMLType.IQ2_S, n)
    d = _f16(b[:, 0:2])
    qs = b[:, 2:34].reshape(-1, 8, 4).astype(np.int32)
    signs_b = b[:, 34:66].reshape(-1, 8, 4).astype(np.int32)
    qh = b[:, 66:74].astype(np.int32)  # [nb,8]
    scales = b[:, 74:82].astype(np.int32)
    db = np.stack(
        [(scales & 0xF).astype(np.float32), (scales >> 4).astype(np.float32)], axis=2
    )
    db = d[:, :, None] * (0.5 + db) * 0.25  # [nb,8,2]
    shift = (8 - 2 * np.arange(4))[None, None, :]
    idx = qs | ((qh[:, :, None] << shift) & 0x300)
    grid = IQ2S_GRID[idx].astype(np.float32)  # [nb,8,4,8]
    # full 8-bit sign byte per group of 8 elements
    signs = np.where(
        (signs_b[:, :, :, None] & KMASK_IQ2XS[None, None, None, :]) != 0, -1.0, 1.0
    ).astype(np.float32)
    lscale = db[:, :, (np.arange(4) // 2)]
    vals = lscale[:, :, :, None] * grid * signs
    return vals.astype(np.float32).reshape(-1)


def dequant_iq3_xxs(raw, n):
    b = _blocks(raw, GGMLType.IQ3_XXS, n)
    d = _f16(b[:, 0:2])
    qs = b[:, 2:66].reshape(-1, 8, 8).astype(np.int32)  # 8 grid bytes per ib32
    aux = np.ascontiguousarray(b[:, 66:98]).view(np.uint32).reshape(-1, 8)  # [nb,8]
    db = d * ((0.5 + (aux >> 28).astype(np.float32)) * 0.5)  # [nb,8]
    grid = IQ3XXS_GRID[qs].astype(np.float32)  # [nb,8,8,4] (pairs of 4)
    shifts = (7 * np.arange(4, dtype=np.uint64))[None, None, :]
    sidx = (aux[:, :, None].astype(np.uint64) >> shifts) & 127
    signs = _SIGNS_EXPANDED[sidx.astype(np.int32)]  # [nb,8,4,8]
    grid = grid.reshape(-1, 8, 4, 8)  # two grid-rows of 4 -> 8 elems
    vals = db[:, :, None, None] * grid * signs
    return vals.astype(np.float32).reshape(-1)


def dequant_iq3_s(raw, n):
    b = _blocks(raw, GGMLType.IQ3_S, n)
    d = _f16(b[:, 0:2])
    qs = b[:, 2:66].reshape(-1, 8, 8).astype(np.int32)
    qh = b[:, 66:74].astype(np.int32)  # [nb,8] one byte per ib32
    signs_b = b[:, 74:106].reshape(-1, 8, 4).astype(np.int32)
    scales = b[:, 106:110].astype(np.int32)  # [nb,4]
    ib = np.arange(8)
    ls = (scales[:, ib // 2] >> (4 * (ib % 2))[None, :]) & 0xF
    db = d * (1 + 2 * ls).astype(np.float32)  # [nb,8]
    # grid idx: qs[2l+s] | (qh << (8-2l-s) & 256) for pair elements
    k = np.arange(8)  # byte index within ib32
    shift = 8 - k
    idx = qs | ((qh[:, :, None] << shift[None, None, :]) & 256)
    grid = IQ3S_GRID[idx].astype(np.float32).reshape(-1, 8, 4, 8)
    signs = np.where(
        (signs_b[:, :, :, None] & KMASK_IQ2XS[None, None, None, :]) != 0, -1.0, 1.0
    ).astype(np.float32)
    vals = db[:, :, None, None] * grid * signs
    return vals.astype(np.float32).reshape(-1)


def dequant_iq1_s(raw, n):
    b = _blocks(raw, GGMLType.IQ1_S, n)
    d = _f16(b[:, 0:2])
    qs = b[:, 2:34].reshape(-1, 8, 4).astype(np.int32)
    qh = np.ascontiguousarray(b[:, 34:50]).view(np.uint16).reshape(-1, 8).astype(np.int32)
    dl = d * (2 * ((qh >> 12) & 7) + 1).astype(np.float32)  # [nb,8]
    delta = np.where((qh & 0x8000) != 0, -IQ1S_DELTA, IQ1S_DELTA).astype(np.float32)
    shift = 3 * np.arange(4)
    idx = qs | (((qh[:, :, None] >> shift[None, None, :]) & 7) << 8)
    grid = IQ1S_GRID[idx].astype(np.float32)  # [nb,8,4,8]
    vals = dl[:, :, None, None] * (grid + delta[:, :, None, None])
    return vals.astype(np.float32).reshape(-1)


def dequant_iq1_m(raw, n):
    b = _blocks(raw, GGMLType.IQ1_M, n)
    qs = b[:, 0:32].reshape(-1, 8, 4).astype(np.int32)
    qh = b[:, 32:48].reshape(-1, 8, 2).astype(np.int32)
    sc = np.ascontiguousarray(b[:, 48:56]).view(np.uint16).astype(np.int32)  # [nb,4]
    scale_bits = (
        (sc[:, 0] >> 12) | ((sc[:, 1] >> 8) & 0x00F0) | ((sc[:, 2] >> 4) & 0x0F00)
        | (sc[:, 3] & 0xF000)
    ).astype(np.uint16)
    d = scale_bits.view(np.float16).astype(np.float32)[:, None]  # [nb,1]
    ib = np.arange(8)
    dl1 = (2 * ((sc[:, ib // 2] >> (6 * (ib % 2) + 0)) & 7) + 1).astype(np.float32)
    dl2 = (2 * ((sc[:, ib // 2] >> (6 * (ib % 2) + 3)) & 7) + 1).astype(np.float32)
    dl = d[:, :, None] * np.stack([dl1, dl1, dl2, dl2], axis=2)  # [nb,8,4]
    idx = np.empty_like(qs)
    idx[:, :, 0] = qs[:, :, 0] | ((qh[:, :, 0] << 8) & 0x700)
    idx[:, :, 1] = qs[:, :, 1] | ((qh[:, :, 0] << 4) & 0x700)
    idx[:, :, 2] = qs[:, :, 2] | ((qh[:, :, 1] << 8) & 0x700)
    idx[:, :, 3] = qs[:, :, 3] | ((qh[:, :, 1] << 4) & 0x700)
    hbits = np.stack(
        [qh[:, :, 0] & 0x08, qh[:, :, 0] & 0x80, qh[:, :, 1] & 0x08, qh[:, :, 1] & 0x80],
        axis=2,
    )
    delta = np.where(hbits != 0, -IQ1S_DELTA, IQ1S_DELTA).astype(np.float32)
    grid = IQ1S_GRID[idx].astype(np.float32)  # [nb,8,4,8]
    vals = dl[:, :, :, None] * (grid + delta[:, :, :, None])
    return vals.astype(np.float32).reshape(-1)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

_DEQUANT = {
    GGMLType.Q4_0: dequant_q4_0,
    GGMLType.Q4_1: dequant_q4_1,
    GGMLType.Q5_0: dequant_q5_0,
    GGMLType.Q5_1: dequant_q5_1,
    GGMLType.Q8_0: dequant_q8_0,
    GGMLType.Q8_1: dequant_q8_1,
    GGMLType.Q2_K: dequant_q2_K,
    GGMLType.Q3_K: dequant_q3_K,
    GGMLType.Q4_K: dequant_q4_K,
    GGMLType.Q5_K: dequant_q5_K,
    GGMLType.Q6_K: dequant_q6_K,
    GGMLType.Q8_K: dequant_q8_K,
    GGMLType.IQ2_XXS: dequant_iq2_xxs,
    GGMLType.IQ2_XS: dequant_iq2_xs,
    GGMLType.IQ2_S: dequant_iq2_s,
    GGMLType.IQ3_XXS: dequant_iq3_xxs,
    GGMLType.IQ3_S: dequant_iq3_s,
    GGMLType.IQ1_S: dequant_iq1_s,
    GGMLType.IQ1_M: dequant_iq1_m,
    GGMLType.IQ4_NL: dequant_iq4_nl,
    GGMLType.IQ4_XS: dequant_iq4_xs,
    GGMLType.TQ1_0: dequant_tq1_0,
    GGMLType.TQ2_0: dequant_tq2_0,
    GGMLType.MXFP4: dequant_mxfp4,
    GGMLType.NVFP4: dequant_nvfp4,
    GGMLType.Q1_0: dequant_q1_0,
    GGMLType.Q2_0: dequant_q2_0,
}


_INTEGER = {GGMLType.I8: np.int8, GGMLType.I16: np.int16, GGMLType.I32: np.int32,
            GGMLType.I64: np.int64}


def dequantize(raw: np.ndarray, dtype: GGMLType, n: int) -> np.ndarray:
    """Dequantize `n` elements of packed `dtype` data to float32 [n]."""
    if dtype == GGMLType.F32:
        return np.frombuffer(raw, dtype=np.float32, count=n).copy()
    if dtype == GGMLType.F16:
        return np.frombuffer(raw, dtype=np.float16, count=n).astype(np.float32)
    if dtype == GGMLType.BF16:
        u = np.frombuffer(raw, dtype=np.uint16, count=n).astype(np.uint32) << 16
        return u.view(np.float32).copy()
    if dtype == GGMLType.F64:
        return np.frombuffer(raw, dtype=np.float64, count=n).astype(np.float32)
    if dtype in _INTEGER:
        return np.frombuffer(raw, dtype=_INTEGER[dtype], count=n).astype(np.float32)
    fn = _DEQUANT.get(dtype)
    if fn is None:
        raise NotImplementedError(f"dequantize: {GGMLType(dtype).name}")
    return fn(raw, n)


def dequantize_tensor(raw: np.ndarray, dtype: GGMLType, shape: tuple[int, ...]) -> np.ndarray:
    """Dequantize to float32 with numpy C-order `shape` (rows are contiguous)."""
    n = int(np.prod(shape)) if shape else 1
    return dequantize(raw, dtype, n).reshape(shape)
