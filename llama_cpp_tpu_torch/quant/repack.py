"""Load-time repacking of ggml block formats into block-scaled int8 planes.

Every format the kernels take is losslessly expressible as
    value[j] = q[j] * scale[j // g] + min[j // g]
with q int8 and group size g in {16, 32}. At load each weight is repacked
into separate q / scale / min planes, so one block-scaled GEMM kernel serves
every format instead of per-format bit-twiddling.

`extract_planes(raw, dtype, n)` -> (q int8 [n], scales f32 [n//g], mins f32
or None, g) for the 21 types of _PLANES. `extract_planes_hier` keeps the
superblock factoring of the 6 types of _HIER: int8 sub-scales times an f32
scale per 256 elements (ggml-common.h:327-376), which cuts the scale-plane
bytes 4x; dmin is returned pre-negated so min_eff = subm * dmin, a pure
product matching the flat planes' mins bit for bit.

Every plane equals the numpy path of the JAX package's quant/repack.py bit
for bit. The 4-, 5- and K-quant extractors assemble q in uint8 straight into
its slots (no int32 temporaries), and both entry points run a tensor in
chunks of CHUNK elements, so a vocab-wide table needs no more than its
planes and a few chunk-sized temporaries of host memory.
"""

from __future__ import annotations

import numpy as np

from ..gguf.constants import GGML_BLOCK_LAYOUT, QK_K, GGMLType
from . import dequant as D

CHUNK = 1 << 22  # elements extracted at a time: a multiple of every block and of 256


def _expand(sc: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(sc, dtype=np.float32).reshape(-1)


def _nibble_bytes(qs: np.ndarray) -> np.ndarray:
    """[nb, 16] bytes -> [nb, 32] uint8: the low nibbles, then the high."""
    out = np.empty((qs.shape[0], 32), np.uint8)
    np.bitwise_and(qs, 0xF, out=out[:, :16])
    np.right_shift(qs, 4, out=out[:, 16:])
    return out


def _q5_bytes(qh: np.ndarray, qs: np.ndarray) -> np.ndarray:
    """Q5_0/Q5_1 values 0..31 in uint8: the nibbles of qs with bit e of the
    little-endian 32-bit qh as bit 4 of element e."""
    q = _nibble_bytes(qs)
    q |= np.unpackbits(qh, axis=1, bitorder="little") << 4
    return q


# each extractor returns (q int8 flat [n], scales [n//g], mins [n//g] | None, g)


def planes_q4_0(raw, n):
    b = D._blocks(raw, GGMLType.Q4_0, n)
    d = D._f16(b[:, 0:2])
    q = _nibble_bytes(b[:, 2:18])
    q -= 8  # wraps in uint8: the int8 view holds -8..7
    return q.view(np.int8).reshape(-1), _expand(d), None, 32


def planes_q4_1(raw, n):
    b = D._blocks(raw, GGMLType.Q4_1, n)
    d = D._f16(b[:, 0:2])
    m = D._f16(b[:, 2:4])
    q = _nibble_bytes(b[:, 4:20])
    return q.view(np.int8).reshape(-1), _expand(d), _expand(m), 32


def planes_q5_0(raw, n):
    b = D._blocks(raw, GGMLType.Q5_0, n)
    d = D._f16(b[:, 0:2])
    q = _q5_bytes(b[:, 2:6], b[:, 6:22])
    q -= 16  # -16..15 in the int8 view
    return q.view(np.int8).reshape(-1), _expand(d), None, 32


def planes_q5_1(raw, n):
    b = D._blocks(raw, GGMLType.Q5_1, n)
    d = D._f16(b[:, 0:2])
    m = D._f16(b[:, 2:4])
    q = _q5_bytes(b[:, 4:8], b[:, 8:24])
    return q.view(np.int8).reshape(-1), _expand(d), _expand(m), 32


def planes_q8_0(raw, n):
    b = D._blocks(raw, GGMLType.Q8_0, n)
    d = D._f16(b[:, 0:2])
    q = b[:, 2:34].view(np.int8)
    return q.reshape(-1).copy(), _expand(d), None, 32


def _q4k_q(qs: np.ndarray) -> np.ndarray:
    """[nb, 128] bytes -> [nb, 8, 32] uint8: chunk j's low nibbles are
    sub-block 2j, its high nibbles sub-block 2j + 1."""
    qs = qs.reshape(-1, 4, 32)
    q = np.empty((qs.shape[0], 4, 2, 32), np.uint8)
    np.bitwise_and(qs, 0xF, out=q[:, :, 0])
    np.right_shift(qs, 4, out=q[:, :, 1])
    return q.reshape(-1, 8, 32)


def planes_q4_K(raw, n):
    b = D._blocks(raw, GGMLType.Q4_K, n)
    d = D._f16(b[:, 0:2])
    dmin = D._f16(b[:, 2:4])
    sc, mn = D._k4_scale_min(b[:, 4:16])
    q = _q4k_q(b[:, 16:144]).view(np.int8)
    scales = (d * sc).astype(np.float32)  # [nb,8]
    mins = (-(dmin * mn)).astype(np.float32)
    return q.reshape(-1), scales.reshape(-1), mins.reshape(-1), 32


def _q5k_q(b: np.ndarray) -> np.ndarray:
    """Q5_K values 0..31 [nb, 8, 32] in uint8: Q4_K's nibbles with bit 2j
    (sub-block 2j) or 2j + 1 (sub-block 2j + 1) of each qh byte as bit 4."""
    q = _q4k_q(b[:, 48:176])
    qh = b[:, 16:48]
    for s in range(8):
        q[:, s] |= ((qh >> s) & 1) << 4
    return q


def planes_q5_K(raw, n):
    b = D._blocks(raw, GGMLType.Q5_K, n)
    d = D._f16(b[:, 0:2])
    dmin = D._f16(b[:, 2:4])
    sc, mn = D._k4_scale_min(b[:, 4:16])
    q = _q5k_q(b).view(np.int8)
    scales = (d * sc).astype(np.float32)
    mins = (-(dmin * mn)).astype(np.float32)
    return q.reshape(-1), scales.reshape(-1), mins.reshape(-1), 32


def planes_q6_K(raw, n):
    # the 6-bit values are assembled in uint8 straight into their slots of
    # q (no int32 temporaries, no stack), then shifted to -32..31 in place
    b = D._blocks(raw, GGMLType.Q6_K, n)
    ql = b[:, 0:128].reshape(-1, 2, 2, 32)
    qh = b[:, 128:192].reshape(-1, 2, 32)
    sc = b[:, 192:208].view(np.int8).reshape(-1, 16).astype(np.float32)
    d = D._f16(b[:, 208:210])
    q = np.empty((b.shape[0], 2, 4, 32), np.uint8)  # [nb,2,4,32]
    q[:, :, 0] = (ql[:, :, 0] & 0xF) | ((qh & 3) << 4)
    q[:, :, 1] = (ql[:, :, 1] & 0xF) | (((qh >> 2) & 3) << 4)
    q[:, :, 2] = (ql[:, :, 0] >> 4) | (((qh >> 4) & 3) << 4)
    q[:, :, 3] = (ql[:, :, 1] >> 4) | ((qh >> 6) << 4)
    q = q.view(np.int8)
    q -= 32
    scales = (d * sc).astype(np.float32)  # [nb,1]*[nb,16] -> [nb,16] per-16 groups
    return q.reshape(-1), scales.reshape(-1), None, 16


def _q2k_q(b: np.ndarray) -> np.ndarray:
    """Q2_K values 0..3 [nb, 2, 4, 32] in uint8: bits 2j..2j+1 of each byte
    of a half's 32 bytes."""
    qs = b[:, 16:80].reshape(-1, 2, 32)
    q = np.empty((b.shape[0], 2, 4, 32), np.uint8)
    for j in range(4):
        q[:, :, j] = (qs >> (2 * j)) & 3
    return q


def planes_q2_K(raw, n):
    b = D._blocks(raw, GGMLType.Q2_K, n)
    scales = b[:, 0:16].astype(np.int32)
    d = D._f16(b[:, 80:82])
    dmin = D._f16(b[:, 82:84])
    q = _q2k_q(b).view(np.int8)
    sc = scales.reshape(-1, 2, 4, 2)
    dl = (d[:, :, None, None] * (sc & 0xF)).astype(np.float32)
    ml = (-(dmin[:, :, None, None] * (sc >> 4))).astype(np.float32)
    return q.reshape(-1), dl.reshape(-1), ml.reshape(-1), 16


def _q3k_q(b: np.ndarray) -> np.ndarray:
    """Q3_K values -4..3 [nb, 2, 4, 32] as uint8 (int8 view): the 2-bit
    value, less 4 where bit 4h + j of the hmask byte is clear."""
    hm = b[:, 0:32]
    qs = b[:, 32:96].reshape(-1, 2, 32)
    q = np.empty((b.shape[0], 2, 4, 32), np.uint8)
    for h in range(2):
        for j in range(4):
            q[:, h, j] = ((qs[:, h] >> (2 * j)) & 3) + (((hm >> (4 * h + j)) & 1) ^ 1) * 252
    return q


def planes_q3_K(raw, n):
    b = D._blocks(raw, GGMLType.Q3_K, n)
    scales6 = D._q3_scales(b[:, 96:108]).astype(np.float32)
    d = D._f16(b[:, 108:110])
    q = _q3k_q(b).view(np.int8)
    sc = scales6.reshape(-1, 2, 4, 2) - 32.0
    scales = (d[:, :, None, None] * sc).astype(np.float32)
    return q.reshape(-1), scales.reshape(-1), None, 16


def planes_iq4_nl(raw, n):
    b = D._blocks(raw, GGMLType.IQ4_NL, n)
    d = D._f16(b[:, 0:2])
    q = D.KVALUES_IQ4NL[_nibble_bytes(b[:, 2:18])]
    return q.reshape(-1), _expand(d), None, 32


def _iq4_xs_sub(b: np.ndarray) -> np.ndarray:
    """IQ4_XS 6-bit sub-scales less 32, [nb, 8] int32."""
    scales_h = np.ascontiguousarray(b[:, 2:4]).view(np.uint16).astype(np.int32)
    scales_l = b[:, 4:8].astype(np.int32)
    ib = np.arange(8)
    ls_l = (scales_l[:, ib // 2] >> (4 * (ib % 2))[None, :]) & 0xF
    ls_h = (scales_h >> (2 * ib)[None, :]) & 3
    return (ls_l | (ls_h << 4)) - 32


def planes_iq4_xs(raw, n):
    b = D._blocks(raw, GGMLType.IQ4_XS, n)
    d = D._f16(b[:, 0:2])
    ls = _iq4_xs_sub(b)
    qs = b[:, 8:136].reshape(-1, 8, 16)
    q = np.empty((b.shape[0], 8, 32), np.int8)
    q[:, :, :16] = D.KVALUES_IQ4NL[qs & 0xF]
    q[:, :, 16:] = D.KVALUES_IQ4NL[qs >> 4]
    scales = (d * ls.astype(np.float32)).astype(np.float32)
    return q.reshape(-1), scales.reshape(-1), None, 32


# the MXFP4 values of a byte's low and high nibble as one int16 (low byte the
# low nibble's): one table lookup a byte
_FP4_PAIR = np.stack([D.KVALUES_FP4[np.arange(256) & 0xF],
                      D.KVALUES_FP4[np.arange(256) >> 4]], axis=1).astype(np.int8).view(
                          np.int16).reshape(256)


def planes_mxfp4(raw, n):
    b = D._blocks(raw, GGMLType.MXFP4, n)
    d = D._e8m0_half(b[:, 0:1])
    pairs = _FP4_PAIR[np.ascontiguousarray(b[:, 1:17])].view(np.int8).reshape(-1, 16, 2)
    q = np.ascontiguousarray(pairs.transpose(0, 2, 1))  # the low nibbles, then the high
    return q.reshape(-1), _expand(d), None, 32


def planes_q8_K(raw, n):
    b = D._blocks(raw, GGMLType.Q8_K, n)
    d = b[:, 0:4].view(np.float32)
    q = b[:, 4: 4 + QK_K].view(np.int8)
    return q.reshape(-1).copy(), np.repeat(_expand(d), QK_K // 32), None, 32


def _signs(sbyte: np.ndarray) -> np.ndarray:
    """Sign bytes [...] -> +-1 int16 [..., 8], bit j of each byte the sign
    of element j."""
    return np.where((sbyte[..., None] & D.KMASK_IQ2XS) != 0, -1, 1).astype(np.int16)


def planes_iq2_xxs(raw, n):
    b = D._blocks(raw, GGMLType.IQ2_XXS, n)
    d = D._f16(b[:, 0:2])
    data = np.ascontiguousarray(b[:, 2:66]).view(np.uint32).reshape(-1, 8, 2)
    aux0 = data[:, :, 0]
    aux1 = data[:, :, 1].astype(np.uint64)
    db = d * ((0.5 + (aux1 >> 28).astype(np.float32)) * 0.25)
    idx = aux0[:, :, None] >> (np.arange(4, dtype=np.uint32) * 8)[None, None, :] & 0xFF
    grid = D.IQ2XXS_GRID[idx].astype(np.int16)  # [nb,8,4,8]
    sidx = (aux1[:, :, None] >> (7 * np.arange(4, dtype=np.uint64))[None, None, :]) & 127
    q = (grid * _signs(D.KSIGNS_IQ2XS[sidx.astype(np.int32)])).astype(np.int8)
    return q.reshape(-1), db.astype(np.float32).reshape(-1), None, 32


def _iq2_scales(d: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """IQ2_XS/IQ2_S per-16 scales [nb, 8, 2]: d * (0.5 + 4-bit) * 0.25."""
    scales = scales.astype(np.int32)
    db = np.stack(
        [(scales & 0xF).astype(np.float32), (scales >> 4).astype(np.float32)], axis=2)
    return d[:, :, None] * (0.5 + db) * 0.25


def planes_iq2_xs(raw, n):
    b = D._blocks(raw, GGMLType.IQ2_XS, n)
    d = D._f16(b[:, 0:2])
    qs = np.ascontiguousarray(b[:, 2:66]).view(np.uint16).reshape(-1, 8, 4)
    db = _iq2_scales(d, b[:, 66:74])
    grid = D.IQ2XS_GRID[(qs & 511).astype(np.int32)].astype(np.int16)
    q = (grid * _signs(D.KSIGNS_IQ2XS[(qs >> 9).astype(np.int32)])).astype(np.int8)
    return q.reshape(-1), db.astype(np.float32).reshape(-1), None, 16


def planes_iq2_s(raw, n):
    b = D._blocks(raw, GGMLType.IQ2_S, n)
    d = D._f16(b[:, 0:2])
    qs = b[:, 2:34].reshape(-1, 8, 4).astype(np.int32)
    signs_b = b[:, 34:66].reshape(-1, 8, 4).astype(np.int32)
    qh = b[:, 66:74].astype(np.int32)
    db = _iq2_scales(d, b[:, 74:82])
    shift = (8 - 2 * np.arange(4))[None, None, :]
    idx = qs | ((qh[:, :, None] << shift) & 0x300)
    grid = D.IQ2S_GRID[idx].astype(np.int16)
    q = (grid * _signs(signs_b)).astype(np.int8)
    return q.reshape(-1), db.astype(np.float32).reshape(-1), None, 16


def planes_iq3_xxs(raw, n):
    b = D._blocks(raw, GGMLType.IQ3_XXS, n)
    d = D._f16(b[:, 0:2])
    qs = b[:, 2:66].reshape(-1, 8, 8).astype(np.int32)
    aux = np.ascontiguousarray(b[:, 66:98]).view(np.uint32).reshape(-1, 8)
    db = d * ((0.5 + (aux >> 28).astype(np.float32)) * 0.5)
    grid = D.IQ3XXS_GRID[qs].astype(np.int16).reshape(-1, 8, 4, 8)
    sidx = (aux[:, :, None].astype(np.uint64)
            >> (7 * np.arange(4, dtype=np.uint64))[None, None, :]) & 127
    q = (grid * _signs(D.KSIGNS_IQ2XS[sidx.astype(np.int32)])).astype(np.int8)
    return q.reshape(-1), db.astype(np.float32).reshape(-1), None, 32


def planes_iq3_s(raw, n):
    b = D._blocks(raw, GGMLType.IQ3_S, n)
    d = D._f16(b[:, 0:2])
    qs = b[:, 2:66].reshape(-1, 8, 8).astype(np.int32)
    qh = b[:, 66:74].astype(np.int32)
    signs_b = b[:, 74:106].reshape(-1, 8, 4).astype(np.int32)
    scales = b[:, 106:110].astype(np.int32)
    ib = np.arange(8)
    ls = (scales[:, ib // 2] >> (4 * (ib % 2))[None, :]) & 0xF
    db = d * (1 + 2 * ls).astype(np.float32)
    shift = 8 - np.arange(8)
    idx = qs | ((qh[:, :, None] << shift[None, None, :]) & 256)
    grid = D.IQ3S_GRID[idx].astype(np.int16).reshape(-1, 8, 4, 8)
    q = (grid * _signs(signs_b)).astype(np.int8)
    return q.reshape(-1), db.astype(np.float32).reshape(-1), None, 32


def planes_iq1_s(raw, n):
    b = D._blocks(raw, GGMLType.IQ1_S, n)
    d = D._f16(b[:, 0:2])
    qs = b[:, 2:34].reshape(-1, 8, 4).astype(np.int32)
    qh = np.ascontiguousarray(b[:, 34:50]).view(np.uint16).reshape(-1, 8).astype(np.int32)
    dl = d * (2 * ((qh >> 12) & 7) + 1).astype(np.float32)  # [nb,8]
    delta = np.where((qh & 0x8000) != 0, -D.IQ1S_DELTA, D.IQ1S_DELTA).astype(np.float32)
    shift = 3 * np.arange(4)
    idx = qs | (((qh[:, :, None] >> shift[None, None, :]) & 7) << 8)
    q = D.IQ1S_GRID[idx]  # [nb,8,4,8] int8
    mins = (dl * delta).astype(np.float32)
    return q.reshape(-1), dl.astype(np.float32).reshape(-1), mins.reshape(-1), 32


def planes_tq2_0(raw, n):
    b = D._blocks(raw, GGMLType.TQ2_0, n)
    qs = b[:, 0:64].reshape(-1, 2, 32)
    d = D._f16(b[:, 64:66])
    q = np.empty((b.shape[0], 2, 4, 32), np.uint8)
    for j in range(4):
        q[:, :, j] = ((qs >> (2 * j)) & 3) + 255  # -1..2 in the int8 view
    return q.view(np.int8).reshape(-1), np.repeat(_expand(d), QK_K // 32), None, 32


_PLANES = {
    GGMLType.Q4_0: planes_q4_0,
    GGMLType.Q4_1: planes_q4_1,
    GGMLType.Q5_0: planes_q5_0,
    GGMLType.Q5_1: planes_q5_1,
    GGMLType.Q8_0: planes_q8_0,
    GGMLType.Q8_K: planes_q8_K,
    GGMLType.Q2_K: planes_q2_K,
    GGMLType.Q3_K: planes_q3_K,
    GGMLType.Q4_K: planes_q4_K,
    GGMLType.Q5_K: planes_q5_K,
    GGMLType.Q6_K: planes_q6_K,
    GGMLType.IQ4_NL: planes_iq4_nl,
    GGMLType.IQ4_XS: planes_iq4_xs,
    GGMLType.MXFP4: planes_mxfp4,
    GGMLType.IQ2_XXS: planes_iq2_xxs,
    GGMLType.IQ2_XS: planes_iq2_xs,
    GGMLType.IQ2_S: planes_iq2_s,
    GGMLType.IQ3_XXS: planes_iq3_xxs,
    GGMLType.IQ3_S: planes_iq3_s,
    GGMLType.IQ1_S: planes_iq1_s,
    GGMLType.TQ2_0: planes_tq2_0,
}

PLANE_TYPES = frozenset(_PLANES)


def _chunked(fn, raw, dtype: GGMLType, n: int):
    """fn over CHUNK elements at a time, each output filled in place: every
    extractor works block by block, so the result is fn(raw, n)'s. A chunk
    is a whole number of blocks and of 256-element superblocks."""
    if n <= CHUNK:
        return fn(raw, n)
    lay = GGML_BLOCK_LAYOUT[dtype]
    if isinstance(raw, (bytes, memoryview)):
        raw = np.frombuffer(raw, dtype=np.uint8)
    raw = raw.reshape(-1)
    out, pos = None, None
    for e0 in range(0, n, CHUNK):
        m = min(CHUNK, n - e0)
        b0 = e0 // lay.block_size * lay.type_size
        part = fn(raw[b0: b0 + m // lay.block_size * lay.type_size], m)
        if out is None:  # each plane's length is a fixed share of the elements
            out = [None if a is None else np.empty(a.size * n // m, a.dtype) for a in part[:-1]]
            pos = [0] * len(out)
        for j, a in enumerate(part[:-1]):
            if a is not None:
                out[j][pos[j]: pos[j] + a.size] = a
                pos[j] += a.size
    return (*out, part[-1])


def extract_planes(raw, dtype: GGMLType, n: int):
    """-> (q int8 [n], scales f32 [n//g], mins f32 [n//g] | None, g)."""
    fn = _PLANES.get(dtype)
    if fn is None:
        raise NotImplementedError(f"extract_planes: {GGMLType(dtype).name}")
    return _chunked(fn, raw, dtype, n)


def hier_q4_K(raw, n):
    b = D._blocks(raw, GGMLType.Q4_K, n)
    d = D._f16(b[:, 0:2]).astype(np.float32).reshape(-1)
    dmin = D._f16(b[:, 2:4]).astype(np.float32).reshape(-1)
    sc, mn = D._k4_scale_min(b[:, 4:16])
    q = _q4k_q(b[:, 16:144]).view(np.int8)
    return (q.reshape(-1), sc.astype(np.int8).reshape(-1), d,
            mn.astype(np.int8).reshape(-1), -dmin, 32)


def hier_q5_K(raw, n):
    b = D._blocks(raw, GGMLType.Q5_K, n)
    d = D._f16(b[:, 0:2]).astype(np.float32).reshape(-1)
    dmin = D._f16(b[:, 2:4]).astype(np.float32).reshape(-1)
    sc, mn = D._k4_scale_min(b[:, 4:16])
    q = _q5k_q(b).view(np.int8)
    return (q.reshape(-1), sc.astype(np.int8).reshape(-1), d,
            mn.astype(np.int8).reshape(-1), -dmin, 32)


def hier_q6_K(raw, n):
    q, _, _, _ = planes_q6_K(raw, n)
    b = D._blocks(raw, GGMLType.Q6_K, n)
    sc = b[:, 192:208].view(np.int8).reshape(-1, 16)
    d = D._f16(b[:, 208:210]).astype(np.float32).reshape(-1)
    return q, sc.reshape(-1).copy(), d, None, None, 16


def hier_q2_K(raw, n):
    b = D._blocks(raw, GGMLType.Q2_K, n)
    scales = b[:, 0:16]
    d = D._f16(b[:, 80:82]).astype(np.float32).reshape(-1)
    dmin = D._f16(b[:, 82:84]).astype(np.float32).reshape(-1)
    q = _q2k_q(b).view(np.int8)
    return (q.reshape(-1), (scales & 0xF).astype(np.int8).reshape(-1), d,
            (scales >> 4).astype(np.int8).reshape(-1), -dmin, 16)


def hier_q3_K(raw, n):
    b = D._blocks(raw, GGMLType.Q3_K, n)
    q = _q3k_q(b).view(np.int8)
    sc = (D._q3_scales(b[:, 96:108]).astype(np.int16) - 32).astype(np.int8)
    d = D._f16(b[:, 108:110]).astype(np.float32).reshape(-1)
    return q.reshape(-1), sc.reshape(-1), d, None, None, 16


def hier_iq4_xs(raw, n):
    q, _, _, _ = planes_iq4_xs(raw, n)
    b = D._blocks(raw, GGMLType.IQ4_XS, n)
    d = D._f16(b[:, 0:2]).astype(np.float32).reshape(-1)
    return q, _iq4_xs_sub(b).astype(np.int8).reshape(-1), d, None, None, 32


_HIER = {
    GGMLType.Q2_K: hier_q2_K,
    GGMLType.Q3_K: hier_q3_K,
    GGMLType.Q4_K: hier_q4_K,
    GGMLType.Q5_K: hier_q5_K,
    GGMLType.Q6_K: hier_q6_K,
    GGMLType.IQ4_XS: hier_iq4_xs,
}

HIER_TYPES = frozenset(_HIER)
SUPERBLOCK = 256


def extract_planes_hier(raw, dtype: GGMLType, n: int):
    """-> (q int8 [n], sub int8 [n//g], d f32 [n//256],
           subm int8 [n//g] | None, dm f32 [n//256] | None, g)
    with effective scale = sub * d-expanded, min = subm * dm-expanded."""
    fn = _HIER.get(dtype)
    if fn is None:
        raise NotImplementedError(f"extract_planes_hier: {GGMLType(dtype).name}")
    return _chunked(fn, raw, dtype, n)
