"""Load-time repacking of the K-quant blocks into block-scaled int8 planes.

Every supported format is losslessly expressible as
    value[j] = q[j] * scale[j // g] + min[j // g]
with q int8 and group size g in {16, 32}. At load each weight is repacked
into separate q / scale / min planes, so one block-scaled GEMM kernel serves
every format instead of per-format bit-twiddling.

`extract_planes(raw, dtype, n)` -> (q int8 [n], scales f32 [n//g], mins f32
or None, g). `extract_planes_hier` keeps the K-quant factoring: int8
sub-scales times an f32 superblock scale per 256 elements (ggml-common.h:
327-376), which cuts the scale-plane bytes 4x; dmin is returned pre-negated
so min_eff = subm * dmin, a pure product matching the flat planes' mins bit
for bit.
"""

from __future__ import annotations

import numpy as np

from ..gguf.constants import GGMLType
from . import dequant as D


def planes_q4_K(raw, n):
    b = D._blocks(raw, GGMLType.Q4_K, n)
    d = D._f16(b[:, 0:2])
    dmin = D._f16(b[:, 2:4])
    sc, mn = D._k4_scale_min(b[:, 4:16])
    qs = b[:, 16:144].reshape(-1, 4, 32)
    lo = (qs & 0xF).astype(np.int8)
    hi = (qs >> 4).astype(np.int8)
    q = np.stack([lo, hi], axis=2).reshape(-1, 8, 32)
    scales = (d * sc).astype(np.float32)  # [nb,8]
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


_PLANES = {
    GGMLType.Q4_K: planes_q4_K,
    GGMLType.Q6_K: planes_q6_K,
}

PLANE_TYPES = frozenset(_PLANES)


def extract_planes(raw, dtype: GGMLType, n: int):
    """-> (q int8 [n], scales f32 [n//g], mins f32 [n//g] | None, g)."""
    fn = _PLANES.get(dtype)
    if fn is None:
        raise NotImplementedError(f"extract_planes: {GGMLType(dtype).name}")
    return fn(raw, n)


def hier_q4_K(raw, n):
    b = D._blocks(raw, GGMLType.Q4_K, n)
    d = D._f16(b[:, 0:2]).astype(np.float32).reshape(-1)
    dmin = D._f16(b[:, 2:4]).astype(np.float32).reshape(-1)
    sc, mn = D._k4_scale_min(b[:, 4:16])
    qs = b[:, 16:144].reshape(-1, 4, 32)
    lo = (qs & 0xF).astype(np.int8)
    hi = (qs >> 4).astype(np.int8)
    q = np.stack([lo, hi], axis=2).reshape(-1, 8, 32)
    return (q.reshape(-1), sc.astype(np.int8).reshape(-1), d,
            mn.astype(np.int8).reshape(-1), -dmin, 32)


def hier_q6_K(raw, n):
    q, _, _, _ = planes_q6_K(raw, n)
    b = D._blocks(raw, GGMLType.Q6_K, n)
    sc = b[:, 192:208].view(np.int8).reshape(-1, 16)
    d = D._f16(b[:, 208:210]).astype(np.float32).reshape(-1)
    return q, sc.reshape(-1).copy(), d, None, None, 16


_HIER = {
    GGMLType.Q4_K: hier_q4_K,
    GGMLType.Q6_K: hier_q6_K,
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
    return fn(raw, n)
