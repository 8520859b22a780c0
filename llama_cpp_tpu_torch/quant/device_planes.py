"""Plane extraction on the device for transposed expert stacks: the raw
blocks go up as they are, and the int8 planes with their f32 scales (and
mins) are cut out and swapped into the matmul layout [E, K, O] there, the
same values as quant/repack.py's extract_planes followed by a swap of the
last two axes on the host. The storage types of the expert stacks that
GGUF files carry: Q4_K and Q6_K (the K-quant mixes), Q8_0 and MXFP4."""

from __future__ import annotations

import numpy as np
import torch

from ..gguf.constants import GGML_BLOCK_LAYOUT, GGMLType
from .dequant import KVALUES_FP4

# elements a pass: bounds the raw upload and the temporaries on the device
CHUNK_ELEMENTS = 1 << 28


def _f16(b: torch.Tensor) -> torch.Tensor:
    """[nb, 2] bytes -> [nb, 1] f32 of the little-endian fp16."""
    return b.contiguous().view(torch.float16).float()


def _q8_0(b):
    return b[:, 2:34].contiguous().view(torch.int8), _f16(b[:, 0:2]), None, 32


def _q4_K(b):
    d, dmin = _f16(b[:, 0:2]), _f16(b[:, 2:4])
    s = b[:, 4:16].int()  # 6-bit scales and mins (reference get_scale_min_k4)
    sc = torch.cat([s[:, 0:4] & 63, (s[:, 8:12] & 0xF) | ((s[:, 0:4] >> 6) << 4)], dim=1)
    mn = torch.cat([s[:, 4:8] & 63, (s[:, 8:12] >> 4) | ((s[:, 4:8] >> 6) << 4)], dim=1)
    qs = b[:, 16:144].reshape(-1, 4, 32)
    q = torch.stack([qs & 0xF, qs >> 4], dim=2)  # chunk j: sub-blocks 2j, 2j + 1
    return q.view(torch.int8), d * sc.float(), -(dmin * mn.float()), 32


def _q6_K(b):
    ql = b[:, 0:128].reshape(-1, 2, 2, 32)
    qh = b[:, 128:192].reshape(-1, 2, 32)
    q = torch.stack([(ql[:, :, 0] & 0xF) | ((qh & 3) << 4),
                     (ql[:, :, 1] & 0xF) | (((qh >> 2) & 3) << 4),
                     (ql[:, :, 0] >> 4) | (((qh >> 4) & 3) << 4),
                     (ql[:, :, 1] >> 4) | ((qh >> 6) << 4)], dim=2).view(torch.int8) - 32
    sc = b[:, 192:208].contiguous().view(torch.int8).float()
    return q, _f16(b[:, 208:210]) * sc, None, 16


def _mxfp4(b):
    e = b[:, 0].long()  # E8M0 -> 2^(e-127) * 0.5 (reference ggml-impl.h:498)
    bits = torch.where(e < 2, 0x00200000 << e, (e - 1).clamp(min=0) << 23)
    d = bits.int().view(torch.float32)[:, None]
    lut = torch.as_tensor(KVALUES_FP4, dtype=torch.int8, device=b.device)
    qs = b[:, 1:17].long()
    return torch.cat([lut[qs & 0xF], lut[qs >> 4]], dim=1), d, None, 32


_PLANES = {GGMLType.Q8_0: _q8_0, GGMLType.Q4_K: _q4_K, GGMLType.Q6_K: _q6_K,
           GGMLType.MXFP4: _mxfp4}
DEVICE_PLANE_TYPES = frozenset(_PLANES)


def expert_stack(raw: np.ndarray, dtype: GGMLType, shape: tuple[int, int, int], device):
    """Raw bytes of an [E, O, K] stack (file order) -> (q int8 [E, K, O],
    scales f32 [E, K/g, O], mins f32 [E, K/g, O] or None, g) on `device`,
    a few experts a pass."""
    E, O, K = shape
    lay = GGML_BLOCK_LAYOUT[dtype]
    per = O * K // lay.block_size * lay.type_size  # bytes an expert
    step = max(1, CHUNK_ELEMENTS // (O * K))
    raw = np.asarray(raw).reshape(-1)
    q = sc = mn = None
    for e0 in range(0, E, step):
        e1 = min(E, e0 + step)
        b = torch.from_numpy(np.array(raw[e0 * per: e1 * per])).to(device)
        pq, ps, pm, g = _PLANES[dtype](b.reshape(-1, lay.type_size))
        if q is None:
            q = torch.empty((E, K, O), dtype=torch.int8, device=device)
            sc = torch.empty((E, K // g, O), dtype=torch.float32, device=device)
            mn = None if pm is None else torch.empty_like(sc)
        q[e0:e1] = pq.reshape(e1 - e0, O, K).transpose(1, 2)
        sc[e0:e1] = ps.reshape(e1 - e0, O, K // g).transpose(1, 2)
        if pm is not None:
            mn[e0:e1] = pm.reshape(e1 - e0, O, K // g).transpose(1, 2)
    return q, sc, mn, g
