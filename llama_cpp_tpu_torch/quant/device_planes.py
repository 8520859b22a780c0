"""Plane extraction on the device: the raw blocks go up as they are, and the
int8 planes with their scales (and mins) are cut out there, the same values
as quant/repack.py's host extraction (the counterpart of the JAX package's
quant/device_repack.py, whose host extraction costs about 10 s a GB).

Two shapes of weight:
  * expert stacks (expert_stack): the flat planes swapped into the matmul
    layout [E, K, O], for the storage types of the expert stacks that GGUF
    files carry: Q4_K and Q6_K (the K-quant mixes), Q8_0 and MXFP4;
  * 2-D matrices (matrix_flat, matrix_hier): the planes in file order
    [O, K], bit for bit extract_planes (Q8_0, Q4_0, Q5_0, Q4_K, Q6_K, MXFP4)
    and extract_planes_hier (Q4_K and Q6_K: int8 sub-scales under f32
    superblock scales); ops/qtensor.load_weight transposes and packs them.

The bytes go up in passes of whole rows (of whole experts for a stack), at
most CHUNK_BYTES a pass where a row or an expert fits, through two pinned
host buffers on a card, so the host's copy of one pass overlaps the
device's copy and cutting of the last. On the CPU the same cutters run on
the host's bytes, the check that they equal quant/repack.py."""

from __future__ import annotations

import numpy as np
import torch

from ..gguf.constants import GGML_BLOCK_LAYOUT, GGMLType
from .dequant import KVALUES_FP4

# raw bytes a pass: bounds the pinned buffers and the temporaries on the device
CHUNK_BYTES = 1 << 26


def _f16(b: torch.Tensor) -> torch.Tensor:
    """[nb, 2] bytes -> [nb, 1] f32 of the little-endian fp16."""
    return b.contiguous().view(torch.float16).float()


def _nibbles(qs: torch.Tensor) -> torch.Tensor:
    """[nb, 16] bytes -> [nb, 32] uint8: the low nibbles, then the high."""
    return torch.cat([qs & 0xF, qs >> 4], dim=1)


def _q8_0(b):
    return b[:, 2:34].contiguous().view(torch.int8), _f16(b[:, 0:2]), None, 32


def _q4_0(b):
    return (_nibbles(b[:, 2:18]) - 8).view(torch.int8), _f16(b[:, 0:2]), None, 32


def _q5_0(b):
    # bit e of the little-endian 32-bit qh is bit 4 of element e
    shifts = torch.arange(8, dtype=torch.uint8, device=b.device).repeat(4)
    hi = (b[:, 2:6].repeat_interleave(8, dim=1) >> shifts) & 1
    return ((_nibbles(b[:, 6:22]) | (hi << 4)) - 16).view(torch.int8), _f16(b[:, 0:2]), None, 32


def _k4_scale_min(s: torch.Tensor):
    """12 bytes of 6-bit scales and mins -> ([nb, 8], [nb, 8]) int32
    (reference get_scale_min_k4)."""
    s = s.int()
    sc = torch.cat([s[:, 0:4] & 63, (s[:, 8:12] & 0xF) | ((s[:, 0:4] >> 6) << 4)], dim=1)
    mn = torch.cat([s[:, 4:8] & 63, (s[:, 8:12] >> 4) | ((s[:, 4:8] >> 6) << 4)], dim=1)
    return sc, mn


def _q4k_q(b):
    qs = b[:, 16:144].reshape(-1, 4, 32)
    return torch.stack([qs & 0xF, qs >> 4], dim=2).view(torch.int8)  # chunk j: sub-blocks 2j, 2j+1


def _q4_K(b):
    d, dmin = _f16(b[:, 0:2]), _f16(b[:, 2:4])
    sc, mn = _k4_scale_min(b[:, 4:16])
    return _q4k_q(b), d * sc.float(), -(dmin * mn.float()), 32


def _q6k_q(b):
    ql = b[:, 0:128].reshape(-1, 2, 2, 32)
    qh = b[:, 128:192].reshape(-1, 2, 32)
    return torch.stack([(ql[:, :, 0] & 0xF) | ((qh & 3) << 4),
                        (ql[:, :, 1] & 0xF) | (((qh >> 2) & 3) << 4),
                        (ql[:, :, 0] >> 4) | (((qh >> 4) & 3) << 4),
                        (ql[:, :, 1] >> 4) | ((qh >> 6) << 4)], dim=2).view(torch.int8) - 32


def _q6_K(b):
    sc = b[:, 192:208].contiguous().view(torch.int8).float()
    return _q6k_q(b), _f16(b[:, 208:210]) * sc, None, 16


def _mxfp4(b):
    e = b[:, 0].long()  # E8M0 -> 2^(e-127) * 0.5 (reference ggml-impl.h:498)
    bits = torch.where(e < 2, 0x00200000 << e, (e - 1).clamp(min=0) << 23)
    d = bits.int().view(torch.float32)[:, None]
    lut = torch.as_tensor(KVALUES_FP4, dtype=torch.int8, device=b.device)
    qs = b[:, 1:17].long()
    return torch.cat([lut[qs & 0xF], lut[qs >> 4]], dim=1), d, None, 32


def _hier_q4_K(b):
    d, dmin = _f16(b[:, 0:2]), _f16(b[:, 2:4])
    sc, mn = _k4_scale_min(b[:, 4:16])
    return _q4k_q(b), sc.to(torch.int8), d, mn.to(torch.int8), -dmin, 32


def _hier_q6_K(b):
    sc = b[:, 192:208].contiguous().view(torch.int8)
    return _q6k_q(b), sc, _f16(b[:, 208:210]), None, None, 16


_PLANES = {GGMLType.Q8_0: _q8_0, GGMLType.Q4_0: _q4_0, GGMLType.Q5_0: _q5_0,
           GGMLType.Q4_K: _q4_K, GGMLType.Q6_K: _q6_K, GGMLType.MXFP4: _mxfp4}
_HIER = {GGMLType.Q4_K: _hier_q4_K, GGMLType.Q6_K: _hier_q6_K}
# the expert stacks' types (the flat cutter serves them); the 2-D matrices'
DEVICE_PLANE_TYPES = frozenset((GGMLType.Q8_0, GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.MXFP4))
MATRIX_PLANE_TYPES = frozenset(_PLANES)
MATRIX_HIER_TYPES = frozenset(_HIER)


def cuts_on(device) -> bool:
    """Whether ops/qtensor.load_weight cuts planes here for `device`: on a
    card (a test may ask for it on the CPU)."""
    return torch.device(device).type == "cuda"


class _Uploader:
    """Raw bytes to the device a pass at a time: on a card through two
    pinned host buffers of `size` bytes (the host fills one while the last
    pass's copy and cutting run), on the CPU as a copy of the host's bytes.
    The copy and the event that frees its buffer go on the stream of the
    target device, which need not be the current one."""

    def __init__(self, device, size: int):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.turn = 0
        self.bufs = [torch.empty(size, dtype=torch.uint8, pin_memory=True)
                     for _ in range(2)] if self.cuda else []
        self.done = [None, None]

    def put(self, raw: np.ndarray) -> torch.Tensor:
        if not self.cuda:
            return torch.from_numpy(np.array(raw)).to(self.device)
        buf, done = self.bufs[self.turn], self.done[self.turn]
        if done is not None:
            done.synchronize()  # this buffer's last copy has left the host
        n = raw.size
        buf[:n].numpy()[:] = raw
        out = torch.empty(n, dtype=torch.uint8, device=self.device)
        out.copy_(buf[:n], non_blocking=True)  # on the target device's current stream
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        self.done[self.turn] = ev
        self.turn ^= 1
        return out


def _passes(raw: np.ndarray, unit: int, n_units: int, device, chunk_bytes: int | None):
    """-> (u0, u1, the bytes of units u0:u1 on `device`) for n_units units
    of `unit` raw bytes each, as many whole units a pass as chunk_bytes
    (CHUNK_BYTES by default) holds, and at least one."""
    step = max(1, (chunk_bytes or CHUNK_BYTES) // unit)
    raw = np.asarray(raw).reshape(-1)
    up = _Uploader(device, min(step, n_units) * unit)
    for u0 in range(0, n_units, step):
        u1 = min(n_units, u0 + step)
        yield u0, u1, up.put(raw[u0 * unit: u1 * unit])


def expert_stack(raw: np.ndarray, dtype: GGMLType, shape: tuple[int, int, int], device,
                 chunk_bytes: int | None = None):
    """Raw bytes of an [E, O, K] stack (file order) -> (q int8 [E, K, O],
    scales f32 [E, K/g, O], mins f32 [E, K/g, O] or None, g) on `device`,
    whole experts a pass."""
    E, O, K = shape
    lay = GGML_BLOCK_LAYOUT[dtype]
    per = O * K // lay.block_size * lay.type_size  # bytes an expert
    q = sc = mn = None
    for e0, e1, b in _passes(raw, per, E, device, chunk_bytes):
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


def _matrix(raw: np.ndarray, dtype: GGMLType, shape: tuple[int, int], device, cutter,
            chunk_bytes: int | None):
    """Cut a 2-D matrix [O, K] (file order) whole rows a pass: -> the
    cutter's planes, each [O, K / its group], on `device`."""
    O, K = shape
    lay = GGML_BLOCK_LAYOUT[dtype]
    row = K // lay.block_size * lay.type_size  # bytes a row
    out = None
    for r0, r1, b in _passes(raw, row, O, device, chunk_bytes):
        parts = cutter(b.reshape(-1, lay.type_size))
        g = parts[-1]
        if out is None:
            out = [None if p is None else torch.empty((O, p.numel() // (r1 - r0)), dtype=p.dtype,
                                                      device=device) for p in parts[:-1]]
        for o, p in zip(out, parts[:-1]):
            if o is not None:
                o[r0:r1] = p.reshape(r1 - r0, -1)
    return (*out, g)


def matrix_flat(raw: np.ndarray, dtype: GGMLType, shape: tuple[int, int], device,
                chunk_bytes: int | None = None):
    """Raw bytes of a 2-D matrix [O, K] (file order) -> (q int8 [O, K],
    scales f32 [O, K/g], mins f32 [O, K/g] or None, g) on `device`: the
    values of quant/repack.py's extract_planes."""
    return _matrix(raw, dtype, shape, device, _PLANES[dtype], chunk_bytes)


def matrix_hier(raw: np.ndarray, dtype: GGMLType, shape: tuple[int, int], device,
                chunk_bytes: int | None = None):
    """Raw bytes of a 2-D matrix [O, K] (file order, K a multiple of 256) ->
    (q int8 [O, K], sub int8 [O, K/g], d f32 [O, K/256], subm int8 [O, K/g]
    or None, dm f32 [O, K/256] or None, g) on `device`: the values of
    quant/repack.py's extract_planes_hier."""
    return _matrix(raw, dtype, shape, device, _HIER[dtype], chunk_bytes)
