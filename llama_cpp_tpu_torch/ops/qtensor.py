"""Quantized weight as block-scaled int8 planes in torch tensors, plus the
matmul route.

A weight W[out, in] is stored as q(int8) with per-group scales (+ mins),
produced once at load by quant/repack.py. Matmul weights keep the JAX
package's transposed layout: q [in, out], scales [in//g, out], with K-quant
superblock factors d/dmin [in//256, out] (hierarchical scales) and 4-bit
formats nibble-packed half-split into qp [in/2, out]. The route per call:
  * rows >= XLA_PREFILL_MIN_N: dequantize once and torch.matmul (the JAX
    package leaves these to XLA's dot);
  * fewer rows, where the JAX package's dispatch runs its Pallas kernel:
    the qmm kernel (ops/kernels/qmm.py), which takes its plain version for a
    CPU tensor and raises on a CUDA tensor it cannot take;
  * other layouts (row-major tables, untileable shapes): dequantize +
    torch.matmul, as the reference leaves them to XLA.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch
import torch.nn.functional as F

from ..gguf.constants import GGMLType
from ..quant.dequant import dequantize_tensor
from ..quant.repack import HIER_TYPES, PLANE_TYPES, extract_planes, extract_planes_hier
from .kernels import qmm as qmm_kernel

# at or above this many activation rows the JAX package routes quantized
# matmuls to XLA's dequant -> dot (qmm.py XLA_PREFILL_MIN_N); the port does
# the same with one dequantization and torch.matmul
XLA_PREFILL_MIN_N = 1024


@dataclass
class QuantTensor:
    """Block-scaled planes for a 2-D weight.

    Non-transposed: q [out, in], scales [out, in//g] (embedding tables).
    Transposed (matmul weights): q [in, out], scales [in//g, out].
    packed: q holds two 4-bit rows per byte, int8-viewed uint8 [in/2, out];
      row k in the low nibble, row k + in/2 in the high nibble (half-split),
      any value offset folded into the mins.
    out_dim: true output width when the O axis is zero-padded (vocab heads).
    d/dmin (hierarchical scales): scales holds int8 sub-scales and the
      effective scale is sub * d-expanded; mins holds int8 sub-mins with dmin
      pre-NEGATED, so min_eff = subm * dmin.
    """

    q: torch.Tensor
    scales: torch.Tensor
    mins: torch.Tensor | None
    group: int
    ggml_type: int
    transposed: bool = False
    packed: bool = False
    out_dim: int = 0
    d: torch.Tensor | None = None
    dmin: torch.Tensor | None = None
    sgroup: int = 256

    @property
    def hier(self) -> bool:
        return self.d is not None

    def eff_scales(self) -> torch.Tensor:
        """Effective per-group f32 scales [in//g, out] (transposed)."""
        if self.d is None:
            return self.scales.float()
        r = self.sgroup // self.group
        return self.scales.float() * self.d.float().repeat_interleave(r, dim=-2)

    def eff_mins(self) -> torch.Tensor | None:
        if self.mins is None:
            return None
        if self.d is None:
            return self.mins.float()
        r = self.sgroup // self.group
        return self.mins.float() * self.dmin.float().repeat_interleave(r, dim=-2)

    @property
    def out_features(self) -> int:
        if self.out_dim:
            return self.out_dim
        return self.q.shape[-1] if self.transposed else self.q.shape[-2]

    @property
    def in_features(self) -> int:
        k = self.q.shape[-2] if self.transposed else self.q.shape[-1]
        return k * 2 if self.packed else k

    def unpack_q(self) -> torch.Tensor:
        """Packed nibbles -> int8 rows [in, out]: low nibbles are rows
        [0, in/2), high nibbles rows [in/2, in)."""
        if not self.packed:
            raise ValueError("unpack_q needs nibble-packed planes")
        lo = self.q & 0xF
        hi = (self.q >> 4) & 0xF
        return torch.cat([lo, hi], dim=-2)

    def dequant(self, dtype=torch.bfloat16) -> torch.Tensor:
        """Dequantize to storage orientation: [out, in], or [in, out] when
        transposed. The arithmetic is f32 (q * scale + min), then one cast."""
        g = self.group
        scales = self.eff_scales()
        mins = self.eff_mins()
        if self.transposed:
            qsrc = self.unpack_q() if self.packed else self.q
            k, out = qsrc.shape
            w = qsrc.float().reshape(k // g, g, out) * scales[:, None, :]
            if mins is not None:
                w = w + mins[:, None, :]
            w = w.reshape(k, out)
            if self.out_dim and self.out_dim != out:
                w = w[:, : self.out_dim]
            return w.to(dtype)
        out, k = self.q.shape
        w = self.q.float().reshape(out, k // g, g) * scales[..., None]
        if mins is not None:
            w = w + mins[..., None]
        return w.reshape(out, k).to(dtype)

    def take_rows(self, ids: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
        """Gather + dequantize rows (embedding lookup; row-major flat scales)."""
        if self.transposed or self.d is not None:
            raise ValueError("take_rows needs row-major planes with flat scales")
        g = self.group
        q = self.q[ids].float()  # [..., k]
        sc = self.scales[ids].float()
        k = q.shape[-1]
        w = q.reshape(*q.shape[:-1], k // g, g) * sc[..., None]
        if self.mins is not None:
            w = w + self.mins[ids].float()[..., None]
        return w.reshape(q.shape).to(dtype)


Weight = QuantTensor | torch.Tensor


def _t(a: np.ndarray | None) -> np.ndarray | None:
    return None if a is None else np.ascontiguousarray(np.swapaxes(a, -1, -2))


def _pack_half_split(q: np.ndarray, off: int) -> np.ndarray:
    """[K, O] values in [0, 15] (after +off) -> [K/2, O] int8-viewed bytes,
    row k in the low nibble and row k + K/2 in the high nibble."""
    u = (q.astype(np.int16) + off).astype(np.uint8)
    half = u.shape[0] // 2
    return (u[:half] | (u[half:] << 4)).astype(np.uint8).view(np.int8)


def load_weight(
    raw: np.ndarray,
    ggml_dtype: GGMLType,
    shape: tuple[int, ...],
    prefer_quant: bool = True,
    dense_dtype=torch.bfloat16,
    transpose: bool = False,
    device: torch.device | str = "cpu",
) -> Weight:
    """GGUF raw bytes -> weight on `device` (planes or dense).

    Extraction runs on the host in numpy; each plane is copied host->device
    once. transpose=True stores planes in the matmul layout."""
    n = int(np.prod(shape))

    def dev(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(device)

    if (prefer_quant and transpose and len(shape) == 2
            and shape[-1] % 512 == 0 and ggml_dtype in HIER_TYPES):
        q, sub, d, subm, dm, g = extract_planes_hier(raw, ggml_dtype, n)
        O, K = shape
        q = _t(q.reshape(O, K))
        sub = _t(sub.reshape(O, K // g))
        d = _t(d.reshape(O, K // 256))
        subm = None if subm is None else _t(subm.reshape(O, K // g))
        dm = None if dm is None else _t(dm.reshape(O, K // 256))
        packed = False
        lo, hi = int(q.min()), int(q.max())
        if hi - lo <= 15 and q.shape[0] % 2 == 0 and (lo >= 0 or subm is None):
            off = -lo if lo < 0 or hi > 15 else 0
            q = _pack_half_split(q, off)
            if off:
                # fold the value offset into the (absent) mins in the
                # factored domain: min_eff = sub * (-off*d)
                subm = sub.copy()
                dm = (-float(off) * d).astype(np.float32)
            packed = True
        return QuantTensor(q=dev(q), scales=dev(sub), mins=dev(subm), group=g,
                           ggml_type=int(ggml_dtype), transposed=True, packed=packed,
                           d=dev(d), dmin=dev(dm), sgroup=256)
    if prefer_quant and ggml_dtype in PLANE_TYPES and shape[-1] % 256 == 0:
        q, sc, mn, g = extract_planes(raw, ggml_dtype, n)
        q = q.reshape(shape)
        sc = sc.reshape(*shape[:-1], shape[-1] // g)
        mn = None if mn is None else mn.reshape(*shape[:-1], shape[-1] // g)
        if transpose:
            q, sc, mn = _t(q), _t(sc), _t(mn)
        packed = False
        if transpose and q.ndim == 2:
            lo, hi = int(q.min()), int(q.max())
            if hi - lo <= 15 and q.shape[0] % 2 == 0:
                off = -lo if lo < 0 or hi > 15 else 0
                q = _pack_half_split(q, off)
                if off:
                    base = mn if mn is not None else 0.0
                    mn = (base - off * sc.astype(np.float32)).astype(np.float32)
                packed = True
        return QuantTensor(q=dev(q), scales=dev(sc), mins=dev(mn), group=g,
                           ggml_type=int(ggml_dtype), transposed=transpose, packed=packed)
    # dense fallback always stays [out, in] (matmul uses w.T)
    w = dequantize_tensor(raw, ggml_dtype, shape)
    return torch.from_numpy(w).to(device=device, dtype=dense_dtype)


def pad_out_features(qt: QuantTensor, multiple: int = 4096) -> QuantTensor:
    """Zero-pad a 2-D transposed plane's O axis to a multiple (vocab heads
    such as 128256 wide). Pad columns dequantize to 0 and matmul slices them
    away via out_dim."""
    if not (qt.transposed and qt.q.ndim == 2):
        raise ValueError("pad_out_features needs a 2-D transposed plane")
    o = qt.q.shape[1]
    o_pad = (o + multiple - 1) // multiple * multiple
    if o_pad == o:
        return qt

    def pad(t):
        return None if t is None else F.pad(t, (0, o_pad - o))

    return replace(qt, q=pad(qt.q), scales=pad(qt.scales), mins=pad(qt.mins),
                   d=pad(qt.d), dmin=pad(qt.dmin), out_dim=o)


def matmul(x: torch.Tensor, w: Weight, dtype=None, kernels: bool = True) -> torch.Tensor:
    """y = x @ W.T with W in [out, in] orientation (ggml mul_mat convention),
    f32 accumulation, cast to `dtype` (default: x's dtype). kernels=False
    takes the plain dequant -> matmul route for every row count (the
    reference path a kernel run is held against)."""
    out_dtype = dtype or x.dtype
    if isinstance(w, QuantTensor):
        rows = x.numel() // w.in_features
        if kernels and rows < XLA_PREFILL_MIN_N and qmm_kernel.dispatches(w):
            return qmm_kernel.qmm(x.to(torch.bfloat16), w).to(out_dtype)
        mdt = torch.float32 if x.dtype == torch.float32 else torch.bfloat16
        wd = w.dequant(mdt)
        if not w.transposed:
            wd = wd.t()
        return torch.matmul(x.to(mdt).float(), wd.float()).to(out_dtype)
    xin = x.to(w.dtype) if w.dtype == torch.bfloat16 else x
    return torch.matmul(xin.float(), w.float().t()).to(out_dtype)


def embed_lookup(table: Weight, ids: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    if isinstance(table, QuantTensor):
        return table.take_rows(ids, dtype)
    return table[ids].to(dtype)
