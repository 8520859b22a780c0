"""Quantized weight as block-scaled int8 planes in torch tensors, plus the
matmul route.

A weight W[out, in] is stored as q(int8) with per-group scales (+ mins),
produced once at load by quant/repack.py from any of the 21 plane types
(the legacy 32-element quants, the K-quants, IQ4_NL/IQ4_XS, the IQ2/IQ3/
IQ1_S codebooks, MXFP4, TQ2_0, Q8_K). Matmul weights keep the JAX package's
transposed layout: q [in, out], scales [in//g, out]; for the six
superblock types (Q2_K-Q6_K, IQ4_XS) at K a multiple of 512 the scales are
hierarchical (int8 sub-scales with f32 d/dmin [in//256, out]); any plane
whose values span at most 16 levels (Q4_0, Q4_1, Q2_K, Q3_K, Q4_K, TQ2_0,
IQ1_S) is nibble-packed half-split into qp [in/2, out] with its offset
folded into the mins. The dequant-only types (Q8_1, IQ1_M, TQ1_0, NVFP4,
Q1_0, Q2_0), like the dense types, load as bf16 weights. The route per
call:
  * rows >= XLA_PREFILL_MIN_N: dequantize, a slab of columns at a time, and
    a library product (the JAX package leaves these to XLA's dot of bf16
    operands into f32: on the card cuBLAS from bf16 operands with an f32
    output; on the CPU the f32 product, the parity reference);
  * fewer rows, where the JAX package's dispatch runs its Pallas kernel:
    the qmm kernel (ops/kernels/qmm.py), which takes its plain version for a
    CPU tensor and raises on a CUDA tensor it cannot take;
  * other layouts (row-major tables, untileable shapes, dense weights): the
    same library route, as the reference leaves them to XLA;
  * a LoraWeight: its base by the route above, plus the low-rank delta as
    two library products of bf16 operands.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch
import torch.nn.functional as F

from ..gguf.constants import GGMLType
from ..quant import device_planes
from ..quant.dequant import dequantize_tensor
from ..quant.repack import HIER_TYPES, PLANE_TYPES, extract_planes, extract_planes_hier
from .kernels import qmm as qmm_kernel
from .kernels import qmm_expert as expert_kernel

# at or above this many activation rows the JAX package routes quantized
# matmuls to XLA's dequant -> dot (qmm.py XLA_PREFILL_MIN_N); the port does
# the same with a dequantization and a library product
XLA_PREFILL_MIN_N = 1024
LIBRARY_SLAB = 4096  # weight columns dequantized at a time for the library product


@dataclass
class QuantTensor:
    """Block-scaled planes for a 2-D weight, or for a 3-D stack of expert
    weights.

    Non-transposed: q [out, in], scales [out, in//g] (embedding tables).
    Transposed (matmul weights): q [in, out], scales [in//g, out].
    Stacked experts (3-D, transposed): q [E, in, out] int8 with flat f32
      scales (and mins) [E, in//g, out]; never nibble-packed and never
      hierarchical (both layouts are 2-D only).
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

    def column_slab(self, o0: int, o1: int) -> "QuantTensor":
        """Output columns [o0, o1) of a 2-D weight, as views of its planes."""
        if self.q.ndim != 2:
            raise ValueError("column_slab takes a 2-D weight")

        def cut(t):
            if t is None:
                return None
            return t[:, o0:o1] if self.transposed else t[o0:o1]

        return replace(self, q=cut(self.q), scales=cut(self.scales), mins=cut(self.mins),
                       d=cut(self.d), dmin=cut(self.dmin), out_dim=0)

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
        transposed (a 3-D stack keeps its leading expert axis). The
        arithmetic is f32 (q * scale + min), then one cast."""
        g = self.group
        scales = self.eff_scales()
        mins = self.eff_mins()
        if self.transposed:
            qsrc = self.unpack_q() if self.packed else self.q
            *lead, k, out = qsrc.shape
            w = qsrc.float().reshape(*lead, k // g, g, out) * scales[..., :, None, :]
            if mins is not None:
                w = w + mins[..., :, None, :]
            w = w.reshape(*lead, k, out)
            if self.out_dim and self.out_dim != out:
                w = w[..., : self.out_dim]
            return w.to(dtype)
        *lead, out, k = self.q.shape
        w = self.q.float().reshape(*lead, out, k // g, g) * scales[..., None]
        if mins is not None:
            w = w + mins[..., None]
        return w.reshape(*lead, out, k).to(dtype)

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


@dataclass
class LoraWeight:
    """A base weight and a low-rank delta applied at matmul time
    (build_lora_mm analog, reference src/llama-graph.h:1018):
    y = x @ base^T + scale * (x @ a^T) @ b^T with a [r, in], b [out, r] in
    bf16. The base keeps its own route: a QuantTensor takes its qmm kernel
    or the library product, a dense weight the library product."""

    base: "QuantTensor | torch.Tensor"
    a: torch.Tensor
    b: torch.Tensor
    scale: float  # adapter scale * alpha / rank


Weight = QuantTensor | LoraWeight | torch.Tensor


def _t(a: torch.Tensor | None) -> torch.Tensor | None:
    """Swap the last two axes into a new contiguous tensor, on a's device."""
    return None if a is None else a.transpose(-1, -2).contiguous()


def _pack_half_split(q: torch.Tensor, off: int) -> torch.Tensor:
    """[K, O] values in [0, 15] (after +off) -> [K/2, O] int8-viewed bytes,
    row k in the low nibble and row k + K/2 in the high nibble. The offset
    is added in uint8 (mod 256), which leaves values in [0, 15] exact."""
    u = q.view(torch.uint8) + (off & 0xFF)
    half = u.shape[0] // 2
    return (u[:half] | (u[half:] << 4)).view(torch.int8)


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

    Extraction runs on the host in numpy, and the planes go to the device as
    the file lays them out; on the card the usual types (Q4_K and Q6_K
    hierarchical, the flat types of device_planes.MATRIX_PLANE_TYPES, and
    the expert stacks) go up as raw blocks and are cut there instead
    (quant/device_planes.py), the same values. transpose=True swaps the
    planes into the matmul layout (and packs nibbles) on the device."""
    n = int(np.prod(shape))
    on_card = device_planes.cuts_on(device)

    def dev(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(device)

    if (prefer_quant and transpose and len(shape) == 2
            and shape[-1] % 512 == 0 and ggml_dtype in HIER_TYPES):
        O, K = shape
        if on_card and ggml_dtype in device_planes.MATRIX_HIER_TYPES:
            q, sub, d, subm, dm, g = device_planes.matrix_hier(raw, ggml_dtype, shape, device)
        else:
            q, sub, d, subm, dm, g = extract_planes_hier(raw, ggml_dtype, n)
            q, sub, d = dev(q.reshape(O, K)), dev(sub.reshape(O, K // g)), dev(d.reshape(O, -1))
            subm = None if subm is None else dev(subm.reshape(O, K // g))
            dm = None if dm is None else dev(dm.reshape(O, -1))
        q, sub, d, subm, dm = _t(q), _t(sub), _t(d), _t(subm), _t(dm)
        packed = False
        lo, hi = int(q.min()), int(q.max())
        if hi - lo <= 15 and q.shape[0] % 2 == 0 and (lo >= 0 or subm is None):
            off = -lo if lo < 0 or hi > 15 else 0
            q = _pack_half_split(q, off)
            if off:
                # fold the value offset into the (absent) mins in the
                # factored domain: min_eff = sub * (-off*d)
                subm = sub.clone()
                dm = -float(off) * d
            packed = True
        return QuantTensor(q=q, scales=sub, mins=subm, group=g,
                           ggml_type=int(ggml_dtype), transposed=True, packed=packed,
                           d=d, dmin=dm, sgroup=256)
    # the JAX package keeps planes for rows a multiple of 256; a transposed
    # expert stack of a flat type also at the other widths the indexed-expert
    # kernel takes (gpt-oss's MXFP4 stacks of 2880), where the JAX loader
    # falls back to dense bf16: the same values (its plain product rounds
    # q * scale to bf16 as the dense load rounds the dequantized weight)
    stack64 = (len(shape) == 3 and transpose
               and expert_kernel.takes_widths(shape[-1], shape[-2]))
    if prefer_quant and ggml_dtype in PLANE_TYPES and (shape[-1] % 256 == 0 or stack64):
        if (transpose and len(shape) == 3 and on_card
                and ggml_dtype in device_planes.DEVICE_PLANE_TYPES):
            # expert stacks of the usual types: the raw blocks go up and are
            # cut into planes on the card, the same values as the host's
            # extraction (which took most of a large MoE file's load)
            q, sc, mn, g = device_planes.expert_stack(raw, ggml_dtype, shape, device)
            return QuantTensor(q=q, scales=sc, mins=mn, group=g, ggml_type=int(ggml_dtype),
                               transposed=True)
        if on_card and len(shape) == 2 and ggml_dtype in device_planes.MATRIX_PLANE_TYPES:
            q, sc, mn, g = device_planes.matrix_flat(raw, ggml_dtype, shape, device)
        else:
            q, sc, mn, g = extract_planes(raw, ggml_dtype, n)
            q = dev(q.reshape(shape))
            sc = dev(sc.reshape(*shape[:-1], shape[-1] // g))
            mn = None if mn is None else dev(mn.reshape(*shape[:-1], shape[-1] // g))
        if transpose:
            q, sc, mn = _t(q), _t(sc), _t(mn)
        packed = False
        if transpose and q.ndim == 2:
            lo, hi = int(q.min()), int(q.max())
            if hi - lo <= 15 and q.shape[0] % 2 == 0:
                off = -lo if lo < 0 or hi > 15 else 0
                q = _pack_half_split(q, off)
                if off:
                    mn = (mn if mn is not None else 0.0) - off * sc
                packed = True
        return QuantTensor(q=q, scales=sc, mins=mn, group=g,
                           ggml_type=int(ggml_dtype), transposed=transpose, packed=packed)
    if ggml_dtype in PLANE_TYPES and shape[-1] % 256 == 0:
        # a dense weight of a plane type (prefer_quant=False): its row-major
        # planes go to the device and are dequantized there, bit for bit the
        # host's dequantize_tensor (f32 arithmetic, one cast), at the copy
        # cost of the planes instead of f32 values
        qt = load_weight(raw, ggml_dtype, shape, prefer_quant=True, device=device)
        return qt.dequant(dense_dtype)
    # dense fallback always stays [out, in] (matmul uses w.T)
    w = dequantize_tensor(raw, ggml_dtype, shape)
    return torch.from_numpy(w).to(device=device, dtype=dense_dtype)


def pad_out_features(qt: QuantTensor, multiple: int = 4096) -> QuantTensor:
    """Zero-pad a 2-D transposed plane's O axis to a multiple (vocab heads
    such as 128256 wide). Pad columns dequantize to 0 and matmul slices them
    away via out_dim."""
    if not (qt.transposed and qt.q.ndim == 2):
        raise ValueError(f"pad_out_features needs a 2-D transposed plane, got "
                         f"{'transposed' if qt.transposed else 'row-major'} planes of shape "
                         f"{tuple(qt.q.shape)} (stacked expert planes are not padded)")
    o = qt.q.shape[1]
    o_pad = (o + multiple - 1) // multiple * multiple
    if o_pad == o:
        return qt

    def pad(t):
        return None if t is None else F.pad(t, (0, o_pad - o))

    return replace(qt, q=pad(qt.q), scales=pad(qt.scales), mins=pad(qt.mins),
                   d=pad(qt.d), dmin=pad(qt.dmin), out_dim=o)


def dot_f32(x: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    """x [N, K] . wd [K, O] (or a batch: [C, N, K] . [C, K, O]) -> f32, both
    in one dtype: the reference's
    jnp.dot(..., preferred_element_type=f32). bf16 operands on the card go
    to cuBLAS with an f32 output, so the sums and any split-K partials stay
    f32 whatever allow_bf16_reduced_precision_reduction says; otherwise (the
    CPU, or f32 operands) the f32 product."""
    if x.device.type == "cuda" and x.dtype == torch.bfloat16:
        if x.dim() == 3:  # a batch of products [C, N, K] . [C, K, O]
            return torch.bmm(x, wd, out_dtype=torch.float32)
        return torch.mm(x, wd, out_dtype=torch.float32)
    return torch.matmul(x.float(), wd.float())


def _library_matmul(x: torch.Tensor, w: QuantTensor, mdt: torch.dtype) -> torch.Tensor:
    """x . W by dequantize -> dot_f32, [..., in] -> [..., out] f32. The
    weight is dequantized LIBRARY_SLAB columns at a time, so no whole copy
    of it (in f32 or bf16) is made."""
    x2 = x.to(mdt).reshape(-1, w.in_features)
    O = w.out_features
    out = torch.empty((x2.shape[0], O), dtype=torch.float32, device=x.device)
    for o0 in range(0, O, LIBRARY_SLAB):
        o1 = min(o0 + LIBRARY_SLAB, O)
        wd = w.column_slab(o0, o1).dequant(mdt)
        out[:, o0:o1] = dot_f32(x2, wd if w.transposed else wd.t())
    return out.reshape(*x.shape[:-1], O)


def matmul(x: torch.Tensor, w: Weight, dtype=None, kernels: bool = True) -> torch.Tensor:
    """y = x @ W.T with W in [out, in] orientation (ggml mul_mat convention),
    f32 accumulation, cast to `dtype` (default: x's dtype). kernels=False
    takes the plain dequant -> matmul route for every row count (the
    reference path a kernel run is held against)."""
    out_dtype = dtype or x.dtype
    if isinstance(w, LoraWeight):
        # the low-rank delta is the JAX package's plain XLA product: bf16
        # operands, f32 sums, the rank-r intermediate rounded to bf16
        y = matmul(x, w.base, dtype=torch.float32, kernels=kernels)
        x2 = x.to(torch.bfloat16).reshape(-1, w.a.shape[1])
        h = dot_f32(x2, w.a.t())
        delta = dot_f32(h.to(torch.bfloat16), w.b.t())
        return (y + w.scale * delta.reshape(y.shape)).to(out_dtype)
    if isinstance(w, QuantTensor):
        rows = x.numel() // w.in_features
        if kernels and rows < XLA_PREFILL_MIN_N and qmm_kernel.dispatches(w):
            return qmm_kernel.qmm(x.to(torch.bfloat16), w).to(out_dtype)
        mdt = torch.float32 if x.dtype == torch.float32 else torch.bfloat16
        return _library_matmul(x, w, mdt).to(out_dtype)
    if w.dtype == torch.bfloat16:
        # a dense weight (--no-quant): the library product of bf16 operands
        # into f32, where the JAX package leaves it to XLA's dot
        y = dot_f32(x.to(torch.bfloat16).reshape(-1, w.shape[1]), w.t())
        return y.reshape(*x.shape[:-1], w.shape[0]).to(out_dtype)
    return torch.matmul(x.float(), w.float().t()).to(out_dtype)


def embed_lookup(table: Weight, ids: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    if isinstance(table, QuantTensor):
        return table.take_rows(ids, dtype)
    return table[ids].to(dtype)
