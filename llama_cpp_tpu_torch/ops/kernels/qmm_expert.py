"""Indexed-expert fused dequantize + matmul over stacked int8 planes
(csrc/qmm_expert.cu), with its plain PyTorch version: row r of the output is
x[r] . W[ids[r]], the MoE decode product.

Port of the TPU kernel qmm_planes_expert of llama_cpp_tpu/ops/pallas/qmm.py
(the 8-sublane replica of x that the TPU tiling needs is not carried over).
The plain version is that kernel's arithmetic: W = bf16(q * scale) with the
product in f32, y = bf16(x) . W accumulated in f32, plus the affine term
(group sums of x) . mins in f32. The CUDA kernel keeps q * scale in f32, an
NMSE near 1e-6 from the plain version.

Bound on an H100: bytes, each distinct expert's planes (int8 q + f32 scales
and mins) read once. The kernel finds the rows that share an expert itself
and reads that expert once for up to four of them; the wrapper takes the
plain version for a CPU tensor and launches the kernel for a CUDA tensor.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_COLS = 128  # output columns per block
_SPLIT_UNIT = 64  # K splits fall on multiples of 64 rows
_TARGET_WARPS = 4096  # ~31 one-warp blocks per SM on 132 SMs before splitting K stops
_MAX_ROWS = 65535  # the grid's y extent

launches = {"qmm_planes_expert": 0}


def supported(w) -> bool:
    """Whether the kernel takes this weight: a 3-D stack of transposed int8
    planes [E, K, O] with flat f32 scales, groups of 16 or 32, K a multiple
    of 256 and O of 128 (never nibble-packed, never per-256 superblocks)."""
    if not w.transposed or w.q.dim() != 3 or w.packed or w.hier:
        return False
    if w.group not in (16, 32):
        return False
    return w.q.shape[1] % 256 == 0 and w.q.shape[2] % _COLS == 0


def qmm_expert_plain(x: torch.Tensor, ids: torch.Tensor, w) -> torch.Tensor:
    """x [R, K], ids [R] -> [R, O] f32 by the TPU kernel's arithmetic on the
    gathered experts (never the whole stack)."""
    R, K = x.shape
    g = w.group
    idx = ids.long()
    q = w.q[idx].float()  # [R, K, O]
    O = q.shape[-1]
    sc = w.scales[idx].float()  # [R, K/g, O]
    wd = (q.reshape(R, K // g, g, O) * sc[:, :, None, :]).reshape(R, K, O)
    xb = x.to(torch.bfloat16).float()
    y = torch.einsum("rk,rko->ro", xb, wd.to(torch.bfloat16).float())
    if w.mins is not None:
        xg = xb.reshape(R, K // g, g).sum(dim=-1)
        y = y + torch.einsum("rg,rgo->ro", xg, w.mins[idx].float())
    return y


def split_count(K: int, O: int, n_rows: int) -> int:
    """K splits for the kernel grid: enough one-warp blocks to fill the card
    (at most one leading block per row), on multiples of 64 plane rows."""
    units = K // _SPLIT_UNIT
    blocks = (O // _COLS) * n_rows
    best = 1
    for s in range(2, units + 1):
        if blocks * s > _TARGET_WARPS:
            break
        if units % s == 0:
            best = s
    return best


def _lib():
    fn = build.library("qmm_expert.cu").qmm_expert_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def qmm_expert(x: torch.Tensor, ids: torch.Tensor, w) -> torch.Tensor:
    """y[r] = x[r] . W[ids[r]] for a stacked transposed-plane QuantTensor:
    x [R, K] bf16, ids [R] int32 -> [R, O] f32."""
    if x.device.type == "cpu":
        return qmm_expert_plain(x, ids, w)
    if x.device.type != "cuda" or not supported(w):
        raise ValueError(f"qmm_expert: needs CUDA tensors and a 3-D stack of transposed int8 "
                         f"planes with flat scales, K % 256 == 0, O % 128 == 0 (got {x.device}, "
                         f"packed={w.packed}, hier={w.hier}, group={w.group}, "
                         f"shape={tuple(w.q.shape)})")
    E, K, O = w.q.shape
    if x.dtype != torch.bfloat16 or x.dim() != 2 or x.shape[1] != K or not x.is_contiguous():
        raise ValueError(f"qmm_expert: x must be a contiguous CUDA bf16 [R, {K}] tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    R = x.shape[0]
    if not 0 < R <= _MAX_ROWS:
        raise ValueError(f"qmm_expert: 1 to {_MAX_ROWS} rows, got {R}")
    if (ids.device != x.device or ids.dtype != torch.int32 or tuple(ids.shape) != (R,)
            or not ids.is_contiguous()):
        raise ValueError(f"qmm_expert: ids must be a contiguous int32 [{R}] tensor on "
                         f"{x.device}, got {ids.dtype} {tuple(ids.shape)} on {ids.device}")
    G = K // w.group
    for name, t, dt, shape in (("q", w.q, torch.int8, (E, K, O)),
                               ("scales", w.scales, torch.float32, (E, G, O)),
                               ("mins", w.mins, torch.float32, (E, G, O))):
        if t is None:
            continue
        if (t.device != x.device or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"qmm_expert: {name} must be a contiguous, 16-byte aligned {dt} "
                             f"{shape} tensor on {x.device}")
    splits = split_count(K, O, R)
    out = torch.empty((R, O), dtype=torch.float32, device=x.device)
    part = (torch.empty((splits, R, O), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    err = _lib()(x.data_ptr(), ids.data_ptr(), w.q.data_ptr(), w.scales.data_ptr(),
                 None if w.mins is None else w.mins.data_ptr(),
                 None if part is None else part.data_ptr(), out.data_ptr(), R, E, K, O,
                 w.group, splits, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "qmm_expert_launch")
    launches["qmm_planes_expert"] += 1
    return out
