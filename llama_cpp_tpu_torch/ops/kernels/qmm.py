"""Fused dequantize + matmul over block-scaled weight planes
(csrc/qmm.cu, csrc/qmm_prefill.cu), with its plain PyTorch version.

Port of the TPU kernels qmm4_planes / qmm4_planes_prefill (packed 4-bit,
Q4_K) and qmm_planes / qmm_planes_prefill (int8 planes, Q6_K) of
llama_cpp_tpu/ops/pallas/qmm.py. The plain version is the JAX package's
dequant -> dot: W = bf16(q * scale + min) in f32 arithmetic, y = bf16(x) . W
accumulated in f32. Three CUDA kernels compute it, by row count N:
  * N <= GEMV_MAX_N: a CUDA-core GEMV that keeps q * scale in f32 and applies
    scale and min per group (an NMSE near 1e-6 from the plain version);
  * up to PREFILL_MIN_N - 1: an mma.sync GEMM that rounds W as the plain
    version does;
  * from PREFILL_MIN_N: the wgmma GEMM of csrc/qmm_prefill.cu, which rounds
    packed planes' scale and min to bf16 before W (an NMSE near 3e-5 on
    quantized weights) and int8 planes' W as the plain version does.
The wrapper takes the plain version for a CPU tensor and launches a kernel
for a CUDA tensor.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import build

# the JAX package's decode/prefill tile-policy boundary (qmm.py
# PREFILL_MIN_N): launches are named by TPU kernel from it, and from it the
# wgmma prefill GEMM runs
PREFILL_MIN_N = 64
GEMV_MAX_N = 4  # the kernel's CUDA-core GEMV up to here, tensor cores above
_GEMV_MAX_N_BUILT = 8  # the widest GEMV the kernel has
_SPLIT_UNIT = 64  # K splits fall on multiples of 64 rows
_COLS = 128  # output columns per block
_TARGET_WARPS = 4096  # ~31 warps per SM on 132 SMs before splitting K stops

# the wgmma prefill GEMM (csrc/qmm_prefill.cu) and the model its grid is
# planned by: a block is 128 rows x 128 columns, a step 64 of K
_SMS = 132
_PREFILL_BM = 128
_PREFILL_BK = 64
# a step of a block at the bf16 peak: 2 * 128 * 128 * 64 flops over 989/132
# TFLOP/s; pipeline fill and epilogue as steps; device memory bytes per us
_STEP_US = 2 * _PREFILL_BM * _COLS * _PREFILL_BK / (989e12 / _SMS) * 1e6
_FILL_STEPS = 4
_BYTES_PER_US = 3.35e6

# launches per (TPU kernel stood in for, CUDA kernel that ran): the GEMV,
# the mma.sync GEMM ("mma") or the wgmma GEMM ("wgmma")
launches = {"qmm4_planes/gemv": 0, "qmm4_planes/mma": 0, "qmm4_planes_prefill/mma": 0,
            "qmm4_planes_prefill/wgmma": 0, "qmm_planes/gemv": 0, "qmm_planes/mma": 0,
            "qmm_planes_prefill/mma": 0, "qmm_planes_prefill/wgmma": 0}


def kernel_name(w, n_rows: int, gemv_max_n: int = GEMV_MAX_N,
                prefill_min_n: int = PREFILL_MIN_N) -> str:
    base = "qmm4_planes" if w.packed else "qmm_planes"
    tpu = base + ("_prefill" if n_rows >= PREFILL_MIN_N else "")
    if n_rows <= gemv_max_n:
        return tpu + "/gemv"
    return tpu + ("/wgmma" if n_rows >= prefill_min_n else "/mma")


def dispatches(w) -> bool:
    """Whether the JAX package's pallas_qmm_dispatch (qmm.py:935-948) sends
    this weight to its Pallas kernel below XLA_PREFILL_MIN_N rows. There the
    port launches its kernel or raises; elsewhere the reference leaves the
    product to XLA, and the port to dequantize + matmul."""
    if not w.transposed or w.q.dim() != 2:
        return False
    K, O = w.in_features, w.q.shape[1]
    if w.hier and K % 512:
        return False
    return K % 256 == 0 and O % _COLS == 0 and (K // w.group) % 8 == 0


def supported(w) -> bool:
    """Whether the kernel takes this weight: 2-D transposed planes, packed or
    int8, groups of 16 or 32, flat scales or per-256 superblocks, K a
    multiple of 256 and O of 128."""
    if not w.transposed or w.q.dim() != 2 or w.group not in (16, 32):
        return False
    if w.hier and w.sgroup != 256:
        return False
    return w.in_features % 256 == 0 and w.q.shape[1] % _COLS == 0


def qmm_plain(x: torch.Tensor, w) -> torch.Tensor:
    """[..., K] -> [..., out_features] f32: dequantize, then f32 matmul of
    bf16 values."""
    K = w.in_features
    y = torch.matmul(x.reshape(-1, K).to(torch.bfloat16).float(),
                     w.dequant(torch.bfloat16).float())
    return y.reshape(*x.shape[:-1], w.out_features)


def split_count(K: int, packed: bool, n: int, O: int, weight_bytes: int,
                gemv: bool) -> int:
    """K splits for the kernel grid: enough warps to fill the card, splits on
    multiples of 64 rows (plane rows for the GEMV, K for the GEMM). The
    GEMV, bound by weight bytes, keeps its partial sums under a quarter of
    the weight's bytes; the GEMM is bound by operations."""
    if gemv:  # one-warp blocks over plane rows
        units, warps = (K // 2 if packed else K) // _SPLIT_UNIT, O // _COLS
        max_partial = weight_bytes // 4
    else:  # four-warp blocks of 16, 32 or 64 rows over K
        bm = 16 if n <= 16 else 32 if n <= 32 else 64
        units, warps = K // _SPLIT_UNIT, 4 * (O // _COLS) * -(-n // bm)
        max_partial = 16 * n * O * 4
    best = 1
    for s in range(2, units + 1):
        if units % s:
            continue
        if warps * s > _TARGET_WARPS or s * n * O * 4 > max_partial:
            break
        best = s
    return best


@dataclass(frozen=True)
class PrefillPlan:
    """Grid of the wgmma prefill GEMM: row and column blocks, K splits (each
    `steps` steps of 64), and why the grid is short of the card's SMs when
    it is ('' when it fills them)."""
    row_blocks: int
    col_blocks: int
    splits: int
    steps: int
    note: str

    @property
    def blocks(self) -> int:
        return self.row_blocks * self.col_blocks * self.splits


def prefill_plan(n: int, K: int, O: int, packed: bool) -> PrefillPlan:
    """K splits for the wgmma GEMM at n rows of x: the count of 64-row plane
    blocks (K/2 plane rows packed, K int8) that minimises a model of the
    time: whole waves of blocks over 132 SMs, each block's steps (two a
    plane block when packed) plus pipeline fill at the bf16 peak, plus the
    partial sums' device-memory traffic (written, read, summed) when split."""
    rows, cols = -(-n // _PREFILL_BM), O // _COLS
    units = (K // 2 if packed else K) // _SPLIT_UNIT
    per_unit = 2 if packed else 1
    best = None
    for s in range(1, units + 1):
        if units % s:
            continue
        blocks = rows * cols * s
        t = -(-blocks // _SMS) * (units // s * per_unit + _FILL_STEPS) * _STEP_US
        if s > 1:
            t += (2 * s + 1) * n * O * 4 / _BYTES_PER_US
        if best is None or t < best[0]:
            best = (t, s)
    s = best[1]
    blocks = rows * cols * s
    note = ""
    if blocks < _SMS:
        more = [d for d in range(s + 1, units + 1) if units % d == 0]
        note = (f"{units} plane blocks of 64 rows admit no split above {s}" if not more else
                f"{more[0]} splits would cost more in partial sums and fill than "
                f"{_SMS - blocks} idle SMs")
    return PrefillPlan(rows, cols, s, units // s * per_unit, note)


def _lib():
    lib = build.library("qmm.cu")
    fn = lib.qmm_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _prefill_lib():
    fn = build.library("qmm_prefill.cu").qmm_prefill_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def qmm(x: torch.Tensor, w, gemv_max_n: int = GEMV_MAX_N,
        prefill_min_n: int = PREFILL_MIN_N) -> torch.Tensor:
    """y = x . W for a transposed-plane QuantTensor: [..., K] bf16 ->
    [..., out_features] f32. Up to gemv_max_n rows (at most 8) the GEMV
    runs, from prefill_min_n rows the wgmma GEMM, between them the mma.sync
    GEMM; the defaults are the measured GEMV crossover (chip_smoke.py times
    both) and the JAX package's prefill boundary."""
    if x.device.type == "cpu":
        return qmm_plain(x, w)
    if not 0 <= gemv_max_n <= _GEMV_MAX_N_BUILT:
        raise ValueError(f"qmm: gemv_max_n must be in [0, {_GEMV_MAX_N_BUILT}]")
    if prefill_min_n < 1:
        raise ValueError("qmm: prefill_min_n must be at least 1")
    K = w.in_features
    O = w.q.shape[1]
    if x.device.type != "cuda" or x.dtype != torch.bfloat16 or x.shape[-1] != K:
        raise ValueError(f"qmm: x must be a CUDA bf16 [..., {K}] tensor, got "
                         f"{x.device} {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("qmm: x must be contiguous")
    if not supported(w):
        raise ValueError(f"qmm: unsupported weight layout (packed={w.packed}, "
                         f"group={w.group}, hier={w.hier}, shape={tuple(w.q.shape)})")
    planes = (w.q, w.scales, w.mins, w.d, w.dmin)
    for t in planes:
        if t is None:
            continue
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("qmm: weight planes must be contiguous, 16-byte aligned "
                             "and on the activation's device")
    sc_dtype = torch.int8 if w.hier else torch.float32
    if w.q.dtype != torch.int8 or w.scales.dtype != sc_dtype or (
            w.mins is not None and w.mins.dtype != sc_dtype):
        raise ValueError("qmm: plane dtypes do not match the layout")
    x2 = x.reshape(-1, K)
    N = x2.shape[0]
    gemv = N <= gemv_max_n
    if not gemv and x2.data_ptr() % 16:
        raise ValueError("qmm: x must be 16-byte aligned for the tensor-core path")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if not gemv and N >= prefill_min_n:
        splits = prefill_plan(N, K, O, w.packed).splits
    else:
        wbytes = sum(t.numel() * t.element_size() for t in planes if t is not None)
        splits = split_count(K, w.packed, N, O, wbytes, gemv)
    out = torch.empty((N, O), dtype=torch.float32, device=x.device)
    part = (torch.empty((splits, N, O), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    args = (x2.data_ptr(), w.q.data_ptr(), w.scales.data_ptr(), _ptr(w.d), _ptr(w.mins),
            _ptr(w.dmin), _ptr(part), out.data_ptr(), N, K, O, w.group, int(w.packed),
            int(w.hier), splits)
    if not gemv and N >= prefill_min_n:
        build.check(_prefill_lib()(*args, stream), "qmm_prefill_launch")
    else:
        build.check(_lib()(*args, gemv_max_n, stream), "qmm_launch")
    launches[kernel_name(w, N, gemv_max_n, prefill_min_n)] += 1
    if w.out_dim and w.out_dim != O:
        out = out[:, : w.out_dim]
    return out.reshape(*x.shape[:-1], w.out_features)
