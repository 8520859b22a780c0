"""Fused dequantize + matmul over block-scaled weight planes
(csrc/qmm_decode.cu, csrc/qmm_prefill.cu), with its plain PyTorch version.

Port of the TPU kernels qmm4_planes / qmm4_planes_prefill (packed 4-bit,
Q4_K) and qmm_planes / qmm_planes_prefill (int8 planes, Q6_K) of
llama_cpp_tpu/ops/pallas/qmm.py. The plain version is the JAX package's
dequant -> dot: W = bf16(q * scale + min) in f32 arithmetic, y = bf16(x) . W
accumulated in f32. CUDA kernels compute it, by row count N:
  * N < PREFILL_MIN_N: the decode kernel of csrc/qmm_decode.cu: up to 8
    rows q stays exact and each group's f32 sum is scaled once (an NMSE near
    1e-6 from the plain version), from 9 rows W is formed in bf16 from a
    bf16-rounded scale and min (near 1e-5);
  * from PREFILL_MIN_N: the wgmma GEMM of csrc/qmm_prefill.cu, which rounds
    packed planes' scale and min to bf16 before W (an NMSE near 3e-5 on
    quantized weights) and int8 planes' W as the plain version does.
The wrapper takes the plain version for a CPU tensor and launches a kernel
for a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from . import build, scratch

# the JAX package's decode/prefill tile-policy boundary (qmm.py
# PREFILL_MIN_N): launches are named by TPU kernel from it, and from it the
# wgmma prefill GEMM runs
PREFILL_MIN_N = 64
_SPLIT_UNIT = 64  # K splits fall on multiples of 64 rows
_COLS = 128  # output columns per block

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

# launches per (TPU kernel stood in for, CUDA kernel that ran): the decode
# kernel below PREFILL_MIN_N rows, the wgmma GEMM from it
launches = {"qmm4_planes/decode": 0, "qmm4_planes_prefill/wgmma": 0,
            "qmm_planes/decode": 0, "qmm_planes_prefill/wgmma": 0}


def kernel_name(w, n_rows: int) -> str:
    """The launch counter's name: the TPU kernel stood in for / the CUDA
    kernel that runs n_rows of x."""
    if n_rows >= PREFILL_MIN_N:
        return ("qmm4_planes" if w.packed else "qmm_planes") + "_prefill/wgmma"
    return ("qmm4_planes" if w.packed else "qmm_planes") + "/decode"


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


@functools.lru_cache(maxsize=None)
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


# the decode kernel (csrc/qmm_decode.cu): a block is 128 columns over a
# range of K in stages of 64 plane rows, 8 consumer warps and a producer warp
_SMEM_PER_SM = 233472  # bytes of shared memory an H100 SM has for blocks
_DECODE_WARPS = 8


def decode_tiles(n: int) -> int:
    """n-tiles of 8 rows the decode kernel is built for at n rows: 1, 2, 4
    or 8 (rows past n are zero and not stored)."""
    return 1 if n <= 8 else 2 if n <= 16 else 4 if n <= 32 else 8


@functools.lru_cache(maxsize=None)
def decode_smem(nt: int, packed: bool, group: int) -> tuple[int, int]:
    """(stages, shared memory bytes) of one block (csrc/qmm_decode.cu
    Layout): per stage 8 KB of plane rows, 4 KB of scale rows and an x tile
    of 8 nt rows x 64 k per half; each warp's f32 scales and mins of its
    groups and columns of a stage; four stages where two blocks still fit
    an SM, else three."""
    halves = 2 if packed else 1
    warp_chunks = 64 // group // (1 if nt >= 8 else 2)
    warp_cols = 16 if nt >= 8 else 32
    scratch = _DECODE_WARPS * warp_chunks * halves * 2 * warp_cols * 4
    stage = 8192 + halves * (4096 + nt * 1024)
    stages = 4 if nt < 8 and 2 * (4 * stage + scratch + 64 + 2048) <= _SMEM_PER_SM else 3
    return stages, stages * stage + scratch + 16 * stages + 1024


@dataclass(frozen=True)
class DecodePlan:
    """Grid of the decode kernel: column blocks of 128, K splits (each
    `stages` stages of 64 plane rows), n-tiles, and why the grid is short of
    the card's SMs when it is ('' when it fills them)."""
    col_blocks: int
    splits: int
    stages: int
    n_tiles: int
    note: str

    @property
    def blocks(self) -> int:
        return self.col_blocks * self.splits


@functools.lru_cache(maxsize=None)
def decode_plan(n: int, K: int, O: int, packed: bool, group: int | None = None) -> DecodePlan:
    """K splits for the decode kernel at n rows of x (1-63). The kernel is
    bound by its warps' work on each stage, not by bytes in flight (a block
    keeps 3-4 stages of ~10 KB in flight), so the grid aims at as many
    blocks as the SMs hold at once (two an SM where their shared memory
    fits, as it does at every layout): the divisor of the 64-row plane
    blocks whose grid lies nearest that count (on a log scale, the smaller
    on a tie), as long as the partial sums stay within half the plane bytes
    (q taken at its 0.5 or 1 byte a weight): one block of each column tile
    reads them all at the end. group defaults to Q4_K's (packed) or Q6_K's.
    Cached: every decode step asks again for the same few shapes."""
    nt = decode_tiles(n)
    group = group or (32 if packed else 16)
    cols = O // _COLS
    units = (K // 2 if packed else K) // _SPLIT_UNIT
    target = _SMS * min(2, _SMEM_PER_SM // (decode_smem(nt, packed, group)[1] + 1024))
    plane = K * O // (2 if packed else 1)
    fits = [d for d in range(1, units + 1)
            if units % d == 0 and (d == 1 or d * n * O * 4 <= plane // 2)]
    s = min(fits, key=lambda d: (abs(math.log(cols * d / target)), d))
    blocks = cols * s
    note = ""
    if blocks < _SMS:
        more = [d for d in range(s + 1, units + 1) if units % d == 0]
        note = (f"{units} plane blocks of 64 rows admit no split above {s}" if not more else
                f"{more[0]} splits would write more partial sums than half the plane bytes")
    return DecodePlan(cols, s, units // s, nt, note)


def _decode_lib():
    fn = build.library("qmm_decode.cu").qmm_decode_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


# split-K tile counters of the decode kernel, per (device, stream): zero
# between launches (the last block of a column tile resets its own), so
# launches on one stream, which run in order, may share them
_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    c = _COUNTERS.get(key)
    if c is None or c.numel() < n:
        c = _COUNTERS[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    scratch.hand_out(c)
    return c


def _prefill_lib():
    fn = build.library("qmm_prefill.cu").qmm_prefill_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def qmm(x: torch.Tensor, w) -> torch.Tensor:
    """y = x . W for a transposed-plane QuantTensor: [..., K] bf16 ->
    [..., out_features] f32, through the decode kernel below PREFILL_MIN_N
    rows and the wgmma GEMM from it."""
    if x.device.type == "cpu":
        return qmm_plain(x, w)
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
    if x2.data_ptr() % 16:
        raise ValueError("qmm: x must be 16-byte aligned")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    decode = N < PREFILL_MIN_N
    if decode:
        splits = decode_plan(N, K, O, w.packed, w.group).splits
    else:
        splits = prefill_plan(N, K, O, w.packed).splits
    out = torch.empty((N, O), dtype=torch.float32, device=x.device)
    part = (torch.empty((splits, N, O), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    head = (x2.data_ptr(), w.q.data_ptr(), w.scales.data_ptr(), _ptr(w.d), _ptr(w.mins),
            _ptr(w.dmin), _ptr(part))
    tail = (N, K, O, w.group, int(w.packed), int(w.hier), splits)
    if decode:
        counters = _counters(x.device, stream, O // _COLS) if splits > 1 else None
        build.check(_decode_lib()(*head, _ptr(counters), out.data_ptr(), *tail, stream),
                    "qmm_decode_launch")
    else:
        build.check(_prefill_lib()(*head, out.data_ptr(), *tail, stream), "qmm_prefill_launch")
    launches[kernel_name(w, N)] += 1
    if w.out_dim and w.out_dim != O:
        out = out[:, : w.out_dim]
    return out.reshape(*x.shape[:-1], w.out_features)
