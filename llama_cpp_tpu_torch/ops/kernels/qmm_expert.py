"""Indexed-expert fused dequantize + matmul over stacked int8 planes
(csrc/qmm_expert.cu), with its plain PyTorch version: row r of the output is
x[r] . W[ids[r]], the MoE decode product.

Port of the TPU kernel qmm_planes_expert of llama_cpp_tpu/ops/pallas/qmm.py
(the 8-sublane replica of x that the TPU tiling needs is not carried over).
The plain version is that kernel's arithmetic: W = bf16(q * scale) with the
product in f32, y = bf16(x) . W accumulated in f32, plus the affine term
(group sums of x) . mins in f32. The CUDA kernel keeps q exact on the tensor
cores and scales each group's f32 sum once, an NMSE near 1e-6 from the plain
version.

Bound on an H100: bytes, each distinct expert's planes (int8 q + f32 scales
and mins) read once. The kernel groups the rows that share an expert itself
(up to 8 a pass, expert_groups) and feeds (column tile, group, K range) units
to a persistent grid, splitting K by split_count; the wrapper takes the plain
version for a CPU tensor and launches the kernel for a CUDA tensor.

Widths: K a multiple of the 64-row stage, O of 64 (gpt-oss's 2880 is 45
stages and 22 column tiles of 128 plus one of 64): a last column tile half
past O reads zeros there and stores no column at or past O.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build, scratch

_COLS = 128  # output columns per block
_STAGE_ROWS = 64  # plane rows a stage; K splits fall on multiples of it
_O_STEP = 64  # O's unit: the last column tile may be half full
_GROUP_ROWS = 8  # rows of one expert in one pass (the MMA's n8 slot)
_MAX_SPLITS = 16
MAX_ROWS = 512  # the kernel's group table

launches = {"qmm_planes_expert": 0}


def supported(w) -> bool:
    """Whether the kernel takes this weight: a 3-D stack of transposed int8
    planes [E, K, O] with flat f32 scales, groups of 16 or 32, K a multiple
    of the 64-row stage and O of 64 (never nibble-packed, never per-256
    superblocks)."""
    if not w.transposed or w.q.dim() != 3 or w.packed or w.hier:
        return False
    if w.group not in (16, 32):
        return False
    return takes_widths(w.q.shape[1], w.q.shape[2])


def takes_widths(K: int, O: int) -> bool:
    """Whether the kernel takes a stack of K rows and O columns: K a multiple
    of the 64-row stage and O of 64."""
    return K % _STAGE_ROWS == 0 and O % _O_STEP == 0


def col_tiles(O: int) -> int:
    """Column tiles of 128 over O, the last one half full where O % 128 = 64."""
    return -(-O // _COLS)


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


def expert_groups(ids, n_expert: int) -> list[tuple[int, tuple[int, ...]]]:
    """The kernel's expert groups, in its order: each row numbered among the
    rows of its expert (ids clamped to [0, n_expert)) in row order; a row
    whose number is a multiple of 8 leads a group of itself and the next 7
    rows of its expert; groups in leader row order. -> [(expert, rows)]."""
    seen: dict[int, int] = {}
    open_group: dict[int, int] = {}
    groups: list[tuple[int, list[int]]] = []
    for r, i in enumerate(ids):
        e = min(max(int(i), 0), n_expert - 1)
        n = seen.get(e, 0)
        seen[e] = n + 1
        if n % _GROUP_ROWS == 0:
            open_group[e] = len(groups)
            groups.append((e, []))
        groups[open_group[e]][1].append(r)
    return [(e, tuple(rows)) for e, rows in groups]


def split_count(col_tiles: int, n_groups: int, k_units: int, slots: int) -> int:
    """The kernel's K split (csrc/qmm_expert.cu split_count), with
    col_tiles * n_groups * s units fed to `slots` blocks (the blocks the card
    holds at once): the smallest divisor s of the k_units stages of 64 plane
    rows, up to 16, whose units are shorter than 64 stages, fill at least
    45% of the slots (70% when split) and leave no partial second wave (1.1
    to 1.9 slots' worth); else the most splits that stay within one wave.
    Measured on an H100 (PERF.md): a partial second wave is slow, a
    long unit leaves the blocks that share an SM finishing last, and
    splitting costs a merge."""
    fallback = 1
    for s in range(1, _MAX_SPLITS + 1):
        if s > k_units or k_units % s:
            continue
        u100 = 100 * col_tiles * n_groups * s
        second_wave = 110 * slots < u100 < 190 * slots
        if not second_wave and k_units // s < 64 and u100 >= (45 if s == 1 else 70) * slots:
            return s
        if u100 < 110 * slots:
            fallback = s
    return fallback


@functools.lru_cache(maxsize=None)
def max_splits(R: int, K: int, O: int, slots: int) -> int:
    """The most splits the kernel can take at R rows, whatever their ids:
    the largest split_count over every possible group count (ceil(R/8) to
    R), so the partial-sum scratch [max_splits, R, O] always suffices."""
    lo = -(-R // _GROUP_ROWS)
    return max(split_count(col_tiles(O), n, K // _STAGE_ROWS, slots) for n in range(lo, R + 1))


@functools.lru_cache(maxsize=None)
def distinct_plan(R: int, E: int, K: int, O: int, slots: int) -> tuple[int, int]:
    """(grid, splits) if the R rows pick distinct experts, as a decode
    token's top-k do: the kernel's split at min(R, E) groups, and one block
    a unit, up to the slots. A block whose first unit is past the last exits
    at once; a grid that matches the units lets the block scheduler spread
    them one an SM before it doubles up (at Qwen3's down experts, R=8, 128
    units on the card's 264 slots ran a fifth slower than on 128 blocks;
    PERF.md). Where R <= E the kernel issues each block's first copies by
    that split before it has grouped the rows; splits is 0 where R > E (no
    such guess)."""
    groups = min(R, E)
    s = split_count(col_tiles(O), groups, K // _STAGE_ROWS, slots)
    return min(col_tiles(O) * groups * s, slots), (s if R <= E else 0)


def _lib():
    lib = build.library("qmm_expert.cu")
    fn = lib.qmm_expert_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.qmm_expert_encode.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        lib.qmm_expert_encode.restype = ctypes.c_int
        lib.qmm_expert_slots.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.qmm_expert_slots.restype = ctypes.c_int
    return lib


# per device index and (group, mins): blocks the card holds at once
_SLOTS: dict[tuple[int, int, bool], int] = {}
# per stack (data pointers and shape): its three encoded tensor maps; a map
# holds only addresses, sizes and strides, so the key decides it
_MAPS: dict[tuple, ctypes.Array] = {}
_MAX_MAPS = 1024
# per (device, stream): split-K partial sums, and the work counters and
# (column tile, group) counters, zero between launches (the last block to
# use one resets it), so launches on one stream, which run in order, may
# share them
_SCRATCH: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def slots(device: torch.device, group: int, mins: bool) -> int:
    """Blocks of the kernel the card holds at once (SMs x blocks an SM)."""
    key = (device.index, group, mins)
    n = _SLOTS.get(key)
    if n is None:
        with torch.cuda.device(device):
            n = _lib().qmm_expert_slots(group, int(mins))
        if n <= 0:
            raise RuntimeError("qmm_expert: could not size the kernel's grid on this card")
        _SLOTS[key] = n
    return n


def _maps(w) -> ctypes.Array:
    E, K, O = w.q.shape
    mn = None if w.mins is None else w.mins.data_ptr()
    key = (w.q.device.index, w.q.data_ptr(), w.scales.data_ptr(), mn, E, K, O, w.group)
    maps = _MAPS.get(key)
    if maps is None:
        maps = ctypes.create_string_buffer(3 * 128)
        build.check(_lib().qmm_expert_encode(w.q.data_ptr(), w.scales.data_ptr(), mn, E, K, O,
                                             w.group, maps), "qmm_expert_encode")
        if len(_MAPS) >= _MAX_MAPS:
            _MAPS.clear()
        _MAPS[key] = maps
    return maps


def qmm_expert(x: torch.Tensor, ids: torch.Tensor, w) -> torch.Tensor:
    """y[r] = x[r] . W[ids[r]] for a stacked transposed-plane QuantTensor:
    x [R, K] bf16, ids [R] int32 -> [R, O] f32."""
    if x.device.type == "cpu":
        return qmm_expert_plain(x, ids, w)
    if x.device.type != "cuda" or not supported(w):
        raise ValueError(f"qmm_expert: needs CUDA tensors and a 3-D stack of transposed int8 "
                         f"planes with flat scales, K % 64 == 0, O % 64 == 0 (got {x.device}, "
                         f"packed={w.packed}, hier={w.hier}, group={w.group}, "
                         f"shape={tuple(w.q.shape)})")
    E, K, O = w.q.shape
    if E * K >= 1 << 31 or E >= 1 << 15:
        raise ValueError(f"qmm_expert: {E} experts of {K} plane rows pass the kernel's 16-bit "
                         "expert ids or the tensor map's 32-bit row coordinate")
    if (x.dtype != torch.bfloat16 or x.dim() != 2 or x.shape[1] != K or not x.is_contiguous()
            or x.data_ptr() % 16):
        raise ValueError(f"qmm_expert: x must be a contiguous, 16-byte aligned CUDA bf16 "
                         f"[R, {K}] tensor, got {x.dtype} {tuple(x.shape)}")
    R = x.shape[0]
    if not 0 < R <= MAX_ROWS:
        raise ValueError(f"qmm_expert: 1 to {MAX_ROWS} rows, got {R}")
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
    mins = w.mins is not None
    n_slots = slots(x.device, w.group, mins)
    s_max = max_splits(R, K, O, n_slots)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    part, counters = scratch.grow(_SCRATCH, x.device, stream,
                                  s_max * R * O if s_max > 1 else 0, 2 + col_tiles(O) * R)
    grid, hint = distinct_plan(R, E, K, O, n_slots)
    out = torch.empty((R, O), dtype=torch.float32, device=x.device)
    err = _lib().qmm_expert_launch(_maps(w), x.data_ptr(), ids.data_ptr(), part.data_ptr(),
                                   counters.data_ptr(), out.data_ptr(), R, E, K, O, w.group,
                                   int(mins), n_slots, s_max, grid, hint, stream)
    build.check(err, "qmm_expert_launch")
    launches["qmm_planes_expert"] += 1
    return out
