"""The qmm microbenchmark's probe kernels (csrc/qmm_bench.cu), each with its
plain PyTorch version.

Port of the four TPU kernels of scripts/bench_qmm.py: stream_planes (the
stream ceiling through the planes a packed 4-bit GEMV reads), _variant_call
(the GEMV with the nibbles unpacked in float arithmetic or by shift and
mask), qmm_tiled (the same function with the tile sizes as arguments) and
qmm_tiled4d (the same over planes stored tile by tile). The GEMVs use the
even/odd pairing: byte r of a column holds row 2r of K in its low nibble and
row 2r+1 in its high nibble, one flat f32 scale and min per `group` rows.

The plain versions are the TPU bodies' arithmetic: W = bf16(nibble * scale)
with the product in f32, y = bf16(x) . W accumulated in f32, plus (group sums
of x) . mins in f32. The CUDA kernels send the nibbles to the tensor cores
unscaled (exact in bf16) and scale each group's sum in f32, an NMSE near
1e-6 from the plain version.

Bound on an H100: the plane bytes over 3.35 TB/s, for all four at 8 rows of
x. _variant_call has a kernel of its own, planned by variant_plan: column
tiles of 128, K split to give every SM a block, one launch. A
wrapper takes the plain version for a CPU tensor and launches the kernel for
a CUDA tensor, or raises.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from . import build, scratch

ROWS = 8  # rows of x per block; N is a multiple
GROUP = 32  # rows of K per scale that the kernels take
TILE_COLS = (128, 256, 512, 1024, 2048)  # columns per block the GEMV is built for
# the fixed tile of _variant_call: its domain is N % 8 == 0, O % 512 == 0,
# K % 2048 == 0 (the card's blocking is variant_plan's)
VARIANT_TILE = (8, 512, 2048)
_STREAM_COLS = 256  # columns per block of the stream probe
_STREAM_Q_ROWS = 32  # byte rows per 8 KB chunk of the stream probe
_STREAM_S_ROWS = 8  # f32 rows per chunk
_STREAM_BLOCKS = 396  # three blocks (64 KB of ring each) fit an SM, 132 SMs: one wave

launches = {"stream_planes": 0, "qmm4_variant/fp": 0, "qmm4_variant/i16": 0, "qmm_tiled": 0,
            "qmm_tiled4d": 0}


# -- plain versions ------------------------------------------------------------

def stream_tile_rows(K2: int) -> int:
    """Byte rows per tile of the stream probe (scripts/bench_qmm.py:102)."""
    return 1024 if K2 % 1024 == 0 else 512


def stream_planes_plain(x, qp: torch.Tensor, sc: torch.Tensor, mn: torch.Tensor, *, group: int,
                        tk2: int | None = None) -> torch.Tensor:
    """[8, O] f32: for every tile of tk2 byte rows, rows 0..7 of the tile's
    bytes (signed), scales and mins, summed over the tiles in order. x is not
    read (the TPU function takes it and does not read it either)."""
    K2, O = qp.shape
    tk2 = tk2 or stream_tile_rows(K2)
    ts = tk2 // (group // 2)
    out = torch.zeros((8, O), dtype=torch.float32, device=qp.device)
    for t in range(K2 // tk2):
        out += (qp[t * tk2: t * tk2 + 8].float() + sc[t * ts: t * ts + 8].float()
                + mn[t * ts: t * ts + 8].float())
    return out


def qmm4_variant_plain(x: torch.Tensor, qp: torch.Tensor, sc: torch.Tensor, mn: torch.Tensor, *,
                       group: int) -> torch.Tensor:
    """x [N, K] -> [N, O] f32 over even/odd packed planes; also the plain
    version of qmm_tiled, whose tile sizes do not change the function."""
    N, K = x.shape
    O = qp.shape[1]
    u = qp.view(torch.uint8)
    w = torch.stack((u & 0xF, u >> 4), dim=1).reshape(K, O).float()  # rows 2r, 2r+1
    w = (w.reshape(K // group, group, O) * sc.float()[:, None, :]).reshape(K, O)
    xb = x.to(torch.bfloat16).float()
    y = torch.matmul(xb, w.to(torch.bfloat16).float())
    xg = xb.reshape(N, K // group, group).sum(dim=-1)
    return y + torch.matmul(xg, mn.float())


def tile_planes_4d(qp: torch.Tensor, sc: torch.Tensor, mn: torch.Tensor, to: int, tk: int):
    """Planes stored tile by tile: qp [K/2, O] -> [K/tk, O/to, tk/2, to], sc
    and mn [K/group, O] -> [K/tk, O/to, tk/group, to], every tile one
    contiguous run. Layout only: a reshape and a permute."""
    K2, O = qp.shape
    K = 2 * K2
    if O % to or K % tk or sc.shape[0] % (K // tk):
        raise ValueError(f"tile_planes_4d: tile ({to}, {tk}) does not divide K={K}, O={O}, "
                         f"{sc.shape[0]} scale rows")

    def tile(p):
        rows = p.shape[0] // (K // tk)
        return p.reshape(K // tk, rows, O // to, to).permute(0, 2, 1, 3).contiguous()

    return tile(qp), tile(sc), tile(mn)


def untile_planes_4d(q4: torch.Tensor, sc4: torch.Tensor, mn4: torch.Tensor):
    """The inverse of tile_planes_4d."""
    def flat(p):
        nk, no, rows, to = p.shape
        return p.permute(0, 2, 1, 3).reshape(nk * rows, no * to)

    return flat(q4), flat(sc4), flat(mn4)


def qmm_tiled4d_plain(x: torch.Tensor, q4: torch.Tensor, sc4: torch.Tensor, mn4: torch.Tensor, *,
                      group: int) -> torch.Tensor:
    """x [N, K] -> [N, O] f32 over tile-by-tile planes: undo the tiling, then
    the flat plain version."""
    return qmm4_variant_plain(x, *untile_planes_4d(q4, sc4, mn4), group=group)


# -- what the kernels take -------------------------------------------------------

def tile_unsupported(tn: int, to: int, tk: int, K: int, O: int) -> str | None:
    """Why the GEMV kernel has no instantiation for the tile (tn, to, tk) at
    this shape, or None when it takes it."""
    if tn != ROWS:
        return f"rows per block {tn}: the kernel is built for {ROWS}"
    if to not in TILE_COLS:
        return f"{to} columns per block: the kernel is built for {TILE_COLS}"
    if O % to or K % tk:
        return f"the tile does not divide K={K}, O={O}"
    if tk % 64:
        return f"{tk} K rows per block: a stage is 64 rows of K"
    return None


def _check_planes(what: str, x, planes, shapes, dtypes):
    for name, t, shape, dt in zip(("q", "scales", "mins"), planes, shapes, dtypes):
        if (t.device != x.device or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{what}: {name} must be a contiguous, 16-byte aligned {dt} "
                             f"{shape} tensor on {x.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")


def _check_x(what: str, x, K: int):
    if (x.device.type != "cuda" or x.dtype != torch.bfloat16 or x.dim() != 2 or x.shape[1] != K
            or not x.is_contiguous() or x.data_ptr() % 16):
        raise ValueError(f"{what}: x must be a contiguous, 16-byte aligned CUDA bf16 [N, {K}] "
                         f"tensor, got {x.device} {x.dtype} {tuple(x.shape)}")
    if x.shape[0] == 0 or x.shape[0] % ROWS:
        raise ValueError(f"{what}: rows of x must be a positive multiple of {ROWS}, "
                         f"got {x.shape[0]}")


def _fn(name: str, n_ptr: int, n_int: int):
    fn = getattr(build.library("qmm_bench.cu"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


# -- B1 ----------------------------------------------------------------------------

def stream_planes(x, qp: torch.Tensor, sc: torch.Tensor, mn: torch.Tensor, *, group: int,
                  tk2: int | None = None) -> torch.Tensor:
    """The stream probe: every byte of the three planes goes through the
    SM, rows 0..7 of each tile are summed -> [8, O] f32. tk2 (byte rows per
    tile; the reference's rule by default) and group are part of the
    function: they say which rows are summed."""
    if qp.device.type == "cpu":
        return stream_planes_plain(x, qp, sc, mn, group=group, tk2=tk2)
    if qp.device.type != "cuda" or qp.dim() != 2:
        raise ValueError(f"stream_planes: qp must be a 2-D CUDA tensor, got {qp.device} "
                         f"{tuple(qp.shape)}")
    K2, O = qp.shape
    tk2 = tk2 or stream_tile_rows(K2)
    g2 = group // 2
    if group % 2 or g2 <= 0 or tk2 <= 0 or tk2 % g2 or K2 % tk2:
        raise ValueError(f"stream_planes: tiles of {tk2} byte rows in groups of {group} do not "
                         f"divide K/2={K2}")
    ts = tk2 // g2
    if O % _STREAM_COLS or tk2 % _STREAM_Q_ROWS or ts % _STREAM_S_ROWS:
        raise ValueError(f"stream_planes: the kernel takes O % {_STREAM_COLS} == 0, tiles of a "
                         f"multiple of {_STREAM_Q_ROWS} byte rows and of {_STREAM_S_ROWS} scale "
                         f"rows; got O={O}, {tk2} and {ts}")
    G = K2 // g2
    _check_planes("stream_planes", qp, (qp, sc, mn), ((K2, O), (G, O), (G, O)),
                  (torch.int8, torch.float32, torch.float32))
    n_chunks = (K2 // tk2) * (tk2 // _STREAM_Q_ROWS + 2 * (ts // _STREAM_S_ROWS))
    strips = O // _STREAM_COLS
    # all blocks resident at once: a second, partly filled wave would run alone
    splits = max(1, min(_STREAM_BLOCKS // strips, n_chunks // 6))
    out = torch.empty((8, O), dtype=torch.float32, device=qp.device)
    part = (torch.empty((splits, 8, O), dtype=torch.float32, device=qp.device)
            if splits > 1 else None)
    err = _fn("stream_planes_launch", 5, 5)(
        qp.data_ptr(), sc.data_ptr(), mn.data_ptr(), None if part is None else part.data_ptr(),
        out.data_ptr(), K2, O, tk2, ts, splits, _stream(qp))
    build.check(err, "stream_planes_launch")
    launches["stream_planes"] += 1
    return out


# -- B2 ----------------------------------------------------------------------------

# the kernel (csrc/qmm_bench.cu qmm4_variant_kernel): a block is 128 columns
# of the output, up to 4 n-tiles of 8 rows of x, and a range of K walked in
# stages of 64 plane byte rows, 8 consumer warps and a producer warp
_SMS = 132
_SMEM_PER_SM = 233472  # bytes of shared memory an H100 SM has for blocks
_VARIANT_COLS = 128
_VARIANT_STAGE_ROWS = 64  # plane byte rows a stage: 128 rows of K
_VARIANT_STAGES = 4
_VARIANT_MAX_BLOCKS_PER_SM = 2  # its launch bounds: the registers of two blocks


def variant_tiles(n: int) -> int:
    """n-tiles of 8 rows of x a block takes at n rows: 1, 2 or 4 (from 33
    rows on, blocks along the rows of x take 32 each)."""
    return 1 if n <= 8 else 2 if n <= 16 else 4


def variant_smem(nt: int) -> int:
    """Shared memory bytes of one block (csrc/qmm_bench.cu VLayout): per
    stage 8 KB of plane rows, x as two boxes of 8 nt rows x 64 k, 4 rows of
    scales and 4 of mins; the barriers; 1 KB to align the swizzled tiles."""
    stage = _VARIANT_STAGE_ROWS * _VARIANT_COLS + 2 * nt * 8 * 128 + 2 * 4 * _VARIANT_COLS * 4
    return _VARIANT_STAGES * stage + 16 * _VARIANT_STAGES + 1024


@dataclass(frozen=True)
class VariantPlan:
    """Grid of the B2 kernel: column blocks of 128, K splits (each `stages`
    stages of 64 plane byte rows), blocks along the rows of x (n_tiles
    n-tiles of 8 each), the blocks an SM holds, and why the grid is short of
    the card's SMs when it is ('' when it fills them)."""
    col_blocks: int
    splits: int
    stages: int
    row_blocks: int
    n_tiles: int
    blocks_per_sm: int
    note: str

    @property
    def blocks(self) -> int:
        return self.col_blocks * self.splits * self.row_blocks

    @property
    def slots(self) -> int:
        return _SMS * self.blocks_per_sm


@functools.lru_cache(maxsize=None)
def variant_plan(n: int, K: int, O: int) -> VariantPlan:
    """K splits for the B2 kernel at n rows of x: the most splits (dividing
    the K/128 stages of 64 plane byte rows) whose blocks do not outnumber
    the SMs, with the partial sums within half the plane bytes (the last
    block of each column tile reads them all). Two blocks fit an SM, but a
    split block pays its ring's fill and the merge again, and one block's 4
    stages of 12 KB in flight keep an SM's share of the memory rate busy:
    sweeps of the split count on an H100 at 4096 x 4096, 4096 x 6144 and
    14336 x 4096 read one block an SM as fast as two or faster (PERF.md).
    Where the column blocks alone outnumber the SMs (4096 x 28672: 224 of
    the 264 slots) K is not split."""
    nt = variant_tiles(n)
    rows = -(-n // (8 * nt))
    cols = O // _VARIANT_COLS
    units = K // 2 // _VARIANT_STAGE_ROWS
    per_sm = min(_VARIANT_MAX_BLOCKS_PER_SM, _SMEM_PER_SM // (variant_smem(nt) + 1024))
    slots = _SMS * per_sm
    plane = K * O // 2 + 2 * (K // GROUP) * O * 4
    fits = [d for d in range(1, units + 1)
            if units % d == 0 and (d == 1 or (cols * rows * d <= _SMS
                                              and d * n * O * 4 <= plane // 2))]
    s = max(fits)
    blocks = cols * rows * s
    note = ""
    if blocks > slots:
        note = f"{blocks} column and row blocks pass the {slots} resident slots"
    elif blocks < _SMS:
        more = [d for d in range(s + 1, units + 1) if units % d == 0]
        note = (f"{units} stages of 64 plane rows admit no split above {s}" if not more else
                f"{more[0]} splits would pass one block an SM" if cols * rows * more[0] > _SMS
                else f"{more[0]} splits would write more partial sums than half the plane bytes")
    return VariantPlan(cols, s, units // s, rows, nt, per_sm, note)


def _variant_lib():
    lib = build.library("qmm_bench.cu")
    fn = lib.qmm4_variant_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.qmm4_variant_encode_planes.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        lib.qmm4_variant_encode_planes.restype = ctypes.c_int
        lib.qmm4_variant_encode_x.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        lib.qmm4_variant_encode_x.restype = ctypes.c_int
        lib.qmm4_variant_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.qmm4_variant_blocks_per_sm.restype = ctypes.c_int
        lib.qmm4_variant_smem_bytes.argtypes = [ctypes.c_int]
        lib.qmm4_variant_smem_bytes.restype = ctypes.c_int
    return lib


# encoded tensor maps: a map holds only the device address, the sizes, the
# strides and the box, so a key of the device, the pointers and the shapes
# (the box follows from the rows of x) decides it
_MAPS: dict[tuple, ctypes.Array] = {}
_MAX_MAPS = 1024
# per (device, stream): split-K partial sums, and the (column tile, row
# block) counters, zero between launches (the last block of a tile resets
# its own), so launches on one stream, which run in order, may share them
_SCRATCH: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _map(key: tuple, n_maps: int, encode) -> ctypes.Array:
    maps = _MAPS.get(key)
    if maps is None:
        maps = ctypes.create_string_buffer(n_maps * 128)
        build.check(encode(maps), "qmm4_variant tensor map encoding")
        if len(_MAPS) >= _MAX_MAPS:
            _MAPS.clear()
        _MAPS[key] = maps
    return maps


def _variant(x, qp, sc, mn, K: int, O: int, fp: bool) -> torch.Tensor:
    N = x.shape[0]
    plan = variant_plan(N, K, O)
    lib = _variant_lib()
    dev = x.device
    pmaps = _map(("planes", dev.index, qp.data_ptr(), sc.data_ptr(), mn.data_ptr(), K, O), 3,
                 lambda m: lib.qmm4_variant_encode_planes(qp.data_ptr(), sc.data_ptr(),
                                                          mn.data_ptr(), K, O, m))
    xmap = _map(("x", dev.index, x.data_ptr(), N, K), 1,
                lambda m: lib.qmm4_variant_encode_x(x.data_ptr(), N, K, m))
    stream = _stream(x)
    part, counters = scratch.grow(_SCRATCH, dev, stream,
                                  plan.splits * N * O if plan.splits > 1 else 0,
                                  plan.col_blocks * plan.row_blocks)
    out = torch.empty((N, O), dtype=torch.float32, device=dev)
    err = lib.qmm4_variant_launch(xmap, pmaps, part.data_ptr(), counters.data_ptr(),
                                  out.data_ptr(), N, K, O, plan.splits, int(fp), stream)
    build.check(err, "qmm4_variant_launch")
    return out


# -- B3, B4 ------------------------------------------------------------------------

def _gemv(what: str, symbol: str, x, planes, K: int, O: int, group: int, tile, ints, counter):
    """Checks shared by the two tiled GEMV wrappers, scratch, launch, count."""
    tn, to, tk = tile
    if group != GROUP:
        raise ValueError(f"{what}: the kernel takes groups of {GROUP}, got {group}")
    why = tile_unsupported(tn, to, tk, K, O)
    if why:
        raise ValueError(f"{what}: {why}")
    N = x.shape[0]
    splits = K // tk
    out = torch.empty((N, O), dtype=torch.float32, device=x.device)
    part = (torch.empty((splits, N, O), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    err = _fn(symbol, 6, 4 + len(ints))(
        x.data_ptr(), *(p.data_ptr() for p in planes), None if part is None else part.data_ptr(),
        out.data_ptr(), N, K, O, group, *ints, _stream(x))
    build.check(err, symbol)
    launches[counter] += 1
    return out


def _flat_planes(what: str, x, qp, sc, mn, group: int):
    if x.device.type != "cuda" or qp.dim() != 2:
        raise ValueError(f"{what}: needs CUDA tensors and 2-D planes, got {x.device} "
                         f"{tuple(qp.shape)}")
    K2, O = qp.shape
    K = 2 * K2
    _check_x(what, x, K)
    if group <= 0 or K % group:
        raise ValueError(f"{what}: groups of {group} do not divide K={K}")
    _check_planes(what, x, (qp, sc, mn), ((K2, O), (K // group, O), (K // group, O)),
                  (torch.int8, torch.float32, torch.float32))
    return K, O


def qmm4_variant(x: torch.Tensor, qp: torch.Tensor, sc: torch.Tensor, mn: torch.Tensor, *,
                 group: int, unpack: str = "i16") -> torch.Tensor:
    """Packed 4-bit GEMV, even/odd pairing, in the domain of the reference's
    fixed tile (8, 512, 2048): x [N, K] bf16 -> [N, O] f32. unpack="fp" puts
    a nibble in the mantissa of bf16 128.0 by bit operations; "i16" shifts,
    masks and converts. Both give the same bits."""
    if unpack not in ("fp", "i16"):
        raise ValueError(f"qmm4_variant: unpack is 'fp' or 'i16', got {unpack!r}")
    if x.device.type == "cpu":
        return qmm4_variant_plain(x, qp, sc, mn, group=group)
    K, O = _flat_planes("qmm4_variant", x, qp, sc, mn, group)
    if group != GROUP:
        raise ValueError(f"qmm4_variant: the kernel takes groups of {GROUP}, got {group}")
    tn, to, tk = VARIANT_TILE
    if O % to or K % tk:
        raise ValueError(f"qmm4_variant: the reference's tile ({tn}, {to}, {tk}) does not "
                         f"divide K={K}, O={O}")
    out = _variant(x, qp, sc, mn, K, O, unpack == "fp")
    launches[f"qmm4_variant/{unpack}"] += 1
    return out


def qmm_tiled(x: torch.Tensor, qp: torch.Tensor, sc: torch.Tensor, mn: torch.Tensor, *,
              group: int, tn: int, to: int, tk: int) -> torch.Tensor:
    """qmm4_variant's function with the tile as arguments: tn rows of x, to
    columns and tk rows of K per block (K/tk splits of K, summed in order)."""
    if x.device.type == "cpu":
        return qmm4_variant_plain(x, qp, sc, mn, group=group)
    K, O = _flat_planes("qmm_tiled", x, qp, sc, mn, group)
    return _gemv("qmm_tiled", "qmm_tiled_launch", x, (qp, sc, mn), K, O, group, (tn, to, tk),
                 (tn, to, tk), "qmm_tiled")


def qmm_tiled4d(x: torch.Tensor, q4: torch.Tensor, sc4: torch.Tensor, mn4: torch.Tensor, *,
                group: int, to: int, tk: int) -> torch.Tensor:
    """The same function over tile_planes_4d(qp, sc, mn, to, tk): each
    block's tile is one contiguous run of device memory."""
    if x.device.type == "cpu":
        return qmm_tiled4d_plain(x, q4, sc4, mn4, group=group)
    if x.device.type != "cuda" or q4.dim() != 4:
        raise ValueError(f"qmm_tiled4d: needs CUDA tensors and 4-D planes, got {x.device} "
                         f"{tuple(q4.shape)}")
    nk, no = q4.shape[:2]
    K, O = nk * tk, no * to
    _check_x("qmm_tiled4d", x, K)
    if group <= 0 or tk % group:
        raise ValueError(f"qmm_tiled4d: groups of {group} do not divide tk={tk}")
    srows = tk // group
    _check_planes("qmm_tiled4d", x, (q4, sc4, mn4),
                  ((nk, no, tk // 2, to), (nk, no, srows, to), (nk, no, srows, to)),
                  (torch.int8, torch.float32, torch.float32))
    return _gemv("qmm_tiled4d", "qmm_tiled4d_launch", x, (q4, sc4, mn4), K, O, group,
                 (ROWS, to, tk), (to, tk), "qmm_tiled4d")
