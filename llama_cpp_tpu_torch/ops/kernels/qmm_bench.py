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
x. A wrapper takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor, or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

ROWS = 8  # rows of x per block; N is a multiple
GROUP = 32  # rows of K per scale that the kernels take
TILE_COLS = (128, 256, 512, 1024, 2048)  # columns per block the GEMV is built for
VARIANT_TILE = (8, 512, 2048)  # the fixed tile of _variant_call
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


# -- B2-B4 -------------------------------------------------------------------------

def _gemv(what: str, symbol: str, x, planes, K: int, O: int, group: int, tile, ints, counter):
    """Checks shared by the three GEMV wrappers, scratch, launch, count."""
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
    """Packed 4-bit GEMV, even/odd pairing, at the reference's fixed tile
    (8, 512, 2048): x [N, K] bf16 -> [N, O] f32. unpack="fp" builds the bf16
    pair of a byte's nibbles with bit operations and one subtraction; "i16"
    shifts, masks and converts. Both give the same bits."""
    if unpack not in ("fp", "i16"):
        raise ValueError(f"qmm4_variant: unpack is 'fp' or 'i16', got {unpack!r}")
    if x.device.type == "cpu":
        return qmm4_variant_plain(x, qp, sc, mn, group=group)
    K, O = _flat_planes("qmm4_variant", x, qp, sc, mn, group)
    return _gemv("qmm4_variant", "qmm4_variant_launch", x, (qp, sc, mn), K, O, group,
                 VARIANT_TILE, (int(unpack == "fp"),), f"qmm4_variant/{unpack}")


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
