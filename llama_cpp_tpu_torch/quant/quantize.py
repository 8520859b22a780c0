"""Vectorized quantizers producing bit-compatible ggml blocks (numpy only).

Algorithm parity with reference ggml/src/ggml-quants.c quantize_row_*_ref
(q4_0:259, q8_0:277, q2_K:891, q3_K:1229, q4_K:1457, q5_K:1644, q6_K:1869) and
the error-minimizing searches make_qx_quants:628 / make_q3_quants:698 /
make_qkx2_quants:800, re-expressed as batched numpy over [n_groups, group] so a
whole tensor quantizes in a handful of array ops per search step. The bytes
equal the JAX package's llama_cpp_tpu/quant/quantize.py for every type of
_QUANT, with and without importance weights.

Imatrix-weighted variants accept `qw` (per-element importance weights) and
follow quantize_row_*_impl semantics.
"""

from __future__ import annotations

import numpy as np

from ..gguf.constants import QK_K, GGMLType
from .dequant import KVALUES_FP4, KVALUES_IQ4NL, _e8m0_half

GROUP_MAX_EPS = 1e-15


def _nearest_int(x: np.ndarray) -> np.ndarray:
    """ggml nearest_int: round-half-to-even (the float +12582912 trick)."""
    return np.rint(x).astype(np.int32)


def _fp16_bytes(x: np.ndarray) -> np.ndarray:
    return x.astype(np.float16).view(np.uint8).reshape(len(x), -1)


def _f16_round(x: np.ndarray) -> np.ndarray:
    """fp32 -> fp16 -> fp32 (storage rounding)."""
    return x.astype(np.float16).astype(np.float32)


# ---------------------------------------------------------------------------
# search helpers (vectorized over axis 0 = groups)
# ---------------------------------------------------------------------------


def _signed_absmax(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-row (amax, signed value at amax); first-max-wins like the C scan."""
    idx = np.argmax(np.abs(x), axis=-1)
    mx = np.take_along_axis(x, idx[:, None], axis=-1)[:, 0]
    return np.abs(mx), mx


def make_qx_quants(
    x: np.ndarray, nmax: int, rmse_type: int = 1, qw: np.ndarray | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Signed search quantizer -> (L in [0, 2*nmax-1] uint, scale). x: [G, n]."""
    G, n = x.shape
    amax, mx = _signed_absmax(x)
    dead = amax < GROUP_MAX_EPS
    mx_safe = np.where(dead, 1.0, mx)

    if qw is not None:
        w = qw
    elif rmse_type == 1:
        w = x * x
    elif rmse_type == 2:
        w = np.ones_like(x)
    elif rmse_type == 3:
        w = np.abs(x)
    else:
        w = np.sqrt(np.abs(x))

    def attempt(iscale):
        l = np.clip(_nearest_int(iscale[:, None] * x), -nmax, nmax - 1)
        sumlx = np.sum(w * x * l, axis=-1)
        suml2 = np.sum(w * l * l, axis=-1)
        return l, sumlx, suml2

    iscale0 = -nmax / mx_safe
    L, sumlx, suml2 = attempt(iscale0)
    scale = np.where(suml2 != 0, sumlx / np.where(suml2 == 0, 1, suml2), 0.0)
    best = scale * sumlx
    for is_ in range(-9, 10):
        if is_ == 0:
            continue
        isc = -(nmax + 0.1 * is_) / mx_safe
        Lc, slx, sl2 = attempt(isc)
        better = (sl2 > 0) & (slx * slx > best * sl2)
        L = np.where(better[:, None], Lc, L)
        scale = np.where(better, slx / np.where(sl2 == 0, 1, sl2), scale)
        best = np.where(better, scale * slx, best)
    L = (L + nmax).astype(np.uint8)
    L[dead] = 0
    scale = np.where(dead, 0.0, scale)
    return L, scale.astype(np.float32)


def make_q3_quants(x: np.ndarray, nmax: int) -> tuple[np.ndarray, np.ndarray]:
    """do_rmse=True variant with coordinate-descent refinement. x: [G, n]."""
    G, n = x.shape
    amax, mx = _signed_absmax(x)
    dead = amax < GROUP_MAX_EPS
    mx_safe = np.where(dead, 1.0, mx)
    iscale = -nmax / mx_safe
    w = x * x
    L = np.clip(_nearest_int(iscale[:, None] * x), -nmax, nmax - 1).astype(np.float64)
    sumlx = np.sum(w * x * L, axis=-1)
    suml2 = np.sum(w * L * L, axis=-1)
    # coordinate descent (5 sweeps, sequential within a group like the C code)
    for _ in range(5):
        changed = np.zeros(G, dtype=bool)
        for i in range(n):
            wi, xi, Li = w[:, i], x[:, i], L[:, i]
            slx = sumlx - wi * xi * Li
            sl2 = suml2 - wi * Li * Li
            ok = slx > 0
            new_l = np.clip(
                _nearest_int(np.where(ok, xi * sl2 / np.where(slx == 0, 1, slx), 0)),
                -nmax,
                nmax - 1,
            ).astype(np.float64)
            slx2 = slx + wi * xi * new_l
            sl22 = sl2 + wi * new_l * new_l
            upd = ok & (new_l != Li) & (sl22 > 0) & (slx2 * slx2 * suml2 > sumlx * sumlx * sl22)
            L[:, i] = np.where(upd, new_l, Li)
            sumlx = np.where(upd, slx2, sumlx)
            suml2 = np.where(upd, sl22, suml2)
            changed |= upd
        if not changed.any():
            break
    scale = np.where(suml2 > 0, sumlx / np.where(suml2 == 0, 1, suml2), 0.0)
    Lout = (L + nmax).astype(np.uint8)
    Lout[dead] = 0
    scale = np.where(dead, 0.0, scale)
    return Lout, scale.astype(np.float32)


def make_qkx2_quants(
    x: np.ndarray,
    weights: np.ndarray,
    nmax: int,
    rmin: float,
    rdelta: float,
    nstep: int,
    use_mad: bool,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Scale+min search -> (L, scale, the_min). x/weights: [G, n]."""
    G, n = x.shape
    mn = np.minimum(x.min(axis=-1), 0.0)
    mx = x.max(axis=-1)
    sum_w = weights.sum(axis=-1)
    sum_x = (weights * x).sum(axis=-1)
    dead = mx == mn
    rng = np.where(dead, 1.0, mx - mn)
    iscale = nmax / rng
    scale = 1.0 / iscale
    L = np.clip(_nearest_int(iscale[:, None] * (x - mn[:, None])), 0, nmax)
    diff = scale[:, None] * L + mn[:, None] - x
    diff = np.abs(diff) if use_mad else diff * diff
    best_error = (weights * diff).sum(axis=-1)
    minv = mn.copy()
    for is_ in range(nstep + 1):
        isc = (rmin + rdelta * is_ + nmax) / rng
        Laux = np.clip(_nearest_int(isc[:, None] * (x - mn[:, None])), 0, nmax)
        sum_l = (weights * Laux).sum(axis=-1)
        sum_l2 = (weights * Laux * Laux).sum(axis=-1)
        sum_xl = (weights * Laux * x).sum(axis=-1)
        D = sum_w * sum_l2 - sum_l * sum_l
        Dok = D > 0
        Dsafe = np.where(Dok, D, 1.0)
        this_scale = (sum_w * sum_xl - sum_x * sum_l) / Dsafe
        this_min = (sum_l2 * sum_x - sum_l * sum_xl) / Dsafe
        pos = this_min > 0
        this_min = np.where(pos, 0.0, this_min)
        this_scale = np.where(
            pos, sum_xl / np.where(sum_l2 == 0, 1, sum_l2), this_scale
        )
        diff = this_scale[:, None] * Laux + this_min[:, None] - x
        diff = np.abs(diff) if use_mad else diff * diff
        cur_error = (weights * diff).sum(axis=-1)
        upd = Dok & (cur_error < best_error)
        best_error = np.where(upd, cur_error, best_error)
        L = np.where(upd[:, None], Laux, L)
        scale = np.where(upd, this_scale, scale)
        minv = np.where(upd, this_min, minv)
    L = L.astype(np.uint8)
    L[dead] = 0
    scale = np.where(dead, 0.0, scale)
    minv = np.where(dead, mn, minv)
    return L, scale.astype(np.float32), (-minv).astype(np.float32)


# ---------------------------------------------------------------------------
# simple formats
# ---------------------------------------------------------------------------


def quant_q4_0(x: np.ndarray) -> np.ndarray:
    x = x.reshape(-1, 32).astype(np.float32)
    amax, mx = _signed_absmax(x)
    d = mx / -8.0
    d = np.where(amax == 0, 0.0, d)
    id_ = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.minimum(15, (x * id_[:, None] + 8.5).astype(np.int8)).astype(np.uint8)
    lo, hi = q[:, :16], q[:, 16:]
    qs = (lo & 0xF) | (hi << 4)
    return np.concatenate([_fp16_bytes(d), qs], axis=1).astype(np.uint8).reshape(-1)


def quant_q4_1(x: np.ndarray) -> np.ndarray:
    x = x.reshape(-1, 32).astype(np.float32)
    mn = x.min(axis=-1)
    mx = x.max(axis=-1)
    d = (mx - mn) / 15.0
    id_ = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.minimum(15, ((x - mn[:, None]) * id_[:, None] + 0.5).astype(np.int8)).astype(np.uint8)
    lo, hi = q[:, :16], q[:, 16:]
    qs = (lo & 0xF) | (hi << 4)
    return np.concatenate(
        [_fp16_bytes(d), _fp16_bytes(mn), qs], axis=1
    ).astype(np.uint8).reshape(-1)


def quant_q5_0(x: np.ndarray) -> np.ndarray:
    x = x.reshape(-1, 32).astype(np.float32)
    amax, mx = _signed_absmax(x)
    d = np.where(amax == 0, 0.0, mx / -16.0)
    id_ = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.minimum(31, (x * id_[:, None] + 16.5).astype(np.int8)).astype(np.uint32)
    lo, hi = q[:, :16], q[:, 16:]
    qs = ((lo & 0xF) | ((hi & 0xF) << 4)).astype(np.uint8)
    j = np.arange(16, dtype=np.uint32)
    qh = (((lo >> 4) & 1) << j).sum(axis=1, dtype=np.uint32) | (
        ((hi >> 4) & 1) << (j + 16)
    ).sum(axis=1, dtype=np.uint32)
    return np.concatenate(
        [_fp16_bytes(d), qh.astype("<u4").view(np.uint8).reshape(-1, 4), qs], axis=1
    ).astype(np.uint8).reshape(-1)


def quant_q5_1(x: np.ndarray) -> np.ndarray:
    x = x.reshape(-1, 32).astype(np.float32)
    mn = x.min(axis=-1)
    mx = x.max(axis=-1)
    d = (mx - mn) / 31.0
    id_ = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.minimum(31, ((x - mn[:, None]) * id_[:, None] + 0.5).astype(np.int8)).astype(np.uint32)
    lo, hi = q[:, :16], q[:, 16:]
    qs = ((lo & 0xF) | ((hi & 0xF) << 4)).astype(np.uint8)
    j = np.arange(16, dtype=np.uint32)
    qh = (((lo >> 4) & 1) << j).sum(axis=1, dtype=np.uint32) | (
        ((hi >> 4) & 1) << (j + 16)
    ).sum(axis=1, dtype=np.uint32)
    return np.concatenate(
        [_fp16_bytes(d), _fp16_bytes(mn), qh.astype("<u4").view(np.uint8).reshape(-1, 4), qs],
        axis=1,
    ).astype(np.uint8).reshape(-1)


def quant_q8_0(x: np.ndarray) -> np.ndarray:
    x = x.reshape(-1, 32).astype(np.float32)
    amax = np.abs(x).max(axis=-1)
    d = amax / 127.0
    id_ = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    v = x * id_[:, None]
    q = np.trunc(v + np.where(v >= 0, 0.5, -0.5)).astype(np.int8)  # roundf()
    return np.concatenate(
        [_fp16_bytes(d), q.view(np.uint8)], axis=1
    ).astype(np.uint8).reshape(-1)


def quant_mxfp4(x: np.ndarray) -> np.ndarray:
    x = x.reshape(-1, 32).astype(np.float32)
    amax = np.abs(x).max(axis=-1)
    e = np.where(amax > 0, np.floor(np.log2(np.where(amax > 0, amax, 1))) - 2 + 127, 0)
    e = np.clip(e, 0, 255).astype(np.uint8)
    d = _e8m0_half(e[:, None])[:, 0]
    id_ = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    scaled = x * id_[:, None]
    # best_index against kvalues_fp4 (signed E2M1 doubled values)
    dist = np.abs(scaled[:, :, None] - KVALUES_FP4[None, None, :].astype(np.float32))
    q = np.argmin(dist, axis=-1).astype(np.uint8)
    lo, hi = q[:, :16], q[:, 16:]
    qs = lo | (hi << 4)
    return np.concatenate([e[:, None], qs], axis=1).astype(np.uint8).reshape(-1)


def quant_iq4_nl(x: np.ndarray) -> np.ndarray:
    """Simple nearest-codebook IQ4_NL (per-block scale fit like super_block_size=32)."""
    x = x.reshape(-1, 32).astype(np.float32)
    amax, mx = _signed_absmax(x)
    d = mx / float(KVALUES_IQ4NL[0])  # -127 end of the LUT
    d = np.where(amax < GROUP_MAX_EPS, 0.0, d)
    # one round of weighted-LS scale refinement over the LUT assignment
    kv = KVALUES_IQ4NL.astype(np.float32)
    scale = d.copy()
    id_ = np.where(scale != 0, 1.0 / np.where(scale == 0, 1, scale), 0.0)
    q = np.argmin(np.abs(x[:, :, None] * id_[:, None, None] - kv[None, None, :]), axis=-1)
    sumqx = (kv[q] * x).sum(axis=-1)
    sumq2 = (kv[q] * kv[q]).sum(axis=-1)
    scale = np.where(sumq2 > 0, sumqx / np.where(sumq2 == 0, 1, sumq2), scale)
    d16 = _f16_round(scale)
    id_ = np.where(d16 != 0, 1.0 / np.where(d16 == 0, 1, d16), 0.0)
    q = np.argmin(
        np.abs(x[:, :, None] * id_[:, None, None] - kv[None, None, :]), axis=-1
    ).astype(np.uint8)
    lo, hi = q[:, :16], q[:, 16:]
    qs = lo | (hi << 4)
    return np.concatenate([_fp16_bytes(d16), qs], axis=1).astype(np.uint8).reshape(-1)


# ---------------------------------------------------------------------------
# IQ codebook quants (iq2_xs / iq3_s / iq4_xs)
#
# Original encoders: the reference's neighbour-table machinery
# (ggml-quants.c iq2xs_init_impl + quantize_row_iq2_xs) is an encode-speed
# device, not part of the format — brute force over the 512-row codebooks
# vectorizes fine in numpy. Codewords are chosen scale-free first (maximize
# weighted correlation^2), scales least-squares fitted and quantized, then
# codewords refined once at the final effective scale. Decode layouts are
# the bit-exact-tested ones in quant/dequant.py.
# ---------------------------------------------------------------------------


def _grid_moments(a: np.ndarray, w: np.ndarray, grid: np.ndarray):
    """den[g,c] = sum_n w*grid^2, num[g,c] = sum_n w*a*grid — the only
    O(G*C*n) work of the codeword search; eff-dependent picks reuse them
    (err(eff) = eff^2*den - 2*eff*num up to a codeword-free constant)."""
    den = np.einsum("gn,cn->gc", w, grid * grid, dtype=np.float32)
    num = np.einsum("gn,cn->gc", w * a, grid, dtype=np.float32)
    return num, den


def _best_grid_rows(a: np.ndarray, w: np.ndarray, grid: np.ndarray,
                    eff: np.ndarray | None = None, moments=None) -> np.ndarray:
    """Best codebook row per group. a/w: [G, n] magnitudes / importance;
    grid: [C, n] unsigned codewords. eff=None -> scale-free (argmax of
    weighted corr^2); else minimize true weighted L2 at that scale."""
    num, den = moments if moments is not None else _grid_moments(a, w, grid)
    if eff is None:
        score = np.where(den > 0,
                         num * np.maximum(num, 0.0) / np.where(den == 0, 1, den),
                         -1.0)
        return np.argmin(-score, axis=1)
    # err = eff^2*den - 2*eff*num = eff*(eff*den - 2*num); the group
    # scales are strictly positive here, so the eff factor drops out of
    # the argmin (saves two [G, C] temporaries)
    eff = np.asarray(eff, np.float32)
    err = den * eff[:, None]
    err -= 2.0 * num
    return np.argmin(err, axis=1)


def _ls_scale(a, w, g):
    """Weighted least-squares scale fitting eff*g ~ a over the last axis."""
    num = (w * a * g).sum(-1)
    den = (w * g * g).sum(-1)
    return np.where(den > 0, num / np.where(den == 0, 1, den), 0.0)


def _iq_weights(x2d: np.ndarray, qw) -> np.ndarray:
    # reference quantize_row_iq*_impl weighting: sqrt(sigma2 + x^2) per
    # 256-block (qw-multiplied when an imatrix is supplied)
    sigma2 = 2.0 * (x2d * x2d).mean(-1, keepdims=True)
    w = np.sqrt(sigma2 + x2d * x2d)
    if qw is not None:
        w = w * qw.reshape(x2d.shape).astype(np.float32)
    return w + 1e-12


def _chunk_superblocks(fn, x, qw, limit=2048):
    """Run an IQ encoder in superblock chunks: bounds the [G, C] moment
    buffers (the per-256-block math is independent)."""
    x = x.reshape(-1, QK_K)
    if len(x) <= limit:
        return None
    outs = []
    for off in range(0, len(x), limit):
        q = None if qw is None else \
            np.asarray(qw).reshape(-1, QK_K)[off : off + limit]
        outs.append(fn(x[off : off + limit], q))
    return np.concatenate(outs)


def quant_iq2_xs(x: np.ndarray, qw: np.ndarray | None = None) -> np.ndarray:
    """IQ2_XS (layout: dequant.dequant_iq2_xs): 32 uint16 per 256-block,
    each = 9-bit grid row | 7-bit ksigns index over a group of 8; one
    4-bit level per PAIR of groups packed one byte per ib32;
    v = d*(0.5+ls)*0.25*grid*sign. Sign patterns carry even parity — the
    other half flips the least-important element."""
    from .dequant import IQ2XS_GRID, KSIGNS_IQ2XS

    out = _chunk_superblocks(quant_iq2_xs, x, qw)
    if out is not None:
        return out
    x = x.reshape(-1, QK_K).astype(np.float32)
    nb = len(x)
    w = _iq_weights(x, qw)
    xg, wg = x.reshape(-1, 8), w.reshape(-1, 8)
    a = np.abs(xg)
    grid = IQ2XS_GRID.astype(np.float32)  # [512, 8]

    sbits = (xg < 0).astype(np.int64)
    sbyte = (sbits << np.arange(8)).sum(-1)
    ok = KSIGNS_IQ2XS[sbyte & 0x7F] == sbyte
    flip = np.argmin(wg * a * a, axis=-1)
    sbyte = np.where(ok, sbyte, sbyte ^ (1 << flip))
    sign_idx = (sbyte & 0x7F).astype(np.uint16)

    moments = _grid_moments(a, wg, grid)
    rows = _best_grid_rows(a, wg, grid, moments=moments)
    g = grid[rows]
    ap, wp, gp = (v.reshape(-1, 16) for v in (a, wg, g))
    e = np.maximum(_ls_scale(ap, wp, gp), 0.0).reshape(nb, 16)
    d0 = e.max(-1) / (0.25 * 15.5)

    def _fit(d):
        dn = np.where(d > 0, d, 1.0).astype(np.float32)
        ei = e
        for _ in range(3):  # alternate rows <-> per-pair level refit
            ls = np.clip(_nearest_int(ei / (0.25 * dn[:, None]) - 0.5),
                         0, 15).astype(np.float32)
            eff = (dn[:, None] * 0.25 * (0.5 + ls)).repeat(2, axis=1).reshape(-1)
            rows = _best_grid_rows(a, wg, grid, eff=eff, moments=moments)
            g = grid[rows]
            ei = np.maximum(_ls_scale(*(v.reshape(-1, 16) for v in (a, wg, g))),
                            0.0).reshape(nb, 16)
        err = (wg * (eff[:, None] * g - a) ** 2).sum(-1).reshape(nb, -1).sum(-1)
        return ls.astype(np.int64), rows, err

    # super-scale search (make_qx_quants role): the max-pair anchor is
    # rarely the best trade against the 4-bit level grid
    best = None
    for f in (0.7, 0.8, 0.9, 1.0, 1.1, 1.25, 1.45):
        d = _f16_round(d0 * f)
        ls, rows_c, err = _fit(d)
        if best is None:
            best = [d, ls, rows_c, err]
        else:
            upd = err < best[3]
            best[0] = np.where(upd, d, best[0])
            best[1] = np.where(upd[:, None], ls, best[1])
            best[2] = np.where(upd.repeat(32), rows_c, best[2])
            best[3] = np.minimum(err, best[3])
    d, ls, rows = best[0], best[1], best[2]

    qs = (rows.astype(np.uint16) | (sign_idx << 9)).reshape(nb, 32)
    scales = (ls[:, 0::2] | (ls[:, 1::2] << 4)).astype(np.uint8)  # [nb, 8]
    return np.concatenate(
        [_fp16_bytes(d), qs.view(np.uint8).reshape(nb, 64), scales],
        axis=1).astype(np.uint8).reshape(-1)


def quant_iq3_s(x: np.ndarray, qw: np.ndarray | None = None) -> np.ndarray:
    """IQ3_S (layout: dequant.dequant_iq3_s): 8 codewords of 4 values per
    ib32 (9-bit rows: low byte in qs, high bit in qh), explicit per-value
    sign bits, one 4-bit level per ib32; v = d*(1+2*ls)*grid*sign."""
    from .dequant import IQ3S_GRID

    out = _chunk_superblocks(quant_iq3_s, x, qw)
    if out is not None:
        return out
    x = x.reshape(-1, QK_K).astype(np.float32)
    nb = len(x)
    w = _iq_weights(x, qw)
    xg, wg = x.reshape(-1, 4), w.reshape(-1, 4)
    a = np.abs(xg)
    grid = IQ3S_GRID.astype(np.float32)  # [512, 4]

    moments = _grid_moments(a, wg, grid)
    rows = _best_grid_rows(a, wg, grid, moments=moments)
    g = grid[rows]
    a32, w32, g32 = (v.reshape(-1, 32) for v in (a, wg, g))
    e = np.maximum(_ls_scale(a32, w32, g32), 0.0).reshape(nb, 8)
    d0 = e.max(-1) / 31.0

    def _fit(d):
        dn = np.where(d > 0, d, 1.0).astype(np.float32)
        ei = e
        for _ in range(3):  # alternate rows <-> per-ib32 level refit
            ls = np.clip(_nearest_int((ei / dn[:, None] - 1.0) / 2.0),
                         0, 15).astype(np.float32)
            eff = (dn[:, None] * (1.0 + 2.0 * ls)).repeat(8, axis=1).reshape(-1)
            rows = _best_grid_rows(a, wg, grid, eff=eff, moments=moments)
            g = grid[rows]
            ei = np.maximum(_ls_scale(*(v.reshape(-1, 32) for v in (a, wg, g))),
                            0.0).reshape(nb, 8)
        err = (wg * (eff[:, None] * g - a) ** 2).sum(-1).reshape(nb, -1).sum(-1)
        return ls.astype(np.int64), rows, err

    best = None
    for f in (0.7, 0.8, 0.9, 1.0, 1.1, 1.25, 1.45):
        d = _f16_round(d0 * f)
        ls, rows_c, err = _fit(d)
        if best is None:
            best = [d, ls, rows_c, err]
        else:
            upd = err < best[3]
            best[0] = np.where(upd, d, best[0])
            best[1] = np.where(upd[:, None], ls, best[1])
            best[2] = np.where(upd.repeat(64), rows_c, best[2])
            best[3] = np.minimum(err, best[3])
    d, ls, rows = best[0], best[1], best[2].reshape(nb, 8, 8)

    qs = (rows & 0xFF).astype(np.uint8).reshape(nb, 64)
    qh = ((rows >> 8) << np.arange(8)).sum(-1).astype(np.uint8)  # [nb, 8]
    sbits = (xg < 0).astype(np.int64).reshape(nb, 32, 8)
    signs = (sbits << np.arange(8)).sum(-1).astype(np.uint8)  # [nb, 32]
    scales = (ls[:, 0::2] | (ls[:, 1::2] << 4)).astype(np.uint8)  # [nb, 4]
    return np.concatenate(
        [_fp16_bytes(d), qs, qh, signs, scales],
        axis=1).astype(np.uint8).reshape(-1)


def quant_iq4_xs(x: np.ndarray, qw: np.ndarray | None = None) -> np.ndarray:
    """IQ4_XS (layout: dequant.dequant_iq4_xs): the IQ4_NL nonlinear LUT
    with per-sub-32 6-bit levels under one fp16 super scale;
    v = d*ls*kvalues[q]."""
    x = x.reshape(-1, QK_K).astype(np.float32)
    nb = len(x)
    w = _iq_weights(x, qw)
    xs, ws = x.reshape(-1, 32), w.reshape(-1, 32)
    kv = KVALUES_IQ4NL.astype(np.float32)

    # per-sub LS scale via one assignment round at amax init (iq4_nl style)
    amax, mx = _signed_absmax(xs)
    e = mx / float(KVALUES_IQ4NL[0])
    e = np.where(amax < GROUP_MAX_EPS, 0.0, e)
    en = np.where(e != 0, e, 1.0)
    q = np.argmin(np.abs(xs[:, :, None] / en[:, None, None] - kv), axis=-1)
    e = _ls_scale(xs, ws, kv[q])
    d = _f16_round(np.abs(e).reshape(nb, 8).max(-1) / 31.0)
    dn = np.where(d > 0, d, 1.0)
    ls = np.clip(_nearest_int(e.reshape(nb, 8) / dn[:, None]), -32, 31)
    eff = (dn[:, None] * ls).reshape(-1)
    effn = np.where(eff != 0, eff, 1.0)
    q = np.argmin(np.abs(xs[:, :, None] / effn[:, None, None] - kv),
                  axis=-1).astype(np.uint8)
    q = np.where((eff == 0)[:, None], np.uint8(np.argmin(np.abs(kv))), q)

    lsu = (ls + 32).astype(np.uint16)  # [nb, 8]
    scales_l = (lsu[:, 0::2] & 0xF) | ((lsu[:, 1::2] & 0xF) << 4)  # [nb, 4]
    sh = ((lsu >> 4).astype(np.uint16) << (2 * np.arange(8))).sum(-1)
    scales_h = sh.astype(np.uint16)[:, None].view(np.uint8)  # [nb, 2]
    qv = q.reshape(nb, 8, 32)
    qs = (qv[:, :, :16] | (qv[:, :, 16:] << 4)).reshape(nb, 128)
    return np.concatenate(
        [_fp16_bytes(d), scales_h, scales_l.astype(np.uint8), qs],
        axis=1).astype(np.uint8).reshape(-1)


# ---------------------------------------------------------------------------
# K-quants
# ---------------------------------------------------------------------------


def _pack_k4_scales(ls: np.ndarray, lm: np.ndarray) -> np.ndarray:
    """[nb,8] 6-bit scales/mins -> [nb,12] bytes (get_scale_min_k4 layout)."""
    nb = len(ls)
    out = np.zeros((nb, 12), dtype=np.uint8)
    out[:, 0:4] = ls[:, 0:4] & 63
    out[:, 4:8] = lm[:, 0:4] & 63
    out[:, 8:12] = (ls[:, 4:8] & 0xF) | ((lm[:, 4:8] & 0xF) << 4)
    out[:, 0:4] |= (ls[:, 4:8] >> 4).astype(np.uint8) << 6
    out[:, 4:8] |= (lm[:, 4:8] >> 4).astype(np.uint8) << 6
    return out


def _unpack_k4_scales(packed: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    q = packed.astype(np.int32)
    sc = np.concatenate(
        [q[:, 0:4] & 63, (q[:, 8:12] & 0xF) | ((q[:, 0:4] >> 6) << 4)], axis=1
    )
    m = np.concatenate(
        [q[:, 4:8] & 63, (q[:, 8:12] >> 4) | ((q[:, 4:8] >> 6) << 4)], axis=1
    )
    return sc, m


def quant_q4_K(x: np.ndarray, qw: np.ndarray | None = None) -> np.ndarray:
    x = x.reshape(-1, QK_K).astype(np.float32)
    nb = len(x)
    xg = x.reshape(-1, 32)  # [nb*8, 32]
    if qw is None:
        av = np.sqrt((xg * xg).mean(axis=-1, keepdims=True))
        weights = av + np.abs(xg)
    else:
        sigma2 = 2.0 * (x * x).mean(axis=-1)  # [nb] (impl variant)
        weights = qw.reshape(-1, 32) * np.sqrt(
            sigma2.repeat(8)[:, None] + xg * xg
        )
    L, scales, mins = make_qkx2_quants(xg, weights, 15, -1.0, 0.1, 20, False)
    scales = scales.reshape(nb, 8)
    mins = mins.reshape(nb, 8)
    max_scale = scales.max(axis=-1)
    max_min = mins.max(axis=-1)
    inv_scale = np.where(max_scale > 0, 63.0 / np.where(max_scale == 0, 1, max_scale), 0.0)
    inv_min = np.where(max_min > 0, 63.0 / np.where(max_min == 0, 1, max_min), 0.0)
    ls = np.minimum(63, _nearest_int(inv_scale[:, None] * scales)).astype(np.uint8)
    lm = np.minimum(63, _nearest_int(inv_min[:, None] * mins)).astype(np.uint8)
    packed_scales = _pack_k4_scales(ls, lm)
    d = _f16_round(max_scale / 63.0)
    dmin = _f16_round(max_min / 63.0)
    sc, mn = _unpack_k4_scales(packed_scales)
    deff = d[:, None] * sc  # [nb,8]
    meff = dmin[:, None] * mn
    Lq = np.clip(
        _nearest_int(
            (x.reshape(nb, 8, 32) + meff[:, :, None])
            / np.where(deff == 0, 1, deff)[:, :, None]
        ),
        0,
        15,
    )
    Lq = np.where((deff == 0)[:, :, None], L.reshape(nb, 8, 32), Lq).astype(np.uint8)
    lo = Lq[:, 0::2, :]  # sub-blocks 0,2,4,6
    hi = Lq[:, 1::2, :]
    qs = (lo | (hi << 4)).reshape(nb, 128)
    return np.concatenate(
        [_fp16_bytes(d), _fp16_bytes(dmin), packed_scales, qs], axis=1
    ).astype(np.uint8).reshape(-1)


def quant_q5_K(x: np.ndarray, qw: np.ndarray | None = None) -> np.ndarray:
    x = x.reshape(-1, QK_K).astype(np.float32)
    nb = len(x)
    xg = x.reshape(-1, 32)
    if qw is None:
        av = np.sqrt((xg * xg).mean(axis=-1, keepdims=True))
        weights = av + np.abs(xg)
    else:
        sigma2 = 2.0 * (x * x).mean(axis=-1)
        weights = qw.reshape(-1, 32) * np.sqrt(sigma2.repeat(8)[:, None] + xg * xg)
    L, scales, mins = make_qkx2_quants(xg, weights, 31, -0.5, 0.1, 15, False)
    scales = scales.reshape(nb, 8)
    mins = mins.reshape(nb, 8)
    max_scale = scales.max(axis=-1)
    max_min = mins.max(axis=-1)
    inv_scale = np.where(max_scale > 0, 63.0 / np.where(max_scale == 0, 1, max_scale), 0.0)
    inv_min = np.where(max_min > 0, 63.0 / np.where(max_min == 0, 1, max_min), 0.0)
    ls = np.minimum(63, _nearest_int(inv_scale[:, None] * scales)).astype(np.uint8)
    lm = np.minimum(63, _nearest_int(inv_min[:, None] * mins)).astype(np.uint8)
    packed_scales = _pack_k4_scales(ls, lm)
    d = _f16_round(max_scale / 63.0)
    dmin = _f16_round(max_min / 63.0)
    sc, mn = _unpack_k4_scales(packed_scales)
    deff = d[:, None] * sc
    meff = dmin[:, None] * mn
    Lq = np.clip(
        _nearest_int(
            (x.reshape(nb, 8, 32) + meff[:, :, None])
            / np.where(deff == 0, 1, deff)[:, :, None]
        ),
        0,
        31,
    )
    Lq = np.where((deff == 0)[:, :, None], L.reshape(nb, 8, 32), Lq)
    lo_sb = Lq[:, 0::2, :]  # [nb,4,32] even sub-blocks
    hi_sb = Lq[:, 1::2, :]
    ql = ((lo_sb & 0xF) | ((hi_sb & 0xF) << 4)).reshape(nb, 128).astype(np.uint8)
    jj = np.arange(4)
    qh = (
        ((lo_sb >> 4) << (2 * jj)[None, :, None]).sum(axis=1)
        | ((hi_sb >> 4) << (2 * jj + 1)[None, :, None]).sum(axis=1)
    ).astype(np.uint8)  # [nb,32]
    return np.concatenate(
        [_fp16_bytes(d), _fp16_bytes(dmin), packed_scales, qh, ql], axis=1
    ).astype(np.uint8).reshape(-1)


def quant_q6_K(x: np.ndarray, qw: np.ndarray | None = None) -> np.ndarray:
    x = x.reshape(-1, QK_K).astype(np.float32)
    nb = len(x)
    xg = x.reshape(-1, 16)  # [nb*16, 16]
    _, scales = make_qx_quants(xg, 32, 1, None if qw is None else qw.reshape(-1, 16))
    scales = scales.reshape(nb, 16)
    idx = np.argmax(np.abs(scales), axis=-1)
    max_scale = np.take_along_axis(scales, idx[:, None], axis=-1)[:, 0]
    dead = np.abs(max_scale) < GROUP_MAX_EPS
    max_safe = np.where(dead, 1.0, max_scale)
    iscale = -128.0 / max_safe
    d = _f16_round(1.0 / iscale)
    sc8 = np.minimum(127, _nearest_int(iscale[:, None] * scales)).astype(np.int8)
    deff = d[:, None] * sc8  # [nb,16]
    Lq = np.clip(
        _nearest_int(
            x.reshape(nb, 16, 16) / np.where(deff == 0, 1, deff)[:, :, None]
        ),
        -32,
        31,
    ) + 32
    Lq = np.where((deff == 0)[:, :, None], 32, Lq).astype(np.uint8)  # zero value
    Lh = Lq.reshape(nb, 2, 4, 32)  # [nb, half, quarter k, l]
    q1, q2, q3, q4 = Lh[:, :, 0], Lh[:, :, 1], Lh[:, :, 2], Lh[:, :, 3]
    ql = np.concatenate(
        [(q1 & 0xF) | ((q3 & 0xF) << 4), (q2 & 0xF) | ((q4 & 0xF) << 4)], axis=2
    ).reshape(nb, 128)
    qh = ((q1 >> 4) | ((q2 >> 4) << 2) | ((q3 >> 4) << 4) | ((q4 >> 4) << 6)).reshape(
        nb, 64
    )
    out = np.concatenate(
        [ql, qh, sc8.view(np.uint8), _fp16_bytes(d)], axis=1
    ).astype(np.uint8)
    out[dead] = 0
    return out.reshape(-1)


def quant_q2_K(x: np.ndarray, qw: np.ndarray | None = None) -> np.ndarray:
    x = x.reshape(-1, QK_K).astype(np.float32)
    nb = len(x)
    xg = x.reshape(-1, 16)  # [nb*16, 16]
    weights = np.abs(xg)
    L, scales, mins = make_qkx2_quants(xg, weights, 3, -0.5, 0.1, 15, True)
    scales = scales.reshape(nb, 16)
    mins = mins.reshape(nb, 16)
    q4scale = 15.0
    max_scale = scales.max(axis=-1)
    max_min = mins.max(axis=-1)
    sc_q = np.where(
        (max_scale > 0)[:, None],
        _nearest_int(q4scale * scales / np.where(max_scale == 0, 1, max_scale)[:, None]),
        0,
    ).astype(np.uint8)
    d = np.where(max_scale > 0, _f16_round(max_scale / q4scale), 0.0).astype(np.float32)
    mn_q = np.where(
        (max_min > 0)[:, None],
        _nearest_int(q4scale * mins / np.where(max_min == 0, 1, max_min)[:, None]),
        0,
    ).astype(np.uint8)
    dmin = np.where(max_min > 0, _f16_round(max_min / q4scale), 0.0).astype(np.float32)
    packed_scales = (sc_q | (mn_q << 4)).astype(np.uint8)  # [nb,16]
    deff = d[:, None] * (packed_scales & 0xF)  # [nb,16]
    meff = dmin[:, None] * (packed_scales >> 4)
    Lq = np.clip(
        _nearest_int(
            (x.reshape(nb, 16, 16) + meff[:, :, None])
            / np.where(deff == 0, 1, deff)[:, :, None]
        ),
        0,
        3,
    )
    Lq = np.where((deff == 0)[:, :, None], L.reshape(nb, 16, 16), Lq).astype(np.uint8)
    Lh = Lq.reshape(nb, 2, 4, 32)  # [nb, half, j, byte-elements]
    qs = (
        Lh[:, :, 0] | (Lh[:, :, 1] << 2) | (Lh[:, :, 2] << 4) | (Lh[:, :, 3] << 6)
    ).reshape(nb, 64)
    return np.concatenate(
        [packed_scales, qs, _fp16_bytes(d), _fp16_bytes(dmin)], axis=1
    ).astype(np.uint8).reshape(-1)


def quant_q3_K(x: np.ndarray, qw: np.ndarray | None = None) -> np.ndarray:
    x = x.reshape(-1, QK_K).astype(np.float32)
    nb = len(x)
    xg = x.reshape(-1, 16)
    _, scales = make_q3_quants(xg, 4)
    scales = scales.reshape(nb, 16)
    idx = np.argmax(np.abs(scales), axis=-1)
    max_scale = np.take_along_axis(scales, idx[:, None], axis=-1)[:, 0]
    dead = max_scale == 0
    max_safe = np.where(dead, 1.0, max_scale)
    iscale = -32.0 / max_safe
    l6 = (np.clip(_nearest_int(iscale[:, None] * scales), -32, 31) + 32).astype(np.uint8)
    l6 = np.where(dead[:, None], 0, l6)
    # 6-bit scale packing (quantize_row_q3_K_ref: low nibbles [j<8 into 0..7,
    # j>=8 into high nibble of 0..7], top 2 bits into bytes 8..11)
    packed = np.zeros((nb, 12), dtype=np.uint8)
    packed[:, 0:8] = l6[:, 0:8] & 0xF
    packed[:, 0:8] |= (l6[:, 8:16] & 0xF) << 4
    jj = np.arange(16)
    top = (l6 >> 4).astype(np.uint8)  # [nb,16] 2 bits
    for j in range(16):
        packed[:, 8 + j % 4] |= top[:, j] << (2 * (j // 4))
    d = np.where(dead, 0.0, _f16_round(1.0 / iscale)).astype(np.float32)
    # effective 6-bit scales, then element requantization
    sc = np.concatenate(
        [packed[:, 0:8] & 0xF, packed[:, 0:8] >> 4], axis=1
    ).astype(np.int32)
    for j in range(16):
        sc[:, j] |= ((packed[:, 8 + j % 4] >> (2 * (j // 4))) & 3) << 4
    sc -= 32
    deff = d[:, None] * sc
    Lq = np.clip(
        _nearest_int(
            x.reshape(nb, 16, 16) / np.where(deff == 0, 1, deff)[:, :, None]
        ),
        -4,
        3,
    ) + 4
    Lq = np.where((deff == 0)[:, :, None], 4, Lq).astype(np.uint8)
    L = Lq.reshape(nb, QK_K)
    hbit = (L > 3).astype(np.uint8)
    Llow = np.where(L > 3, L - 4, L)
    # hmask: element j -> byte j%32, bit j//32
    hmask = (
        hbit.reshape(nb, 8, 32) << np.arange(8)[None, :, None]
    ).sum(axis=1).astype(np.uint8)
    Lh = Llow.reshape(nb, 2, 4, 32)
    qs = (
        Lh[:, :, 0] | (Lh[:, :, 1] << 2) | (Lh[:, :, 2] << 4) | (Lh[:, :, 3] << 6)
    ).reshape(nb, 64)
    out = np.concatenate([hmask, qs, packed, _fp16_bytes(d)], axis=1).astype(np.uint8)
    return out.reshape(-1)


def quant_q8_K(x: np.ndarray) -> np.ndarray:
    """Activation-side superblock format (float d + int8 + bsums)."""
    x = x.reshape(-1, QK_K).astype(np.float32)
    nb = len(x)
    idx = np.argmax(np.abs(x), axis=-1)
    mx = np.take_along_axis(x, idx[:, None], axis=-1)[:, 0]
    amax = np.abs(mx)
    iscale = np.where(amax != 0, -127.0 / np.where(mx == 0, 1, mx), 0.0)
    q = np.clip(_nearest_int(iscale[:, None] * x), -128, 127).astype(np.int8)
    d = np.where(iscale != 0, 1.0 / np.where(iscale == 0, 1, iscale), 0.0).astype(
        np.float32
    )
    bsums = q.reshape(nb, 16, 16).sum(axis=-1, dtype=np.int16)
    return np.concatenate(
        [
            d.view(np.uint8).reshape(nb, 4),
            q.view(np.uint8),
            bsums.view(np.uint8).reshape(nb, 32),
        ],
        axis=1,
    ).astype(np.uint8).reshape(-1)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

_QUANT = {
    GGMLType.Q4_0: quant_q4_0,
    GGMLType.Q4_1: quant_q4_1,
    GGMLType.Q5_0: quant_q5_0,
    GGMLType.Q5_1: quant_q5_1,
    GGMLType.Q8_0: quant_q8_0,
    GGMLType.Q2_K: quant_q2_K,
    GGMLType.Q3_K: quant_q3_K,
    GGMLType.Q4_K: quant_q4_K,
    GGMLType.Q5_K: quant_q5_K,
    GGMLType.Q6_K: quant_q6_K,
    GGMLType.Q8_K: quant_q8_K,
    GGMLType.MXFP4: quant_mxfp4,
    GGMLType.IQ4_NL: quant_iq4_nl,
    GGMLType.IQ2_XS: quant_iq2_xs,
    GGMLType.IQ3_S: quant_iq3_s,
    GGMLType.IQ4_XS: quant_iq4_xs,
}

IMATRIX_AWARE = {GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K,
                 GGMLType.IQ2_XS, GGMLType.IQ3_S, GGMLType.IQ4_XS}


def quantize(x: np.ndarray, dtype: GGMLType, qw: np.ndarray | None = None) -> np.ndarray:
    """Quantize float array -> packed uint8 bytes. `qw`: importance weights."""
    if dtype == GGMLType.F32:
        return np.ascontiguousarray(x, dtype=np.float32).view(np.uint8).reshape(-1)
    if dtype == GGMLType.F16:
        return np.ascontiguousarray(x, dtype=np.float16).view(np.uint8).reshape(-1)
    if dtype == GGMLType.BF16:
        u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
        rounded = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)
        return rounded.view(np.uint8).reshape(-1)
    fn = _QUANT.get(dtype)
    if fn is None:
        raise NotImplementedError(f"quantize: {dtype.name}")
    if qw is not None and dtype in IMATRIX_AWARE:
        return fn(x, qw=qw)
    return fn(x)
