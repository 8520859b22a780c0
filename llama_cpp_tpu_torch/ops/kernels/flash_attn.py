"""Flash attention straight off the KV memory, int8 or bf16: the paged pool
(csrc/flash_attn_paged.cu) and the slot-table cache (csrc/flash_attn.cu),
each with its plain PyTorch version and its GQA fold wrapper. Both kernels
are one device function (csrc/flash_attn_common.cuh) with two layouts.

Port of flash_attention_paged / mha_flash_paged and flash_attention /
mha_flash of llama_cpp_tpu/ops/pallas/flash_attn.py, without the
decode-window tail operands of the paged one (the port writes KV in place,
so there is no window). Layouts at the public functions: the pool's k/v
[Hkv, S_pool, D], k_scale/v_scale [Hkv, S_pool] (int8; None for bf16), pos
[S_pool], table_b [B, MP]; the slot table's k/v [n_seqs, Hkv, S, D],
k_scale/v_scale [n_seqs, Hkv, S], pos [n_seqs, S] and seq_idx [B]: the
kernel reads sequence seq_idx[b] in place, where the JAX caller gathers
cache[seq_idx] first.

The mask comes from position labels only: valid = pos >= 0, causal = pos <=
row_pos, window = pos > row_pos - w. Causally dead KV is not visited: pages
at or past clip(row_pos // page + 1, 1, MP) of the pool, tiles at or past
clip(row_pos // 64 + 1, 1, S / 64) of a slot table unless it is a ring
(wrapped slots). Rows whose columns are all masked come out as 0 and are
dropped by the callers.

Two CUDA kernels a layout, chosen by the rows per (batch row, KV head), R =
G*T: from PREFILL_MIN_ROWS rows the prefill kernel (wgmma; 128 query rows a
block, 64 at heads of 256; bound by its tensor-core operations), below it
the decode kernel (swap-AB mma.sync; 8 query rows a block, the live tiles
split over blocks and merged by the last block of each row group in the
same launch; bound by the live K/V bytes). Launch
counters per CUDA kernel: "flash_attention_paged/prefill",
"flash_attention_paged/decode", "flash_attention/prefill",
"flash_attention/decode". Head dims 32, 64, 128 and 256 (K and V alike):
every head dim of this kind that the JAX package sends to its kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, scratch

HEAD_DIMS = (32, 64, 128, 256)  # the kernels' K and V head dims (K and V alike)
PREFILL_MIN_ROWS = 64  # rows per (batch row, KV head) from which the prefill kernel runs
_TILE = 64  # KV rows per kernel tile
_DECODE_ROWS = 8  # query rows per decode block
_MIN_BLOCKS = 132  # decode: one block per SM on 132 SMs before splitting KV
_MAX_SPLITS = 64  # the decode kernel's bound on KV splits
_LANES = 128  # the TPU lane width the JAX package's dispatch tests against

launches = {f"{name}/{route}": 0 for name in ("flash_attention_paged", "flash_attention")
            for route in ("prefill", "decode")}


def dispatches(head_dim_k: int, head_dim_v: int, n_slots: int, rows: int) -> bool:
    """Whether the JAX package on its accelerator sends a llama layer's
    attention to a Pallas kernel, paged or slot-table (flash_supported and
    the small-head rule of models/transformer.py:376-383); rows = T * (H //
    Hkv). There the port launches its kernel or raises."""
    dim_ok = all(d % _LANES == 0 or d in (32, 64) for d in (head_dim_k, head_dim_v))
    if not dim_ok or n_slots % _LANES:
        return False
    return min(head_dim_k, head_dim_v) >= 128 or rows >= 16


def supported(head_dim_k: int, head_dim_v: int, page: int, kv_dtype: torch.dtype) -> bool:
    """Whether the kernels take this attention: K and V heads alike of 32,
    64, 128 or 256, an int8 or bf16 memory, pages (or a slot table) of whole
    tiles."""
    return (head_dim_k in HEAD_DIMS and head_dim_v == head_dim_k and page % _TILE == 0
            and kv_dtype in (torch.int8, torch.bfloat16))


def _softmax_pv(s, mask, vv, v_scale, sinks):
    """Masked softmax of scores s [B, Hkv, R, S] (sink logit in the
    denominator only) times vv [B, Hkv, S, Dv], v_scale [B, Hkv, S] folded
    into P; rows with no unmasked column give 0."""
    s = torch.where(mask[:, None], s, torch.tensor(float("-inf"), device=s.device))
    m = s.amax(dim=-1, keepdim=True)  # [B, Hkv, R, 1]
    if sinks is not None:
        sk = sinks.float()[None, :, :, None]  # [1, Hkv, R, 1]
        m = torch.maximum(m, sk)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if sinks is not None:
        l = l + torch.exp(sk - m)
    pv = p if v_scale is None else p * v_scale[:, :, None, :]
    out = torch.einsum("bhrs,bhsd->bhrd", pv, vv)
    return torch.where(l > 0, out / torch.where(l > 0, l, torch.ones_like(l)),
                       torch.zeros_like(out))


def _scores(q, kk, k_scale, sm_scale: float, softcap: float):
    s = torch.einsum("bhrd,bhsd->bhrs", q.float(), kk)
    if k_scale is not None:
        s = s * k_scale[:, :, None, :]
    s = s * sm_scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    return s


def flash_attention_paged_plain(q, k, v, row_pos, pos, table_b, k_scale=None, v_scale=None,
                                sinks=None, *, sm_scale: float, window: int = 0,
                                softcap: float = 0.0, page: int) -> torch.Tensor:
    """Dense f32 reference of the paged kernel -> [B, Hkv, R, Dv] f32."""
    B, Hkv, R, D = q.shape
    MP = table_b.shape[1]
    rows = (table_b.long()[:, :, None] * page
            + torch.arange(page, device=q.device)).reshape(B, MP * page)
    kk = k[:, rows].float().permute(1, 0, 2, 3)  # [B, Hkv, S, D]
    vv = v[:, rows].float().permute(1, 0, 2, 3)
    cp = pos[rows]  # [B, S]
    ksb = None if k_scale is None else k_scale[:, rows].permute(1, 0, 2)  # [B, Hkv, S]
    vsb = None if v_scale is None else v_scale[:, rows].permute(1, 0, 2)
    s = _scores(q, kk, ksb, sm_scale, softcap)
    rp = row_pos.long()
    lim = torch.clamp(torch.div(rp, page, rounding_mode="floor") + 1, 1, MP)  # [B, R]
    col_page = torch.arange(MP * page, device=q.device) // page
    mask = ((col_page[None, None, :] < lim[:, :, None])
            & (cp[:, None, :] >= 0) & (cp[:, None, :] <= rp[:, :, None]))
    if window > 0:
        mask = mask & (cp[:, None, :] > rp[:, :, None] - window)
    return _softmax_pv(s, mask, vv, vsb, sinks)


def _lib(paged: bool):
    """fa_paged_launch / fa_slots_launch: 13 pointers, B, Hkv, R, the rows
    of the memory, then the layout's ints, D, the scalars, the route and
    the splits."""
    if paged:
        fn = build.library("flash_attn_paged.cu").fa_paged_launch
        tail = ([ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_float]
                + [ctypes.c_int] * 3)  # MP, page, D | sm_scale, window, softcap | prefill, splits, bf16
    else:
        fn = build.library("flash_attn.cu").fa_slots_launch
        tail = ([ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int, ctypes.c_float]
                + [ctypes.c_int] * 4)  # n_seqs, D | ... | ring, prefill, splits, bf16
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 3 + [ctypes.c_longlong]
                       + tail + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def smem_bytes(head_dim: int, prefill: bool, bf16_kv: bool) -> int:
    """Dynamic shared memory of one block of the prefill or decode kernel
    (read from the built library)."""
    return int(build.library("flash_attn_paged.cu").fa_smem_bytes(
        int(head_dim), int(prefill), int(bf16_kv)))


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"flash attention: {name} must be {dtype} {tuple(shape)} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"flash attention: {name} must be contiguous")


def route(R: int) -> str:
    """The CUDA kernel that takes R rows per (batch row, KV head)."""
    return "prefill" if R >= PREFILL_MIN_ROWS else "decode"


def decode_splits(B: int, Hkv: int, R: int, max_tiles: int) -> int:
    """KV splits of the decode kernel: enough blocks for one on every SM
    (fewer, longer splits beat two blocks an SM on the card: each split
    adds partial sums to merge and keeps fewer tiles in flight), at most
    one per tile the memory could hold and at most _MAX_SPLITS."""
    groups = B * Hkv * -(-R // _DECODE_ROWS)
    return max(1, min(max_tiles, _MAX_SPLITS, -(-_MIN_BLOCKS // groups)))


# The decode kernel's scratch per (device, stream): the splits' partial sums
# and the row groups' counters, zero between launches (the last block of a
# row group resets its own), so launches on one stream, which run in order,
# may share them.
_SCRATCH: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _launch(paged: bool, q, k, v, ks, vs, pos, row_pos, index, sinks, lay: tuple,
            max_tiles: int, sm_scale: float, window: int, softcap: float,
            ring: bool = False) -> torch.Tensor:
    """Allocate the output, pick the kernel and its splits, launch, count.
    lay: (S_pool, MP, page) of the pool or (S, n_seqs) of a slot table."""
    B, Hkv, R, D = q.shape
    dev = q.device
    for t in (q, k, v, ks, vs, pos):  # read 16 bytes at a time
        if t is not None and t.data_ptr() % 16:
            raise ValueError("flash attention: q, k, v, their scales and the position "
                             "labels must be 16-byte aligned")
    kind = route(R)
    stream = torch.cuda.current_stream(dev).cuda_stream
    splits = 1 if kind == "prefill" else decode_splits(B, Hkv, R, max_tiles)
    part = counters = None
    if splits > 1:
        n_rows = B * Hkv * R
        part, counters = scratch.grow(_SCRATCH, dev, stream, splits * n_rows * (D + 2),
                                      B * Hkv * -(-R // _DECODE_ROWS))
    out = torch.empty((B, Hkv, R, D), dtype=torch.float32, device=dev)
    quantized = ks is not None
    ptr = [None if t is None else t.data_ptr() for t in (q, k, v, ks, vs, pos, row_pos,
                                                         index, sinks)]
    part_acc = part_ml = None
    if part is not None:
        part_acc = part.data_ptr()
        part_ml = part_acc + 4 * splits * B * Hkv * R * D
    err = _lib(paged)(*ptr, part_acc, part_ml, None if counters is None else counters.data_ptr(),
                      out.data_ptr(), B, Hkv, R, *lay, D, float(sm_scale), int(window),
                      float(softcap), *(() if paged else (int(ring),)),
                      int(kind == "prefill"), splits, int(not quantized), stream)
    name = "flash_attention_paged" if paged else "flash_attention"
    build.check(err, "fa_paged_launch" if paged else "fa_slots_launch")
    launches[f"{name}/{kind}"] += 1
    return out


def flash_attention_paged(q, k, v, row_pos, pos, table_b, k_scale=None, v_scale=None,
                          sinks=None, *, sm_scale: float, window: int = 0,
                          softcap: float = 0.0, page: int) -> torch.Tensor:
    """q [B, Hkv, R, D] bf16 over the int8 (with row scales) or bf16 pool ->
    [B, Hkv, R, Dv] f32."""
    if q.device.type == "cpu":
        return flash_attention_paged_plain(q, k, v, row_pos, pos, table_b, k_scale, v_scale,
                                           sinks, sm_scale=sm_scale, window=window,
                                           softcap=softcap, page=page)
    B, Hkv, R, D = q.shape
    S_pool = k.shape[1]
    MP = table_b.shape[1]
    dev = q.device
    if dev.type != "cuda" or not supported(D, v.shape[-1], page, k.dtype):
        raise ValueError(f"flash_attention_paged: needs CUDA tensors, an int8 or bf16 pool, "
                         f"K and V head dims alike in {HEAD_DIMS} and a page multiple of "
                         f"{_TILE} (got {dev}, {k.dtype}, D={D}, Dv={v.shape[-1]}, "
                         f"page={page})")
    quantized = k.dtype == torch.int8
    if quantized != (k_scale is not None and v_scale is not None):
        raise ValueError("flash_attention_paged: an int8 pool needs its row scales, a bf16 "
                         "pool takes none")
    if S_pool % page:
        raise ValueError("flash_attention_paged: pool rows must be whole pages")
    _check(q, "q", torch.bfloat16, (B, Hkv, R, D), dev)
    _check(k, "k", k.dtype, (Hkv, S_pool, D), dev)
    _check(v, "v", k.dtype, (Hkv, S_pool, D), dev)
    if quantized:
        _check(k_scale, "k_scale", torch.float32, (Hkv, S_pool), dev)
        _check(v_scale, "v_scale", torch.float32, (Hkv, S_pool), dev)
    _check(pos, "pos", torch.int32, (S_pool,), dev)
    _check(row_pos, "row_pos", torch.int32, (B, R), dev)
    _check(table_b, "table_b", torch.int32, (B, MP), dev)
    if sinks is not None:
        _check(sinks, "sinks", torch.float32, (Hkv, R), dev)
    return _launch(True, q, k, v, k_scale if quantized else None,
                   v_scale if quantized else None, pos, row_pos, table_b, sinks,
                   (S_pool, MP, page), MP * (page // _TILE), sm_scale, window, softcap)


def _fold_gqa(q, Hkv: int, positions, sinks):
    """q [B, T, H, Dk] -> rows [B, Hkv, G*T, Dk] (query head h = h_kv * G + g
    maps to row g * T + t), their positions [B, G*T] and sink logits
    [Hkv, G*T]."""
    B, T, H, Dk = q.shape
    G = H // Hkv
    qr = (q.reshape(B, T, Hkv, G, Dk).permute(0, 2, 3, 1, 4)
          .reshape(B, Hkv, G * T, Dk).contiguous())
    row_pos = positions.repeat(1, G).to(torch.int32).contiguous()
    sink_rows = None
    if sinks is not None:
        sink_rows = sinks.float().reshape(Hkv, G).repeat_interleave(T, dim=1).contiguous()
    return qr, row_pos, sink_rows


def _unfold_gqa(out, T: int) -> torch.Tensor:
    """[B, Hkv, G*T, Dv] -> [B, T, H*Dv]."""
    B, Hkv, GT, Dv = out.shape
    G = GT // T
    return out.reshape(B, Hkv, G, T, Dv).permute(0, 3, 1, 2, 4).reshape(B, T, Hkv * G * Dv)


def mha_flash_paged(q, kvc, li: int, seq_idx, positions, *, sm_scale: float, window: int = 0,
                    softcap: float = 0.0, sinks=None) -> torch.Tensor:
    """GQA fold + pool views for the paged kernel: q [B, T, H, Dk] ->
    [B, T, H*Dv]."""
    qr, row_pos, sink_rows = _fold_gqa(q, kvc.k[li].shape[0], positions, sinks)
    table_b = kvc.table[seq_idx.long()].contiguous()
    ks, vs = (kvc.k_scale[li], kvc.v_scale[li]) if kvc.quantized else (None, None)
    out = flash_attention_paged(
        qr, kvc.k[li], kvc.v[li], row_pos, kvc.pos, table_b, ks, vs, sink_rows,
        sm_scale=sm_scale, window=window, softcap=softcap,
        page=kvc.page)  # [B, Hkv, G*T, Dv]
    return _unfold_gqa(out, q.shape[1])


def flash_attention_plain(q, k, v, row_pos, col_pos, seq_idx, k_scale=None, v_scale=None,
                          sinks=None, *, sm_scale: float, window: int = 0,
                          softcap: float = 0.0, ring: bool = False) -> torch.Tensor:
    """Dense f32 reference of the slot-table kernel -> [B, Hkv, R, Dv] f32."""
    S = k.shape[2]
    sel = seq_idx.long().clamp(0, k.shape[0] - 1)
    cp = col_pos[sel]  # [B, S]
    s = _scores(q, k[sel].float(), None if k_scale is None else k_scale[sel], sm_scale,
                softcap)
    rp = row_pos.long()
    mask = (cp[:, None, :] >= 0) & (cp[:, None, :] <= rp[:, :, None])
    if not ring:  # tiles past the row's live limit are not visited
        lim = torch.clamp(torch.div(rp, _TILE, rounding_mode="floor") + 1, 1, S // _TILE)
        col_tile = torch.arange(S, device=q.device) // _TILE
        mask = mask & (col_tile[None, None, :] < lim[:, :, None])
    if window > 0:
        mask = mask & (cp[:, None, :] > rp[:, :, None] - window)
    return _softmax_pv(s, mask, v[sel].float(), None if v_scale is None else v_scale[sel],
                       sinks)


def flash_attention(q, k, v, row_pos, col_pos, seq_idx, k_scale=None, v_scale=None,
                    sinks=None, *, sm_scale: float, window: int = 0, softcap: float = 0.0,
                    ring: bool = False) -> torch.Tensor:
    """q [B, Hkv, R, D] bf16 over the slot-table cache k/v [n_seqs, Hkv, S, D]
    (int8 with row scales [n_seqs, Hkv, S], or bf16), col_pos [n_seqs, S],
    batch row b reading sequence seq_idx[b] -> [B, Hkv, R, Dv] f32."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, row_pos, col_pos, seq_idx, k_scale, v_scale,
                                     sinks, sm_scale=sm_scale, window=window,
                                     softcap=softcap, ring=ring)
    B, Hkv, R, D = q.shape
    n_seqs, _, S, _ = k.shape
    dev = q.device
    if dev.type != "cuda" or not supported(D, v.shape[-1], S, k.dtype):
        raise ValueError(f"flash_attention: needs CUDA tensors, an int8 or bf16 cache, K and V "
                         f"head dims alike in {HEAD_DIMS} and slots a multiple of {_TILE} "
                         f"(got {dev}, {k.dtype}, D={D}, Dv={v.shape[-1]}, S={S})")
    quantized = k.dtype == torch.int8
    if quantized != (k_scale is not None and v_scale is not None):
        raise ValueError("flash_attention: an int8 cache needs its row scales, a bf16 cache "
                         "takes none")
    _check(q, "q", torch.bfloat16, (B, Hkv, R, D), dev)
    _check(k, "k", k.dtype, (n_seqs, Hkv, S, D), dev)
    _check(v, "v", k.dtype, (n_seqs, Hkv, S, D), dev)
    if quantized:
        _check(k_scale, "k_scale", torch.float32, (n_seqs, Hkv, S), dev)
        _check(v_scale, "v_scale", torch.float32, (n_seqs, Hkv, S), dev)
    _check(col_pos, "col_pos", torch.int32, (n_seqs, S), dev)
    _check(row_pos, "row_pos", torch.int32, (B, R), dev)
    _check(seq_idx, "seq_idx", torch.int32, (B,), dev)
    if sinks is not None:
        _check(sinks, "sinks", torch.float32, (Hkv, R), dev)
    return _launch(False, q, k, v, k_scale if quantized else None,
                   v_scale if quantized else None, col_pos, row_pos, seq_idx, sinks,
                   (S, n_seqs), S // _TILE, sm_scale, window, softcap, ring)


def mha_flash(q, kvc, li: int, seq_idx, positions, *, sm_scale: float, window: int = 0,
              softcap: float = 0.0, sinks=None) -> torch.Tensor:
    """GQA fold for the slot-table kernel: q [B, T, H, Dk] over layer li of a
    KVCache -> [B, T, H*Dv]. The cache and seq_idx go to the kernel as they
    are; nothing is gathered."""
    qr, row_pos, sink_rows = _fold_gqa(q, kvc.k[li].shape[1], positions, sinks)
    ks, vs = (kvc.k_scale[li], kvc.v_scale[li]) if kvc.quantized else (None, None)
    out = flash_attention(
        qr, kvc.k[li], kvc.v[li], row_pos, kvc.pos, seq_idx.to(torch.int32).contiguous(), ks,
        vs, sink_rows, sm_scale=sm_scale, window=window, softcap=softcap, ring=kvc.ring)
    return _unfold_gqa(out, q.shape[1])
