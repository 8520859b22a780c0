"""Flash attention straight off the paged KV pool, int8 or bf16
(csrc/flash_attn_paged.cu), with its plain PyTorch version and the GQA fold
wrapper.

Port of flash_attention_paged and mha_flash_paged of
llama_cpp_tpu/ops/pallas/flash_attn.py, without the decode-window tail
operands (the port writes KV in place, so there is no window). Layouts at
the public functions follow the port's pool: k/v [Hkv, S_pool, D],
k_scale/v_scale [Hkv, S_pool] (int8 pool; None for bf16), pos [S_pool],
table_b [B, MP].

The mask comes from position labels only: valid = pos >= 0, causal = pos <=
row_pos, window = pos > row_pos - w; pages at or past clip(row_pos // page
+ 1, 1, MP) are not visited. Rows whose columns are all masked come out as
0 and are dropped by the callers.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

HEAD_DIM = 128  # the kernel's K and V head dim
_TILE = 64  # KV rows per kernel tile
_MIN_BLOCKS = 264  # two blocks per SM on 132 SMs before splitting KV
_LANES = 128  # the TPU lane width the JAX package's dispatch tests against

launches = {"flash_attention_paged": 0}


def dispatches(head_dim_k: int, head_dim_v: int, n_slots: int, rows: int) -> bool:
    """Whether the JAX package on its accelerator sends a llama layer's
    attention to its paged Pallas kernel (flash_supported and the small-head
    rule of models/transformer.py:376-383); rows = T * (H // Hkv). There the
    port launches its kernel or raises."""
    dim_ok = all(d % _LANES == 0 or d in (32, 64) for d in (head_dim_k, head_dim_v))
    if not dim_ok or n_slots % _LANES:
        return False
    return min(head_dim_k, head_dim_v) >= 128 or rows >= 16


def supported(head_dim_k: int, head_dim_v: int, page: int, kv_dtype: torch.dtype) -> bool:
    """Whether the kernel takes this attention (128-wide heads, an int8 or
    bf16 pool, pages of whole tiles)."""
    return (head_dim_k == HEAD_DIM and head_dim_v == HEAD_DIM and page % _TILE == 0
            and kv_dtype in (torch.int8, torch.bfloat16))


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
    s = torch.einsum("bhrd,bhsd->bhrs", q.float(), kk)
    if k_scale is not None:
        s = s * k_scale[:, rows].permute(1, 0, 2)[:, :, None, :]  # [B, Hkv, 1, S]
    s = s * sm_scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    rp = row_pos.long()
    lim = torch.clamp(torch.div(rp, page, rounding_mode="floor") + 1, 1, MP)  # [B, R]
    col_page = torch.arange(MP * page, device=q.device) // page
    mask = ((col_page[None, None, :] < lim[:, :, None])
            & (cp[:, None, :] >= 0) & (cp[:, None, :] <= rp[:, :, None]))
    if window > 0:
        mask = mask & (cp[:, None, :] > rp[:, :, None] - window)
    s = torch.where(mask[:, None], s, torch.tensor(float("-inf"), device=q.device))
    m = s.amax(dim=-1, keepdim=True)  # [B, Hkv, R, 1]
    if sinks is not None:
        sk = sinks.float()[None, :, :, None]  # [1, Hkv, R, 1]
        m = torch.maximum(m, sk)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if sinks is not None:
        l = l + torch.exp(sk - m)
    pv = p if v_scale is None else p * v_scale[:, rows].permute(1, 0, 2)[:, :, None, :]
    out = torch.einsum("bhrs,bhsd->bhrd", pv, vv)
    return torch.where(l > 0, out / torch.where(l > 0, l, torch.ones_like(l)),
                       torch.zeros_like(out))


def _lib():
    fn = build.library("flash_attn_paged.cu").fa_paged_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 3 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int, ctypes.c_float]
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"flash_attention_paged: {name} must be {dtype} {tuple(shape)} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"flash_attention_paged: {name} must be contiguous")


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
                         f"head dim {HEAD_DIM} and a page multiple of {_TILE} (got {dev}, "
                         f"{k.dtype}, D={D}, page={page})")
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
    rpw = 1 if R <= 8 else 4
    blocks = -(-R // (4 * rpw)) * Hkv * B
    max_tiles = MP * (page // _TILE)
    splits = max(1, min(max_tiles, -(-_MIN_BLOCKS // blocks)))
    part_acc = torch.empty((splits, B, Hkv, R, D), dtype=torch.float32, device=dev)
    part_ml = torch.empty((2, splits, B, Hkv, R), dtype=torch.float32, device=dev)
    out = torch.empty((B, Hkv, R, D), dtype=torch.float32, device=dev)
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 k_scale.data_ptr() if quantized else None,
                 v_scale.data_ptr() if quantized else None, pos.data_ptr(), row_pos.data_ptr(), table_b.data_ptr(),
                 None if sinks is None else sinks.data_ptr(), part_acc.data_ptr(),
                 part_ml[0].data_ptr(), part_ml[1].data_ptr(), out.data_ptr(), B, Hkv, R,
                 S_pool, MP, page, float(sm_scale), int(window), float(softcap), rpw, splits,
                 int(not quantized), torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "fa_paged_launch")
    launches["flash_attention_paged"] += 1
    return out


def mha_flash_paged(q, kvc, li: int, seq_idx, positions, *, sm_scale: float, window: int = 0,
                    softcap: float = 0.0, sinks=None) -> torch.Tensor:
    """GQA fold + pool views for the paged kernel: q [B, T, H, Dk] ->
    [B, T, H*Dv]. Query head h = h_kv * G + g maps to row g * T + t."""
    B, T, H, Dk = q.shape
    Hkv = kvc.k[li].shape[0]
    Dv = kvc.v[li].shape[2]
    G = H // Hkv
    qr = (q.reshape(B, T, Hkv, G, Dk).permute(0, 2, 3, 1, 4)
          .reshape(B, Hkv, G * T, Dk).contiguous())
    row_pos = positions.repeat(1, G).to(torch.int32).contiguous()  # [B, G*T]
    sink_rows = None
    if sinks is not None:
        sink_rows = sinks.float().reshape(Hkv, G).repeat_interleave(T, dim=1).contiguous()
    table_b = kvc.table[seq_idx.long()].contiguous()
    ks, vs = (kvc.k_scale[li], kvc.v_scale[li]) if kvc.quantized else (None, None)
    out = flash_attention_paged(
        qr, kvc.k[li], kvc.v[li], row_pos, kvc.pos, table_b, ks, vs, sink_rows,
        sm_scale=sm_scale, window=window, softcap=softcap,
        page=kvc.page)  # [B, Hkv, G*T, Dv]
    return out.reshape(B, Hkv, G, T, Dv).permute(0, 3, 1, 2, 4).reshape(B, T, H * Dv)
