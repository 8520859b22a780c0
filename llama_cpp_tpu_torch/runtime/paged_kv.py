"""Paged KV cache: one shared page pool per layer + per-sequence page tables.

Analog of the reference's unified KV cache cell pool (src/llama-kv-cache.h:
196 find_slot; SET_ROWS writes :205-212):

- k/v: per-layer pools [Hkv, S_pool, D] (int8 with f32 row scales when
  quantized), S_pool = n_pages * page, so device memory is bounded by the
  pool, not n_seqs * n_ctx;
- table [n_seqs, max_pages] int32 maps (seq, pos // page) -> page id;
  unallocated entries point at the trash page n_pages - 1, whose last row
  also absorbs padding writes;
- page allocation is host-side bookkeeping in PageAllocator.

Because table[s, j] covers positions [j*page, (j+1)*page), a sequence's
virtual slot axis is position-ordered: slot_of(pos) = table[s, pos // page]
* page + pos % page. Writes update the pools in place (index_copy_), where the
JAX package rebuilds them functionally.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch


class KVCacheFull(RuntimeError):
    """Pool exhausted (reference llama_decode FAILED_PREPARE analog)."""


def _quant_rows(x: torch.Tensor):
    """Per-head-row int8 quantization (q8_0-style, group = head_dim).
    The scale is amax times the f32 reciprocal of 127: XLA rewrites the JAX
    package's `amax / 127.0` that way, and matching it stores the same
    bytes as the JAX pool."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True) * (1.0 / 127.0)
    q = torch.round(xf / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return q, scale[..., 0]


@dataclass
class PagedKVCache:
    """Page-pool KV storage.

    k, v:      list of L tensors [Hkv, S_pool, D] (int8 if quantized)
    pos:       [S_pool] int32 position label per pool row (-1 = empty)
    table:     [n_seqs, max_pages] int32 page id per (seq, pos // page)
    k_scale:   list of L tensors [Hkv, S_pool] f32 row scales (quantized)
    """

    k: list
    v: list
    pos: torch.Tensor
    table: torch.Tensor
    k_scale: list | None = None
    v_scale: list | None = None
    page: int = 512

    @classmethod
    def create(cls, n_layers: int, n_seqs: int, n_pages: int, max_pages: int,
               n_kv_heads: int, head_dim_k: int, head_dim_v: int | None = None,
               dtype=torch.bfloat16, quantized: bool = False, page: int = 512,
               device="cpu") -> "PagedKVCache":
        """n_pages includes the reserved trash page (the last id)."""
        head_dim_v = head_dim_v or head_dim_k
        kd = torch.int8 if quantized else dtype
        s_pool = n_pages * page

        def zeros(*shape, dt):
            return torch.zeros(shape, dtype=dt, device=device)

        return cls(
            k=[zeros(n_kv_heads, s_pool, head_dim_k, dt=kd) for _ in range(n_layers)],
            v=[zeros(n_kv_heads, s_pool, head_dim_v, dt=kd) for _ in range(n_layers)],
            pos=torch.full((s_pool,), -1, dtype=torch.int32, device=device),
            table=torch.full((n_seqs, max_pages), n_pages - 1, dtype=torch.int32,
                             device=device),
            k_scale=[zeros(n_kv_heads, s_pool, dt=torch.float32) for _ in range(n_layers)]
            if quantized else None,
            v_scale=[zeros(n_kv_heads, s_pool, dt=torch.float32) for _ in range(n_layers)]
            if quantized else None,
            page=page,
        )

    @property
    def n_pages(self) -> int:
        return self.k[0].shape[1] // self.page

    @property
    def max_pages(self) -> int:
        return self.table.shape[1]

    @property
    def trash_slot(self) -> int:
        return self.k[0].shape[1] - 1  # last row of the trash page

    @property
    def quantized(self) -> bool:
        return self.k[0].dtype == torch.int8

    def layer_view(self, il: int):
        """-> (memory, local layer index): identity for the pool."""
        return self, il

    # -- write ----------------------------------------------------------
    def slot_of(self, seq_idx: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """(seq, position) -> pool row. Invalid positions -> trash row."""
        pos = positions.long()
        pg = torch.clamp(torch.div(pos, self.page, rounding_mode="floor"), 0,
                         self.max_pages - 1)
        pid = self.table[seq_idx.long(), pg].long()
        slot = pid * self.page + torch.remainder(pos, self.page)
        return torch.where(pos >= 0, slot, torch.full_like(slot, self.trash_slot))

    def write_layer(self, il: int, seq_idx: torch.Tensor, positions: torch.Tensor,
                    k_new: torch.Tensor, v_new: torch.Tensor,
                    update_pos: bool | None = None) -> None:
        """Position-addressed in-place write (SET_ROWS analog).
        seq_idx/positions [N], k_new/v_new [N, Hkv, D]. Position labels are
        written by layer 0 unless update_pos says otherwise."""
        slots = self.slot_of(seq_idx, positions)
        if self.quantized:
            k_q, k_s = _quant_rows(k_new)
            v_q, v_s = _quant_rows(v_new)
            self.k[il].index_copy_(1, slots, k_q.transpose(0, 1))
            self.v[il].index_copy_(1, slots, v_q.transpose(0, 1))
            self.k_scale[il].index_copy_(1, slots, k_s.transpose(0, 1))
            self.v_scale[il].index_copy_(1, slots, v_s.transpose(0, 1))
        else:
            self.k[il].index_copy_(1, slots, k_new.to(self.k[il].dtype).transpose(0, 1))
            self.v[il].index_copy_(1, slots, v_new.to(self.v[il].dtype).transpose(0, 1))
        if update_pos if update_pos is not None else il == 0:
            self.pos.index_copy_(0, slots, positions.to(torch.int32))

    # -- read -----------------------------------------------------------
    def seq_slot_pos(self, seq_idx: torch.Tensor) -> torch.Tensor:
        """-> [B, n_slots] position label per virtual slot."""
        tb = self.table[seq_idx.long()].long()
        return self.pos.reshape(self.n_pages, self.page)[tb].reshape(tb.shape[0], -1)

    def gather_seq(self, layer: int, seq_idx: torch.Tensor, dtype=torch.bfloat16):
        """Dense per-sequence view for the non-kernel attention path:
        -> (k [B, Hkv, S, Dk], v [B, Hkv, S, Dv], slot_pos [B, S])."""
        tb = self.table[seq_idx.long()].long()  # [B, MP]
        B = tb.shape[0]
        H = self.k[0].shape[0]

        def view(buf):
            d = buf.shape[2]
            b4 = buf.reshape(H, self.n_pages, self.page, d)
            return b4[:, tb].permute(1, 0, 2, 3, 4).reshape(B, H, -1, d)

        k = view(self.k[layer])
        v = view(self.v[layer])
        if self.quantized:
            def sview(buf):
                b3 = buf.reshape(H, self.n_pages, self.page)
                return b3[:, tb].permute(1, 0, 2, 3).reshape(B, H, -1)

            k = k.to(dtype) * sview(self.k_scale[layer])[..., None].to(dtype)
            v = v.to(dtype) * sview(self.v_scale[layer])[..., None].to(dtype)
        return k, v, self.seq_slot_pos(seq_idx)

    # -- sequence ops ---------------------------------------------------
    def _seq_rows(self, seq: int) -> torch.Tensor:
        """All pool rows of a sequence's pages (incl. trash rows for
        unallocated entries) -> [max_pages * page]."""
        pages = self.table[seq].long()
        return (pages[:, None] * self.page
                + torch.arange(self.page, device=pages.device)[None, :]).reshape(-1)

    def seq_rm(self, seq: int, p0: int = 0, p1: int = 1 << 30) -> None:
        rows = self._seq_rows(seq)
        vals = self.pos[rows]
        self.pos[rows] = torch.where((vals >= p0) & (vals < p1), torch.full_like(vals, -1),
                                     vals)

    def copy_pages(self, src_pages: torch.Tensor, dst_pages: torch.Tensor) -> None:
        """Page-granular content copy (seq_cp support; the table rows are the
        caller's host-side job)."""
        src = src_pages.long()
        dst = dst_pages.long()
        H = self.k[0].shape[0]
        bufs = list(self.k) + list(self.v)
        if self.quantized:
            bufs += list(self.k_scale) + list(self.v_scale)
        for buf in bufs:
            view = buf.view(H, self.n_pages, self.page, *buf.shape[2:])
            view[:, dst] = view[:, src]
        pos2 = self.pos.view(self.n_pages, self.page)
        pos2[dst] = pos2[src]

    def seq_add(self, seq: int, p0: int, p1: int, delta: int) -> None:
        """Shift the position labels of [p0, p1) by delta (self-extend
        support). The rows stay in their pages, so slot_of no longer
        resolves shifted positions: a context shift goes through shift_seq,
        which moves the rows."""
        rows = self._seq_rows(seq)
        vals = self.pos[rows]
        mask = (vals >= p0) & (vals < p1)
        self.pos[rows] = torch.where(mask, vals + delta, vals)

    def seq_len(self, seq: int) -> int:
        return int((self.pos[self._seq_rows(seq)] >= 0).sum())

    # -- context shift (build_rope_shift analog) -------------------------
    def shift_seq(self, cfg, seq: int, n_keep: int, n_discard: int) -> None:
        """Drop positions [n_keep, n_keep + n_discard) of `seq`, slide the
        rest down and re-rotate the moved K rows by -n_discard, in place.
        Works on the sequence's position-ordered virtual rows; freeing the
        pages past the new end is the caller's host-side job. An int8 pool
        dequantizes K, rotates it in f32 and requantizes it; V rows move
        with their scales (the JAX package's PagedKVCache.shift_seq)."""
        rows = self._seq_rows(seq)
        shifted = _shift_rows(self.pos[rows], n_keep, n_discard)
        src_rows = rows[shifted.src]
        for il in range(len(self.k)):
            k_new = self.k[il][:, src_rows]  # [H, S, Dk]
            v_new = self.v[il][:, src_rows]
            if self.quantized:
                k_new = k_new.float() * self.k_scale[il][:, src_rows][..., None]
            k_new = shifted.rotate(cfg, il, k_new)
            if self.quantized:
                k_q, k_s = _quant_rows(k_new)
                self.k[il][:, rows] = k_q
                self.k_scale[il][:, rows] = k_s
                self.v_scale[il][:, rows] = self.v_scale[il][:, src_rows]
            else:
                self.k[il][:, rows] = k_new.to(self.k[il].dtype)
            self.v[il][:, rows] = v_new
        self.pos[rows] = shifted.new_pos


class ShiftedRows:
    """The row map of a context shift over one sequence's S position-ordered
    rows: row j takes row src[j]'s contents at new_pos[j] (-1: emptied),
    its K rotated by delta[j] (-n_discard where it moved, else 0)."""

    def __init__(self, src: torch.Tensor, new_pos: torch.Tensor, delta: torch.Tensor):
        self.src = src
        self.new_pos = new_pos
        self.delta = delta

    def rotate(self, cfg, il: int, k: torch.Tensor) -> torch.Tensor:
        """K rows [H, S, D] re-rotated by delta with layer il's rope, zeroed
        where the row is emptied. An MLA memory (naive or absorbed) ropes
        only the tail rope_dims of each row, its k_pe (the JAX package's
        runtime/kv_cache.py:229-241); any other the leading rope_dims."""
        from ..models.transformer import _rope_params
        from ..ops.rope import ROPE_TYPE_NONE, apply_rope

        if cfg.rope_type != ROPE_TYPE_NONE:
            rp = _rope_params(cfg, il)
            x = k.transpose(0, 1)  # [S, H, D]
            if "kv_lora_rank" in cfg.extra:
                n_rot = cfg.rope_dims
                tail = apply_rope(x[..., -n_rot:], self.delta, replace(rp, n_dims=n_rot))
                x = torch.cat([x[..., :-n_rot], tail.to(x.dtype)], dim=-1)
            else:
                x = apply_rope(x, self.delta, rp)
            k = x.transpose(0, 1)
        return torch.where((self.new_pos >= 0)[None, :, None], k, torch.zeros_like(k))


def _shift_rows(old_pos: torch.Tensor, n_keep: int, n_discard: int) -> ShiftedRows:
    """The shift of a sequence whose S position-ordered rows carry old_pos:
    rows from n_keep on take the row n_discard further on (those past the
    end are emptied), as the JAX package's shift_seq computes it."""
    S = old_pos.shape[0]
    virt = torch.arange(S, dtype=torch.int64, device=old_pos.device)
    moved = virt >= n_keep
    src = torch.where(moved, torch.clamp(virt + n_discard, max=S - 1), virt)
    src_pos = old_pos[src]
    empty = torch.full_like(old_pos, -1)
    new_pos = torch.where(moved & (src_pos >= 0) & (virt + n_discard < S), src_pos - n_discard,
                          torch.where(moved, empty, old_pos))
    delta = torch.where(moved & (new_pos >= 0), torch.full_like(old_pos, -n_discard),
                        torch.zeros_like(old_pos))
    return ShiftedRows(src, new_pos, delta)


class PageAllocator:
    """Host bookkeeping for the page pool: free list + per-seq page counts.
    The authoritative table lives here as numpy; Context mirrors it into the
    device table whenever it changes."""

    def __init__(self, n_seqs: int, n_pages: int, max_pages: int, page: int):
        self.page = page
        self.n_pages = n_pages
        self.trash = n_pages - 1
        self.max_pages = max_pages
        # LIFO free list (most-recently-freed first: warm pages get reused)
        self.free: list[int] = list(range(n_pages - 2, -1, -1))
        self.table = np.full((n_seqs, max_pages), self.trash, np.int32)
        self.count = np.zeros(n_seqs, np.int64)
        self.dirty = False  # device table out of date

    @property
    def n_free(self) -> int:
        return len(self.free)

    def pages_for(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 0) // self.page)

    def ensure(self, seq: int, n_tokens: int) -> None:
        """Allocate pages so positions [0, n_tokens) resolve. Raises
        KVCacheFull when the pool is exhausted."""
        need = min(self.pages_for(n_tokens), self.max_pages)
        while self.count[seq] < need:
            if not self.free:
                raise KVCacheFull(
                    f"KV page pool exhausted ({self.n_pages - 1} pages of "
                    f"{self.page} tokens; seq {seq} needs {need})")
            p = self.free.pop()
            self.table[seq, self.count[seq]] = p
            self.count[seq] += 1
            self.dirty = True

    def seq_pages(self, seq: int) -> np.ndarray:
        return self.table[seq, : int(self.count[seq])].copy()

    def trim(self, seq: int, n_tokens: int) -> None:
        """Free pages beyond ceil(n_tokens / page)."""
        keep = self.pages_for(n_tokens)
        while self.count[seq] > keep:
            self.count[seq] -= 1
            j = int(self.count[seq])
            self.free.append(int(self.table[seq, j]))
            self.table[seq, j] = self.trash
            self.dirty = True
