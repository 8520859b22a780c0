"""Slot-table KV cache: per sequence a fixed row of slots with an explicit
position label per slot.

Port of the JAX package's runtime/kv_cache.py KVCache: the memory of every
context that is not the page pool (Context(paged=False)). Attention masks
come from `pos` (slot -> position, -1 = empty), so seq_rm / seq_cp are plain
tensor updates. Layout: per layer k/v [n_seqs, Hkv, n_slots, D] (the head
axis before the slot axis, so the attention kernel streams [S, D] tiles per
head), int8 with f32 row scales [n_seqs, Hkv, n_slots] when quantized; the
last slot of each sequence absorbs padding writes. Writes update the
tensors in place, where the JAX package rebuilds them functionally.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .paged_kv import _quant_rows


@dataclass
class KVCache:
    """k, v:    lists of L tensors [n_seqs, Hkv, n_slots, D] (int8 if quantized)
    pos:     [n_seqs, n_slots] int32, -1 = empty
    k_scale: list of L tensors [n_seqs, Hkv, n_slots] f32 (quantized)
    ring:    window cache, slot = pos % capacity (slot order is not
             position order)"""

    k: list
    v: list
    pos: torch.Tensor
    k_scale: list | None = None
    v_scale: list | None = None
    ring: bool = False

    @classmethod
    def create(cls, n_layers: int, n_seqs: int, n_slots: int, n_kv_heads: int,
               head_dim_k: int, head_dim_v: int | None = None, dtype=torch.bfloat16,
               quantized: bool = False, ring: bool = False, device="cpu") -> "KVCache":
        head_dim_v = head_dim_v or head_dim_k
        kd = torch.int8 if quantized else dtype

        def zeros(*shape, dt):
            return torch.zeros(shape, dtype=dt, device=device)

        rows = (n_seqs, n_kv_heads, n_slots)
        return cls(
            k=[zeros(*rows, head_dim_k, dt=kd) for _ in range(n_layers)],
            v=[zeros(*rows, head_dim_v, dt=kd) for _ in range(n_layers)],
            pos=torch.full((n_seqs, n_slots), -1, dtype=torch.int32, device=device),
            k_scale=[zeros(*rows, dt=torch.float32) for _ in range(n_layers)]
            if quantized else None,
            v_scale=[zeros(*rows, dt=torch.float32) for _ in range(n_layers)]
            if quantized else None,
            ring=ring,
        )

    @property
    def n_slots(self) -> int:
        return self.k[0].shape[2]

    @property
    def capacity(self) -> int:
        return self.n_slots - 1  # the last slot is the padding trash slot

    @property
    def quantized(self) -> bool:
        return self.k[0].dtype == torch.int8

    def slot_of(self, positions: torch.Tensor) -> torch.Tensor:
        """Position -> slot (ring caches wrap; invalid -> trash slot)."""
        cap = self.capacity
        pos = positions.long()
        s = torch.remainder(pos, cap) if self.ring else torch.clamp(pos, max=cap - 1)
        return torch.where(pos >= 0, s, torch.full_like(s, self.n_slots - 1))

    def layer_view(self, il: int):
        """-> (cache, local layer index): identity for the unified cache."""
        return self, il

    # -- write ----------------------------------------------------------
    def write_layer(self, il: int, seq_idx: torch.Tensor, positions: torch.Tensor,
                    k_new: torch.Tensor, v_new: torch.Tensor,
                    update_pos: bool | None = None) -> None:
        """Position-addressed in-place write: the cache derives its own slots."""
        self.write(il, seq_idx, self.slot_of(positions), k_new, v_new, positions,
                   update_pos=update_pos)

    def write(self, layer: int, seq_idx: torch.Tensor, slots: torch.Tensor,
              k_new: torch.Tensor, v_new: torch.Tensor, positions: torch.Tensor,
              update_pos: bool | None = None) -> None:
        """seq_idx/slots/positions [N], k_new/v_new [N, Hkv, D]: row i goes to
        (seq_idx[i], slots[i]), padding rows to the trash slot. One scatter
        serves the JAX cache's three write shapes (single row, contiguous
        run, scatter): they differ only in where padding rows land, and
        those carry position -1 everywhere. Position labels are written by
        layer 0 unless update_pos says otherwise."""
        seq, sl = seq_idx.long(), slots.long()

        def put(buf, rows):  # rows [N, Hkv, ...] -> buf[seq[i], :, sl[i]]
            buf[seq, :, sl] = rows.to(buf.dtype)

        if self.quantized:
            k_q, k_s = _quant_rows(k_new)
            v_q, v_s = _quant_rows(v_new)
            put(self.k[layer], k_q)
            put(self.v[layer], v_q)
            put(self.k_scale[layer], k_s)
            put(self.v_scale[layer], v_s)
        else:
            put(self.k[layer], k_new)
            put(self.v[layer], v_new)
        if update_pos if update_pos is not None else layer == 0:
            self.pos[seq, sl] = positions.to(torch.int32)

    # -- read -----------------------------------------------------------
    def read(self, layer: int, seq_idx: torch.Tensor | None = None, dtype=torch.bfloat16):
        """-> (k, v) [n_seqs or B, Hkv, n_slots, D] dequantized (in `dtype`
        arithmetic, as the JAX cache does); seq_idx picks the sequences
        before the dequantization."""
        k, v = self.k[layer], self.v[layer]
        if seq_idx is not None:
            k, v = k[seq_idx.long()], v[seq_idx.long()]
        if not self.quantized:
            return k, v
        ks, vs = self.k_scale[layer], self.v_scale[layer]
        if seq_idx is not None:
            ks, vs = ks[seq_idx.long()], vs[seq_idx.long()]
        return (k.to(dtype) * ks[..., None].to(dtype), v.to(dtype) * vs[..., None].to(dtype))

    # -- sequence ops (llama_memory seq_rm / seq_cp analog) ---------------
    def seq_rm(self, seq: int, p0: int = 0, p1: int = 1 << 30) -> None:
        row = self.pos[seq]
        row[(row >= p0) & (row < p1)] = -1

    def seq_cp(self, dst: int, src: int) -> None:
        if dst == src:
            return
        bufs = list(self.k) + list(self.v) + [self.pos]
        if self.quantized:
            bufs += list(self.k_scale) + list(self.v_scale)
        for buf in bufs:
            buf[dst].copy_(buf[src])

    def seq_len(self, seq: int) -> int:
        return int((self.pos[seq] >= 0).sum())
