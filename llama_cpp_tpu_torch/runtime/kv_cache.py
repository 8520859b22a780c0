"""Slot-table KV cache: per sequence a fixed row of slots with an explicit
position label per slot; and the two-tier memory of interleaved
sliding-window models (ISWACache) built on it.

Port of the JAX package's runtime/kv_cache.py KVCache and ISWACache: the
memory of every context that is not the page pool (Context(paged=False)),
and the window rings of SWA layers. Attention masks
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

from .paged_kv import PagedKVCache, _quant_rows, _shift_rows


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

    def seq_add(self, seq: int, p0: int, p1: int, delta: int) -> None:
        """Shift the position labels of [p0, p1) by delta (self-extend
        support); a context shift goes through shift_seq, which also moves
        the rows and re-rotates K."""
        row = self.pos[seq]
        mask = (row >= p0) & (row < p1)
        row[mask] += delta

    def seq_len(self, seq: int) -> int:
        return int((self.pos[seq] >= 0).sum())

    # -- context shift (reference build_rope_shift, llama-kv-cache.h:297) --
    def shift_seq(self, cfg, seq: int, n_keep: int, n_discard: int) -> None:
        """Drop positions [n_keep, n_keep + n_discard) of `seq`, slide the
        rest down by n_discard slots and re-rotate the moved K rows by
        -n_discard, in place (slot = position layout). An int8 cache
        dequantizes K, rotates it in f32 and requantizes it; V rows move
        with their scales (the JAX package's KVCache.shift_seq)."""
        shifted = _shift_rows(self.pos[seq], n_keep, n_discard)
        src = shifted.src
        for il in range(len(self.k)):
            k_new = self.k[il][seq][:, src]  # [H, S, Dk]
            v_new = self.v[il][seq][:, src]
            if self.quantized:
                k_new = k_new.float() * self.k_scale[il][seq][:, src][..., None]
            k_new = shifted.rotate(cfg, il, k_new)
            if self.quantized:
                k_q, k_s = _quant_rows(k_new)
                self.k[il][seq] = k_q
                self.k_scale[il][seq] = k_s
                self.v_scale[il][seq] = self.v_scale[il][seq][:, src]
            else:
                self.k[il][seq] = k_new.to(self.k[il].dtype)
            self.v[il][seq] = v_new
        self.pos[seq] = shifted.new_pos


@dataclass
class ISWACache:
    """Two-tier KV memory of interleaved sliding-window models (reference
    llama_kv_cache_iswa, src/llama-kv-cache-iswa.h): full-attention layers
    keep the whole context, on the page pool or a slot table; SWA layers
    keep a ring per sequence sized to the window plus the largest ubatch
    (slot = position % capacity, computed on the device), so their memory
    is O(window). Each sub-cache has its own position labels, written on
    its own first layer.

    is_swa:   per model layer, whether it is a window layer
    full_idx: model layer -> layer of `full` (-1 for a window layer)
    swa_idx:  model layer -> layer of `swa` (-1 for a full layer)

    Cross-layer KV sharing (gemma3n, gemma4: cfg.extra["kv_reuse"]): a
    shared layer has no line of its own; its indices alias the line of the
    owned layer it reads (reference llama-kv-cache.cpp map_layer_ids), so
    layer_view resolves it on the pool and on the rings alike, and the
    state files, seq_cp, seq_rm and the sub-caches' own layers know only
    the owned lines. The window rings may have their own head dims
    (gemma4's head_dim_k_swa / head_dim_v_swa)."""

    full: KVCache | PagedKVCache
    swa: KVCache
    is_swa: tuple
    full_idx: tuple
    swa_idx: tuple

    @staticmethod
    def layer_split(cfg) -> tuple[tuple, tuple, tuple]:
        """-> (is_swa, full_idx, swa_idx) of cfg's layers, a shared layer
        (kv_reuse[il] >= 0) aliasing its source's line (the JAX package's
        kv_cache.py:296-330)."""
        is_swa = tuple(cfg.is_swa_layer(i) for i in range(cfg.n_layers))
        reuse = cfg.extra.get("kv_reuse")
        full_idx, swa_idx = [], []
        n_full = n_swa = 0
        for il, s in enumerate(is_swa):
            if reuse is not None and int(reuse[il]) >= 0:
                src = int(reuse[il])
                full_idx.append(full_idx[src])
                swa_idx.append(swa_idx[src])
                continue
            full_idx.append(-1 if s else n_full)
            swa_idx.append(n_swa if s else -1)
            n_swa += s
            n_full += not s
        return is_swa, tuple(full_idx), tuple(swa_idx)

    @staticmethod
    def n_lines(cfg) -> tuple[int, int]:
        """-> (full lines, window lines): the owned layers of each class,
        at least one each."""
        _, full_idx, swa_idx = ISWACache.layer_split(cfg)
        return max(max(full_idx) + 1, 1), max(max(swa_idx) + 1, 1)

    @classmethod
    def build(cls, cfg, n_seqs: int, n_slots_full: int, n_slots_swa: int,
              dtype=torch.bfloat16, quantized: bool = False, device="cpu",
              full: PagedKVCache | None = None) -> "ISWACache":
        """Window rings of n_slots_swa for the SWA layers; for the full
        layers `full` (a pool with one layer per owned full layer) or,
        without it, a slot table of n_slots_full."""
        is_swa, full_idx, swa_idx = cls.layer_split(cfg)
        n_full, n_swa = cls.n_lines(cfg)
        dk_swa = int(cfg.extra.get("head_dim_k_swa", cfg.head_dim_k))
        dv_swa = int(cfg.extra.get("head_dim_v_swa", cfg.head_dim_v))

        def table(n_layers, n_slots, ring, dk, dv):
            return KVCache.create(n_layers, n_seqs, n_slots, cfg.n_kv_heads, dk, dv,
                                  dtype=dtype, quantized=quantized, ring=ring, device=device)

        if full is None:
            full = table(n_full, n_slots_full, False, cfg.head_dim_k, cfg.head_dim_v)
        return cls(full=full, swa=table(n_swa, n_slots_swa, True, dk_swa, dv_swa),
                   is_swa=is_swa, full_idx=full_idx, swa_idx=swa_idx)

    @property
    def quantized(self) -> bool:
        return self.full.quantized

    def layer_view(self, il: int):
        """-> (sub-cache, its layer index) of model layer il."""
        if self.is_swa[il]:
            return self.swa, self.swa_idx[il]
        return self.full, self.full_idx[il]

    def write_layer(self, il: int, seq_idx: torch.Tensor, positions: torch.Tensor,
                    k_new: torch.Tensor, v_new: torch.Tensor,
                    update_pos: bool | None = None) -> None:
        """Position-addressed in-place write into layer il's sub-cache; its
        position labels are written on its own first layer unless
        update_pos says otherwise."""
        cache, li = self.layer_view(il)
        cache.write_layer(li, seq_idx, positions, k_new, v_new,
                          update_pos=li == 0 if update_pos is None else update_pos)

    def seq_rm(self, seq: int, p0: int = 0, p1: int = 1 << 30) -> None:
        self.full.seq_rm(seq, p0, p1)
        self.swa.seq_rm(seq, p0, p1)

    def seq_cp(self, dst: int, src: int) -> None:
        """Both sub-caches' rows of src to dst (a pool's pages are copied by
        the context, which owns their table)."""
        if isinstance(self.full, PagedKVCache):
            raise TypeError("seq_cp of a pool's pages goes through Context.seq_cp")
        self.full.seq_cp(dst, src)
        self.swa.seq_cp(dst, src)
