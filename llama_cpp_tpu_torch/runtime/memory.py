"""Recurrent state memory for the SSM, linear-attention and short-conv
mixers, and the hybrid memory of models that also attend.

Port of the JAX package's runtime/memory.py (analog of reference
llama_memory_recurrent, src/llama-memory-recurrent.cpp, and
llama_memory_hybrid, src/llama-memory-hybrid.cpp): one fixed-size state
slot per sequence instead of a KV ring, two tensors per layer: the rolling
conv window and the SSM (or DeltaNet) state matrix. Writes are in place
(index_copy_ on the sequence rows), so a captured decode graph updates the
state with no host sync; the values are the JAX package's functional
`.at[].set`. Removing a position range (seq_rm with p0 > 0) is refused, as
the reference refuses it: rolling a recurrent state back needs snapshots,
not cell eviction.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class RecurrentState:
    """conv: [L, n_seqs, d_conv - 1, channels]; ssm: [L, n_seqs, d_state,
    d_inner] f32."""

    conv: torch.Tensor
    ssm: torch.Tensor

    @classmethod
    def create(cls, n_layers: int, n_seqs: int, d_conv: int, d_inner: int, d_state: int,
               dtype=torch.float32, conv_channels: int | None = None,
               device="cpu") -> "RecurrentState":
        # mamba2 and the DeltaNet convolve over more channels than d_inner
        return cls(
            conv=torch.zeros((n_layers, n_seqs, max(d_conv - 1, 0), conv_channels or d_inner),
                             dtype=dtype, device=device),
            ssm=torch.zeros((n_layers, n_seqs, d_state, d_inner), dtype=torch.float32,
                            device=device),
        )

    @property
    def quantized(self) -> bool:
        return False

    @property
    def n_slots(self) -> int:  # one state a sequence
        return 1

    def get(self, layer: int, seq_idx: torch.Tensor):
        """-> (conv [B, d_conv - 1, C], ssm [B, d_state, d_inner])."""
        idx = seq_idx.long()
        return self.conv[layer][idx], self.ssm[layer][idx]

    def put(self, layer: int, seq_idx: torch.Tensor, conv_new: torch.Tensor,
            ssm_new: torch.Tensor) -> None:
        idx = seq_idx.long()
        self.conv[layer].index_copy_(0, idx, conv_new.to(self.conv.dtype))
        self.ssm[layer].index_copy_(0, idx, ssm_new.to(self.ssm.dtype))

    def seq_rm(self, seq: int, p0: int = 0, p1: int = 1 << 30) -> None:
        if p0 > 0:
            raise NotImplementedError(
                "recurrent memory cannot evict a position range "
                "(reference llama-memory-recurrent.cpp seq_rm restriction)")
        self.conv[:, seq] = 0.0
        self.ssm[:, seq] = 0.0

    def seq_cp(self, dst: int, src: int) -> None:
        self.conv[:, dst] = self.conv[:, src]
        self.ssm[:, dst] = self.ssm[:, src]


@dataclass
class HybridMemory:
    """Attention KV (`kv`: the page pool or a slot table) and recurrent state
    (`rs`) for hybrid models: attention layers address .kv, mixer layers
    .rs; each keeps a slice for every layer, the other kind's unused."""

    kv: object
    rs: RecurrentState

    @property
    def pos(self):
        return self.kv.pos

    @property
    def quantized(self) -> bool:
        return self.kv.quantized

    @property
    def n_slots(self) -> int:
        return self.kv.n_slots

    def seq_rm(self, seq: int, p0: int = 0, p1: int = 1 << 30) -> None:
        self.rs.seq_rm(seq, p0, p1)  # refuses p0 > 0 before the KV is touched
        self.kv.seq_rm(seq, p0, p1)

    def seq_cp(self, dst: int, src: int) -> None:
        """Both parts' rows of src to dst (a pool's pages are copied by the
        context, which owns their table)."""
        self.kv.seq_cp(dst, src)
        self.rs.seq_cp(dst, src)


@dataclass
class DSAMemory:
    """The memory of block-sparse and sparse attention (reference
    llama_kv_cache_msa / llama_kv_cache_dsa; the JAX package's
    runtime/memory.py:126): the main KV on a slot table (`kv`) and a
    one-head indexer key cache (`idx`, its V rows unused) beside it, written
    at the same positions. Both are slot tables of the same slots, so a
    sequence's rows keep one position layout in each; seq_rm and seq_cp go
    to both."""

    kv: object  # KVCache
    idx: object  # KVCache, one head of the indexer's key width

    @property
    def pos(self):
        return self.kv.pos

    @property
    def quantized(self) -> bool:
        return self.kv.quantized

    @property
    def n_slots(self) -> int:
        return self.kv.n_slots

    def seq_rm(self, seq: int, p0: int = 0, p1: int = 1 << 30) -> None:
        self.kv.seq_rm(seq, p0, p1)
        self.idx.seq_rm(seq, p0, p1)

    def seq_cp(self, dst: int, src: int) -> None:
        self.kv.seq_cp(dst, src)
        self.idx.seq_cp(dst, src)
