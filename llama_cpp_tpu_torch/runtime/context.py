"""Inference context: the llama_context analog, on the paged KV pool.

Owns the KV pool and its host-side page allocator, the batch bucketing
policy (padding rows carry negative positions and write to the pool's trash
row), and the greedy generation loops. PyTorch runs eagerly, so the buckets
only keep the step shapes the JAX package uses.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Iterable

import numpy as np
import torch

from ..models.loader import Model, resolve_device
from ..models.transformer import AttnInputs, forward
from .paged_kv import PageAllocator, PagedKVCache


def _bucket(n: int, buckets: Iterable[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return max(buckets)


@dataclass
class PerfCounters:
    """llama_perf_context analog (include/llama.h:1545-1570). Host clock
    around work that ends in a device-to-host copy."""

    t_prefill_ms: float = 0.0
    t_decode_ms: float = 0.0
    n_prefill: int = 0
    n_decode: int = 0

    def summary(self) -> dict:
        return {
            "prefill_tok_per_s": self.n_prefill / (self.t_prefill_ms / 1e3 + 1e-9),
            "decode_tok_per_s": self.n_decode / (self.t_decode_ms / 1e3 + 1e-9),
            **self.__dict__,
        }


class Context:
    def __init__(
        self,
        model: Model,
        n_ctx: int = 2048,
        n_seqs: int = 1,
        n_ubatch: int = 512,
        quantized_kv: bool = False,
        kv_total: int | None = None,
        device="cuda",
        kernels: bool = True,
    ):
        """kernels=False runs every layer through the plain PyTorch versions
        (dequant -> matmul, gather + einsum attention): the reference a
        kernel run is held against."""
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, context asked for {self.device}")
        self.model = model
        self.cfg = model.cfg
        self.n_ctx = n_ctx
        self.n_seqs = n_seqs
        self.n_ubatch = n_ubatch
        self.kernels = kernels
        self._kv_quant = quantized_kv
        # per-sequence slot range: a 256 multiple with headroom for one padded
        # prefill bucket; 512 multiples beyond 512
        headroom = min(max(n_ubatch, 8), 2048)
        want = n_ctx + 1 + headroom
        self.n_slots = 256 if want <= 256 else -(-want // 512) * 512
        # 512-row pages keep the attention kernel's page walk short; small
        # contexts take 256 for finer pool granularity
        self.page = 512 if self.n_slots >= 2048 else min(256, self.n_slots)
        max_pages = self.n_slots // self.page
        pool_tokens = kv_total or n_seqs * self.n_slots
        n_pages = -(-pool_tokens // self.page) + 1  # + trash page
        self.alloc = PageAllocator(n_seqs, n_pages, max_pages, self.page)
        self.kv = self._make_memory()
        self.seq_len = np.zeros(n_seqs, dtype=np.int64)  # host-side lengths
        self.perf = PerfCounters()
        self.prefill_buckets = [b for b in (8, 16, 32, 64, 128, 256, 512, 1024, 2048)
                                if b <= max(n_ubatch, 8)]
        if self.prefill_buckets[-1] < n_ubatch:
            self.prefill_buckets.append(n_ubatch)

    def _make_memory(self) -> PagedKVCache:
        return PagedKVCache.create(
            self.cfg.n_layers, self.n_seqs, self.alloc.n_pages, self.alloc.max_pages,
            self.cfg.n_kv_heads, self.cfg.head_dim_k, self.cfg.head_dim_v,
            dtype=self.cfg.compute_dtype, quantized=self._kv_quant, page=self.page,
            device=self.device)

    # ------------------------------------------------------------------
    def _ensure_pages(self, seq_idx, positions) -> None:
        """Host-side page allocation before a step (find_slot analog): every
        position that will be written must resolve through the table.
        Raises KVCacheFull when the pool is exhausted."""
        pos = np.atleast_2d(np.asarray(positions))
        seqs = np.asarray(seq_idx).reshape(-1)
        for b in range(len(seqs)):
            mx = int(pos[b].max()) if pos[b].size else -1
            if mx >= 0:
                self.alloc.ensure(int(seqs[b]), mx + 1)
        self._sync_table()

    def _sync_table(self) -> None:
        if self.alloc.dirty:
            self.kv.table.copy_(torch.from_numpy(self.alloc.table))
            self.alloc.dirty = False

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _forward(self, toks, sidx, pos, out_rows) -> torch.Tensor:
        inputs = AttnInputs(seq_idx=sidx, positions=pos)
        return forward(self.model.params, self.cfg, toks, inputs, self.kv, out_rows,
                       kernels=self.kernels)

    # ------------------------------------------------------------------
    def decode(self, tokens: np.ndarray, seq_idx: np.ndarray, positions: np.ndarray,
               output_rows: np.ndarray) -> np.ndarray:
        """Low-level ubatch step -> logits [M, vocab] (f32, host) for the flat
        rows `output_rows` of the [B, T] token grid."""
        tokens = np.atleast_2d(np.asarray(tokens))
        positions = np.atleast_2d(np.asarray(positions))
        seq_idx = np.asarray(seq_idx).reshape(-1)
        B, T = tokens.shape
        Tb = _bucket(T, self.prefill_buckets) if T > 1 else 1
        Bb = B if T > 1 else _bucket(B, [1, 2, 4, 8, 16, 32, 64, self.n_seqs])
        Bb = min(max(Bb, B), self.n_seqs)

        toks = np.zeros((Bb, Tb), np.int32)
        pos = np.full((Bb, Tb), -1, np.int32)
        sidx = np.zeros(Bb, np.int32)
        toks[:B, :T] = tokens
        pos[:B, :T] = positions
        sidx[:B] = seq_idx
        rows = np.asarray(output_rows, dtype=np.int64)
        out_rows = (rows // T) * Tb + (rows % T)  # flat [B, T] -> padded [Bb, Tb]
        self._ensure_pages(sidx[:B], pos[:B])
        logits = self._forward(self._tensor(toks), self._tensor(sidx), self._tensor(pos),
                               self._tensor(out_rows))
        return logits[: len(rows)].cpu().numpy()

    def prefill(self, prompt: list[int], seq: int = 0) -> np.ndarray:
        """Feed a prompt in ubatches; returns last-token logits [vocab]."""
        t0 = time.perf_counter()
        pos0 = int(self.seq_len[seq])
        logits = None
        for off in range(0, len(prompt), self.n_ubatch):
            chunk = prompt[off: off + self.n_ubatch]
            positions = np.arange(pos0 + off, pos0 + off + len(chunk))
            logits = self.decode(np.asarray(chunk)[None, :], np.asarray([seq]),
                                 positions[None, :], np.asarray([len(chunk) - 1]))
        self.seq_len[seq] = pos0 + len(prompt)
        self.perf.n_prefill += len(prompt)
        self.perf.t_prefill_ms += (time.perf_counter() - t0) * 1e3
        return logits[0]

    def decode_one(self, token: int, seq: int = 0) -> np.ndarray:
        t0 = time.perf_counter()
        pos = int(self.seq_len[seq])
        logits = self.decode(np.asarray([[token]]), np.asarray([seq]), np.asarray([[pos]]),
                             np.asarray([0]))
        self.seq_len[seq] = pos + 1
        self.perf.n_decode += 1
        self.perf.t_decode_ms += (time.perf_counter() - t0) * 1e3
        return logits[0]

    def _greedy_batch(self, tokens, seqs, pos_pad: int):
        """Bucketed [Bb] device tensors (tokens, positions, seq ids) for a
        batched decode step; padding rows get position `pos_pad`."""
        B = len(seqs)
        Bb = min(max(_bucket(B, [1, 2, 4, 8, 16, 32, 64, self.n_seqs]), B), self.n_seqs)
        toks = np.zeros(Bb, np.int32)
        pos = np.full(Bb, pos_pad, np.int32)
        sidx = np.zeros(Bb, np.int32)
        toks[:B] = tokens
        pos[:B] = self.seq_len[seqs]
        sidx[:B] = seqs
        return self._tensor(toks), self._tensor(pos), self._tensor(sidx)

    def decode_step_greedy(self, tokens: np.ndarray, seqs: np.ndarray) -> np.ndarray:
        """One batched decode step returning only the argmax token per
        sequence (B int32s to the host instead of [B, vocab] logits)."""
        t0 = time.perf_counter()
        seqs = np.asarray(seqs)
        B = len(seqs)
        t, p, s = self._greedy_batch(tokens, seqs, -1)
        self._ensure_pages(seqs, self.seq_len[seqs][:, None])
        logits = self._forward(t[:, None], s, p[:, None], torch.arange(len(t), device=self.device))
        out = torch.argmax(logits, dim=-1).to(torch.int32)[:B].cpu().numpy()
        self.seq_len[seqs] += 1
        self.perf.n_decode += B
        self.perf.t_decode_ms += (time.perf_counter() - t0) * 1e3
        return out

    def decode_steps_greedy(self, tokens: np.ndarray, seqs: np.ndarray,
                            n_steps: int) -> np.ndarray:
        """n_steps batched greedy decode steps with the argmax on the device:
        each step feeds the previous step's tokens without a host copy of
        the logits. Returns [B, n_steps]. All sequences advance n_steps;
        callers finishing a sequence early drop its tail (and seq_rm it)."""
        t0 = time.perf_counter()
        seqs = np.asarray(seqs)
        B = len(seqs)
        for b in range(B):
            self.alloc.ensure(int(seqs[b]), int(self.seq_len[seqs[b]]) + n_steps)
        self._sync_table()
        # pad rows: the position stays negative for every step (trash writes)
        t, p, s = self._greedy_batch(tokens, seqs, -(1 << 20))
        rows = torch.arange(len(t), device=self.device)
        outs = []
        for _ in range(n_steps):
            logits = self._forward(t[:, None], s, p[:, None], rows)
            t = torch.argmax(logits, dim=-1).to(torch.int32)
            outs.append(t)
            p = p + 1
        out = torch.stack(outs, dim=1)[:B].cpu().numpy()
        self.seq_len[seqs] += n_steps
        self.perf.n_decode += B * n_steps
        self.perf.t_decode_ms += (time.perf_counter() - t0) * 1e3
        return out

    def decode_step_multi(self, tokens: np.ndarray, seqs: np.ndarray) -> np.ndarray:
        """One decode step for several sequences at once (continuous
        batching): tokens[i] appended to seqs[i]; logits [len(seqs), vocab]."""
        t0 = time.perf_counter()
        seqs = np.asarray(seqs)
        pos = self.seq_len[seqs]
        logits = self.decode(np.asarray(tokens)[:, None], seqs, np.asarray(pos)[:, None],
                             np.arange(len(seqs)))
        self.seq_len[seqs] += 1
        self.perf.n_decode += len(seqs)
        self.perf.t_decode_ms += (time.perf_counter() - t0) * 1e3
        return logits

    # -- sequence management (llama_memory seq API analog) ---------------
    def seq_rm(self, seq: int, p0: int = 0, p1: int = 1 << 30) -> None:
        self.kv.seq_rm(seq, p0, p1)
        if p0 == 0:
            self.seq_len[seq] = 0
        else:
            self.seq_len[seq] = min(self.seq_len[seq], p0)
        if p1 >= int(1e9):
            # suffix removal: release whole pages past the cut point
            self.alloc.trim(seq, p0)
            self._sync_table()

    def seq_cp(self, dst: int, src: int) -> None:
        # page-granular copy: dst gets fresh pages mirroring src's
        self.alloc.trim(dst, 0)
        self.alloc.ensure(dst, int(self.alloc.count[src]) * self.page)
        self._sync_table()
        src_p = self._tensor(self.alloc.table[src])
        dst_p = self._tensor(self.alloc.table[dst])
        self.kv.copy_pages(src_p, dst_p)
        self.seq_len[dst] = self.seq_len[src]

    def reset(self) -> None:
        self.alloc = PageAllocator(self.n_seqs, self.alloc.n_pages, self.alloc.max_pages,
                                   self.page)
        self.kv = self._make_memory()
        self.seq_len[:] = 0

    # ------------------------------------------------------------------
    def generate(self, prompt: list[int], max_new_tokens: int = 128, seq: int = 0) -> list[int]:
        """Greedy generation: prefill, then one decode step per token until
        max_new_tokens or the end of the context."""
        logits = self.prefill(prompt, seq=seq)
        out: list[int] = []
        for _ in range(max_new_tokens):
            token = int(np.argmax(logits))
            out.append(token)
            if self.seq_len[seq] >= self.n_ctx:
                break
            logits = self.decode_one(token, seq=seq)
        return out
