"""Inference context: the llama_context analog, on the paged KV pool or the
slot-table cache.

Owns the KV memory (the pool with its host-side page allocator, or with
paged=False a KVCache of n_slots per sequence), the batch bucketing policy
(padding rows carry negative positions and write to the memory's trash
row), and the generation loops: through a host sampler chain, or on the
device (decode_steps_greedy, generate_ondevice), where one decode step per
(batch bucket, sampler) is captured as a CUDA graph at first use and
replayed once a step (runtime/decode_graph.py).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, fields, is_dataclass
from typing import Callable, Iterable

import numpy as np
import torch

from ..models.loader import Model, resolve_device
from ..models.transformer import AttnInputs, forward
from ..sampling.samplers import SamplerChain, SamplingParams
from .decode_graph import GREEDY, DecodeLoop, DeviceSampler
from .kv_cache import KVCache
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


def _nbytes(obj) -> int:
    """Bytes of every tensor reachable from obj (dicts, lists, tuples and
    dataclasses such as QuantTensor and the KV memories)."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        return sum(_nbytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_nbytes(v) for v in obj)
    if is_dataclass(obj) and not isinstance(obj, type):
        return sum(_nbytes(getattr(obj, f.name)) for f in fields(obj))
    return 0


class Context:
    # members the JAX package's server scheduler reads: the port has no
    # recurrent memory and no speculator, so no layer's features are captured
    recurrent = False
    aux_layers: tuple[int, ...] = ()

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
        paged: bool = True,
        graphs: bool = True,
    ):
        """kernels=False runs every layer through the plain PyTorch versions
        (dequant -> matmul, gather + einsum attention): the reference a
        kernel run is held against. paged=False keeps the KV in a slot table
        of n_slots per sequence instead of the page pool (no allocator).
        graphs=False runs the on-device decode loops' step eagerly on the
        card instead of replaying its CUDA graph: the reference a graph run
        is held against (the CPU always runs it eagerly)."""
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, context asked for {self.device}")
        self.model = model
        self.cfg = model.cfg
        self.n_ctx = n_ctx
        self.n_seqs = n_seqs
        self.n_ubatch = n_ubatch
        self.kernels = kernels
        self.graphs = graphs
        self._loops: dict[tuple[int, DeviceSampler], DecodeLoop] = {}
        self._kv_quant = quantized_kv
        # per-sequence slot range: a 256 multiple with headroom for one padded
        # prefill bucket; 512 multiples beyond 512
        headroom = min(max(n_ubatch, 8), 2048)
        want = n_ctx + 1 + headroom
        self.n_slots = 256 if want <= 256 else -(-want // 512) * 512
        self.paged = paged
        self.alloc = None
        if paged:
            # 512-row pages keep the attention kernel's page walk short;
            # small contexts take 256 for finer pool granularity
            self.page = 512 if self.n_slots >= 2048 else min(256, self.n_slots)
            max_pages = self.n_slots // self.page
            pool_tokens = kv_total or n_seqs * self.n_slots
            n_pages = -(-pool_tokens // self.page) + 1  # + trash page
            self.alloc = PageAllocator(n_seqs, n_pages, max_pages, self.page)
        self.kv = self._make_memory()
        self.trash_slot = self.n_slots - 1
        self.seq_len = np.zeros(n_seqs, dtype=np.int64)  # host-side lengths
        self.perf = PerfCounters()
        self.prefill_buckets = [b for b in (8, 16, 32, 64, 128, 256, 512, 1024, 2048)
                                if b <= max(n_ubatch, 8)]
        if self.prefill_buckets[-1] < n_ubatch:
            self.prefill_buckets.append(n_ubatch)

    def _make_memory(self) -> PagedKVCache | KVCache:
        if not self.paged:
            return KVCache.create(
                self.cfg.n_layers, self.n_seqs, self.n_slots, self.cfg.n_kv_heads,
                self.cfg.head_dim_k, self.cfg.head_dim_v, dtype=self.cfg.compute_dtype,
                quantized=self._kv_quant, device=self.device)
        return PagedKVCache.create(
            self.cfg.n_layers, self.n_seqs, self.alloc.n_pages, self.alloc.max_pages,
            self.cfg.n_kv_heads, self.cfg.head_dim_k, self.cfg.head_dim_v,
            dtype=self.cfg.compute_dtype, quantized=self._kv_quant, page=self.page,
            device=self.device)

    # ------------------------------------------------------------------
    def _ensure_pages(self, seq_idx, positions) -> None:
        """Host-side page allocation before a step (find_slot analog): every
        position that will be written must resolve through the table.
        Raises KVCacheFull when the pool is exhausted. A slot table needs
        none."""
        if self.alloc is None:
            return
        pos = np.atleast_2d(np.asarray(positions))
        seqs = np.asarray(seq_idx).reshape(-1)
        for b in range(len(seqs)):
            mx = int(pos[b].max()) if pos[b].size else -1
            if mx >= 0:
                self.alloc.ensure(int(seqs[b]), mx + 1)
        self._sync_table()

    def _sync_table(self) -> None:
        if self.alloc is not None and self.alloc.dirty:
            self.kv.table.copy_(torch.from_numpy(self.alloc.table))
            self.alloc.dirty = False

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _forward(self, toks, sidx, pos, out_rows) -> torch.Tensor:
        inputs = AttnInputs(seq_idx=sidx, positions=pos)
        return forward(self.model.params, self.cfg, toks, inputs, self.kv, out_rows,
                       kernels=self.kernels)

    # ------------------------------------------------------------------
    def set_aux_capture(self, layer_ids) -> None:
        """Capture of hidden features for a speculator: refused, the port has
        no speculator yet (an empty capture is a no-op)."""
        if layer_ids:
            raise NotImplementedError("set_aux_capture: speculative decoding (-md, "
                                      "--spec-ngram) is not ported")

    def decode(self, tokens: np.ndarray, seq_idx: np.ndarray, positions: np.ndarray,
               output_rows: np.ndarray, aux: bool = False) -> np.ndarray:
        """Low-level ubatch step -> logits [M, vocab] (f32, host) for the flat
        rows `output_rows` of the [B, T] token grid. aux=True (logits and a
        speculator's features) is refused: the port has no speculator yet."""
        if aux:
            raise NotImplementedError("decode(aux=True): speculative decoding (-md, "
                                      "--spec-ngram) is not ported")
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

    def _batch_bucket(self, B: int) -> int:
        return min(max(_bucket(B, [1, 2, 4, 8, 16, 32, 64, self.n_seqs]), B), self.n_seqs)

    def decode_loop(self, batch: int, sampler: DeviceSampler = GREEDY) -> DecodeLoop:
        """The on-device decode loop of a batch bucket and sampler, made at
        first use (its CUDA graph is captured at its first run on the card).
        Loops made over an earlier KV memory are dropped."""
        if any(loop.kv is not self.kv for loop in self._loops.values()):
            self._loops.clear()
        key = (batch, sampler)
        loop = self._loops.get(key)
        if loop is None:
            capture = self.graphs and self.device.type == "cuda"
            loop = self._loops[key] = DecodeLoop(self, batch, sampler, capture)
        return loop

    def _greedy_batch(self, tokens, seqs):
        """Bucketed [Bb] device tensors (tokens, positions, seq ids) for a
        batched decode step; padding rows get position -1."""
        B = len(seqs)
        Bb = self._batch_bucket(B)
        toks = np.zeros(Bb, np.int32)
        pos = np.full(Bb, -1, np.int32)
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
        t, p, s = self._greedy_batch(tokens, seqs)
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
        each step feeds the previous step's tokens without a host copy, and
        on the card each step is a replay of the batch bucket's captured
        graph; the [B, n_steps] ids come to the host once. All sequences
        advance n_steps; callers finishing a sequence early drop its tail
        (and seq_rm it)."""
        t0 = time.perf_counter()
        seqs = np.asarray(seqs)
        B = len(seqs)
        if self.alloc is not None:
            for b in range(B):
                self.alloc.ensure(int(seqs[b]), int(self.seq_len[seqs[b]]) + n_steps)
            self._sync_table()
        loop = self.decode_loop(self._batch_bucket(B))
        # pad rows: the position stays negative for every step (trash writes)
        out = loop.run(np.asarray(tokens), self.seq_len[seqs], seqs, n_steps)
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
        if self.alloc is not None and p1 >= int(1e9):
            # suffix removal: release whole pages past the cut point
            self.alloc.trim(seq, p0)
            self._sync_table()

    def seq_cp(self, dst: int, src: int) -> None:
        if self.alloc is None:
            self.kv.seq_cp(dst, src)
        else:
            # page-granular copy: dst gets fresh pages mirroring src's
            self.alloc.trim(dst, 0)
            self.alloc.ensure(dst, int(self.alloc.count[src]) * self.page)
            self._sync_table()
            src_p = self._tensor(self.alloc.table[src])
            dst_p = self._tensor(self.alloc.table[dst])
            self.kv.copy_pages(src_p, dst_p)
        self.seq_len[dst] = self.seq_len[src]

    def memory_breakdown(self) -> dict:
        """Device-memory bytes of the model's tensors, of the KV memory's,
        and their total (the reference's llama_memory_breakdown)."""
        model = _nbytes(self.model.params)
        memory = _nbytes(self.kv)
        return {"model_bytes": model, "memory_bytes": memory, "total_bytes": model + memory}

    def reset(self) -> None:
        if self.alloc is not None:
            self.alloc = PageAllocator(self.n_seqs, self.alloc.n_pages, self.alloc.max_pages,
                                       self.page)
        self.kv = self._make_memory()
        self._loops.clear()  # their graphs write the old memory
        self.seq_len[:] = 0

    # ------------------------------------------------------------------
    def generate(
        self,
        prompt: list[int],
        max_new_tokens: int = 128,
        sampler: SamplerChain | None = None,
        seq: int = 0,
        stop_fn: Callable[[int], bool] | None = None,
        stream: Callable[[int], None] | None = None,
    ) -> list[int]:
        """Prefill, then one decode step per token until max_new_tokens,
        stop_fn(token), an end-of-generation token (when the model has a
        tokenizer) or the end of the context. The stopping token is part of
        the result. With a sampler the last row's f32 logits come to the
        host once a step and go through the chain; without one the loop is
        greedy with the argmax taken on the device (the same ids as the
        default greedy chain, without the copy of the logits)."""
        vocab = self.model.tokenizer.vocab if self.model.tokenizer else None
        logits = self.prefill(prompt, seq=seq)
        greedy = int(np.argmax(logits))
        out: list[int] = []
        for _ in range(max_new_tokens):
            token = sampler.sample(logits) if sampler is not None else greedy
            out.append(token)
            if stream:
                stream(token)
            if stop_fn and stop_fn(token):
                break
            if vocab is not None and vocab.is_eog(token):
                break
            if self.seq_len[seq] >= self.n_ctx:
                break
            if sampler is not None:
                logits = self.decode_one(token, seq=seq)
            else:
                greedy = int(self.decode_step_greedy(np.asarray([token]), np.asarray([seq]))[0])
        return out

    def generate_ondevice(
        self,
        prompt: list[int],
        max_new_tokens: int = 128,
        temp: float = 0.0,
        top_k: int = 0,
        seed: int = 0,
        seq: int = 0,
        chunk: int = 32,
        stream: Callable[[int], None] | None = None,
    ) -> list[int]:
        """Greedy or simply sampled (temp, top_k) generation with the decode
        loop on the device: prefill, the first token from the prefill's
        logits (through the host chain when temp > 0), then chunks of up to
        `chunk` steps, each step a replay of the B=1 graph on the card and
        each chunk's ids copied to the host once. An end-of-generation token
        is checked on the host once a chunk (the loop stops at it; the chunk's
        positions stay written), and the loop stops before a chunk would
        reach n_ctx. The JAX package's semantics (runtime/context.py
        generate_ondevice); the sampled ids differ from jax.random's."""
        logits = self.prefill(prompt, seq=seq)
        if temp <= 0:
            first = int(np.argmax(logits))
        else:
            chain = SamplerChain.from_params(SamplingParams(temp=temp, top_k=top_k, seed=seed))
            first = chain.sample(logits)
        out = [first]
        if stream:
            stream(first)
        vocab = self.model.tokenizer.vocab if self.model.tokenizer else None
        if vocab is not None and vocab.is_eog(first):
            return out
        loop = self.decode_loop(1, GREEDY if temp <= 0 else DeviceSampler(temp, top_k))
        loop.ready()
        loop.generator.manual_seed(seed)
        t0 = time.perf_counter()
        while len(out) < max_new_tokens:
            n = min(chunk, max_new_tokens - len(out))
            if int(self.seq_len[seq]) + n + 1 >= self.n_ctx:
                break
            if self.alloc is not None:
                self.alloc.ensure(seq, int(self.seq_len[seq]) + n + 1)
                self._sync_table()
            toks = loop.run([out[-1]], [self.seq_len[seq]], [seq], n)[0]
            self.seq_len[seq] += n
            self.perf.n_decode += n
            stop = False
            for t in toks:
                out.append(int(t))
                if stream:
                    stream(int(t))
                if vocab is not None and vocab.is_eog(int(t)):
                    stop = True
                    break
            if stop:
                break
        self.perf.t_decode_ms += (time.perf_counter() - t0) * 1e3
        return out
