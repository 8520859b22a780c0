"""Inference context: the llama_context analog, on the paged KV pool or the
slot-table cache, or a recurrent state.

Owns the KV memory (the pool with its host-side page allocator, or with
paged=False a KVCache of n_slots per sequence; for an interleaved
sliding-window model an ISWACache whose full layers take that memory and
whose window layers take rings; for a recurrent stack a RecurrentState, for
a hybrid a HybridMemory of that memory and a RecurrentState), the batch
bucketing policy (padding rows carry negative positions and write to the
memory's trash row; a recurrent state has none, so its ubatches and decode
batches run at their exact shapes), and the generation loops: through a
host sampler chain, or on the device (decode_steps_greedy,
generate_ondevice). Every batched decode step, the server's one-step calls
(decode_step_greedy, decode_step_multi) included, runs one step per (batch
bucket, sampler) that is captured as a CUDA graph at first use and replayed
once a step (runtime/decode_graph.py).
context_shift slides a sequence down in place, and a captured loop is made
again when the memory or the model's weights (adapters) change. embed pools
the final hidden rows of one forward over a throwaway memory (encoders,
embedding decoders); encode runs T5's encoder and keeps its output as the
sequence's cross state, which T5's decoder steps read (the encoder-decoder
flow: prefill encodes the prompt and decodes the decoder's start token;
its steps run eagerly through decode, on the slot table). The family's
graph is the model's forward_fn.
"""

from __future__ import annotations

import inspect
import time
from dataclasses import dataclass, fields, is_dataclass
from typing import Callable, Iterable

import numpy as np
import torch

from ..models.loader import Model, resolve_device
from ..models.transformer import AttnInputs
from ..sampling.samplers import SamplerChain, SamplingParams
from .decode_graph import GREEDY, LOGITS, DecodeLoop, DeviceSampler
from .kv_cache import ISWACache, KVCache
from .memory import DSAMemory, HybridMemory, RecurrentState
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
    # the layers whose input rows decode(aux=True) returns (set_aux_capture;
    # the JAX package's server scheduler reads it too)
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
        # a recurrent or hybrid memory's state cannot absorb padding: its
        # ubatches and decode batches run at their exact shapes
        self.recurrent = self.cfg.extra.get("memory") in ("recurrent", "hybrid")
        # T5: each sequence's encoder output [Ne, E] f32 on the device, the
        # cross state its decoder steps attend (the JAX package's
        # runtime/context.py:74-75)
        self.enc_dec = bool(self.cfg.extra.get("encoder_decoder"))
        self._cross: dict[int, torch.Tensor] = {}
        self.n_ctx = n_ctx
        self.n_seqs = n_seqs
        self.n_ubatch = n_ubatch
        self.kernels = kernels
        self.graphs = graphs
        self._loops: dict[tuple[int, DeviceSampler | None], DecodeLoop] = {}
        self._kv_quant = quantized_kv
        # per-sequence slot range: a 256 multiple with headroom for one padded
        # prefill bucket; 512 multiples beyond 512
        headroom = min(max(n_ubatch, 8), 2048)
        want = n_ctx + 1 + headroom
        self.n_slots = 256 if want <= 256 else -(-want // 512) * 512
        # a recurrent stack has no KV to page (a hybrid's attention layers
        # take the pool, as in the JAX package); T5's decoder and MSA's
        # DSAMemory keep slot tables (the JAX package's
        # runtime/context.py:98-105)
        self.paged = paged = (paged and self.cfg.extra.get("memory") != "recurrent"
                              and not self.enc_dec and not self.cfg.extra.get("msa"))
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

    def _recurrent_state(self, n_seqs: int) -> RecurrentState:
        ex = self.cfg.extra
        return RecurrentState.create(self.cfg.n_layers, n_seqs, ex["ssm_d_conv"],
                                     ex["ssm_d_inner"], ex["ssm_d_state"],
                                     conv_channels=ex.get("ssm_conv_dim"), device=self.device)

    def _make_memory(self, n_seqs: int | None = None, n_slots: int | None = None
                     ) -> PagedKVCache | KVCache | ISWACache | RecurrentState | HybridMemory:
        """The context's memory, or with n_slots a throwaway one of n_seqs
        sequences on slot tables of n_slots (Context.embed's; the JAX
        package's runtime/context.py:194-215)."""
        cfg = self.cfg
        kind = cfg.extra.get("memory")
        paged = self.paged and n_slots is None
        n_seqs = n_seqs or self.n_seqs
        n_slots = n_slots or self.n_slots
        if kind == "recurrent":  # the JAX package's runtime/context.py:262-266
            return self._recurrent_state(n_seqs)
        if kind == "hybrid":
            # the attention layers on the pool (or a slot table), every layer's
            # recurrent state beside (runtime/context.py:267-282)
            rs = self._recurrent_state(n_seqs)
            if paged:
                kvc = PagedKVCache.create(
                    cfg.n_layers, n_seqs, self.alloc.n_pages, self.alloc.max_pages,
                    cfg.n_kv_heads, cfg.head_dim_k, cfg.head_dim_v, dtype=cfg.compute_dtype,
                    quantized=self._kv_quant, page=self.page, device=self.device)
            else:
                kvc = KVCache.create(cfg.n_layers, n_seqs, n_slots, cfg.n_kv_heads,
                                     cfg.head_dim_k, cfg.head_dim_v, dtype=cfg.compute_dtype,
                                     quantized=self._kv_quant, device=self.device)
            return HybridMemory(kv=kvc, rs=rs)
        if cfg.extra.get("msa"):
            # the main KV and the one-head indexer key cache, slot tables of
            # the same slots (the JAX package's runtime/context.py:233-250)
            return DSAMemory(
                kv=KVCache.create(cfg.n_layers, n_seqs, n_slots, cfg.n_kv_heads, cfg.head_dim_k,
                                  cfg.head_dim_v, dtype=cfg.compute_dtype,
                                  quantized=self._kv_quant, device=self.device),
                idx=KVCache.create(cfg.n_layers, n_seqs, n_slots, 1,
                                   cfg.extra["indexer_head_size"], 8, dtype=cfg.compute_dtype,
                                   device=self.device))
        # an encoder's window (ModernBERT) is its own forward's mask: no rings
        iswa = cfg.sliding_window > 0 and cfg.swa_pattern > 0 and not cfg.extra.get("encoder")
        n_layers = cfg.n_layers
        if iswa:  # the pool (if any) holds the owned full layers only
            n_layers = ISWACache.n_lines(cfg)[0]
        # an absorbed-MLA memory holds one KV head of the latent (registry
        # _mla_absorb_extras), any other the config's heads (the JAX
        # package's runtime/context.py:199-200)
        heads = cfg.extra.get("cache_n_kv_heads", cfg.n_kv_heads)
        dk = cfg.extra.get("cache_head_dim_k", cfg.head_dim_k)
        dv = cfg.extra.get("cache_head_dim_v", cfg.head_dim_v)
        pool = None
        if paged:
            pool = PagedKVCache.create(
                n_layers, n_seqs, self.alloc.n_pages, self.alloc.max_pages,
                heads, dk, dv, dtype=cfg.compute_dtype,
                quantized=self._kv_quant, page=self.page, device=self.device)
        if iswa:
            # a window layer's ring holds the window plus the largest ubatch
            # in flight (the JAX package's runtime/context.py:284-311), at most
            # the slot table's slots
            ring = -(-(cfg.sliding_window + self.n_ubatch + 1) // 256) * 256
            return ISWACache.build(cfg, n_seqs, n_slots, min(ring, n_slots),
                                   dtype=cfg.compute_dtype, quantized=self._kv_quant,
                                   device=self.device, full=pool)
        if pool is not None:
            return pool
        return KVCache.create(
            n_layers, n_seqs, n_slots, heads, dk, dv, dtype=cfg.compute_dtype,
            quantized=self._kv_quant, device=self.device)

    def _pool(self) -> PagedKVCache | None:
        """The page pool: the memory itself, the ISWA memory's full tier or
        the hybrid memory's attention part."""
        kv = self.kv
        if isinstance(kv, ISWACache):
            kv = kv.full
        elif isinstance(kv, HybridMemory):
            kv = kv.kv
        return kv if isinstance(kv, PagedKVCache) else None

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
            self._pool().table.copy_(torch.from_numpy(self.alloc.table))
            self.alloc.dirty = False

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _forward(self, toks, sidx, pos, out_rows, **kw) -> torch.Tensor:
        """One forward over the serving memory; kw: the cross state of an
        encoder-decoder, or the tap of decode(aux=True)."""
        inputs = AttnInputs(seq_idx=sidx, positions=pos)
        return self.model.forward_fn(self.model.params, self.cfg, toks, inputs, self.kv,
                                     out_rows, kernels=self.kernels, **kw)

    def _cross_state(self, sidx: np.ndarray, B: int) -> dict[str, torch.Tensor]:
        """The decoder rows' cross state (the JAX package's
        runtime/context.py:468-484): row r attends its sequence's encoder
        output, every row padded to the batch's longest (a bucket of 64 to
        4096, 512 multiples beyond), the padding at cross_pos -1; a sequence
        that was never encoded attends nothing."""
        ne = max((len(self._cross.get(int(q), ())) for q in sidx[:B]), default=1)
        ne_b = _bucket(max(ne, 1), (64, 128, 256, 512, 1024, 2048, 4096))
        ne_b = max(ne_b, -(-ne // 512) * 512)
        cross = torch.zeros((len(sidx), ne_b, self.cfg.n_embd), dtype=torch.float32,
                            device=self.device)
        cross_pos = torch.full((len(sidx), ne_b), -1, dtype=torch.int32, device=self.device)
        for r in range(B):
            ce = self._cross.get(int(sidx[r]))
            if ce is not None:
                cross[r, : len(ce)] = ce
                cross_pos[r, : len(ce)] = torch.arange(len(ce), dtype=torch.int32,
                                                       device=self.device)
        return {"cross": cross, "cross_pos": cross_pos}

    def _no_device_loop(self, what: str) -> None:
        """T5's decoder steps read a cross state that the on-device loops do
        not carry (nor do the JAX package's, runtime/context.py:711,1069)."""
        if self.enc_dec:
            raise NotImplementedError(
                f"{what}: {self.cfg.arch!r} (an encoder-decoder) has no on-device decode loop; "
                "its steps run eagerly through Context.decode (Context.generate)")

    # -- embeddings (llama_encode + pooling) -------------------------------
    def embed(self, prompt: list[int], seq: int = 0, pooling: str = "mean") -> np.ndarray:
        """A sequence's embedding from its final hidden rows (the JAX
        package's runtime/context.py:820-864): one forward of the bucket
        max(bucket(n), ceil(n / 512) * 512) rows over a throwaway memory of
        bucket + 8 slots (the serving memory is not touched), the padding
        rows (position -1) dropped, then pooled: "mean", "cls" (the first
        row), "last", or anything else for the rows [n, E] unpooled. f32 on
        the host. A model whose forward has no hidden output (t5encoder's:
        Context.encode) raises TypeError, as in the JAX package."""
        n = len(prompt)
        Tb = max(_bucket(n, self.prefill_buckets), -(-n // 512) * 512)
        kv = self._make_memory(n_seqs=1, n_slots=Tb + 8)
        toks = np.zeros((1, Tb), np.int32)
        toks[0, :n] = prompt
        pos = np.full((1, Tb), -1, np.int32)
        pos[0, :n] = np.arange(n)
        inputs = AttnInputs(seq_idx=self._tensor(np.zeros(1, np.int32)),
                            positions=self._tensor(pos))
        hidden = self.model.forward_fn(self.model.params, self.cfg, self._tensor(toks), inputs,
                                       kv, kernels=self.kernels, return_hidden=True)
        h = hidden.float()[:n].cpu().numpy()  # the padding rows dropped
        if pooling == "mean":
            return h.mean(axis=0)
        if pooling == "last":
            return h[-1]
        if pooling == "cls":
            return h[0]
        return h

    def encode(self, prompt: list[int], seq: int = 0) -> np.ndarray:
        """T5's encoder over the prompt (llama_encode; the JAX package's
        runtime/context.py:590-615): the prefill bucket of its length, pad
        keys masked by `valid`, the rows of the prompt -> [n, E] f32 on the
        host, kept on the device as the sequence's cross state."""
        from ..models import t5

        n = len(prompt)
        Tb = _bucket(n, self.prefill_buckets)
        toks = np.zeros((1, Tb), np.int32)
        toks[0, :n] = prompt
        valid = np.zeros((1, Tb), bool)
        valid[0, :n] = True
        out = t5.t5_encode(self.model.params, self.cfg, self._tensor(toks), self._tensor(valid),
                           kernels=self.kernels)[0]
        out = out[:n].float()  # the padded rows saw pad tokens
        self._cross[seq] = out
        return out.cpu().numpy()

    # ------------------------------------------------------------------
    def set_aux_capture(self, layer_ids) -> None:
        """Arm decode(aux=True): the input row of each named layer (id
        n_layers: the pre-output-norm row), concatenated along the feature
        axis (the JAX package's runtime/context.py:357-363; the reference's
        layer_inp / nextn rows, common/speculative.cpp:604-618)."""
        self.aux_layers = tuple(int(i) for i in layer_ids)

    def decode(self, tokens: np.ndarray, seq_idx: np.ndarray, positions: np.ndarray,
               output_rows: np.ndarray, aux: bool = False):
        """Low-level ubatch step -> logits [M, vocab] (f32, host) for the flat
        rows `output_rows` of the [B, T] token grid. aux=True also returns
        the rows of the layers set_aux_capture named, (logits, feats [B, T,
        n_aux * n_embd] f32 on the host); that step runs eagerly."""
        tokens = np.atleast_2d(np.asarray(tokens))
        positions = np.atleast_2d(np.asarray(positions))
        seq_idx = np.asarray(seq_idx).reshape(-1)
        B, T = tokens.shape
        if self.recurrent:  # no padded rows or tokens (llama-batch.h:108's split_equal)
            Tb, Bb = T, B
        else:
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
        cross = self._cross_state(sidx, B) if self.enc_dec else {}
        if aux:
            return self._aux_forward(toks, sidx, pos, out_rows, len(rows), B, T)
        logits = self._forward(self._tensor(toks), self._tensor(sidx), self._tensor(pos),
                               self._tensor(out_rows), **cross)
        return logits[: len(rows)].cpu().numpy()

    def _aux_forward(self, toks, sidx, pos, out_rows, m: int, B: int, T: int):
        """One forward with a tap on the named layers' input rows: [B, T,
        n_aux * E] f32 beside the logits, on the host."""
        if not self.aux_layers:
            raise ValueError("decode(aux=True) needs set_aux_capture's layers first")
        fn = self.model.forward_fn
        if self.enc_dec or "tap" not in inspect.signature(fn).parameters:
            raise NotImplementedError(f"aux capture: {self.cfg.arch!r}'s forward has no tap of "
                                      "its layers' rows (the shared decoder and Gemma 3n/4 do)")
        feats: dict[int, torch.Tensor] = {}

        def tap(il, x):
            if il in self.aux_layers:
                feats[il] = x

        logits = self._forward(self._tensor(toks), self._tensor(sidx), self._tensor(pos),
                               self._tensor(out_rows), tap=tap)
        f = torch.cat([feats[i].float() for i in self.aux_layers], dim=-1)
        return logits[:m].cpu().numpy(), f[:B, :T].cpu().numpy()

    def prefill(self, prompt: list[int], seq: int = 0, aux: bool = False):
        """Feed a prompt in ubatches; returns last-token logits [vocab], or
        with aux (decode(aux=True) on every ubatch) (logits, the prompt's
        rows of set_aux_capture's layers [n, n_aux * n_embd] f32). On an
        encoder-decoder whose sequence holds no cross state yet, the prompt
        goes to the encoder instead, and the decoder's start token is
        decoded at position 0 (the JAX package's runtime/context.py:
        617-630)."""
        t0 = time.perf_counter()
        if self.enc_dec and seq not in self._cross:
            self.encode(prompt, seq=seq)
            start = int(self.cfg.extra.get("decoder_start_token", 0))
            logits = self.decode(np.asarray([[start]]), np.asarray([seq]), np.asarray([[0]]),
                                 np.asarray([0]), aux=aux)  # aux refuses an encoder-decoder
            self.seq_len[seq] = 1
            self.perf.n_prefill += len(prompt)
            self.perf.t_prefill_ms += (time.perf_counter() - t0) * 1e3
            return logits[0]
        pos0 = int(self.seq_len[seq])
        logits, feats = None, []
        for off in range(0, len(prompt), self.n_ubatch):
            chunk = prompt[off: off + self.n_ubatch]
            positions = np.arange(pos0 + off, pos0 + off + len(chunk))
            logits = self.decode(np.asarray(chunk)[None, :], np.asarray([seq]),
                                 positions[None, :], np.asarray([len(chunk) - 1]), aux=aux)
            if aux:
                logits, f = logits
                feats.append(f[0])
        self.seq_len[seq] = pos0 + len(prompt)
        self.perf.n_prefill += len(prompt)
        self.perf.t_prefill_ms += (time.perf_counter() - t0) * 1e3
        return (logits[0], np.concatenate(feats)) if aux else logits[0]

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
        """The decode loop a batch of B rows runs on: the next bucket, whose
        padding rows write the KV's trash row; a recurrent memory has no
        trash state, so its loops run at the exact B."""
        if self.recurrent:
            return B
        return min(max(_bucket(B, [1, 2, 4, 8, 16, 32, 64, self.n_seqs]), B), self.n_seqs)

    def decode_loop(self, batch: int, sampler: DeviceSampler | None = GREEDY) -> DecodeLoop:
        """The on-device decode loop of a batch bucket and sampler (LOGITS:
        the step keeps its logits for the host), made at first use (its CUDA
        graph is captured at its first run on the card). Loops made over an
        earlier KV memory, or before the model's weights last changed
        (adapters applied or removed), are dropped: their graphs read the old
        tensors. An encoder-decoder raises."""
        self._no_device_loop("decode_loop")
        if any(loop.kv is not self.kv or loop.weights != self.model.version
               for loop in self._loops.values()):
            self._loops.clear()
        key = (batch, sampler)
        loop = self._loops.get(key)
        if loop is None:
            capture = self.graphs and self.device.type == "cuda"
            loop = self._loops[key] = DecodeLoop(self, batch, sampler, capture)
        return loop

    def decode_step_greedy(self, tokens: np.ndarray, seqs: np.ndarray) -> np.ndarray:
        """One batched decode step returning only the argmax token per
        sequence (B int32s to the host instead of [B, vocab] logits): one
        step of the batch bucket's greedy loop, a replay on the card. Pages
        are allocated first, so a full pool raises KVCacheFull before the
        step runs. An encoder-decoder's step is decode_step_multi's, eager."""
        if self.enc_dec:  # eager: the step reads the cross state
            return np.argmax(self.decode_step_multi(tokens, seqs), axis=-1).astype(np.int32)
        t0 = time.perf_counter()
        seqs = np.asarray(seqs)
        B = len(seqs)
        self._ensure_pages(seqs, self.seq_len[seqs][:, None])
        loop = self.decode_loop(self._batch_bucket(B))
        out = loop.run(np.asarray(tokens), self.seq_len[seqs], seqs, 1)[:, 0]
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
        (and seq_rm it). An encoder-decoder raises: its steps go through
        decode_step_greedy, eagerly."""
        self._no_device_loop("decode_steps_greedy")
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
        batching): tokens[i] appended to seqs[i]; logits [len(seqs), vocab]
        f32 on the host. One step of the batch bucket's LOGITS loop, a
        replay on the card; pages are allocated first (KVCacheFull before
        the step runs). An encoder-decoder's step runs eagerly (decode), as
        in the JAX package."""
        t0 = time.perf_counter()
        seqs = np.asarray(seqs)
        if self.enc_dec:
            logits = self.decode(np.asarray(tokens)[:, None], seqs, self.seq_len[seqs][:, None],
                                 np.arange(len(seqs)))
        else:
            self._ensure_pages(seqs, self.seq_len[seqs][:, None])
            loop = self.decode_loop(self._batch_bucket(len(seqs)), LOGITS)
            logits = loop.logits_step(np.asarray(tokens), self.seq_len[seqs], seqs)
        self.seq_len[seqs] += 1
        self.perf.n_decode += len(seqs)
        self.perf.t_decode_ms += (time.perf_counter() - t0) * 1e3
        return logits

    # -- sequence management (llama_memory seq API analog) ---------------
    def seq_rm(self, seq: int, p0: int = 0, p1: int = 1 << 30) -> None:
        self.kv.seq_rm(seq, p0, p1)
        if p0 == 0:
            self._cross.pop(seq, None)  # the encoder's output goes with the sequence
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
            # page-granular copy: dst gets fresh pages mirroring src's (and
            # an ISWA memory's window rings their rows, a hybrid memory's
            # recurrent state its row)
            self.alloc.trim(dst, 0)
            self.alloc.ensure(dst, int(self.alloc.count[src]) * self.page)
            self._sync_table()
            src_p = self._tensor(self.alloc.table[src])
            dst_p = self._tensor(self.alloc.table[dst])
            self._pool().copy_pages(src_p, dst_p)
            if isinstance(self.kv, ISWACache):
                self.kv.swa.seq_cp(dst, src)
            elif isinstance(self.kv, HybridMemory):
                self.kv.rs.seq_cp(dst, src)
        if src in self._cross:
            self._cross[dst] = self._cross[src]
        self.seq_len[dst] = self.seq_len[src]

    def context_shift(self, seq: int = 0, n_keep: int = 0, n_discard: int | None = None) -> int:
        """Discard positions [n_keep, n_keep + n_discard) of `seq` and slide
        the rest down, re-rotating the cached K (reference server context
        shift, tools/server/server-context.cpp:2916), in place: a captured
        decode loop goes on reading the same tensors. The default discards
        half of what lies past n_keep. Returns n_discard. The ISWA memory's
        rings and the recurrent and hybrid memories are refused, as the JAX
        package refuses them: a recurrent state cannot drop tokens."""
        if self.recurrent:
            raise NotImplementedError("context shift needs an attention KV, not a recurrent "
                                      f"state ({type(self.kv).__name__})")
        if not isinstance(self.kv, (KVCache, PagedKVCache)):
            raise NotImplementedError("context shift needs the unified cache, not "
                                      f"{type(self.kv).__name__}")
        cur = int(self.seq_len[seq])
        if n_discard is None:
            n_discard = max((cur - n_keep) // 2, 1)
        self.kv.shift_seq(self.cfg, seq, n_keep, n_discard)
        self.seq_len[seq] = max(cur - n_discard, n_keep)
        if self.alloc is not None:
            self.alloc.trim(seq, int(self.seq_len[seq]))
            self._sync_table()
        return n_discard

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
        self._cross.clear()
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
        generate_ondevice); the sampled ids differ from jax.random's. An
        encoder-decoder raises (Context.generate runs it)."""
        self._no_device_loop("generate_ondevice")
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
