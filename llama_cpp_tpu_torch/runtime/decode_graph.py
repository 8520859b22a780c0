"""The decode loop on the device: one decode step per (batch bucket,
sampler), captured as a CUDA graph at first use and replayed once a step.

Port of the scan bodies of the JAX package's runtime/context.py
(`_gen_chunk_fn`, `decode_steps_greedy`): there a `lax.scan` runs a chunk
of steps in one dispatch. Here the step reads static device buffers (the
tokens, positions and sequence ids of the batch rows), runs `forward`,
samples on the device, writes the ids at a step index kept on the device
and advances tokens, positions and the index in place, so replaying its
graph n times is the scan of n steps, and the host copies the ids once a
chunk. The KV memory is written in place, which is the effect the JAX
package's runtime/decode_window.py gets under XLA.

A recurrent or hybrid memory has no trash state row, so its loops run at
the exact batch (Context._batch_bucket) and no padding row ever reads or
writes a live sequence's state.

A loop of sampler LOGITS is the server's step (`Context.decode_step_multi`):
it keeps the [bucket, vocab] f32 logits, the graph's own output buffer, for
the host's sampler chain and grammar, and advances nothing; the host copies
the first B rows out before the next replay overwrites them.

`DecodeLoop.step` is the only step body: on the card it is captured, on
the CPU (and under Context(graphs=False)) it runs eagerly. A step that
cannot be captured raises with the reason; nothing falls back.

What capture needs from the kernels' wrappers:
  * the scratch buffers they cache per (device, stream) are handed out
    under `scratch.holding()`, and the graph keeps them alive;
  * the capture runs on a stream of its own, warmed up by eager steps
    first, so the wrappers' first allocations for that stream fall outside
    the capture;
  * the inputs and outputs of every launch (tensor maps included) keep
    their addresses across replays: the buffers here are static and the
    step's intermediates live in the graph's private memory pool;
  * the launch counters count at capture, not at replay: the counts of one
    step are taken off again after the capture and added back at every
    replay.
"""

from __future__ import annotations

import gc
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.kernels import flash_attn, qmm, qmm_bench, qmm_expert, scratch
from .memory import HybridMemory, RecurrentState

CAPACITY = 256  # steps of ids a loop holds on the device between copies
PAD_POS = -(1 << 20)  # a padding row's position: negative for every step
WARMUP_STEPS = 2
LAUNCH_COUNTERS = (qmm.launches, flash_attn.launches, flash_attn.ring_launches,
                   qmm_expert.launches, qmm_bench.launches)


@dataclass(frozen=True)
class DeviceSampler:
    """The JAX package's on-device sampler (`sample` of `_gen_chunk_fn`):
    greedy (temp <= 0) is an argmax; otherwise the logits over temp, those
    below the k-th largest masked out when top_k > 0, and a Gumbel-max draw
    from `generator` (torch.multinomial would synchronise the host). The
    draws cannot equal jax.random's."""

    temp: float = 0.0
    top_k: int = 0

    @property
    def greedy(self) -> bool:
        return self.temp <= 0

    def __call__(self, logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        """[B, V] f32 logits -> [B] int32 ids."""
        if self.greedy:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        scaled = logits.float() / max(self.temp, 1e-6)
        if self.top_k > 0:
            kth = torch.topk(scaled, min(self.top_k, scaled.shape[-1]), dim=-1).values[..., -1:]
            scaled = scaled.masked_fill(scaled < kth, float("-inf"))
        u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        return torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)


GREEDY = DeviceSampler()
LOGITS = None  # no sampler on the device: the step keeps its logits for the host


def _counts() -> list[dict[str, int]]:
    return [dict(c) for c in LAUNCH_COUNTERS]


class DecodeLoop:
    """The decode loop of one batch bucket and sampler over a Context's KV
    memory: static buffers, the step body, and its graph when captured."""

    def __init__(self, ctx, batch: int, sampler: DeviceSampler | None, capture: bool):
        dev = ctx.device
        # a weak reference: the context owns its loops, so dropping it frees
        # their graphs at once, never in a garbage collection that might run
        # inside another graph's capture (which a graph's release would end)
        self._ctx = weakref.ref(ctx)
        self.kv = ctx.kv  # the memory the graph writes; a new one needs a new loop
        self.weights = ctx.model.version  # changed weights need a new loop too
        self.batch = batch
        self.sampler = sampler
        self.capture = capture
        self.tok = torch.zeros(batch, dtype=torch.int32, device=dev)
        self.pos = torch.full((batch,), PAD_POS, dtype=torch.int32, device=dev)
        self.seq = torch.zeros(batch, dtype=torch.int32, device=dev)
        self.rows = torch.arange(batch, device=dev)
        self.out = torch.zeros((batch, CAPACITY), dtype=torch.int32, device=dev)
        self.index = torch.zeros(1, dtype=torch.int64, device=dev)
        self.generator = torch.Generator(device=dev)
        self.logits: torch.Tensor | None = None  # [batch, vocab] f32, LOGITS loops
        self.graph: torch.cuda.CUDAGraph | None = None
        self.stream: torch.cuda.Stream | None = None  # the capture's
        self.held: list[torch.Tensor] = []  # scratch buffers the graph replays into
        self.step_counts: dict[tuple[int, str], int] = {}  # launches of one replay
        self.replays = 0
        self.graph_bytes = 0  # device memory the capture reserved (its private pool)

    def step(self) -> None:
        """One decode step of every row: the only step body."""
        logits = self._ctx()._forward(self.tok[:, None], self.seq, self.pos[:, None], self.rows)
        if self.sampler is LOGITS:
            self.logits = logits  # captured: the graph's output, rewritten by every replay
            return
        nxt = self.sampler(logits, self.generator)
        self.out.index_copy_(1, self.index, nxt[:, None])
        self.tok.copy_(nxt)
        self.pos.add_(1)
        self.index.add_(1)

    def ready(self) -> None:
        """Capture the step on the card if it is not captured yet. Warm-up
        steps run on the capture stream with every row a padding row (their
        KV writes go to the memory's trash row; a recurrent state, which has
        no trash row, is saved before them and put back after); the buffers
        are reset after."""
        if not self.capture or self.graph is not None:
            return
        dev = self.tok.device
        gc.collect()  # release unreachable graphs now, not during the capture
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream(device=dev)
        rs = self.kv.rs if isinstance(self.kv, HybridMemory) else self.kv
        if not isinstance(rs, RecurrentState):
            rs = None
        try:
            self.pos.fill_(PAD_POS)
            saved = None if rs is None else (rs.conv.clone(), rs.ssm.clone())
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                for _ in range(WARMUP_STEPS):
                    self.step()
            torch.cuda.current_stream(dev).wait_stream(stream)
            if saved is not None:
                rs.conv.copy_(saved[0])
                rs.ssm.copy_(saved[1])
                del saved
            if self.sampler is not LOGITS and not self.sampler.greedy:
                graph.register_generator_state(self.generator)
            before = _counts()
            # what the capture's entry does first: its private pool is then
            # the growth of the reserved memory
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            with scratch.holding() as held, torch.cuda.graph(graph, stream=stream):
                self.step()
        except RuntimeError as e:
            raise RuntimeError(
                f"the decode step at B={self.batch} ({self.sampler}) could not be captured "
                f"as a CUDA graph: {e}") from e
        after = _counts()
        self.graph_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.step_counts = {(i, k): after[i][k] - before[i][k] for i in range(len(after))
                            for k in after[i] if after[i][k] != before[i][k]}
        for (i, k), n in self.step_counts.items():  # nothing launched at capture
            LAUNCH_COUNTERS[i][k] -= n
        self.held = held
        self.graph = graph
        self.stream = stream
        self.index.zero_()
        self.pos.fill_(PAD_POS)

    def advance(self) -> None:
        """One step: a replay of the graph, or the step body run eagerly."""
        if self.graph is None:
            self.step()
            return
        self.graph.replay()
        self.replays += 1
        for (i, k), n in self.step_counts.items():
            LAUNCH_COUNTERS[i][k] += n

    def _load(self, tokens, positions, seqs) -> None:
        """Fill the static buffers: tokens [B] at positions [B] of sequences
        [B] (B <= the bucket); the other rows pad at PAD_POS (trash writes)."""
        B = len(tokens)
        tok = np.zeros(self.batch, np.int32)
        pos = np.full(self.batch, PAD_POS, np.int32)
        seq = np.zeros(self.batch, np.int32)
        tok[:B] = tokens
        pos[:B] = positions
        seq[:B] = seqs
        for buf, a in ((self.tok, tok), (self.pos, pos), (self.seq, seq)):
            buf.copy_(torch.from_numpy(a))

    def run(self, tokens, positions, seqs, n_steps: int) -> np.ndarray:
        """n_steps steps from tokens [B] at positions [B] of sequences [B]
        (B <= the bucket; the other rows pad) -> ids [B, n_steps], copied to
        the host once."""
        self.ready()
        B = len(tokens)
        if n_steps <= 0:
            return np.zeros((B, 0), np.int32)
        self._load(tokens, positions, seqs)
        self.index.zero_()
        parts = []
        done = 0
        while done < n_steps:
            n = min(self.out.shape[1], n_steps - done)
            for _ in range(n):
                self.advance()
            done += n
            parts.append(self.out[:, :n].clone() if done < n_steps else self.out[:, :n])
            self.index.zero_()
        return torch.cat(parts, dim=1)[:B].cpu().numpy()

    def logits_step(self, tokens, positions, seqs) -> np.ndarray:
        """One step of a LOGITS loop -> f32 logits [B, vocab] on the host,
        copied before the next replay can overwrite them."""
        if self.sampler is not LOGITS:
            raise ValueError(f"logits_step on a loop that samples ({self.sampler})")
        self.ready()
        self._load(tokens, positions, seqs)
        self.advance()
        return self.logits[: len(tokens)].cpu().numpy()
