"""Continuous-batching scheduler: slots + task queue + step loop.

Parity with reference llama-server internals (tools/server/server-context.cpp):
slot states IDLE->PROCESSING_PROMPT->GENERATING (:58-65), the update_slots
step loop (:2802-2910) doing prompt chunking + one batched decode per token
step + per-slot sampling/stop handling, and the deferred task queue
(server-queue.h:13-60). Runs in a dedicated thread; results stream out via
thread-safe callbacks.

A copy of the JAX package's server/scheduler.py over this package's Context,
samplers, grammar and speculators. The scheduler thread is the only thread
that touches the card: HTTP threads reach the Context through `run_sync`,
and every draft Context, seq op and state call runs on it too. On the card
the batched decode step (`decode_step_greedy` when every slot is greedy,
`decode_step_multi` otherwise) replays the batch bucket's CUDA graph.
With a spec_factory each slot drafts (n-gram lookup or a draft model) and
all slots' [token | drafts] rows are verified in one batched decode, each
slot keeping its longest accepted prefix (`_spec_step`). A slot that
reaches n_ctx shifts its context (Context.context_shift: the older half
past n_keep is dropped and the rest slides down) and goes on, unless
enable_ctx_shift=False, when it finishes with "length". Multimodal prompts
are refused, not emulated: a task with `chunks` fails with a message naming
mtmd. An encoder-decoder (T5) takes its whole prompt through
Context.prefill (the encoder, then the decoder's start token) and its
decode steps run eagerly (Context.decode_step_greedy and
decode_step_multi take Context.decode for it); its slots keep no prompt
prefix, since their memory holds decoder tokens. A draft that reads the
target's features (the Gemma 4 assistant) gets them from the slot's
prefill chunks and from every batched verify step (Context.decode(aux=True)).
"""

from __future__ import annotations

import enum
import logging
import queue
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from ..runtime.context import Context
from ..runtime.paged_kv import KVCacheFull
from ..sampling.grammar import GrammarSampler
from ..sampling.samplers import SamplerChain, SamplingParams

log = logging.getLogger("server")

MTMD_REFUSED = "error: multimodal prompts (multimodal/mtmd.py) are not ported"


class SlotState(enum.Enum):
    IDLE = 0
    PROMPT = 1
    GENERATING = 2


@dataclass
class GenTask:
    prompt_ids: list[int]
    params: SamplingParams
    max_tokens: int = 128
    stop_strings: list[str] = field(default_factory=list)
    ignore_eos: bool = False
    grammar: str = ""
    grammar_lazy: bool = False
    grammar_trigger_patterns: tuple = ()
    grammar_trigger_tokens: tuple = ()
    stream_cb: Callable[[dict], None] | None = None  # called per token (any thread)
    done_cb: Callable[[dict], None] | None = None
    task_id: str = field(default_factory=lambda: uuid.uuid4().hex[:16])
    n_probs: int = 0
    cache_prompt: bool = True  # reuse common KV prefix (reference default)
    cancelled: bool = False
    # multimodal chunks: refused (the task fails with MTMD_REFUSED)
    chunks: list | None = None


@dataclass
class Slot:
    idx: int
    state: SlotState = SlotState.IDLE
    task: GenTask | None = None
    sampler: SamplerChain | None = None
    grammar: GrammarSampler | None = None
    prompt_pos: int = 0
    generated: list[int] = field(default_factory=list)
    cache_tokens: list[int] = field(default_factory=list)  # tokens in KV
    speculator: Any = None  # per-slot drafter (spec_factory), or None
    text: str = ""
    sent_text_len: int = 0
    t_start: float = 0.0
    t_first_token: float = 0.0

    def reset(self):
        # cache_tokens survives reset: the KV keeps the old sequence so the
        # next request can reuse a common prefix (server prompt cache,
        # reference tools/server update_slots prompt reuse)
        self.state = SlotState.IDLE
        self.task = None
        self.sampler = None
        self.grammar = None
        self.prompt_pos = 0
        self.generated = []
        self.text = ""
        self.sent_text_len = 0


class Scheduler:
    """One inference thread owning the Context; HTTP threads post GenTasks."""

    def __init__(self, ctx: Context, n_slots: int | None = None,
                 enable_ctx_shift: bool = True,
                 spec_factory: Callable[[int], Any] | None = None, n_draft: int = 8):
        self.ctx = ctx
        self.enable_ctx_shift = enable_ctx_shift
        self.n_slots = n_slots or ctx.n_seqs
        if self.n_slots > ctx.n_seqs:
            raise ValueError(f"{self.n_slots} slots over a context of {ctx.n_seqs} sequences")
        self.slots = [Slot(i) for i in range(self.n_slots)]
        # per-slot speculative drafting (reference update_slots drafts per
        # slot inside the step loop, server-context.cpp:3001-3048)
        self.spec_factory = spec_factory if not ctx.recurrent else None
        self.n_draft = n_draft
        self.tasks: queue.Queue[GenTask] = queue.Queue()
        self.calls: queue.Queue = queue.Queue()  # sync calls into the sched thread
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.metrics = {
            "requests_total": 0,
            "tokens_predicted_total": 0,
            "tokens_prompt_total": 0,
            "tokens_prompt_cached_total": 0,
            "draft_tokens_total": 0,
            "draft_tokens_accepted": 0,
            "busy_slots": 0,
        }

    # ------------------------------------------------------------------
    def submit(self, task: GenTask) -> str:
        self.tasks.put(task)
        self.metrics["requests_total"] += 1
        return task.task_id

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True, name="sched")
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=10)

    # ------------------------------------------------------------------
    def _launch(self, slot: Slot, task: GenTask):
        tok = self.ctx.model.tokenizer
        slot.task = task
        slot.state = SlotState.PROMPT
        slot.prompt_pos = 0
        slot.generated = []
        slot.text = ""
        slot.sent_text_len = 0
        slot.t_start = time.perf_counter()
        slot.sampler = SamplerChain.from_params(
            task.params, tok.vocab if tok else None
        )
        if task.params.reasoning_budget >= 0 and tok is not None:
            from ..sampling.samplers import make_reasoning_budget

            slot.sampler.samplers.insert(0, make_reasoning_budget(
                tok.vocab,
                lambda s: tok.encode(s, add_special=False,
                                     parse_special=True),
                task.params.reasoning_budget))
        slot.grammar = None
        slot.speculator = None
        if self.spec_factory is not None:
            slot.speculator = self.spec_factory(slot.idx)
            if slot.speculator is not None and hasattr(slot.speculator, "reset"):
                slot.speculator.reset()
            if getattr(slot.speculator, "needs_features", False) and not self.ctx.aux_layers:
                self.ctx.set_aux_capture(slot.speculator.target_layers)
        if task.grammar and tok is not None:
            try:
                slot.grammar = GrammarSampler(
                    task.grammar, tok, lazy=task.grammar_lazy,
                    trigger_patterns=tuple(task.grammar_trigger_patterns),
                    trigger_tokens=tuple(task.grammar_trigger_tokens))
            except Exception as e:
                log.warning("grammar rejected: %s", e)
        # sampler sees the prompt for penalties context
        for t in task.prompt_ids[-task.params.n_prev :]:
            slot.sampler.state.prev.append(t)
        # prompt cache: keep the longest common prefix with what this slot's
        # KV already holds; re-decode only the divergent tail (at least the
        # final token, whose logits we need)
        n_keep = 0
        # a recurrent state holds no positions to keep a prefix of (seq_rm
        # with p0 > 0 raises): its prompt is decoded whole; an
        # encoder-decoder's memory holds decoder tokens, not the prompt
        if task.cache_prompt and not self.ctx.recurrent and not self.ctx.enc_dec:
            limit = min(len(slot.cache_tokens), len(task.prompt_ids) - 1)
            while n_keep < limit and slot.cache_tokens[n_keep] == task.prompt_ids[n_keep]:
                n_keep += 1
        if n_keep > 0:
            self.ctx.seq_rm(slot.idx, p0=n_keep)
            slot.prompt_pos = n_keep
            self.metrics["tokens_prompt_cached_total"] += n_keep
        else:
            self.ctx.seq_rm(slot.idx)
        # cache_tokens tracks tokens actually DECODED into KV (reference
        # pushes to the cache list only when a token enters a decode batch,
        # server-context.cpp:520); prompt chunks extend it as they decode
        slot.cache_tokens = list(task.prompt_ids[:n_keep])

    def _finish(self, slot: Slot, reason: str):
        task = slot.task
        n_gen = len(slot.generated)
        dt = time.perf_counter() - slot.t_start
        if task and task.done_cb:
            task.done_cb(
                {
                    "task_id": task.task_id,
                    "text": slot.text,
                    "tokens": list(slot.generated),
                    "finish_reason": reason,
                    "n_prompt": len(task.prompt_ids),
                    "n_generated": n_gen,
                    "t_total_s": dt,
                }
            )
        self.metrics["tokens_predicted_total"] += n_gen
        slot.reset()

    # ------------------------------------------------------------------
    def run_sync(self, fn: Callable[[], Any], timeout: float = 120.0):
        """Execute fn on the scheduler thread (the Context is single-owner,
        like the reference's single inference thread) and return its result."""
        ev = threading.Event()
        box: dict[str, Any] = {}

        def wrapped():
            try:
                box["result"] = fn()
            except Exception as e:  # pragma: no cover
                box["error"] = e
            ev.set()

        self.calls.put(wrapped)
        if not ev.wait(timeout):
            raise TimeoutError("scheduler call timed out")
        if "error" in box:
            raise box["error"]
        return box["result"]

    def _loop(self):
        while not self._stop.is_set():
            while not self.calls.empty():
                try:
                    self.calls.get_nowait()()
                except queue.Empty:
                    break
            try:
                did_work = self._step()
            except Exception as e:
                # the inference thread must survive (reference converts step
                # exceptions into abort_all_slots + HTTP errors,
                # server-context.cpp:2895): fail the active slots, keep going
                log.exception("scheduler step failed: %s", e)
                for s in self.slots:
                    if s.state != SlotState.IDLE:
                        try:
                            self.ctx.seq_rm(s.idx)
                        except Exception:
                            pass
                        s.cache_tokens = []
                        self._finish(s, f"error: {type(e).__name__}")
                did_work = True
            if not did_work:
                try:
                    task = self.tasks.get(timeout=0.05)
                    self._admit(task)
                except queue.Empty:
                    pass

    def _admit(self, task: GenTask):
        free = [s for s in self.slots if s.state == SlotState.IDLE]
        if free:
            # pick the slot whose cached tokens share the longest prefix
            # (reference server slot selection by prompt similarity)
            def common(slot):
                n = 0
                lim = min(len(slot.cache_tokens), len(task.prompt_ids))
                while n < lim and slot.cache_tokens[n] == task.prompt_ids[n]:
                    n += 1
                return n
            self._launch(max(free, key=common), task)
            return
        # no free slot: requeue at the back (deferred task)
        self.tasks.put(task)
        time.sleep(0.005)

    def _step(self) -> bool:
        """One update_slots iteration. Returns True if any work happened."""
        # admit queued tasks into free slots first
        while not self.tasks.empty():
            free = [s for s in self.slots if s.state == SlotState.IDLE]
            if not free:
                break
            try:
                self._admit(self.tasks.get_nowait())
            except queue.Empty:
                break

        self.metrics["busy_slots"] = sum(
            1 for s in self.slots if s.state != SlotState.IDLE
        )

        # 1) prompt processing: chunk one slot's prompt per iteration, then
        # FALL THROUGH to a decode step so generating slots are not starved
        # by a long prompt (reference update_slots packs both in one batch)
        did_prompt = False
        for slot in self.slots:
            if slot.state != SlotState.PROMPT:
                continue
            task = slot.task
            if task.cancelled:
                self._finish(slot, "cancelled")
                continue
            if task.chunks is not None:
                self._finish(slot, MTMD_REFUSED)
                continue
            remaining = task.prompt_ids[slot.prompt_pos :]
            # an encoder-decoder's prompt is the encoder's input, in one piece
            chunk = remaining if self.ctx.enc_dec else remaining[: self.ctx.n_ubatch]
            is_last = len(chunk) == len(remaining)
            try:
                logits = self._prefill_chunk(slot.idx, chunk, slot.prompt_pos, slot)
            except KVCacheFull:
                # pool over-committed (reference FAILED_PREPARE): release
                # this slot's pages; retry once other slots free capacity,
                # or fail if this prompt alone exceeds the pool
                self.ctx.seq_rm(slot.idx)
                slot.cache_tokens = []
                if any(s is not slot and s.state != SlotState.IDLE
                       for s in self.slots):
                    log.warning("KV pool full; deferring task %s", task.task_id)
                    t = slot.task
                    slot.reset()
                    self.tasks.put(t)
                else:
                    self._finish(slot, "error_kv_cache_full")
                continue
            slot.prompt_pos += len(chunk)
            slot.cache_tokens.extend(chunk)
            self.metrics["tokens_prompt_total"] += len(chunk)
            if is_last:
                slot.state = SlotState.GENERATING
                self._emit_token(slot, logits)
            did_prompt = True
            break

        # 2) one batched decode step across all generating slots
        gen = [s for s in self.slots if s.state == SlotState.GENERATING]
        if not gen:
            return did_prompt
        for s in list(gen):
            if s.task.cancelled:
                self._finish(s, "cancelled")
                gen.remove(s)
        if not gen:
            return True
        if any(s.speculator is not None for s in gen) and self._spec_step(gen):
            return True
        toks = np.asarray([s.generated[-1] for s in gen])
        seqs = np.asarray([s.idx for s in gen])
        if all(self._device_greedy_ok(s) for s in gen):
            # fused on-device sampling: ship B token ids, not [B, vocab]
            # logits (critical across a slow host<->chip link)
            try:
                new_toks = self.ctx.decode_step_greedy(toks, seqs)
            except KVCacheFull:
                self._reclaim_victim(gen)
                return True
            for i, slot in enumerate(gen):
                slot.cache_tokens.append(int(toks[i]))
            for i, slot in enumerate(gen):
                t = int(new_toks[i])
                slot.sampler.accept(t)  # keep prev-window state coherent
                self._process_token(slot, t)
            return True
        try:
            logits = self.ctx.decode_step_multi(toks, seqs)
        except KVCacheFull:
            self._reclaim_victim(gen)
            return True
        for i, slot in enumerate(gen):
            slot.cache_tokens.append(int(toks[i]))  # now decoded into KV
        for i, slot in enumerate(gen):
            self._emit_token(slot, logits[i])
        return True

    @staticmethod
    def _device_greedy_ok(slot: Slot) -> bool:
        """Token choice is exactly device argmax: greedy chain with no
        logit-mutating samplers or grammar."""
        p = slot.task.params
        return (p.is_greedy and slot.grammar is None and not p.logit_bias
                and p.penalty_repeat == 1.0 and p.penalty_freq == 0.0
                and p.penalty_present == 0.0 and p.dry_multiplier == 0.0
                and p.reasoning_budget < 0 and slot.task.n_probs == 0)

    def _reclaim_victim(self, gen):
        # reclaim by finishing the longest-running generation; the
        # remaining slots retry next iteration
        victim = max(gen, key=lambda s: len(s.cache_tokens))
        log.warning("KV pool full; truncating slot %d", victim.idx)
        self.ctx.seq_rm(victim.idx)  # release its pages now
        victim.cache_tokens = []
        self._finish(victim, "length")

    def _spec_step(self, gen) -> bool:
        """Speculative batched decode (reference server-context.cpp:3001-
        3048): draft per slot, pack the [cur | drafted...] rows of all slots
        into one batched decode (padding rows at position -1 of the first
        slot's sequence, which write the memory's trash row), then per slot
        accept the longest agreeing prefix and roll the rest back with a
        suffix seq_rm. Returns False when no slot drafted (the caller takes
        the plain step)."""
        ctx = self.ctx
        drafts: list[list[int]] = []
        for s in gen:
            d: list[int] = []
            if s.speculator is not None:
                hist = s.cache_tokens + [s.generated[-1]]
                try:
                    d = list(s.speculator.draft(hist, self.n_draft))
                except Exception as e:  # drafting must never kill the step
                    log.warning("draft failed: %s", e)
                    d = []
                room = ctx.n_ctx - int(ctx.seq_len[s.idx]) - 2
                cap = s.task.max_tokens - len(s.generated) - 1
                d = d[: max(0, min(len(d), room, cap))]
            drafts.append(d)
        featured = any(getattr(s.speculator, "needs_features", False) for s in gen)
        T = 1 + max((len(d) for d in drafts), default=0)
        if T == 1 and not featured:
            return False
        B = len(gen)
        Bb = 1
        while Bb < B:
            Bb *= 2
        toks = np.zeros((Bb, T), np.int32)
        pos = np.full((Bb, T), -1, np.int32)
        seqs = np.full(Bb, gen[0].idx, np.int32)
        for i, s in enumerate(gen):
            row = [s.generated[-1]] + drafts[i]
            p0 = int(ctx.seq_len[s.idx])
            toks[i, : len(row)] = row
            pos[i, : len(row)] = np.arange(p0, p0 + len(row))
            seqs[i] = s.idx
        feats = None
        try:
            # featured: every row's target features for the drafts' process()
            logits = ctx.decode(toks, seqs, pos, np.arange(Bb * T), aux=featured)
            if featured:
                logits, feats = logits
        except KVCacheFull:
            self._reclaim_victim(gen)
            return True
        logits = np.asarray(logits).reshape(Bb, T, -1)
        ctx.perf.n_decode += B * T

        for i, s in enumerate(gen):
            d = drafts[i]
            p0 = int(ctx.seq_len[s.idx])
            s.cache_tokens.append(int(toks[i, 0]))
            self.metrics["draft_tokens_total"] += len(d)
            emit: list[int] = []
            n_acc = 0
            for j in range(len(d)):
                t = self._sample_slot(s, logits[i, j])
                emit.append(t)
                if t != d[j]:
                    break
                n_acc += 1
            else:
                emit.append(self._sample_slot(s, logits[i, len(d)]))
            # the KV is valid through p0 + n_acc (cur and the accepted drafts)
            if n_acc < len(d):
                ctx.seq_rm(s.idx, p0=p0 + n_acc + 1)
            ctx.seq_len[s.idx] = p0 + n_acc + 1
            s.cache_tokens.extend(d[:n_acc])
            self.metrics["draft_tokens_accepted"] += n_acc
            if feats is not None and getattr(s.speculator, "needs_features", False):
                row = [int(toks[i, 0])] + d[:n_acc] + [int(emit[n_acc])]
                s.speculator.process(row, feats[i, : n_acc + 1], p0)
            for t in emit:
                self._process_token(s, int(t))
                if s.state != SlotState.GENERATING:
                    break
        return True

    def _sample_slot(self, slot: Slot, logits: np.ndarray) -> int:
        lg = np.array(logits, dtype=np.float32)
        if slot.grammar is not None:
            lg = slot.grammar.filter_logits(lg)
        token = slot.sampler.sample(lg)
        if slot.grammar is not None:
            slot.grammar.accept(token)
        return token

    def _prefill_chunk(self, seq: int, chunk: list[int], pos0: int, slot: Slot | None = None):
        if self.ctx.enc_dec:  # the encoder, then the decoder's start token
            return self.ctx.prefill(chunk, seq=seq)
        positions = np.arange(pos0, pos0 + len(chunk))
        featured = slot is not None and getattr(slot.speculator, "needs_features", False)
        logits = self.ctx.decode(np.asarray(chunk)[None, :], np.asarray([seq]),
                                 positions[None, :], np.asarray([len(chunk) - 1]), aux=featured)
        if featured:
            logits, feats = logits
            slot.speculator.process(chunk, feats[0], pos0)
        self.ctx.seq_len[seq] = pos0 + len(chunk)
        return logits[0]

    def _emit_token(self, slot: Slot, logits: np.ndarray):
        self._process_token(slot, self._sample_slot(slot, logits))

    def _process_token(self, slot: Slot, token: int):
        """Post-sampling bookkeeping for one emitted token: stop conditions,
        streaming, context shift (reference process_token)."""
        task = slot.task
        tok = self.ctx.model.tokenizer
        slot.generated.append(token)
        if not slot.t_first_token:
            slot.t_first_token = time.perf_counter() - slot.t_start

        piece = tok.piece(token) if tok else str(token)
        is_eog = tok.is_eog(token) if tok else False
        if is_eog and not task.ignore_eos:
            self._finish(slot, "stop")
            return
        slot.text += piece

        # stop strings (reference process_token stop handling)
        for ss in task.stop_strings:
            idx = slot.text.find(ss, max(0, len(slot.text) - len(ss) - len(piece)))
            if idx >= 0:
                slot.text = slot.text[:idx]
                self._delta(slot)
                self._finish(slot, "stop")
                return

        self._delta(slot)
        if len(slot.generated) >= task.max_tokens:
            self._finish(slot, "length")
            return
        if int(self.ctx.seq_len[slot.idx]) + 1 >= self.ctx.n_ctx:
            # context shift: drop the older half past n_keep and go on
            # (reference server context shift, server-context.cpp:2916)
            if self.enable_ctx_shift and not self.ctx.recurrent:
                try:
                    n_keep = min(getattr(slot.task, "n_keep", 0) or 0, self.ctx.n_ctx // 2)
                    n_discard = self.ctx.context_shift(slot.idx, n_keep=n_keep)
                    # keep cache_tokens position-aligned with the shifted KV
                    # (reference server-context.cpp:2957-2970)
                    slot.cache_tokens = (slot.cache_tokens[:n_keep]
                                         + slot.cache_tokens[n_keep + n_discard:])
                    return
                except NotImplementedError:
                    pass
            self._finish(slot, "length")

    def _delta(self, slot: Slot):
        task = slot.task
        if task.stream_cb is None:
            return
        # hold back a possible partial stop-string suffix
        hold = max((len(s) - 1 for s in task.stop_strings), default=0)
        emit_to = len(slot.text) - hold
        if emit_to > slot.sent_text_len:
            delta = slot.text[slot.sent_text_len : emit_to]
            slot.sent_text_len = emit_to
            task.stream_cb(
                {"task_id": task.task_id, "delta": delta, "token": slot.generated[-1]}
            )
