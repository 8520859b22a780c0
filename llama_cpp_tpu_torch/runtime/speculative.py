"""Speculative decoding: draft-model and self-speculative n-gram drafting
with batched verification (port of the JAX package's
runtime/speculative.py).

Analog of reference common/speculative.cpp (registry :32-41: the
draft-model and ngram modes) and the server's per-slot drafting loop
(tools/server/server-context.cpp:3001-3048). The target verifies the
drafted tokens in one decode of a [1, 1 + n_draft] ubatch (bucketed to 8 or
16 rows: the qmm decode kernel at N = 8 or 16, and the paged attention's
decode or prefill kernel by the rows a KV head), sampling each position and
accepting the longest agreeing prefix; the rejected rows are dropped by a
suffix seq_rm, which labels their rows empty (position -1) before the next
verify. A speculator that reads the target's hidden features
(needs_features: the Gemma 4 assistant, models/gemma3n.py) gets them from
the target's prefill and verify steps through Context.decode(aux=True);
the EAGLE3 and DFlash drafts are not ported and are refused by name.
"""

from __future__ import annotations

from typing import Protocol

import numpy as np

from ..sampling.samplers import SamplerChain, SamplingParams
from .context import Context


# draft arches whose speculators (feature drafts) are not ported: refused
FEATURE_DRAFTS = ("eagle3", "dflash")


def refused_draft(path: str) -> str | None:
    """The arch of a draft GGUF when it is one of FEATURE_DRAFTS, else None
    (read from the file's metadata, before any load)."""
    from ..gguf.reader import read_gguf

    arch = read_gguf(path).metadata.get("general.architecture")
    return arch if arch in FEATURE_DRAFTS else None


class Speculator(Protocol):
    def draft(self, tokens: list[int], n: int) -> list[int]:
        """Propose up to n continuation tokens for the sequence `tokens`."""
        ...

    def reset(self) -> None: ...


class NgramSpeculator:
    """Prompt-lookup self-speculation (reference common/ngram-map.cpp idea):
    match the longest recent suffix (n_max..n_min) earlier in the sequence
    and propose the tokens that followed it."""

    def __init__(self, n_min: int = 2, n_max: int = 4):
        self.n_min = n_min
        self.n_max = n_max

    def reset(self) -> None:
        pass

    def draft(self, tokens: list[int], n: int) -> list[int]:
        L = len(tokens)
        for g in range(self.n_max, self.n_min - 1, -1):
            if L <= g:
                continue
            suffix = tokens[L - g:]
            # the most recent earlier occurrence
            for start in range(L - g - 1, -1, -1):
                if tokens[start:start + g] == suffix:
                    cont = tokens[start + g: start + g + n]
                    if cont:
                        return cont
        return []


class DraftModelSpeculator:
    """Greedy drafting with a small draft model sharing the vocab
    (reference common/speculative.cpp draft-model mode), on sequence `seq`
    of the draft's own Context."""

    def __init__(self, draft_ctx: Context, seq: int = 0):
        self.ctx = draft_ctx
        self.seq = seq

    def reset(self) -> None:
        self.ctx.seq_rm(self.seq)

    def draft(self, tokens: list[int], n: int) -> list[int]:
        seq = self.seq
        L = len(tokens)
        if L < 1 or L + n + 1 >= self.ctx.n_ctx:
            return []
        # rewind any stale (drafted and rejected) rows past L - 1
        if int(self.ctx.seq_len[seq]) > L - 1:
            self.ctx.seq_rm(seq, p0=max(L - 1, 0))
        # catch up on the confirmed tokens but the last (fed in the loop)
        pending = tokens[int(self.ctx.seq_len[seq]):]
        if len(pending) > 1:
            self.ctx.prefill(pending[:-1], seq=seq)
        out: list[int] = []
        cur = tokens[-1]
        for _ in range(n):
            logits = self.ctx.decode_one(cur, seq=seq)
            cur = int(np.argmax(logits))
            out.append(cur)
        return out


def speculative_generate(
    ctx: Context,
    speculator: Speculator,
    prompt: list[int],
    max_new_tokens: int = 128,
    n_draft: int = 8,
    sampler: SamplerChain | None = None,
    seq: int = 0,
    stream=None,
) -> tuple[list[int], dict]:
    """-> (generated tokens, stats {n_draft, n_accept, n_steps}). Greedy
    (a temp=0 sampler) output is token-identical to plain Context.generate
    wherever the verify step's logits pick the same argmax as the one-row
    step's. A speculator with needs_features gets the rows of its
    target_layers from the prefill and from every verify step, through
    process(tokens, feats, pos0), as the JAX package's loop feeds them."""
    if sampler is None:
        sampler = SamplerChain.from_params(SamplingParams(temp=0.0))
    vocab = ctx.model.tokenizer.vocab if ctx.model.tokenizer else None

    feat = bool(getattr(speculator, "needs_features", False))
    if feat:
        ctx.set_aux_capture(speculator.target_layers)
    pos0 = int(ctx.seq_len[seq])
    logits = ctx.prefill(prompt, seq=seq, aux=feat)
    if feat:
        logits, feats = logits
        speculator.process(prompt, feats, pos0)
    cur = sampler.sample(logits)
    out = [cur]
    if stream:
        stream(cur)
    all_toks = list(prompt) + [cur]
    stats = {"n_draft": 0, "n_accept": 0, "n_steps": 0}

    def eog(t: int) -> bool:
        return vocab is not None and vocab.is_eog(t)

    if eog(cur):
        return out, stats

    while len(out) < max_new_tokens:
        drafted = speculator.draft(all_toks, n_draft)
        # cap by the remaining budget and context
        room = ctx.n_ctx - len(all_toks) - 2
        drafted = drafted[: max(0, min(len(drafted), max_new_tokens - len(out) - 1, room))]
        toks = [cur] + drafted
        pos0 = len(all_toks) - 1
        positions = np.arange(pos0, pos0 + len(toks))
        logits_all = ctx.decode(np.asarray(toks)[None, :], np.asarray([seq]),
                                positions[None, :], np.arange(len(toks)), aux=feat)
        if feat:
            logits_all, vfeats = logits_all
        ctx.perf.n_decode += len(toks)
        stats["n_steps"] += 1
        stats["n_draft"] += len(drafted)

        n_acc = 0
        nxt = None
        for i in range(len(drafted)):
            t = sampler.sample(logits_all[i])
            if t == drafted[i]:
                n_acc += 1
                out.append(t)
                if stream:
                    stream(t)
                if eog(t) or len(out) >= max_new_tokens:
                    nxt = None
                    break
            else:
                nxt = t
                break
        else:
            nxt = sampler.sample(logits_all[len(toks) - 1])
        stats["n_accept"] += n_acc

        # the KV is valid through position pos0 + n_acc; drop the rejected rows
        if n_acc < len(drafted):
            ctx.seq_rm(seq, p0=pos0 + n_acc + 1)
        ctx.seq_len[seq] = pos0 + n_acc + 1
        all_toks.extend(drafted[:n_acc])
        if feat and nxt is not None:
            # the accepted rows' features back to the draft (the reference
            # runs process() on every verify batch)
            speculator.process(toks[: n_acc + 1] + [nxt], vfeats[0][: n_acc + 1], pos0)

        if nxt is None:  # stopped inside the accept loop (end of generation, budget)
            break
        out.append(nxt)
        if stream:
            stream(nxt)
        all_toks.append(nxt)
        cur = nxt
        if eog(nxt):
            break
    return out, stats
