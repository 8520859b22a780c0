"""Sampler chain: llama.cpp-compatible token samplers.

Parity inventory (reference include/llama.h:1339-1496, impl
src/llama-sampler.cpp): greedy, dist, top-k, top-p, min-p, typical, temp,
temp-ext (entropy-dynamic), XTC, top-n-sigma, mirostat v1/v2, penalties
(repeat/freq/presence), DRY, logit-bias, infill; chain composition mirrors
llama_sampler_chain. Host-side numpy implementation (the reference samples on
CPU too); the greedy/dist fast path also has an on-device jit twin used by the
decode loop.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np


@dataclass
class SamplingParams:
    """Mirror of common_params_sampling (reference common/common.h:200-260)."""

    seed: int = 0xFFFFFFFF
    n_prev: int = 64
    top_k: int = 40
    top_p: float = 0.95
    min_p: float = 0.05
    typical_p: float = 1.0
    temp: float = 0.8
    dynatemp_range: float = 0.0
    dynatemp_exponent: float = 1.0
    penalty_last_n: int = 64
    penalty_repeat: float = 1.0
    penalty_freq: float = 0.0
    penalty_present: float = 0.0
    dry_multiplier: float = 0.0
    dry_base: float = 1.75
    dry_allowed_length: int = 2
    dry_penalty_last_n: int = -1
    dry_sequence_breakers: tuple[str, ...] = ("\n", ":", '"', "*")
    xtc_probability: float = 0.0
    xtc_threshold: float = 0.10
    top_n_sigma: float = -1.0
    mirostat: int = 0
    mirostat_tau: float = 5.0
    mirostat_eta: float = 0.1
    mirostat_m: int = 100  # v1 s_hat estimation window
    adaptive_target: float = -1.0  # negative = disabled
    adaptive_decay: float = 0.90
    infill: bool = False  # fill-in-the-middle sampler (needs vocab)
    logit_bias: dict[int, float] = field(default_factory=dict)
    grammar: str = ""
    reasoning_budget: int = -1  # max tokens inside <think>…</think>; -1 = off

    @property
    def is_greedy(self) -> bool:
        return self.temp <= 0 and self.mirostat == 0

    def apply_gguf_defaults(self, md: dict,
                            explicit: set[str] = frozenset()) -> "SamplingParams":
        """Model-embedded sampling defaults (reference llama-arch.cpp:157-168
        general.sampling.* keys, written by the model saver): any field the
        caller did NOT set explicitly takes the GGUF value when present."""
        from dataclasses import replace

        keymap = {  # gguf suffix -> field, cast
            "top_k": ("top_k", int), "top_p": ("top_p", float),
            "min_p": ("min_p", float), "temp": ("temp", float),
            "xtc_probability": ("xtc_probability", float),
            "xtc_threshold": ("xtc_threshold", float),
            "penalty_last_n": ("penalty_last_n", int),
            "penalty_repeat": ("penalty_repeat", float),
            "mirostat": ("mirostat", int),
            "mirostat_tau": ("mirostat_tau", float),
            "mirostat_eta": ("mirostat_eta", float),
        }
        upd = {}
        for suffix, (field_name, cast) in keymap.items():
            v = md.get(f"general.sampling.{suffix}")
            if v is not None and field_name not in explicit:
                upd[field_name] = cast(v)
        return replace(self, **upd) if upd else self


def _softmax(logits: np.ndarray) -> np.ndarray:
    m = logits.max()
    e = np.exp(logits - m)
    return e / e.sum()


class Sampler:
    def apply(self, state: "SamplerState", logits: np.ndarray) -> np.ndarray:
        return logits

    def accept(self, state: "SamplerState", token: int) -> None:
        pass

    def reset(self) -> None:
        pass


@dataclass
class SamplerState:
    prev: list[int] = field(default_factory=list)
    rng: np.random.Generator = field(default_factory=lambda: np.random.default_rng(0))
    mu: float = 0.0  # mirostat state


class LogitBias(Sampler):
    def __init__(self, bias: dict[int, float]):
        self.bias = bias

    def apply(self, state, logits):
        for t, b in self.bias.items():
            if 0 <= t < len(logits):
                logits[t] += b
        return logits


class Penalties(Sampler):
    """repeat/freq/presence penalties (llama_sampler_init_penalties)."""

    def __init__(self, last_n: int, repeat: float, freq: float, present: float):
        self.last_n, self.repeat, self.freq, self.present = last_n, repeat, freq, present

    def apply(self, state, logits):
        if self.last_n == 0 or (self.repeat == 1.0 and self.freq == 0 and self.present == 0):
            return logits
        window = state.prev[-self.last_n :] if self.last_n > 0 else state.prev
        if not window:
            return logits
        toks, counts = np.unique(np.asarray(window), return_counts=True)
        sel = logits[toks]
        if self.repeat != 1.0:
            sel = np.where(sel <= 0, sel * self.repeat, sel / self.repeat)
        sel = sel - counts * self.freq - (counts > 0) * self.present
        logits[toks] = sel
        return logits


class Dry(Sampler):
    """DRY sequence-repetition penalty (llama_sampler_init_dry); penalizes
    tokens that would extend a suffix already seen in the context."""

    def __init__(self, multiplier: float, base: float, allowed: int, last_n: int,
                 breaker_ids: frozenset[int] = frozenset()):
        self.multiplier, self.base, self.allowed, self.last_n = multiplier, base, allowed, last_n
        self.breakers = breaker_ids

    def apply(self, state, logits):
        if self.multiplier <= 0:
            return logits
        prev = state.prev if self.last_n < 0 else state.prev[-self.last_n :]
        n = len(prev)
        if n < self.allowed + 1:
            return logits
        # z-algorithm style match: for each token id that follows a maximal
        # repeated suffix of length >= allowed, apply multiplier*base^(len-allowed)
        max_len: dict[int, int] = {}
        for i in range(n - 1):
            if prev[i] in self.breakers:
                continue
            # length of the longest common suffix of prev[:i+1] and prev[:n]
            l = 0
            while (
                l < i + 1
                and l < n
                and prev[i - l] == prev[n - 1 - l]
                and prev[i - l] not in self.breakers
            ):
                l += 1
            if l >= self.allowed and i + 1 < n:
                nxt = prev[i + 1]
                max_len[nxt] = max(max_len.get(nxt, 0), l)
        for tok, l in max_len.items():
            logits[tok] -= self.multiplier * (self.base ** (l - self.allowed))
        return logits

    def accept(self, state, token):
        pass


class TopK(Sampler):
    def __init__(self, k: int):
        self.k = k

    def apply(self, state, logits):
        k = self.k
        if k <= 0 or k >= len(logits):
            return logits
        kth = np.partition(logits, -k)[-k]
        logits[logits < kth] = -np.inf
        return logits


class TopP(Sampler):
    def __init__(self, p: float, min_keep: int = 1):
        self.p, self.min_keep = p, min_keep

    def apply(self, state, logits):
        if self.p >= 1.0:
            return logits
        order = np.argsort(-logits)
        probs = _softmax(logits[order])
        csum = np.cumsum(probs)
        cut = int(np.searchsorted(csum, self.p) + 1)
        cut = max(cut, self.min_keep)
        logits[order[cut:]] = -np.inf
        return logits


class MinP(Sampler):
    def __init__(self, p: float, min_keep: int = 1):
        self.p, self.min_keep = p, min_keep

    def apply(self, state, logits):
        if self.p <= 0:
            return logits
        mx = logits.max()
        # p_i >= p * p_max  <=>  logit_i >= logit_max + log(p)
        thresh = mx + np.log(self.p)
        mask = logits < thresh
        if (~mask).sum() < self.min_keep:
            keep = np.argsort(-logits)[: self.min_keep]
            mask[keep] = False
        logits[mask] = -np.inf
        return logits


class Typical(Sampler):
    def __init__(self, p: float, min_keep: int = 1):
        self.p, self.min_keep = p, min_keep

    def apply(self, state, logits):
        if self.p >= 1.0:
            return logits
        probs = _softmax(logits)
        ent = -np.sum(np.where(probs > 0, probs * np.log(np.maximum(probs, 1e-30)), 0.0))
        shifted = np.abs(-np.log(np.maximum(probs, 1e-30)) - ent)
        order = np.argsort(shifted)
        csum = np.cumsum(probs[order])
        cut = max(int(np.searchsorted(csum, self.p) + 1), self.min_keep)
        drop = order[cut:]
        logits[drop] = -np.inf
        return logits


class Temp(Sampler):
    def __init__(self, t: float):
        self.t = t

    def apply(self, state, logits):
        if self.t > 0:
            logits /= self.t
        return logits


class TempExt(Sampler):
    """Entropy-dynamic temperature (llama_sampler_init_temp_ext)."""

    def __init__(self, t: float, delta: float, exponent: float):
        self.t, self.delta, self.exponent = t, delta, exponent

    def apply(self, state, logits):
        if self.delta <= 0:
            if self.t > 0:
                logits /= self.t
            return logits
        tmin, tmax = max(0.0, self.t - self.delta), self.t + self.delta
        probs = _softmax(logits)
        nz = probs > 0
        ent = -np.sum(probs[nz] * np.log(probs[nz]))
        max_ent = np.log(nz.sum()) if nz.sum() > 1 else 1.0
        norm = ent / max(max_ent, 1e-9)
        dyn = tmin + (tmax - tmin) * (norm**self.exponent)
        logits /= max(dyn, 1e-9)
        return logits


class Xtc(Sampler):
    def __init__(self, probability: float, threshold: float, min_keep: int = 1):
        self.probability, self.threshold, self.min_keep = probability, threshold, min_keep

    def apply(self, state, logits):
        if self.probability <= 0 or self.threshold > 0.5:
            return logits
        if state.rng.random() >= self.probability:
            return logits
        probs = _softmax(logits)
        above = np.nonzero(probs >= self.threshold)[0]
        if len(above) >= 2:
            # remove all above-threshold tokens except the least probable one
            order = above[np.argsort(-probs[above])]
            logits[order[:-1]] = -np.inf
        return logits


class TopNSigma(Sampler):
    def __init__(self, n: float):
        self.n = n

    def apply(self, state, logits):
        if self.n < 0:
            return logits
        finite = logits[np.isfinite(logits)]
        mx, sd = finite.max(), finite.std()
        logits[logits < mx - self.n * sd] = -np.inf
        return logits


class MirostatV2(Sampler):
    def __init__(self, tau: float, eta: float, seed: int):
        self.tau, self.eta = tau, eta
        self._init = 2 * tau

    def apply(self, state, logits):
        if state.mu == 0.0:
            state.mu = self._init
        probs = _softmax(logits)
        surprise = -np.log2(np.maximum(probs, 1e-30))
        mask = surprise > state.mu
        if mask.all():
            mask[np.argmax(probs)] = False
        logits[mask] = -np.inf
        self._last_probs = _softmax(logits)
        return logits

    def accept(self, state, token):
        p = self._last_probs[token] if hasattr(self, "_last_probs") else 1.0
        observed = -np.log2(max(p, 1e-30))
        state.mu -= self.eta * (observed - self.tau)


class MirostatV1(Sampler):
    """Mirostat 1.0 (llama_sampler_init_mirostat, include/llama.h:1375;
    paper arXiv:2007.14966): estimate the Zipf exponent s_hat from the top-m
    probability ratios, derive a surprise-bounded k, truncate to top-k, and
    adapt mu toward the target surprise tau after each pick."""

    def __init__(self, tau: float, eta: float, m: int, n_vocab: int = 0):
        self.tau, self.eta, self.m = tau, eta, m
        self.n_vocab = n_vocab
        self._last_probs: np.ndarray | None = None

    def apply(self, state, logits):
        if state.mu == 0.0:
            state.mu = 2 * self.tau
        n_vocab = self.n_vocab or len(logits)
        probs = _softmax(logits)
        top = np.sort(probs)[::-1][: self.m]
        i = np.arange(len(top) - 1, dtype=np.float64)
        t_i = np.log((i + 2) / (i + 1))
        b_i = np.log(np.maximum(top[:-1], 1e-30) / np.maximum(top[1:], 1e-30))
        s_hat = float(np.sum(t_i * b_i) / max(np.sum(t_i * t_i), 1e-9))
        eps = s_hat - 1.0
        k = ((eps * 2.0 ** state.mu) / max(1.0 - n_vocab ** (-eps), 1e-9)) ** (
            1.0 / max(s_hat, 1e-9))
        k = max(int(k), 1)
        if k < len(logits):
            kth = np.partition(logits, -k)[-k]
            logits[logits < kth] = -np.inf
        self._last_probs = _softmax(logits)
        return logits

    def accept(self, state, token):
        if self._last_probs is None:
            return
        observed = -np.log2(max(float(self._last_probs[token]), 1e-30))
        state.mu -= self.eta * (observed - self.tau)

    def reset(self):
        self._last_probs = None


class AdaptiveP(Sampler):
    """Adaptive-p (llama_sampler_init_adaptive_p, include/llama.h:1465):
    favors tokens whose ORIGINAL probability sits near a target, tracked via
    an EMA of selected-token probabilities; terminal like mirostat/dist."""

    WIDTH = 0.3
    PEAK = 5.0
    SHARP = 10.0

    def __init__(self, target: float, decay: float):
        self.target = min(max(target, 0.0), 1.0)
        self.decay = decay
        self.reset()

    def reset(self):
        self.weighted_sum = self.target / (1.0 - self.decay)
        self.total_weight = 1.0 / (1.0 - self.decay)
        self._orig: np.ndarray | None = None

    def apply(self, state, logits):
        probs = _softmax(logits)
        self._orig = probs
        adapted = 2.0 * self.target - self.weighted_sum / self.total_weight
        adapted = min(max(adapted, 0.0), 1.0)
        dist = np.abs(probs - adapted) / self.WIDTH
        new = self.PEAK - self.SHARP * dist * dist / (1.0 + dist)
        # keep hard masks (-inf from earlier truncation samplers)
        return np.where(np.isneginf(logits), -np.inf, new)

    def accept(self, state, token):
        if self._orig is None:
            return
        self.weighted_sum = float(self._orig[token]) + self.decay * self.weighted_sum
        self.total_weight = 1.0 + self.decay * self.total_weight
        self._orig = None


class Infill(Sampler):
    """Fill-in-the-middle sampler (llama_sampler_init_infill,
    include/llama.h:1475): prefer EOG when text mass is weak, merge tokens
    sharing a textual prefix into the stronger candidate, drop weak non-EOG
    tokens, and fall back to EOT when nothing textual survives."""

    THOLD = 0.2

    def __init__(self, vocab, piece_fn=None):
        self.vocab = vocab
        self.piece = piece_fn or (lambda t: vocab.text_of(t))
        self._eog_mask: np.ndarray | None = None

    def _eog(self, n):
        if self._eog_mask is None or len(self._eog_mask) != n:
            m = np.zeros(n, bool)
            for t in range(n):
                if self.vocab.is_eog(t):
                    m[t] = True
            self._eog_mask = m
        return self._eog_mask

    def apply(self, state, logits):
        probs = _softmax(logits)
        n = len(probs)
        eog = self._eog(n)
        live = np.isfinite(logits)
        p_eog = float(probs[eog & live].sum())
        p_txt = float(probs[~eog & live].sum())
        n_cand = int(live.sum())
        if 3 * p_eog * n_cand > p_txt:
            # text mass too weak relative to EOG -> keep only EOG tokens
            out = np.full_like(logits, -np.inf)
            out[eog & live] = np.log(np.maximum(probs[eog & live], 1e-30))
            return out
        # combine candidates sharing a textual prefix (merge into stronger)
        cand = np.nonzero(live & (probs > 1e-8))[0]
        cand = cand[np.argsort(-probs[cand])][:64]  # top candidates only
        pieces = {int(t): self.piece(int(t)) for t in cand}
        p = probs.copy()
        alive = {int(t) for t in cand}
        for t0 in cand:
            t0 = int(t0)
            if t0 not in alive:
                continue
            s0 = pieces[t0]
            if not s0:
                continue
            for t1 in cand:
                t1 = int(t1)
                if t1 == t0 or t1 not in alive or t0 not in alive:
                    continue
                s1 = pieces[t1]
                if len(s0) <= len(s1) and s1.startswith(s0):
                    dst, src = (t0, t1) if p[t0] >= p[t1] else (t1, t0)
                    p[dst] += p[src]
                    p[src] = 0.0
                    alive.discard(src)
        # drop weak non-EOG candidates
        keep = np.zeros(n, bool)
        for t in alive:
            if p[t] >= self.THOLD or eog[t]:
                keep[t] = True
        keep |= eog & live & (p > 0)
        if not (keep & ~eog).any():
            # no textual candidate survives -> force EOT (or EOS)
            t = self.vocab.eot_id if self.vocab.eot_id >= 0 else self.vocab.eos_id
            out = np.full_like(logits, -np.inf)
            out[t] = 1.0
            return out
        out = np.full_like(logits, -np.inf)
        out[keep] = np.log(np.maximum(p[keep], 1e-30))
        return out


class ReasoningBudget(Sampler):
    """Token budget for reasoning blocks (reference
    common/reasoning-budget.{h,cpp}): IDLE → COUNTING once a start sequence
    (e.g. <think>) is generated; after `budget` tokens, wait for any pending
    UTF-8 multibyte sequence to close, then FORCE the forced token sequence
    (the closing </think>) by masking all other logits; DONE passes through
    and re-arms if a new start sequence appears."""

    IDLE, COUNTING, WAITING_UTF8, FORCING, DONE = range(5)

    def __init__(self, start_seqs, end_seqs, forced_tokens, budget,
                 piece_bytes=None, initial_state=None):
        self.start_seqs = [list(s) for s in start_seqs if s]
        self.end_seqs = [list(s) for s in end_seqs if s]
        self.forced = list(forced_tokens)
        self.budget = int(budget)
        self.piece_bytes = piece_bytes  # token -> bytes, for UTF-8 boundary
        self.state_ = self.IDLE if initial_state is None else initial_state
        self.remaining = self.budget
        self.force_idx = 0
        self.end_match: list[int] | None = None
        self._recent: list[int] = []
        self._pending_utf8 = 0
        max_seq = max(
            [len(s) for s in self.start_seqs + self.end_seqs] or [1]
        )
        self._keep = max_seq

    def _ends_with_any(self, seqs):
        for s in seqs:
            if len(self._recent) >= len(s) and self._recent[-len(s):] == s:
                return s
        return None

    def _track_utf8(self, token: int):
        if self.piece_bytes is None:
            return
        try:
            b = self.piece_bytes(token)
        except Exception:
            return
        for byte in b:
            if self._pending_utf8 > 0:
                if 0x80 <= byte < 0xC0:
                    self._pending_utf8 -= 1
                else:
                    self._pending_utf8 = 0  # malformed; don't stall
            if self._pending_utf8 == 0:
                if byte >= 0xF0:
                    self._pending_utf8 = 3
                elif byte >= 0xE0:
                    self._pending_utf8 = 2
                elif byte >= 0xC0:
                    self._pending_utf8 = 1

    def apply(self, state, logits):
        if self.state_ == self.FORCING and self.force_idx < len(self.forced):
            out = np.full_like(logits, -np.inf)
            out[self.forced[self.force_idx]] = 0.0
            return out
        return logits

    def accept(self, state, token):
        self._recent.append(int(token))
        if len(self._recent) > self._keep:
            del self._recent[: -self._keep]
        st = self.state_
        if st == self.FORCING:
            # only our forced token can have been sampled
            self.force_idx += 1
            if self.force_idx >= len(self.forced):
                self.state_ = self.DONE
            return
        if st in (self.IDLE, self.DONE):
            if self._ends_with_any(self.start_seqs):
                self.state_ = self.COUNTING
                self.remaining = self.budget
                self.end_match = None
            return
        if st == self.COUNTING:
            self._track_utf8(int(token))
            hit = self._ends_with_any(self.end_seqs)
            if hit is not None:
                self.state_ = self.DONE
                self.end_match = hit
                return
            self.remaining -= 1
            if self.remaining <= 0:
                if self._pending_utf8 > 0:
                    self.state_ = self.WAITING_UTF8
                else:
                    self.state_ = self.FORCING
                    self.force_idx = 0
            return
        if st == self.WAITING_UTF8:
            self._track_utf8(int(token))
            if self._pending_utf8 == 0:
                self.state_ = self.FORCING
                self.force_idx = 0

    def reset(self):
        self.state_ = self.IDLE
        self.remaining = self.budget
        self.force_idx = 0
        self.end_match = None
        self._recent.clear()
        self._pending_utf8 = 0


def make_reasoning_budget(vocab, tokenize, budget: int,
                          start: str = "<think>", end: str = "</think>"):
    """Build a ReasoningBudget from text markers: tokenizes the start/end
    sequences with the model tokenizer (special parsing on) and forces the
    end marker when the budget expires."""
    start_ids = tokenize(start)
    end_ids = tokenize(end)
    forced = tokenize("\n" + end)
    piece_bytes = None
    if vocab is not None and hasattr(vocab, "text_of"):
        piece_bytes = lambda t: vocab.text_of(t).encode("utf-8", "ignore")
    return ReasoningBudget([start_ids], [end_ids], forced, budget,
                           piece_bytes=piece_bytes)


class SamplerChain:
    """llama_sampler_chain analog: ordered samplers + final pick."""

    def __init__(self, samplers: Sequence[Sampler], params: SamplingParams):
        self.samplers = list(samplers)
        self.params = params
        self.state = SamplerState(
            rng=np.random.default_rng(
                params.seed if params.seed != 0xFFFFFFFF else None
            )
        )
        self.n_sampled = 0

    @classmethod
    def from_params(cls, p: SamplingParams, vocab=None) -> "SamplerChain":
        """Default chain order mirrors common/sampling.cpp."""
        chain: list[Sampler] = []
        if p.logit_bias:
            chain.append(LogitBias(p.logit_bias))
        chain.append(Penalties(p.penalty_last_n, p.penalty_repeat, p.penalty_freq, p.penalty_present))
        if p.dry_multiplier > 0:
            breaker_ids = frozenset()
            if vocab is not None:
                ids = set()
                for s in p.dry_sequence_breakers:
                    tid = vocab.token_to_id.get(s)
                    if tid is not None:
                        ids.add(tid)
                breaker_ids = frozenset(ids)
            chain.append(Dry(p.dry_multiplier, p.dry_base, p.dry_allowed_length,
                             p.dry_penalty_last_n, breaker_ids))
        if p.mirostat == 2:
            chain.append(Temp(p.temp))
            chain.append(MirostatV2(p.mirostat_tau, p.mirostat_eta, p.seed))
            return cls(chain, p)
        if p.mirostat == 1:
            chain.append(Temp(p.temp))
            chain.append(MirostatV1(p.mirostat_tau, p.mirostat_eta,
                                    p.mirostat_m))
            return cls(chain, p)
        if p.is_greedy:
            return cls(chain, p)
        if p.top_n_sigma >= 0:
            chain.append(TopNSigma(p.top_n_sigma))
        chain.append(TopK(p.top_k))
        chain.append(Typical(p.typical_p))
        chain.append(TopP(p.top_p))
        chain.append(MinP(p.min_p))
        if p.infill and vocab is not None:
            chain.append(Infill(vocab))
        chain.append(Xtc(p.xtc_probability, p.xtc_threshold))
        if p.dynatemp_range > 0:
            chain.append(TempExt(p.temp, p.dynatemp_range, p.dynatemp_exponent))
        else:
            chain.append(Temp(p.temp))
        if p.adaptive_target >= 0:
            # terminal transform (must precede only the final dist pick)
            chain.append(AdaptiveP(p.adaptive_target, p.adaptive_decay))
        return cls(chain, p)

    def sample(self, logits: np.ndarray) -> int:
        logits = np.asarray(logits, dtype=np.float32).copy()
        for s in self.samplers:
            logits = s.apply(self.state, logits)
        if self.params.is_greedy:
            token = int(np.argmax(logits))
        else:
            probs = _softmax(logits)
            token = int(self.state.rng.choice(len(probs), p=probs))
        self.accept(token)
        return token

    def accept(self, token: int) -> None:
        self.state.prev.append(token)
        if len(self.state.prev) > 4096:
            del self.state.prev[:-2048]
        for s in self.samplers:
            s.accept(self.state, token)
        self.n_sampled += 1

    def reset(self) -> None:
        self.state.prev.clear()
        self.state.mu = 0.0
        for s in self.samplers:
            s.reset()
