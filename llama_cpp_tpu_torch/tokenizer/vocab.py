"""Vocabulary model + special-token partitioning.

Capability parity with reference src/llama-vocab.cpp: 6 tokenizer families
selected by `tokenizer.ggml.model` (SPM "llama", BPE "gpt2", WPM "bert",
UGM "t5", RWKV "rwkv", PLaMo-2), special-token partitioning
(tokenizer_st_partition, llama-vocab.cpp:416), byte fallback, and the
add_bos/add_eos/add_space_prefix attribute plumbing.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterable

import numpy as np

from ..gguf.constants import Keys, TokenType


@dataclass
class Vocab:
    model: str  # "llama" | "gpt2" | "bert" | "t5" | "rwkv" | "no_vocab" | "none"
    pre: str = "default"
    tokens: list[str] = field(default_factory=list)
    scores: np.ndarray | None = None
    token_types: np.ndarray | None = None
    merges: list[str] = field(default_factory=list)

    bos_id: int = -1
    eos_id: int = -1
    eot_id: int = -1
    eom_id: int = -1
    unk_id: int = -1
    sep_id: int = -1
    pad_id: int = -1
    mask_id: int = -1

    add_bos: bool = True
    add_eos: bool = False
    add_sep: bool = False
    add_space_prefix: bool = True
    remove_extra_whitespaces: bool = False

    chat_template: str | None = None

    # derived
    token_to_id: dict[str, int] = field(default_factory=dict)
    _special: list[tuple[str, int]] = field(default_factory=list)
    _byte_tokens: dict[int, int] = field(default_factory=dict)
    _eog: set[int] = field(default_factory=set)

    # ------------------------------------------------------------------
    @classmethod
    def from_gguf(cls, md: dict[str, Any]) -> "Vocab":
        K = Keys.Tokenizer

        def _get(key, default=None):
            v = md.get(key, default)
            if isinstance(v, np.generic):
                v = v.item()
            return v

        tokens_raw = md.get(K.TOKENS, [])
        tokens = [t if isinstance(t, str) else str(t) for t in tokens_raw]
        model = _get(K.MODEL, "llama")
        v = cls(
            model=model,
            pre=_get(K.PRE, "default"),
            tokens=tokens,
            scores=np.asarray(md[K.SCORES], dtype=np.float32) if K.SCORES in md else None,
            token_types=np.asarray(md[K.TOKEN_TYPE], dtype=np.int32)
            if K.TOKEN_TYPE in md
            else None,
            merges=list(md.get(K.MERGES, [])),
            bos_id=int(_get(K.BOS_ID, 1 if model == "llama" else -1)),
            eos_id=int(_get(K.EOS_ID, 2 if model == "llama" else -1)),
            eot_id=int(_get(K.EOT_ID, -1)),
            eom_id=int(_get(K.EOM_ID, -1)),
            unk_id=int(_get(K.UNK_ID, 0 if model == "llama" else -1)),
            sep_id=int(_get(K.SEP_ID, -1)),
            pad_id=int(_get(K.PAD_ID, -1)),
            mask_id=int(_get(K.MASK_ID, -1)),
            add_bos=bool(_get(K.ADD_BOS, model == "llama")),
            add_eos=bool(_get(K.ADD_EOS, False)),
            add_sep=bool(_get(K.ADD_SEP, False)),
            add_space_prefix=bool(_get(K.ADD_SPACE_PREFIX, model == "llama")),
            remove_extra_whitespaces=bool(_get(K.REMOVE_EXTRA_WS, False)),
            chat_template=_get(K.CHAT_TEMPLATE),
        )
        v.finalize()
        return v

    def finalize(self):
        self.token_to_id = {t: i for i, t in enumerate(self.tokens)}
        tt = self.token_types
        self._special = []
        self._byte_tokens = {}
        self._eog = set()
        for i, tok in enumerate(self.tokens):
            t = int(tt[i]) if tt is not None else TokenType.NORMAL
            if t in (TokenType.CONTROL, TokenType.USER_DEFINED):
                self._special.append((tok, i))
            if t == TokenType.BYTE:
                # "<0xAB>" style byte fallback tokens
                if len(tok) == 6 and tok.startswith("<0x") and tok.endswith(">"):
                    self._byte_tokens[int(tok[3:5], 16)] = i
        # longest-first so overlapping specials match greedily
        self._special.sort(key=lambda p: -len(p[0]))
        for tid in (self.eos_id, self.eot_id, self.eom_id):
            if tid >= 0:
                self._eog.add(tid)
        for i, tok in enumerate(self.tokens):
            if tok in ("<|eot_id|>", "<|im_end|>", "<|end|>", "<end_of_turn>",
                       "<|endoftext|>", "<EOT>", "<|end_of_text|>", "</s>",
                       "<|return|>", "<|call|>"):
                t = int(tt[i]) if tt is not None else TokenType.NORMAL
                if t == TokenType.CONTROL:
                    self._eog.add(i)

    # ------------------------------------------------------------------
    @property
    def n_tokens(self) -> int:
        return len(self.tokens)

    def is_eog(self, token_id: int) -> bool:
        return token_id in self._eog

    def is_control(self, token_id: int) -> bool:
        if self.token_types is None:
            return False
        return int(self.token_types[token_id]) == TokenType.CONTROL

    def byte_token(self, b: int) -> int:
        if b in self._byte_tokens:
            return self._byte_tokens[b]
        # gpt2-style fallback: find the single-char token
        ch = chr(b)
        if ch in self.token_to_id:
            return self.token_to_id[ch]
        return self.unk_id

    def text_of(self, token_id: int) -> str:
        return self.tokens[token_id]

    # ------------------------------------------------------------------
    def partition_specials(self, text: str, parse_special: bool) -> Iterable[tuple[str, int | None]]:
        """Split text into (fragment, None) and ("", token_id) pieces.

        Mirrors tokenizer_st_partition (src/llama-vocab.cpp:3165): special
        tokens match greedily, longest first, on the raw text before the inner
        tokenizer runs. USER_DEFINED tokens always partition; CONTROL tokens
        only when parse_special.
        """
        if not self._special:
            if text:
                yield (text, None)
            return
        tt = self.token_types
        frags: list[tuple[str, int | None]] = [(text, None)]
        for stext, sid in self._special:
            if not stext:
                continue
            if not parse_special and (
                tt is None or int(tt[sid]) != TokenType.USER_DEFINED
            ):
                continue
            out: list[tuple[str, int | None]] = []
            for frag, fid in frags:
                if fid is not None or not frag:
                    out.append((frag, fid))
                    continue
                start = 0
                while True:
                    pos = frag.find(stext, start)
                    if pos < 0:
                        if start < len(frag):
                            out.append((frag[start:], None))
                        break
                    if pos > start:
                        out.append((frag[start:pos], None))
                    out.append(("", sid))
                    start = pos + len(stext)
            frags = out
        yield from frags
