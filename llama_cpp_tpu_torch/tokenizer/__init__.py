"""Tokenizer front-end: special-token handling + family dispatch.

API parity with reference llama_tokenize / llama_detokenize
(include/llama.h tokenization section; impl src/llama-vocab.cpp).
"""

from __future__ import annotations

import unicodedata
from typing import Any

from .bpe import BPETokenizer
from .spm import SPMTokenizer
from .vocab import Vocab


def _is_chinese_char(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B920 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


class WPMTokenizer:
    """WordPiece (BERT): NFD strip-accents + lowercase, punctuation/CJK chars
    isolated, then greedy longest-match over "▁word" strings; a word with any
    unmatched tail becomes UNK (reference WordPiece tokenizer,
    src/llama-vocab.cpp:768-815)."""

    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        self._max_len = max((len(t) for t in vocab.tokens), default=1)

    def _preprocess(self, text: str) -> list[str]:
        words: list[str] = [""]
        for ch in unicodedata.normalize("NFD", text):
            cat = unicodedata.category(ch)
            if ch.isspace():
                if words[-1]:
                    words.append("")
                continue
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or cat.startswith("C"):
                continue
            if cat == "Mn":  # strip accents
                continue
            s = ch.lower()
            if cat.startswith("P") or (cp < 0x7F and cat.startswith("S")) or _is_chinese_char(cp):
                if words[-1]:
                    words.append("")
                words[-1] = s
                words.append("")
            else:
                words[-1] += s
        if words and not words[-1]:
            words.pop()
        return words

    def encode_fragment(self, text: str) -> list[int]:
        v = self.vocab
        out: list[int] = []
        for word in self._preprocess(text):
            if not word:
                continue
            word1 = "▁" + word
            n = len(word1)
            ids: list[int] = []
            i = 0
            ok = True
            while i < n:
                match = False
                for j in range(min(n, i + self._max_len), i, -1):
                    tid = v.token_to_id.get(word1[i:j])
                    if tid is not None:
                        ids.append(tid)
                        i = j
                        match = True
                        break
                if not match:
                    ok = False
                    break
            if ok and ids:
                out.extend(ids)
            elif v.unk_id >= 0:
                out.append(v.unk_id)
        return out

    def decode_piece(self, token_id: int) -> bytes:
        return self.vocab.tokens[token_id].replace("▁", " ").encode()


class UGMTokenizer:
    """Unigram (T5): Viterbi max-score segmentation over the score table
    (reference llm_tokenizer_ugm, src/llama-vocab.cpp:887)."""

    UNKNOWN_PENALTY = 10.0

    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        self._max_len = max((len(t) for t in vocab.tokens), default=1)
        sc = vocab.scores
        self._min_score = float(sc.min()) if sc is not None and len(sc) else 0.0

    def encode_fragment(self, text: str) -> list[int]:
        v = self.vocab
        text = text.replace(" ", "▁")
        if v.add_space_prefix and text and not text.startswith("▁"):
            text = "▁" + text
        n = len(text)
        NEG = -1e30
        best = [NEG] * (n + 1)
        back: list[tuple[int, int]] = [(-1, -1)] * (n + 1)
        best[0] = 0.0
        unk_score = self._min_score - self.UNKNOWN_PENALTY
        for i in range(n):
            if best[i] <= NEG / 2:
                continue
            for j in range(i + 1, min(n, i + self._max_len) + 1):
                tid = v.token_to_id.get(text[i:j])
                if tid is not None and v.scores is not None:
                    s = best[i] + float(v.scores[tid])
                    if s > best[j]:
                        best[j] = s
                        back[j] = (i, tid)
            # unknown single char
            s = best[i] + unk_score
            if s > best[i + 1]:
                best[i + 1] = s
                back[i + 1] = (i, v.unk_id)
        ids: list[int] = []
        i = n
        while i > 0:
            prev, tid = back[i]
            if prev < 0:
                break
            if tid >= 0:
                ids.append(tid)
            i = prev
        ids.reverse()
        # merge adjacent unknowns like the reference does
        out: list[int] = []
        for t in ids:
            if out and t == v.unk_id and out[-1] == v.unk_id:
                continue
            out.append(t)
        return out

    def decode_piece(self, token_id: int) -> bytes:
        return self.vocab.tokens[token_id].replace("▁", " ").encode()


class RWKVTokenizer:
    """Greedy longest-match over raw bytes (reference llm_tokenizer_rwkv,
    src/llama-vocab.cpp:1296)."""

    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        self._by_bytes = {}
        for i, t in enumerate(vocab.tokens):
            self._by_bytes[t.encode("utf-8", errors="replace")] = i
        self._max_len = max((len(b) for b in self._by_bytes), default=1)

    def encode_fragment(self, text: str) -> list[int]:
        data = text.encode("utf-8")
        out: list[int] = []
        i = 0
        while i < len(data):
            for j in range(min(len(data), i + self._max_len), i, -1):
                tid = self._by_bytes.get(data[i:j])
                if tid is not None:
                    out.append(tid)
                    i = j
                    break
            else:
                i += 1  # skip unencodable byte
        return out

    def decode_piece(self, token_id: int) -> bytes:
        return self.vocab.tokens[token_id].encode("utf-8", errors="replace")


class PLaMo2Tokenizer:
    """PLaMo-2 tokenizer (reference llm_tokenizer_plamo2, src/llama-vocab
    .cpp:1351): Viterbi over vocabulary pieces maximizing the summed unigram
    scores (scaled to int, matching the reference's 1e4 fixed point), with a
    heavily-penalized per-character unknown fallback that emits UTF-8 byte
    tokens. The reference enumerates candidate pieces through an
    Aho-Corasick-style reversed-suffix table; the piece set and the DP
    recurrence here are identical, so tokenizations match."""

    UNKNOWN = -10000000  # sentinel score of the unknown-char fallback row

    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        self.pieces: dict[str, tuple[int, int]] = {}
        self.bytes_ = [0] * 256
        max_len = 1
        tt = vocab.token_types
        for i, t in enumerate(vocab.tokens):
            if tt is not None and int(tt[i]) == 6:  # BYTE
                if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
                    try:
                        self.bytes_[int(t[3:5], 16)] = i
                    except ValueError:
                        pass
                continue
            score = float(vocab.scores[i]) if vocab.scores is not None else 0.0
            self.pieces[t] = (i, int(round(score * 1e4)))
            max_len = max(max_len, len(t))
        self._max_len = max_len

    def encode_fragment(self, text: str) -> list[int]:
        if text and text[0] == "﻿":  # BOM skip
            text = text[1:]
        n = len(text)
        if n == 0:
            return []
        INF = 1 << 60
        scores = [INF] * (n + 1)
        scores[n] = 0
        back: list[tuple[int, int]] = [(1, -1)] * (n + 1)
        for i in range(n - 1, -1, -1):
            # candidate pieces by decreasing length, unknown fallback last —
            # same visit order (and thus tie-breaking) as the reference table
            m = min(self._max_len, n - i)
            for L in range(m, 0, -1):
                ent = self.pieces.get(text[i : i + L])
                if ent is None:
                    continue
                s = scores[i + L] - ent[1]
                if s < scores[i]:
                    scores[i] = s
                    back[i] = (L, ent[0])
            s = scores[i + 1] - self.UNKNOWN
            if s < scores[i]:
                scores[i] = s
                back[i] = (1, -1)
        out: list[int] = []
        pos = 0
        while pos < n:
            length, tid = back[pos]
            if tid >= 0:
                out.append(tid)
            else:  # byte fallback over the char's UTF-8 encoding
                for b in text[pos].encode("utf-8"):
                    out.append(self.bytes_[b])
            pos += length
        return out

    def decode_piece(self, token_id: int) -> bytes:
        t = self.vocab.tokens[token_id]
        tt = self.vocab.token_types
        if (tt is not None and int(tt[token_id]) == 6
                and len(t) == 6 and t.startswith("<0x")):
            try:
                return bytes([int(t[3:5], 16)])
            except ValueError:
                pass
        return t.encode("utf-8", errors="replace")


_FAMILIES = {
    "llama": SPMTokenizer,
    "gpt2": BPETokenizer,
    "bert": WPMTokenizer,
    "t5": UGMTokenizer,
    "rwkv": RWKVTokenizer,
    "plamo2": PLaMo2Tokenizer,
}


class Tokenizer:
    """llama_tokenize-equivalent front-end over the family tokenizers."""

    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        fam = _FAMILIES.get(vocab.model)
        if fam is None:
            raise ValueError(f"unsupported tokenizer model {vocab.model!r}")
        self.inner = fam(vocab)

    @classmethod
    def from_gguf(cls, metadata: dict[str, Any]) -> "Tokenizer":
        return cls(Vocab.from_gguf(metadata))

    def encode(
        self, text: str, add_special: bool = True, parse_special: bool = True
    ) -> list[int]:
        v = self.vocab
        out: list[int] = []
        # SPM: a fragment gets a phantom leading space when it is the first
        # fragment or directly follows a special token (llama-vocab.cpp:3350)
        is_prev_special = True
        for frag, sid in v.partition_specials(text, parse_special):
            if sid is not None:
                out.append(sid)
                is_prev_special = True
                continue
            if not frag:
                continue
            if v.model == "llama" and v.add_space_prefix and is_prev_special:
                frag = " " + frag
            out.extend(self.inner.encode_fragment(frag))
            is_prev_special = False
        if add_special and v.add_bos and v.bos_id >= 0:
            if not out or out[0] != v.bos_id:
                out.insert(0, v.bos_id)
        if add_special and v.add_sep and v.sep_id >= 0:
            out.append(v.sep_id)
        elif add_special and v.add_eos and v.eos_id >= 0:
            out.append(v.eos_id)
        return out

    def decode(self, ids: list[int], skip_special: bool = False) -> str:
        v = self.vocab
        parts: list[bytes] = []
        for i, tid in enumerate(ids):
            if tid < 0 or tid >= v.n_tokens:
                continue
            if skip_special and v.is_control(tid):
                continue
            piece = self.inner.decode_piece(tid)
            # SPM drops the leading space of the very first piece
            if i == 0 and v.model == "llama" and v.add_space_prefix and piece.startswith(b" "):
                piece = piece[1:]
            parts.append(piece)
        return b"".join(parts).decode("utf-8", errors="replace")

    def piece(self, token_id: int) -> str:
        return self.inner.decode_piece(token_id).decode("utf-8", errors="replace")

    @property
    def bos_id(self):
        return self.vocab.bos_id

    @property
    def eos_id(self):
        return self.vocab.eos_id

    def is_eog(self, tid: int) -> bool:
        return self.vocab.is_eog(tid)
