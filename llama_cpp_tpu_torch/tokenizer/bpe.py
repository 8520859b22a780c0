"""Byte-level BPE tokenizer (GPT-2 family) with per-model pretokenizer regexes.

Parity targets: reference llm_tokenizer_bpe (src/llama-vocab.cpp:279-450).
The C++ build adapts the original tokenizer.json regexes for std::wregex; since
Python's `regex` module supports \\p{..} and (?i:..) natively we use the
original upstream patterns (the commented-out "original regex from
tokenizer.json" lines in the reference).
"""

from __future__ import annotations

import functools

from .vocab import Vocab

_LLAMA3 = r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
_GPT2 = r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
_QWEN2 = r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
_STARCODER = [r"\p{N}", r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"]
_GPT4O = r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]*[\p{Ll}\p{Lm}\p{Lo}\p{M}]+(?i:'s|'t|'re|'ve|'m|'ll|'d)?|[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]+[\p{Ll}\p{Lm}\p{Lo}\p{M}]*(?i:'s|'t|'re|'ve|'m|'ll|'d)?|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n/]*|\s*[\r\n]+|\s+(?!\S)|\s+"
_TEKKEN = r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]*[\p{Ll}\p{Lm}\p{Lo}\p{M}]+|[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]+[\p{Ll}\p{Lm}\p{Lo}\p{M}]*|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n/]*|\s*[\r\n]+|\s+(?!\S)|\s+"

# tokenizer.ggml.pre -> list of split regexes (applied in sequence)
PRE_REGEXES: dict[str, list[str]] = {
    "default": [_GPT2],
    "gpt-2": [_GPT2],
    "mpt": [_GPT2],
    "olmo": [_GPT2],
    "jais": [_GPT2],
    "phi-2": [_GPT2],
    "llama3": [_LLAMA3],
    "llama-v3": [_LLAMA3],
    "llama-bpe": [_LLAMA3],
    "dbrx": [_LLAMA3],
    "smaug-bpe": [_LLAMA3],
    "chatglm-bpe": [_LLAMA3],
    "falcon3": [_LLAMA3],
    "falcon-h1": [_LLAMA3],
    "pixtral": [_LLAMA3],
    "midm-2.0": [_LLAMA3],
    "llada": [_LLAMA3],
    "qwen2": [_QWEN2],
    "stablelm2": [_QWEN2],
    "hunyuan": [_QWEN2],
    "glm4": [_LLAMA3],
    "granite": [_GPT2],
    "starcoder": _STARCODER,
    "refact": _STARCODER,
    "command-r": _STARCODER,
    "smollm": _STARCODER,
    "codeshell": _STARCODER,
    "exaone": _STARCODER,
    "minerva-7b": _STARCODER,
    "falcon": [
        r"[\p{P}\$\+<=>\^~\|`]+",
        r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+",
        r"[0-9][0-9][0-9]",
    ],
    "deepseek-llm": [
        "[\r\n]",
        "\\s?[A-Za-z\xb5\xc0-\xd6\xd8-\xf6\xf8-\u01ba\u01bc-\u01bf\u01c4-\u0293\u0295-\u02af\u0370-\u0373\u0376\u0377\u037b-\u037d\u037f\u0386\u0388-\u038a\u038c\u038e-\u03a1\u03a3-\u03f5\u03f7-\u0481\u048a-\u052f\u0531-\u0556\u10a0-\u10c5\u13a0-\u13f5\u13f8-\u13fd\u1c90-\u1cba\u1cbd-\u1cbf\u1d00-\u1d2b\u1d6b-\u1d77\u1d79-\u1d9a\u1e00-\u1f15\u1f18-\u1f1d\u1f20-\u1f45\u1f48-\u1f4d\u1f50-\u1f57\u1f59\u1f5b\u1f5d\u1f5f-\u1f7d\u1f80-\u1fb4\u1fb6-\u1fbc\u1fbe\u1fc2-\u1fc4\u1fc6-\u1fcc\u1fd0-\u1fd3\u1fd6-\u1fdb\u1fe0-\u1fec\u1ff2-\u1ff4\u1ff6-\u1ffc\u2102\u2107\u210a-\u2113\u2115\u2119-\u211d\u2124\u2126\u2128\u212a-\u212d\u212f-\u2134\u2139\u213c-\u213f\u2145-\u2149\u214e\u2183\u2184\u2c00-\u2c7b\u2c7e-\u2ce4\u2ceb-\u2cee\u2cf2\u2cf3\ua640-\ua66d\ua680-\ua69b\ua722-\ua76f\ua771-\ua787\ua78b-\ua78e\uab70-\uabbf\ufb00-\ufb06\ufb13-\ufb17\uff21-\uff3a\uff41-\uff5a\U00010400-\U0001044f\U000104b0-\U000104d3\U000104d8-\U000104fb\U00010c80-\U00010cb2\U00010cc0-\U00010cf2\U000118a0-\U000118df\U0001e900-\U0001e943]+",
        "\\s?[!-/:-~\uff01-\uff0f\uff1a-\uff5e\u2018-\u201f\u3000-\u3002]+",
        r"\s+$",
        "[\u4e00-\u9fa5\u0800-\u4e00\uac00-\ud7ff]+",
        r"\p{N}+",
    ],
    "deepseek-coder": [
        r"[\r\n]",
        r"\s?\p{L}+",
        r"\s?\p{P}+",
        r"[一-龥ࠀ-一가-퟿]+",
        r"\p{N}",
    ],
    "deepseek-v3": [
        r"\p{N}{1,3}",
        r"[一-龥぀-ゟ゠-ヿ]+",
        r"[!\"#$%&'()*+,\-./:;<=>?@\[\\\]^_`{|}~][A-Za-z]+|[^\r\n\p{L}\p{P}\p{S}]?[\p{L}\p{M}]+| ?[\p{P}\p{S}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+",
    ],
    "poro-chat": [r" ?[^(\s|.,!?…。，、।۔،)]+"],
    "bloom": [r" ?[^(\s|.,!?…。，、।۔،)]+"],
    "gpt3-finnish": [r" ?[^(\s|.,!?…。，、।۔،)]+"],
    "viking": [r" ?[^(\s|.,!?…。，、।۔،)]+", r"\p{N}"],
    "tekken": [_TEKKEN],
    "gpt-4o": [_GPT4O],
    "minimax-m2": [_GPT4O],
    "kimi-k2": [_GPT4O],
    "seed-coder": [_GPT2],
    "chameleon": [
        r"<sentinel:[0-9]+>",
        r"(IMGIMG)((A|B|C|D|E|F|G|H|I){1,4})Z",
        r"([\t\n]|    |  )",
        r"\p{N}",
        r"[\p{P}!-/:-@\[-`{-~]",
        r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+",
    ],
}


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2 byte <-> printable-unicode bijection."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


@functools.lru_cache(maxsize=1)
def unicode_to_bytes() -> dict[str, int]:
    return {v: k for k, v in bytes_to_unicode().items()}


def _compile_pretokenizer(patterns: list[str]) -> list:
    """The pre-tokenizer patterns use \\p{..} classes, which need the
    third-party `regex` module; it is imported here so that the package and
    the SPM path need only the standard library."""
    try:
        import regex
    except ImportError as e:
        raise ImportError("a BPE vocab needs the third-party `regex` module for its "
                          "pre-tokenizer patterns (\\p{..} classes); it is not installed") from e
    return [regex.compile(p) for p in patterns]


class BPETokenizer:
    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        pats = PRE_REGEXES.get(vocab.pre, PRE_REGEXES["default"])
        self._regexes = _compile_pretokenizer(pats)
        self._ranks: dict[tuple[str, str], int] = {}
        for rank, merge in enumerate(vocab.merges):
            # merges stored as "left right" (space-separated byte-unicode strings)
            parts = merge.split(" ")
            if len(parts) == 2:
                self._ranks[(parts[0], parts[1])] = rank
        self._b2u = bytes_to_unicode()
        self._u2b = unicode_to_bytes()

    def _split(self, text: str) -> list[str]:
        """Apply the regex cascade: every piece (matched or not) is further
        split by each subsequent regex (reference unicode_regex_split
        semantics, src/unicode.cpp)."""
        pieces = [text]
        for rx in self._regexes:
            out = []
            for frag in pieces:
                pos = 0
                for m in rx.finditer(frag):
                    if m.start() > pos:
                        out.append(frag[pos : m.start()])
                    if m.group():
                        out.append(m.group())
                    pos = m.end()
                if pos < len(frag):
                    out.append(frag[pos:])
            pieces = out
        return [p for p in pieces if p]

    @functools.lru_cache(maxsize=65536)
    def _bpe_word(self, word: str) -> tuple[str, ...]:
        parts = list(word)
        if not self._ranks:
            return tuple(parts)
        while len(parts) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(parts) - 1):
                r = self._ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank = r
                    best_i = i
            if best_rank is None:
                break
            parts[best_i : best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        return tuple(parts)

    def encode_fragment(self, text: str) -> list[int]:
        v = self.vocab
        out: list[int] = []
        for piece in self._split(text):
            word = "".join(self._b2u[b] for b in piece.encode("utf-8"))
            for sub in self._bpe_word(word):
                tid = v.token_to_id.get(sub)
                if tid is not None:
                    out.append(tid)
                else:
                    for ch in sub:
                        tid = v.token_to_id.get(ch)
                        if tid is not None:
                            out.append(tid)
                        elif v.unk_id >= 0:
                            out.append(v.unk_id)
        return out

    def decode_piece(self, token_id: int) -> bytes:
        v = self.vocab
        if not 0 <= token_id < len(v.tokens):  # out-of-range id: no piece
            return b""
        t = v.tokens[token_id]
        # USER_DEFINED / CONTROL tokens are stored as raw text, not byte-level
        if v.token_types is not None:
            tt = int(v.token_types[token_id])
            if tt in (3, 4):  # CONTROL, USER_DEFINED
                return t.encode("utf-8")
        u2b = self._u2b
        try:
            return bytes(u2b[ch] for ch in t)
        except KeyError:
            return t.encode("utf-8")
