"""GBNF grammar-constrained sampling: parser + pushdown automaton over UTF-8.

Parity target: reference src/llama-grammar.{h,cpp} — GBNF text is parsed into
rules of alternates of elements (char ranges / rule refs); decoding maintains
a set of PDA stacks; `filter_vocab` masks tokens whose text cannot extend any
stack (llama_grammar_apply_impl) and `accept_token` advances the stacks
(llama_grammar_accept_impl).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum, auto


class ElemType(Enum):
    END = auto()
    ALT = auto()
    RULE_REF = auto()
    CHAR = auto()
    CHAR_NOT = auto()
    CHAR_RNG_UPPER = auto()
    CHAR_ALT = auto()


@dataclass(frozen=True)
class Elem:
    type: ElemType
    value: int = 0  # char codepoint or rule id


Rule = list[Elem]


class GrammarParseError(ValueError):
    pass


class GBNFParser:
    """Parses GBNF text into numbered rules (grammar format per reference
    grammars/README.md)."""

    def __init__(self):
        self.symbol_ids: dict[str, int] = {}
        self.rules: dict[int, Rule] = {}

    def get_symbol_id(self, name: str) -> int:
        if name not in self.symbol_ids:
            self.symbol_ids[name] = len(self.symbol_ids)
        return self.symbol_ids[name]

    def generate_symbol_id(self, base: str) -> int:
        idx = len(self.symbol_ids)
        self.symbol_ids[f"{base}_{idx}"] = idx
        return idx

    def parse(self, text: str) -> "Grammar":
        pos = 0
        text_len = len(text)

        def skip_ws(p, newline_ok=True):
            # newline terminates a rule body unless inside parens
            # (reference llama-grammar.cpp parse_space newline_ok flag)
            while p < text_len:
                c = text[p]
                if c in " \t" or (newline_ok and c in "\r\n"):
                    p += 1
                elif c == "#":
                    while p < text_len and text[p] != "\n":
                        p += 1
                else:
                    break
            return p

        def parse_name(p):
            start = p
            while p < text_len and (text[p].isalnum() or text[p] in "-_"):
                p += 1
            if p == start:
                raise GrammarParseError(f"expected name at {p}: {text[p:p+20]!r}")
            return text[start:p], p

        def parse_char(p):
            """-> (codepoint, newpos). Handles escapes."""
            c = text[p]
            if c == "\\":
                e = text[p + 1]
                if e == "x":
                    return int(text[p + 2 : p + 4], 16), p + 4
                if e == "u":
                    return int(text[p + 2 : p + 6], 16), p + 6
                if e == "U":
                    return int(text[p + 2 : p + 10], 16), p + 10
                mapping = {"t": 9, "r": 13, "n": 10, "\\": 92, '"': 34, "[": 91, "]": 93}
                if e in mapping:
                    return mapping[e], p + 2
                return ord(e), p + 2
            return ord(c), p + 1

        def parse_sequence(p, rule_name, out: Rule, nested: bool):
            last_sym_start = len(out)
            while p < text_len:
                c = text[p]
                if c == '"':
                    p += 1
                    last_sym_start = len(out)
                    while text[p] != '"':
                        cp, p = parse_char(p)
                        out.append(Elem(ElemType.CHAR, cp))
                    p = skip_ws(p + 1, nested)
                elif c == "[":
                    p += 1
                    start_type = ElemType.CHAR
                    if text[p] == "^":
                        p += 1
                        start_type = ElemType.CHAR_NOT
                    last_sym_start = len(out)
                    first = True
                    while text[p] != "]":
                        cp, p = parse_char(p)
                        out.append(Elem(start_type if first else ElemType.CHAR_ALT, cp))
                        first = False
                        if text[p] == "-" and text[p + 1] != "]":
                            cp2, p2 = parse_char(p + 1)
                            out.append(Elem(ElemType.CHAR_RNG_UPPER, cp2))
                            p = p2
                    p = skip_ws(p + 1, nested)
                elif c.isalnum() or c == "_":
                    name, p = parse_name(p)
                    p = skip_ws(p, nested)
                    last_sym_start = len(out)
                    out.append(Elem(ElemType.RULE_REF, self.get_symbol_id(name)))
                elif c == "(":
                    p = skip_ws(p + 1)
                    sub_id = self.generate_symbol_id(rule_name)
                    p = parse_alternates(p, rule_name, sub_id, True)
                    last_sym_start = len(out)
                    out.append(Elem(ElemType.RULE_REF, sub_id))
                    if p >= text_len or text[p] != ")":
                        raise GrammarParseError(f"expected ) at {p}")
                    p = skip_ws(p + 1, nested)
                elif c in "*+?":
                    if last_sym_start == len(out):
                        raise GrammarParseError(f"dangling {c} at {p}")
                    sub = out[last_sym_start:]
                    sub_id = self.generate_symbol_id(rule_name)
                    new_rule: Rule = []
                    if c in "*+":
                        # S ::= sub S | (sub for +, empty for *)
                        new_rule.extend(sub)
                        new_rule.append(Elem(ElemType.RULE_REF, sub_id))
                        new_rule.append(Elem(ElemType.ALT))
                        if c == "+":
                            new_rule.extend(sub)
                    else:  # ? -> sub | empty
                        new_rule.extend(sub)
                        new_rule.append(Elem(ElemType.ALT))
                    new_rule.append(Elem(ElemType.END))
                    self.rules[sub_id] = new_rule
                    del out[last_sym_start:]
                    out.append(Elem(ElemType.RULE_REF, sub_id))
                    p = skip_ws(p + 1, nested)
                elif c == "{":
                    # {m,n} repetition
                    import re as _re

                    m = _re.match(r"\{(\d*)(,(\d*))?\}", text[p:])
                    if not m:
                        raise GrammarParseError(f"bad repetition at {p}")
                    lo = int(m.group(1) or 0)
                    hi = int(m.group(3)) if m.group(3) else (lo if m.group(2) is None else -1)
                    sub = out[last_sym_start:]
                    del out[last_sym_start:]
                    # expand: sub{lo} then optional tail
                    for _ in range(lo):
                        out.extend(sub)
                    if hi < 0:  # unbounded
                        sub_id = self.generate_symbol_id(rule_name)
                        self.rules[sub_id] = list(sub) + [Elem(ElemType.RULE_REF, sub_id), Elem(ElemType.ALT), Elem(ElemType.END)]
                        out.append(Elem(ElemType.RULE_REF, sub_id))
                    else:
                        for _ in range(hi - lo):
                            sub_id = self.generate_symbol_id(rule_name)
                            self.rules[sub_id] = list(sub) + [Elem(ElemType.ALT), Elem(ElemType.END)]
                            out.append(Elem(ElemType.RULE_REF, sub_id))
                    p = skip_ws(p + m.end(), nested)
                else:
                    break
            return p

        def parse_alternates(p, rule_name, rule_id, nested):
            rule: Rule = []
            p = parse_sequence(p, rule_name, rule, nested)
            while p < text_len and text[p] == "|":
                rule.append(Elem(ElemType.ALT))
                p = skip_ws(p + 1, True)
                p = parse_sequence(p, rule_name, rule, nested)
            rule.append(Elem(ElemType.END))
            self.rules[rule_id] = rule
            return p

        p = skip_ws(pos)
        while p < text_len:
            name, p = parse_name(p)
            p = skip_ws(p)
            if not text[p : p + 3] == "::=":
                raise GrammarParseError(f"expected ::= at {p}")
            p = skip_ws(p + 3)
            rule_id = self.get_symbol_id(name)
            p = parse_alternates(p, name, rule_id, False)
            p = skip_ws(p)

        if "root" not in self.symbol_ids:
            raise GrammarParseError("grammar missing 'root' rule")
        for rid in range(len(self.symbol_ids)):
            if rid not in self.rules:
                missing = [n for n, i in self.symbol_ids.items() if i == rid]
                raise GrammarParseError(f"undefined rule {missing}")
        return Grammar(self.rules, self.symbol_ids["root"])


def _split_alternates(rule: Rule) -> list[list[Elem]]:
    alts: list[list[Elem]] = [[]]
    for e in rule:
        if e.type == ElemType.ALT:
            alts.append([])
        elif e.type == ElemType.END:
            break
        else:
            alts[-1].append(e)
    return alts


def _char_match(elems: list[Elem], i: int, cp: int) -> tuple[bool, int]:
    """Match codepoint against the char class starting at elems[i];
    returns (matched, next_index_after_class)."""
    e = elems[i]
    negated = e.type == ElemType.CHAR_NOT
    found = False
    lo = e.value
    j = i + 1
    # first range
    if j < len(elems) and elems[j].type == ElemType.CHAR_RNG_UPPER:
        if lo <= cp <= elems[j].value:
            found = True
        j += 1
    else:
        if cp == lo:
            found = True
    while j < len(elems) and elems[j].type == ElemType.CHAR_ALT:
        lo2 = elems[j].value
        j += 1
        if j < len(elems) and elems[j].type == ElemType.CHAR_RNG_UPPER:
            if lo2 <= cp <= elems[j].value:
                found = True
            j += 1
        else:
            if cp == lo2:
                found = True
    return (found != negated), j


class Grammar:
    """PDA over codepoints. Stacks are tuples of (rule_id, alt_idx, elem_idx)."""

    def __init__(self, rules: dict[int, Rule], root: int):
        self.rules = {rid: _split_alternates(r) for rid, r in rules.items()}
        self.root = root
        self.stacks: list[tuple] = []
        self.reset()

    # a stack entry is (rule_id, alt_index, pos_in_alt)
    def _advance(self, stack: tuple, out: list[tuple], seen: set):
        """Expand until top of stack is a char element (or stack empty)."""
        if stack in seen:
            return
        seen.add(stack)
        if not stack:
            out.append(stack)
            return
        rid, alt, pos = stack[-1]
        elems = self.rules[rid][alt]
        if pos >= len(elems):
            self._advance(stack[:-1], out, seen)
            return
        e = elems[pos]
        if e.type == ElemType.RULE_REF:
            for sub_alt in range(len(self.rules[e.value])):
                new = stack[:-1] + ((rid, alt, pos + 1), (e.value, sub_alt, 0))
                self._advance(new, out, seen)
        else:  # char class
            if stack not in out:
                out.append(stack)

    def reset(self):
        self.stacks = []
        seen: set = set()
        for alt in range(len(self.rules[self.root])):
            self._advance(((self.root, alt, 0),), self.stacks, seen)

    def _accept_cp(self, stacks: list[tuple], cp: int) -> list[tuple]:
        out: list[tuple] = []
        seen: set = set()
        for stack in stacks:
            if not stack:
                continue
            rid, alt, pos = stack[-1]
            elems = self.rules[rid][alt]
            if pos >= len(elems):
                continue
            e = elems[pos]
            if e.type in (ElemType.CHAR, ElemType.CHAR_NOT):
                ok, nxt = _char_match(elems, pos, cp)
                if ok:
                    new = stack[:-1] + ((rid, alt, nxt),)
                    self._advance(new, out, seen)
        return out

    def accept_text(self, text: str) -> bool:
        """Advance the live stacks; False if text is not a valid extension."""
        stacks = self.stacks
        for ch in text:
            stacks = self._accept_cp(stacks, ord(ch))
            if not stacks:
                return False
        self.stacks = stacks
        return True

    def would_accept(self, text: str) -> bool:
        stacks = self.stacks
        for ch in text:
            stacks = self._accept_cp(stacks, ord(ch))
            if not stacks:
                return False
        return True

    def is_complete(self) -> bool:
        return any(not s for s in self.stacks) or any(
            self._stack_done(s) for s in self.stacks
        )

    def _stack_done(self, stack: tuple) -> bool:
        if not stack:
            return True
        for rid, alt, pos in stack:
            if pos < len(self.rules[rid][alt]):
                return False
        return True


class GrammarSampler:
    """Vocab-mask + accept front-end (llama_sampler_init_grammar analog).

    Lazy mode (llama_sampler_init_grammar_lazy_patterns, include/llama.h:
    1415-1422): the grammar stays dormant — no vocab masking — until either
    a trigger token is produced or a trigger pattern fully matches the
    generation output so far; the grammar is then fed the constrained text
    starting at the trigger token / the pattern's first capture group."""

    def __init__(self, grammar_text: str, tokenizer, lazy: bool = False,
                 trigger_patterns: tuple[str, ...] = (),
                 trigger_tokens: tuple[int, ...] = ()):
        import re

        self.grammar = GBNFParser().parse(grammar_text)
        self.tok = tokenizer
        self._piece_cache: dict[int, str] = {}
        self.trigger_tokens = set(trigger_tokens)
        self.trigger_patterns = [re.compile(p, re.DOTALL)
                                 for p in trigger_patterns]
        self.awaiting = bool(lazy) and bool(
            self.trigger_tokens or self.trigger_patterns)
        self._buffer = ""  # generation output accumulated while dormant

    def _piece(self, tid: int) -> str:
        if tid not in self._piece_cache:
            self._piece_cache[tid] = self.tok.piece(tid)
        return self._piece_cache[tid]

    def filter_logits(self, logits, eog_ok_fn=None):
        import numpy as np

        if self.awaiting:  # dormant: free generation until a trigger fires
            return logits
        mask = np.full(len(logits), False)
        complete = self.grammar.is_complete()
        for tid in range(len(logits)):
            if self.tok.is_eog(tid):
                mask[tid] = complete
                continue
            piece = self._piece(tid)
            if piece and self.grammar.would_accept(piece):
                mask[tid] = True
        logits[~mask] = -float("inf")
        return logits

    def _pattern_start(self) -> int | None:
        """Full-match each trigger pattern against the buffer; return the
        constrained-text start (first non-empty capture group, else match
        start) — reference llama_grammar_trigger_pattern::find."""
        for pat in self.trigger_patterns:
            m = pat.fullmatch(self._buffer)
            if m is None:
                continue
            for gi in range(1, (m.lastindex or 0) + 1):
                if m.group(gi):
                    return m.start(gi)
            return m.start(0)
        return None

    def accept(self, tid: int):
        if self.awaiting:
            piece = self._piece(tid)
            if tid in self.trigger_tokens:
                self.awaiting = False
                self._buffer = ""
                self.grammar.accept_text(piece)
                return
            self._buffer += piece
            start = self._pattern_start()
            if start is not None:
                self.awaiting = False
                self.grammar.accept_text(self._buffer[start:])
                self._buffer = ""
            return
        if self.tok.is_eog(tid):
            return
        self.grammar.accept_text(self._piece(tid))
