"""PEG parser combinators with partial-parse (streaming) support.

Analog of the reference's common/peg-parser.{h,cpp}: ordered-choice PEG
combinators that parse a *growing* buffer. A parse over an incomplete
generation returns PARTIAL instead of FAIL whenever more input could still
complete the rule (reference COMMON_PEG_PARSE_RESULT_NEED_MORE_INPUT), and
the AST it yields marks unfinished spans with ``partial=True`` (reference
common_peg_ast_node.is_partial). This is what lets the server re-parse the
accumulated text every token and stream structured diffs (content /
reasoning / tool-call argument deltas) without ever emitting text that might
retroactively turn out to be the start of a tool-call marker.

Pure host-side code: no JAX. Ordered choice, greedy repetition, no
backtracking across a committed alternative — standard PEG semantics.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

FAIL = 0
OK = 1
PARTIAL = 2  # consumed to end of a non-final buffer; could match with more


@dataclass
class Node:
    """AST node. Only tagged parsers produce nodes; untagged combinators
    pass children through (reference arena nodes carry rule+tag)."""

    tag: str
    start: int
    end: int
    text: str
    children: list["Node"] = field(default_factory=list)
    partial: bool = False

    def find(self, tag: str) -> Optional["Node"]:
        if self.tag == tag:
            return self
        for c in self.children:
            got = c.find(tag)
            if got is not None:
                return got
        return None

    def find_all(self, tag: str) -> list["Node"]:
        out = []
        if self.tag == tag:
            out.append(self)
        for c in self.children:
            out.extend(c.find_all(tag))
        return out


@dataclass
class Ctx:
    text: str
    at_end: bool  # True once generation finished (no more input will come)


# A parser is fn(ctx, pos) -> (status, end_pos, children_nodes).
# On PARTIAL, end_pos is where consumption stopped (usually len(text)) and
# children hold whatever was captured so far (marked partial where apt).


class P:
    __slots__ = ("fn",)

    def __init__(self, fn: Callable):
        self.fn = fn

    def __call__(self, ctx: Ctx, pos: int):
        return self.fn(ctx, pos)

    def __add__(self, other):
        return seq(self, _coerce(other))

    def __radd__(self, other):
        return seq(_coerce(other), self)

    def __or__(self, other):
        return choice(self, _coerce(other))

    def __ror__(self, other):
        return choice(_coerce(other), self)

    def tag(self, name: str) -> "P":
        return tag(name, self)


def _coerce(x) -> P:
    if isinstance(x, P):
        return x
    if isinstance(x, str):
        return lit(x)
    raise TypeError(f"cannot use {type(x)} as parser")


def lit(s: str) -> P:
    """Literal string. A proper prefix at end-of-buffer is PARTIAL."""

    def fn(ctx: Ctx, pos: int):
        t = ctx.text
        if t.startswith(s, pos):
            return OK, pos + len(s), []
        remain = t[pos:]
        if not ctx.at_end and len(remain) < len(s) and s.startswith(remain):
            return PARTIAL, len(t), []
        return FAIL, pos, []

    return fn if False else P(fn)


def eps() -> P:
    return P(lambda ctx, pos: (OK, pos, []))


def ws() -> P:
    def fn(ctx: Ctx, pos: int):
        t = ctx.text
        n = len(t)
        while pos < n and t[pos] in " \t\r\n":
            pos += 1
        # trailing whitespace never blocks: it's optional by construction
        return OK, pos, []

    return P(fn)


def seq(*parsers) -> P:
    ps = [_coerce(p) for p in parsers]

    def fn(ctx: Ctx, pos: int):
        nodes: list[Node] = []
        cur = pos
        for p in ps:
            st, cur, kids = p(ctx, cur)
            nodes.extend(kids)
            if st == FAIL:
                return FAIL, pos, []
            if st == PARTIAL:
                return PARTIAL, cur, nodes
        return OK, cur, nodes

    return P(fn)


def choice(*parsers) -> P:
    """Ordered choice. If an earlier alternative is PARTIAL we must wait —
    with more input PEG would commit to it over a later alternative."""
    ps = [_coerce(p) for p in parsers]

    def fn(ctx: Ctx, pos: int):
        best_partial = None
        for p in ps:
            st, end, kids = p(ctx, pos)
            if st == OK:
                if best_partial is not None:
                    # an earlier alternative may still win with more input
                    return best_partial
                return OK, end, kids
            if st == PARTIAL and best_partial is None:
                best_partial = (PARTIAL, end, kids)
        return best_partial if best_partial is not None else (FAIL, pos, [])

    return P(fn)


def opt(p) -> P:
    p = _coerce(p)

    def fn(ctx: Ctx, pos: int):
        st, end, kids = p(ctx, pos)
        if st == FAIL:
            return OK, pos, []
        return st, end, kids

    return P(fn)


def star(p) -> P:
    p = _coerce(p)

    def fn(ctx: Ctx, pos: int):
        nodes: list[Node] = []
        cur = pos
        while True:
            st, end, kids = p(ctx, cur)
            if st == FAIL:
                return OK, cur, nodes
            nodes.extend(kids)
            if st == PARTIAL:
                return PARTIAL, end, nodes
            if end == cur:  # no progress; avoid infinite loop
                return OK, cur, nodes
            cur = end

    return P(fn)


def tag(name: str, p) -> P:
    p = _coerce(p)

    def fn(ctx: Ctx, pos: int):
        st, end, kids = p(ctx, pos)
        if st == FAIL:
            return FAIL, pos, []
        node = Node(name, pos, end, ctx.text[pos:end], kids, st == PARTIAL)
        return st, end, [node]

    return P(fn)


def until(*stops: str, allow_empty: bool = True) -> P:
    """Consume text up to (not including) the earliest stop literal.

    Streaming-safe: if no stop is found and the buffer may still grow, the
    final characters that form a prefix of any stop marker are withheld
    (PARTIAL) so content never leaks a half-emitted ``<tool_call>``."""

    def fn(ctx: Ctx, pos: int):
        t = ctx.text
        best = -1
        for s in stops:
            i = t.find(s, pos)
            if i >= 0 and (best < 0 or i < best):
                best = i
        if best >= 0:
            if not allow_empty and best == pos:
                return FAIL, pos, []
            return OK, best, []
        if ctx.at_end:
            if not allow_empty and len(t) == pos:
                return FAIL, pos, []
            return OK, len(t), []
        # hold back any suffix that could be a partial stop marker
        safe = len(t)
        lo = max(pos, len(t) - max(len(s) for s in stops) + 1)
        for i in range(lo, len(t)):
            suf = t[i:]
            if any(s.startswith(suf) for s in stops):
                safe = i
                break
        return PARTIAL, safe, []

    return P(fn)


def rest() -> P:
    """Everything remaining. OK at end, PARTIAL otherwise."""

    def fn(ctx: Ctx, pos: int):
        if ctx.at_end:
            return OK, len(ctx.text), []
        return PARTIAL, len(ctx.text), []

    return P(fn)


def regex_char(pred: Callable[[str], bool], min_n: int = 1) -> P:
    def fn(ctx: Ctx, pos: int):
        t = ctx.text
        cur = pos
        while cur < len(t) and pred(t[cur]):
            cur += 1
        if cur - pos < min_n:
            if cur == len(t) and not ctx.at_end:
                return PARTIAL, cur, []
            return FAIL, pos, []
        if cur == len(t) and not ctx.at_end:
            return PARTIAL, cur, []  # the run may continue
        return OK, cur, []

    return P(fn)


# ---------------------------------------------------------------------------
# Partial-aware JSON value scanner (reference peg-parser json rules).
# Returns the raw text span of one JSON value; marks it partial if the
# buffer ended mid-value.


def _scan_json(t: str, pos: int, at_end: bool):
    """-> (status, end). Scans one JSON value starting at pos (no leading
    whitespace). Does not validate numbers strictly — the goal is streaming
    span recovery, json.loads gives final validation."""
    n = len(t)
    if pos >= n:
        return (FAIL if at_end else PARTIAL), pos
    c = t[pos]
    if c in "{[":
        stack = [c]
        i = pos + 1
        in_str = False
        esc = False
        while i < n and stack:
            ch = t[i]
            if in_str:
                if esc:
                    esc = False
                elif ch == "\\":
                    esc = True
                elif ch == '"':
                    in_str = False
            else:
                if ch == '"':
                    in_str = True
                elif ch in "{[":
                    stack.append(ch)
                elif ch == "}":
                    if stack[-1] != "{":
                        return FAIL, i
                    stack.pop()
                elif ch == "]":
                    if stack[-1] != "[":
                        return FAIL, i
                    stack.pop()
            i += 1
        if stack:
            return (FAIL if at_end else PARTIAL), n
        return OK, i
    if c == '"':
        i = pos + 1
        esc = False
        while i < n:
            ch = t[i]
            if esc:
                esc = False
            elif ch == "\\":
                esc = True
            elif ch == '"':
                return OK, i + 1
            i += 1
        return (FAIL if at_end else PARTIAL), n
    # number / true / false / null only (barewords are not JSON)
    i = pos
    while i < n and (t[i].isalnum() or t[i] in "+-.eE_"):
        i += 1
    if i == pos:
        return FAIL, pos
    word = t[pos:i]
    is_lit = any(k.startswith(word) for k in ("true", "false", "null"))
    is_num = word[0] in "-0123456789" and all(
        ch in "0123456789+-.eE" for ch in word
    )
    if not (is_lit or is_num):
        return FAIL, pos
    if i == n and not at_end:
        return PARTIAL, n
    return OK, i


def eof() -> P:
    def fn(ctx: Ctx, pos: int):
        if pos >= len(ctx.text):
            return (OK, pos, []) if ctx.at_end else (PARTIAL, pos, [])
        return FAIL, pos, []

    return P(fn)


def json_value(tag_name: str = "json", container_only: bool = False) -> P:
    def fn(ctx: Ctx, pos: int):
        if container_only:
            if pos >= len(ctx.text):
                return (FAIL, pos, []) if ctx.at_end else (PARTIAL, pos, [])
            if ctx.text[pos] not in "{[":
                return FAIL, pos, []
        st, end = _scan_json(ctx.text, pos, ctx.at_end)
        if st == FAIL:
            return FAIL, pos, []
        node = Node(tag_name, pos, end, ctx.text[pos:end], [], st == PARTIAL)
        return st, end, [node]

    return P(fn)


def parse(parser: P, text: str, at_end: bool):
    """Top-level entry: -> (status, root Node). The root wraps whatever was
    captured; on PARTIAL the AST is the best-effort prefix parse."""
    ctx = Ctx(text, at_end)
    st, end, kids = _coerce(parser)(ctx, 0)
    root = Node("root", 0, end, text[:end], kids, st == PARTIAL)
    return st, root
