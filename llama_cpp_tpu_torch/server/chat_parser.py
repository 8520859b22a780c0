"""Streaming chat-output parsing: PEG grammars per tool-call format, AST →
message mapping, and incremental diffs.

Analog of the reference's common/chat-peg-parser.cpp (per-format grammar
builders + mappers) and common_chat_msg_diff::compute_diffs
(common/chat.cpp:266): the server re-parses the accumulated generation every
token with partial-parse enabled and streams OpenAI-style structured deltas
— content, reasoning_content, and per-tool-call argument increments — while
withholding any text that could still become a tool-call marker.

Formats:
  generic      content + optional <think> reasoning (no tools)
  hermes       <tool_call>{json}</tool_call>        (Hermes/Qwen)
  llama3       {"name": ..., "parameters": {...}} and <|python_tag|>
  functionary  >>>name\\n{json} segments (v3.2) and <function=name>{json}
  xml_invoke   <tool_call><invoke name=..><parameter name=k>v</parameter>…
               (MiniMax-M3 / Claude-XML family)
"""

from __future__ import annotations

import json
import uuid
from dataclasses import dataclass, field

from . import peg
from .peg import (FAIL, OK, PARTIAL, choice, json_value, lit, opt, parse,
                  rest, seq, star, tag, until, ws)

THINK_TAGS = [
    ("<think>", "</think>"),
    ("<seed:think>", "</seed:think>"),
    ("<|START_THINKING|>", "<|END_THINKING|>"),
    ("<reasoning>", "</reasoning>"),
]


@dataclass
class ToolCall:
    id: str = ""
    name: str = ""
    arguments: str = ""


@dataclass
class ParsedMsg:
    content: str = ""
    reasoning: str = ""
    tool_calls: list[ToolCall] = field(default_factory=list)


# ---------------------------------------------------------------------------
# grammar builders


def _reasoning_block():
    """Optional leading reasoning block, any of the known tag pairs. Also
    accepts a *bare* reasoning body when generation starts inside an open
    think block (templates that pre-open <think>)."""
    alts = []
    for opn, cls in THINK_TAGS:
        alts.append(
            seq(lit(opn), tag("reasoning", until(cls)), opt(lit(cls)), ws())
        )
    return opt(choice(*alts))


def _grammar_generic():
    return seq(_reasoning_block(), tag("content", rest()))


def _grammar_hermes():
    call = seq(
        lit("<tool_call>"), ws(),
        tag("tool", json_value("tool-json")),
        ws(), opt(lit("</tool_call>")),
    )
    chunk = choice(call, tag("content", until("<tool_call>", allow_empty=False)))
    return seq(_reasoning_block(), star(chunk), opt(tag("content", rest())))


def _grammar_llama3():
    pytag = seq(
        lit("<|python_tag|>"),
        tag("tool", json_value("tool-json")),
        opt(lit("<|eom_id|>")),
    )
    bare = seq(
        ws(),
        tag("tool", json_value("tool-json", container_only=True)),
        ws(),
        peg.eof(),
    )
    return seq(
        _reasoning_block(),
        choice(pytag, bare, tag("content", rest())),
    )


def _grammar_functionary():
    name_chars = peg.regex_char(lambda c: c.isalnum() or c in "_-.", 1)
    seg = seq(
        lit(">>>"),
        tag("tool-name", name_chars),
        lit("\n"),
        tag("tool-args", json_value("tool-json")),
        ws(),
    )
    fn_blk = seq(
        lit("<function="),
        tag("tool-name", name_chars),
        lit(">"),
        tag("tool-args", json_value("tool-json")),
        opt(lit("</function>")),
        ws(),
    )
    chunk = choice(
        seg, fn_blk,
        tag("content", until(">>>", "<function=", allow_empty=False)),
    )
    return seq(_reasoning_block(), star(chunk), opt(tag("content", rest())))


def _grammar_xml_invoke():
    """<tool_call><invoke name="x"><parameter name="k">value</parameter>...
    </invoke></tool_call> — MiniMax-M3 family. Parameter values are raw
    text; mapped into a JSON arguments object."""
    qname = seq(lit('"'), tag("name-text", until('"')), lit('"'))
    param = seq(
        ws(), lit("<parameter name="), qname, lit(">"),
        tag("param-value", until("</parameter>")),
        opt(lit("</parameter>")),
    ).tag("param")
    invoke = seq(
        ws(), lit("<invoke name="), qname.tag("invoke-name"), lit(">"),
        star(param), ws(), opt(lit("</invoke>")),
    ).tag("invoke")
    call = seq(lit("<tool_call>"), star(invoke), ws(), opt(lit("</tool_call>")))
    chunk = choice(call, tag("content", until("<tool_call>", allow_empty=False)))
    return seq(_reasoning_block(), star(chunk), opt(tag("content", rest())))


_GRAMMARS = {
    "generic": _grammar_generic,
    "hermes": _grammar_hermes,
    "llama3": _grammar_llama3,
    "functionary": _grammar_functionary,
    "xml_invoke": _grammar_xml_invoke,
}


def detect_format(template_src: str | None) -> str:
    """Pick a stream-parse format from the chat template source (the
    reference sniffs template markers the same way, chat.cpp:3100+)."""
    if not template_src:
        return "generic"
    src = template_src
    if "<invoke name=" in src:
        return "xml_invoke"
    if "<tool_call>" in src:
        return "hermes"
    if ">>>" in src and "all\n" in src:
        return "functionary"
    if "<function=" in src:
        return "functionary"
    if "<|python_tag|>" in src or "<|start_header_id|>" in src:
        return "llama3"
    return "generic"


# ---------------------------------------------------------------------------
# AST -> ParsedMsg


def _new_id() -> str:
    return "call_" + uuid.uuid4().hex[:12]


def _map_tool_json(raw: str, partial: bool, msg: ParsedMsg):
    """Map one hermes/llama3-style JSON tool blob (possibly incomplete) to a
    ToolCall with name + raw-text arguments."""
    tc = ToolCall()
    if not partial:
        try:
            obj = json.loads(raw)
        except json.JSONDecodeError:
            msg.content += raw
            return
        if isinstance(obj, dict) and "function" in obj and isinstance(obj["function"], dict):
            obj = obj["function"]
        if not isinstance(obj, dict) or not isinstance(obj.get("name"), str):
            msg.content += raw
            return
        args = obj.get("arguments", obj.get("parameters", {}))
        tc.name = obj["name"]
        tc.arguments = args if isinstance(args, str) else json.dumps(args)
        msg.tool_calls.append(tc)
        return
    # partial: recover name once its string literal closes; stream the raw
    # text of the arguments value as it grows
    name, args = _probe_partial_tool_json(raw)
    if name is None and args is None and not raw.strip().startswith("{"):
        return
    tc.name = name or ""
    tc.arguments = args or ""
    msg.tool_calls.append(tc)


def _probe_partial_tool_json(raw: str):
    """Best-effort extraction of "name" and the raw arguments-value span
    from an incomplete JSON object."""
    name = None
    args = None
    for key in ('"name"', "'name'"):
        i = raw.find(key)
        if i < 0:
            continue
        j = raw.find(":", i + len(key))
        if j < 0:
            break
        st, end = peg._scan_json(raw, _skip_ws(raw, j + 1), True)
        if st == OK:
            try:
                v = json.loads(raw[_skip_ws(raw, j + 1):end])
                if isinstance(v, str):
                    name = v
            except json.JSONDecodeError:
                pass
        break
    for key in ('"arguments"', '"parameters"'):
        i = raw.find(key)
        if i < 0:
            continue
        j = raw.find(":", i + len(key))
        if j < 0:
            break
        k = _skip_ws(raw, j + 1)
        if k < len(raw):
            args = raw[k:]
        break
    return name, args


def _skip_ws(s: str, i: int) -> int:
    while i < len(s) and s[i] in " \t\r\n":
        i += 1
    return i


def map_ast(root: peg.Node, fmt: str) -> ParsedMsg:
    msg = ParsedMsg()
    pending_name: str | None = None
    for node in _walk(root):
        if node.tag == "reasoning":
            msg.reasoning += node.text
        elif node.tag == "content":
            msg.content += node.text
        elif node.tag == "tool-json":
            _map_tool_json(node.text, node.partial, msg)
        elif node.tag == "tool-name":
            pending_name = node.text
        elif node.tag == "tool-args":
            tc = ToolCall(name=pending_name or "", arguments=node.text)
            msg.tool_calls.append(tc)
            pending_name = None
        elif node.tag == "invoke":
            tc = ToolCall()
            nm = node.find("invoke-name")
            if nm is not None:
                inner = nm.find("name-text")
                tc.name = inner.text if inner is not None else ""
            obj = {}
            for p in node.find_all("param"):
                k = p.find("name-text")
                v = p.find("param-value")
                if k is None:
                    continue
                obj[k.text] = _coerce_param(v.text if v is not None else "")
            tc.arguments = json.dumps(obj) if (obj or not node.partial) else ""
            msg.tool_calls.append(tc)
    if pending_name is not None:
        msg.tool_calls.append(ToolCall(name=pending_name))
    msg.content = msg.content.strip() if not msg.tool_calls else msg.content
    return msg


def _coerce_param(text: str):
    t = text.strip()
    try:
        return json.loads(t)
    except (json.JSONDecodeError, ValueError):
        return t


def _walk(node: peg.Node):
    # yield in document order; invoke/tool-args subtrees are handled as units
    for c in node.children:
        yield c
        if c.tag not in ("invoke", "tool-args"):
            yield from _walk(c)


# ---------------------------------------------------------------------------
# streaming diffs (reference common_chat_msg_diff::compute_diffs)


def _string_diff(prev: str, new: str) -> str:
    if new.startswith(prev):
        return new[len(prev):]
    return new  # reparse changed its mind; resend (reference throws — we heal)


def compute_diffs(prev: ParsedMsg, new: ParsedMsg) -> list[dict]:
    """OpenAI-style delta objects: {"reasoning_content": s} | {"content": s}
    | {"tool_calls": [{index, id?, function:{name?, arguments}}]}."""
    diffs: list[dict] = []
    if prev.reasoning != new.reasoning:
        d = _string_diff(prev.reasoning, new.reasoning)
        if d:
            diffs.append({"reasoning_content": d})
    if prev.content != new.content:
        d = _string_diff(prev.content, new.content)
        if d:
            diffs.append({"content": d})
    if len(new.tool_calls) < len(prev.tool_calls):
        return diffs  # reparse shrank (rare heal path); wait for it to regrow
    if prev.tool_calls:
        idx = len(prev.tool_calls) - 1
        pt, nt = prev.tool_calls[idx], new.tool_calls[idx]
        entry: dict = {"index": idx, "function": {}}
        if pt.name != nt.name and nt.name:
            entry["function"]["name"] = nt.name
            entry["id"] = nt.id or pt.id
        args_d = _string_diff(pt.arguments, nt.arguments)
        if args_d:
            entry["function"]["arguments"] = args_d
        if entry["function"]:
            diffs.append({"tool_calls": [entry]})
    for idx in range(len(prev.tool_calls), len(new.tool_calls)):
        nt = new.tool_calls[idx]
        entry = {
            "index": idx,
            "id": nt.id or _new_id(),
            "type": "function",
            "function": {"name": nt.name, "arguments": nt.arguments},
        }
        nt.id = entry["id"]
        diffs.append({"tool_calls": [entry]})
    return diffs


class StreamingChatParser:
    """Per-slot incremental parser. Feed text deltas; each put() returns the
    structured deltas to stream. finish() flushes with at_end=True."""

    def __init__(self, fmt: str = "generic"):
        if fmt not in _GRAMMARS:
            fmt = "generic"
        self.fmt = fmt
        self.grammar = _GRAMMARS[fmt]()
        self.text = ""
        self.msg = ParsedMsg()
        self._ids: list[str] = []

    def _reparse(self, at_end: bool) -> ParsedMsg:
        st, root = parse(self.grammar, self.text, at_end)
        if st == FAIL:
            # grammar can't make sense of it: degrade to plain content
            msg = ParsedMsg(content=self.text)
        else:
            msg = map_ast(root, self.fmt)
        # sticky tool-call ids across reparses
        for i, tc in enumerate(msg.tool_calls):
            if i < len(self._ids):
                tc.id = self._ids[i]
            else:
                tc.id = tc.id or _new_id()
                self._ids.append(tc.id)
        return msg

    def put(self, delta: str) -> list[dict]:
        self.text += delta
        new = self._reparse(at_end=False)
        diffs = compute_diffs(self.msg, new)
        self.msg = new
        return diffs

    def finish(self) -> list[dict]:
        new = self._reparse(at_end=True)
        diffs = compute_diffs(self.msg, new)
        self.msg = new
        return diffs

    @property
    def result(self) -> ParsedMsg:
        return self.msg
