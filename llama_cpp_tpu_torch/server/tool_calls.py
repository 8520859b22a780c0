"""Tool-call extraction from model output.

Analog of reference common/chat*.cpp streaming-diff PEG parsers (the
llama.cpp chat-parser family): recover OpenAI-style tool_calls from the
common emission formats — Hermes/Qwen <tool_call> blocks, llama3 python_tag,
functionary-style JSON, and bare JSON objects/arrays with name+arguments.
"""

from __future__ import annotations

import json
import re
import uuid
from typing import Any


def _mk_call(name: str, arguments: Any) -> dict:
    if not isinstance(arguments, str):
        arguments = json.dumps(arguments)
    return {
        "id": "call_" + uuid.uuid4().hex[:12],
        "type": "function",
        "function": {"name": name, "arguments": arguments},
    }


def _from_obj(obj: Any) -> list[dict]:
    calls = []
    items = obj if isinstance(obj, list) else [obj]
    for it in items:
        if not isinstance(it, dict):
            continue
        if "function" in it and isinstance(it["function"], dict):
            it = it["function"]
        name = it.get("name")
        args = it.get("arguments", it.get("parameters", {}))
        if isinstance(name, str) and name:
            calls.append(_mk_call(name, args))
    return calls


_TOOL_BLOCK = re.compile(r"<tool_call>\s*(.*?)\s*</tool_call>", re.S)
_FN_BLOCK = re.compile(r"<function=(\w+)>\s*(.*?)\s*</function>", re.S)
_PY_TAG = re.compile(r"<\|python_tag\|>(.*?)(?:<\|eom_id\|>|$)", re.S)


def _json_candidates(text: str):
    """Yield top-level JSON objects/arrays found in free text. Braces inside
    JSON string literals (common in code-valued arguments) are ignored by
    tracking in-string/escape state, as the reference chat parsers do."""
    depth = 0
    start = None
    in_str = False
    escaped = False
    for i, ch in enumerate(text):
        if start is not None and in_str:
            if escaped:
                escaped = False
            elif ch == "\\":
                escaped = True
            elif ch == '"':
                in_str = False
            continue
        if depth == 0 and ch in "{[":
            start, depth = i, 1
        elif start is not None:
            if ch == '"':
                in_str = True
            elif ch in "{[":
                depth += 1
            elif ch in "}]":
                depth -= 1
                if depth == 0:
                    yield text[start : i + 1], start, i + 1
                    start = None


def parse_tool_calls(text: str) -> tuple[str, list[dict]]:
    """-> (content_without_calls, tool_calls). Empty list if none found."""
    calls: list[dict] = []
    content = text

    m_blocks = _TOOL_BLOCK.findall(text)
    if m_blocks:
        for blk in m_blocks:
            try:
                calls.extend(_from_obj(json.loads(blk)))
            except json.JSONDecodeError:
                continue
        content = _TOOL_BLOCK.sub("", text).strip()
        return content, calls

    fn_blocks = _FN_BLOCK.findall(text)
    if fn_blocks:
        for name, blk in fn_blocks:
            try:
                calls.append(_mk_call(name, json.loads(blk)))
            except json.JSONDecodeError:
                calls.append(_mk_call(name, blk))
        return _FN_BLOCK.sub("", text).strip(), calls

    pt = _PY_TAG.search(text)
    if pt:
        body = pt.group(1).strip()
        try:
            calls.extend(_from_obj(json.loads(body)))
            return text[: pt.start()].strip(), calls
        except json.JSONDecodeError:
            pass

    # bare JSON object/array containing name+arguments
    stripped = text.strip()
    if stripped.startswith(("{", "[")):
        for cand, s, e in _json_candidates(stripped):
            try:
                got = _from_obj(json.loads(cand))
            except json.JSONDecodeError:
                continue
            if got:
                calls.extend(got)
                rest = (stripped[:s] + stripped[e:]).strip()
                return rest, calls
    return content, calls
