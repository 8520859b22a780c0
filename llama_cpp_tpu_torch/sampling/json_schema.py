"""JSON schema -> GBNF grammar conversion.

Parity target: reference common/json-schema-to-grammar.cpp. Supports the
core schema vocabulary (type, enum, const, properties/required, items,
prefixItems, anyOf/oneOf, additionalProperties=false, min/maxItems) and
degrades to generic JSON for the rest.
"""

from __future__ import annotations

import json
from typing import Any

JSON_GBNF = r"""
root ::= value
value ::= object | array | string | number | boolean | null
object ::= "{" ws ( member ("," ws member)* )? "}" ws
member ::= string ":" ws value
array ::= "[" ws ( value ("," ws value)* )? "]" ws
string ::= "\"" char* "\"" ws
char ::= [^"\\] | "\\" (["\\/bfnrt] | "u" [0-9a-fA-F]{4})
number ::= "-"? ([0-9] | [1-9] [0-9]*) ("." [0-9]+)? ([eE] [-+]? [0-9]+)? ws
boolean ::= ("true" | "false") ws
null ::= "null" ws
ws ::= [ \t\n\r]*
"""

_PRIMITIVES = {
    "string": 'string',
    "number": 'number',
    "integer": 'integer',
    "boolean": 'boolean',
    "null": 'null',
}

_PRIM_RULES = {
    "string": r'"\"" char* "\"" ws',
    "char": r'[^"\\] | "\\" (["\\/bfnrt] | "u" [0-9a-fA-F]{4})',
    "number": r'"-"? ([0-9] | [1-9] [0-9]*) ("." [0-9]+)? ([eE] [-+]? [0-9]+)? ws',
    "integer": r'"-"? ([0-9] | [1-9] [0-9]*) ws',
    "boolean": r'("true" | "false") ws',
    "null": r'"null" ws',
    "value": r"object | array | string | number | boolean | null",
    "object": r'"{" ws ( member ("," ws member)* )? "}" ws',
    "member": r'string ":" ws value',
    "array": r'"[" ws ( value ("," ws value)* )? "]" ws',
    "ws": r"[ \t\n\r]*",
}


def _lit(s: str) -> str:
    return json.dumps(s)


class _Converter:
    def __init__(self):
        self.rules: dict[str, str] = {"ws": _PRIM_RULES["ws"]}
        self.n = 0

    def _need(self, *names):
        for name in names:
            if name not in self.rules:
                self.rules[name] = _PRIM_RULES[name]
                if name == "string":
                    self._need("char")
                if name in ("value", "object", "array", "member"):
                    self._need("string", "number", "boolean", "null",
                               "value", "object", "member", "array")

    def _fresh(self, hint: str) -> str:
        self.n += 1
        return f"{hint}{self.n}"

    def visit(self, schema: Any, hint: str = "r") -> str:
        """Returns a grammar EXPRESSION for this schema."""
        if schema in (True, {}, None):
            self._need("value")
            return "value"
        if "$ref" in schema:
            self._need("value")
            return "value"  # refs degrade to generic JSON
        if "const" in schema:
            return _lit(json.dumps(schema["const"])) + " ws"
        if "enum" in schema:
            return "(" + " | ".join(_lit(json.dumps(v)) for v in schema["enum"]) + ") ws"
        for comb in ("anyOf", "oneOf"):
            if comb in schema:
                parts = [self.visit(s, hint) for s in schema[comb]]
                return "(" + " | ".join(parts) + ")"
        t = schema.get("type")
        if isinstance(t, list):
            return "(" + " | ".join(self.visit({**schema, "type": x}, hint) for x in t) + ")"
        if t == "object" or (t is None and "properties" in schema):
            return self._object(schema, hint)
        if t == "array":
            return self._array(schema, hint)
        if t in _PRIMITIVES:
            self._need(t)
            if t == "string":
                self._need("char")
            return t
        self._need("value")
        return "value"

    def _object(self, schema: dict, hint: str) -> str:
        props = schema.get("properties", {})
        required = set(schema.get("required", []))
        if not props:
            self._need("object")
            return "object"
        name = self._fresh(hint + "obj")
        parts = []
        first = True
        # properties emitted in declaration order; optional ones wrapped with
        # their separator (approximation of the reference's optional chains)
        for key, sub in props.items():
            expr = self.visit(sub, hint + "p")
            kv = f'{_lit(json.dumps(key))} ":" ws ({expr})'
            sep = "" if first else '"," ws '
            if key in required:
                parts.append(f"{sep}{kv} ws")
            else:
                parts.append(f"({sep}{kv} ws)?")
            first = False
        body = " ".join(parts)
        self.rules[name] = f'"{{" ws {body} "}}" ws'
        return name

    def _array(self, schema: dict, hint: str) -> str:
        items = schema.get("items", True)
        prefix = schema.get("prefixItems")
        name = self._fresh(hint + "arr")
        if prefix:
            parts = [self.visit(s, hint + "i") for s in prefix]
            body = ' "," ws '.join(f"({p})" for p in parts)
            self.rules[name] = f'"[" ws {body} "]" ws'
            return name
        item = self.visit(items, hint + "i")
        min_items = int(schema.get("minItems", 0))
        req = " ".join(
            f"({item})" if i == 0 else f'"," ws ({item})' for i in range(min_items)
        )
        if min_items > 0:
            self.rules[name] = f'"[" ws {req} ("," ws ({item}))* "]" ws'
        else:
            self.rules[name] = f'"[" ws (({item}) ("," ws ({item}))*)? "]" ws'
        return name


def schema_to_gbnf(schema: dict | str) -> str:
    """Convert a JSON schema to GBNF text with a root rule."""
    if isinstance(schema, str):
        schema = json.loads(schema) if schema.strip() else {}
    conv = _Converter()
    root_expr = conv.visit(schema, "s")
    lines = [f"root ::= ws {root_expr}"]
    for name, body in conv.rules.items():
        lines.append(f"{name} ::= {body}")
    return "\n".join(lines) + "\n"
