"""The port's grammar sampler and JSON-schema converter
(llama_cpp_tpu_torch/sampling/grammar.py, json_schema.py) against the JAX
package's copies: the GBNF grammars of tests/test_grammar.py accept and
refuse the same strings, parse errors raise in both, a GrammarSampler over
the bench fixture's vocabulary allows the same token set at every step of
a constrained text, and schema_to_gbnf gives the same GBNF text."""

import numpy as np
import pytest
import torch

from llama_cpp_tpu.gguf.reader import read_gguf as jax_read_gguf
from llama_cpp_tpu.sampling import grammar as jax_grammar
from llama_cpp_tpu.sampling import json_schema as jax_json_schema
from llama_cpp_tpu.tokenizer import Tokenizer as JaxTokenizer
from llama_cpp_tpu_torch.gguf.reader import read_gguf
from llama_cpp_tpu_torch.sampling import grammar, json_schema
from llama_cpp_tpu_torch.testing import make_bench_llama_gguf
from llama_cpp_tpu_torch.tokenizer import Tokenizer

# (grammar, strings) from tests/test_grammar.py, each string checked with
# would_accept (prefix validity)
GRAMMARS = {
    "literal": ('root ::= "ab"', ["ab", "a", "b", "abc", ""]),
    "alternates": ('root ::= "cat" | "dog"', ["cat", "dog", "cow", "ca", "do"]),
    "range": ("root ::= [a-z]", ["q", "Q", "qq"]),
    "negated_range": ("root ::= [^a-z]", ["Q", "q", "7"]),
    "star": ('root ::= "a"* "b"', ["b", "ab", "aaab", "ba", "aaa"]),
    "plus_optional": ('root ::= "a"+ "b"?', ["a", "aab", "b", "abb"]),
    "recursion": ("root ::= expr\nexpr ::= term (\"+\" term)*\nterm ::= [0-9]+ | \"(\" expr \")\"",
                  ["1", "1+2", "12+(3+4)", "(1)", "+1", "1+", "((", ")"]),
    "bounded": ('root ::= "a"{2,3}', ["aaaa", "aa", "aaa", "a"]),
    "json_like": (r"""
root ::= object
object ::= "{" ws ( string ":" ws value ("," ws string ":" ws value)* )? "}"
value ::= object | array | string | number | "true" | "false" | "null"
array ::= "[" ws ( value ("," ws value)* )? "]"
string ::= "\"" [^"]* "\""
number ::= "-"? [0-9]+ ("." [0-9]+)?
ws ::= [ \t\n]*
""", ['{"a": 1}', '{"a": [1, 2], "b": {"c": "d"}}', "[1]", '{"a" 1}', '{"a": tr']),
    "json_gbnf": (jax_json_schema.JSON_GBNF, ['{"k": [1, -2.5e3, true, null]}', '"x\\u00e9"',
                                              "{,", "nul", "[1 2]"]),
}
PARSE_ERRORS = {"missing_root": 'start ::= "x"', "undefined_rule": "root ::= missing"}

SCHEMAS = {
    "empty": {},
    "string": {"type": "string"},
    "integer": {"type": "integer"},
    "enum": {"enum": ["red", "green", 3]},
    "const": {"const": {"a": 1}},
    "object": {"type": "object", "properties": {"name": {"type": "string"},
                                                "age": {"type": "integer"},
                                                "tags": {"type": "array",
                                                         "items": {"type": "string"}}},
               "required": ["name"]},
    "array_min": {"type": "array", "items": {"type": "number"}, "minItems": 2},
    "prefix_items": {"type": "array", "prefixItems": [{"type": "string"},
                                                      {"type": "boolean"}]},
    "any_of": {"anyOf": [{"type": "null"}, {"type": "object", "properties": {
        "x": {"type": ["integer", "string"]}}}]},
    "ref": {"$ref": "#/defs/x"},
    "string_form": '{"type": "object", "properties": {"ok": {"type": "boolean"}}}',
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", list(GRAMMARS))
def test_grammar_accepts_the_same_strings(name):
    text, strings = GRAMMARS[name]
    got = [grammar.GBNFParser().parse(text).would_accept(s) for s in strings]
    ref = [jax_grammar.GBNFParser().parse(text).would_accept(s) for s in strings]
    assert got == ref and any(ref) and (not all(ref) or name == "literal")


@pytest.mark.parametrize("name", list(PARSE_ERRORS))
def test_grammar_parse_errors_raise_in_both(name):
    with pytest.raises(jax_grammar.GrammarParseError):
        jax_grammar.GBNFParser().parse(PARSE_ERRORS[name])
    with pytest.raises(grammar.GrammarParseError):
        grammar.GBNFParser().parse(PARSE_ERRORS[name])


@pytest.mark.parametrize("name", list(SCHEMAS))
def test_schema_to_gbnf_gives_the_same_text(name):
    got = json_schema.schema_to_gbnf(SCHEMAS[name])
    assert got == jax_json_schema.schema_to_gbnf(SCHEMAS[name])
    grammar.GBNFParser().parse(got)  # and the text parses
    assert json_schema.JSON_GBNF == jax_json_schema.JSON_GBNF


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    path = make_bench_llama_gguf(str(tmp_path_factory.mktemp("grammar") / "m.gguf"),
                                 n_layers=1, n_embd=256, n_heads=2, n_kv_heads=1, n_ff=512,
                                 vocab_size=512, seed=0)
    return (Tokenizer.from_gguf(read_gguf(path).metadata),
            JaxTokenizer.from_gguf(jax_read_gguf(path).metadata))


@pytest.mark.parametrize("lazy", [False, True], ids=["eager", "lazy"])
@pytest.mark.parametrize("name", ["json_gbnf", "recursion", "alternates"])
def test_grammar_sampler_allows_the_same_tokens(tokenizers, name, lazy):
    """Each step: the same finite logits survive filter_logits in both
    packages; then both accept the same token (the allowed one of largest
    seeded logit). Lazy samplers wait for a trigger token first."""
    tok, jtok = tokenizers
    text = GRAMMARS[name][0]
    trigger = (5,) if lazy else ()
    gs = grammar.GrammarSampler(text, tok, lazy=lazy, trigger_tokens=trigger)
    js = jax_grammar.GrammarSampler(text, jtok, lazy=lazy, trigger_tokens=trigger)
    rng = np.random.default_rng(1)
    n_allowed = []
    for step in range(5):
        logits = rng.normal(size=len(tok.vocab.tokens)).astype(np.float32)
        got = gs.filter_logits(logits.copy())
        ref = js.filter_logits(logits.copy())
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
        n_allowed.append(int(np.isfinite(ref).sum()))
        if lazy and step == 0:
            t = trigger[0]  # wakes the grammar (its piece feeds it when it can)
        elif not np.isfinite(ref).any():
            break
        else:
            t = int(np.argmax(ref))
        gs.accept(t)
        js.accept(t)
    assert 0 < min(n_allowed[1:] if lazy else n_allowed) < len(tok.vocab.tokens)
