"""The port's tokenizer (a copy that imports nothing of the JAX package)
against the JAX package's, on the same GGUF metadata: exact equality of ids,
text, pieces and end-of-generation flags. Two vocabs, both written out here:
the SPM fixture with byte fallback that the bench models carry, and a small
GPT-2-style byte-level BPE vocab with its merges."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from llama_cpp_tpu.tokenizer import Tokenizer as JaxTokenizer
from llama_cpp_tpu.tokenizer.bpe import bytes_to_unicode
from llama_cpp_tpu_torch.gguf.constants import Keys, TokenType
from llama_cpp_tpu_torch.testing import tiny_spm_vocab
from llama_cpp_tpu_torch.tokenizer import Tokenizer

K = Keys.Tokenizer

MERGES = ["Ġ t", "h e", "Ġt he", "i n", "Ġ a", "e r", "Ġ c", "a t", "Ġc at", "o n", "Ġ o",
          "Ġo n", "Ġ i", "Ġi s", "l l", "e ll", "h ell", "hell o", "Ġ w", "o r", "Ġw or",
          "Ġwor l", "Ġworl d", "Ã ©", "1 2", "Ċ Ċ"]


def bpe_vocab() -> dict:
    tokens = list(bytes_to_unicode().values())
    tokens += ["".join(m.split(" ")) for m in MERGES]
    types = [int(TokenType.NORMAL)] * len(tokens)
    specials = ["<|begin_of_text|>", "<|end_of_text|>", "<|eot_id|>"]
    tokens += specials
    types += [int(TokenType.CONTROL)] * len(specials)
    n = len(tokens)
    return {
        K.MODEL: "gpt2", K.PRE: "llama-bpe", K.TOKENS: tokens, K.MERGES: MERGES,
        K.TOKEN_TYPE: np.asarray(types, np.int32),
        K.BOS_ID: np.uint32(n - 3), K.EOS_ID: np.uint32(n - 2), K.EOT_ID: np.uint32(n - 1),
        K.ADD_BOS: True,
    }


VOCABS = {"spm": tiny_spm_vocab(300), "bpe": bpe_vocab()}
TEXTS = [
    "the cat is on the mat",
    "  leading spaces and  double",
    "tab\tnewline\n\nend",
    "números àéîõü café",
    "日本語のテキスト 🙂 emoji",
    "hello world 1234 12",
    "<s>the</s> that",
    "<|begin_of_text|>hello<|eot_id|> world<|end_of_text|>",
    "",
    "a",
    "\x00\x7f   control bytes",
    "THE ING and thethe",
]


@pytest.fixture(scope="module", params=sorted(VOCABS))
def pair(request):
    md = VOCABS[request.param]
    return Tokenizer.from_gguf(md), JaxTokenizer.from_gguf(md)


@pytest.mark.parametrize("parse_special", [True, False], ids=["parse", "noparse"])
@pytest.mark.parametrize("add_special", [True, False], ids=["bos", "nobos"])
@pytest.mark.parametrize("text", TEXTS, ids=range(len(TEXTS)))
def test_encode_and_decode_equal(pair, text, add_special, parse_special):
    tok, jtok = pair
    ids = tok.encode(text, add_special=add_special, parse_special=parse_special)
    assert ids == jtok.encode(text, add_special=add_special, parse_special=parse_special)
    assert tok.decode(ids) == jtok.decode(ids)
    assert tok.decode(ids, skip_special=True) == jtok.decode(ids, skip_special=True)


def test_every_piece_and_flag_equal(pair):
    tok, jtok = pair
    n = len(tok.vocab.tokens)
    assert n == len(jtok.vocab.tokens)
    assert [tok.piece(i) for i in range(n)] == [jtok.piece(i) for i in range(n)]
    assert [tok.is_eog(i) for i in range(n)] == [jtok.is_eog(i) for i in range(n)]
    assert (tok.bos_id, tok.eos_id) == (jtok.bos_id, jtok.eos_id)
    assert any(tok.is_eog(i) for i in range(n))


def test_special_tokens_are_single_ids_only_when_parsed(pair):
    tok, _ = pair
    special = tok.piece(tok.eos_id)
    assert tok.encode(special, add_special=False, parse_special=True) == [tok.eos_id]
    assert tok.encode(special, add_special=False, parse_special=False) != [tok.eos_id]


def test_byte_fallback_round_trips(pair):
    tok, _ = pair
    text = "zürich → 東京"
    ids = tok.encode(text, add_special=False, parse_special=False)
    assert tok.decode(ids).strip() == text


_PAIRS: dict = {}


@pytest.mark.parametrize("name", sorted(VOCABS))
@settings(derandomize=True, max_examples=150, deadline=None)
@given(text=st.text(max_size=40))
def test_random_text_equal(name, text):
    if name not in _PAIRS:  # hypothesis calls the body many times: build once
        _PAIRS[name] = (Tokenizer.from_gguf(VOCABS[name]), JaxTokenizer.from_gguf(VOCABS[name]))
    tok, jtok = _PAIRS[name]
    ids = tok.encode(text, add_special=True, parse_special=True)
    assert ids == jtok.encode(text, add_special=True, parse_special=True)
    assert tok.decode(ids) == jtok.decode(ids)


def test_bpe_without_regex_says_so(monkeypatch):
    """The pre-tokenizer patterns need the third-party `regex`; without it a
    BPE vocab raises an error that names it, and the SPM path still works."""
    import builtins

    real_import = builtins.__import__

    def no_regex(name, *a, **kw):
        if name == "regex":
            raise ImportError("No module named 'regex'")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_regex)
    with pytest.raises(ImportError, match="regex"):
        Tokenizer.from_gguf(VOCABS["bpe"])
    assert Tokenizer.from_gguf(VOCABS["spm"]).encode("the cat")
