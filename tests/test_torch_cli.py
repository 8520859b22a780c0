"""The port's command-line tools against the JAX package's on the same GGUF:
tools/cli.py prints the same greedy text, tools/tokenize.py the same lines;
the port's sampled text repeats under a seed and equals Context.generate with
the same sampler; a grammar-constrained run prints the JAX CLI's text;
every flag whose module is not ported (multimodal input) exits with 2 and
names itself. Torch runs on one thread here: under pytest-xdist's workers
on a shared CPU its thread pool cost these small steps far more than the
work."""

import numpy as np
import pytest
import torch

from llama_cpp_tpu.testing import make_tiny_llama_gguf as jax_make_tiny
from llama_cpp_tpu.tools import cli as jax_cli
from llama_cpp_tpu.tools import tokenize as jax_tokenize
from llama_cpp_tpu_torch.models.loader import load_model
from llama_cpp_tpu_torch.runtime.context import Context
from llama_cpp_tpu_torch.sampling.samplers import SamplerChain, SamplingParams
from llama_cpp_tpu_torch.testing import make_bench_llama_gguf
from llama_cpp_tpu_torch.tools import cli, tokenize

SHAPE = dict(n_layers=2, n_embd=512, n_heads=4, n_kv_heads=2, n_ff=1024, vocab_size=512,
             seed=0)
PROMPT = "the cat is on the mat and that was it"


@pytest.fixture(scope="module")
def bench_gguf(tmp_path_factory):
    return make_bench_llama_gguf(str(tmp_path_factory.mktemp("torch_cli") / "bench.gguf"),
                                 **SHAPE)


@pytest.fixture(scope="module")
def q4k_gguf(tmp_path_factory):
    """Weights from the JAX package's quantizer: its greedy and sampled ids
    vary, where the bench fixture's synthetic payload settles on one token."""
    return jax_make_tiny(str(tmp_path_factory.mktemp("torch_cli_q4k") / "q4k.gguf"),
                         vocab_size=512, n_layers=2, n_embd=512, n_heads=4, n_kv_heads=2,
                         n_ff=1024, ftype="q4_k", seed=3)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def q4k_model(q4k_gguf):
    """One load of the quantizer-weights file for the cases that only read it."""
    return load_model(q4k_gguf, device="cpu")


def run(main, argv, capsys):
    capsys.readouterr()
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16_kv", "int8_kv"])
def test_greedy_text_equals_the_jax_cli(bench_gguf, capsys, kv_quant):
    argv = ["-m", bench_gguf, "-p", PROMPT, "-n", "12", "-c", "256", "--temp", "0"]
    argv += ["--kv-quant"] if kv_quant else []
    rc, out, err = run(cli.main, argv + ["--device", "cpu"], capsys)
    jrc, jout, _ = run(jax_cli.main, argv, capsys)
    assert rc == jrc == 0
    assert out == jout and len(out.split()) == 12
    assert "perf: prompt" in err and "tok/s; gen" in err


def test_greedy_text_on_quantizer_weights_equals_generate(q4k_gguf, q4k_model, capsys):
    argv = ["-m", q4k_gguf, "-p", PROMPT, "-n", "16", "-c", "256", "--temp", "0",
            "--device", "cpu", "--verbose-prompt"]
    rc, out, err = run(cli.main, argv, capsys)
    model = q4k_model
    tok = model.tokenizer
    ids = tok.encode(PROMPT, add_special=True, parse_special=True)
    gen = Context(model, n_ctx=256, device="cpu").generate(ids, 16)
    assert rc == 0 and out == "".join(tok.piece(t) for t in gen) + "\n"
    assert len(set(gen)) > 1
    assert err.count(" -> ") == len(ids)  # --verbose-prompt lists the prompt's tokens


def test_sampled_text_repeats_under_a_seed_and_equals_generate(q4k_gguf, q4k_model, capsys):
    argv = ["-m", q4k_gguf, "-p", PROMPT, "-n", "16", "-c", "256", "--temp", "0.8", "--seed",
            "7", "--device", "cpu"]
    rc, first, _ = run(cli.main, argv, capsys)
    _, second, _ = run(cli.main, argv, capsys)
    _, other, _ = run(cli.main, argv[:-4] + ["--seed", "8", "--device", "cpu"], capsys)
    assert rc == 0 and first == second and first != other
    model = q4k_model
    tok = model.tokenizer
    sampler = SamplerChain.from_params(SamplingParams(temp=0.8, seed=7), tok.vocab)
    streamed = []
    gen = Context(model, n_ctx=256, device="cpu").generate(
        tok.encode(PROMPT, add_special=True, parse_special=True), 16, sampler=sampler,
        stream=streamed.append)
    assert streamed == gen
    assert first == "".join(tok.piece(t) for t in gen if not tok.is_eog(t)) + "\n"


def test_generate_stops_where_asked(q4k_model):
    model = q4k_model
    ids = model.tokenizer.encode(PROMPT)
    free = Context(model, n_ctx=256, device="cpu").generate(ids, 12)
    stop_at = free[4]
    cut = Context(model, n_ctx=256, device="cpu").generate(ids, 12,
                                                            stop_fn=lambda t: t == stop_at)
    assert cut == free[: free.index(stop_at) + 1]
    short = Context(model, n_ctx=len(ids) + 3, device="cpu").generate(ids, 12)
    assert short == free[: len(short)] and 1 <= len(short) <= 4
    greedy_chain = SamplerChain.from_params(SamplingParams(temp=0.0))
    assert Context(model, n_ctx=256, device="cpu").generate(ids, 12,
                                                           sampler=greedy_chain) == free


def test_eog_token_ends_generation(q4k_model, capsys):
    """The vocab's EOS is the greedy token of no step here, so the third
    generated token is declared end-of-generation: it is returned, and
    nothing after it."""
    model = q4k_model
    ids = model.tokenizer.encode(PROMPT)
    free = Context(model, n_ctx=256, device="cpu").generate(ids, 6)
    eog = model.tokenizer.vocab._eog
    added = free[2] not in eog
    eog.add(free[2])
    try:
        assert Context(model, n_ctx=256, device="cpu").generate(ids, 6) == free[:3]
    finally:
        if added:
            eog.discard(free[2])


NOT_PORTED = [["--mmproj", "mm.gguf"], ["--image", "a.png"]]


GRAMMAR = 'root ::= (" w" [0-9]+)+'
GRAMMAR_FLAGS = {"--grammar": GRAMMAR, "--grammar-file": GRAMMAR,
                 "--json-schema": '{"type": "array", "items": {"type": "integer"}}'}


def jax_constrained_text(path, grammar_text, n):
    """The JAX CLI's grammar loop (llama_cpp_tpu/tools/cli.py:208-235),
    greedy, over the JAX package's Context, sampler chain and grammar. Run
    here rather than through jax_cli.main, whose loop masks the read-only
    array that np.asarray makes of a JAX array, and raises."""
    from llama_cpp_tpu.models.loader import load_model as jax_load_model
    from llama_cpp_tpu.runtime.context import Context as JaxContext
    from llama_cpp_tpu.sampling.grammar import GrammarSampler as JaxGrammarSampler
    from llama_cpp_tpu.sampling.samplers import SamplerChain as JaxChain
    from llama_cpp_tpu.sampling.samplers import SamplingParams as JaxParams

    model = jax_load_model(path)
    tok = model.tokenizer
    ctx = JaxContext(model, n_ctx=256)
    chain = JaxChain.from_params(JaxParams(temp=0.0, grammar=grammar_text), tok.vocab)
    gs = JaxGrammarSampler(grammar_text, tok)
    logits = ctx.prefill(tok.encode(PROMPT, add_special=True, parse_special=True))
    text = ""
    for _ in range(n):
        token = chain.sample(gs.filter_logits(np.array(logits, dtype=np.float32)))
        gs.accept(token)
        if tok.is_eog(token):
            break
        text += tok.piece(token)
        if ctx.seq_len[0] >= ctx.n_ctx - 1:
            break
        logits = ctx.decode_one(token)
    return text + "\n"


@pytest.mark.parametrize("flag", list(GRAMMAR_FLAGS))
def test_grammar_constrained_text_equals_the_jax_cli(q4k_gguf, capsys, tmp_path, flag):
    """A GBNF grammar given as text, as a file or as a JSON schema: the
    port's CLI prints the JAX CLI loop's constrained greedy text, which the
    grammar accepts and the free run does not give."""
    from llama_cpp_tpu_torch.sampling.grammar import GBNFParser
    from llama_cpp_tpu_torch.sampling.json_schema import schema_to_gbnf

    value = GRAMMAR_FLAGS[flag]
    text = GRAMMAR if flag != "--json-schema" else schema_to_gbnf(value)
    if flag == "--grammar-file":
        (tmp_path / "g.gbnf").write_text(value, encoding="utf-8")
        value = str(tmp_path / "g.gbnf")
    argv = ["-m", q4k_gguf, "-p", PROMPT, "-n", "6", "-c", "256", "--temp", "0",
            "--device", "cpu"]
    rc, out, _ = run(cli.main, argv + [flag, value], capsys)
    _, free, _ = run(cli.main, argv, capsys)
    assert rc == 0 and out == jax_constrained_text(q4k_gguf, text, 6) and len(out) > 1
    assert GBNFParser().parse(text).would_accept(out[:-1]) and out != free


@pytest.mark.parametrize("flag", NOT_PORTED, ids=[f[0] for f in NOT_PORTED])
def test_unported_flag_exits_with_2_and_names_itself(bench_gguf, capsys, flag):
    rc, out, err = run(cli.main, ["-m", bench_gguf, "-p", "the", "--device", "cpu", *flag],
                       capsys)
    assert rc == 2 and out == ""
    assert flag[0] in err and "not ported" in err


def test_cli_needs_a_card_unless_asked_for_the_cpu(bench_gguf, capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-m", bench_gguf, "-p", "the", "-n", "1"])


def test_cli_reads_the_prompt_from_a_file_and_asks_for_one(bench_gguf, capsys, tmp_path):
    (tmp_path / "p.txt").write_text(PROMPT, encoding="utf-8")
    base = ["-m", bench_gguf, "-n", "4", "-c", "256", "--temp", "0", "--device", "cpu"]
    _, from_file, _ = run(cli.main, base + ["-f", str(tmp_path / "p.txt")], capsys)
    _, from_flag, _ = run(cli.main, base + ["-p", PROMPT], capsys)
    assert from_file == from_flag
    rc, _, err = run(cli.main, base, capsys)
    assert rc == 1 and "need -p or -f" in err


@pytest.mark.parametrize("extra", [[], ["--ids"], ["--no-bos", "--show-count"],
                                   ["--no-parse-special"]], ids=["pieces", "ids", "nobos", "raw"])
def test_tokenize_tool_prints_the_same_lines(bench_gguf, capsys, extra):
    argv = ["-m", bench_gguf, "-p", "<s>the cat is on the mät</s>", *extra]
    ids, out, _ = run(tokenize.main, argv, capsys)
    jids, jout, _ = run(jax_tokenize.main, argv, capsys)
    assert ids == jids and out == jout and out
    assert np.all(np.asarray(ids) >= 0)
