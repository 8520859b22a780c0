"""The port's measurement tools against the JAX package's on the CPU:
tools/perplexity.py (perplexity, KL divergence, continuation log-probs,
multiple-choice and winogrande scoring, and its entry point),
tools/bench_tool.py (llama-bench: markdown and JSON rows, the batched grid;
both entry points with --no-quant too)
and tools/results.py (record, then check with no drift). Values agree to
1e-3 relative: the two packages' logits differ by an NMSE under 1e-3.

Fixtures: the Q4_K llama whose weights the JAX package's quantizer made
(2 layers, n_embd 512, 4/2 heads of 128, n_ff 1024, vocab 512) for the
scores, the bench-shaped Q4_K_M fixture of the same size for the entry
points."""

import json

import numpy as np
import pytest
import torch

from llama_cpp_tpu.models.loader import load_model as jax_load_model
from llama_cpp_tpu.runtime.context import Context as JaxContext
from llama_cpp_tpu.testing import make_tiny_llama_gguf as jax_make_tiny
from llama_cpp_tpu.tools import bench_tool as jbench
from llama_cpp_tpu.tools import perplexity as jppl
from llama_cpp_tpu.tools import results as jresults
from llama_cpp_tpu_torch.models.loader import load_model
from llama_cpp_tpu_torch.runtime.context import Context
from llama_cpp_tpu_torch.testing import make_bench_llama_gguf
from llama_cpp_tpu_torch.tools import bench_tool, perplexity, results

CTX = dict(n_ctx=128, n_seqs=1, n_ubatch=64)



@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tests run a 2-layer model one small step at a time: under
    pytest-xdist's workers on a shared CPU, torch's thread pool spends far
    more than the work on waking its threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def q4k(tmp_path_factory):
    path = jax_make_tiny(str(tmp_path_factory.mktemp("torch_tools") / "q4k.gguf"),
                         vocab_size=512, n_layers=2, n_embd=512, n_heads=4, n_kv_heads=2,
                         n_ff=1024, ftype="q4_k", seed=3)
    return path, load_model(path, device="cpu"), jax_load_model(path)


@pytest.fixture(scope="module")
def bench_gguf(tmp_path_factory):
    return make_bench_llama_gguf(str(tmp_path_factory.mktemp("torch_tools_bench") / "b.gguf"),
                                 n_layers=2, n_embd=512, n_heads=4, n_kv_heads=2, n_ff=1024,
                                 vocab_size=512, seed=0)


def tokens(n, seed=0):
    return [int(t) for t in np.random.default_rng(seed).integers(3, 512, n)]


def rel(a, b):
    return abs(a - b) / abs(b)


def test_perplexity_matches_jax(q4k):
    _, model, jmodel = q4k
    toks = tokens(300)  # two chunks of 128, each in two ubatches of 64
    got = perplexity.perplexity(Context(model, device="cpu", **CTX), tokens=toks, n_ctx=128)
    ref = jppl.perplexity(JaxContext(jmodel, **CTX), tokens=toks, n_ctx=128)
    assert got.n_tokens == ref.n_tokens == 2 * 63
    assert rel(got.ppl, ref.ppl) < 1e-3 and rel(got.nll_sum, ref.nll_sum) < 1e-3
    assert rel(got.ppl_err, ref.ppl_err) < 1e-2


def test_kl_divergence_matches_jax(q4k):
    """Both tools against one set of base logits (the JAX package's with
    seeded noise, so the divergence is not near zero)."""
    _, model, jmodel = q4k
    toks = tokens(256, seed=1)
    jctx = JaxContext(jmodel, **CTX)
    base = np.concatenate([jppl.eval_chunk_logits(jctx, toks[i:i + 128]) for i in (0, 128)])
    base = base + np.random.default_rng(2).standard_normal(base.shape).astype(np.float32)
    got = perplexity.kl_divergence(Context(model, device="cpu", **CTX), toks, base, n_ctx=128)
    ref = jppl.kl_divergence(jctx, toks, base, n_ctx=128)
    assert ref["kl_mean"] > 0.1
    for key in ("kl_mean", "kl_p99"):
        assert rel(got[key], ref[key]) < 1e-3, key
    assert abs(got["same_top_frac"] - ref["same_top_frac"]) <= 2 / 254


def test_continuation_logprob_matches_jax(q4k):
    _, model, jmodel = q4k
    context, cont = tokens(30, seed=3), tokens(6, seed=4)
    got = perplexity.continuation_logprob(Context(model, device="cpu", **CTX), context, cont)
    ref = jppl.continuation_logprob(JaxContext(jmodel, **CTX), context, cont)
    assert rel(got, ref) < 1e-3


def test_choice_scores_match_jax(q4k):
    _, model, jmodel = q4k
    mc = [{"context": "the cat sat", "endings": ["on the mat", "in a hat", "a dog", "x"],
           "label": 1}, {"context": "a b c", "endings": ["d e", "f", "g h i", "j"], "label": 0}]
    wg = [{"sentence": "the cat _ on the mat", "option1": "sat", "option2": "ran",
           "answer": 1}]
    ctx, jctx = Context(model, device="cpu", **CTX), JaxContext(jmodel, **CTX)
    assert (perplexity.multiple_choice_score(ctx, mc)
            == jppl.multiple_choice_score(jctx, mc))
    assert perplexity.winogrande_score(ctx, wg) == jppl.winogrande_score(jctx, wg)


def test_perplexity_entry_point_matches_jax(q4k, tmp_path, capsys):
    path, model, _ = q4k
    text = " ".join(model.tokenizer.piece(t).strip() or "a" for t in tokens(400, seed=5))
    corpus = tmp_path / "corpus.txt"
    corpus.write_text(text)
    capsys.readouterr()
    assert perplexity.main(["-m", path, "-f", str(corpus), "-c", "128", "--device",
                            "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    jppl.main(["-m", path, "-f", str(corpus), "-c", "128"])
    jout = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith("PPL = ") and len(out) == len(jout) >= 3
    ppl, jval = float(out[-1].split()[2]), float(jout[-1].split()[2])
    assert rel(ppl, jval) < 1e-3 and out[-1].split()[-2] == jout[-1].split()[-2]
    # --no-quant: dense bf16 weights in both packages
    assert perplexity.main(["-m", path, "-f", str(corpus), "-c", "128", "--no-quant",
                            "--device", "cpu"]) == 0
    dense = capsys.readouterr().out.strip().splitlines()
    jppl.main(["-m", path, "-f", str(corpus), "-c", "128", "--no-quant"])
    jdense = capsys.readouterr().out.strip().splitlines()
    assert dense[-1].startswith("PPL = ") and len(dense) == len(jdense)
    assert rel(float(dense[-1].split()[2]), float(jdense[-1].split()[2])) < 1e-3
    assert float(dense[-1].split()[2]) != ppl


def test_bench_tool_prints_markdown_and_json_rows(bench_gguf, capsys):
    argv = ["-m", bench_gguf, "-p", "64", "-n", "8", "-c", "256", "--device", "cpu"]
    capsys.readouterr()
    assert bench_tool.main(argv) == 0
    md = capsys.readouterr().out.strip().splitlines()
    assert md[0] == "| test | t/s |" and md[1] == "|---|---|" and len(md) == 4
    assert md[2].startswith("| pp64 | ") and md[3].startswith("| tg8 | ")
    assert all(float(line.split("|")[2]) > 0 for line in md[2:])
    assert bench_tool.main(argv + ["-o", "json", "-d", "16"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["model"] == bench_gguf
    assert [r["test"] for r in doc["results"]] == ["pp64", "tg8@d16"]
    assert all(r["t/s"] > 0 for r in doc["results"])
    assert bench_tool.main(argv + ["--batched", "-b", "1,2", "-o", "json"]) == 0
    rows = json.loads(capsys.readouterr().out)["results"]
    assert [(r["PP"], r["TG"], r["B"]) for r in rows] == [(64, 8, 1), (64, 8, 2)]
    assert all(r["S_PP t/s"] > 0 and r["S_TG t/s"] > 0 for r in rows)
    # --no-quant: the JAX tool's rows (test names and counts) over dense weights
    assert bench_tool.main(argv + ["--no-quant", "-o", "json"]) == 0
    dense = json.loads(capsys.readouterr().out)["results"]
    jbench.main(argv[:-2] + ["--no-quant", "-o", "json"])
    jdense = json.loads(capsys.readouterr().out)["results"]
    assert [r["test"] for r in dense] == [r["test"] for r in jdense] == ["pp64", "tg8"]
    assert all(r["t/s"] > 0 for r in dense)


def test_bench_tg_runs_the_on_device_loop(bench_gguf):
    model = load_model(bench_gguf, device="cpu")
    ctx = Context(model, n_ctx=256, n_seqs=1, device="cpu")
    assert bench_tool.bench_tg(ctx, 8, n_rep=1) > 0
    assert ctx.perf.n_decode == 8 and [batch for batch, _ in ctx._loops] == [1]


def test_results_record_then_check_reports_no_drift(bench_gguf, tmp_path, capsys):
    base = tmp_path / "base.json"
    assert results.main(["-m", bench_gguf, "-o", str(base), "-n", "8", "--device",
                         "cpu"]) == 0
    snap = json.loads(base.read_text())
    ref = jresults.snapshot(bench_gguf, n_tokens=8)
    assert [s["tokens"] for s in snap] == [r["tokens"] for r in ref]
    for s, r in zip(snap, ref):
        np.testing.assert_allclose(s["logits_head"], r["logits_head"], rtol=0, atol=5e-2)
    capsys.readouterr()
    assert results.main(["-m", bench_gguf, "--check", str(base), "-n", "8", "--device",
                         "cpu"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report == {"n": 3, "token_mismatches": 0, "max_logit_drift": 0.0, "ok": True}
    snap[0]["tokens"][-1] += 1
    base.write_text(json.dumps(snap))
    assert results.main(["-m", bench_gguf, "--check", str(base), "-n", "8", "--device",
                         "cpu"]) == 1
