"""The PyTorch port's llama main path against the JAX package on the CPU:
the bench-shaped Q4_K_M fixture at a small size (2 layers, n_embd 512, 4/2
heads of 128, n_ff 1024, vocab 512), a paged pool of 256-row pages, bf16
and int8 KV.

Prefill logits agree to NMSE < 1e-3 and greedy token ids are identical,
at B=1 and through decode_steps_greedy; the port holds each fixture's
bytes, planes and pool in agreement with the JAX package, so a greedy
mismatch is a fault, not noise."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from llama_cpp_tpu.models.loader import load_model as jax_load_model
from llama_cpp_tpu.runtime.context import Context as JaxContext
from llama_cpp_tpu.testing import make_bench_llama_gguf as jax_make_bench
from llama_cpp_tpu.testing import make_tiny_llama_gguf as jax_make_tiny
from llama_cpp_tpu_torch.models.from_jax import kv_cache_from_jax, params_from_jax
from llama_cpp_tpu_torch.models.loader import Model, load_model
from llama_cpp_tpu_torch.runtime.context import Context
from llama_cpp_tpu_torch.testing import make_bench_llama_gguf

SHAPE = dict(n_layers=2, n_embd=512, n_heads=4, n_kv_heads=2, n_ff=1024, vocab_size=512,
             seed=0)
CTX = dict(n_ctx=256, n_seqs=6, n_ubatch=64)
KV = pytest.mark.parametrize("quantized", [False, True], ids=["bf16_kv", "int8_kv"])
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def fixture_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_model")
    return (make_bench_llama_gguf(str(d / "port.gguf"), **SHAPE),
            jax_make_bench(str(d / "jax.gguf"), **SHAPE))


@pytest.fixture(scope="module")
def models(fixture_paths):
    return load_model(fixture_paths[0], device="cpu"), jax_load_model(fixture_paths[1])


@pytest.fixture(scope="module")
def quantized_models(tmp_path_factory):
    """A Q4_K model whose weights the JAX package's quantizer made from
    random values: the bench fixture's synthetic payload repeats across
    tensors and its greedy ids settle on one token, this one's do not."""
    path = jax_make_tiny(str(tmp_path_factory.mktemp("torch_q4k") / "q4k.gguf"),
                         vocab_size=512, n_layers=2, n_embd=512, n_heads=4, n_kv_heads=2,
                         n_ff=1024, ftype="q4_k", seed=3)
    return load_model(path, device="cpu"), jax_load_model(path)


def jax_greedy(jctx, prompt, n, seq=0):
    logits, ids = jctx.prefill(prompt, seq=seq), []
    for _ in range(n):
        ids.append(int(np.argmax(logits)))
        logits = jctx.decode_one(ids[-1], seq=seq)
    return ids


def prompts(n, length, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(3, 512, length)] for _ in range(n)]


def nmse(got, ref):
    return float(np.mean((got - ref) ** 2) / np.mean(ref ** 2))


def test_bench_fixture_bytes_match_jax(fixture_paths):
    with open(fixture_paths[0], "rb") as a, open(fixture_paths[1], "rb") as b:
        assert a.read() == b.read()


def test_loader_fuses_the_q4_k_m_mix(models):
    model, _ = models
    lw = model.params["layers"][0]
    assert set(lw) == {"attn_norm", "attn_qk", "attn_v", "attn_output", "ffn_norm",
                       "ffn_gateup", "ffn_down"}
    assert lw["attn_qk"].packed and lw["attn_qk"].mins is not None  # Q4_K
    assert not lw["attn_v"].packed and lw["attn_v"].mins is None  # Q6_K
    assert lw["attn_qk"].q.shape == (256, 512 + 256)
    assert lw["ffn_gateup"].q.shape == (256, 2048)
    assert model.params["output"].out_features == 512
    assert model.device == torch.device("cpu")


@KV
def test_prefill_logits_match_jax(models, quantized):
    model, jmodel = models
    prompt = prompts(1, 100)[0]  # two ubatches of 64
    got = Context(model, quantized_kv=quantized, device="cpu", **CTX).prefill(prompt)
    jctx = JaxContext(jmodel, quantized_kv=quantized, **CTX)
    ref = jctx.prefill(prompt)
    assert jctx.page == 256 and got.shape == ref.shape == (512,)
    assert nmse(got, ref) < 1e-3


@KV
def test_greedy_b1_matches_jax(models, quantized):
    model, jmodel = models
    prompt = prompts(1, 40, seed=1)[0]
    got = Context(model, quantized_kv=quantized, device="cpu", **CTX).generate(prompt, 16)
    assert got == jax_greedy(JaxContext(jmodel, quantized_kv=quantized, **CTX), prompt, 16)


@KV
def test_teacher_forced_steps_with_quantizer_weights_match_jax(quantized_models, quantized):
    """Both packages consume the JAX package's greedy ids (fused q|k|v Q4_K
    planes). Each step's logits agree to NMSE < 1e-3, and the argmax agrees
    at every step whose JAX top-2 gap exceeds 0.1: the two sum f32
    products in different orders and XLA keeps some fused intermediates
    above bf16 precision, which moves logits by a few 1e-2 on this model,
    so a closer near-tie may part the free-running greedy ids."""
    model, jmodel = quantized_models
    prompt = prompts(1, 40, seed=6)[0]
    ctx = Context(model, quantized_kv=quantized, device="cpu", **CTX)
    jctx = JaxContext(jmodel, quantized_kv=quantized, **CTX)
    got, ref = ctx.prefill(prompt), jctx.prefill(prompt)
    decided = 0
    for _ in range(16):
        assert nmse(got, ref) < 1e-3
        top2 = np.sort(ref)[-2:]
        if top2[1] - top2[0] > 0.1:
            assert int(np.argmax(got)) == int(np.argmax(ref))
            decided += 1
        tok = int(np.argmax(ref))
        got, ref = ctx.decode_one(tok), jctx.decode_one(tok)
    assert decided >= 8


@KV
def test_decode_steps_greedy_rows_are_independent(quantized_models, quantized):
    """decode_steps_greedy at B = 3 (one trash pad row in the [4] bucket)
    gives each sequence the ids of its own B = 1 greedy decode."""
    model, _ = quantized_models
    ps = prompts(3, 40, seed=6)
    ctx = Context(model, quantized_kv=quantized, device="cpu", **CTX)
    one = Context(model, quantized_kv=quantized, device="cpu", **CTX)
    first, ref = [], []
    for s, p in enumerate(ps):
        p = p[: 24 + 4 * s]
        first.append(int(np.argmax(ctx.prefill(p, seq=s))))
        ref.append(one.generate(p, 9, seq=s)[1:])
    got = ctx.decode_steps_greedy(np.asarray(first), np.arange(3), 8)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert len(set(got.reshape(-1).tolist())) > 6


@pytest.mark.parametrize("batch", [3, 4])  # 3 pads the [4] bucket with a trash row
@KV
def test_decode_steps_greedy_matches_jax(models, quantized, batch):
    """Batched greedy decode on the device against the JAX package's greedy
    stepping of each sequence. XLA:CPU has no bf16 x bf16 -> f32 dot for
    the JAX batched decode step (B >= 2, T = 1), so the JAX side decodes
    each sequence at B = 1; every row of the step is independent of the
    others."""
    model, jmodel = models
    ctx = Context(model, quantized_kv=quantized, device="cpu", **CTX)
    jctx = JaxContext(jmodel, quantized_kv=quantized, **CTX)
    first, ref = [], []
    for s, p in enumerate(prompts(batch, 40, seed=2)):
        p = p[: 20 + 6 * s]  # ragged depths
        a, logits = ctx.prefill(p, seq=s), jctx.prefill(p, seq=s)
        first.append(int(np.argmax(a)))
        ids = [int(np.argmax(logits))]
        for _ in range(8):
            ids.append(int(np.argmax(jctx.decode_one(ids[-1], seq=s))))
        ref.append(ids[1:])
    got = ctx.decode_steps_greedy(np.asarray(first), np.arange(batch), 8)
    assert got.shape == (batch, 8)
    np.testing.assert_array_equal(got, np.asarray(ref))
    np.testing.assert_array_equal(ctx.seq_len, jctx.seq_len[: len(ctx.seq_len)])


def test_from_jax_params_give_the_same_logits(models, fixture_paths):
    model, jmodel = models
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jmodel.params), device="cpu")
    converted = Model(model.cfg, params, torch.device("cpu"))
    prompt = prompts(1, 30, seed=3)[0]
    a = Context(model, quantized_kv=True, device="cpu", **CTX).prefill(prompt)
    b = Context(converted, quantized_kv=True, device="cpu", **CTX).prefill(prompt)
    np.testing.assert_array_equal(a, b)


def test_seq_ops_and_multi_step_match_jax(models):
    """seq_cp / seq_rm, then one continuous-batching step over three
    sequences (the JAX side steps each at B = 1, see above)."""
    model, jmodel = models
    ctx = Context(model, quantized_kv=True, device="cpu", **CTX)
    jctx = JaxContext(jmodel, quantized_kv=True, **CTX)
    p0, p1 = prompts(2, 30, seed=4)
    for c in (ctx, jctx):
        c.prefill(p0, seq=0)
        c.prefill(p1, seq=1)
        c.seq_cp(2, 0)  # seq 2 continues seq 0's pages
        c.seq_rm(1, 20)  # drop seq 1's suffix from position 20
    np.testing.assert_array_equal(ctx.alloc.table, jctx.alloc.table)
    np.testing.assert_array_equal(ctx.seq_len, jctx.seq_len)
    got = ctx.decode_step_multi(np.array([5, 6, 7]), np.array([0, 1, 2]))
    ref = np.stack([jctx.decode_one(t, seq=s) for s, t in enumerate((5, 6, 7))])
    assert nmse(got, ref) < 1e-3
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
    np.testing.assert_array_equal(ctx.seq_len, jctx.seq_len)
    ctx.reset()
    assert ctx.seq_len.sum() == 0 and ctx.alloc.n_free == ctx.alloc.n_pages - 1


def test_plain_path_equals_kernel_route_on_cpu(models):
    """kernels=False is the reference a card run is held against; on the
    CPU the kernel route takes the same plain versions."""
    model, _ = models
    prompt = prompts(1, 50, seed=5)[0]
    a = Context(model, quantized_kv=True, device="cpu", **CTX).prefill(prompt)
    b = Context(model, quantized_kv=True, device="cpu", kernels=False, **CTX).prefill(prompt)
    np.testing.assert_array_equal(a, b)


def test_entry_points_need_a_card_unless_cpu_is_asked(models, fixture_paths):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_model(fixture_paths[0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Context(models[0])


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, and chip_smoke.py, in a fresh interpreter."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import llama_cpp_tpu_torch.tokenizer\n"
        "assert 'regex' not in sys.modules, 'the tokenizer package imported regex'\n"
        "import llama_cpp_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "for new in ('ops.kernels.qmm_expert', 'ops.kernels.flash_attn', 'runtime.kv_cache',\n"
        "            'models.from_jax', 'models.transformer', 'testing',\n"
        "            'ops.kernels.qmm_bench', 'utils.timing', 'utils.logging', 'tools.bench_qmm',\n"
        "            'tools.cli', 'tools.args', 'tools.tokenize', 'tools.conformance', 'tokenizer.bpe',\n"
        "            'tokenizer.spm', 'tokenizer.vocab', 'sampling.samplers', 'runtime.decode_graph',\n"
        "            'tools.bench_tool', 'tools.perplexity', 'tools.results', 'tools.decode_wall'):\n"
        "    assert 'llama_cpp_tpu_torch.' + new in sys.modules, new\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'llama_cpp_tpu' or m.startswith('llama_cpp_tpu.')]\n"
        "assert not bad, bad\n"
        "assert 'regex' not in sys.modules, 'a module of the port imported regex'\n"
        "print('clean', len([m for m in sys.modules if m.startswith('llama_cpp_tpu_torch')]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


# -- the slot-table cache (Context(paged=False)) -----------------------------

@KV
def test_slot_table_prefill_and_greedy_match_jax(models, quantized):
    """The llama fixture on the slot-table cache against the JAX package's
    Context(paged=False), and against the port's own paged context."""
    model, jmodel = models
    prompt = prompts(1, 100, seed=7)[0]  # two ubatches of 64
    ctx = Context(model, quantized_kv=quantized, device="cpu", paged=False, **CTX)
    jctx = JaxContext(jmodel, quantized_kv=quantized, paged=False, **CTX)
    assert ctx.alloc is None and jctx.alloc is None
    assert ctx.kv.n_slots == jctx.kv.n_slots == ctx.n_slots and ctx.trash_slot == jctx.trash_slot
    got, ref = ctx.prefill(prompt), jctx.prefill(prompt)
    assert nmse(got, ref) < 1e-3
    paged = Context(model, quantized_kv=quantized, device="cpu", **CTX).prefill(prompt)
    assert nmse(got, paged) < 1e-6
    ids, jids = [], []
    for _ in range(8):
        ids.append(int(np.argmax(got)))
        jids.append(int(np.argmax(ref)))
        got, ref = ctx.decode_one(ids[-1]), jctx.decode_one(jids[-1])
    assert ids == jids
    live = np.asarray(jctx.kv.pos) >= 0
    np.testing.assert_array_equal(ctx.kv.pos.numpy() >= 0, live)
    if quantized:  # the same int8 rows in every live slot of every layer
        for li in range(2):
            np.testing.assert_array_equal(
                ctx.kv.k[li].numpy().transpose(0, 2, 1, 3)[live],
                np.asarray(jctx.kv.k[li]).transpose(0, 2, 1, 3)[live])


def test_slot_table_batched_decode_and_seq_ops_match_jax(quantized_models):
    """seq_cp / seq_rm / reset on the slot table, and decode_steps_greedy at
    B = 3 against the JAX package's B = 1 steps of each sequence (XLA:CPU has
    no bf16 x bf16 -> f32 dot for its batched step)."""
    model, jmodel = quantized_models
    ctx = Context(model, quantized_kv=True, device="cpu", paged=False, **CTX)
    jctx = JaxContext(jmodel, quantized_kv=True, paged=False, **CTX)
    p0, p1 = prompts(2, 30, seed=4)
    firsts = []
    for c in (ctx, jctx):
        a = c.prefill(p0, seq=0)
        b = c.prefill(p1, seq=1)
        c.seq_cp(2, 0)
        c.seq_rm(1, 20)
        firsts.append([int(np.argmax(a)), 5, int(np.argmax(a))])
    np.testing.assert_array_equal(ctx.seq_len, jctx.seq_len[: len(ctx.seq_len)])
    np.testing.assert_array_equal(ctx.kv.pos.numpy(), np.asarray(jctx.kv.pos))
    assert firsts[0] == firsts[1]
    ref = []
    for s in range(3):
        tok, ids = firsts[1][s], []
        for _ in range(6):
            tok = int(np.argmax(jctx.decode_one(tok, seq=s)))
            ids.append(tok)
        ref.append(ids)
    got = ctx.decode_steps_greedy(np.asarray(firsts[0]), np.arange(3), 6)
    np.testing.assert_array_equal(got, np.asarray(ref))
    np.testing.assert_array_equal(got[0], got[2])  # seq 2 is seq 0's copy
    ctx.reset()
    assert ctx.seq_len.sum() == 0 and int((ctx.kv.pos >= 0).sum()) == 0


def test_port_continues_a_jax_prefill_from_its_cache(models):
    """A JAX slot-table prefill carried across by kv_cache_from_jax: the
    port's next step gives the JAX package's next logits."""
    model, jmodel = models
    prompt = prompts(1, 50, seed=9)[0]
    jctx = JaxContext(jmodel, quantized_kv=True, paged=False, **CTX)
    tok = int(np.argmax(jctx.prefill(prompt)))
    ctx = Context(model, quantized_kv=True, device="cpu", paged=False, **CTX)
    ctx.kv = kv_cache_from_jax(jax.tree_util.tree_map(np.asarray, jctx.kv))
    ctx.seq_len[0] = len(prompt)
    got, ref = ctx.decode_one(tok), jctx.decode_one(tok)
    assert nmse(got, ref) < 1e-3 and int(np.argmax(got)) == int(np.argmax(ref))


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slots"])
def test_heads_of_64_match_jax(tmp_path, paged):
    """A narrow llama with 64-wide heads (n_embd 256, 4/2 heads) on both
    memories."""
    shape = dict(n_layers=2, n_embd=256, n_heads=4, n_kv_heads=2, n_ff=512, vocab_size=512,
                 seed=1)
    path = make_bench_llama_gguf(str(tmp_path / "d64.gguf"), **shape)
    model, jmodel = load_model(path, device="cpu"), jax_load_model(path)
    assert model.cfg.head_dim_k == 64
    prompt = prompts(1, 70, seed=10)[0]
    ctx = Context(model, quantized_kv=True, device="cpu", paged=paged, **CTX)
    jctx = JaxContext(jmodel, quantized_kv=True, paged=paged, **CTX)
    got, ref = ctx.prefill(prompt), jctx.prefill(prompt)
    assert nmse(got, ref) < 1e-3
    tok = int(np.argmax(ref))
    assert int(np.argmax(got)) == tok
    assert nmse(ctx.decode_one(tok), jctx.decode_one(tok)) < 1e-3
