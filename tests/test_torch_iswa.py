"""The port's interleaved sliding-window memory (runtime/kv_cache.py
ISWACache: full layers on the page pool or a slot table, window layers on
rings of slot = position % capacity) against a unified cache with window
masks and against the JAX package's ISWACache, on a small Gemma-3-shaped
fixture (2 layers: a window layer of 16 then a full layer; 4/2 heads of
128, n_embd 512, vocab 512, Q4_K/Q6_K).

Mirrors tests/test_engine.py (ISWA against the unified cache, a ring
smaller than the sequence) and tests/test_paged.py (the paged variant and
its sequence operations), and adds iswa_from_jax continuing a JAX prefill
and batched port decode against the JAX package's B=1 steps (XLA:CPU
cannot run its batched decode step)."""

import jax
import numpy as np
import pytest
import torch

from llama_cpp_tpu.models.loader import load_model as jax_load_model
from llama_cpp_tpu.runtime.context import Context as JaxContext
from llama_cpp_tpu.runtime.kv_cache import ISWACache as JaxISWACache
from llama_cpp_tpu_torch.models.from_jax import iswa_from_jax
from llama_cpp_tpu_torch.models.loader import Model, load_model
from llama_cpp_tpu_torch.runtime.context import Context
from llama_cpp_tpu_torch.runtime.kv_cache import ISWACache, KVCache
from llama_cpp_tpu_torch.runtime.paged_kv import PagedKVCache
from llama_cpp_tpu_torch.testing import make_bench_arch_gguf

WINDOW = 16
GEMMA3 = dict(n_layers=2, n_embd=512, n_heads=4, n_kv_heads=2, head_dim=128, n_ff=1024,
              vocab_size=512, n_ctx=512, tie=True, post_norms=True, qk_norm=True,
              sliding_window=WINDOW, swa_pattern=2, rope_base=1e6, rope_base_swa=1e4,
              rope_linear_factor=8.0)
CTX = dict(n_ctx=256, n_seqs=4, n_ubatch=32)
KV = pytest.mark.parametrize("quantized", [False, True], ids=["bf16_kv", "int8_kv"])


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = make_bench_arch_gguf(str(tmp_path_factory.mktemp("iswa") / "gemma3.gguf"),
                                "gemma3", **GEMMA3)
    return load_model(path, device="cpu"), jax_load_model(path)


def nmse(got, ref):
    return float(np.mean((got - ref) ** 2) / np.mean(ref ** 2))


def prompt(length, seed=0):
    return [int(t) for t in np.random.default_rng(seed).integers(3, 512, length)]


def jax_greedy(jctx, p, n, seq=0):
    logits, ids = jctx.prefill(p, seq=seq), []
    for _ in range(n):
        ids.append(int(np.argmax(logits)))
        logits = jctx.decode_one(ids[-1], seq=seq)
    return ids


def unified(model, quantized=False):
    """A paged=False context whose memory is one slot table for every
    layer: the window layers keep every position and are masked."""
    ctx = Context(model, paged=False, quantized_kv=quantized, device="cpu", **CTX)
    cfg = model.cfg
    ctx.kv = KVCache.create(cfg.n_layers, ctx.n_seqs, ctx.n_slots, cfg.n_kv_heads,
                            cfg.head_dim_k, quantized=quantized)
    return ctx


def small_ring(model, quantized=False, ring=64):
    """A paged=False ISWA context whose rings (63 positions) are shorter
    than the sequence: the window (16) plus a ubatch (32) still fits."""
    ctx = Context(model, paged=False, quantized_kv=quantized, device="cpu", **CTX)
    ctx.kv = ISWACache.build(model.cfg, ctx.n_seqs, ctx.n_slots, ring, quantized=quantized)
    return ctx


def test_layers_take_the_pool_and_a_ring_of_window_plus_ubatch(models):
    model, _ = models
    ctx = Context(model, device="cpu", **CTX)
    kv = ctx.kv
    assert isinstance(kv, ISWACache) and isinstance(kv.full, PagedKVCache)
    assert kv.is_swa == (True, False) and kv.layer_view(0) == (kv.swa, 0)
    assert kv.layer_view(1) == (kv.full, 0)
    assert kv.swa.ring and len(kv.swa.k) == 1 and len(kv.full.k) == 1
    assert kv.swa.n_slots == 256 < ctx.n_slots  # ceil((16 + 32 + 1) / 256) * 256
    # the smoke run's Gemma-3-4B cut: window 1024, ubatches of 512 -> 1792 slots
    big = Model(model.cfg.with_(sliding_window=1024, swa_pattern=6, n_layers=6),
                {"layers": [{}] * 6}, model.device)
    kv = Context(big, n_ctx=4096, n_seqs=1, n_ubatch=512, device="cpu").kv
    assert kv.swa.n_slots == 1792 and len(kv.swa.k) == 5 and len(kv.full.k) == 1
    slots = Context(model, paged=False, device="cpu", **CTX).kv
    assert isinstance(slots.full, KVCache) and not slots.full.ring


@KV
def test_ring_matches_unified_cache_with_window_masks(models, quantized):
    model, _ = models
    p = prompt(100)
    ctx = Context(model, paged=False, quantized_kv=quantized, device="cpu", **CTX)
    ref = unified(model, quantized)
    assert nmse(ctx.prefill(p), ref.prefill(p)) < 1e-6
    assert ctx.generate(p, 10, seq=1) == ref.generate(p, 10, seq=1)


@KV
def test_wrapped_ring_matches_unified_cache_and_jax(models, quantized):
    """A ring of 63 positions under a 100-token prompt and 8 decode steps:
    each slot is written again and again; logits and ids stay the unified
    cache's and the JAX package's (its ISWACache with the same ring)."""
    model, jmodel = models
    p = prompt(100, seed=1)
    ctx = small_ring(model, quantized)
    got = ctx.prefill(p)
    assert int((ctx.kv.swa.pos[0] >= 0).sum()) == 63
    assert nmse(got, unified(model, quantized).prefill(p)) < 1e-6
    jctx = JaxContext(jmodel, paged=False, quantized_kv=quantized, **CTX)
    jctx.kv = JaxISWACache.build(jmodel.cfg, jctx.n_seqs, jctx.n_slots, 64, quantized=quantized)
    jctx._steps.clear()
    ref = jctx.prefill(p)
    assert nmse(got, ref) < 1e-3
    ids = [int(np.argmax(got))]
    jids = [int(np.argmax(ref))]
    for _ in range(8):
        ids.append(int(np.argmax(ctx.decode_one(ids[-1]))))
        jids.append(int(np.argmax(jctx.decode_one(jids[-1]))))
    assert ids == jids
    assert ids[1:] == small_ring(model, quantized).generate(p, 9)[1:]


@KV
def test_paged_iswa_matches_slot_tables_and_jax(models, quantized):
    model, jmodel = models
    p = [5, 9, 23, 42, 7, 7, 9] * 6
    ctx = Context(model, quantized_kv=quantized, kv_total=512, device="cpu", **CTX)
    got = ctx.generate(p, 8)
    assert got == Context(model, paged=False, quantized_kv=quantized, device="cpu",
                          **CTX).generate(p, 8)
    assert got == jax_greedy(JaxContext(jmodel, quantized_kv=quantized, kv_total=512, **CTX),
                             p, 8)


def test_seq_cp_and_seq_rm_cover_both_tiers_on_the_pool(models):
    model, _ = models
    p = prompt(60, seed=2)
    ctx = Context(model, kv_total=1024, device="cpu", **CTX)
    first = int(np.argmax(ctx.prefill(p, seq=0)))
    ctx.seq_cp(1, 0)
    ring = ctx.kv.swa
    assert torch.equal(ring.pos[1], ring.pos[0]) and torch.equal(ring.k[0][1], ring.k[0][0])
    assert ctx.alloc.count[1] == ctx.alloc.count[0]
    out = ctx.decode_steps_greedy(np.asarray([first, first]), np.asarray([0, 1]), 6)
    assert (out[0] == out[1]).all()
    ctx.seq_rm(1)
    assert int(ctx.seq_len[1]) == 0 and ctx.alloc.count[1] == 0
    assert int((ring.pos[1] >= 0).sum()) == 0
    free = ctx.alloc.n_free
    ctx.seq_rm(0, 30)  # a suffix of seq 0 off both tiers
    assert int(ctx.seq_len[0]) == 30 and ctx.alloc.n_free >= free
    assert int(ring.pos[0].max()) == 29


def test_seq_cp_and_seq_rm_on_slot_tables_continue_alike(models):
    model, _ = models
    p = prompt(70, seed=3)
    ctx = Context(model, paged=False, device="cpu", **CTX)
    last = ctx.prefill(p, seq=2)
    ctx.seq_cp(3, 2)
    for tier in (ctx.kv.full, ctx.kv.swa):
        assert torch.equal(tier.pos[3], tier.pos[2])
        assert torch.equal(tier.v[0][3], tier.v[0][2])
    t = int(np.argmax(last))
    out = ctx.decode_steps_greedy(np.asarray([t, t]), np.asarray([2, 3]), 5)
    assert (out[0] == out[1]).all()
    ctx.seq_rm(3, 40)
    assert int(ctx.kv.full.pos[3].max()) == 39 and int(ctx.kv.swa.pos[3].max()) == 39
    assert int(ctx.seq_len[3]) == 40


@KV
def test_iswa_from_jax_continues_a_jax_prefill(models, quantized):
    model, jmodel = models
    p = prompt(90, seed=4)
    jctx = JaxContext(jmodel, paged=False, quantized_kv=quantized, **CTX)
    tok = int(np.argmax(jctx.prefill(p)))
    ctx = Context(model, paged=False, quantized_kv=quantized, device="cpu", **CTX)
    ctx.kv = iswa_from_jax(jax.tree_util.tree_map(np.asarray, jctx.kv))
    assert isinstance(ctx.kv, ISWACache) and ctx.kv.swa.ring
    ctx.seq_len[0] = len(p)
    for _ in range(4):
        got, ref = ctx.decode_one(tok), jctx.decode_one(tok)
        assert nmse(got, ref) < 1e-3
        tok = int(np.argmax(ref))


def test_batched_decode_matches_jax_b1_steps(models):
    """decode_steps_greedy at B=3 over three prompts (the pool and the
    rings) against the JAX package's B=1 steps of each."""
    model, jmodel = models
    ps = [prompt(40 + 13 * s, seed=10 + s) for s in range(3)]
    ctx = Context(model, quantized_kv=True, device="cpu", **CTX)
    firsts = np.asarray([int(np.argmax(ctx.prefill(p, seq=s))) for s, p in enumerate(ps)])
    out = ctx.decode_steps_greedy(firsts, np.arange(3), 6)
    jctx = JaxContext(jmodel, quantized_kv=True, **CTX)
    for s, p in enumerate(ps):
        ref = jax_greedy(jctx, p, 7, seq=s)
        assert [int(firsts[s])] + out[s].tolist() == ref


def test_memory_breakdown_and_reset_cover_both_tiers(models):
    model, _ = models
    ctx = Context(model, device="cpu", **CTX)
    ctx.prefill(prompt(50), seq=0)
    kv = ctx.kv

    def nbytes(cache):
        tensors = [*cache.k, *cache.v, cache.pos] + ([cache.table] if hasattr(cache, "table")
                                                      else [])
        return sum(t.numel() * t.element_size() for t in tensors)

    assert ctx.memory_breakdown()["memory_bytes"] == nbytes(kv.full) + nbytes(kv.swa)
    ctx.reset()
    assert ctx.kv is not kv and isinstance(ctx.kv, ISWACache)
    assert int((ctx.kv.swa.pos >= 0).sum()) == 0 and int(ctx.seq_len.sum()) == 0
