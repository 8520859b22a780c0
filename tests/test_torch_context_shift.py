"""The port's context shift (Context.context_shift over PagedKVCache and
KVCache.shift_seq) on the CPU: against the JAX package's context_shift on
the same file, on the pool and the slot table, bf16 and int8 KV (the next
decodes' logits within NMSE 5e-4 of JAX's, and within twice the packages'
difference before the shift); against a fresh context
prefilled with the kept tokens at their shifted positions (a one-layer
model, where K and V depend on token and position only: NMSE 5e-3, the int8
memory's dequantize-rotate-requantize being a rounding); the other
sequences untouched; the shift in place (the memory's tensors stay the
same objects); the pages past the new end freed; seq_add; an ISWA memory
refused, as the JAX package refuses it.

Fixtures: Q8_0 llamas (n_embd 256, 4/2 heads of 64, n_ff 512, vocab 256)
of seeded values from the JAX package's quantizer, at 2 layers and 1."""

import numpy as np
import pytest
import torch

from llama_cpp_tpu.models.loader import load_model as jax_load_model
from llama_cpp_tpu.runtime.context import Context as JaxContext
from llama_cpp_tpu.testing import make_tiny_llama_gguf as jax_make_tiny
from llama_cpp_tpu_torch.models.loader import load_model
from llama_cpp_tpu_torch.runtime.context import Context
from llama_cpp_tpu_torch.testing import make_bench_arch_gguf

SHAPE = dict(vocab_size=256, n_embd=256, n_heads=4, n_kv_heads=2, n_ff=512, ftype="q8_0",
             seed=3)
CTX = dict(n_ctx=128, n_seqs=2, n_ubatch=32)
TOKS = [int(t) for t in np.random.default_rng(0).integers(4, 250, 90)]
CASES = pytest.mark.parametrize("paged,quantized", [(True, False), (True, True),
                                                     (False, False), (False, True)],
                                ids=["paged-bf16", "paged-int8", "slots-bf16", "slots-int8"])


def nmse(a, b):
    return float(np.mean((a - b) ** 2) / (np.mean(b ** 2) + 1e-30))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_shift")
    return {n: jax_make_tiny(str(d / f"l{n}.gguf"), n_layers=n, **SHAPE) for n in (1, 2)}


@pytest.fixture(scope="module")
def models(paths):
    return {n: load_model(p, device="cpu") for n, p in paths.items()}


@CASES
def test_shift_equals_jax(models, paths, paged, quantized):
    """Prefill 90 tokens, decode one, shift (keep 8, discard 40), decode 3:
    each shifted step's logits within NMSE 5e-4 of the JAX package's on the
    same file, and within twice the two packages' difference before the
    shift (about 1e-4 on this fixture: bf16 activations), so the shift adds
    no difference of its own."""
    ctx = Context(models[2], device="cpu", paged=paged, quantized_kv=quantized, **CTX)
    jctx = JaxContext(jax_load_model(paths[2]), paged=paged, quantized_kv=quantized, **CTX)
    for c in (ctx, jctx):
        c.prefill(TOKS)
    base = nmse(ctx.decode_one(7), np.asarray(jctx.decode_one(7)))
    for c in (ctx, jctx):
        assert c.context_shift(0, n_keep=8, n_discard=40) == 40
    assert int(ctx.seq_len[0]) == int(jctx.seq_len[0]) == 51
    for t in (7, 19, 200):
        err = nmse(ctx.decode_one(t), np.asarray(jctx.decode_one(t)))
        assert err < 5e-4 and err < 2 * base


@CASES
def test_shift_matches_a_fresh_context(models, paged, quantized):
    """One layer: the shifted memory is the kept tokens' at their new
    positions, up to the re-rotation's rounding (and the int8 memory's
    requantization)."""
    n_keep, n_discard = 4, 30
    ctx = Context(models[1], device="cpu", paged=paged, quantized_kv=quantized, **CTX)
    ctx.prefill(TOKS)
    ctx.context_shift(0, n_keep=n_keep, n_discard=n_discard)
    fresh = Context(models[1], device="cpu", paged=paged, quantized_kv=quantized, **CTX)
    fresh.prefill(TOKS[:n_keep] + TOKS[n_keep + n_discard:])
    assert ctx.seq_len[0] == fresh.seq_len[0] == len(TOKS) - n_discard
    for t in (42, 7):
        assert nmse(ctx.decode_one(t), fresh.decode_one(t)) < 5e-3


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slots"])
def test_shift_leaves_other_sequences_and_shifts_in_place(models, paged):
    ctx = Context(models[2], device="cpu", paged=paged, quantized_kv=True, **CTX)
    ctx.prefill(TOKS, seq=0)
    ctx.prefill(TOKS[:20], seq=1)
    before = ctx.decode_one(3, seq=1)
    ctx.seq_rm(1, p0=20)  # rewind the probe token
    tensors = [ctx.kv.k[0], ctx.kv.v[0], ctx.kv.pos]
    pages = int(ctx.alloc.count[0]) if paged else 0
    ctx.context_shift(0)  # default: half of what lies past n_keep = 0
    assert int(ctx.seq_len[0]) == len(TOKS) - len(TOKS) // 2
    assert all(a is b for a, b in zip([ctx.kv.k[0], ctx.kv.v[0], ctx.kv.pos], tensors))
    if paged:  # pages of 256: 90 -> 45 tokens keeps one page
        assert pages == 1 and int(ctx.alloc.count[0]) == 1
    assert np.array_equal(ctx.decode_one(3, seq=1), before)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slots"])
def test_seq_add_moves_labels_only(models, paged):
    ctx = Context(models[2], device="cpu", paged=paged, **CTX)
    ctx.prefill(TOKS[:10])
    ctx.kv.seq_add(0, 5, 10, 100)
    pos = (ctx.kv.seq_slot_pos(torch.tensor([0]))[0] if paged else ctx.kv.pos[0]).tolist()
    assert sorted(p for p in pos if p >= 0) == [0, 1, 2, 3, 4, 105, 106, 107, 108, 109]


def test_iswa_memory_is_refused(tmp_path):
    path = make_bench_arch_gguf(str(tmp_path / "g.gguf"), "gemma3", n_layers=2, n_embd=256,
                                n_heads=4, n_kv_heads=2, head_dim=64, n_ff=512, vocab_size=512,
                                n_ctx=256, tie=True, qk_norm=True, sliding_window=32,
                                swa_pattern=2, ftype="q8_0")
    ctx = Context(load_model(path, device="cpu"), device="cpu", **CTX)
    ctx.prefill(TOKS[:40])
    with pytest.raises(NotImplementedError, match="ISWACache"):
        ctx.context_shift(0)
