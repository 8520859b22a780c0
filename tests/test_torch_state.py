"""The port's state files (runtime/state.py) on the CPU: whole-context and
per-sequence round trips on the page pool and the slot table, int8 and bf16
KV, give the next decode's logits bit for bit; a per-sequence blob moves
between the two packages in both directions (the JAX package's
save_seq_state loaded by the port, the port's loaded by the JAX package),
the next decode's logits within NMSE 1e-4 of the other package's; a blob or
file of another model, a whole-context file of the JAX package and a file
of another memory are refused with ValueError; loads write into the
memory's existing tensors (a captured decode loop keeps reading them).

Fixture: a Q8_0 llama (2 layers, n_embd 256, 4/2 heads of 64, n_ff 512,
vocab 256) of seeded values from the JAX package's quantizer."""

import numpy as np
import pytest
import torch

from llama_cpp_tpu.models.loader import load_model as jax_load_model
from llama_cpp_tpu.runtime import state as jstate
from llama_cpp_tpu.runtime.context import Context as JaxContext
from llama_cpp_tpu.testing import make_tiny_llama_gguf as jax_make_tiny
from llama_cpp_tpu_torch.models.loader import load_model
from llama_cpp_tpu_torch.runtime import state
from llama_cpp_tpu_torch.runtime.context import Context

SHAPE = dict(vocab_size=256, n_layers=2, n_embd=256, n_heads=4, n_kv_heads=2, n_ff=512,
             ftype="q8_0", seed=3)
CTX = dict(n_ctx=128, n_seqs=4, n_ubatch=32)
PROMPTS = [[5, 9, 23, 9, 23, 42, 17, 88, 3, 61, 7, 200, 31] * 3, [4, 8, 15, 16, 23, 42] * 2]
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
def path(tmp_path_factory):
    return jax_make_tiny(str(tmp_path_factory.mktemp("torch_state") / "m.gguf"), **SHAPE)


@pytest.fixture(scope="module")
def model(path):
    return load_model(path, device="cpu")


@pytest.fixture(scope="module")
def jax_model(path):
    return jax_load_model(path)


def filled(model, paged, quantized):
    ctx = Context(model, device="cpu", paged=paged, quantized_kv=quantized, **CTX)
    for s, p in enumerate(PROMPTS):
        ctx.prefill(p, seq=s)
    return ctx


@CASES
def test_whole_state_round_trip(model, tmp_path, paged, quantized):
    """save_state, reset (a new memory), load_state: the next decode of both
    sequences equals the run without the round trip, bit for bit, and the
    tensors loaded into are the memory's own."""
    ref = filled(model, paged, quantized)
    want = ref.decode_step_multi(np.asarray([7, 9]), np.asarray([0, 1]))
    ctx = filled(model, paged, quantized)
    f = str(tmp_path / "ctx.state")
    nbytes = state.save_state(ctx, f, extra={"tokens": PROMPTS[0]})
    ctx.reset()
    k0 = ctx.kv.k[0]
    assert state.load_state(ctx, f) == {"tokens": PROMPTS[0]} and nbytes > 0
    assert ctx.kv.k[0] is k0 and list(ctx.seq_len[:2]) == [len(p) for p in PROMPTS]
    got = ctx.decode_step_multi(np.asarray([7, 9]), np.asarray([0, 1]))
    assert np.array_equal(got, want)
    if paged:  # the allocator rebuilt from the table: same pages, same free list
        assert np.array_equal(ctx.alloc.table, ref.alloc.table)
        assert sorted(ctx.alloc.free) == sorted(ref.alloc.free)


@CASES
def test_seq_state_round_trip(model, paged, quantized):
    """save_seq_state of seq 0, load_seq_state into seq 3 of another context:
    the next decode's logits equal seq 0's, bit for bit."""
    src = filled(model, paged, quantized)
    blob = state.save_seq_state(src, 0)
    want = src.decode_step_multi(np.asarray([7]), np.asarray([0]))
    dst = filled(model, paged, quantized)
    assert state.load_seq_state(dst, 3, blob) == len(PROMPTS[0])
    assert dst.seq_len[3] == len(PROMPTS[0])
    got = dst.decode_step_multi(np.asarray([7]), np.asarray([3]))
    assert np.array_equal(got, want)
    other = dst.decode_step_multi(np.asarray([9]), np.asarray([1]))  # seq 1 untouched
    assert np.array_equal(other, filled(model, paged, quantized).decode_step_multi(
        np.asarray([9]), np.asarray([1])))


@CASES
def test_jax_blob_loads_into_the_port(model, jax_model, paged, quantized):
    jctx = JaxContext(jax_model, paged=paged, quantized_kv=quantized, **CTX)
    jctx.prefill(PROMPTS[0], seq=1)
    blob = jstate.save_seq_state(jctx, 1)
    want = np.asarray(jctx.decode_one(7, seq=1))
    ctx = Context(model, device="cpu", paged=paged, quantized_kv=quantized, **CTX)
    assert state.load_seq_state(ctx, 2, blob) == len(PROMPTS[0])
    got = ctx.decode_one(7, seq=2)
    assert nmse(got, want) < 1e-4


@CASES
def test_port_blob_loads_into_jax(model, jax_model, paged, quantized):
    ctx = Context(model, device="cpu", paged=paged, quantized_kv=quantized, **CTX)
    ctx.prefill(PROMPTS[0], seq=1)
    blob = state.save_seq_state(ctx, 1)
    want = ctx.decode_one(7, seq=1)
    jctx = JaxContext(jax_model, paged=paged, quantized_kv=quantized, **CTX)
    assert jstate.load_seq_state(jctx, 0, blob) == len(PROMPTS[0])
    got = np.asarray(jctx.decode_one(7, seq=0))
    assert nmse(got, want) < 1e-4


def test_mismatches_raise(model, path, tmp_path):
    """Another model, another memory, and a whole-context file of the JAX
    package are refused, each naming the mismatch."""
    ctx = filled(model, True, True)
    other = load_model(jax_make_tiny(str(tmp_path / "o.gguf"), **{**SHAPE, "n_layers": 1}),
                       device="cpu")
    blob = state.save_seq_state(ctx, 0)
    with pytest.raises(ValueError, match="model mismatch"):
        state.load_seq_state(Context(other, device="cpu", quantized_kv=True, **CTX), 0, blob)
    with pytest.raises(ValueError, match="memory-type mismatch"):
        state.load_seq_state(Context(model, device="cpu", quantized_kv=True, paged=False, **CTX),
                             0, blob)
    f = str(tmp_path / "ctx.state")
    state.save_state(ctx, f)
    with pytest.raises(ValueError, match="model mismatch"):
        state.load_state(Context(other, device="cpu", quantized_kv=True, **CTX), f)
    with pytest.raises(ValueError, match="geometry"):
        state.load_state(Context(model, device="cpu", quantized_kv=True,
                                 **{**CTX, "n_seqs": 2}), f)
    jctx = JaxContext(jax_load_model(path), quantized_kv=True, **CTX)
    jctx.prefill(PROMPTS[0])
    jf = str(tmp_path / "jax.state")
    jstate.save_state(jctx, jf)
    with pytest.raises(ValueError, match="layout mismatch.*JAX package"):
        state.load_state(ctx, jf)


def test_memory_tensors_order(model):
    """The documented order of a whole-context file's tensors."""
    ctx = Context(model, device="cpu", quantized_kv=True, **CTX)
    names = [n for n, _ in state.memory_tensors(ctx.kv)]
    assert names == ["k.0", "k.1", "v.0", "v.1", "k_scale.0", "k_scale.1", "v_scale.0",
                     "v_scale.1", "pos", "table"]
    slots = Context(model, device="cpu", paged=False, **CTX)
    assert [n for n, _ in state.memory_tensors(slots.kv)] == ["k.0", "k.1", "v.0", "v.1", "pos"]
