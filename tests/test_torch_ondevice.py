"""The port's on-device decode loop (runtime/decode_graph.py) against the
JAX package on the CPU, where the step body runs eagerly: generate_ondevice
greedy on both memories and KV types with chunks that leave a short last
chunk, its end-of-generation and n_ctx stops, sampled runs (seeded repeats,
top_k=1 against greedy, every id inside the JAX package's teacher-forced
top-k, a chi-square test of the sampler function), decode_steps_greedy at
B=1 and across the ids buffer's capacity, and the two host reads removed
from the step: RoPE's frequencies (cached) and the MoE route's segment
sizes. The step is run under a guard that raises on any read of a tensor
to the host and any tensor made from host data, which is what a CUDA graph
capture refuses.

Fixture: a Q4_K llama (2 layers, n_embd 512, 4/2 heads of 128, n_ff 1024,
vocab 512) whose weights the JAX package's quantizer made from random
values, so its greedy ids vary."""

import contextlib

import numpy as np
import pytest
import torch
from scipy import stats

import jax.numpy as jnp

from llama_cpp_tpu.models import transformer as jtf
from llama_cpp_tpu.models.loader import load_model as jax_load_model
from llama_cpp_tpu.ops import rope as jrope
from llama_cpp_tpu.runtime.context import Context as JaxContext
from llama_cpp_tpu.testing import make_tiny_llama_gguf as jax_make_tiny
from llama_cpp_tpu_torch.models import transformer as ttf
from llama_cpp_tpu_torch.models.loader import load_model
from llama_cpp_tpu_torch.ops import rope as trope
from llama_cpp_tpu_torch.runtime import decode_graph
from llama_cpp_tpu_torch.runtime.context import Context
from llama_cpp_tpu_torch.runtime.decode_graph import GREEDY, DeviceSampler
from llama_cpp_tpu_torch.testing import make_bench_moe_gguf

CTX = dict(n_ctx=256, n_seqs=4, n_ubatch=64)
MEM = pytest.mark.parametrize("paged", [True, False], ids=["paged", "slots"])
KV = pytest.mark.parametrize("quantized", [False, True], ids=["bf16_kv", "int8_kv"])



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
def models(tmp_path_factory):
    path = jax_make_tiny(str(tmp_path_factory.mktemp("torch_ondevice") / "q4k.gguf"),
                         vocab_size=512, n_layers=2, n_embd=512, n_heads=4, n_kv_heads=2,
                         n_ff=1024, ftype="q4_k", seed=3)
    return load_model(path, device="cpu"), jax_load_model(path)


def prompt(length=40, seed=1):
    return [int(t) for t in np.random.default_rng(seed).integers(3, 512, length)]


@contextlib.contextmanager
def no_host_reads(monkeypatch):
    """Raise on what a CUDA graph capture refuses: a tensor read to the host
    (item, tolist, int/float/bool/index of a tensor, numpy, bincount) or a
    tensor made from host data (torch.tensor, as_tensor, from_numpy)."""
    def refuse(name):
        def fail(*a, **k):
            raise AssertionError(f"host read in the decode step: {name}")
        return fail

    with monkeypatch.context() as m:
        for name in ("item", "tolist", "numpy", "__int__", "__float__", "__bool__",
                     "__index__"):
            m.setattr(torch.Tensor, name, refuse(f"Tensor.{name}"))
        for name in ("tensor", "as_tensor", "from_numpy", "bincount"):
            m.setattr(torch, name, refuse(f"torch.{name}"))
        yield


# -- generate_ondevice ----------------------------------------------------

@pytest.mark.parametrize("chunk", [4, 5])  # 9 steps: chunks 4+4+1 and 5+4
@KV
@MEM
def test_generate_ondevice_greedy_matches_jax(models, paged, quantized, chunk):
    model, jmodel = models
    p = prompt()
    ctx = Context(model, quantized_kv=quantized, paged=paged, device="cpu", **CTX)
    jctx = JaxContext(jmodel, quantized_kv=quantized, paged=paged, **CTX)
    got = ctx.generate_ondevice(p, max_new_tokens=10, chunk=chunk)
    ref = jctx.generate_ondevice(p, max_new_tokens=10, chunk=chunk)
    assert got == ref and len(got) == 10 and len(set(got)) > 3
    np.testing.assert_array_equal(ctx.seq_len, jctx.seq_len[: len(ctx.seq_len)])
    assert ctx.perf.n_decode == jctx.perf.n_decode == 9
    assert ctx.generate(p, max_new_tokens=10, seq=1) == got  # the host loop's ids


def test_end_of_generation_inside_a_chunk_stops_at_that_token(models, monkeypatch):
    model, _ = models
    p = prompt()
    ids = Context(model, device="cpu", **CTX).generate_ondevice(p, max_new_tokens=10, chunk=4)
    stop = 6  # the second chunk holds ids 5-8
    target = ids[stop]
    assert target not in ids[:stop]
    monkeypatch.setattr(model.tokenizer.vocab, "is_eog", lambda t: t == target)
    ctx = Context(model, device="cpu", **CTX)
    streamed = []
    got = ctx.generate_ondevice(p, max_new_tokens=10, chunk=4, stream=streamed.append)
    assert got == streamed == ids[: stop + 1]
    assert ctx.seq_len[0] == len(p) + 8  # two whole chunks were decoded


def test_n_ctx_stops_the_loop(models):
    """The loop stops before a chunk would reach n_ctx, as the JAX
    package's does."""
    model, jmodel = models
    p = prompt()
    kw = dict(CTX, n_ctx=52)
    got = Context(model, device="cpu", **kw).generate_ondevice(p, max_new_tokens=30, chunk=4)
    ref = JaxContext(jmodel, **kw).generate_ondevice(p, max_new_tokens=30, chunk=4)
    assert got == ref and len(got) == 9  # 40 + 8 + 4 + 1 >= 52 stops the third chunk


def test_sampled_ids_repeat_under_a_seed_and_top_k_one_is_greedy(models):
    model, _ = models
    p = prompt()
    ctx = Context(model, device="cpu", **CTX)
    runs = []
    for seed, k in ((1, 40), (1, 40), (2, 40), (1, 1)):
        runs.append(ctx.generate_ondevice(p, max_new_tokens=12, temp=0.8, top_k=k, seed=seed,
                                          chunk=5))
        ctx.reset()
    greedy = ctx.generate_ondevice(p, max_new_tokens=12, chunk=5)
    assert runs[0] == runs[1] and runs[0] != runs[2]
    assert runs[3] == greedy and runs[0] != greedy


def test_sampled_ids_lie_in_the_jax_teacher_forced_top_k(models):
    """Each id of a sampled run (temp 1.5, top_k 5) is among the 5 largest of
    the port's teacher-forced logits at its position, and among the JAX
    package's 5 largest there, fed the same ids, up to the two packages'
    difference at that step: an id past JAX's 5th must lie within the
    step's largest |port - JAX| logit difference of JAX's 5th value (the
    two sum in different orders, so a near-tie at the 5th may part)."""
    model, jmodel = models
    p = prompt(seed=2)
    got = Context(model, device="cpu", **CTX).generate_ondevice(
        p, max_new_tokens=12, temp=1.5, top_k=5, seed=3, chunk=4)
    ctx, jctx = Context(model, device="cpu", **CTX), JaxContext(jmodel, **CTX)
    logits, jlogits = ctx.prefill(p), jctx.prefill(p)
    ranks, jranks = [], []
    for t in got:
        ranks.append(int((logits > logits[t]).sum()))
        jranks.append(int((jlogits > jlogits[t]).sum()))
        if jranks[-1] >= 5:
            fifth = np.sort(jlogits)[-5]
            assert jlogits[t] >= fifth - np.abs(logits - jlogits).max(), (t, jranks)
        logits, jlogits = ctx.decode_one(t), jctx.decode_one(t)
    assert max(ranks) < 5 and len(got) == 12
    assert sum(r < 5 for r in jranks) >= 11
    assert any(ranks)  # not the greedy path


@pytest.mark.parametrize("top_k", [0, 4])
def test_sampler_draws_follow_the_softmax(top_k):
    """20,000 draws of the sampler function on fixed logits of a vocabulary
    of 8 against softmax(logits / temp) over the top-k: chi-square p > 1e-3."""
    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -0.5, -1.0, -2.0, 3.0])
    temp = 0.7
    gen = torch.Generator().manual_seed(5)
    draws = DeviceSampler(temp, top_k)(logits.expand(20000, 8), gen).numpy()
    probs = torch.softmax(logits / temp, dim=-1).numpy().astype(np.float64)
    if top_k:
        keep = np.argsort(-probs)[:top_k]
        probs = np.where(np.isin(np.arange(8), keep), probs, 0.0)
        probs /= probs.sum()
        assert set(np.unique(draws)) == set(keep.tolist())
    counts = np.bincount(draws, minlength=8)
    live = probs > 0
    expected = probs[live] / probs[live].sum() * len(draws)
    assert stats.chisquare(counts[live], expected).pvalue > 1e-3


# -- decode_steps_greedy through the step function -------------------------

def test_decode_steps_greedy_b1_matches_jax(models):
    model, jmodel = models
    p = prompt(seed=4)
    ctx = Context(model, quantized_kv=True, device="cpu", **CTX)
    jctx = JaxContext(jmodel, quantized_kv=True, **CTX)
    first = int(np.argmax(ctx.prefill(p)))
    assert first == int(np.argmax(jctx.prefill(p)))
    got = ctx.decode_steps_greedy(np.asarray([first]), np.asarray([0]), 8)
    ref = jctx.decode_steps_greedy(np.asarray([first]), np.asarray([0]), 8)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert ctx.decode_loop(1).replays == 0  # the CPU runs the step eagerly


def test_decode_steps_greedy_across_the_ids_buffer(models, monkeypatch):
    """More steps than the loop's ids buffer holds on the device: the ids
    are copied out a buffer at a time and come out equal; padding rows of
    the B=3 step in the [4] bucket stay negative."""
    model, _ = models
    firsts = []
    ref_ctx = Context(model, device="cpu", **CTX)
    for s in range(3):
        firsts.append(int(np.argmax(ref_ctx.prefill(prompt(20 + 4 * s, seed=s), seq=s))))
    ref = ref_ctx.decode_steps_greedy(np.asarray(firsts), np.arange(3), 10)
    monkeypatch.setattr(decode_graph, "CAPACITY", 4)
    ctx = Context(model, device="cpu", **CTX)
    for s in range(3):
        ctx.prefill(prompt(20 + 4 * s, seed=s), seq=s)
    got = ctx.decode_steps_greedy(np.asarray(firsts), np.arange(3), 10)
    np.testing.assert_array_equal(got, ref)
    loop = ctx.decode_loop(4)
    assert loop.out.shape == (4, 4) and int(loop.pos[3]) < 0


def test_step_reads_nothing_from_the_host(models, monkeypatch):
    """The llama step (after one warm-up step, which fills the RoPE cache)
    and a sampled step run under the guard on both memories."""
    model, _ = models
    for paged in (True, False):
        ctx = Context(model, quantized_kv=True, paged=paged, device="cpu", **CTX)
        ctx.prefill(prompt(), seq=0)
        for sampler in (GREEDY, DeviceSampler(0.8, 40)):
            loop = ctx.decode_loop(4, sampler)
            loop.step()
            with no_host_reads(monkeypatch):
                loop.step()
            assert int(loop.index[0]) == 2
    ctx.reset()
    assert not ctx._loops  # reset drops the loops and their graphs


# -- the host reads removed from the step ----------------------------------

@pytest.mark.parametrize("kind", ["norm", "neox_yarn", "freq_factors"])
def test_rope_with_cached_frequencies_matches_jax(kind):
    kw = dict(rope_type=trope.ROPE_TYPE_NORM, n_dims=64, freq_base=500000.0)
    if kind == "neox_yarn":
        kw.update(rope_type=trope.ROPE_TYPE_NEOX, freq_scale=0.25, ext_factor=1.0,
                  orig_ctx=4096, attn_factor=1.0)
    if kind == "freq_factors":
        kw["freq_factors"] = np.linspace(1.0, 8.0, 32).astype(np.float32)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 4, 128)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    p = trope.RopeParams(**kw)
    got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), p).numpy()
    again = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), p).numpy()
    jp = jrope.RopeParams(**kw)
    ref = np.asarray(jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), jp))
    assert np.mean((got - ref) ** 2) / np.mean(ref ** 2) < 1e-10
    np.testing.assert_array_equal(got, again)
    assert trope._freqs(p, 128, torch.device("cpu"))[0] is trope._freqs(
        p, 128, torch.device("cpu"))[0]


def _moe_ragged_host_counts(cfg, lw, x, topi, topw):
    """The sort-by-expert route as it was, segment sizes read to the host
    once a layer: the reference the device-only route is held against."""
    lead, E = x.shape[:-1], x.shape[-1]
    k = topi.shape[-1]
    xf = x.reshape(-1, E)
    N = xf.shape[0]
    e_flat = topi.reshape(N * k).long()
    tw = topw.reshape(N, k)
    order = torch.sort(e_flat, stable=True).indices
    counts = torch.bincount(e_flat, minlength=cfg.n_expert).tolist()
    mdt = torch.bfloat16
    xs = xf[order // k].to(mdt)
    y = torch.empty((N * k, E), dtype=torch.float32)
    start = 0
    for e, n in enumerate(counts):
        if n == 0:
            continue
        seg = slice(start, start + n)
        eid = torch.tensor([e])

        def emm(key, h):
            return ttf.dot_f32(h.to(mdt), ttf._dequant_experts(lw[key], eid, mdt)[0])

        h = ttf.silu(emm("ffn_gate_exps", xs[seg])) * emm("ffn_up_exps", xs[seg])
        y[seg] = emm("ffn_down_exps", h)
        start += n
    inv = torch.empty_like(order)
    inv[order] = torch.arange(N * k)
    y = y[inv].reshape(N, k, E)
    return (y * tw[:, :, None]).sum(dim=1).reshape(*lead, E)


def test_moe_route_without_host_reads_matches_the_previous_route_and_jax(tmp_path,
                                                                         monkeypatch):
    """A Mixtral-shaped fixture (8 experts, top-2) at B=8 decode (16 pairs:
    the per-expert route): the route run under the guard equals the route
    with host segment sizes and the JAX package's moe_block."""
    path = make_bench_moe_gguf(str(tmp_path / "moe.gguf"), n_layers=1, n_embd=512,
                               n_heads=4, n_kv_heads=2, n_ff=1024, n_expert=8,
                               n_expert_used=2, vocab_size=512, seed=0)
    model, jmodel = load_model(path, device="cpu"), jax_load_model(path)
    cfg, lw = model.cfg, model.params["layers"][0]
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((8, 1, 512))
                         .astype(np.float32)).to(torch.bfloat16)
    topi, topw = ttf._route(cfg, lw, x, True)
    assert x.shape[0] * cfg.n_expert_used >= cfg.n_expert
    with no_host_reads(monkeypatch):
        got = ttf._moe_ragged(cfg, lw, x, topi, topw, True)
    prev = _moe_ragged_host_counts(cfg, lw, x, topi, topw)
    assert float(((got - prev) ** 2).mean() / (prev ** 2).mean()) < 1e-12
    out = ttf.moe_block(cfg, lw, x).float().numpy()
    ref = np.asarray(jtf.moe_block(jmodel.cfg, jmodel.params["layers"][0],
                                   jnp.asarray(x.float().numpy(), jnp.bfloat16)
                                   ).astype(jnp.float32))
    assert np.mean((out - ref) ** 2) / np.mean(ref ** 2) < 1e-6
