"""The port's RWKV entries (rwkv6, rwkv7, rwkv6qwen2, arwkv7: models/rwkv.py
over the RecurrentState), each against the JAX package on the CPU.

The scans from numpy-seeded inputs and states: RWKV-6's wkv, the qrwkv
hybrids' gated linear attention and RWKV-7's rank-1 update, each at T = 1,
6 and 7 (the associative scan's odd and even halvings), output and new state
within f32 NMSE 1e-6. Each entry on one tiny f32 fixture
(testing.make_tiny_rwkv6_gguf, make_tiny_rwkv7_gguf,
make_tiny_rwkv_hybrid_gguf: 2 layers, n_embd 64, heads of 16, vocab 256)
read by both packages from the same bytes: the graph (Model.forward_fn is
rwkv.forward, not the Mamba forward), layer keys, flags and extras equal;
f32 logits of a prefill and 4 decode steps within NMSE 1e-5; a token-by-
token decode equal to the prefill's rows; 8 greedy ids equal; sequences
kept apart (seq_cp then divergent decode); on a Q4_K_M file (n_embd 256,
heads of 64) the prefill logits within NMSE 5e-3. The memory: 2 shift rows
of n_embd and an [hs, n_embd] f32 plane a layer and a sequence; whole-
context and sequence state bit for bit; sequence blobs and whole-context
files written by one package and read by the other; the JAX package's
parameters carried over by models/from_jax.py. llama-cli and a served
round on RWKV-7 against Context.generate; llama-bench's rows on RWKV-6."""

import json
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_tpu.models import rwkv as jrwkv
from llama_cpp_tpu.models.loader import load_model as jax_load_model
from llama_cpp_tpu.runtime import state as jstate
from llama_cpp_tpu.runtime.context import Context as JaxContext
from llama_cpp_tpu_torch.models import rwkv
from llama_cpp_tpu_torch.models.from_jax import params_from_jax
from llama_cpp_tpu_torch.models.loader import load_model
from llama_cpp_tpu_torch.models.registry import supported_archs
from llama_cpp_tpu_torch.runtime import state
from llama_cpp_tpu_torch.runtime.context import Context
from llama_cpp_tpu_torch.runtime.memory import RecurrentState
from llama_cpp_tpu_torch.server import app as server_app
from llama_cpp_tpu_torch.testing import (RWKV_ARCHS, make_bench_rwkv_gguf, make_tiny_rwkv6_gguf,
                                         make_tiny_rwkv7_gguf, make_tiny_rwkv_hybrid_gguf)

ARCH = pytest.mark.parametrize("arch", RWKV_ARCHS)
TS = pytest.mark.parametrize("T", [1, 6, 7])
FLAGS = ("use_rms_norm", "norm_eps", "rms_eps", "n_embd", "n_layers", "vocab_size")
EXTRAS = ("memory", "rwkv", "rwkv_hybrid", "wkv_head_size", "rescale_every", "ssm_d_conv",
          "ssm_d_inner", "ssm_d_state")
CTX = dict(n_ctx=64, n_seqs=1, n_ubatch=32)
NMSE_F32 = 1e-5
NMSE_SCAN = 1e-6
NMSE_QUANT = 5e-3


def nmse(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.mean((got - ref) ** 2) / (np.mean(ref ** 2) + 1e-30))


def prompt(length, seed=0):
    return [int(t) for t in np.random.default_rng(seed).integers(3, 256, length)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small steps under pytest-xdist's workers on a shared CPU: torch's
    thread pool would spend more than the work on waking its threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_tiny(path, arch):
    if arch == "rwkv6":
        return make_tiny_rwkv6_gguf(path)
    if arch == "rwkv7":
        return make_tiny_rwkv7_gguf(path)
    return make_tiny_rwkv_hybrid_gguf(path, arch)


@pytest.fixture(scope="module")
def f32_models(tmp_path_factory):
    """arch -> (port model, JAX model, path), both f32 from one tiny f32
    file, made at first use."""
    made = {}

    def get(arch):
        if arch not in made:
            path = write_tiny(str(tmp_path_factory.mktemp(arch) / f"{arch}.gguf"), arch)
            made[arch] = (load_model(path, device="cpu", dense_dtype=torch.float32),
                          jax_load_model(path, dense_dtype=jnp.float32), path)
        return made[arch]

    return get


def port_ctx(model, **kw):
    return Context(model, device="cpu", **{**CTX, **kw})


def jax_ctx(jmodel, **kw):
    return JaxContext(jmodel, kv_dtype=jnp.float32, **{**CTX, **kw})


# -- the scans against the JAX functions --------------------------------------

def _scan_inputs(T, seed, H=3, hs=8, B=2):
    rng = np.random.default_rng(seed)
    s0 = (0.5 * rng.standard_normal((B, H, hs, hs))).astype(np.float32)
    r, k, v = (rng.standard_normal((B, T, H, hs)).astype(np.float32) for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((B, T, H, hs)))).astype(np.float32)
    return rng, s0, r, k, v, w


def _hold(port_out, jax_out):
    for got, ref in zip(port_out, jax_out):
        assert tuple(got.shape) == tuple(ref.shape)
        assert nmse(got.numpy(), np.asarray(ref)) <= NMSE_SCAN


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@TS
def test_wkv6_scan_matches_jax(T):
    rng, s0, r, k, v, w = _scan_inputs(T, 1)
    u = (0.3 * rng.standard_normal((3, 8))).astype(np.float32)
    _hold(rwkv.wkv6_scan(*_t(s0, r, k, v, w, u)),
          jrwkv.wkv6_scan(*(jnp.asarray(a) for a in (s0, r, k, v, w, u))))


@TS
def test_gla_scan_matches_jax(T):
    _, s0, r, k, v, w = _scan_inputs(T, 2)
    _hold(rwkv.gla_scan(*_t(s0, r, k, v, w), 8 ** -0.5),
          jrwkv.gla_scan(*(jnp.asarray(a) for a in (s0, r, k, v, w)), 8 ** -0.5))


@TS
def test_wkv7_scan_matches_jax(T):
    rng, s0, r, k, v, w = _scan_inputs(T, 3)
    kk = rng.standard_normal((2, T, 3, 8)).astype(np.float32)
    kk /= np.linalg.norm(kk, axis=-1, keepdims=True)
    a = (1 / (1 + np.exp(-rng.standard_normal((2, T, 3, 8))))).astype(np.float32)
    args = (s0, r, w, k, v, -kk, kk * a)
    _hold(rwkv.wkv7_scan(*_t(*args)), jrwkv.wkv7_scan(*(jnp.asarray(x) for x in args)))


# -- the entries against the JAX package ----------------------------------------

def test_supported_archs_cover_rwkv():
    assert set(RWKV_ARCHS) <= set(supported_archs())


@ARCH
def test_graph_layer_keys_and_flags_match_jax(f32_models, arch):
    model, jmodel, _ = f32_models(arch)
    assert model.forward_fn is rwkv.forward
    assert [set(lw) for lw in model.params["layers"]] == [
        set(lw) for lw in jmodel.params["layers"]]
    assert set(model.params) == set(jmodel.params)
    for name in FLAGS:
        assert getattr(model.cfg, name) == pytest.approx(getattr(jmodel.cfg, name)), name
    for key in EXTRAS:
        assert model.cfg.extra.get(key) == jmodel.cfg.extra.get(key), key


@ARCH
def test_f32_prefill_and_decode_match_jax(f32_models, arch):
    model, jmodel, _ = f32_models(arch)
    ctx, jctx = port_ctx(model), jax_ctx(jmodel)
    p = prompt(11, seed=3)
    assert nmse(ctx.prefill(p), np.asarray(jctx.prefill(p))) <= NMSE_F32
    for t in (5, 77, 140, 9):
        assert nmse(ctx.decode_one(t), np.asarray(jctx.decode_one(t))) <= NMSE_F32


@ARCH
def test_stepwise_decode_equals_prefill(f32_models, arch):
    """Every row of a 9-token ubatch equals the logits of the same tokens
    decoded one at a time."""
    model, _, _ = f32_models(arch)
    toks = np.asarray(prompt(9, seed=4))[None]
    rows = port_ctx(model).decode(toks, np.asarray([0]), np.arange(9)[None], np.arange(9))
    ctx = port_ctx(model)
    steps = [ctx.prefill([int(toks[0, 0])])] + [ctx.decode_one(int(t)) for t in toks[0, 1:]]
    assert nmse(np.stack(steps), rows) <= 1e-10


@ARCH
def test_greedy_ids_match_jax(f32_models, arch):
    model, jmodel, _ = f32_models(arch)
    p = prompt(10, seed=2)
    assert port_ctx(model).generate(p, max_new_tokens=8) == jax_ctx(jmodel).generate(
        p, max_new_tokens=8)


@ARCH
def test_sequences_kept_apart_match_jax(f32_models, arch):
    """seq_cp then a divergent decode on each sequence, against the JAX
    package; a prefill of another sequence leaves the first's next step
    unchanged."""
    model, jmodel, _ = f32_models(arch)
    ctx, jctx = port_ctx(model, n_seqs=2), jax_ctx(jmodel, n_seqs=2)
    ctx.prefill(prompt(9), seq=0)
    jctx.prefill(prompt(9), seq=0)
    ctx.seq_cp(1, 0)
    jctx.seq_cp(1, 0)
    for seq, toks in ((0, (11, 12)), (1, (40, 41))):
        for t in toks:
            assert nmse(ctx.decode_one(t, seq=seq),
                        np.asarray(jctx.decode_one(t, seq=seq))) <= NMSE_F32
    alone = port_ctx(model, n_seqs=2)
    alone.prefill(prompt(9), seq=0)
    alone.decode_one(11, seq=0)
    want = alone.decode_one(12, seq=0)
    alone.seq_rm(0)
    alone.prefill(prompt(9), seq=0)
    alone.prefill(prompt(6, seed=5), seq=1)
    alone.decode_one(11, seq=0)
    assert np.array_equal(alone.decode_one(12, seq=0), want)


@ARCH
def test_quantized_logits_match_jax(tmp_path, arch):
    """The Q4_K_M file (n_embd 256, heads of 64; the synthetic block scales
    divided by 256, as on the card's paths) in bf16 through both packages:
    every row of a 24-token ubatch within NMSE 5e-3."""
    path = make_bench_rwkv_gguf(str(tmp_path / f"{arch}.gguf"), arch, n_layers=2, n_embd=256,
                                head_size=64, n_ff=512, vocab_size=256, lora=(16, 16, 16, 16),
                                n_kv_heads=2 if arch == "rwkv6qwen2" else 0,
                                synth_scale=1.0 / 256)
    toks = np.asarray(prompt(24, seed=4))[None]
    args = (toks, np.asarray([0]), np.arange(24)[None], np.arange(24))
    got = port_ctx(load_model(path, device="cpu")).decode(*args)
    ref = JaxContext(jax_load_model(path), **CTX).decode(*args)
    assert nmse(got, ref) < NMSE_QUANT


@ARCH
def test_params_from_jax_compute_the_port_logits(f32_models, arch):
    """The JAX package's parameters (time_mix_*, channel_mix_*, the qrwkv
    biases) turned into the port's by models/from_jax.py compute the port's
    own logits."""
    import jax

    from llama_cpp_tpu_torch.models.loader import Model

    model, jmodel, _ = f32_models(arch)
    jp = jax.tree_util.tree_map(np.asarray, jmodel.params)
    carried = Model(model.cfg, params_from_jax(jp), torch.device("cpu"))
    assert [set(lw) for lw in carried.params["layers"]] == [
        set(lw) for lw in model.params["layers"]]
    p = prompt(9, seed=6)
    assert nmse(port_ctx(carried).prefill(p), port_ctx(model).prefill(p)) <= 1e-12


# -- the memory ----------------------------------------------------------------

@ARCH
def test_memory_geometry_and_refused_shift(f32_models, arch):
    """The RecurrentState alone: 2 token-shift rows of n_embd and an [hs,
    n_embd] f32 wkv plane a layer and a sequence; no pages; exact-shape
    decode batches; the context shift refused."""
    model, _, _ = f32_models(arch)
    cfg = model.cfg
    ctx = port_ctx(model, n_seqs=3)
    assert isinstance(ctx.kv, RecurrentState) and not ctx.paged and ctx.recurrent
    assert tuple(ctx.kv.conv.shape) == (cfg.n_layers, 3, 2, cfg.n_embd)
    assert tuple(ctx.kv.ssm.shape) == (cfg.n_layers, 3, cfg.extra["wkv_head_size"], cfg.n_embd)
    assert ctx.kv.ssm.dtype == torch.float32
    assert [ctx._batch_bucket(b) for b in (1, 2, 3)] == [1, 2, 3]
    ctx.prefill(prompt(8), seq=0)
    if cfg.extra.get("rwkv_hybrid"):  # one token-shift stream in both slots
        assert torch.equal(ctx.kv.conv[:, 0, 0], ctx.kv.conv[:, 0, 1])
    with pytest.raises(NotImplementedError, match="recurrent"):
        ctx.context_shift(0, n_keep=2)


@ARCH
def test_state_round_trips_bit_for_bit(f32_models, arch, tmp_path):
    """A whole-context file into a fresh context and a sequence blob into
    another sequence: every tensor equal, the next step's logits equal."""
    model, _, _ = f32_models(arch)
    ctx = port_ctx(model, n_seqs=2)
    ctx.prefill(prompt(10), seq=0)
    state.save_state(ctx, str(tmp_path / "s.npz"))
    fresh = port_ctx(model, n_seqs=2)
    state.load_state(fresh, str(tmp_path / "s.npz"))
    for (name, a), (_, b) in zip(state.memory_tensors(ctx.kv), state.memory_tensors(fresh.kv)):
        assert torch.equal(a, b), name
    blob = state.save_seq_state(ctx, 0)
    other = port_ctx(model, n_seqs=2)
    other.prefill(prompt(3, seed=8), seq=1)
    assert state.load_seq_state(other, 1, blob) >= 1
    assert torch.equal(other.kv.ssm[:, 1], ctx.kv.ssm[:, 0])
    want = ctx.decode_one(17, seq=0)
    assert np.array_equal(fresh.decode_one(17, seq=0), want)
    assert np.array_equal(other.decode_one(17, seq=1), want)


@ARCH
def test_sequence_blobs_interchange_with_jax(f32_models, arch):
    """A JAX sequence blob continues in the port, and a port blob in the
    JAX package: the next steps' logits within NMSE 1e-5."""
    model, jmodel, _ = f32_models(arch)
    jctx = jax_ctx(jmodel, n_seqs=2)
    jctx.prefill(prompt(10), seq=1)
    ctx = port_ctx(model, n_seqs=2)
    state.load_seq_state(ctx, 0, jstate.save_seq_state(jctx, 1))
    for t in (5, 6):
        assert nmse(ctx.decode_one(t, seq=0), np.asarray(jctx.decode_one(t, seq=1))) <= NMSE_F32
    back = jax_ctx(jmodel, n_seqs=2)
    jstate.load_seq_state(back, 0, state.save_seq_state(ctx, 0))
    for t in (7, 8):
        assert nmse(ctx.decode_one(t, seq=0), np.asarray(back.decode_one(t, seq=0))) <= NMSE_F32


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_whole_state_files_interchange_with_jax(f32_models, tmp_path, writer):
    """A whole-context state file (rwkv6, as the JAX package's own test
    writes it) written by one package and read by the other: the same
    next-step logits."""
    model, jmodel, _ = f32_models("rwkv6")
    jctx, ctx = jax_ctx(jmodel, n_seqs=2), port_ctx(model, n_seqs=2)
    src, dst = (jctx, ctx) if writer == "jax" else (ctx, jctx)
    src.generate([3, 5, 7, 9, 11, 13], max_new_tokens=4)
    path = str(tmp_path / "sess.bin")
    (jstate if writer == "jax" else state).save_state(src, path)
    (state if writer == "jax" else jstate).load_state(dst, path)
    assert int(ctx.seq_len[0]) == int(jctx.seq_len[0]) > 0
    for t in (21, 22):
        assert nmse(ctx.decode_one(t), np.asarray(jctx.decode_one(t))) <= NMSE_F32


# -- llama-cli and the server ---------------------------------------------------

def test_cli_on_rwkv_matches_generate(f32_models, capsys):
    """llama-cli on RWKV-7 prints what the JAX package's llama-cli prints
    (the same greedy ids); --spec-ngram is turned off with a note."""
    from llama_cpp_tpu.tools import cli as jcli

    from llama_cpp_tpu_torch.tools import cli

    _, _, path = f32_models("rwkv7")
    argv = ["-m", path, "-p", "the cat is on the mat", "-n", "8", "-c", "256", "--temp", "0"]
    capsys.readouterr()
    assert cli.main([*argv, "--device", "cpu"]) == 0
    ours = capsys.readouterr().out
    assert jcli.main(argv) == 0
    assert ours == capsys.readouterr().out
    assert cli.main([*argv, "--device", "cpu", "--spec-ngram"]) == 0
    out = capsys.readouterr()
    assert "speculative decoding: off" in out.err and out.out == ours


def test_bench_tool_runs_rwkv(f32_models, capsys):
    """llama-bench on RWKV-6: the pp and tg rows, and the batched grid (exact-
    shape decode batches), each with a positive rate."""
    from llama_cpp_tpu_torch.tools import bench_tool

    _, _, path = f32_models("rwkv6")
    argv = ["-m", path, "-p", "16", "-n", "4", "-c", "128", "--device", "cpu", "-o", "json"]
    capsys.readouterr()
    assert bench_tool.main(argv) == 0
    rows = json.loads(capsys.readouterr().out)["results"]
    assert [r["test"] for r in rows] == ["pp16", "tg4"] and all(r["t/s"] > 0 for r in rows)
    assert bench_tool.main(argv + ["--batched", "-b", "1,2"]) == 0
    rows = json.loads(capsys.readouterr().out)["results"]
    assert [r["B"] for r in rows] == [1, 2]
    assert all(r["S_PP t/s"] > 0 and r["S_TG t/s"] > 0 for r in rows)


def test_served_round_on_rwkv_equals_generate(f32_models):
    """Two concurrent requests on RWKV-7 served with -np 2: each reply's ids
    equal Context.generate's."""
    model, _, _ = f32_models("rwkv7")
    box, ready = {}, threading.Event()
    th = threading.Thread(target=server_app.run_server, args=(model,), daemon=True, kwargs=dict(
        host="127.0.0.1", port=0, device="cpu", n_seqs=2, n_ctx=64, n_ubatch=32,
        ready=lambda s: (box.setdefault("s", s), ready.set())))
    th.start()
    assert ready.wait(60)
    srv = box["s"]
    prompts = [prompt(9, seed=1), prompt(6, seed=2)]
    out = [None, None]

    def ask(i):
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/completion",
            data=json.dumps({"prompt": prompts[i], "n_predict": 6, "temperature": 0,
                             "ignore_eos": True, "return_tokens": True}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            out[i] = json.loads(r.read())

    try:
        threads = [threading.Thread(target=ask, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        srv.shutdown()
        th.join(timeout=30)
    for p, reply in zip(prompts, out):
        assert reply["tokens"] == port_ctx(model).generate(p, max_new_tokens=6)
