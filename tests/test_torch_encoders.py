"""The port's embedding and rerank path against the JAX package on the CPU:
the BERT-family encoders (bert, modern-bert, nomic-bert, nomic-bert-moe,
neo-bert, eurobert, jina-bert-v2, jina-bert-v3: models/bert.py), T5's
encoder (t5encoder: models/t5.py), EmbeddingGemma and llama-embed on the
shared decoder, through Context.embed / Context.encode and the server's
/v1/embeddings, /v1/rerank and /rerank.

Each entry on one small fixture (testing.make_bench_embedding_gguf: n_embd
256, 4 heads of 64, n_ff 512, vocab 300, 2 layers; F32 values) read by both
packages from the same bytes: layer keys, flags and extras equal; embed in
all four poolings (mean, cls, last, unpooled rows) at 7 and 600 tokens
within NMSE 1e-5 (600 tokens bucket to 1024 rows, past gemma-embedding's
window ring of 768 slots: held to what the JAX package computes there).
The branches that differ between the families are held live (turned off,
the embedding moves): jina-v2's ALiBi and attn_norm_2, ModernBERT's local
window (and its layer 0 without attn_norm), nomic-bert-moe's raw top-k
weights. A Q4_K/Q6_K bert file within NMSE 5e-3 (the JAX package loaded
without its q+k fusion, which its bert forward cannot read); the embed
bucket's 512-row floor; return_hidden on a tiny qwen3 and a tiny mamba2;
t5encoder's encode at 7 and 200 tokens, and embed on it raising TypeError
in both packages; the three server routes against the JAX ServerApp on the
same file; from_jax on an encoder's parameters."""

import asyncio
import copy
import json
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from llama_cpp_tpu.models.loader import load_model as jax_load_model
from llama_cpp_tpu.runtime.context import Context as JaxContext
from llama_cpp_tpu.server.app import ServerApp as JaxServerApp
from llama_cpp_tpu.server.scheduler import Scheduler as JaxScheduler
from llama_cpp_tpu_torch.models.from_jax import params_from_jax
from llama_cpp_tpu_torch.models.loader import Model, load_model
from llama_cpp_tpu_torch.models.registry import supported_archs
from llama_cpp_tpu_torch.models.transformer import AttnInputs
from llama_cpp_tpu_torch.runtime.context import Context
from llama_cpp_tpu_torch.server import app as server_app
from llama_cpp_tpu_torch.testing import (EMBEDDING_ARCHS, HYBRID_LAYOUTS,
                                         make_bench_arch_gguf, make_bench_embedding_gguf,
                                         make_bench_hybrid_gguf)

SHAPE = dict(n_layers=2, n_embd=256, n_heads=4, n_ff=512, vocab_size=300)
POSITIONS = dict(n_positions=1024)  # bert's table cut from BGE-M3's 8194 rows
CTX = dict(n_ctx=1024, n_seqs=1)
POOLINGS = ("mean", "cls", "last", "none")
EMBEDDERS = [a for a in EMBEDDING_ARCHS if a != "t5encoder"]
FLAGS = ("rope_type", "act", "glu", "use_rms_norm", "norm_eps", "rms_eps", "alibi_bias",
         "sliding_window", "swa_pattern", "n_expert", "n_expert_used", "expert_weights_norm",
         "qk_norm", "post_norms", "embd_scale", "attn_scale", "tie_embeddings", "n_ff",
         "n_layers", "head_dim_k", "head_dim_v")
EXTRAS = ("encoder", "pre_norm_encoder", "non_causal", "t5", "t5_encoder_only", "rel_buckets",
          "enc_n_layers", "swa_first_global", "rope_freq_base_swa", "tensor_remap")
NMSE_F32 = 1e-5
NMSE_QUANT = 5e-3


def nmse(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(((got - ref) ** 2).mean() / ((ref ** 2).mean() + 1e-30))


def prompt(n, seed=0):
    return [int(t) for t in np.random.default_rng(seed).integers(3, SHAPE["vocab_size"], n)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fixture(tmp_path_factory, arch, **kw):
    path = str(tmp_path_factory.mktemp("enc") / f"{arch}.gguf")
    extra = POSITIONS if arch == "bert" else {}
    return make_bench_embedding_gguf(path, arch, **SHAPE, **{**extra, **kw})


@pytest.fixture(scope="module")
def f32_models(tmp_path_factory):
    """(port model, JAX model) of an entry's F32 file, made at first use."""
    made = {}

    def get(arch):
        if arch not in made:
            path = _fixture(tmp_path_factory, arch, f32=True)
            made[arch] = (load_model(path, device="cpu", dense_dtype=torch.float32),
                          jax_load_model(path, prefer_quant=False, dense_dtype=jnp.float32))
        return made[arch]

    return get


def contexts(model, jmodel):
    return Context(model, device="cpu", **CTX), JaxContext(jmodel, kv_dtype=jnp.float32, **CTX)


def test_supported_archs_cover_the_slice():
    assert set(EMBEDDING_ARCHS) <= set(supported_archs())
    assert len(EMBEDDING_ARCHS) == 11


@pytest.mark.parametrize("arch", EMBEDDING_ARCHS)
def test_layer_keys_and_flags_match_jax(f32_models, arch):
    model, jmodel = f32_models(arch)
    for key in ("layers", "enc_layers"):
        assert [set(lw) for lw in model.params.get(key, [])] == [
            set(lw) for lw in jmodel.params.get(key, [])], key
    assert set(model.params) == set(jmodel.params)
    for name in FLAGS:
        assert getattr(model.cfg, name) == pytest.approx(getattr(jmodel.cfg, name)), name
    for key in EXTRAS:
        assert model.cfg.extra.get(key) == jmodel.cfg.extra.get(key), key


@pytest.mark.parametrize("n", [7, 600])
@pytest.mark.parametrize("arch", EMBEDDERS)
def test_embed_matches_jax_in_every_pooling(f32_models, arch, n):
    """f32 weights, activations and memory; 7 tokens run a 512-row bucket,
    600 a 1024-row one."""
    model, jmodel = f32_models(arch)
    ctx, jctx = contexts(model, jmodel)
    toks = prompt(n, seed=n)
    for pooling in POOLINGS:
        got = ctx.embed(toks, pooling=pooling)
        ref = np.asarray(jctx.embed(toks, pooling=pooling), np.float32)
        assert got.shape == ref.shape == ((n, 256) if pooling == "none" else (256,))
        assert np.isfinite(got).all()
        assert nmse(got, ref) < NMSE_F32, pooling


def test_gemma_embedding_bucket_past_its_window_ring(f32_models):
    """A 600-token embed buckets to 1024 rows over 1032 slots; the window
    layer's ring is ceil((128 + 512 + 1) / 256) * 256 = 768 slots in both
    packages, so the window layer's keys wrap within the bucket. The port
    holds what the JAX package computes there."""
    model, jmodel = f32_models("gemma-embedding")
    ctx, jctx = contexts(model, jmodel)
    kv = ctx._make_memory(n_seqs=1, n_slots=1024 + 8)
    assert kv.swa.n_slots == 768 and kv.full.n_slots == 1032
    toks = prompt(600, seed=5)
    assert nmse(ctx.embed(toks, pooling="none"),
                np.asarray(jctx.embed(toks, pooling="none"), np.float32)) < NMSE_F32


def _embedding_with(model, toks, **change):
    """Embed of toks (unpooled) on a copy of the model whose config or
    layers are changed: cfg fields, or drop=<layer key>."""
    cfg = copy.deepcopy(model.cfg)
    params = dict(model.params)
    drop = change.pop("drop", None)
    if drop:
        params["layers"] = [{k: w for k, w in lw.items() if not k.startswith(drop)}
                            for lw in model.params["layers"]]
    for key, val in change.items():
        setattr(cfg, key, val)
    return Context(Model(cfg, params, model.device, model.tokenizer), device="cpu",
                   **CTX).embed(toks, pooling="none")


BRANCHES = {
    "jina_v2_alibi": ("jina-bert-v2", dict(alibi_bias=0.0)),
    "jina_v2_attn_norm_2": ("jina-bert-v2", dict(drop="attn_norm_2")),
    "modern_bert_local_window": ("modern-bert", dict(sliding_window=0)),
    "nomic_moe_raw_topk": ("nomic-bert-moe", dict(expert_weights_norm=True)),
}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_family_branch_is_held_live(f32_models, branch):
    """The branch is on in both packages at this fixture, and the port with
    it turned off parts from the JAX package: the equality of the embed
    tests holds the branch itself."""
    arch, change = BRANCHES[branch]
    model, jmodel = f32_models(arch)
    toks = prompt(300, seed=11)  # 300 rows: ModernBERT's window of 128 cuts
    ref = np.asarray(JaxContext(jmodel, kv_dtype=jnp.float32, **CTX).embed(
        toks, pooling="none"), np.float32)
    assert nmse(Context(model, device="cpu", **CTX).embed(toks, pooling="none"),
                ref) < NMSE_F32
    assert nmse(_embedding_with(model, toks, **change), ref) > 1e-4


def test_modern_bert_layer0_has_no_attn_norm(f32_models):
    model, jmodel = f32_models("modern-bert")
    for m in (model, jmodel):
        assert "attn_norm" not in m.params["layers"][0]
        assert "attn_norm" in m.params["layers"][1]
    assert [model.cfg.is_swa_layer(i) for i in range(2)] == [False, True]


@pytest.fixture(scope="module")
def quant_bert(tmp_path_factory):
    """bert in the Q4_K_M mix (Q6_K attn_v and ffn_down), synthetic block
    scales / 256. The port fuses q+k (attn_qk) beside attn_v, as its loader
    does for every family; the JAX package's bert forward reads only
    attn_qkv or q, k, v apart, so it is loaded without its fusion."""
    path = _fixture(tmp_path_factory, "bert", synth_scale=1.0 / 256)
    return path, load_model(path, device="cpu"), jax_load_model(path, fuse=False)


@pytest.mark.parametrize("n", [7, 600])
def test_quantized_bert_matches_jax(quant_bert, n):
    _, model, jmodel = quant_bert
    assert "attn_qk" in model.params["layers"][0]
    ctx = Context(model, device="cpu", **CTX)
    jctx = JaxContext(jmodel, **CTX)
    toks = prompt(n, seed=3)
    for pooling in ("mean", "none"):
        got = ctx.embed(toks, pooling=pooling)
        assert np.isfinite(got).all()
        assert nmse(got, np.asarray(jctx.embed(toks, pooling=pooling), np.float32)) < NMSE_QUANT


def test_jax_bert_cannot_read_its_own_qk_fusion(quant_bert):
    """A reference behaviour: the JAX loader fuses a Q4_K_M file's q+k into
    attn_qk (its attn_v is Q6_K), which its bert forward does not read."""
    path = quant_bert[0]
    jmodel = jax_load_model(path)
    assert "attn_qk" in jmodel.params["layers"][0]
    with pytest.raises(KeyError, match="attn_q"):
        JaxContext(jmodel, **CTX).embed(prompt(7))


@pytest.mark.parametrize("n,rows", [(7, 512), (512, 512), (513, 1024), (1000, 1024)])
def test_embed_bucket_has_a_512_row_floor(f32_models, monkeypatch, n, rows):
    """One forward of max(bucket(n), ceil(n / 512) * 512) rows over bucket +
    8 slots (the JAX package's context.py:827-828)."""
    model, _ = f32_models("bert")
    seen = []
    fwd = type(model).forward_fn.fget(model)

    def spy(params, cfg, tokens, inputs, kv, *a, **kw):
        seen.append((tuple(tokens.shape), kv.n_slots if hasattr(kv, "n_slots") else None))
        return fwd(params, cfg, tokens, inputs, kv, *a, **kw)

    monkeypatch.setattr(type(model), "forward_fn", property(lambda self: spy))
    Context(model, device="cpu", **CTX).embed(prompt(n))
    assert [s[0] for s in seen] == [(1, rows)]


@pytest.fixture(scope="module")
def tiny_decoders(tmp_path_factory):
    d = tmp_path_factory.mktemp("hidden")
    q = make_bench_arch_gguf(str(d / "qwen3.gguf"), "qwen3", 2, 256, 4, 2, 64, 512, 300,
                             qk_norm=True, f32=True)
    m = make_bench_hybrid_gguf(str(d / "mamba2.gguf"), "mamba2", n_embd=256, vocab_size=300,
                               f32=True, **HYBRID_LAYOUTS["mamba2"])
    return {name: (load_model(p, device="cpu", dense_dtype=torch.float32),
                   jax_load_model(p, prefer_quant=False, dense_dtype=jnp.float32))
            for name, p in (("qwen3", q), ("mamba2", m))}


@pytest.mark.parametrize("arch", ["qwen3", "mamba2"])
def test_return_hidden_matches_jax(tiny_decoders, arch):
    """The hidden rows after output_norm (the port's forward with
    return_hidden) through embed in every pooling, against the JAX
    package's; and the same forward's logits are the hidden rows through
    the head."""
    model, jmodel = tiny_decoders[arch]
    ctx, jctx = contexts(model, jmodel)
    toks = prompt(20, seed=4)
    for pooling in POOLINGS:
        assert nmse(ctx.embed(toks, pooling=pooling),
                    np.asarray(jctx.embed(toks, pooling=pooling), np.float32)) < NMSE_F32
    c = Context(model, device="cpu", **CTX)
    kv = c._make_memory(n_seqs=1, n_slots=520)
    inputs = AttnInputs(seq_idx=torch.zeros(1, dtype=torch.int32),
                        positions=torch.arange(20)[None])
    hidden = model.forward_fn(model.params, model.cfg, torch.tensor([toks]), inputs, kv,
                              kernels=False, return_hidden=True)
    head = model.params.get("output", model.params["token_embd"])
    logits = c.decode(np.asarray([toks]), np.asarray([0]), np.arange(20)[None], np.arange(20))
    assert nmse(hidden.float() @ head.float().t(), logits) < 1e-8


@pytest.mark.parametrize("n", [7, 200])
def test_t5encoder_encode_matches_jax(f32_models, n):
    model, jmodel = f32_models("t5encoder")
    ctx, jctx = contexts(model, jmodel)
    toks = prompt(n, seed=7)
    got = ctx.encode(toks)
    assert got.shape == (n, 256) and np.isfinite(got).all()
    assert nmse(got, np.asarray(jctx.encode(toks), np.float32)) < NMSE_F32


def test_embed_on_t5encoder_raises_as_in_jax(f32_models):
    """T5's encoder-only forward takes no return_hidden in either package."""
    for ctx in contexts(*f32_models("t5encoder")):
        with pytest.raises(TypeError, match="return_hidden"):
            ctx.embed(prompt(5))


@pytest.mark.parametrize("arch", ["bert", "nomic-bert-moe", "t5encoder"])
def test_from_jax_on_an_encoder(f32_models, arch):
    """The JAX package's parameters (token types, expert stacks, T5's
    enc_layers with attn_rel_b) carried across compute the port's own."""
    model, jmodel = f32_models(arch)
    import jax

    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jmodel.params))
    twin = Model(model.cfg, params, model.device, model.tokenizer)
    toks = prompt(9, seed=9)
    if arch == "t5encoder":
        got, ref = (Context(m, device="cpu", **CTX).encode(toks) for m in (twin, model))
    else:
        got, ref = (Context(m, device="cpu", **CTX).embed(toks, pooling="none")
                    for m in (twin, model))
    assert nmse(got, ref) < 1e-12


class Served:
    """The port's server in a thread on a free port of 127.0.0.1."""

    def __init__(self, model, **kw):
        box, ready = {}, threading.Event()

        def on_ready(server):
            box["server"] = server
            ready.set()

        self.thread = threading.Thread(
            target=server_app.run_server, args=(model,), daemon=True,
            kwargs=dict(host="127.0.0.1", port=0, ready=on_ready, **kw))
        self.thread.start()
        assert ready.wait(60), "the server did not start"
        self.server = box["server"]
        self.url = f"http://127.0.0.1:{self.server.port}"

    def request(self, path, body):
        req = urllib.request.Request(self.url + path, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())

    def close(self):
        self.server.shutdown()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """The port's server and the JAX package's ServerApp (aiohttp's test
    client on a private loop) on the same F32 bert file."""
    path = _fixture(tmp_path_factory, "bert", f32=True)
    port = Served(load_model(path, device="cpu", dense_dtype=torch.float32), n_seqs=1,
                  n_ctx=256)
    sched = JaxScheduler(JaxContext(jax_load_model(path, prefer_quant=False,
                                                   dense_dtype=jnp.float32),
                                    n_ctx=256, n_seqs=1, kv_dtype=jnp.float32))
    sched.start()
    loop = asyncio.new_event_loop()
    client = TestClient(TestServer(JaxServerApp(sched, model_name="model").app), loop=loop)
    loop.run_until_complete(client.start_server())

    def jax_request(route, body):
        async def go():
            r = await client.post(route, json=body)
            return r.status, json.loads(await r.read())
        return loop.run_until_complete(go())

    yield port.request, jax_request
    loop.run_until_complete(client.close())
    loop.close()
    sched.stop()
    port.close()


DOCS = ["the cat is on the mat", "a dog was in the house", "the end of it", "is it on",
        "and that was that", "the mat", "on the", "it was the cat and the dog"]
ROUTES = {
    "embeddings_list": ("/v1/embeddings", {"input": ["the cat", "a dog is in", "of it", "x"]}),
    "embeddings_one": ("/v1/embeddings", {"input": "the cat is on the mat"}),
    "v1_rerank": ("/v1/rerank", {"query": "the cat on the mat", "documents": DOCS}),
    "rerank_top_n": ("/rerank", {"query": "a dog", "documents": DOCS, "top_n": 3}),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_embedding_routes_match_the_jax_server(servers, route):
    """200 from both; the vectors within 1e-6, unit length; the rerank
    results in the same order with the same scores within 1e-6."""
    port, jax_request = servers
    path, body = ROUTES[route]
    (status, got), (jstatus, ref) = port(path, body), jax_request(path, body)
    assert status == jstatus == 200
    if "embeddings" in route:
        assert [d["index"] for d in got["data"]] == [d["index"] for d in ref["data"]]
        for d, r in zip(got["data"], ref["data"]):
            np.testing.assert_allclose(d["embedding"], r["embedding"], atol=1e-6)
            assert abs(np.linalg.norm(d["embedding"]) - 1.0) < 1e-5
        assert got["usage"] == ref["usage"] == {"prompt_tokens": 0, "total_tokens": 0}
    else:
        assert [r["index"] for r in got["results"]] == [r["index"] for r in ref["results"]]
        np.testing.assert_allclose([r["relevance_score"] for r in got["results"]],
                                   [r["relevance_score"] for r in ref["results"]], atol=1e-6)
        assert len(got["results"]) == body.get("top_n", len(DOCS))
