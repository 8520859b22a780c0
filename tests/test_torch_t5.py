"""T5's encoder-decoder in the port against the JAX package on the CPU:
models/t5.py's t5_forward (self-attention over the slot-table memory with
the unidirectional relative bias, cross-attention over the encoder's
output), Context's encoder-decoder flow (encode, the decoder's start token,
the cross state padded across a batch, seq_rm dropping it), the on-device
loops refusing it by name, and llama-cli, llama-server and llama-bench on a
t5 file.

Checkpoints: transformers T5 models with random weights (ReLU and gated
GELU, tied and untied heads), converted by the JAX package's converter
as tests/test_model_parity.py converts them, and the port's own synthetic
t5 file (testing.make_bench_t5_gguf, F32 values and a vocab) for the
entry points. Both packages load each file in f32: t5_forward's logits
within NMSE 1e-5 at prefill and stepwise; greedy ids equal."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from llama_cpp_tpu.convert.hf_to_gguf import convert_hf_model
from llama_cpp_tpu.models import t5 as jt5
from llama_cpp_tpu.models.loader import load_model as jax_load_model
from llama_cpp_tpu.models.transformer import AttnInputs as JaxAttnInputs
from llama_cpp_tpu.runtime.context import Context as JaxContext
from llama_cpp_tpu.runtime.kv_cache import KVCache as JaxKVCache
from llama_cpp_tpu_torch.models import t5
from llama_cpp_tpu_torch.models.loader import load_model
from llama_cpp_tpu_torch.models.transformer import AttnInputs
from llama_cpp_tpu_torch.runtime.context import Context
from llama_cpp_tpu_torch.runtime.kv_cache import KVCache
from llama_cpp_tpu_torch.testing import make_bench_t5_gguf
from llama_cpp_tpu_torch.tools import bench_tool, cli

NMSE_F32 = 1e-5
ENC = [4, 19, 7, 33, 2, 60, 11, 5, 91]
DEC = [0, 8, 15, 3, 44]
# (feed_forward_proj, tie_word_embeddings): flan's gated GELU and T5's ReLU,
# tied and untied heads; the ReLU models' decoders one layer deeper than their
# encoders
VARIANTS = {"relu_tied": ("relu", True), "gated_untied": ("gated-gelu", False),
            "relu_untied": ("relu", False), "gated_tied": ("gated-gelu", True)}
VARIANT = pytest.mark.parametrize("variant", list(VARIANTS))
CTX = dict(n_ctx=64, n_seqs=2)


def nmse(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.mean((got - ref) ** 2) / (np.mean(ref ** 2) + 1e-30))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small steps under pytest-xdist's workers on a shared CPU: torch's
    thread pool would spend more than the work on waking its threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """variant -> (path, port model, JAX model, the transformers model) from
    one converted file, made at first use; "synthetic" -> the port's own t5
    file (no transformers model)."""
    made = {}

    def get(variant):
        if variant in made:
            return made[variant]
        d = tmp_path_factory.mktemp(variant)
        path = str(d / f"{variant}.gguf")
        hf = None
        if variant == "synthetic":
            make_bench_t5_gguf(path, n_layers=2, n_dec_layers=2, n_embd=64, n_heads=4,
                               n_ff=128, vocab_size=256, n_buckets=8, f32=True, seed=3)
        else:
            proj, tie = VARIANTS[variant]
            cfg = transformers.T5Config(
                vocab_size=150, d_model=48, d_kv=12, d_ff=96, num_layers=2,
                num_decoder_layers=3 if proj == "relu" else 2, num_heads=4,
                relative_attention_num_buckets=8,
                feed_forward_proj=proj, tie_word_embeddings=tie, decoder_start_token_id=0,
                pad_token_id=0, eos_token_id=1)
            torch.manual_seed(80 + list(VARIANTS).index(variant))
            hf = transformers.T5ForConditionalGeneration(cfg).eval()
            convert_hf_model(hf, path, ftype="f32")
        made[variant] = (path, load_model(path, device="cpu", dense_dtype=torch.float32),
                         jax_load_model(path, prefer_quant=False, dense_dtype=jnp.float32), hf)
        return made[variant]

    return get


def port_ctx(model, **kw):
    return Context(model, device="cpu", **{**CTX, **kw})


def jax_ctx(jmodel, **kw):
    return JaxContext(jmodel, kv_dtype=jnp.float32, **{**CTX, **kw})


@VARIANT
def test_layers_and_config_match_jax(models, variant):
    _, model, jmodel, _ = models(variant)
    for key in ("layers", "enc_layers"):
        assert [set(lw) for lw in model.params[key]] == [set(lw) for lw in jmodel.params[key]]
    assert set(model.params) == set(jmodel.params)
    for key in ("t5", "encoder_decoder", "rel_buckets", "enc_n_layers", "decoder_start_token"):
        assert model.cfg.extra.get(key) == jmodel.cfg.extra.get(key), key
    assert (model.cfg.n_layers, model.cfg.logit_scale) == (jmodel.cfg.n_layers,
                                                          jmodel.cfg.logit_scale)


def _port_forward(model, cross, toks, positions, kv):
    inputs = AttnInputs(seq_idx=torch.zeros(1, dtype=torch.int32),
                        positions=torch.tensor([positions], dtype=torch.int32))
    return t5.t5_forward(model.params, model.cfg, torch.tensor([toks]), inputs, kv,
                         cross=cross).numpy()


def _jax_forward(jmodel, cross, toks, positions, kv):
    inputs = JaxAttnInputs(seq_idx=jnp.zeros(1, jnp.int32),
                           slots=jnp.asarray([positions], jnp.int32),
                           positions=jnp.asarray([positions], jnp.int32))
    logits, kv = jt5.t5_forward(jmodel.params, jmodel.cfg, jnp.asarray([toks], jnp.int32),
                                inputs, kv, cross=cross)
    return np.asarray(logits), kv


def _memories(model):
    cfg = model.cfg
    kv = KVCache.create(cfg.n_layers, 1, 32, cfg.n_kv_heads, cfg.head_dim_k, cfg.head_dim_v,
                        dtype=torch.float32, device="cpu")
    jkv = JaxKVCache.create(cfg.n_layers, 1, 32, cfg.n_kv_heads, cfg.head_dim_k,
                            cfg.head_dim_v, dtype=jnp.float32)
    return kv, jkv


@VARIANT
def test_t5_forward_prefill_matches_jax(models, variant):
    """The encoder's output and the decoder's logits of a 5-token ubatch
    over it, as tests/test_model_parity.py's _t5_parity drives them."""
    _, model, jmodel, _ = models(variant)
    cross = t5.t5_encode(model.params, model.cfg, torch.tensor([ENC]))
    jcross = jt5.t5_encode(jmodel.params, jmodel.cfg, jnp.asarray([ENC], jnp.int32))
    assert nmse(cross.numpy(), np.asarray(jcross)) <= NMSE_F32
    kv, jkv = _memories(model)
    pos = list(range(len(DEC)))
    got = _port_forward(model, cross, DEC, pos, kv)
    ref, _ = _jax_forward(jmodel, jcross, DEC, pos, jkv)
    assert got.shape == ref.shape and nmse(got, ref) <= NMSE_F32


@VARIANT
def test_t5_forward_stepwise_matches_jax_and_the_ubatch(models, variant):
    """One decoder token at a time through the memory: each step's logits
    within NMSE 1e-5 of the JAX package's, and of the ubatch's row."""
    _, model, jmodel, _ = models(variant)
    cross = t5.t5_encode(model.params, model.cfg, torch.tensor([ENC]))
    jcross = jt5.t5_encode(jmodel.params, jmodel.cfg, jnp.asarray([ENC], jnp.int32))
    kv, jkv = _memories(model)
    whole = _port_forward(model, cross, DEC, list(range(len(DEC))), _memories(model)[0])
    for i, t in enumerate(DEC):
        got = _port_forward(model, cross, [t], [i], kv)
        ref, jkv = _jax_forward(jmodel, jcross, [t], [i], jkv)
        assert nmse(got, ref) <= NMSE_F32
        assert nmse(got[0], whole[i]) <= NMSE_F32


def test_t5_forward_needs_the_cross_state(models):
    _, model, _, _ = models("relu_tied")
    with pytest.raises(ValueError, match="cross"):
        _port_forward(model, None, DEC, list(range(len(DEC))), _memories(model)[0])


@pytest.mark.parametrize("variant", [*VARIANTS, "synthetic"])
def test_generate_matches_jax(models, variant):
    """Context.generate: the prompt encoded, the start token decoded at
    position 0, then greedy steps: the ids of the JAX package's."""
    _, model, jmodel, _ = models(variant)
    prompt = ENC if variant != "synthetic" else [5, 77, 140, 9, 33, 201, 17]
    got = port_ctx(model).generate(prompt, max_new_tokens=10)
    assert got == jax_ctx(jmodel).generate(prompt, max_new_tokens=10)


def test_generate_matches_transformers(models):
    """The port's ids are transformers' greedy generate's."""
    _, model, _, hf = models("gated_untied")
    with torch.no_grad():
        ref = hf.generate(torch.tensor([ENC]), max_new_tokens=10, do_sample=False)[0][1:]
    assert port_ctx(model).generate(ENC, max_new_tokens=10) == ref.tolist()


@pytest.mark.parametrize("variant", ["gated_untied", "relu_tied"])
def test_prefill_and_steps_match_jax_context(models, variant):
    """Context.prefill (the start token's logits) and 4 decode_one steps
    teacher-forced: logits within NMSE 1e-5 of the JAX Context's; encode's
    output is the JAX one's."""
    _, model, jmodel, _ = models(variant)
    ctx, jctx = port_ctx(model), jax_ctx(jmodel)
    errs = [nmse(ctx.prefill(ENC), np.asarray(jctx.prefill(ENC)))]
    for t in (5, 77, 140, 9):
        errs.append(nmse(ctx.decode_one(t), np.asarray(jctx.decode_one(t))))
    assert max(errs) <= NMSE_F32
    assert nmse(port_ctx(model).encode(ENC, seq=1), jax_ctx(jmodel).encode(ENC, seq=1)) <= (
        NMSE_F32)


@pytest.mark.parametrize("variant", ["gated_untied", "synthetic"])
def test_batch_of_two_rows_equal_their_b1_runs(models, variant):
    """Two sequences whose encoder outputs are 5 and 11 rows (one cross
    state padded to 64 rows, the pad masked): batched greedy steps
    (decode_step_greedy) give each row its own B=1 run's ids, and a batched
    decode_step_multi's logits each row's B=1 logits within NMSE 1e-5."""
    _, model, _, _ = models(variant)
    vocab = model.cfg.vocab_size
    prompts = [ENC[:5], [int(t) for t in np.random.default_rng(2).integers(3, vocab, 11)]]
    ctx = port_ctx(model)
    toks = np.asarray([int(np.argmax(ctx.prefill(p, seq=s))) for s, p in enumerate(prompts)])
    rows = [[int(t)] for t in toks]
    for _ in range(5):
        toks = ctx.decode_step_greedy(toks, np.arange(2))
        for s in range(2):
            rows[s].append(int(toks[s]))
    for s, p in enumerate(prompts):
        assert rows[s] == port_ctx(model).generate(p, max_new_tokens=6)
    both = ctx.decode_step_multi(toks, np.arange(2))
    for s, p in enumerate(prompts):
        one = port_ctx(model)
        one.prefill(p)
        for t in rows[s]:
            lg = one.decode_one(t)
        assert nmse(both[s], lg) <= NMSE_F32


def test_seq_rm_drops_the_cross_state(models):
    """seq_rm(seq) (p0 = 0) drops the sequence's encoder output, a suffix
    removal keeps it; the next prefill encodes again; seq_cp carries it."""
    _, model, _, _ = models("relu_tied")
    ctx = port_ctx(model)
    first = ctx.prefill(ENC, seq=0)
    assert 0 in ctx._cross and ctx.seq_len[0] == 1
    ctx.decode_one(5, seq=0)
    ctx.seq_rm(0, p0=1)
    assert 0 in ctx._cross and ctx.seq_len[0] == 1
    ctx.seq_cp(1, 0)
    assert torch.equal(ctx._cross[1], ctx._cross[0])
    ctx.seq_rm(0)
    assert 0 not in ctx._cross and ctx.seq_len[0] == 0
    np.testing.assert_allclose(ctx.prefill(ENC, seq=0), first, rtol=1e-6, atol=1e-6)
    ctx.reset()
    assert not ctx._cross


def test_on_device_loops_raise_naming_t5(models):
    """The on-device loops carry no cross state (nor do the JAX package's):
    decode_steps_greedy, generate_ondevice and decode_loop raise naming
    the architecture; the one-step calls run eagerly through decode."""
    _, model, _, _ = models("relu_tied")
    ctx = port_ctx(model)
    ctx.prefill(ENC)
    for call in (lambda: ctx.decode_steps_greedy(np.asarray([5]), np.asarray([0]), 3),
                 lambda: ctx.generate_ondevice(ENC, max_new_tokens=3, seq=1),
                 lambda: ctx.decode_loop(1)):
        with pytest.raises(NotImplementedError, match="'t5'"):
            call()
    assert not ctx._loops and not ctx.paged


def _run(main, argv, capsys):
    capsys.readouterr()
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def test_llama_cli_prints_the_generated_text(models, capsys):
    """llama-cli on the synthetic t5 file (--device cpu): the text of the
    JAX package's Context.generate ids up to an end-of-generation token."""
    path, model, jmodel, _ = models("synthetic")
    prompt = "the cat is on the mat"
    rc, out, err = _run(cli.main, ["-m", path, "-p", prompt, "-n", "8", "-c", "64", "--temp",
                                   "0", "--device", "cpu", "--no-quant"], capsys)
    tok = model.tokenizer
    ids = tok.encode(prompt, add_special=True, parse_special=True)
    want = []
    for t in jax_ctx(jmodel).generate(ids, max_new_tokens=8):
        if tok.is_eog(t):
            break
        want.append(t)
    assert rc == 0 and out == "".join(tok.piece(t) for t in want) + "\n"
    assert "perf: prompt" in err


def test_served_round_equals_generate(models):
    """llama-server over the t5 model (two concurrent greedy requests): each
    request's prompt goes through the encoder (Context.prefill), its steps
    eager; the ids equal Context.generate's and the JAX package's."""
    import threading

    from test_torch_server import Served

    _, model, jmodel, _ = models("synthetic")
    tok = model.tokenizer
    prompts = ["the cat is on the mat", "a long story about the end of it all"]
    s = Served(model, n_seqs=2, n_ctx=64, n_ubatch=64, device="cpu")
    try:
        replies = [None, None]

        def ask(i):
            replies[i] = s.request("/completion", {
                "prompt": prompts[i], "n_predict": 6, "temperature": 0, "ignore_eos": True,
                "return_tokens": True})

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        for i, (status, raw) in enumerate(replies):
            ids = tok.encode(prompts[i], add_special=True, parse_special=True)
            want = port_ctx(model).generate(ids, max_new_tokens=6, stop_fn=lambda t: False)
            assert status == 200 and json.loads(raw)["tokens"][: len(want)] == want
            assert want == jax_ctx(jmodel).generate(ids, max_new_tokens=6)[: len(want)]
    finally:
        s.close()


def test_llama_bench_runs_the_eager_steps(models, capsys):
    """llama-bench on the t5 file: pp through the encoder, tg through
    Context.generate's eager steps (the on-device loop refuses t5)."""
    path, _, _, _ = models("synthetic")
    rc, out, _ = _run(bench_tool.main, ["-m", path, "-p", "16", "-n", "4", "-c", "64", "-o",
                                        "json", "--device", "cpu", "--no-quant"], capsys)
    rows = json.loads(out)["results"]
    assert rc == 0 and [r["test"] for r in rows] == ["pp16", "tg4"]
    assert all(r["t/s"] > 0 for r in rows)


def test_params_from_jax_carry_the_decoder(models):
    """The JAX package's T5 params (encoder blocks, decoder blocks with
    their cross-attention) through params_from_jax: the port's prefill
    logits bit for bit."""
    import jax

    from llama_cpp_tpu_torch.models.from_jax import params_from_jax
    from llama_cpp_tpu_torch.models.loader import Model

    _, model, jmodel, _ = models("gated_untied")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jmodel.params))
    assert "cross_attn_q" in params["layers"][0] and "attn_rel_b" in params["enc_layers"][0]
    converted = Model(model.cfg, params, torch.device("cpu"))
    np.testing.assert_array_equal(port_ctx(converted).prefill(ENC), port_ctx(model).prefill(ENC))
