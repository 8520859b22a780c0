"""The port's gemma3n, gemma4 and gemma4-assistant entries against the JAX
package on the CPU, on files both read from the same bytes:

  * Gemma 3n: the JAX tests' fixture (tests/test_model_parity.py
    test_gemma3n), a tiny transformers Gemma3nForCausalLM of 6 layers
    through the JAX package's converter (f32): the kv_reuse map, the ISWA
    memory's aliased lines, prefill logits against JAX gemma3n.forward and
    the transformers model at the JAX test's rtol/atol of 3e-3, 8 greedy
    ids, stepwise decode equal to the one-shot prefill, shared layers that
    write no line; and the port's Q4_K_M fixture maker at a tiny width,
    held teacher-forced (logit NMSE <= 1e-4 a step);
  * Gemma 4, on tests/test_archs3.py::test_gemma4's layout
    (testing.make_bench_gemma4_gguf): window heads narrower than full, a
    shared tail layer, V from K, the dual-branch MoE, rope_freqs: logits,
    greedy ids, the rings' head dims, a Q4_K_M file teacher-forced, and
    the pre-output-norm features of Context.decode(aux=True);
  * the assistant, on tests/test_speculative.py::_gemma4_pair's layout:
    drafts, acceptance and final ids equal Gemma4AssistantSpeculator's run
    on the JAX package, the output the target's greedy ids.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_tpu.models.loader import load_model as jax_load_model
from llama_cpp_tpu.runtime.context import Context as JaxContext
from llama_cpp_tpu_torch.models.loader import load_model
from llama_cpp_tpu_torch.runtime.context import Context
from llama_cpp_tpu_torch.runtime.kv_cache import ISWACache
from llama_cpp_tpu_torch.testing import (make_bench_gemma3n_gguf,
                                         make_bench_gemma4_assistant_gguf,
                                         make_bench_gemma4_gguf)

transformers = pytest.importorskip("transformers")

TOKENS = [2, 5, 40, 96, 7, 130, 22, 9]
# tests/test_archs3.py::test_gemma4's layout
G4 = dict(n_layers=4, n_embd=64, n_heads=4, n_kv_heads=2, head_dim=16, head_dim_swa=8, n_ff=96,
          vocab_size=96, is_swa=(1, 0, 1, 1), sliding_window=4, shared_kv_layers=1,
          n_embd_per_layer=8, n_expert=4, n_expert_used=2, n_ff_exp=32, moe_layers=(1,),
          alt_v_layers=(2,))
# tests/test_speculative.py::_gemma4_pair's
PAIR = dict(n_embd=64, n_heads=4, n_kv_heads=2, head_dim=16, head_dim_swa=8, n_ff=96,
            vocab_size=96, sliding_window=8)
PROMPT = [3, 5, 9, 2, 7, 11, 13, 17, 19, 23]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nmse(got, ref):
    return float(np.mean((got - ref) ** 2) / np.mean(ref ** 2))


def hf_gemma3n(n_altup, sparsity, seed):
    cfg = transformers.Gemma3nTextConfig(
        vocab_size=150, vocab_size_per_layer_input=150, hidden_size=48,
        intermediate_size=[64] * 6, num_hidden_layers=6,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        altup_num_inputs=n_altup, altup_active_idx=0, laurel_rank=8,
        hidden_size_per_layer_input=16, num_kv_shared_layers=2,
        layer_types=["sliding_attention", "sliding_attention", "full_attention"] * 2,
        sliding_window=4, rope_theta=1000000.0, rope_local_base_freq=10000.0,
        activation_sparsity_pattern=sparsity, final_logit_softcapping=30.0,
        max_position_embeddings=64, rms_norm_eps=1e-6)
    torch.manual_seed(seed)
    return transformers.Gemma3nForCausalLM(cfg).eval()


def f32_pair(path):
    return (load_model(path, device="cpu", prefer_quant=False, dense_dtype=torch.float32),
            jax_load_model(path, prefer_quant=False, dense_dtype=jnp.float32))


@pytest.fixture(scope="module")
def g3n(tmp_path_factory):
    """The JAX test's Gemma 3n: (port model, JAX model, transformers model)."""
    from llama_cpp_tpu.convert.hf_to_gguf import convert_hf_model

    hf = hf_gemma3n(4, [0.95, 0.95, 0.0, 0.0, 0.0, 0.0], 71)
    path = str(tmp_path_factory.mktemp("g3n") / "g3n.gguf")
    convert_hf_model(hf, path, ftype="f32")
    return (*f32_pair(path), hf)


@pytest.fixture(scope="module")
def g4(tmp_path_factory):
    return f32_pair(make_bench_gemma4_gguf(str(tmp_path_factory.mktemp("g4") / "g4.gguf"),
                                           f32=True, **G4))


def port_ctx(model, **kw):
    return Context(model, n_ctx=64, n_seqs=1, device="cpu", **kw)


def jax_ctx(model):
    return JaxContext(model, n_ctx=64, n_seqs=1, kv_dtype=jnp.float32)


def grid_logits(ctx, toks):
    T = len(toks)
    return np.asarray(ctx.decode(np.asarray([toks]), np.asarray([0]), np.arange(T)[None],
                                 np.arange(T)))


def test_gemma3n_kv_reuse_and_aliased_lines(g3n):
    model, jmodel, _ = g3n
    assert model.cfg.extra["kv_reuse"] == jmodel.cfg.extra["kv_reuse"] == [-1, -1, -1, -1, 3, 2]
    assert [set(lw) for lw in model.params["layers"]] == [
        set(lw) for lw in jmodel.params["layers"]]
    assert set(model.params) == set(jmodel.params)
    kv, jkv = Context(model, n_ctx=64, n_seqs=1, device="cpu", paged=False).kv, jax_ctx(jmodel).kv
    assert isinstance(kv, ISWACache)
    assert (kv.full_idx, kv.swa_idx) == (tuple(jkv.full_idx), tuple(jkv.swa_idx))
    assert (len(kv.full.k), len(kv.swa.k)) == (1, 3)  # 4 owned layers: 1 full, 3 window
    # the pool of a paged context holds the owned full layer alone
    assert len(port_ctx(model).kv.full.k) == 1


def test_gemma3n_prefill_logits_match_jax_and_transformers(g3n):
    model, jmodel, hf = g3n
    got = grid_logits(port_ctx(model), TOKENS)
    ref = grid_logits(jax_ctx(jmodel), TOKENS)
    np.testing.assert_allclose(got, ref, rtol=3e-3, atol=3e-3)
    with torch.no_grad():
        hf_ref = hf(torch.tensor([TOKENS])).logits[0].numpy()
    np.testing.assert_allclose(got, hf_ref, rtol=3e-3, atol=3e-3)


def test_gemma3n_greedy_ids_match_jax(g3n):
    model, jmodel, _ = g3n
    assert port_ctx(model).generate(TOKENS, 8) == jax_ctx(jmodel).generate(TOKENS, 8)


def test_gemma3n_stepwise_decode_equals_prefill(tmp_path):
    """The JAX test's second fixture (2 AltUp streams): token-by-token decode
    through the ISWA memory, whose shared layers read the owned layers'
    lines, equals the one-shot prefill (and the transformers model)."""
    from llama_cpp_tpu.convert.hf_to_gguf import convert_hf_model

    hf = hf_gemma3n(2, [0.95, 0.0, 0.0, 0.0, 0.0, 0.0], 72)
    path = str(tmp_path / "g3ns.gguf")
    convert_hf_model(hf, path, ftype="f32")
    model = load_model(path, device="cpu", prefer_quant=False, dense_dtype=torch.float32)
    pre = port_ctx(model).prefill(TOKENS)
    ctx = port_ctx(model)
    for t in TOKENS[:-1]:
        ctx.decode_one(t)
    np.testing.assert_allclose(ctx.decode_one(TOKENS[-1]), pre, rtol=3e-4, atol=3e-4)
    with torch.no_grad():
        ref = hf(torch.tensor([TOKENS])).logits[0, -1].numpy()
    np.testing.assert_allclose(pre, ref, rtol=3e-3, atol=3e-3)


def written_layers(ctx, toks) -> set:
    """The layers whose K/V rows a prefill writes."""
    seen = set()
    write = ctx.kv.write_layer

    def spy(il, *a, **k):
        seen.add(il)
        return write(il, *a, **k)

    ctx.kv.write_layer = spy
    ctx.prefill(toks)
    return seen


def test_shared_layers_write_no_line(g3n, g4):
    assert written_layers(port_ctx(g3n[0]), TOKENS) == {0, 1, 2, 3}
    assert written_layers(port_ctx(g4[0]), PROMPT) == {0, 1, 2}


def test_gemma3n_q4_k_m_fixture_teacher_forced(tmp_path):
    """The port's fixture maker (the card's Gemma-3n-E4B file) at a tiny
    width, Q4_K_M: every step's logits within NMSE 1e-4 of the JAX
    package's, both fed the JAX package's greedy ids."""
    path = make_bench_gemma3n_gguf(str(tmp_path / "g3nq.gguf"), n_layers=6, n_embd=256,
                                   n_heads=2, n_kv_heads=1, head_dim=128, n_ff=512,
                                   vocab_size=256, n_embd_altup=64, laurel_rank=64,
                                   sliding_window=8, swa_pattern=3, shared_kv_layers=2,
                                   n_ctx=256, synth_scale=1.0 / 256)
    model, jmodel = load_model(path, device="cpu"), jax_load_model(path)
    assert model.cfg.extra["kv_reuse"] == jmodel.cfg.extra["kv_reuse"] == [-1, -1, -1, -1, 3, 2]
    ctx, jctx = port_ctx(model), JaxContext(jmodel, n_ctx=64, n_seqs=1)
    lp, lj = ctx.prefill(PROMPT), np.asarray(jctx.prefill(PROMPT))
    errs = [nmse(lp, lj)]
    for _ in range(4):
        t = int(np.argmax(lj))
        lp, lj = ctx.decode_one(t), np.asarray(jctx.decode_one(t))
        errs.append(nmse(lp, lj))
    assert max(errs) <= 1e-4, errs


def test_gemma4_layer_keys_and_class_head_dims(g4):
    model, jmodel = g4
    assert [set(lw) for lw in model.params["layers"]] == [
        set(lw) for lw in jmodel.params["layers"]]
    assert "attn_v" not in model.params["layers"][2] and "attn_k" in model.params["layers"][2]
    cfg = model.cfg
    assert cfg.extra["kv_reuse"] == jmodel.cfg.extra["kv_reuse"] == [-1, -1, -1, 2]
    assert (cfg.extra["head_dim_k_swa"], cfg.extra["rope_dims_swa"]) == (8, 8)
    kv = port_ctx(model).kv
    assert kv.swa.k[0].shape[-1] == 8 and kv.full.k[0].shape[-1] == 16
    assert kv.swa_idx == (0, -1, 1, 1)  # the shared tail layer aliases layer 2's ring


def test_gemma4_logits_and_ids_match_jax(g4):
    model, jmodel = g4
    np.testing.assert_allclose(grid_logits(port_ctx(model), PROMPT),
                               grid_logits(jax_ctx(jmodel), PROMPT), rtol=1e-4, atol=1e-4)
    assert port_ctx(model).generate(PROMPT, 8) == jax_ctx(jmodel).generate(PROMPT, 8)


def test_gemma4_q4_k_m_teacher_forced(tmp_path):
    """A Q4_K_M Gemma 4 file (Q4_K expert stacks split from their fused
    [gate | up]): each step within NMSE 1e-4 of the JAX package's."""
    shape = {**G4, "n_embd": 256, "head_dim": 128, "head_dim_swa": 64, "n_ff": 512,
             "vocab_size": 256, "n_embd_per_layer": 64, "n_ff_exp": 256}
    path = make_bench_gemma4_gguf(str(tmp_path / "g4q.gguf"), synth_scale=1.0 / 256, **shape)
    model, jmodel = load_model(path, device="cpu"), jax_load_model(path)
    ctx, jctx = port_ctx(model), JaxContext(jmodel, n_ctx=64, n_seqs=1)
    lp, lj = ctx.prefill(PROMPT), np.asarray(jctx.prefill(PROMPT))
    errs = [nmse(lp, lj)]
    for _ in range(4):
        t = int(np.argmax(lj))
        lp, lj = ctx.decode_one(t), np.asarray(jctx.decode_one(t))
        errs.append(nmse(lp, lj))
    assert max(errs) <= 1e-4, errs


def test_gemma4_pre_output_norm_features_match_jax(g4):
    """decode(aux=True) at layer n_layers: the row the assistant reads."""
    model, jmodel = g4
    L = model.cfg.n_layers
    ctx, jctx = port_ctx(model), jax_ctx(jmodel)
    ctx.set_aux_capture((L,))
    jctx.set_aux_capture((L,))
    args = (np.asarray([PROMPT]), np.asarray([0]), np.arange(len(PROMPT))[None],
            np.asarray([len(PROMPT) - 1]))
    (lg, f), (jlg, jf) = ctx.decode(*args, aux=True), jctx.decode(*args, aux=True)
    assert f.shape == (1, len(PROMPT), model.cfg.n_embd)
    np.testing.assert_allclose(f, np.asarray(jf), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(lg, np.asarray(jlg), rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("g4pair")
    tgt = make_bench_gemma4_gguf(str(d / "t.gguf"), n_layers=4, is_swa=(1, 1, 1, 0),
                                 shared_kv_layers=0, n_embd_per_layer=0, n_expert=0,
                                 moe_layers=(), alt_v_layers=(), f32=True, **PAIR)
    ast = make_bench_gemma4_assistant_gguf(str(d / "a.gguf"), n_layers=2, is_swa=(1, 0),
                                           n_embd_out=64, f32=True, **PAIR)
    return f32_pair(tgt), f32_pair(ast)


def recorded(spec):
    """spec with each draft() call's result kept in spec.drafts."""
    spec.drafts = []
    draft = spec.draft

    def keep(tokens, n):
        out = draft(tokens, n)
        spec.drafts.append(list(out))
        return out

    spec.draft = keep
    return spec


def speculate_both(pair, prompt, n_new):
    """The port's and the JAX package's assistant speculation over a pair:
    -> (the port's ids, its stats and drafts, the JAX ids, stats and drafts,
    the target's greedy ids)."""
    from llama_cpp_tpu.models.gemma3n import Gemma4AssistantSpeculator as JaxSpeculator
    from llama_cpp_tpu.runtime.speculative import speculative_generate as jax_speculative
    from llama_cpp_tpu_torch.models.gemma3n import Gemma4AssistantSpeculator
    from llama_cpp_tpu_torch.runtime.speculative import speculative_generate

    (tgt, jtgt), (ast, jast) = pair
    plain = port_ctx(tgt).generate(prompt, n_new)
    ctx, jctx = port_ctx(tgt), jax_ctx(jtgt)
    spec = recorded(Gemma4AssistantSpeculator(ast, ctx, p_min=0.0))
    jspec = recorded(JaxSpeculator(jast, jctx, p_min=0.0))
    out, stats = speculative_generate(ctx, spec, prompt, max_new_tokens=n_new, n_draft=4)
    jout, jstats = jax_speculative(jctx, jspec, prompt, max_new_tokens=n_new, n_draft=4)
    return out, stats, spec.drafts, jout, jstats, jspec.drafts, plain


def test_assistant_drafts_match_jax_and_keep_the_targets_ids(pair):
    out, stats, drafts, jout, jstats, jdrafts, plain = speculate_both(pair, [3, 5, 9, 2, 7, 11],
                                                                      10)
    assert drafts == jdrafts and stats == jstats
    assert out == jout == plain and stats["n_draft"] > 0


@pytest.fixture(scope="module")
def mirrored_pair(tmp_path_factory):
    """A target whose blocks add 0.15 of the embedded row's RMS each, with
    an untied head, and the assistant mirrored on it (mirror_of)."""
    d = tmp_path_factory.mktemp("g4mirror")
    tgt = make_bench_gemma4_gguf(str(d / "t.gguf"), n_layers=4, is_swa=(1, 1, 1, 0),
                                 shared_kv_layers=0, n_embd_per_layer=0, n_expert=0,
                                 moe_layers=(), alt_v_layers=(), f32=True, untied_head=True,
                                 block_gain=0.15, **PAIR)
    ast = make_bench_gemma4_assistant_gguf(str(d / "a.gguf"), n_layers=2, is_swa=(1, 0),
                                           n_embd_out=64, f32=True, mirror_of=tgt,
                                           block_gain=0.15, h_gain=0.05, **PAIR)
    return f32_pair(tgt), f32_pair(ast)


def test_mirrored_assistant_drafts_are_accepted_as_in_the_jax_package(mirrored_pair):
    """Drafts the target accepts: the accepted rows' features go back to
    the assistant (process) and its h_next chains across accepted drafts;
    drafts, acceptance and ids equal the JAX package's run, and the ids
    the target's greedy ones."""
    out, stats, drafts, jout, jstats, jdrafts, plain = speculate_both(
        mirrored_pair, [3, 5, 9, 2, 7, 11, 13, 17], 16)
    assert drafts == jdrafts and stats == jstats
    assert out == jout == plain
    assert stats["n_accept"] > 0, stats


def test_assistant_runs_only_as_a_draft(pair):
    (tgt, _), (ast, _) = pair
    assert ast.cfg.extra["gemma4_assistant"] and ast.cfg.extra["n_embd_out"] == 64
    with pytest.raises(RuntimeError, match="Gemma4AssistantSpeculator"):
        ast.forward_fn(ast.params, ast.cfg, None, None, None)
