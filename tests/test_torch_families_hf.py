"""The port's dense-decoder families on the JAX package's converter layouts:
the tiny Hugging Face models of tests/test_model_parity.py (same configs,
same seeds), each written to an f32 GGUF through
llama_cpp_tpu.convert.hf_to_gguf.convert_hf_model, then loaded by both
packages (f32 activations and KV). The port's per-layer weight keys must
equal the JAX load_model's, and its logits of every row of one prompt must
be allclose to the JAX package's at the tolerance that test holds the JAX
package to against transformers. These are the layouts the converter
really writes: file-fused attn_qkv (gpt2, gptneox, phi2, bloom, phi3,
falcon, dbrx), learned positions (gpt2), the embedding LayerNorm (bloom),
partial rotary dims, and the per-family metadata keys."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from llama_cpp_tpu.convert.hf_to_gguf import convert_hf_model  # noqa: E402
from llama_cpp_tpu.models.loader import load_model as jax_load_model  # noqa: E402
from llama_cpp_tpu.runtime.context import Context as JaxContext  # noqa: E402
from llama_cpp_tpu_torch.models.loader import load_model  # noqa: E402
from llama_cpp_tpu_torch.runtime.context import Context  # noqa: E402

TOKENS = (2, 5, 40, 96, 7, 9)
LONG = (2, 5, 40, 96, 7, 130, 22, 9)  # windows of 4 need more than one span
COMMON = dict(vocab_size=150, hidden_size=48, intermediate_size=96, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)


def _gpt2():
    return transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=120, n_positions=64, n_embd=48, n_layer=2, n_head=4, n_inner=None,
        activation_function="gelu_new"))


def _gptneox(parallel, pct):
    return transformers.GPTNeoXForCausalLM(transformers.GPTNeoXConfig(
        vocab_size=120, hidden_size=48, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=96, rotary_pct=pct, use_parallel_residual=parallel,
        max_position_embeddings=64))


def _phi2():
    return transformers.PhiForCausalLM(transformers.PhiConfig(
        vocab_size=120, hidden_size=48, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=96, partial_rotary_factor=0.5, max_position_embeddings=64))


def _bloom():
    return transformers.BloomForCausalLM(transformers.BloomConfig(
        vocab_size=120, hidden_size=48, n_layer=2, n_head=4))


def _phi3():
    return transformers.Phi3ForCausalLM(transformers.Phi3Config(
        **COMMON, tie_word_embeddings=False, pad_token_id=0))


def _starcoder2():
    return transformers.Starcoder2ForCausalLM(transformers.Starcoder2Config(
        **COMMON, use_bias=True))


def _granite():
    return transformers.GraniteForCausalLM(transformers.GraniteConfig(
        **COMMON, tie_word_embeddings=False, embedding_multiplier=6.0,
        residual_multiplier=0.5, attention_multiplier=0.3, logits_scaling=2.0))


def _olmo2():
    return transformers.Olmo2ForCausalLM(transformers.Olmo2Config(
        **COMMON, tie_word_embeddings=False))


def _command_r():
    return transformers.CohereForCausalLM(transformers.CohereConfig(
        **COMMON, logit_scale=0.25, use_qk_norm=False))


def _glm4():
    return transformers.Glm4ForCausalLM(transformers.Glm4Config(
        **COMMON, head_dim=12, partial_rotary_factor=0.5, attention_bias=True,
        tie_word_embeddings=False, pad_token_id=0))


def _nemotron():
    return transformers.NemotronForCausalLM(transformers.NemotronConfig(
        **COMMON, partial_rotary_factor=0.5, tie_word_embeddings=False))


def _olmoe():
    return transformers.OlmoeForCausalLM(transformers.OlmoeConfig(
        vocab_size=150, hidden_size=32, intermediate_size=24, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=4, num_experts=4, num_experts_per_tok=2,
        norm_topk_prob=True, max_position_embeddings=64, tie_word_embeddings=False))


def _falcon():
    return transformers.FalconForCausalLM(transformers.FalconConfig(
        vocab_size=150, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        num_kv_heads=2, new_decoder_architecture=True, parallel_attn=True, bias=False))


def _smollm3():
    return transformers.SmolLM3ForCausalLM(transformers.SmolLM3Config(
        **{**COMMON, "num_hidden_layers": 4}, no_rope_layer_interval=2,
        tie_word_embeddings=False, use_sliding_window=False, pad_token_id=0))


def _cohere2():
    from transformers.models.cohere2 import Cohere2Config, Cohere2ForCausalLM
    return Cohere2ForCausalLM(Cohere2Config(
        **{**COMMON, "num_hidden_layers": 4}, logit_scale=0.25, sliding_window=4,
        sliding_window_pattern=2, pad_token_id=0))


def _olmo():
    from transformers.models.olmo import OlmoConfig, OlmoForCausalLM
    return OlmoForCausalLM(OlmoConfig(**COMMON, clip_qkv=0.2))


def _exaone4():
    from transformers.models.exaone4 import Exaone4Config, Exaone4ForCausalLM
    return Exaone4ForCausalLM(Exaone4Config(
        **{**COMMON, "num_hidden_layers": 4}, head_dim=12, sliding_window=4,
        sliding_window_pattern=4, pad_token_id=0))


def _seed_oss():
    from transformers.models.seed_oss import SeedOssConfig, SeedOssForCausalLM
    return SeedOssForCausalLM(SeedOssConfig(**COMMON, head_dim=12, pad_token_id=0))


def _hunyuan_dense():
    from transformers.models.hunyuan_v1_dense import (HunYuanDenseV1Config,
                                                      HunYuanDenseV1ForCausalLM)
    return HunYuanDenseV1ForCausalLM(HunYuanDenseV1Config(**COMMON, head_dim=12,
                                                          pad_token_id=0))


def _ernie4_5():
    from transformers.models.ernie4_5 import Ernie4_5Config, Ernie4_5ForCausalLM
    return Ernie4_5ForCausalLM(Ernie4_5Config(**COMMON, pad_token_id=0))


def _dbrx():
    from transformers.models.dbrx import DbrxConfig, DbrxForCausalLM
    return DbrxForCausalLM(DbrxConfig(
        d_model=48, n_heads=4, n_layers=2, max_seq_len=64, vocab_size=150,
        ffn_config={"ffn_hidden_size": 32, "moe_num_experts": 4, "moe_top_k": 2},
        attn_config={"kv_n_heads": 2, "clip_qkv": 8.0}, pad_token_id=0))


def _granitemoe():
    from transformers.models.granitemoe import GraniteMoeConfig, GraniteMoeForCausalLM
    return GraniteMoeForCausalLM(GraniteMoeConfig(
        **{**COMMON, "intermediate_size": 32}, num_local_experts=4, num_experts_per_tok=2,
        pad_token_id=0, embedding_multiplier=2.0, residual_multiplier=0.5,
        attention_multiplier=0.1, logits_scaling=4.0))


def _arcee():
    from transformers.models.arcee import ArceeConfig, ArceeForCausalLM
    return ArceeForCausalLM(ArceeConfig(**COMMON, pad_token_id=0))


# case -> (HF model maker, torch seed of tests/test_model_parity.py, the
# architecture the converter writes, prompt, tolerance of that test)
CASES = {
    "gpt2": (_gpt2, 11, "gpt2", TOKENS, 4e-4),
    "gptneox": (lambda: _gptneox(True, 0.5), 12, "gptneox", TOKENS, 4e-4),
    "gptneox_sequential": (lambda: _gptneox(False, 1.0), 13, "gptneox", TOKENS, 4e-4),
    "phi2": (_phi2, 14, "phi2", TOKENS, 4e-4),
    "bloom": (_bloom, 15, "bloom", TOKENS, 4e-4),
    "phi3": (_phi3, 42, "phi3", TOKENS, 4e-4),
    "starcoder2": (_starcoder2, 43, "starcoder2", TOKENS, 4e-4),
    "granite": (_granite, 45, "granite", TOKENS, 4e-4),
    "olmo2": (_olmo2, 46, "olmo2", TOKENS, 4e-4),
    "command-r": (_command_r, 47, "command-r", TOKENS, 4e-4),
    "glm4": (_glm4, 48, "glm4", TOKENS, 4e-4),
    "nemotron": (_nemotron, 49, "nemotron", TOKENS, 4e-4),
    "olmoe": (_olmoe, 62, "olmoe", TOKENS, 6e-4),
    "falcon": (_falcon, 63, "falcon", TOKENS, 4e-4),
    "smollm3": (_smollm3, 64, "smollm3", TOKENS, 4e-4),
    "cohere2": (_cohere2, 60, "cohere2", LONG, 4e-4),
    "olmo": (_olmo, 61, "olmo", TOKENS, 4e-4),
    "exaone4": (_exaone4, 62, "exaone4", LONG, 4e-4),
    "seed_oss": (_seed_oss, 63, "seed_oss", TOKENS, 4e-4),
    "hunyuan-dense": (_hunyuan_dense, 64, "hunyuan-dense", TOKENS, 4e-4),
    "ernie4_5": (_ernie4_5, 65, "ernie4_5", TOKENS, 4e-4),
    "dbrx": (_dbrx, 66, "dbrx", TOKENS, 4e-4),
    "granitemoe": (_granitemoe, 67, "granitemoe", TOKENS, 4e-4),
    "arcee": (_arcee, 95, "arcee", TOKENS, 4e-4),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small steps under pytest-xdist's workers on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", list(CASES))
def test_converted_model_matches_jax(tmp_path, case):
    make, seed, arch, tokens, tol = CASES[case]
    torch.manual_seed(seed)
    hf = make().eval()
    path = str(tmp_path / f"{case}.gguf")
    convert_hf_model(hf, path, ftype="f32")
    jmodel = jax_load_model(path, prefer_quant=False, dense_dtype=jnp.float32)
    model = load_model(path, device="cpu", prefer_quant=False, dense_dtype=torch.float32)
    assert model.cfg.arch == jmodel.cfg.arch == arch
    assert [set(lw) for lw in model.params["layers"]] == [
        set(lw) for lw in jmodel.params["layers"]]
    assert set(model.params) == set(jmodel.params)
    n = len(tokens)
    args = (np.asarray(tokens)[None], np.asarray([0]), np.arange(n)[None], np.arange(n))
    got = Context(model, n_ctx=64, n_ubatch=64, device="cpu").decode(*args)
    ref = JaxContext(jmodel, n_ctx=64, n_ubatch=64, kv_dtype=jnp.float32).decode(*args)
    assert got.shape == ref.shape == (n, model.cfg.vocab_size)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)
