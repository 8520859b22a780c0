"""The PyTorch port's registry entries against the JAX package on the CPU:
mistral, qwen2 (q/k/v biases), qwen3 (per-head q/k norms), qwen2moe
(sigmoid-gated shared expert), qwen3moe, gemma, gemma2 (softcaps, window
every other layer) and gemma3 (ISWA memory, per-layer rope, GeGLU,
post-norms, tied head), each on a small fixture that both packages read
from the same bytes (2 layers, n_embd 512, 4/2 heads of 128, vocab 512).

For each entry: the per-layer weight keys equal the JAX load_model's (a
tensor the port skipped would show), teacher-forced prefill logits agree to
NMSE < 1e-3 on the Q4_K/Q6_K fixture and to allclose 1e-4 on an f32 one,
and 8 greedy ids equal the JAX Context.generate's. Also: the registry's
list, the refusal of an architecture it lacks, and the loader's rule for
fusing projections that carry biases."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_tpu.models import loader as jloader
from llama_cpp_tpu.models.loader import load_model as jax_load_model
from llama_cpp_tpu.runtime.context import Context as JaxContext
from llama_cpp_tpu_torch.models import loader as tloader
from llama_cpp_tpu_torch.models.config import ModelConfig
from llama_cpp_tpu_torch.models.from_jax import params_from_jax
from llama_cpp_tpu_torch.models.loader import Model, load_model
from llama_cpp_tpu_torch.models.registry import apply_arch, supported_archs
from llama_cpp_tpu_torch.runtime.context import Context
from llama_cpp_tpu_torch.runtime.kv_cache import ISWACache
from llama_cpp_tpu_torch.testing import make_bench_arch_gguf

SHAPE = dict(n_layers=2, n_embd=512, n_heads=4, n_kv_heads=2, head_dim=128, n_ff=1024,
             vocab_size=512, n_ctx=256)
MOE = dict(n_expert=8, n_expert_used=2, n_ff_exp=256)
# each entry with the tensors and metadata of its family
ARCHS = {
    "mistral": dict(),
    "qwen2": dict(qkv_bias=True, rope_base=1e6),
    "qwen3": dict(qk_norm=True, rope_base=1e6),
    "qwen2moe": dict(qkv_bias=True, shared_expert_ff=512, **MOE),
    "qwen3moe": dict(qk_norm=True, **MOE),
    "gemma": dict(tie=True),
    "gemma2": dict(tie=True, post_norms=True, sliding_window=32, attn_softcap=50.0,
                   final_softcap=30.0),
    "gemma3": dict(tie=True, post_norms=True, qk_norm=True, sliding_window=32, swa_pattern=2,
                   rope_base=1e6, rope_base_swa=1e4, rope_linear_factor=8.0),
}
CTX = dict(n_ctx=256, n_seqs=2, n_ubatch=64)
ARCH = pytest.mark.parametrize("arch", list(ARCHS))


def nmse(got, ref):
    return float(np.mean((got - ref) ** 2) / np.mean(ref ** 2))


def prompt(length, seed=0):
    return [int(t) for t in np.random.default_rng(seed).integers(3, 512, length)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small steps under pytest-xdist's workers on a shared CPU: torch's
    thread pool would spend more than the work on waking its threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """arch -> (port model, JAX model) of the Q4_K/Q6_K fixture, made at
    first use."""
    made = {}

    def get(arch):
        if arch not in made:
            path = str(tmp_path_factory.mktemp(arch) / f"{arch}.gguf")
            make_bench_arch_gguf(path, arch, **SHAPE, **ARCHS[arch])
            made[arch] = load_model(path, device="cpu"), jax_load_model(path)
        return made[arch]

    return get


def test_supported_archs():
    """The families here, llama, deepseek2 (tests/test_torch_deepseek2.py),
    the dense-decoder families of tests/test_torch_families.py, the MoE
    families of tests/test_torch_moe_families.py, the recurrent and
    hybrid families of tests/test_torch_hybrid.py, the encoders and
    embedding models of tests/test_torch_encoders.py, the RWKV entries of
    tests/test_torch_rwkv.py, the last decoder families (the MLA entries
    at MHA width among them) of tests/test_torch_families_late.py, and
    t5 (tests/test_torch_t5.py), the diffusion LMs
    (tests/test_torch_diffusion.py) and the last text entries
    (tests/test_torch_families_last.py)."""
    from test_torch_families import ARCHS as FAMILIES
    from test_torch_hybrid import ARCHS as HYBRID_FAMILIES
    from test_torch_moe_families import ARCHS as MOE_FAMILIES

    from llama_cpp_tpu_torch.testing import (DIFFUSION_LAYOUTS, EMBEDDING_ARCHS,
                                             LAST_TEXT_LAYOUTS, LATE_FAMILY_LAYOUTS,
                                             MLA_FAMILY_LAYOUTS, RWKV_ARCHS)

    assert supported_archs() == sorted(["llama", "deepseek2", *ARCHS, *FAMILIES,
                                        *MOE_FAMILIES, *HYBRID_FAMILIES, *EMBEDDING_ARCHS,
                                        *RWKV_ARCHS, *LATE_FAMILY_LAYOUTS,
                                        *MLA_FAMILY_LAYOUTS, "t5", *DIFFUSION_LAYOUTS,
                                        *LAST_TEXT_LAYOUTS, "gemma3n", "gemma4",
                                        "gemma4-assistant", "minimax-m3"])


def test_other_arch_raises_naming_it(tmp_path):
    """deepseek32 (DeepSeek's sparse attention memory) is not ported:
    loading its file raises naming it."""
    path = make_bench_arch_gguf(str(tmp_path / "deepseek32.gguf"), "deepseek32", **SHAPE)
    with pytest.raises(NotImplementedError, match="'deepseek32'"):
        load_model(path, device="cpu")


@ARCH
def test_layer_keys_match_jax(fixtures, arch):
    model, jmodel = fixtures(arch)
    assert [set(lw) for lw in model.params["layers"]] == [
        set(lw) for lw in jmodel.params["layers"]]
    assert set(model.params) == set(jmodel.params)
    cfg, jcfg = model.cfg, jmodel.cfg
    for field in ("rope_type", "act", "embd_scale", "qk_norm", "post_norms", "swa_pattern",
                  "sliding_window", "attn_scale", "rope_freq_scale",
                  "expert_weights_norm", "attn_logit_softcap", "final_logit_softcap"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    assert [cfg.is_swa_layer(i) for i in range(2)] == [jcfg.is_swa_layer(i) for i in range(2)]


@ARCH
def test_prefill_logits_match_jax(fixtures, arch):
    """Every row of a 64-token ubatch (teacher-forced), then the last row
    of a 100-token prefill in two ubatches on int8 KV."""
    model, jmodel = fixtures(arch)
    toks = np.asarray(prompt(64))[None]
    args = (toks, np.asarray([0]), np.arange(64)[None], np.arange(64))
    got = Context(model, device="cpu", **CTX).decode(*args)
    ref = JaxContext(jmodel, **CTX).decode(*args)
    assert got.shape == ref.shape == (64, 512)
    assert nmse(got, ref) < 1e-3
    ctx = Context(model, quantized_kv=True, device="cpu", **CTX)
    got = ctx.prefill(prompt(100, seed=1))
    ref = JaxContext(jmodel, quantized_kv=True, **CTX).prefill(prompt(100, seed=1))
    assert nmse(got, ref) < 1e-3
    assert isinstance(ctx.kv, ISWACache) == (ARCHS[arch].get("sliding_window", 0) > 0)


@ARCH
def test_greedy_ids_match_jax(fixtures, arch):
    model, jmodel = fixtures(arch)
    p = prompt(40, seed=2)
    got = Context(model, device="cpu", **CTX).generate(p, max_new_tokens=8)
    assert got == JaxContext(jmodel, **CTX).generate(p, max_new_tokens=8)


@ARCH
def test_f32_logits_match_jax(tmp_path, arch):
    """The f32 fixture through both packages in f32 (the port's model made
    from the JAX package's parameters, its config from the port's
    registry; an f32 KV memory in both): every row of a 48-token ubatch
    allclose to 1e-4."""
    path = make_bench_arch_gguf(str(tmp_path / "f32.gguf"), arch, f32=True, **SHAPE,
                                **ARCHS[arch])
    jmodel = jax_load_model(path, prefer_quant=False, dense_dtype=jnp.float32)
    md = jmodel.gguf.metadata
    cfg = apply_arch(ModelConfig.from_gguf(md), md).with_(compute_dtype=torch.float32)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jmodel.params))
    model = Model(cfg, params, torch.device("cpu"))
    toks = np.asarray(prompt(48, seed=3))[None]
    args = (toks, np.asarray([0]), np.arange(48)[None], np.arange(48))
    got = Context(model, device="cpu", **CTX).decode(*args)
    ref = JaxContext(jmodel, kv_dtype=jnp.float32, **CTX).decode(*args)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def _dense(rows, cols, seed):
    return np.random.default_rng(seed).standard_normal((rows, cols)).astype(np.float32)


FUSE_CASES = {
    # layer keys -> the keys after fusion, in both packages
    "qkv_all_biased": ({"attn_q", "attn_k", "attn_v", "attn_q_bias", "attn_k_bias",
                        "attn_v_bias"}, {"attn_qkv", "attn_qkv_bias"}),
    "qkv_one_biased": ({"attn_q", "attn_k", "attn_v", "attn_q_bias"},
                       {"attn_q", "attn_k", "attn_v", "attn_q_bias"}),
    "qk_biased_v_other_type": ({"attn_q", "attn_k", "attn_v16", "attn_q_bias", "attn_k_bias",
                                "attn_v_bias"}, {"attn_qk", "attn_qk_bias", "attn_v",
                                                 "attn_v_bias"}),
    "qkv_unbiased": ({"attn_q", "attn_k", "attn_v"}, {"attn_qkv"}),
    "qk_one_biased_v_other_type": ({"attn_q", "attn_k", "attn_v16", "attn_q_bias"},
                                   {"attn_q", "attn_k", "attn_v", "attn_q_bias"}),
    "gate_up_unbiased": ({"ffn_gate", "ffn_up"}, {"ffn_gateup"}),
}


@pytest.mark.parametrize("case", list(FUSE_CASES))
def test_fused_bias_rule_matches_jax(case):
    """Projections fuse only when all of them or none carry a bias; the
    fused bias is the concatenation (dense weights; attn_v16 is an attn_v
    of another dtype, which keeps v standalone)."""
    keys, want = FUSE_CASES[case]
    lw, jlw = {}, {}
    for i, key in enumerate(sorted(keys)):
        name = "attn_v" if key == "attn_v16" else key
        a = _dense(64, 32, i)[:, 0] if key.endswith("_bias") else _dense(64, 32, i)
        lw[name] = torch.from_numpy(a)
        jlw[name] = jnp.asarray(a)
        if key == "attn_v16":
            lw[name] = lw[name].to(torch.float16)
            jlw[name] = jlw[name].astype(jnp.float16)
    tloader._fuse_projections(lw)
    jloader._fuse_projections(jlw)
    assert set(lw) == set(jlw) == want
    for key in lw:
        np.testing.assert_array_equal(lw[key].float().numpy(),
                                      np.asarray(jlw[key].astype(jnp.float32)))
