"""The port's dense-decoder families that differ from llama only in block
variants (LayerNorm with biases, the non-gated FFN, file-fused QKV, parallel
and norm-after residuals, residual and logit scales, ALiBi, NoPE layers,
learned positions, whole-projection and post-rope q/k norms, clamped q/k/v,
the weightless norm), each against the JAX package on the CPU.

One fixture an entry, written by make_bench_arch_gguf with the tensors and
metadata of its family (2 layers, n_embd 256, heads of 64, vocab 256) and
read by both packages from the same bytes. Each entry: the per-layer
weight keys and the block flags equal the JAX load_model's; f32 prefill
logits of every row allclose to the JAX forward's at 1e-4; 8 greedy ids (f32)
equal the JAX Context.generate's. One entry a mechanism also on its Q4_K /
Q6_K file, NMSE < 1e-3. Every architecture of the JAX registry that the
port does not register raises NotImplementedError naming itself. The MoE
families are tests/test_torch_moe_families.py's, the recurrent and hybrid
ones (mamba, qwen3next, nemotron_h, ...) tests/test_torch_hybrid.py's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_tpu.models.loader import load_model as jax_load_model
from llama_cpp_tpu.models.registry import supported_archs as jax_supported_archs
from llama_cpp_tpu.runtime.context import Context as JaxContext
from llama_cpp_tpu_torch.models.config import ModelConfig
from llama_cpp_tpu_torch.models.loader import load_model
from llama_cpp_tpu_torch.models.registry import apply_arch, supported_archs
from llama_cpp_tpu_torch.runtime.context import Context
from llama_cpp_tpu_torch.testing import (FAMILY_LAYOUTS, HYBRID_LAYOUTS, MOE_FAMILY_LAYOUTS,
                                         make_bench_arch_gguf)

SHAPE = dict(n_layers=2, n_embd=256, n_heads=4, n_kv_heads=2, head_dim=64, n_ff=512,
             vocab_size=256, n_ctx=256)
# each registered dense-decoder entry with its family's tensors and metadata
# (the MoE families' are tests/test_torch_moe_families.py's, the recurrent
# and hybrid families' tests/test_torch_hybrid.py's)
ARCHS = {a: lay for a, lay in FAMILY_LAYOUTS.items()
         if a not in MOE_FAMILY_LAYOUTS and a not in HYBRID_LAYOUTS}
# one entry a mechanism, also on its Q4_K/Q6_K file
QUANTIZED = ("starcoder2", "command-r", "gptneox", "olmo2", "bloom", "gpt2", "smollm3",
             "granite", "olmo", "hunyuan-dense", "olmoe", "cohere2", "nemotron")
# the block flags both packages' configs must agree on
FLAGS = ("rope_type", "act", "glu", "use_rms_norm", "norm_eps", "parallel_residual",
         "shared_parallel_norm", "norm_after", "residual_scale", "alibi_bias", "embd_scale",
         "attn_scale", "logit_scale", "qk_norm", "post_norms", "sliding_window", "swa_pattern",
         "expert_weights_norm", "tie_embeddings")
EXTRAS = ("no_rope_layers", "qk_norm_full", "qk_norm_after_rope", "weightless_norm",
          "clamp_kqv")
CTX = dict(n_ctx=64, n_seqs=1, n_ubatch=32)
ARCH = pytest.mark.parametrize("arch", list(ARCHS))


def nmse(got, ref):
    return float(np.mean((got - ref) ** 2) / np.mean(ref ** 2))


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


def _fixture(tmp_path_factory, arch, **kw):
    path = str(tmp_path_factory.mktemp(arch) / f"{arch}.gguf")
    return make_bench_arch_gguf(path, arch, **{**SHAPE, **ARCHS[arch], **kw})


@pytest.fixture(scope="module")
def f32_models(tmp_path_factory):
    """arch -> (port model, JAX model), both f32 from one f32 file, made at
    first use."""
    made = {}

    def get(arch):
        if arch not in made:
            path = _fixture(tmp_path_factory, arch, f32=True)
            made[arch] = (load_model(path, device="cpu", dense_dtype=torch.float32),
                          jax_load_model(path, dense_dtype=jnp.float32))
        return made[arch]

    return get


def test_supported_archs_cover_the_slice():
    """At least the entries this slice names are registered, and every
    registered name is one of the JAX registry's."""
    want = {"starcoder2", "command-r", "gpt2", "gptneox", "phi2", "phi3", "falcon", "bloom",
            "olmo2", "granite", "smollm3", "nemotron", "olmoe"}
    assert want <= set(supported_archs())
    assert set(ARCHS) <= set(supported_archs()) <= set(jax_supported_archs())


@pytest.mark.parametrize("arch", sorted(set(jax_supported_archs()) - set(supported_archs())))
def test_left_out_arch_raises_naming_it(arch):
    with pytest.raises(NotImplementedError, match=f"'{arch}'"):
        apply_arch(ModelConfig(arch=arch), {})


@ARCH
def test_layer_keys_and_flags_match_jax(f32_models, arch):
    model, jmodel = f32_models(arch)
    assert [set(lw) for lw in model.params["layers"]] == [
        set(lw) for lw in jmodel.params["layers"]]
    assert set(model.params) == set(jmodel.params)
    cfg, jcfg = model.cfg, jmodel.cfg
    for name in FLAGS:
        assert getattr(cfg, name) == pytest.approx(getattr(jcfg, name)), name
    for key in EXTRAS:
        assert cfg.extra.get(key) == jcfg.extra.get(key), key


@ARCH
def test_f32_logits_match_jax(f32_models, arch):
    """Every row of a 24-token ubatch, f32 weights, activations and KV."""
    model, jmodel = f32_models(arch)
    toks = np.asarray(prompt(24, seed=3))[None]
    args = (toks, np.asarray([0]), np.arange(24)[None], np.arange(24))
    got = Context(model, device="cpu", **CTX).decode(*args)
    ref = JaxContext(jmodel, kv_dtype=jnp.float32, **CTX).decode(*args)
    assert got.shape == ref.shape == (24, 256)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@ARCH
def test_greedy_ids_match_jax(f32_models, arch):
    model, jmodel = f32_models(arch)
    p = prompt(12, seed=2)
    got = Context(model, device="cpu", **CTX).generate(p, max_new_tokens=8)
    assert got == JaxContext(jmodel, kv_dtype=jnp.float32, **CTX).generate(p, max_new_tokens=8)


@pytest.mark.parametrize("arch", QUANTIZED)
def test_quantized_logits_match_jax(tmp_path_factory, arch):
    """The Q4_K/Q6_K file in bf16 through both packages: every row of a
    24-token ubatch within NMSE 1e-3. The synthetic block scales are divided
    by 256, as on the card's paths: at the default scale (weights up to
    about 19) a biased model's attention is near one-hot and the two
    packages' bf16 roundings pick other keys."""
    path = _fixture(tmp_path_factory, arch, synth_scale=1.0 / 256)
    toks = np.asarray(prompt(24, seed=4))[None]
    args = (toks, np.asarray([0]), np.arange(24)[None], np.arange(24))
    got = Context(load_model(path, device="cpu"), device="cpu", **CTX).decode(*args)
    ref = JaxContext(jax_load_model(path), **CTX).decode(*args)
    assert nmse(got, ref) < 1e-3


@pytest.mark.parametrize("arch,paged", [("smollm3", True), ("smollm3", False), ("bloom", True),
                                        ("gpt2", False)],
                         ids=["smollm3-pool", "smollm3-slots", "bloom-pool", "gpt2-slots"])
def test_context_shift_matches_jax(f32_models, arch, paged):
    """Prefill 40, shift (keep 4, discard 16), decode 3: each step's f32
    logits allclose to the JAX package's at 1e-4. smollm3's NoPE layer has
    its K re-roped like every other layer's, as the JAX package's shift_seq
    does (runtime/kv_cache.py:198-240); bloom (ALiBi) and gpt2 (learned
    positions) have no rope, so the shift only moves positions."""
    model, jmodel = f32_models(arch)
    kw = dict(n_ctx=64, n_seqs=1, n_ubatch=32, paged=paged)
    ctx = Context(model, device="cpu", **kw)
    jctx = JaxContext(jmodel, kv_dtype=jnp.float32, **kw)
    p = prompt(40, seed=5)
    for c in (ctx, jctx):
        c.prefill(p)
        assert c.context_shift(0, n_keep=4, n_discard=16) == 16
    for t in (7, 19, 200):
        np.testing.assert_allclose(ctx.decode_one(t), np.asarray(jctx.decode_one(t)),
                                   rtol=1e-4, atol=1e-4)
