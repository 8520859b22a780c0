"""The port's mixture-of-experts families on the shared decoder (gpt-oss,
llama4, phimoe, deepseek, grok, arctic, grovemoe, smallthinker, chatglm,
glm4moe, dots1 and the Ling, HunYuan, EXAONE, Command-A, Mellum, MiMo-2,
MiniMax-M2, Step-3.5 and PLaMo-3 entries), each against the JAX package on
the CPU.

One fixture an entry, written by make_bench_arch_gguf with the tensors and
metadata of its family (testing.MOE_FAMILY_LAYOUTS: 2 layers, n_embd 256,
heads of 64, 8 experts of 256, vocab 256, windows of 16) and read by both
packages from the same bytes. Each entry: the per-layer weight keys, the
block and MoE flags and the extras equal the JAX load_model's; f32 prefill
logits of every row of a 24-token ubatch allclose to the JAX forward's at
1e-4; 8 greedy ids (f32) equal the JAX Context.generate's. gpt-oss on its
MXFP4-experts / Q8_0 file and llama4 on its Q4_K_M file, NMSE < 1e-3. Then
the MoE pieces against the JAX functions: swiglu_oai at and past its clamp,
sparsemixer's two picks at ties and at two jitters, and the gate on the
expert input (llama4), GroveMoE's chunk mix and arctic's branch each on the
gather route (decode) and the per-expert route (prefill); and an MXFP4 expert
stack of gpt-oss's 2880-wide rows, which the port loads as planes where the
JAX loader keeps it dense, holds the JAX package's values bit for bit; at
Q8_0 and Q5_0, rows of 1472 load as planes exactly where the expert kernel
takes the stack's widths, and dense elsewhere."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_tpu.models import transformer as jtf
from llama_cpp_tpu.models.loader import load_model as jax_load_model
from llama_cpp_tpu.runtime.context import Context as JaxContext
from llama_cpp_tpu_torch.models import transformer as ttf
from llama_cpp_tpu_torch.models.loader import load_model
from llama_cpp_tpu_torch.runtime.context import Context
from llama_cpp_tpu_torch.testing import (MOE_FAMILY_LAYOUTS, make_bench_arch_gguf,
                                         make_bench_gpt_oss_gguf, make_bench_llama4_gguf)

SHAPE = dict(n_layers=2, n_embd=256, n_heads=4, n_kv_heads=2, head_dim=64, n_ff=512,
             vocab_size=256, n_ctx=256)
ARCHS = MOE_FAMILY_LAYOUTS
FLAGS = ("rope_type", "act", "glu", "use_rms_norm", "norm_eps", "parallel_residual",
         "shared_parallel_norm", "norm_after", "residual_scale", "embd_scale", "attn_scale",
         "logit_scale", "attn_logit_softcap", "final_logit_softcap", "qk_norm", "post_norms",
         "sliding_window", "swa_pattern", "rope_freq_base", "rope_freq_scale", "rope_ext_factor",
         "n_expert", "n_expert_used", "n_expert_shared", "expert_gating", "moe_act",
         "moe_every", "expert_weights_norm", "expert_weights_scale", "tie_embeddings")
EXTRAS = ("no_rope_layers", "qk_norm_full", "qk_norm_after_rope", "rope_freq_base_swa",
          "is_swa_layers", "swa_first_global", "moe_weight_before", "router_jitter",
          "router_raw_input", "dense_moe_scale", "n_group_experts", "expert_group_scale",
          "n_chunk_expert", "tensor_remap")
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


@pytest.fixture(scope="module")
def f32_models(tmp_path_factory):
    """arch -> (port model, JAX model), both f32 from one f32 file, made at
    first use."""
    made = {}

    def get(arch):
        if arch not in made:
            path = str(tmp_path_factory.mktemp(arch) / f"{arch}.gguf")
            make_bench_arch_gguf(path, arch, **{**SHAPE, **ARCHS[arch]}, f32=True)
            made[arch] = (load_model(path, device="cpu", dense_dtype=torch.float32),
                          jax_load_model(path, dense_dtype=jnp.float32))
        return made[arch]

    return get


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
    assert [cfg.is_swa_layer(i) for i in range(cfg.n_layers)] == [
        jcfg.is_swa_layer(i) for i in range(jcfg.n_layers)]


@ARCH
def test_f32_logits_match_jax(f32_models, arch):
    """Every row of a 24-token ubatch (past the window of 16), f32 weights,
    activations and KV."""
    model, jmodel = f32_models(arch)
    toks = np.asarray(prompt(24, seed=3))[None]
    args = (toks, np.asarray([0]), np.arange(24)[None], np.arange(24))
    got = Context(model, device="cpu", **CTX).decode(*args)
    ref = JaxContext(jmodel, kv_dtype=jnp.float32, **CTX).decode(*args)
    assert got.shape == ref.shape == (24, 256)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@ARCH
def test_greedy_ids_match_jax(f32_models, arch):
    """A 20-token prompt (the logits test's prefill bucket) and 8 ids."""
    model, jmodel = f32_models(arch)
    p = prompt(20, seed=2)
    got = Context(model, device="cpu", **CTX).generate(p, max_new_tokens=8)
    assert got == JaxContext(jmodel, kv_dtype=jnp.float32, **CTX).generate(p, max_new_tokens=8)


QUANT_SHAPE = dict(n_layers=2, n_embd=256, n_heads=4, n_kv_heads=2, head_dim=64,
                   n_expert=8, n_ff_exp=256, vocab_size=256, n_ctx=256, synth_scale=1.0 / 256)


@pytest.mark.parametrize("arch", ["gpt-oss", "llama4"])
def test_quantized_logits_match_jax(tmp_path, arch):
    """gpt-oss's file (MXFP4 experts, every other matrix Q8_0, window 16)
    and llama4's (the Q4_K_M mix) in bf16 through both packages: every row
    of a 24-token ubatch within NMSE 1e-3. Synthetic block scales divided by
    256, as on the card's paths."""
    path = str(tmp_path / f"{arch}.gguf")
    if arch == "gpt-oss":
        make_bench_gpt_oss_gguf(path, **QUANT_SHAPE, n_expert_used=4, sliding_window=16)
    else:
        make_bench_llama4_gguf(path, **QUANT_SHAPE, n_ff=512)
    toks = np.asarray(prompt(24, seed=4))[None]
    args = (toks, np.asarray([0]), np.arange(24)[None], np.arange(24))
    model = load_model(path, device="cpu")
    kinds = {type(w).__name__ for w in model.params["layers"][0].values()}
    assert "QuantTensor" in kinds
    got = Context(model, device="cpu", **CTX).decode(*args)
    ref = JaxContext(jax_load_model(path), **CTX).decode(*args)
    assert nmse(got, ref) < 1e-3


# -- the MoE pieces against the JAX functions ------------------------------

def test_swiglu_oai_matches_jax_at_and_past_the_clamp():
    """min(g, 7) * sigmoid(1.702 min(g, 7)) * (clamp(u, -7, 7) + 1) on a grid
    through -7 and 7 and past them (f32, 1e-6)."""
    v = np.concatenate([np.linspace(-12, 12, 97), [-7.0, 7.0, -7.0001, 7.0001, 0.0]])
    g, u = np.meshgrid(v.astype(np.float32), v[::-1].astype(np.float32))
    got = ttf.swiglu_oai(torch.from_numpy(g), torch.from_numpy(u)).numpy()
    ref = np.asarray(jtf.swiglu_oai(jnp.asarray(g), jnp.asarray(u)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    flat = ttf.swiglu_oai(torch.tensor([7.0, 20.0]), torch.tensor([7.0, 20.0]))
    assert flat[0] == flat[1]  # both operands clamped at 7


@pytest.mark.parametrize("eps", [0.01, 0.5], ids=["jitter_0.01", "jitter_0.5"])
def test_sparsemixer_route_matches_jax(eps):
    """Two picks over random logits and over rows with tied maxima (the
    first maximum taken first, then the tie's other expert), each pick's
    weight the softmax over the experts within the jitter of the best."""
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((12, 8)).astype(np.float32)
    logits[0] = 0.0  # every expert tied
    logits[1, [2, 5]] = 3.0  # a tie at the top
    logits[2, [1, 6]] = -1.0
    logits[2, [0, 3]] = 2.0
    logits[3] = logits[3] * 1e-4  # every expert within the jitter
    ti, tw = ttf._sparsemixer_route(torch.from_numpy(logits), eps)
    ri, rw = jtf._sparsemixer_route(jnp.asarray(logits), eps)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    np.testing.assert_allclose(tw.numpy(), np.asarray(rw), rtol=1e-6, atol=1e-7)
    assert ti[1].tolist() == [2, 5] and ti[0].tolist() == [0, 1]


def _layer(f32_models, arch, il=1):
    model, jmodel = f32_models(arch)
    return model.cfg, model.params["layers"][il], jmodel.cfg, jmodel.params["layers"][il]


def _x(n_tok, seed, E=256):
    return np.random.default_rng(seed).standard_normal((1, n_tok, E)).astype(np.float32)


ROUTES = pytest.mark.parametrize("n_tok", [1, 12], ids=["gather", "per_expert"])


@ROUTES
def test_gate_on_the_expert_input_matches_jax(f32_models, n_tok):
    """llama4's moe_weight_before (top 1 of 8): the gate weight scales the
    expert input in f32 and the outputs sum unweighted, with its shared
    expert; one token on the gather route, 12 on the per-expert route."""
    cfg, lw, jcfg, jlw = _layer(f32_models, "llama4")
    assert cfg.extra["moe_weight_before"]
    x = _x(n_tok, 11)
    got = ttf.moe_block(cfg, lw, torch.from_numpy(x)).numpy()
    ref = np.asarray(jtf.moe_block(jcfg, jlw, jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    plain = ttf.moe_block(cfg.with_(extra={**cfg.extra, "moe_weight_before": False}), lw,
                          torch.from_numpy(x)).numpy()
    assert not np.allclose(plain, got, atol=1e-5)  # the gate weight is not 1


@ROUTES
def test_grovemoe_chunk_mix_matches_jax(f32_models, n_tok):
    """GroveMoE: the main mix (top 2 of 8) and the chunk experts' mix (4
    chunks of 2 experts) over its output, scaled by 0.05; one token on the
    gather route, 12 on the per-expert route (the JAX package's is its
    ragged route at both)."""
    cfg, lw, jcfg, jlw = _layer(f32_models, "grovemoe")
    x = _x(n_tok, 12)
    got = ttf.grovemoe_ffn(cfg, lw, torch.from_numpy(x)).numpy()
    ref = np.asarray(jtf._grovemoe_ffn(jcfg, jlw, jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


@ROUTES
def test_arctic_branch_matches_jax(f32_models, n_tok):
    """Arctic: the dense FFN on the normed input plus the experts on
    ffn_norm_exps of the layer input, as the JAX decoder loop sums them."""
    cfg, lw, jcfg, jlw = _layer(f32_models, "arctic")
    h, x_in = _x(n_tok, 13), _x(n_tok, 14)
    got = ttf._ffn(cfg, lw, torch.from_numpy(h), torch.from_numpy(x_in), True).numpy()
    moe_in = jtf.rms_norm(jnp.asarray(x_in), jlw["ffn_norm_exps"], jcfg.rms_eps)
    ref = np.asarray(jtf.ffn_block(jcfg, jlw, jnp.asarray(h), 1).astype(jnp.float32)
                     + jtf.moe_block(jcfg, jlw, moe_in))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_gpt_oss_width_expert_stack_loads_as_planes_of_the_dense_values():
    """An MXFP4 expert stack whose rows (2880) are a multiple of 64 but not of
    256: the JAX loader keeps it dense (bf16), the port as int8 flat-g32
    planes without mins, which the indexed-expert kernel takes; their
    dequantized values in bf16 are the JAX package's dense weights, bit for
    bit."""
    from llama_cpp_tpu.ops.qtensor import load_weight as jax_load_weight
    from llama_cpp_tpu_torch.gguf.constants import GGMLType
    from llama_cpp_tpu_torch.ops.kernels import qmm_expert
    from llama_cpp_tpu_torch.ops.qtensor import QuantTensor, load_weight
    from llama_cpp_tpu_torch.testing import synth_quant_bytes

    shape = (2, 128, 2880)  # [E, out, in] in file order
    raw = np.frombuffer(synth_quant_bytes(np.random.default_rng(5), int(np.prod(shape)),
                                          GGMLType.MXFP4), np.uint8)
    w = load_weight(raw, GGMLType.MXFP4, shape, transpose=True)
    assert isinstance(w, QuantTensor) and w.q.shape == (2, 2880, 128)
    assert qmm_expert.supported(w) and w.group == 32 and w.mins is None
    dense = np.asarray(jax_load_weight(raw, GGMLType.MXFP4, shape, transpose=True)
                       .astype(jnp.float32))
    assert dense.shape == shape
    got = ttf._dequant_experts(w, slice(None), torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got, dense.transpose(0, 2, 1))


@pytest.mark.parametrize("type_name, shape, planes", [
    ("Q8_0", (2, 128, 1472), True),  # K = 23 stages of 64, O two column tiles
    ("Q5_0", (2, 192, 1472), True),  # O a tile and a half
    ("Q8_0", (2, 96, 1472), False),  # O % 64 != 0: the kernel would refuse it
    ("Q8_0", (128, 1472), False),  # a matrix, not a stack
], ids=["q8_0_stack", "q5_0_stack_half_tile", "q8_0_stack_o96", "q8_0_matrix"])
def test_flat_type_widths_load_as_planes_where_the_expert_kernel_takes_them(type_name, shape,
                                                                              planes):
    """Rows (K = 1472) a multiple of 64 but not of 256, at types other than
    MXFP4: a transposed expert stack loads as planes exactly where the
    indexed-expert kernel takes its widths (qmm_expert.takes_widths), else
    dense as the JAX loader keeps it; planes hold the JAX dense values to
    bf16 rounding."""
    from llama_cpp_tpu.ops.qtensor import load_weight as jax_load_weight
    from llama_cpp_tpu_torch.gguf.constants import GGMLType
    from llama_cpp_tpu_torch.ops.kernels import qmm_expert
    from llama_cpp_tpu_torch.ops.qtensor import QuantTensor, load_weight
    from llama_cpp_tpu_torch.testing import synth_quant_bytes

    ggml_type = GGMLType[type_name]
    raw = np.frombuffer(synth_quant_bytes(np.random.default_rng(6), int(np.prod(shape)),
                                          ggml_type), np.uint8)
    w = load_weight(raw, ggml_type, shape, transpose=True)
    dense = np.asarray(jax_load_weight(raw, ggml_type, shape, transpose=True)
                       .astype(jnp.float32))
    assert isinstance(w, QuantTensor) == planes
    if not planes:
        np.testing.assert_array_equal(w.float().numpy(), dense)
        return
    assert qmm_expert.supported(w) and w.q.shape == (shape[0], shape[2], shape[1])
    got = ttf._dequant_experts(w, slice(None), torch.bfloat16).float().numpy()
    np.testing.assert_allclose(got, dense.transpose(0, 2, 1), rtol=2 ** -7, atol=0)
