"""The PyTorch port's mixture-of-experts path against the JAX package on the
CPU: a Mixtral-shaped llama-arch fixture at a small size (2 layers, n_embd
512, 4/2 heads of 128, n_ff 1024, 8 experts, top-2, vocab 512), loaded by
both packages from one file.

moe_block is held on both routes (gather: tokens * top_k < n_expert, the
decode shape; ragged: sort by expert, the prefill shape) to NMSE < 1e-6, and
the whole model by prefill logits (NMSE < 1e-3) and greedy ids (identical on
the synthetic fixture). A second model, whose expert weights the JAX
package's quantizer made from random values, is held by teacher-forced
logits as the llama tests do: free-running ids may part at a near-tie. Off
its accelerator the JAX package never runs its indexed-expert kernel
(models/transformer.py _moe_expert_mm): it gathers and dequantizes in bf16
arithmetic, and so does the port's CPU route; the kernel's plain version
(f32 product, one cast) is held against that route to NMSE < 5e-3, the two
differing by where W is rounded to bf16."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama_cpp_tpu.gguf.constants import GGMLType as JGGMLType
from llama_cpp_tpu.gguf.writer import GGUFWriter as JGGUFWriter
from llama_cpp_tpu.models import transformer as jtf
from llama_cpp_tpu.models.loader import load_model as jax_load_model
from llama_cpp_tpu.quant.quantize import quantize as jax_quantize
from llama_cpp_tpu.runtime.context import Context as JaxContext
from llama_cpp_tpu.testing import tiny_spm_vocab as jax_tiny_vocab
from llama_cpp_tpu_torch.models import transformer as ttf
from llama_cpp_tpu_torch.models.from_jax import params_from_jax
from llama_cpp_tpu_torch.models.loader import Model, load_model
from llama_cpp_tpu_torch.ops.kernels import qmm_expert as tqe
from llama_cpp_tpu_torch.ops.qtensor import QuantTensor, pad_out_features
from llama_cpp_tpu_torch.runtime.context import Context
from llama_cpp_tpu_torch.testing import make_bench_moe_gguf

SHAPE = dict(n_layers=2, n_embd=512, n_heads=4, n_kv_heads=2, n_ff=1024, n_expert=8,
             n_expert_used=2, vocab_size=512, seed=0)
CTX = dict(n_ctx=256, n_seqs=4, n_ubatch=64)
MEM = pytest.mark.parametrize("paged", [True, False], ids=["paged", "slots"])


def nmse(got, ref):
    return float(np.mean((got - ref) ** 2) / np.mean(ref ** 2))


def prompts(n, length, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(3, 512, length)] for _ in range(n)]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = make_bench_moe_gguf(str(tmp_path_factory.mktemp("torch_moe") / "moe.gguf"), **SHAPE)
    return load_model(path, device="cpu"), jax_load_model(path)


def make_quantized_moe_gguf(path, seed=3, n_embd=512, n_ff=512, n_expert=4, vocab=512):
    """A llama-arch MoE GGUF whose matrices the JAX package's Q4_K quantizer
    made from random values (the bench fixture's synthetic payload repeats
    across tensors and its greedy ids settle on one token)."""
    rng = np.random.default_rng(seed)
    n_heads, n_kv = 4, 2
    hd = n_embd // n_heads
    w = JGGUFWriter()
    w.add("general.architecture", "llama")
    w.add("general.name", "tiny-moe")
    for key, val in (("block_count", 2), ("context_length", 256), ("embedding_length", n_embd),
                     ("feed_forward_length", n_ff), ("attention.head_count", n_heads),
                     ("attention.head_count_kv", n_kv), ("rope.dimension_count", hd),
                     ("vocab_size", vocab), ("expert_count", n_expert),
                     ("expert_used_count", 2)):
        w.add("llama." + key, np.uint32(val))
    w.add("llama.attention.layer_norm_rms_epsilon", 1e-5)
    w.add("llama.rope.freq_base", 10000.0)
    w.add_all(jax_tiny_vocab(vocab))

    def emit(name, arr, quant=True):
        arr = np.ascontiguousarray(arr, dtype=np.float32)
        if quant and arr.ndim > 1:
            w.add_tensor(name, jax_quantize(arr, JGGMLType.Q4_K).tobytes(),
                         tuple(reversed(arr.shape)), JGGMLType.Q4_K)
        else:
            w.add_tensor(name, arr.tobytes(), tuple(reversed(arr.shape)), JGGMLType.F32)

    def rand(*shape, scale=None):
        return rng.standard_normal(shape) * (scale or 1.0 / np.sqrt(shape[-1]))

    emit("token_embd.weight", rand(vocab, n_embd, scale=0.02))
    emit("output_norm.weight", np.ones(n_embd))
    emit("output.weight", rand(vocab, n_embd))
    for i in range(2):
        b = f"blk.{i}."
        emit(b + "attn_norm.weight", np.ones(n_embd))
        emit(b + "attn_q.weight", rand(n_embd, n_embd))
        emit(b + "attn_k.weight", rand(n_kv * hd, n_embd))
        emit(b + "attn_v.weight", rand(n_kv * hd, n_embd))
        emit(b + "attn_output.weight", rand(n_embd, n_embd))
        emit(b + "ffn_norm.weight", np.ones(n_embd))
        emit(b + "ffn_gate_inp.weight", rand(n_expert, n_embd, scale=0.1), quant=False)
        emit(b + "ffn_gate_exps.weight", rand(n_expert, n_ff, n_embd))
        emit(b + "ffn_up_exps.weight", rand(n_expert, n_ff, n_embd))
        emit(b + "ffn_down_exps.weight", rand(n_expert, n_embd, n_ff))
    w.write(path)
    return path


@pytest.fixture(scope="module")
def quantized_models(tmp_path_factory):
    path = make_quantized_moe_gguf(str(tmp_path_factory.mktemp("torch_moe_q") / "q.gguf"))
    return load_model(path, device="cpu"), jax_load_model(path)


def test_loader_stacks_the_experts(models):
    model, jmodel = models
    cfg, lw, jlw = model.cfg, model.params["layers"][0], jmodel.params["layers"][0]
    assert (cfg.n_expert, cfg.n_expert_used, cfg.expert_gating) == (8, 2, "softmax")
    assert cfg.expert_weights_norm and cfg.expert_weights_scale == 1.0
    assert "ffn_down" not in lw and "ffn_gateup" not in lw
    router = lw["ffn_gate_inp"]  # an F32 router lands as a dense bf16 [out, in] weight
    assert isinstance(router, torch.Tensor) and router.dtype == torch.bfloat16
    assert tuple(router.shape) == (8, 512)
    np.testing.assert_array_equal(router.float().numpy(),
                                  np.asarray(jlw["ffn_gate_inp"].astype(jnp.float32)))
    for key, shape, mins in (("ffn_gate_exps", (8, 512, 1024), True),
                             ("ffn_up_exps", (8, 512, 1024), True),
                             ("ffn_down_exps", (8, 1024, 512), False)):
        w, jw = lw[key], jlw[key]
        assert isinstance(w, QuantTensor) and w.transposed and not w.packed and not w.hier
        assert tuple(w.q.shape) == shape and w.q.dtype == torch.int8
        assert w.scales.dtype == torch.float32 and (w.mins is not None) == mins
        assert tqe.supported(w) and (w.in_features, w.out_features) == shape[1:]
        np.testing.assert_array_equal(w.q.numpy(), np.asarray(jw.q))
        np.testing.assert_array_equal(w.scales.numpy(), np.asarray(jw.scales))
        if mins:
            np.testing.assert_array_equal(w.mins.numpy(), np.asarray(jw.mins))


def test_stacked_dequant_matches_jax(models):
    model, jmodel = models
    for key in ("ffn_gate_exps", "ffn_down_exps"):
        got = model.params["layers"][1][key].dequant(torch.float32).numpy()
        ref = np.asarray(jmodel.params["layers"][1][key].dequant(jnp.float32))
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n_tok,route", [(1, "gather"), (3, "gather"), (4, "ragged"),
                                         (40, "ragged")])
@pytest.mark.parametrize("which", ["bench", "quantizer"])
def test_moe_block_matches_jax(models, quantized_models, which, n_tok, route):
    """3 tokens * top-2 < 8 experts take the gather route, 4 tokens the
    sort-by-expert route (the quantizer model has 4 experts: only one token
    gathers there)."""
    model, jmodel = models if which == "bench" else quantized_models
    cfg = model.cfg
    gathers = n_tok * cfg.n_expert_used < cfg.n_expert
    if which == "bench":
        assert gathers == (route == "gather")
    rng = np.random.default_rng(n_tok)
    x = torch.from_numpy(rng.standard_normal((1, n_tok, cfg.n_embd)).astype(np.float32)
                         ).to(torch.bfloat16)
    for il in range(2):
        got = ttf.moe_block(cfg, model.params["layers"][il], x).float().numpy()
        ref = np.asarray(jtf.moe_block(jmodel.cfg, jmodel.params["layers"][il],
                                       jnp.asarray(x.float().numpy(), jnp.bfloat16)
                                       ).astype(jnp.float32))
        assert got.shape == ref.shape == (1, n_tok, cfg.n_embd)
        assert nmse(got, ref) < 1e-6


@pytest.mark.parametrize("gating,bias,norm,scale", [
    ("softmax", False, True, 1.0), ("sigmoid", True, True, 2.5),
    ("softmax_weight", False, False, 1.0), ("softmax", True, False, 0.5)],
    ids=["softmax_norm", "sigmoid_selbias_scale", "softmax_weight", "softmax_selbias"])
def test_router_variants_match_jax(models, gating, bias, norm, scale):
    """Gating functions, the selection bias, weight norm and scale."""
    model, jmodel = models
    kw = dict(expert_gating=gating, expert_weights_norm=norm, expert_weights_scale=scale)
    cfg, jcfg = model.cfg.with_(**kw), jmodel.cfg.with_(**kw)
    lw, jlw = dict(model.params["layers"][0]), dict(jmodel.params["layers"][0])
    rng = np.random.default_rng(11)
    if bias:
        b = rng.standard_normal(8).astype(np.float32)
        lw["exp_probs_b"], jlw["exp_probs_b"] = torch.from_numpy(b), jnp.asarray(b)
        rb = (rng.standard_normal(8) * 0.1).astype(np.float32)
        lw["ffn_gate_inp_bias"], jlw["ffn_gate_inp_bias"] = torch.from_numpy(rb), jnp.asarray(rb)
    x = torch.from_numpy(rng.standard_normal((2, 5, 512)).astype(np.float32)).to(torch.bfloat16)
    got = ttf.moe_block(cfg, lw, x).float().numpy()
    ref = np.asarray(jtf.moe_block(jcfg, jlw, jnp.asarray(x.float().numpy(), jnp.bfloat16)
                                   ).astype(jnp.float32))
    assert nmse(got, ref) < 1e-6


def test_top_k_takes_the_lower_index_on_a_tie():
    """jax.lax.top_k returns the lower index first on a tie; the port's
    stable sort does the same (torch.topk promises no order)."""
    model_cfg = ttf.ModelConfig(arch="llama", n_expert=4, n_expert_used=2)
    lw = {"ffn_gate_inp": torch.zeros((4, 8), dtype=torch.bfloat16)}  # all logits equal
    topi, topw = ttf._route(model_cfg, lw, torch.ones((3, 8), dtype=torch.bfloat16), True)
    ref = np.asarray(jax.lax.top_k(jnp.zeros((3, 4)), 2)[1])
    np.testing.assert_array_equal(topi.numpy(), ref)
    np.testing.assert_allclose(topw.numpy(), 0.25)


def test_unported_gating_raises(models):
    model, _ = models
    cfg = model.cfg.with_(expert_gating="sparsemixer")
    with pytest.raises(NotImplementedError, match="sparsemixer"):
        ttf.moe_block(cfg, model.params["layers"][0], torch.zeros((1, 1, 512),
                                                                  dtype=torch.bfloat16))


def test_shared_expert_branch_matches_jax(models):
    """qwen2moe-style sigmoid-gated shared expert beside the routed ones."""
    model, jmodel = models
    cfg, jcfg = model.cfg.with_(n_expert_shared=1), jmodel.cfg.with_(n_expert_shared=1)
    lw, jlw = dict(model.params["layers"][0]), dict(jmodel.params["layers"][0])
    rng = np.random.default_rng(5)
    for key, shape in (("ffn_gate_shexp", (256, 512)), ("ffn_up_shexp", (256, 512)),
                       ("ffn_down_shexp", (512, 256)), ("ffn_gate_inp_shexp", (1, 512))):
        a = (rng.standard_normal(shape) / np.sqrt(shape[1])).astype(np.float32)
        lw[key] = torch.from_numpy(a).to(torch.bfloat16)
        jlw[key] = jnp.asarray(a, jnp.bfloat16)
    x = torch.from_numpy(rng.standard_normal((1, 6, 512)).astype(np.float32)).to(torch.bfloat16)
    got = ttf.moe_block(cfg, lw, x).float().numpy()
    ref = np.asarray(jtf.moe_block(jcfg, jlw, jnp.asarray(x.float().numpy(), jnp.bfloat16)
                                   ).astype(jnp.float32))
    assert nmse(got, ref) < 1e-4  # the dense shared branch rounds to bf16 between its ops


def test_kernel_arithmetic_against_the_gather_route(models):
    """K7's plain version (f32 product, W rounded to bf16 once, mins in f32)
    against the model's CPU gather route (bf16 arithmetic throughout, as the
    JAX package off its accelerator): NMSE < 5e-3."""
    model, _ = models
    rng = np.random.default_rng(9)
    for key in ("ffn_gate_exps", "ffn_down_exps"):
        w = model.params["layers"][0][key]
        x = torch.from_numpy(rng.standard_normal((4, w.in_features)).astype(np.float32)
                             ).to(torch.bfloat16)
        ids = torch.tensor([3, 3, 0, 7], dtype=torch.int32)
        kernel = tqe.qmm_expert(x, ids, w)
        route = ttf._moe_expert_mm(w, x, ids.long(), torch.bfloat16, kernels=False)
        assert nmse(kernel.numpy(), route.numpy()) < 5e-3


@MEM
def test_prefill_logits_and_greedy_ids_match_jax(models, paged):
    model, jmodel = models
    prompt = prompts(1, 100)[0]  # two ubatches of 64: the ragged route
    ctx = Context(model, quantized_kv=True, device="cpu", paged=paged, **CTX)
    jctx = JaxContext(jmodel, quantized_kv=True, paged=paged, **CTX)
    got, ref = ctx.prefill(prompt), jctx.prefill(prompt)
    assert got.shape == ref.shape == (512,)
    assert nmse(got, ref) < 1e-3
    ids, jids = [], []
    for _ in range(8):  # B = 1 decode: the gather route
        ids.append(int(np.argmax(got)))
        jids.append(int(np.argmax(ref)))
        got, ref = ctx.decode_one(ids[-1]), jctx.decode_one(jids[-1])
    assert ids == jids


@MEM
def test_teacher_forced_steps_with_quantizer_weights_match_jax(quantized_models, paged):
    """Both packages consume the JAX package's greedy ids; each step's logits
    agree to NMSE < 1e-3 and the argmax agrees wherever the JAX top-2 gap
    exceeds 0.1 (a closer near-tie may part free-running ids: the two sum
    f32 products in different orders)."""
    model, jmodel = quantized_models
    prompt = prompts(1, 40, seed=6)[0]
    ctx = Context(model, quantized_kv=True, device="cpu", paged=paged, **CTX)
    jctx = JaxContext(jmodel, quantized_kv=True, paged=paged, **CTX)
    got, ref = ctx.prefill(prompt), jctx.prefill(prompt)
    decided, seen = 0, set()
    for _ in range(12):
        assert nmse(got, ref) < 1e-3
        top2 = np.sort(ref)[-2:]
        if top2[1] - top2[0] > 0.1:
            assert int(np.argmax(got)) == int(np.argmax(ref))
            decided += 1
        tok = int(np.argmax(ref))
        seen.add(tok)
        got, ref = ctx.decode_one(tok), jctx.decode_one(tok)
    assert decided >= 6 and len(seen) > 3


def test_decode_steps_greedy_rows_are_independent(quantized_models):
    """Batched greedy decode at B = 3 (6 slots >= 4 experts: the ragged
    route) gives each sequence the ids of its own B = 1 decode (the gather
    route): XLA:CPU has no bf16 x bf16 -> f32 dot for the JAX batched step,
    so the batch is held against the port's own B = 1 steps, and those
    against JAX above."""
    model, _ = quantized_models
    ps = prompts(3, 30, seed=8)
    ctx = Context(model, quantized_kv=True, device="cpu", **CTX)
    one = Context(model, quantized_kv=True, device="cpu", **CTX)
    first, ref = [], []
    for s, p in enumerate(ps):
        p = p[: 20 + 4 * s]
        first.append(int(np.argmax(ctx.prefill(p, seq=s))))
        ref.append(one.generate(p, 7, seq=s)[1:])
    got = ctx.decode_steps_greedy(np.asarray(first), np.arange(3), 6)
    np.testing.assert_array_equal(got, np.asarray(ref))


def test_from_jax_round_trip_of_the_stacked_experts(models):
    model, jmodel = models
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jmodel.params), device="cpu")
    lw = params["layers"][0]
    assert lw["ffn_gate_exps"].q.dim() == 3 and lw["ffn_gate_inp"].dtype == torch.bfloat16
    converted = Model(model.cfg, params, torch.device("cpu"))
    prompt = prompts(1, 30, seed=3)[0]
    a = Context(model, quantized_kv=True, device="cpu", **CTX).prefill(prompt)
    b = Context(converted, quantized_kv=True, device="cpu", **CTX).prefill(prompt)
    np.testing.assert_array_equal(a, b)


def test_stacks_are_neither_padded_nor_fused(models):
    from llama_cpp_tpu_torch.models.loader import _concat_weights

    model, _ = models
    lw = model.params["layers"][0]
    with pytest.raises(ValueError, match="2-D transposed"):
        pad_out_features(lw["ffn_gate_exps"])
    with pytest.raises(ValueError, match="stacked expert"):
        _concat_weights([lw["ffn_gate_exps"], lw["ffn_up_exps"]])
