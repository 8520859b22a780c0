"""The port's deepseek2 family (DeepSeek-V2/V3 Multi-head Latent Attention)
against the JAX package on the CPU, both reading the same bytes.

Fixtures: the port's make_bench_deepseek2_gguf at small widths (2 layers,
n_embd 256, 4 heads, kv_lora 256, qk_nope/qk_rope/v 32, a leading dense
layer of 512 then a MoE layer of 8 experts of 256, top 2, one shared; the
"v3" file with a q-LoRA of 256 and sigmoid gating with exp_probs_b, weights
normalised and scaled by 2.5; the "lite" file with a plain attn_q and
softmax gating; Q4_K/Q6_K, F32 where rows are not a multiple of 256), and
the JAX package's make_tiny_deepseek32_gguf(arch="deepseek2") (F32, the
dense oracle). The absorbed cache holds one KV head of K = 256 + 96 pad +
32 = 384 and V = 256.

Tolerances: NMSE < 1e-3 between the packages on the Q4_K/Q6_K files (bf16
activations summed in other orders, as tests/test_torch_archs.py holds the
other families), the absorbed path against the naive expansion NMSE < 1e-3
(bf16 K/V rows cached at different places), bit equality where the same
package reads the same values."""

import numpy as np
import pytest
import torch

from llama_cpp_tpu.models.loader import load_model as jax_load_model
from llama_cpp_tpu.runtime import state as jstate
from llama_cpp_tpu.runtime.context import Context as JaxContext
from llama_cpp_tpu.testing import make_tiny_deepseek32_gguf
from llama_cpp_tpu_torch.models import registry
from llama_cpp_tpu_torch.models.from_jax import params_from_jax
from llama_cpp_tpu_torch.models.loader import Model, load_model
from llama_cpp_tpu_torch.models.transformer import mla_kq_scale
from llama_cpp_tpu_torch.runtime import state
from llama_cpp_tpu_torch.runtime.context import Context
from llama_cpp_tpu_torch.runtime.kv_cache import KVCache
from llama_cpp_tpu_torch.runtime.paged_kv import PagedKVCache
from llama_cpp_tpu_torch.testing import make_bench_deepseek2_gguf

SHAPE = dict(n_layers=2, n_embd=256, n_heads=4, kv_lora_rank=256, qk_nope=32, qk_rope=32,
             v_dim=32, n_ff=512, n_dense=1, n_expert=8, n_expert_used=2, n_ff_exp=256,
             n_expert_shared=1, vocab_size=512, n_ctx=4096)
FILES = {"v3": dict(q_lora_rank=256, gating="sigmoid", weights_norm=True, weights_scale=2.5),
         "lite": dict()}
CTX = dict(n_ctx=256, n_seqs=2, n_ubatch=64)
MEMORIES = pytest.mark.parametrize("paged,quantized", [(True, True), (True, False),
                                                       (False, True), (False, False)],
                                   ids=["pool_int8", "pool_bf16", "slots_int8", "slots_bf16"])


def nmse(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.mean((got - ref) ** 2) / np.mean(ref ** 2))


def prompt(length, seed=0):
    return [int(t) for t in np.random.default_rng(seed).integers(3, 512, length)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small steps under pytest-xdist's workers on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("deepseek2")
    out = {name: make_bench_deepseek2_gguf(str(d / f"{name}.gguf"), **SHAPE, **kw)
           for name, kw in FILES.items()}
    out["lite_split"] = make_bench_deepseek2_gguf(str(d / "lite_split.gguf"), split_kv_b=True,
                                                  **SHAPE)
    out["tiny"] = make_tiny_deepseek32_gguf(str(d / "tiny.gguf"), arch="deepseek2")
    return out


@pytest.fixture(scope="module")
def models(paths):
    """name -> (port model, JAX model), made at first use."""
    made = {}

    def get(name):
        if name not in made:
            made[name] = load_model(paths[name], device="cpu"), jax_load_model(paths[name])
        return made[name]

    return get


@pytest.mark.parametrize("name", ["v3", "lite", "tiny"])
def test_config_matches_jax(models, name):
    """The registry's fields, the absorbed cache's dims and pad, and the
    YaRN-corrected kq_scale (mscale^2 / sqrt(Dk) over the naive Dk) equal
    the JAX package's; the layers carry the same weight keys."""
    model, jmodel = models(name)
    cfg, jcfg = model.cfg, jmodel.cfg
    for field in ("n_heads", "n_kv_heads", "head_dim_k", "head_dim_v", "rope_dims",
                  "rope_type", "rope_freq_scale", "rope_ext_factor", "rope_attn_factor",
                  "rope_orig_ctx", "expert_gating", "expert_weights_norm",
                  "expert_weights_scale", "n_expert", "n_expert_used", "n_expert_shared"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    for key in ("kv_lora_rank", "q_lora_rank", "yarn_log_mul", "mla_absorb", "mla_pad",
                "cache_n_kv_heads", "cache_head_dim_k", "cache_head_dim_v"):
        assert cfg.extra[key] == jcfg.extra[key], key
    assert cfg.extra["cache_head_dim_k"] % 128 == 0
    want = 1.0 / np.sqrt(jcfg.head_dim_k)
    if jcfg.rope_ext_factor > 0 and jcfg.rope_freq_scale != 1.0:
        ln = np.log(1.0 / jcfg.rope_freq_scale)
        m = (jcfg.rope_attn_factor * (1 + 0.1 * ln)
             * (1 + 0.1 * jcfg.extra["yarn_log_mul"] * ln))
        want = m * m / np.sqrt(jcfg.head_dim_k)
        assert want != pytest.approx(1.0 / np.sqrt(jcfg.head_dim_k))
    assert mla_kq_scale(cfg) == pytest.approx(want, rel=1e-12)
    assert [set(lw) for lw in model.params["layers"]] == [
        set(lw) for lw in jmodel.params["layers"]]


@MEMORIES
def test_prefill_and_decode_match_jax(models, paged, quantized):
    """The V3-shaped file (q-LoRA, dense layer then MoE with sigmoid gating,
    the selection bias and a shared expert): a 100-token prefill in two
    ubatches and 4 teacher-forced decode steps."""
    model, jmodel = models("v3")
    ctx = Context(model, device="cpu", paged=paged, quantized_kv=quantized, **CTX)
    jctx = JaxContext(jmodel, paged=paged, quantized_kv=quantized, **CTX)
    toks = prompt(100)
    assert nmse(ctx.prefill(toks), np.asarray(jctx.prefill(toks))) < 1e-3
    for t in (7, 19, 300, 4):
        assert nmse(ctx.decode_one(t), np.asarray(jctx.decode_one(t))) < 1e-3


@pytest.mark.parametrize("paged", [True, False], ids=["pool", "slots"])
def test_greedy_ids_equal_jax_on_the_tiny_file(models, paged):
    """The JAX package's tiny deepseek2 oracle (F32 weights): 12 greedy ids
    equal the JAX Context.generate's."""
    model, jmodel = models("tiny")
    toks = prompt(20, seed=3)
    toks = [t % 128 for t in toks]
    got = Context(model, device="cpu", paged=paged, n_ctx=128, n_seqs=1).generate(toks, 12)
    want = JaxContext(jmodel, paged=paged, n_ctx=128, n_seqs=1).generate(toks, 12)
    assert list(got) == list(want)


@pytest.mark.parametrize("paged", [True, False], ids=["pool", "slots"])
def test_absorbed_matches_naive(paths, monkeypatch, paged):
    """The absorbed path (one cached latent head, W_UK folded into q, W_UV
    on the output) against the naive expansion of attn_kv_b into 4 heads of
    K 64 / V 32, reached by a config without the absorb extras."""
    absorbed = load_model(paths["lite"], device="cpu")
    monkeypatch.setattr(registry, "_mla_absorb_extras", lambda cfg: None)
    naive = load_model(paths["lite"], device="cpu")
    assert "mla_k_b" in absorbed.params["layers"][0]
    assert "attn_kv_b" in naive.params["layers"][0] and "mla_absorb" not in naive.cfg.extra
    toks = prompt(70, seed=5)
    ca = Context(absorbed, device="cpu", paged=paged, **CTX)
    cn = Context(naive, device="cpu", paged=paged, **CTX)
    assert ca.kv.k[0].shape[-1] == 384 and ca.kv.v[0].shape[-1] == 256
    assert cn.kv.k[0].shape[-1] == 64 and cn.kv.v[0].shape[-1] == 32
    assert nmse(ca.prefill(toks), cn.prefill(toks)) < 1e-3
    for t in (9, 400):
        assert nmse(ca.decode_one(t), cn.decode_one(t)) < 1e-3


def test_split_kv_b_file_loads_bit_for_bit(models, paths):
    """attn_k_b + attn_v_b (the layout current llama.cpp files ship) load to
    the same mla_k_b / mla_v_b as the fused attn_kv_b, and the same logits."""
    fused = models("lite")[0]
    split = load_model(paths["lite_split"], device="cpu")
    for a, b in zip(fused.params["layers"], split.params["layers"]):
        assert set(a) == set(b)
        assert torch.equal(a["mla_k_b"], b["mla_k_b"]) and torch.equal(a["mla_v_b"], b["mla_v_b"])
    toks = prompt(40, seed=2)
    assert np.array_equal(Context(fused, device="cpu", **CTX).prefill(toks),
                          Context(split, device="cpu", **CTX).prefill(toks))


@pytest.mark.parametrize("paged", [True, False], ids=["pool", "slots"])
def test_context_shift_matches_jax(models, paged):
    """Prefill 90 tokens, shift (keep 8, discard 40), decode 3: within NMSE
    1e-3 of the JAX package's shift (the tail rope of the latent rows' k_pe)
    and no further from it than twice the difference before the shift."""
    model, jmodel = models("lite")
    ctx = Context(model, device="cpu", paged=paged, quantized_kv=True, **CTX)
    jctx = JaxContext(jmodel, paged=paged, quantized_kv=True, **CTX)
    toks = prompt(90, seed=4)
    for c in (ctx, jctx):
        c.prefill(toks)
    base = nmse(ctx.decode_one(7), np.asarray(jctx.decode_one(7)))
    for c in (ctx, jctx):
        assert c.context_shift(0, n_keep=8, n_discard=40) == 40
    for t in (7, 19, 200):
        err = nmse(ctx.decode_one(t), np.asarray(jctx.decode_one(t)))
        assert err < 1e-3 and err < 2 * base + 1e-6


def test_context_shift_ropes_the_tail_only(models):
    """On the slot table, the shifted rows equal the JAX package's
    KVCache.shift_seq on the same rows: c_kv and the pad unchanged, k_pe
    re-roped by -n_discard."""
    model, jmodel = models("lite")
    ctx = Context(model, device="cpu", paged=False, **CTX)
    jctx = JaxContext(jmodel, paged=False, **CTX)
    toks = prompt(60, seed=6)
    ctx.prefill(toks)
    jctx.prefill(toks)
    before = ctx.kv.k[1][0, 0, 10:50].float().clone()
    ctx.context_shift(0, n_keep=4, n_discard=6)
    jctx.context_shift(0, n_keep=4, n_discard=6)
    after = ctx.kv.k[1][0, 0, 4:44].float()
    C = model.cfg.extra["kv_lora_rank"] + model.cfg.extra["mla_pad"]
    assert torch.equal(after[:, :C], before[:, :C])
    assert not torch.equal(after[:, C:], before[:, C:])
    jk = np.asarray(jctx.kv.k[1, 0, 0, 4:44].astype(np.float32))
    assert nmse(after.numpy(), jk) < 1e-4


@pytest.mark.parametrize("paged", [True, False], ids=["pool", "slots"])
def test_seq_state_blob_both_ways(models, paged):
    """A sequence blob of the one-head 384/256 memory written by either
    package loads into the other (int8 rows and their scales)."""
    model, jmodel = models("lite")
    toks = prompt(50, seed=8)
    ctx = Context(model, device="cpu", paged=paged, quantized_kv=True, **CTX)
    jctx = JaxContext(jmodel, paged=paged, quantized_kv=True, **CTX)
    ctx.prefill(toks, seq=1)
    jctx.prefill(toks, seq=1)
    blob, jblob = state.save_seq_state(ctx, 1), jstate.save_seq_state(jctx, 1)
    want, jwant = ctx.decode_one(7, seq=1), np.asarray(jctx.decode_one(7, seq=1))
    into_jax = JaxContext(jmodel, paged=paged, quantized_kv=True, **CTX)
    assert jstate.load_seq_state(into_jax, 0, blob) == len(toks)
    into_port = Context(model, device="cpu", paged=paged, quantized_kv=True, **CTX)
    assert state.load_seq_state(into_port, 0, jblob) == len(toks)
    assert nmse(np.asarray(into_jax.decode_one(7, seq=0)), want) < 1e-3
    assert nmse(into_port.decode_one(7, seq=0), jwant) < 1e-3
    again = Context(model, device="cpu", paged=paged, quantized_kv=True, **CTX)
    state.load_seq_state(again, 0, blob)
    assert np.array_equal(again.decode_one(7, seq=0), want)


@pytest.mark.parametrize("paged", [True, False], ids=["pool", "slots"])
def test_context_allocates_one_latent_head(models, paged):
    """The memory holds one KV head of K 384 / V 256 per layer (the JAX
    Context's sizing), and memory_breakdown counts those tensors."""
    model, jmodel = models("v3")
    ctx = Context(model, device="cpu", paged=paged, quantized_kv=True, **CTX)
    kv = ctx.kv
    assert isinstance(kv, PagedKVCache if paged else KVCache)
    head_axis = 0 if paged else 1
    assert all(k.shape[head_axis] == 1 and k.shape[-1] == 384 for k in kv.k)
    assert all(v.shape[head_axis] == 1 and v.shape[-1] == 256 for v in kv.v)
    jkv = JaxContext(jmodel, paged=paged, quantized_kv=True, **CTX).kv
    assert jkv.k[0].shape[-1] == 384 and jkv.v[0].shape[-1] == 256
    rows = kv.k[0].shape[1] if paged else kv.k[0].shape[0] * kv.k[0].shape[2]
    per_row = 2 * (384 + 256) // 2 + 8  # int8 K and V and their two f32 scales
    assert ctx.memory_breakdown()["memory_bytes"] == (
        len(kv.k) * rows * per_row + kv.pos.numel() * 4
        + (kv.table.numel() * 4 if paged else 0))


def test_params_from_jax_carry_the_mla_weights(models):
    """The JAX parameters (mla_k_b, mla_v_b, the q-LoRA and latent weights,
    exp_probs_b) turned into the port's compute the port's own logits."""
    import jax

    model, jmodel = models("v3")
    jp = jax.tree_util.tree_map(np.asarray, jmodel.params)
    carried = Model(model.cfg, params_from_jax(jp), torch.device("cpu"))
    for key in ("mla_k_b", "mla_v_b", "attn_q_a", "attn_q_a_norm", "attn_q_b",
                "attn_kv_a_mqa", "attn_kv_a_norm", "exp_probs_b"):
        assert key in carried.params["layers"][1], key
    toks = prompt(30, seed=9)
    got = Context(carried, device="cpu", **CTX).prefill(toks)
    assert nmse(got, Context(model, device="cpu", **CTX).prefill(toks)) < 1e-3


def test_deepseek32_is_refused_by_name(tmp_path):
    """DeepSeek's sparse attention (deepseek32) needs the DSA memory, which
    is not ported: loading raises NotImplementedError naming the arch."""
    path = make_tiny_deepseek32_gguf(str(tmp_path / "ds32.gguf"))
    with pytest.raises(NotImplementedError, match="'deepseek32'"):
        load_model(path, device="cpu")
