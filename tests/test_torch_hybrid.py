"""The port's recurrent and hybrid memories and their families (mamba,
mamba2, jamba, qwen3next, qwen35, qwen35moe, lfm2, lfm2moe, nemotron_h,
nemotron_h_moe, falcon-h1, granitehybrid, plamo2, kimi-linear), each
against the JAX package on the CPU.

The mixers, from numpy-seeded weights, inputs and states of three
sequences (two of them in the batch, in another order): the causal conv,
Mamba-1 (with and without FalconMamba's dt/B/C norms), Mamba-2, PLaMo-2's
mixer, the gated DeltaNet in both of its layouts, Kimi's delta attention
(KDA) with q|k|v fused or v apart, and LFM2's short conv, each at T = 1, 6
and 7 (the associative scan's odd and even halvings); output, new conv
window and new state within f32 NMSE 1e-6. Interleaved M-RoPE on text
positions against the JAX apply_mrope. Each entry on one fixture
(testing.make_bench_hybrid_gguf with testing.HYBRID_LAYOUTS: n_embd 256,
heads of 64, vocab 256) read by both packages from the same bytes: layer
keys, flags and extras equal; f32 logits of a prefill and 4 decode steps
within NMSE 1e-5; 8 greedy ids equal; and qwen3next, qwen35, nemotron_h,
granitehybrid and falcon-h1 on their Q4_K/Q6_K files, teacher-forced logits
within NMSE 5e-3 (the conformance threshold). The memory: seq_cp then
divergent decode, seq_rm (p0 = 0 zeroes the row, p0 > 0 raises and
changes nothing), whole-context and sequence state bit for bit (and a JAX
sequence blob continued in the port), a JAX prefill's RecurrentState
continued in the port, a batched B = 2 step against the reference's B = 1
steps (XLA:CPU cannot run the JAX batched step), uneven ubatches against
one, exact-shape decode batches, the context shift refused; Nemotron-H
with an FFN block before its first attention block labels its positions;
the per-expert MoE route in chunks of experts against one chunk and JAX.
The server: a served round on a tiny hybrid against Context.generate, a
request that shares the slot's prefix, speculation and context shift
refused; llama-cli's prompt cache and its speculation flag on a hybrid."""

import json
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_tpu.models import mamba as jmamba
from llama_cpp_tpu.models.config import ModelConfig as JaxConfig
from llama_cpp_tpu.models.loader import load_model as jax_load_model
from llama_cpp_tpu.ops import rope as jrope
from llama_cpp_tpu.runtime import state as jstate
from llama_cpp_tpu.runtime.context import Context as JaxContext
from llama_cpp_tpu.runtime.memory import RecurrentState as JaxRecurrentState
from llama_cpp_tpu_torch.models import mamba
from llama_cpp_tpu_torch.models.config import ModelConfig
from llama_cpp_tpu_torch.models.from_jax import recurrent_from_jax
from llama_cpp_tpu_torch.models.loader import load_model
from llama_cpp_tpu_torch.models.registry import supported_archs
from llama_cpp_tpu_torch.ops import rope
from llama_cpp_tpu_torch.runtime import state
from llama_cpp_tpu_torch.runtime.context import Context
from llama_cpp_tpu_torch.runtime.memory import HybridMemory, RecurrentState
from llama_cpp_tpu_torch.runtime.paged_kv import PagedKVCache
from llama_cpp_tpu_torch.server import app as server_app
from llama_cpp_tpu_torch.server.scheduler import Scheduler
from llama_cpp_tpu_torch.testing import HYBRID_LAYOUTS, make_bench_hybrid_gguf

ARCHS = HYBRID_LAYOUTS
ARCH = pytest.mark.parametrize("arch", list(ARCHS))
SHAPE = dict(n_embd=256, vocab_size=256)
QUANTIZED = ("qwen3next", "qwen35", "nemotron_h", "granitehybrid", "falcon-h1")
FLAGS = ("rope_type", "act", "glu", "qk_norm", "post_norms", "attn_scale", "embd_scale",
         "residual_scale", "logit_scale", "n_expert", "n_expert_used", "n_expert_shared",
         "expert_gating", "expert_weights_norm", "expert_weights_scale", "tie_embeddings",
         "rope_dims", "n_kv_heads", "head_dim_k", "head_dim_v")
EXTRAS = ("memory", "ssm_version", "ssm_d_conv", "ssm_d_inner", "ssm_d_state", "ssm_dt_rank",
          "ssm_n_group", "ssm_conv_dim", "ssm_dt_b_c_rms", "shortconv_l", "mrope_sections",
          "imrope", "q_gate_interleaved", "no_rope_layers", "tensor_remap", "dual_mixer",
          "plamo2", "kda_head_dim", "kv_lora_rank", "q_lora_rank")
CTX = dict(n_ctx=64, n_seqs=1, n_ubatch=32)
NMSE_F32 = 1e-5
NMSE_MIXER = 1e-6
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


@pytest.fixture(scope="module")
def f32_models(tmp_path_factory):
    """arch -> (port model, JAX model, path), both f32 from one f32 file,
    made at first use."""
    made = {}

    def get(arch):
        if arch not in made:
            path = str(tmp_path_factory.mktemp(arch) / f"{arch}.gguf")
            make_bench_hybrid_gguf(path, arch, **SHAPE, **ARCHS[arch], f32=True)
            made[arch] = (load_model(path, device="cpu", dense_dtype=torch.float32),
                          jax_load_model(path, dense_dtype=jnp.float32), path)
        return made[arch]

    return get


def rs_of(ctx) -> RecurrentState:
    return ctx.kv.rs if isinstance(ctx.kv, HybridMemory) else ctx.kv


def port_ctx(model, **kw):
    return Context(model, device="cpu", **{**CTX, **kw})


def jax_ctx(jmodel, **kw):
    return JaxContext(jmodel, kv_dtype=jnp.float32, **{**CTX, **kw})


# -- the mixers against the JAX functions ------------------------------------

E_MIX = 32


class _JaxMem:
    """A JAX RecurrentState of the test's numpy state."""

    def __new__(cls, conv, ssm):
        return JaxRecurrentState(conv=jnp.asarray(conv), ssm=jnp.asarray(ssm))


def _mixer_case(extra: dict, weights: dict, conv_ch: int, d_state: int, d_inner: int, T: int,
                seed: int = 0):
    """Both packages' configs, weights, states (3 sequences, the batch rows
    2 and 0) and input h [2, T, E]."""
    rng = np.random.default_rng(seed)
    jcfg = JaxConfig(arch="t", n_embd=E_MIX)
    jcfg.extra.update(extra)
    cfg = ModelConfig(arch="t", n_embd=E_MIX)
    cfg.extra.update(extra)
    dc = extra["ssm_d_conv"]
    conv = (0.5 * rng.standard_normal((1, 3, dc - 1, conv_ch))).astype(np.float32)
    ssm = (0.5 * rng.standard_normal((1, 3, d_state, d_inner))).astype(np.float32)
    h = rng.standard_normal((2, T, E_MIX)).astype(np.float32)
    lw = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in weights.items()}
    jlw = {k: jnp.asarray(v) for k, v in weights.items()}
    mem = RecurrentState(conv=torch.from_numpy(conv.copy()), ssm=torch.from_numpy(ssm.copy()))
    return cfg, jcfg, lw, jlw, mem, _JaxMem(conv, ssm), h


def _hold(port_out, jax_out):
    for got, ref in zip(port_out, jax_out):
        assert tuple(got.shape) == tuple(ref.shape)
        assert nmse(got.numpy(), np.asarray(ref)) <= NMSE_MIXER


SEQ = np.asarray([2, 0], np.int32)
TS = pytest.mark.parametrize("T", [1, 6, 7])


def _w(rng, *shape, scale=None):
    return (rng.standard_normal(shape) * (scale or 1.0 / np.sqrt(shape[-1]))).astype(np.float32)


@TS
def test_causal_conv_matches_jax(T):
    rng = np.random.default_rng(1)
    C = 24
    weights = {"ssm_conv1d": _w(rng, C, 4, scale=0.4), "ssm_conv1d_bias": _w(rng, C, scale=0.1)}
    cfg, jcfg, lw, jlw, mem, jmem, _ = _mixer_case({"ssm_d_conv": 4}, weights, C, 4, C, T)
    xs = rng.standard_normal((2, T, C)).astype(np.float32)
    got = mamba._causal_conv(mem, 0, torch.from_numpy(SEQ), torch.from_numpy(xs), lw, 4)
    ref = jmamba._causal_conv(jmem, 0, jnp.asarray(SEQ), jnp.asarray(xs), jlw, 4)
    _hold(got, ref)


@TS
@pytest.mark.parametrize("norms", [False, True], ids=["mamba", "falcon_mamba"])
def test_mamba1_layer_matches_jax(T, norms):
    """selective_scan under mamba1_layer; FalconMamba's dt/B/C RMSNorms."""
    rng = np.random.default_rng(2)
    I, S, R, dc = 48, 8, 6, 4
    extra = dict(ssm_d_conv=dc, ssm_d_state=S, ssm_dt_rank=R, ssm_d_inner=I,
                 ssm_dt_b_c_rms=norms)
    weights = {"ssm_in": _w(rng, 2 * I, E_MIX), "ssm_conv1d": _w(rng, I, dc, scale=0.4),
               "ssm_conv1d_bias": _w(rng, I, scale=0.1), "ssm_x": _w(rng, R + 2 * S, I),
               "ssm_dt": _w(rng, I, R), "ssm_dt_bias": _w(rng, I, scale=0.3),
               "ssm_a": -np.exp(_w(rng, I, S, scale=0.5)), "ssm_d": _w(rng, I, scale=0.3),
               "ssm_out": _w(rng, E_MIX, I)}
    if norms:
        weights.update(ssm_dt_norm=1 + _w(rng, R, scale=0.1), ssm_b_norm=1 + _w(rng, S, scale=0.1),
                       ssm_c_norm=1 + _w(rng, S, scale=0.1))
    cfg, jcfg, lw, jlw, mem, jmem, h = _mixer_case(extra, weights, I, S, I, T)
    got = mamba.mamba1_layer(cfg, lw, torch.from_numpy(h), mem, torch.from_numpy(SEQ), 0)
    ref = jmamba.mamba1_layer(jcfg, jlw, jnp.asarray(h), jmem, jnp.asarray(SEQ), 0)
    _hold(got, ref)


@TS
def test_mamba2_layer_matches_jax(T):
    rng = np.random.default_rng(3)
    I, S, H, G, dc = 32, 8, 4, 2, 4
    conv_dim = I + 2 * G * S
    extra = dict(ssm_d_conv=dc, ssm_d_state=S, ssm_dt_rank=H, ssm_n_group=G, ssm_d_inner=I)
    weights = {"ssm_in": _w(rng, I + conv_dim + H, E_MIX),
               "ssm_conv1d": _w(rng, conv_dim, dc, scale=0.4),
               "ssm_conv1d_bias": _w(rng, conv_dim, scale=0.1),
               "ssm_dt_bias": _w(rng, H, scale=0.3), "ssm_a": -np.exp(_w(rng, H, 1, scale=0.5)),
               "ssm_d": _w(rng, H, 1, scale=0.3), "ssm_norm": 1 + _w(rng, G, I // G, scale=0.1),
               "ssm_out": _w(rng, E_MIX, I)}
    cfg, jcfg, lw, jlw, mem, jmem, h = _mixer_case(extra, weights, conv_dim, S, I, T)
    got = mamba.mamba2_layer(cfg, lw, torch.from_numpy(h), mem, torch.from_numpy(SEQ), 0)
    ref = jmamba.mamba2_layer(jcfg, jlw, jnp.asarray(h), jmem, jnp.asarray(SEQ), 0)
    _hold(got, ref)


@TS
@pytest.mark.parametrize("layout", ["qkvz", "flat"])
def test_gated_delta_layer_matches_jax(T, layout):
    """qwen3next's interleaved ssm_in/ssm_ba and qwen35's flat attn_qkv,
    attn_gate, ssm_beta, ssm_alpha; 2 key heads of 8, 4 value heads of 8."""
    rng = np.random.default_rng(4)
    Dk, Hk, Hv, Dv, dc = 8, 2, 4, 8, 4
    R, key_dim, I = Hv // Hk, Hk * Dk, Hv * Dv
    extra = dict(ssm_d_conv=dc, ssm_d_state=Dk, ssm_n_group=Hk, ssm_dt_rank=Hv, ssm_d_inner=I)
    weights = {"ssm_conv1d": _w(rng, 2 * key_dim + I, dc, scale=0.4),
               "ssm_dt_bias": _w(rng, Hv, scale=0.3), "ssm_a": -np.exp(_w(rng, Hv, scale=0.5)),
               "ssm_norm": 1 + _w(rng, Dv, scale=0.1), "ssm_out": _w(rng, E_MIX, I)}
    if layout == "qkvz":
        weights.update(ssm_in=_w(rng, Hk * (2 * Dk + 2 * R * Dv), E_MIX),
                       ssm_ba=_w(rng, 2 * Hv, E_MIX))
    else:
        weights.update(attn_qkv=_w(rng, 2 * key_dim + I, E_MIX), attn_gate=_w(rng, I, E_MIX),
                       ssm_beta=_w(rng, Hv, E_MIX), ssm_alpha=_w(rng, Hv, E_MIX))
    cfg, jcfg, lw, jlw, mem, jmem, h = _mixer_case(extra, weights, 2 * key_dim + I, Dk, I, T)
    got = mamba.gated_delta_layer(cfg, lw, torch.from_numpy(h), mem, torch.from_numpy(SEQ), 0)
    ref = jmamba.gated_delta_layer(jcfg, jlw, jnp.asarray(h), jmem, jnp.asarray(SEQ), 0)
    _hold(got, ref)


@TS
def test_plamo2_layer_matches_jax(T):
    """PLaMo-2's mixer: per-head [z | x], the conv over x, x_proj after it
    with normed B, C, dt, a scalar decay a head."""
    rng = np.random.default_rng(7)
    I, S, H, dtd, dc = 32, 8, 4, 6, 4
    extra = dict(ssm_d_conv=dc, ssm_d_state=S, ssm_dt_rank=H, ssm_d_inner=I)
    weights = {"ssm_in": _w(rng, 2 * I, E_MIX), "ssm_conv1d": _w(rng, I, dc, scale=0.4),
               "ssm_x": _w(rng, 2 * S + dtd, I), "ssm_dt": _w(rng, H, dtd),
               "ssm_dt_bias": _w(rng, H, scale=0.3), "ssm_a": -np.exp(_w(rng, H, scale=0.5)),
               "ssm_d": _w(rng, H, scale=0.3), "ssm_dt_norm": 1 + _w(rng, dtd, scale=0.1),
               "ssm_b_norm": 1 + _w(rng, S, scale=0.1), "ssm_c_norm": 1 + _w(rng, S, scale=0.1),
               "ssm_out": _w(rng, E_MIX, I)}
    cfg, jcfg, lw, jlw, mem, jmem, h = _mixer_case(extra, weights, I, S, I, T)
    got = mamba.plamo2_layer(cfg, lw, torch.from_numpy(h), mem, torch.from_numpy(SEQ), 0)
    ref = jmamba.plamo2_layer(jcfg, jlw, jnp.asarray(h), jmem, jnp.asarray(SEQ), 0)
    _hold(got, ref)


@TS
@pytest.mark.parametrize("proj", ["qkv", "qk_v"])
def test_kda_layer_matches_jax(T, proj):
    """Kimi's delta attention: a decay a key channel, separate q/k/v convs,
    the sigmoid-gated output norm; 4 heads of 8. With q|k fused and v apart
    (the Q4_K_M mix's fusion), against the JAX function on the three
    projections apart."""
    rng = np.random.default_rng(8)
    H, Dh, dc = 4, 8, 4
    I = H * Dh
    extra = dict(ssm_d_conv=dc, kda_head_dim=Dh)
    weights = {"attn_q": _w(rng, I, E_MIX), "attn_k": _w(rng, I, E_MIX),
               "attn_v": _w(rng, I, E_MIX), "ssm_f_a": _w(rng, Dh, E_MIX),
               "ssm_f_b": _w(rng, I, Dh), "ssm_g_a": _w(rng, Dh, E_MIX),
               "ssm_g_b": _w(rng, I, Dh), "ssm_beta": _w(rng, H, E_MIX),
               "ssm_a": -np.exp(_w(rng, H, 1, scale=0.5)), "ssm_dt_bias": _w(rng, I, scale=0.3),
               "ssm_norm": 1 + _w(rng, Dh, scale=0.1), "attn_output": _w(rng, E_MIX, I)}
    for cn in ("ssm_conv1d_q", "ssm_conv1d_k", "ssm_conv1d_v"):
        weights[cn] = _w(rng, I, 1, dc, scale=0.4)
    cfg, jcfg, lw, jlw, mem, jmem, h = _mixer_case(extra, weights, 3 * I, Dh, I, T)
    cfg.n_heads = jcfg.n_heads = H
    if proj == "qk_v":
        lw["attn_qk"] = torch.cat([lw.pop("attn_q"), lw.pop("attn_k")], dim=0)
    got = mamba.kda_layer(cfg, lw, torch.from_numpy(h), mem, torch.from_numpy(SEQ), 0)
    ref = jmamba.kda_layer(jcfg, jlw, jnp.asarray(h), jmem, jnp.asarray(SEQ), 0)
    _hold(got, ref)


@TS
def test_lfm2_shortconv_layer_matches_jax(T):
    rng = np.random.default_rng(5)
    L = 3
    extra = dict(shortconv_l=L, ssm_d_conv=L)
    weights = {"shortconv_in": _w(rng, 3 * E_MIX, E_MIX),
               "shortconv_conv": _w(rng, E_MIX, L, scale=0.4),
               "shortconv_out": _w(rng, E_MIX, E_MIX)}
    cfg, jcfg, lw, jlw, mem, jmem, h = _mixer_case(extra, weights, E_MIX, 1, E_MIX, T)
    got = mamba.lfm2_shortconv_layer(cfg, lw, torch.from_numpy(h), mem, torch.from_numpy(SEQ), 0)
    ref = jmamba.lfm2_shortconv_layer(jcfg, jlw, jnp.asarray(h), jmem, jnp.asarray(SEQ), 0)
    _hold(got, ref)


@pytest.mark.parametrize("sections", [(3, 3, 2, 0), (24, 20, 20, 0)],
                         ids=["fourth_stream", "qwen35_default"])
def test_interleaved_mrope_matches_jax(sections):
    """Text positions broadcast to the t/h/w streams, the 4th stream zero:
    pairs routed to it stay unrotated (rope over 48 of 64 dims, base 1e7)."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 3, 64)).astype(np.float32)
    pos = np.asarray([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
    pos3 = np.broadcast_to(pos[None], (3, 2, 5))
    rp = rope.RopeParams(rope_type=rope.ROPE_TYPE_NEOX, n_dims=48, freq_base=1e7)
    jrp = jrope.RopeParams(rope_type=jrope.ROPE_TYPE_NEOX, n_dims=48, freq_base=1e7)
    got = rope.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3.copy()), sections, rp)
    ref = jrope.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), sections, jrp, interleaved=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


# -- each registered entry ----------------------------------------------------

def test_supported_archs_cover_the_slice():
    assert set(ARCHS) <= set(supported_archs())


@ARCH
def test_layer_keys_and_flags_match_jax(f32_models, arch):
    model, jmodel, _ = f32_models(arch)
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
    """A 12-token prefill and 4 decode steps, every step's logits within
    NMSE 1e-5 (f32 weights, activations, KV and states)."""
    model, jmodel, _ = f32_models(arch)
    ctx, jctx = port_ctx(model), jax_ctx(jmodel)
    steps = [(ctx.prefill(prompt(12, seed=3)), np.asarray(jctx.prefill(prompt(12, seed=3))))]
    for t in prompt(4, seed=4):
        steps.append((ctx.decode_one(t), np.asarray(jctx.decode_one(t))))
    for got, ref in steps:
        assert got.shape == ref.shape == (256,)
        assert nmse(got, ref) <= NMSE_F32


@ARCH
def test_greedy_ids_match_jax(f32_models, arch):
    model, jmodel, _ = f32_models(arch)
    p = prompt(10, seed=2)
    assert port_ctx(model).generate(p, max_new_tokens=8) == jax_ctx(jmodel).generate(
        p, max_new_tokens=8)


@pytest.mark.parametrize("arch", QUANTIZED)
def test_quantized_logits_match_jax(tmp_path, arch):
    """The Q4_K_M mix (synthetic block scales / 16) in bf16 through both
    packages: a 20-token prefill and 4 teacher-forced steps, each within
    NMSE 5e-3."""
    path = str(tmp_path / f"{arch}.gguf")
    make_bench_hybrid_gguf(path, arch, **SHAPE, **ARCHS[arch], synth_scale=1.0 / 16)
    model = load_model(path, device="cpu")
    assert "QuantTensor" in {type(w).__name__ for lw in model.params["layers"]
                             for w in lw.values()}
    ctx, jctx = port_ctx(model), JaxContext(jax_load_model(path), **CTX)
    errs = [nmse(ctx.prefill(prompt(20, seed=5)), np.asarray(jctx.prefill(prompt(20, seed=5))))]
    for t in prompt(4, seed=6):
        errs.append(nmse(ctx.decode_one(t), np.asarray(jctx.decode_one(t))))
    assert max(errs) <= NMSE_QUANT, errs


# -- the memory -----------------------------------------------------------------

MEM_ARCHS = pytest.mark.parametrize("arch", ["mamba2", "qwen3next"])


@MEM_ARCHS
def test_context_builds_the_memory_and_refuses_context_shift(f32_models, arch):
    model, _, _ = f32_models(arch)
    ctx = port_ctx(model, n_seqs=3)
    assert ctx.recurrent
    if arch == "mamba2":
        assert isinstance(ctx.kv, RecurrentState) and not ctx.paged and ctx.alloc is None
    else:
        assert isinstance(ctx.kv, HybridMemory) and isinstance(ctx.kv.kv, PagedKVCache)
        assert ctx._pool() is ctx.kv.kv
    ex = model.cfg.extra
    assert tuple(rs_of(ctx).conv.shape) == (model.cfg.n_layers, 3, ex["ssm_d_conv"] - 1,
                                            ex["ssm_conv_dim"])
    assert [ctx._batch_bucket(b) for b in (1, 2, 3)] == [1, 2, 3]
    ctx.prefill(prompt(8), seq=0)
    with pytest.raises(NotImplementedError, match="recurrent"):
        ctx.context_shift(0, n_keep=2)


@MEM_ARCHS
def test_seq_cp_then_divergent_decode_matches_jax(f32_models, arch):
    model, jmodel, _ = f32_models(arch)
    ctx, jctx = port_ctx(model, n_seqs=2), jax_ctx(jmodel, n_seqs=2)
    ctx.prefill(prompt(9), seq=0)
    jctx.prefill(prompt(9), seq=0)
    ctx.seq_cp(1, 0)
    jctx.seq_cp(1, 0)
    for seq, toks in ((0, (11, 12, 13)), (1, (40, 41, 42))):
        for t in toks:
            assert nmse(ctx.decode_one(t, seq=seq),
                        np.asarray(jctx.decode_one(t, seq=seq))) <= NMSE_F32


@MEM_ARCHS
def test_seq_rm_zeroes_the_row_and_refuses_a_range(f32_models, arch):
    model, jmodel, _ = f32_models(arch)
    ctx, jctx = port_ctx(model, n_seqs=2), jax_ctx(jmodel, n_seqs=2)
    for s in (0, 1):
        ctx.prefill(prompt(6, seed=s), seq=s)
        jctx.prefill(prompt(6, seed=s), seq=s)
    rs = rs_of(ctx)
    before = (rs.conv.clone(), rs.ssm.clone())
    with pytest.raises(NotImplementedError):
        ctx.seq_rm(0, p0=3)
    with pytest.raises(NotImplementedError):
        jctx.seq_rm(0, p0=3)
    assert torch.equal(rs.conv, before[0]) and torch.equal(rs.ssm, before[1])
    assert int(ctx.seq_len[0]) == 6
    ctx.seq_rm(0)
    jctx.seq_rm(0)
    assert not rs.conv[:, 0].any() and not rs.ssm[:, 0].any()
    assert torch.equal(rs.conv[:, 1], before[0][:, 1]) and torch.equal(rs.ssm[:, 1],
                                                                      before[1][:, 1])
    assert int(ctx.seq_len[0]) == 0
    p = prompt(7, seed=9)
    assert nmse(ctx.prefill(p, seq=0), np.asarray(jctx.prefill(p, seq=0))) <= NMSE_F32


@MEM_ARCHS
def test_state_round_trips_bit_for_bit(f32_models, arch, tmp_path):
    """Whole-context files into a fresh context and a sequence blob into
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
    assert torch.equal(rs_of(other).conv[:, 1], rs_of(ctx).conv[:, 0])
    assert torch.equal(rs_of(other).ssm[:, 1], rs_of(ctx).ssm[:, 0])
    want = ctx.decode_one(17, seq=0)
    assert np.array_equal(fresh.decode_one(17, seq=0), want)
    assert np.array_equal(other.decode_one(17, seq=1), want)


@MEM_ARCHS
def test_jax_sequence_blob_continues_in_the_port(f32_models, arch):
    model, jmodel, _ = f32_models(arch)
    jctx = jax_ctx(jmodel, n_seqs=2)
    jctx.prefill(prompt(10), seq=1)
    ctx = port_ctx(model, n_seqs=2)
    state.load_seq_state(ctx, 0, jstate.save_seq_state(jctx, 1))
    for t in (5, 6):
        assert nmse(ctx.decode_one(t, seq=0), np.asarray(jctx.decode_one(t, seq=1))) <= NMSE_F32


def test_jax_recurrent_state_continues_in_the_port(f32_models):
    """recurrent_from_jax: a JAX prefill's RecurrentState, decoded on in the
    port."""
    model, jmodel, _ = f32_models("mamba")
    jctx = jax_ctx(jmodel)
    jctx.prefill(prompt(11))
    ctx = port_ctx(model)
    ctx.kv = recurrent_from_jax(jax_tree_numpy(jctx.kv))
    ctx.seq_len[0] = jctx.seq_len[0]
    for t in (8, 9, 10):
        assert nmse(ctx.decode_one(t), np.asarray(jctx.decode_one(t))) <= NMSE_F32


def jax_tree_numpy(jrs):
    return JaxRecurrentState(conv=np.asarray(jrs.conv), ssm=np.asarray(jrs.ssm))


@MEM_ARCHS
def test_batched_step_matches_the_reference_single_steps(f32_models, arch):
    """decode_step_multi at B = 2 (rows in another order than the
    sequences) against the JAX package's decode_one on each sequence; then
    decode_steps_greedy at B = 3, an exact-shape loop, against three
    single-sequence greedy runs."""
    model, jmodel, _ = f32_models(arch)
    ctx, jctx = port_ctx(model, n_seqs=3), jax_ctx(jmodel, n_seqs=3)
    for s in range(3):
        ctx.prefill(prompt(5 + s, seed=s), seq=s)
        jctx.prefill(prompt(5 + s, seed=s), seq=s)
    got = ctx.decode_step_multi(np.asarray([21, 22]), np.asarray([2, 0]))
    for row, (seq, t) in enumerate(((2, 21), (0, 22))):
        assert nmse(got[row], np.asarray(jctx.decode_one(t, seq=seq))) <= NMSE_F32
    greedy = port_ctx(model, n_seqs=3)
    singles = []
    for s in range(3):
        greedy.prefill(prompt(5 + s, seed=s), seq=s)
        singles.append(port_ctx(model).generate(prompt(5 + s, seed=s), max_new_tokens=5))
    firsts = np.asarray([ids[0] for ids in singles], np.int32)
    out = greedy.decode_steps_greedy(firsts, np.arange(3), 4)
    assert out.tolist() == [ids[1:] for ids in singles]


@MEM_ARCHS
def test_uneven_ubatches_equal_one_ubatch(f32_models, arch):
    model, _, _ = f32_models(arch)
    p = prompt(13, seed=7)
    one = port_ctx(model, n_ubatch=32).prefill(p)
    uneven = port_ctx(model, n_ubatch=5).prefill(p)  # 5 + 5 + 3 tokens
    assert nmse(uneven, one) <= 1e-10


@pytest.mark.parametrize("before", [False, True], ids=["weights_after", "weight_before"])
def test_per_expert_route_in_chunks_matches_jax(f32_models, monkeypatch, before):
    """The per-expert route (12 tokens x top 4 over 8 experts) with its
    experts in chunks of 3, 3 and 2 equals it in one chunk, and the JAX
    package's moe_block (qwen3next's experts; with the gate weight on the
    expert input, llama4's rule, too)."""
    from llama_cpp_tpu.models import transformer as jtf
    from llama_cpp_tpu_torch.models import transformer as ttf

    model, jmodel, _ = f32_models("qwen3next")
    cfg, jcfg = model.cfg, jmodel.cfg
    if before:
        cfg = cfg.with_(extra={**cfg.extra, "moe_weight_before": True})
        jcfg = jcfg.with_(extra={**jcfg.extra, "moe_weight_before": True})
    lw, jlw = model.params["layers"][0], jmodel.params["layers"][0]
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((1, 12, 256))
                         .astype(np.float32))
    topi, topw = ttf._route(cfg, lw, x, True)
    assert x.shape[1] * cfg.n_expert_used >= cfg.n_expert
    whole = ttf._moe_ragged(cfg, lw, x, topi, topw, True)
    per_expert = lw["ffn_gate_exps"][0].numel()
    monkeypatch.setattr(ttf, "RAGGED_CHUNK_WEIGHTS", 3 * per_expert)
    chunked = ttf._moe_ragged(cfg, lw, x, topi, topw, True)
    assert nmse(chunked.numpy(), whole.numpy()) <= 1e-12
    got = ttf.moe_block(cfg, lw, x).numpy()
    ref = np.asarray(jtf.moe_block(jcfg, jlw, jnp.asarray(x.numpy())))
    assert nmse(got, ref) <= NMSE_F32


def test_nemotron_ffn_block_before_attention_labels_positions(tmp_path):
    """Nemotron-H's pattern M-M-...: an FFN block comes before the first
    attention block, whose K/V rows must still carry their positions."""
    path = str(tmp_path / "nh.gguf")
    make_bench_hybrid_gguf(path, "nemotron_h", "SFA", **SHAPE, d_state=32, n_group=2, f32=True)
    model = load_model(path, device="cpu", dense_dtype=torch.float32)
    ctx = port_ctx(model)
    ctx.prefill(prompt(9))
    labels = ctx.kv.kv.seq_slot_pos(torch.tensor([0]))[0]
    assert sorted(int(p) for p in labels if p >= 0) == list(range(9))


# -- the server -----------------------------------------------------------------

def _serve(model, **kw):
    box, ready = {}, threading.Event()
    th = threading.Thread(target=server_app.run_server, args=(model,), daemon=True, kwargs=dict(
        host="127.0.0.1", port=0, device="cpu",
        ready=lambda s: (box.setdefault("s", s), ready.set()), **kw))
    th.start()
    assert ready.wait(60)
    return box["s"], th


def _post(srv, body):
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/completion",
                                 data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_served_requests_on_a_hybrid_equal_generate(f32_models):
    """Two concurrent requests, then one that shares the first's prefix
    (its prompt decoded whole: a recurrent state keeps no prefix)."""
    model, _, _ = f32_models("qwen3next")
    srv, th = _serve(model, n_seqs=2, n_ctx=64, n_ubatch=32)
    prompts = [prompt(9, seed=1), prompt(6, seed=2), prompt(9, seed=1) + [30, 31]]
    out = [None, None]
    try:
        def ask(i):
            out[i] = _post(srv, {"prompt": prompts[i], "n_predict": 6, "temperature": 0,
                                 "ignore_eos": True, "return_tokens": True})

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        out.append(_post(srv, {"prompt": prompts[2], "n_predict": 6, "temperature": 0,
                               "ignore_eos": True, "return_tokens": True}))
        assert srv.app.sched.metrics["tokens_prompt_cached_total"] == 0
    finally:
        srv.shutdown()
        th.join(timeout=30)
    for p, reply in zip(prompts, out):
        assert reply["tokens"] == port_ctx(model).generate(p, max_new_tokens=6)


def test_cli_prompt_cache_and_speculation_on_a_hybrid(f32_models, tmp_path, capsys):
    """llama-cli on a hybrid: --prompt-cache run twice reuses the whole
    cached state where the new prompt extends the cached one, and prints
    what a run without the cache prints; --spec-ngram is turned off, with a
    note, and prints the same."""
    from llama_cpp_tpu_torch.tools import cli

    _, _, path = f32_models("qwen3next")
    base = ["-m", path, "-n", "8", "-c", "256", "--temp", "0", "--device", "cpu"]

    def run(*argv):
        capsys.readouterr()
        rc = cli.main([*base, *argv])
        out = capsys.readouterr()
        assert rc == 0
        return out.out, out.err

    cache = str(tmp_path / "p.cache")
    first, second = "the cat is on the mat", "the cat is on the mat and so on"
    assert run("-p", first, "--prompt-cache", cache)[0] == run("-p", first)[0]
    out, err = run("-p", second, "--prompt-cache", cache)
    assert "prompt cache: reused" in err and out == run("-p", second)[0]
    out, err = run("-p", first, "--spec-ngram")
    assert "speculative decoding: off" in err and out == run("-p", first)[0]


def test_scheduler_refuses_speculation_and_context_shift(f32_models):
    """A speculator factory is dropped for a recurrent context; a request
    past n_ctx ends at the context's end instead of shifting."""
    model, _, _ = f32_models("nemotron_h")
    ctx = port_ctx(model, n_ctx=24, n_seqs=1)
    sched = Scheduler(ctx, spec_factory=lambda i: object())
    assert sched.spec_factory is None
    done, box = threading.Event(), {}
    from llama_cpp_tpu_torch.sampling.samplers import SamplingParams
    from llama_cpp_tpu_torch.server.scheduler import GenTask

    sched.start()
    try:
        sched.submit(GenTask(prompt_ids=prompt(10), params=SamplingParams(temp=0.0),
                             max_tokens=40, ignore_eos=True,
                             done_cb=lambda r: (box.setdefault("r", r), done.set())))
        assert done.wait(120)
    finally:
        sched.stop()
    r = box["r"]
    assert r["finish_reason"] == "length" and 0 < r["n_generated"] < 40
    assert r["tokens"] == port_ctx(model, n_ctx=24).generate(prompt(10),
                                                             max_new_tokens=r["n_generated"])
