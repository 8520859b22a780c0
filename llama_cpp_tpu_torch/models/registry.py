"""Architecture registry: per-arch config tweaks over the shared decoder.

Port of the JAX package's models/registry.py (analog of reference
src/llama-arch.h LLM_ARCH_* and the per-arch classes of src/models/*.cpp),
for the entries whose graph is the port's shared decoder: each entry takes
the config read from the metadata and the metadata itself, and sets that
family's flags; the recurrent and hybrid entries (mamba, mamba2, jamba,
qwen3next, qwen35, qwen35moe, lfm2, lfm2moe, nemotron_h, nemotron_h_moe,
falcon-h1, granitehybrid, plamo2, kimi-linear) also name their memory and
its geometry, and the RWKV entries (rwkv6, rwkv7, rwkv6qwen2, arwkv7: their
own forward, models/rwkv.py) the RecurrentState's; the encoders (bert,
modern-bert, nomic-bert, nomic-bert-moe, neo-bert, eurobert, jina-bert-v2,
jina-bert-v3: models/bert.py; t5encoder: models/t5.py) set the extras their
forward reads, and gemma-embedding and llama-embed run the shared decoder
for Context.embed. The MLA entries (deepseek2, mistral4, plm, minicpm3)
cache the absorbed latent. t5 runs models/t5.py's encoder and decoder
(Context's encoder-decoder flow); dream, llada, llada-moe and rnd1 are the
shared decoder run bidirectionally for runtime/diffusion.py; afmoe, laguna
(the softplus output gate, rope_dims_swa), openelm (per-layer head arrays)
and nanbeige (the physical stack looped) are the shared decoder. gemma3n
and gemma4 run models/gemma3n.py's forwards, gemma4-assistant is a draft
over a target context (Gemma4AssistantSpeculator), and minimax-m3 is the
shared decoder with MSA's block-sparse attention on a DSAMemory. Any other
architecture raises NotImplementedError naming itself: deepseek32, glm-dsa
and deepseek4 (sparse attention memories), the eagle3 and dflash drafts,
the vision-language entries (qwen2vl, qwen3vl, qwen3vlmoe, cogvlm,
hunyuan_vl, paddleocr, deepseek2-ocr) and qwen3tts.
"""

from __future__ import annotations

from typing import Any, Callable

from ..ops.rope import ROPE_TYPE_NEOX, ROPE_TYPE_NONE, ROPE_TYPE_NORM
from .config import ModelConfig

ArchTweak = Callable[[ModelConfig, dict[str, Any]], ModelConfig]

_REGISTRY: dict[str, ArchTweak] = {}


def register(name: str):
    def deco(fn: ArchTweak):
        _REGISTRY[name] = fn
        return fn

    return deco


def apply_arch(cfg: ModelConfig, md: dict[str, Any]) -> ModelConfig:
    fn = _REGISTRY.get(cfg.arch)
    if fn is None:
        raise NotImplementedError(
            f"architecture {cfg.arch!r} not implemented (have: {sorted(_REGISTRY)})")
    return fn(cfg, md)


def supported_archs() -> list[str]:
    return sorted(_REGISTRY)


@register("llama")
def _llama(cfg: ModelConfig, md) -> ModelConfig:
    # GGUF llama q/k weights are permuted for NORM-style rope
    # (reference src/models/llama.cpp:99-247); MoE (mixtral) gates by softmax
    # and normalizes the top-k router weights (build_moe_ffn norm_w=true,
    # src/models/llama.cpp:196)
    return cfg.with_(rope_type=ROPE_TYPE_NORM, expert_weights_norm=True)


@register("mistral")
def _mistral(cfg: ModelConfig, md) -> ModelConfig:
    return cfg.with_(rope_type=ROPE_TYPE_NORM)


@register("qwen2")
def _qwen2(cfg: ModelConfig, md) -> ModelConfig:
    # its q/k/v biases apply wherever the loader finds them
    return cfg.with_(rope_type=ROPE_TYPE_NEOX)


@register("qwen3")
def _qwen3(cfg: ModelConfig, md) -> ModelConfig:
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, qk_norm=True)


@register("qwen2moe")
def _qwen2moe(cfg: ModelConfig, md) -> ModelConfig:
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, expert_weights_norm=False)


@register("qwen3moe")
def _qwen3moe(cfg: ModelConfig, md) -> ModelConfig:
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, qk_norm=True, expert_weights_norm=True)


@register("gemma")
def _gemma(cfg: ModelConfig, md) -> ModelConfig:
    # the gemma families are tied: with no output.weight the head is token_embd
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, act="gelu",
                     embd_scale=float(cfg.n_embd) ** 0.5)


@register("gemma2")
def _gemma2(cfg: ModelConfig, md) -> ModelConfig:
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, act="gelu",
                     embd_scale=float(cfg.n_embd) ** 0.5, post_norms=True, swa_pattern=2,
                     attn_scale=float(md.get("gemma2.attention.scale", 0.0)))


@register("gemma3")
def _gemma3(cfg: ModelConfig, md) -> ModelConfig:
    # the global layers keep the metadata's (linear) rope scaling; the SWA
    # layers run at their own base and scale 1 (models/transformer.py
    # _rope_params)
    c = cfg.with_(rope_type=ROPE_TYPE_NEOX, act="gelu",
                  embd_scale=float(cfg.n_embd) ** 0.5, post_norms=True, qk_norm=True,
                  swa_pattern=int(md.get("gemma3.attention.sliding_window_pattern", 6)),
                  attn_scale=float(md.get("gemma3.attention.scale", 0.0))
                  or 1.0 / (float(cfg.head_dim_k) ** 0.5))
    c.extra["rope_freq_base_swa"] = float(md.get("gemma3.rope.freq_base_swa", 10000.0))
    return c


def _mla_absorb_extras(cfg: ModelConfig) -> None:
    """The absorbed-latent MLA cache (reference build_attn_mha's MLA path,
    src/llama-graph.cpp:2499-2618; the JAX package's registry.py:409-428):
    one KV head a token holding K = [c_kv | pad | k_pe] and V = c_kv instead
    of the expanded per-head K/V. The pad makes K a multiple of 128 wide
    and sits between c_kv and k_pe, so a context shift re-ropes K's tail.
    A config without these extras takes the naive expansion."""
    c = cfg.extra["kv_lora_rank"]
    rot = cfg.rope_dims
    pad = (-(c + rot)) % 128
    cfg.extra.update(mla_absorb=True, mla_pad=pad, cache_n_kv_heads=1,
                     cache_head_dim_k=c + pad + rot, cache_head_dim_v=c)


@register("deepseek2")
def _deepseek2(cfg: ModelConfig, md) -> ModelConfig:
    """DeepSeek-V2/V3 Multi-head Latent Attention (reference
    src/models/deepseek2.cpp): head dims from the *_mla keys, q from a q-LoRA
    (V3) or a plain attn_q (V2-Lite), the latent KV absorbed into one cached
    head; a leading dense FFN then MoE layers with shared experts, gated by
    softmax (V2) or by sigmoid with a selection bias (V3), with the weights
    optionally normalised and scaled. The metadata stores 0.1 * the YaRN
    mscale_all_dim as yarn_log_mul, which is divided back out."""
    a = "deepseek2."
    log_mul = md.get(a + "rope.scaling.yarn_log_mul")
    cfg.extra.update(
        kv_lora_rank=int(md.get(a + "attention.kv_lora_rank", 512)),
        q_lora_rank=int(md.get(a + "attention.q_lora_rank", 0) or 0),
        yarn_log_mul=float(log_mul) / 0.1 if log_mul else 0.0,
        leading_dense_block_count=int(md.get(a + "leading_dense_block_count", 0)),
    )
    c = cfg.with_(
        rope_type=ROPE_TYPE_NEOX,
        n_kv_heads=cfg.n_heads,  # the naive expansion's heads
        head_dim_k=int(md.get(a + "attention.key_length_mla", cfg.head_dim_k)),
        head_dim_v=int(md.get(a + "attention.value_length_mla", cfg.head_dim_v)),
        expert_gating="softmax" if int(md.get(a + "expert_gating_func", 1)) == 1 else "sigmoid",
        expert_weights_norm=bool(md.get(a + "expert_weights_norm", False)),
        expert_weights_scale=float(md.get(a + "expert_weights_scale", 1.0)),
    )
    _mla_absorb_extras(c)
    return c


# -- the dense-decoder families that differ only in block variants ---------
# (the JAX package's registry.py entries of the same names, its line given)


def _no_rope_from(md, key: str) -> tuple[int, ...] | None:
    """Layer ids whose flag in the per-layer array md[key] is 0 (NoPE)."""
    flags = md.get(key)
    if flags is None:
        return None
    return tuple(i for i, use in enumerate(flags) if not int(use))


@register("phi3")  # 351
def _phi3(cfg: ModelConfig, md) -> ModelConfig:
    return cfg.with_(rope_type=ROPE_TYPE_NEOX)


@register("stablelm")  # 356
def _stablelm(cfg: ModelConfig, md) -> ModelConfig:
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, use_rms_norm=False)


@register("starcoder2")  # 361
def _starcoder2(cfg: ModelConfig, md) -> ModelConfig:
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, use_rms_norm=False, act="gelu", glu=False)


@register("smollm3")  # 367
def _smollm3(cfg: ModelConfig, md) -> ModelConfig:
    """Every fourth layer runs without positional encoding (NoPE)."""
    skip = _no_rope_from(md, "smollm3.no_rope_layers")
    if skip is not None:
        cfg.extra["no_rope_layers"] = skip
    return cfg.with_(rope_type=ROPE_TYPE_NORM)


@register("granite")  # 377
def _granite(cfg: ModelConfig, md) -> ModelConfig:
    """muP scales: embedding, attention, residual (both halves) and logits."""
    a = cfg.arch
    return cfg.with_(
        rope_type=ROPE_TYPE_NORM,
        embd_scale=float(md.get(f"{a}.embedding_scale", 1.0)),
        attn_scale=float(md.get(f"{a}.attention.scale", 0.0)),
        residual_scale=float(md.get(f"{a}.residual_scale", 1.0)),
        logit_scale=float(md.get(f"{a}.logit_scale", 1.0)))


@register("olmo2")  # 389
def _olmo2(cfg: ModelConfig, md) -> ModelConfig:
    """Norm-after blocks and q/k RMSNorm over the whole projection."""
    cfg.extra["qk_norm_full"] = True
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, norm_after=True, qk_norm=True)


@register("glm4")  # 397
def _glm4(cfg: ModelConfig, md) -> ModelConfig:
    return cfg.with_(rope_type=ROPE_TYPE_NORM, post_norms=True)


@register("nemotron")  # 402
def _nemotron(cfg: ModelConfig, md) -> ModelConfig:
    # layernorm1p weights arrive +1-folded from the converter
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, use_rms_norm=False, act="relu2", glu=False)


@register("gpt2")  # 479
def _gpt2(cfg: ModelConfig, md) -> ModelConfig:
    return cfg.with_(rope_type=ROPE_TYPE_NONE, use_rms_norm=False, act="gelu", glu=False,
                     tie_embeddings=True)


@register("gptneox")  # 485
def _gptneox(cfg: ModelConfig, md) -> ModelConfig:
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, use_rms_norm=False, act="gelu", glu=False,
                     parallel_residual=bool(md.get("gptneox.use_parallel_residual", True)))


@register("phi2")  # 493
def _phi2(cfg: ModelConfig, md) -> ModelConfig:
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, use_rms_norm=False, act="gelu", glu=False,
                     parallel_residual=True, shared_parallel_norm=True)


@register("bloom")  # 501
def _bloom(cfg: ModelConfig, md) -> ModelConfig:
    return cfg.with_(rope_type=ROPE_TYPE_NONE, use_rms_norm=False, act="gelu", glu=False,
                     alibi_bias=8.0)


@register("mpt")  # 509
def _mpt(cfg: ModelConfig, md) -> ModelConfig:
    return cfg.with_(rope_type=ROPE_TYPE_NONE, use_rms_norm=False, act="gelu", glu=False,
                     alibi_bias=float(md.get("mpt.attention.max_alibi_bias", 8.0)))


@register("command-r")  # 517
def _command_r(cfg: ModelConfig, md) -> ModelConfig:
    return cfg.with_(rope_type=ROPE_TYPE_NORM, use_rms_norm=False, parallel_residual=True,
                     shared_parallel_norm=True,
                     logit_scale=float(md.get("command-r.logit_scale", 1.0)))


@register("olmoe")  # 526
def _olmoe(cfg: ModelConfig, md) -> ModelConfig:
    """Whole-projection q/k RMSNorm and top-k-normalised experts."""
    cfg.extra["qk_norm_full"] = True
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, qk_norm=True,
                     expert_weights_norm=bool(md.get("olmoe.expert_weights_norm", True)))


@register("falcon")  # 534
def _falcon(cfg: ModelConfig, md) -> ModelConfig:
    """The new decoder: parallel residual on two norms, a fused QKV."""
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, use_rms_norm=False, act="gelu", glu=False,
                     parallel_residual=True)


@register("internlm2")  # 718
def _internlm2(cfg: ModelConfig, md) -> ModelConfig:
    return cfg.with_(rope_type=ROPE_TYPE_NORM)


@register("orion")  # 724
def _orion(cfg: ModelConfig, md) -> ModelConfig:
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, use_rms_norm=False)


@register("xverse")  # 730
def _xverse(cfg: ModelConfig, md) -> ModelConfig:
    return cfg.with_(rope_type=ROPE_TYPE_NORM)


@register("baichuan")  # 736
def _baichuan(cfg: ModelConfig, md) -> ModelConfig:
    # the 7B graph; the reference's 13B ALiBi variant is not keyed (as in
    # the JAX package)
    return cfg.with_(rope_type=ROPE_TYPE_NORM)


@register("exaone")  # 743
def _exaone(cfg: ModelConfig, md) -> ModelConfig:
    return cfg.with_(rope_type=ROPE_TYPE_NEOX)


@register("minicpm")  # 759
def _minicpm(cfg: ModelConfig, md) -> ModelConfig:
    """muP defaults: embedding 12, residual 1.4 / sqrt(L), logits 256 / E."""
    a = cfg.arch
    return cfg.with_(
        rope_type=ROPE_TYPE_NORM,
        embd_scale=float(md.get(f"{a}.embedding_scale", 12.0)),
        residual_scale=float(md.get(f"{a}.residual_scale", 1.4 / (cfg.n_layers ** 0.5))),
        logit_scale=float(md.get(f"{a}.logit_scale", 256.0 / max(cfg.n_embd, 1))),
        tie_embeddings=True)


@register("jais")  # 775
def _jais(cfg: ModelConfig, md) -> ModelConfig:
    """LayerNorm blocks, ALiBi, a gated SwiGLU FFN with biases."""
    return cfg.with_(rope_type=ROPE_TYPE_NONE, use_rms_norm=False,
                     alibi_bias=float(md.get("jais.attention.max_alibi_bias", 8.0)),
                     tie_embeddings=True)


@register("arcee")  # 786
def _arcee(cfg: ModelConfig, md) -> ModelConfig:
    return cfg.with_(rope_type=ROPE_TYPE_NORM, act="relu2", glu=False)


@register("cohere2")  # 913
def _cohere2(cfg: ModelConfig, md) -> ModelConfig:
    """Command-R7B: command-r's parallel residual on ISWA, rope on the
    window layers only (the full layers are NoPE)."""
    c = cfg.with_(
        rope_type=ROPE_TYPE_NORM, use_rms_norm=False, parallel_residual=True,
        shared_parallel_norm=True, logit_scale=float(md.get("cohere2.logit_scale", 1.0)),
        sliding_window=int(md.get("cohere2.attention.sliding_window", 0)),
        swa_pattern=int(md.get("cohere2.attention.sliding_window_pattern", 4)),
        tie_embeddings=True)
    if c.sliding_window > 0:
        c.extra["no_rope_layers"] = tuple(il for il in range(c.n_layers)
                                          if not c.is_swa_layer(il))
    return c


@register("olmo")  # 932
def _olmo(cfg: ModelConfig, md) -> ModelConfig:
    """Non-parametric LayerNorm (no norm tensors) and optionally clamped q/k/v."""
    cfg.extra["weightless_norm"] = True
    clamp = md.get("olmo.attention.clamp_kqv")
    if clamp:
        cfg.extra["clamp_kqv"] = float(clamp)
    return cfg.with_(rope_type=ROPE_TYPE_NORM, use_rms_norm=False)


@register("exaone4")  # 943
def _exaone4(cfg: ModelConfig, md) -> ModelConfig:
    """Norm-after blocks, per-head q/k RMSNorm before rope, ISWA with rope
    on the window layers only."""
    c = cfg.with_(
        rope_type=ROPE_TYPE_NEOX, norm_after=True, qk_norm=True,
        sliding_window=int(md.get("exaone4.attention.sliding_window", 0)),
        swa_pattern=int(md.get("exaone4.attention.sliding_window_pattern", 4)))
    if c.sliding_window > 0:
        c.extra["no_rope_layers"] = tuple(il for il in range(c.n_layers)
                                          if not c.is_swa_layer(il))
    return c


@register("seed_oss")  # 960
def _seed_oss(cfg: ModelConfig, md) -> ModelConfig:
    return cfg.with_(rope_type=ROPE_TYPE_NEOX,
                     attn_scale=float(md.get("seed_oss.attention.scale", 0.0)))


@register("hunyuan-dense")  # 970
def _hunyuan_dense(cfg: ModelConfig, md) -> ModelConfig:
    """Per-head q/k RMSNorm after rope."""
    cfg.extra["qk_norm_after_rope"] = True
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, qk_norm=True)


@register("ernie4_5")  # 978
def _ernie4_5(cfg: ModelConfig, md) -> ModelConfig:
    return cfg.with_(rope_type=ROPE_TYPE_NORM)


@register("ernie4_5-moe")  # 984
def _ernie4_5_moe(cfg: ModelConfig, md) -> ModelConfig:
    """Softmax top-k with normalised weights; dense layers carry plain FFN
    tensors, shared experts the *_shexp ones."""
    return cfg.with_(rope_type=ROPE_TYPE_NORM, expert_weights_norm=True)


@register("dbrx")  # 992
def _dbrx(cfg: ModelConfig, md) -> ModelConfig:
    """LayerNorm, a fused clamped QKV, softmax MoE with normalised weights."""
    clamp = md.get("dbrx.attention.clamp_kqv")
    if clamp:
        cfg.extra["clamp_kqv"] = float(clamp)
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, use_rms_norm=False, expert_weights_norm=True)


@register("granitemoe")  # 1003
def _granitemoe(cfg: ModelConfig, md) -> ModelConfig:
    return _granite(cfg, md).with_(expert_weights_norm=True)


@register("qwen")  # 1102
def _qwen(cfg: ModelConfig, md) -> ModelConfig:
    """Qwen v1: a fused QKV with bias."""
    return cfg.with_(rope_type=ROPE_TYPE_NEOX)


@register("codeshell")  # 1118
def _codeshell(cfg: ModelConfig, md) -> ModelConfig:
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, use_rms_norm=False, act="gelu", glu=False)


@register("refact")  # 1126
def _refact(cfg: ModelConfig, md) -> ModelConfig:
    """ALiBi (max bias 8), no rope, SiLU-GLU, RMS norms."""
    return cfg.with_(rope_type=ROPE_TYPE_NONE, alibi_bias=8.0)


@register("plamo")  # 1133
def _plamo(cfg: ModelConfig, md) -> ModelConfig:
    """Parallel residual on the shared attn_norm."""
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, parallel_residual=True,
                     shared_parallel_norm=True)


@register("mistral3")  # 1231
def _mistral3(cfg: ModelConfig, md) -> ModelConfig:
    # the attention-temperature scaling is not applied, as in the JAX package
    return cfg.with_(rope_type=ROPE_TYPE_NORM)


@register("starcoder")  # 1706
def _starcoder(cfg: ModelConfig, md) -> ModelConfig:
    """gpt-bigcode: learned positions, LayerNorm blocks, a fused biased QKV
    (MQA), a GELU FFN with biases; the head falls back to token_embd."""
    return cfg.with_(rope_type=ROPE_TYPE_NONE, use_rms_norm=False, act="gelu", glu=False,
                     tie_embeddings=True)


# -- the mixture-of-experts families on the shared decoder -------------------
# (the JAX package's registry.py entries of the same names, its line given)


def _gating(md, key: str, default: int) -> str:
    """The metadata's expert_gating_func (1 softmax, 2 sigmoid); a missing
    or unknown value takes the default's."""
    names = {1: "softmax", 2: "sigmoid"}
    return names.get(int(md.get(key, default) or default), names[default])


def _swa_base(cfg: ModelConfig, md, a: str) -> None:
    """The window layers' rope base, where the file sets one."""
    swa_base = md.get(f"{a}.rope.freq_base_swa")
    if swa_base:
        cfg.extra["rope_freq_base_swa"] = float(swa_base)


def _swa_pattern_extra(cfg: ModelConfig, md, a: str, scalar_is_array: bool = False
                       ) -> ModelConfig:
    """The window pattern as a scalar period or a per-layer array
    (is_swa_layers), and the window layers' rope base (the JAX package's
    registry.py:1444). With scalar_is_array (mimo2, step35) a scalar key
    broadcasts to every layer: any nonzero scalar makes every layer a window
    layer."""
    pat = md.get(f"{a}.attention.sliding_window_pattern", 4)
    if hasattr(pat, "__len__"):  # a per-layer array
        cfg.extra["is_swa_layers"] = tuple(bool(int(v)) for v in pat)
        pat_i = 0
    elif scalar_is_array:
        cfg.extra["is_swa_layers"] = tuple([bool(int(pat))] * cfg.n_layers)
        pat_i = 0
    else:
        pat_i = int(pat)
    _swa_base(cfg, md, a)
    return cfg.with_(sliding_window=int(md.get(f"{a}.attention.sliding_window", 0)),
                     swa_pattern=pat_i)


@register("llama4")  # 53
def _llama4(cfg: ModelConfig, md) -> ModelConfig:
    """Llama 4: sigmoid routing whose gate weight scales the expert input, an
    always-on shared expert, NoPE layers, and the weightless q/k norm after
    rope on the rope layers."""
    skip = _no_rope_from(md, "llama4.no_rope_layers")
    if skip is not None:
        cfg.extra["no_rope_layers"] = skip
    cfg.extra.update(moe_weight_before=True, qk_norm_after_rope=True)
    return cfg.with_(rope_type=ROPE_TYPE_NORM, qk_norm=bool(md.get("llama4.use_qk_norm", False)),
                     expert_gating="sigmoid", n_expert_shared=1,
                     moe_every=int(md.get("llama4.interleave_moe_layer_step", 1)))


@register("deepseek")  # 749
def _deepseek(cfg: ModelConfig, md) -> ModelConfig:
    """DeepSeek V1: softmax routing, scaled weights, shared experts, dense
    lead layers."""
    return cfg.with_(rope_type=ROPE_TYPE_NORM,
                     expert_weights_scale=float(md.get("deepseek.expert_weights_scale", 1.0)))


@register("dots1")  # 1010
def _dots1(cfg: ModelConfig, md) -> ModelConfig:
    """dots.llm1: DeepSeek-V3-style routing (sigmoid, selection bias,
    normalised weights) with per-head q/k norms."""
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, qk_norm=True,
                     expert_gating="sigmoid"
                     if int(md.get("dots1.expert_gating_func", 2)) == 2 else "softmax",
                     expert_weights_norm=bool(md.get("dots1.expert_weights_norm", True)),
                     expert_weights_scale=float(md.get("dots1.expert_weights_scale", 1.0)))


@register("glm4moe")  # 1024
def _glm4moe(cfg: ModelConfig, md) -> ModelConfig:
    """GLM-4.5: partial NEOX rope, optional q/k norms, sigmoid routing with a
    selection bias, a shared expert and dense lead layers."""
    return cfg.with_(rope_type=ROPE_TYPE_NEOX,
                     qk_norm=bool(md.get("glm4moe.attention.use_qk_norm", False)),
                     expert_gating="sigmoid",
                     expert_weights_norm=bool(md.get("glm4moe.expert_weights_norm", True)),
                     expert_weights_scale=float(md.get("glm4moe.expert_weights_scale", 1.0)))


@register("phimoe")  # 1038
def _phimoe(cfg: ModelConfig, md) -> ModelConfig:
    """PhiMoE: LayerNorm blocks with biases and the sparsemixer router."""
    cfg.extra["router_jitter"] = float(md.get("phimoe.router_jitter", 0.01))
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, use_rms_norm=False, expert_gating="sparsemixer")


@register("gpt-oss")  # 1074
def _gpt_oss(cfg: ModelConfig, md) -> ModelConfig:
    """gpt-oss: window and full layers in turn, attention sinks, q/k/v and
    output biases, a biased router taking the top k of its logits then a
    softmax over them, the clamped oai GLU on biased experts; the file stores
    the pre-FFN norm as attn_post_norm."""
    c = cfg.with_(rope_type=ROPE_TYPE_NEOX,
                  swa_pattern=int(md.get("gpt-oss.attention.sliding_window_pattern", 2)),
                  expert_gating="softmax_weight", moe_act="swiglu_oai",
                  expert_weights_norm=False)
    _swa_base(c, md, "gpt-oss")
    c.extra["tensor_remap"] = {"attn_post_norm": "ffn_norm"}
    return c


@register("chatglm")  # 1109
def _chatglm(cfg: ModelConfig, md) -> ModelConfig:
    """ChatGLM: a fused QKV with bias; its one ffn_up holds gate|up."""
    cfg.extra["tensor_remap"] = {"ffn_up": "ffn_gateup"}
    return cfg.with_(rope_type=ROPE_TYPE_NORM)


@register("grok")  # 1141
def _grok(cfg: ModelConfig, md) -> ModelConfig:
    """Grok-1: GELU experts (plus a dense FFN, the sum scaled by sqrt(2)/2),
    attention logits scaled inside a 30.0 tanh softcap, embedding and logit
    scales, post-norms on both halves."""
    a = cfg.arch
    cfg.extra["dense_moe_scale"] = 0.7071067811865476
    return cfg.with_(
        rope_type=ROPE_TYPE_NEOX, act="gelu", expert_weights_norm=True,
        embd_scale=float(md.get(f"{a}.embedding_scale", 78.38367176906169)),
        logit_scale=float(md.get(f"{a}.logit_scale", 0.5773502691896257)),
        attn_scale=float(md.get(f"{a}.attention.output_scale", 0.08838834764831845)),
        attn_logit_softcap=float(md.get(f"{a}.attn_logit_softcapping", 30.0)),
        final_logit_softcap=float(md.get(f"{a}.final_logit_softcapping", 0.0)),
        post_norms=True)


@register("arctic")  # 1163
def _arctic(cfg: ModelConfig, md) -> ModelConfig:
    """Snowflake Arctic: a dense FFN plus an MoE branch on its own norm of
    the layer input (ffn_norm_exps)."""
    return cfg.with_(rope_type=ROPE_TYPE_NORM, expert_weights_norm=True)


@register("bailingmoe")  # 1204
def _bailingmoe(cfg: ModelConfig, md) -> ModelConfig:
    """Ling: softmax routing, shared experts, dense lead layers."""
    a = cfg.arch
    return cfg.with_(rope_type=ROPE_TYPE_NORM,
                     expert_weights_norm=bool(md.get(f"{a}.expert_weights_norm", False)),
                     expert_weights_scale=float(md.get(f"{a}.expert_weights_scale", 1.0)),
                     n_expert_shared=int(md.get(f"{a}.expert_shared_count", 0)))


@register("smallthinker")  # 1218
def _smallthinker(cfg: ModelConfig, md) -> ModelConfig:
    """SmallThinker: ReLU experts, the router fed the raw residual stream."""
    cfg.extra["router_raw_input"] = True
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, act="relu", expert_weights_norm=True,
                     expert_gating=_gating(md, f"{cfg.arch}.expert_gating_func", 1))


@register("mellum")  # 1253
def _mellum(cfg: ModelConfig, md) -> ModelConfig:
    """Mellum: per-head q/k norms, normalised MoE, an optional window
    pattern with its own rope base."""
    a = cfg.arch
    c = cfg.with_(rope_type=ROPE_TYPE_NEOX, qk_norm=True, expert_weights_norm=True,
                  sliding_window=int(md.get(f"{a}.attention.sliding_window", 0)),
                  swa_pattern=int(md.get(f"{a}.attention.sliding_window_pattern", 4)))
    _swa_base(c, md, a)
    return c


@register("minimax-m2")  # 1277
def _minimax_m2(cfg: ModelConfig, md) -> ModelConfig:
    """MiniMax-M2: q/k RMSNorm over the whole projection, routing with a
    selection bias."""
    a = cfg.arch
    cfg.extra["qk_norm_full"] = True
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, qk_norm=True,
                     expert_gating=_gating(md, f"{a}.expert_gating_func", 2),
                     expert_weights_norm=bool(md.get(f"{a}.expert_weights_norm", True)),
                     expert_weights_scale=float(md.get(f"{a}.expert_weights_scale", 1.0)))


@register("hunyuan-moe")  # 1294
def _hunyuan_moe(cfg: ModelConfig, md) -> ModelConfig:
    """HunYuan-MoE: per-head q/k norms after rope, normalised MoE and a
    shared expert."""
    cfg.extra["qk_norm_after_rope"] = True
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, qk_norm=True, expert_weights_norm=True,
                     n_expert_shared=max(1, int(md.get(f"{cfg.arch}.expert_shared_count", 1))))


@register("exaone-moe")  # 1308
def _exaone_moe(cfg: ModelConfig, md) -> ModelConfig:
    """EXAONE-MoE: per-head q/k norms, ISWA (window 128, period 4) with rope
    on the window layers only, MoE with a shared expert."""
    a = cfg.arch
    c = cfg.with_(
        rope_type=ROPE_TYPE_NEOX, qk_norm=True,
        sliding_window=int(md.get(f"{a}.attention.sliding_window", 128)),
        swa_pattern=int(md.get(f"{a}.attention.sliding_window_pattern", 4)),
        n_expert_shared=int(md.get(f"{a}.expert_shared_count", 0)),
        expert_gating=_gating(md, f"{a}.expert_gating_func", 1),
        expert_weights_norm=bool(md.get(f"{a}.expert_weights_norm", False)),
        expert_weights_scale=float(md.get(f"{a}.expert_weights_scale", 1.0)))
    c.extra["no_rope_layers"] = tuple(il for il in range(c.n_layers) if not c.is_swa_layer(il))
    _swa_base(c, md, a)
    return c


@register("cohere2moe")  # 1335
def _cohere2moe(cfg: ModelConfig, md) -> ModelConfig:
    """Command-A MoE: cohere2's parallel residual on ISWA with rope on the
    window layers only, the first layer of each period global, RMSNorm where
    the metadata has its epsilon (else LayerNorm), MoE and shared experts."""
    a = cfg.arch
    cfg.extra["swa_first_global"] = True
    c = cfg.with_(
        rope_type=ROPE_TYPE_NORM, use_rms_norm=f"{a}.attention.layer_norm_rms_epsilon" in md,
        parallel_residual=True, shared_parallel_norm=True,
        logit_scale=float(md.get(f"{a}.logit_scale", 1.0)),
        sliding_window=int(md.get(f"{a}.attention.sliding_window", 0)),
        swa_pattern=int(md.get(f"{a}.attention.sliding_window_pattern", 4)),
        expert_gating=_gating(md, f"{a}.expert_gating_func", 2),
        expert_weights_norm=bool(md.get(f"{a}.expert_weights_norm", False)),
        expert_weights_scale=float(md.get(f"{a}.expert_weights_scale", 1.0)),
        n_expert_shared=int(md.get(f"{a}.expert_shared_count", 0)),
        tie_embeddings=True)
    if c.sliding_window > 0:
        c.extra["no_rope_layers"] = tuple(il for il in range(c.n_layers)
                                          if not c.is_swa_layer(il))
    return c


@register("bailingmoe2")  # 1470
def _bailingmoe2(cfg: ModelConfig, md) -> ModelConfig:
    """Ling/Ring 2.0: per-head q/k norms, dense lead layers, MoE with a
    selection bias and a shared expert."""
    a = cfg.arch
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, qk_norm=True,
                     expert_gating=_gating(md, f"{a}.expert_gating_func", 1),
                     expert_weights_norm=bool(md.get(f"{a}.expert_weights_norm", False)),
                     expert_weights_scale=float(md.get(f"{a}.expert_weights_scale", 1.0)),
                     n_expert_shared=int(md.get(f"{a}.expert_shared_count", 0)))


@register("step35")  # 1488
def _step35(cfg: ModelConfig, md) -> ModelConfig:
    """Step-3.5: sigmoid-routed MoE with a shared expert, the window pattern
    per layer with its own rope base."""
    a = cfg.arch
    c = cfg.with_(rope_type=ROPE_TYPE_NEOX,
                  expert_gating=_gating(md, f"{a}.expert_gating_func", 2),
                  expert_weights_norm=bool(md.get(f"{a}.expert_weights_norm", False)),
                  expert_weights_scale=float(md.get(f"{a}.expert_weights_scale", 1.0)),
                  n_expert_shared=int(md.get(f"{a}.expert_shared_count", 0)))
    return _swa_pattern_extra(c, md, a, scalar_is_array=True)


@register("mimo2")  # 1506
def _mimo2(cfg: ModelConfig, md) -> ModelConfig:
    """MiMo-2: sigmoid-routed normalised MoE, the window pattern per layer,
    attention sinks."""
    c = cfg.with_(rope_type=ROPE_TYPE_NEOX, qk_norm=True, expert_gating="sigmoid",
                  expert_weights_norm=True)
    return _swa_pattern_extra(c, md, cfg.arch, scalar_is_array=True)


@register("grovemoe")  # 1519
def _grovemoe(cfg: ModelConfig, md) -> ModelConfig:
    """GroveMoE: softmax MoE plus per-group chunk experts on the mix's
    output, scaled by expert_group_scale; per-head q/k norms."""
    a = cfg.arch
    cfg.extra.update(n_group_experts=int(md.get(f"{a}.experts_per_group", 1)),
                     expert_group_scale=float(md.get(f"{a}.expert_group_scale", 0.05)))
    n_exp = int(md.get(f"{a}.expert_count", 0) or 0)
    if n_exp:
        cfg.extra["n_chunk_expert"] = max(1, n_exp // max(1, cfg.extra["n_group_experts"]))
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, qk_norm=True)


@register("plamo3")  # 1619
def _plamo3(cfg: ModelConfig, md) -> ModelConfig:
    """PLaMo-3: a fused QKV, per-head q/k norms, post-norms on both halves,
    one ffn_up holding gate|up, an optional window with its own rope base."""
    cfg.extra["tensor_remap"] = {"ffn_up": "ffn_gateup"}
    c = cfg.with_(rope_type=ROPE_TYPE_NEOX, qk_norm=True, post_norms=True)
    return _swa_pattern_extra(c, md, cfg.arch)


# -- the recurrent and hybrid families ----------------------------------------
# (the JAX package's registry.py entries of the same names, its line given):
# extra["memory"] is "recurrent" (the RecurrentState alone, the mamba
# forward) or "hybrid" (a HybridMemory: the recurrent state beside a KV
# memory on the page pool); the ssm_* extras size the state and the mixers


def _ssm2_extras(cfg: ModelConfig, md, a: str, memory: str, d_inner_default: int,
                 dt_rank_default: int, conv_dim: str = "x") -> None:
    """The Mamba-2 / DeltaNet geometry of the metadata: conv window, inner
    width, state size, heads (time_step_rank), groups, and the conv's
    channels: x|B|C for Mamba-2, q|k|v for the DeltaNet ("qkv")."""
    d_inner = int(md.get(f"{a}.ssm.inner_size", d_inner_default))
    d_state = int(md.get(f"{a}.ssm.state_size", 128))
    n_group = int(md.get(f"{a}.ssm.group_count", 1))
    cfg.extra.update(
        memory=memory, ssm_version=2,
        ssm_d_conv=int(md.get(f"{a}.ssm.conv_kernel", 4)),
        ssm_d_inner=d_inner, ssm_d_state=d_state,
        ssm_dt_rank=int(md.get(f"{a}.ssm.time_step_rank", dt_rank_default)),
        ssm_n_group=n_group,
        ssm_conv_dim=(d_inner + 2 * n_group * d_state if conv_dim == "x"
                      else 2 * n_group * d_state + d_inner))


def _ssm1_extras(cfg: ModelConfig, md, a: str, memory: str) -> None:
    cfg.extra.update(
        memory=memory,
        ssm_d_conv=int(md.get(f"{a}.ssm.conv_kernel", 4)),
        ssm_d_inner=int(md.get(f"{a}.ssm.inner_size", 2 * cfg.n_embd)),
        ssm_d_state=int(md.get(f"{a}.ssm.state_size", 16)),
        ssm_dt_rank=int(md.get(f"{a}.ssm.time_step_rank", -(cfg.n_embd // -16))))


@register("mamba")  # 542
def _mamba(cfg: ModelConfig, md) -> ModelConfig:
    """Mamba-1 / FalconMamba: a pure SSM stack on the recurrent state."""
    _ssm1_extras(cfg, md, cfg.arch, "recurrent")
    cfg.extra["ssm_dt_b_c_rms"] = bool(md.get(f"{cfg.arch}.ssm.dt_b_c_rms", False))
    return cfg


@register("mamba2")  # 558
def _mamba2(cfg: ModelConfig, md) -> ModelConfig:
    """Mamba-2: the fused zxBCdt projection, a scalar decay a head, grouped
    B/C, the gated grouped RMSNorm."""
    d_inner = int(md.get(f"{cfg.arch}.ssm.inner_size", 2 * cfg.n_embd))
    _ssm2_extras(cfg, md, cfg.arch, "recurrent", 2 * cfg.n_embd, d_inner // 64)
    return cfg


@register("jamba")  # 653
def _jamba(cfg: ModelConfig, md) -> ModelConfig:
    """Jamba: Mamba-1 and attention layers (no rope) in turn, MoE FFNs."""
    _ssm1_extras(cfg, md, cfg.arch, "hybrid")
    return cfg.with_(rope_type=ROPE_TYPE_NONE, expert_weights_norm=False)


@register("qwen3next")  # 668
def _qwen3next(cfg: ModelConfig, md) -> ModelConfig:
    """Qwen3-Next: gated DeltaNet layers and gated full-attention layers
    (partial rope), the qwen3moe MoE with a sigmoid-gated shared expert."""
    _ssm2_extras(cfg, md, cfg.arch, "hybrid", 0, 1, conv_dim="qkv")
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, qk_norm=True, expert_weights_norm=True,
                     n_expert_shared=1)


@register("lfm2")  # 690
def _lfm2(cfg: ModelConfig, md) -> ModelConfig:
    """LFM2: short-conv mixer layers and full-attention layers (per-head q/k
    norms); the final norm is stored under the token_embd_norm name."""
    L = int(md.get(f"{cfg.arch}.shortconv.l_cache", 3))
    cfg.extra.update(memory="hybrid", shortconv_l=L, ssm_d_conv=L, ssm_d_inner=cfg.n_embd,
                     ssm_d_state=1, ssm_conv_dim=cfg.n_embd,
                     tensor_remap={"token_embd_norm": "output_norm"})
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, qk_norm=True, tie_embeddings=True)


@register("lfm2moe")  # 707
def _lfm2moe(cfg: ModelConfig, md) -> ModelConfig:
    c = _lfm2(cfg, md)
    return c.with_(
        expert_gating="sigmoid" if int(md.get("lfm2moe.expert_gating_func", 2)) == 2
        else "softmax",
        expert_weights_norm=bool(md.get("lfm2moe.expert_weights_norm", True)),
        expert_weights_scale=float(md.get("lfm2moe.expert_weights_scale", 1.0)))


@register("nemotron_h")  # 844
def _nemotron_h(cfg: ModelConfig, md) -> ModelConfig:
    """Nemotron-H: each layer is one block, Mamba-2, NoPE attention or a
    relu^2 FFN, on a shared norm."""
    a = cfg.arch
    d_inner = int(md.get(f"{a}.ssm.inner_size", 2 * cfg.n_embd))
    _ssm2_extras(cfg, md, a, "hybrid", 2 * cfg.n_embd, d_inner // 64)
    return cfg.with_(rope_type=ROPE_TYPE_NONE, act="relu2", glu=False,
                     attn_scale=float(md.get(f"{a}.attention.scale", 0.0)))


@register("nemotron_h_moe")  # 1809
def _nemotron_h_moe(cfg: ModelConfig, md) -> ModelConfig:
    """Nemotron-H-MoE: the nemotron_h graph, its FFN blocks on experts where
    the file has them."""
    md2 = {k.replace("nemotron_h_moe.", "nemotron_h."): v for k, v in md.items()}
    return _nemotron_h(cfg.with_(arch="nemotron_h"), md2).with_(arch=cfg.arch)


@register("falcon-h1")  # 864
def _falcon_h1(cfg: ModelConfig, md) -> ModelConfig:
    """Falcon-H1: every layer runs attention and a Mamba-2 SSM in parallel on
    the same normed input and sums them."""
    a = cfg.arch
    d_inner = int(md.get(f"{a}.ssm.inner_size", 2 * cfg.n_embd))
    _ssm2_extras(cfg, md, a, "hybrid", 2 * cfg.n_embd, d_inner // 64)
    cfg.extra["dual_mixer"] = True
    return cfg.with_(rope_type=ROPE_TYPE_NEOX)


@register("granitehybrid")  # 884
def _granitehybrid(cfg: ModelConfig, md) -> ModelConfig:
    """Granite-4.0-H: Mamba-2 or attention a layer (NoPE unless
    rope.finetuned), Granite's multipliers, MoE with a shared FFN."""
    a = cfg.arch
    d_inner = int(md.get(f"{a}.ssm.inner_size", 2 * cfg.n_embd))
    _ssm2_extras(cfg, md, a, "hybrid", 2 * cfg.n_embd, d_inner // 64)
    if not bool(md.get(f"{a}.rope.finetuned", False)):
        cfg.extra["no_rope_layers"] = tuple(range(cfg.n_layers))
    return cfg.with_(
        rope_type=ROPE_TYPE_NORM,
        embd_scale=float(md.get(f"{a}.embedding_scale", 1.0)),
        attn_scale=float(md.get(f"{a}.attention.scale", 0.0)),
        residual_scale=float(md.get(f"{a}.residual_scale", 1.0)),
        logit_scale=float(md.get(f"{a}.logit_scale", 1.0)),
        expert_weights_norm=True)


@register("plamo2")  # 1597
def _plamo2(cfg: ModelConfig, md) -> ModelConfig:
    """PLaMo-2: its own Mamba mixer (plamo2_layer) and attention layers in
    turn (a fused qkv, q/k norms with a weight a head), post-norms on both
    halves, one ffn_up holding gate|up."""
    a = cfg.arch
    d_inner = int(md.get(f"{a}.ssm.inner_size", 2 * cfg.n_embd))
    cfg.extra.update(
        memory="hybrid", plamo2=True,
        ssm_d_conv=int(md.get(f"{a}.ssm.conv_kernel", 4)),
        ssm_d_inner=d_inner,
        ssm_d_state=int(md.get(f"{a}.ssm.state_size", 64)),
        ssm_dt_rank=int(md.get(f"{a}.ssm.time_step_rank", d_inner // 64)),
        ssm_n_group=0, ssm_conv_dim=d_inner,
        tensor_remap={"ffn_up": "ffn_gateup"})
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, qk_norm=True, post_norms=True)


@register("kimi-linear")  # 1997
def _kimi_linear(cfg: ModelConfig, md) -> ModelConfig:
    """Kimi-Linear: KDA layers (kda_layer) and rope-free MLA layers on the
    naive expansion of the latent, sigmoid-routed MoE with shared experts
    after leading dense layers."""
    a = cfg.arch
    kda_dh = int(md.get(f"{a}.kda.head_dim", 128))
    d_inner = cfg.n_heads * kda_dh
    cfg.extra.update(
        kv_lora_rank=int(md.get(f"{a}.attention.kv_lora_rank", 512)),
        q_lora_rank=int(md.get(f"{a}.attention.q_lora_rank", 0) or 0),
        memory="hybrid", kda_head_dim=kda_dh,
        ssm_d_conv=int(md.get(f"{a}.ssm.conv_kernel", 4)),
        ssm_d_state=kda_dh, ssm_d_inner=d_inner,
        ssm_conv_dim=3 * d_inner)  # the q, k and v windows side by side
    return cfg.with_(
        rope_type=ROPE_TYPE_NONE,
        n_kv_heads=cfg.n_heads,  # the naive expansion's heads
        head_dim_k=int(md.get(f"{a}.attention.key_length_mla", cfg.head_dim_k)),
        head_dim_v=int(md.get(f"{a}.attention.value_length_mla", cfg.head_dim_v)),
        expert_gating=_gating(md, f"{a}.expert_gating_func", 2),
        expert_weights_norm=bool(md.get(f"{a}.expert_weights_norm", True)),
        expert_weights_scale=float(md.get(f"{a}.expert_weights_scale", 1.0)),
        n_expert_shared=int(md.get(f"{a}.expert_shared_count", 1) or 1))


def _qwen35_common(cfg: ModelConfig, md, a: str) -> ModelConfig:  # 1907
    """Qwen3.5: the qwen3next hybrid with separate beta/alpha projections, a
    flat q|k|v and a z gate in the DeltaNet, per-head [q | gate] pairs in
    wq and interleaved M-RoPE (a text row's position on every stream)."""
    _ssm2_extras(cfg, md, a, "hybrid", 0, 1, conv_dim="qkv")
    sec = md.get(f"{a}.rope.dimension_sections", [24, 20, 20, 0])
    if hasattr(sec, "tolist"):
        sec = sec.tolist()
    cfg.extra.update(mrope_sections=tuple(int(x) for x in sec), imrope=True,
                     q_gate_interleaved=True)
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, qk_norm=True)


@register("qwen35")  # 1929
def _qwen35(cfg: ModelConfig, md) -> ModelConfig:
    return _qwen35_common(cfg, md, cfg.arch)


@register("qwen35moe")  # 1938
def _qwen35moe(cfg: ModelConfig, md) -> ModelConfig:
    return _qwen35_common(cfg, md, cfg.arch).with_(expert_weights_norm=True, n_expert_shared=1)


# -- the encoders and the embedding entries (the JAX package's
# registry.py:579-615, 1064-1075, 1246-1250, 1417-1445, 1536-1575,
# 1862-1875): models/bert.py's forward for the BERT family, models/t5.py's
# encoder for t5encoder, the shared decoder for gemma-embedding and
# llama-embed; their pooling is Context.embed's

@register("bert")  # 579
def _bert(cfg: ModelConfig, md) -> ModelConfig:
    """Post-norm bidirectional blocks, learned positions, token types
    (reference src/models/bert.cpp)."""
    cfg.extra["encoder"] = True
    return cfg.with_(rope_type=ROPE_TYPE_NONE, use_rms_norm=False, act="gelu", glu=False)


@register("modern-bert")  # 587
def _modern_bert(cfg: ModelConfig, md) -> ModelConfig:
    """Pre-norm encoder, fused qkv, fused gate|up FFN, symmetric local
    windows with a global layer every Nth (il % N == 0) and a local rope
    base (reference src/models/modern-bert.cpp)."""
    a = cfg.arch
    cfg.extra.update(encoder=True, pre_norm_encoder=True, swa_first_global=True)
    swa_base = md.get(f"{a}.rope.freq_base_swa")
    if swa_base:
        cfg.extra["rope_freq_base_swa"] = float(swa_base)
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, use_rms_norm=False,
                     sliding_window=int(md.get(f"{a}.attention.sliding_window", 0)),
                     swa_pattern=int(md.get(f"{a}.attention.sliding_window_pattern", 3)))


@register("nomic-bert")  # 605
def _nomic_bert(cfg: ModelConfig, md) -> ModelConfig:
    """NEOX rope and a gated SiLU FFN (bert.cpp:138, 209-213)."""
    cfg.extra["encoder"] = True
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, use_rms_norm=False, act="silu", glu=True)


@register("t5encoder")  # 1064
def _t5encoder(cfg: ModelConfig, md) -> ModelConfig:
    """T5's encoder alone (reference src/models/t5.cpp, encoder graph):
    relative position buckets, attention scale 1."""
    cfg.extra.update(
        t5=True, t5_encoder_only=True,
        rel_buckets=int(md.get("t5encoder.attention.relative_buckets_count", 32)),
        enc_n_layers=cfg.n_layers)
    return cfg.with_(rope_type=ROPE_TYPE_NONE)


@register("llama-embed")  # 1246
def _llama_embed(cfg: ModelConfig, md) -> ModelConfig:
    """The llama graph instantiated for embeddings (reference
    src/models/llama-embed.cpp)."""
    return cfg.with_(rope_type=ROPE_TYPE_NORM)


@register("neo-bert")  # 1417
def _neo_bert(cfg: ModelConfig, md) -> ModelConfig:
    """Pre-norm RMS encoder, NORM rope, fused gate|up SwiGLU FFN,
    enc.output_norm (reference src/models/neo-bert.cpp)."""
    cfg.extra.update(encoder=True, pre_norm_encoder=True)
    return cfg.with_(rope_type=ROPE_TYPE_NORM, act="silu")


@register("eurobert")  # 1426
def _eurobert(cfg: ModelConfig, md) -> ModelConfig:
    """Pre-norm RMS encoder with a gated SiLU FFN and NEOX rope (reference
    src/models/eurobert.cpp)."""
    cfg.extra.update(encoder=True, pre_norm_encoder=True)
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, act="silu")


@register("nomic-bert-moe")  # 1434
def _nomic_bert_moe(cfg: ModelConfig, md) -> ModelConfig:
    """nomic-embed-text-v2 (reference src/models/nomic-bert-moe.cpp): the
    nomic encoder with gate-less GELU experts on the layers that carry
    them, softmax top-k with raw weights."""
    cfg.extra["encoder"] = True
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, use_rms_norm=False, act="gelu", glu=False)


@register("gemma-embedding")  # 1536
def _gemma_embedding(cfg: ModelConfig, md) -> ModelConfig:
    """EmbeddingGemma (reference src/models/gemma-embedding.cpp): the gemma3
    stack run bidirectionally with symmetric sliding windows."""
    a = cfg.arch
    cfg.extra.update(non_causal=True)
    c = cfg.with_(rope_type=ROPE_TYPE_NEOX, act="gelu", embd_scale=float(cfg.n_embd) ** 0.5,
                  post_norms=True, qk_norm=True, tie_embeddings=True,
                  sliding_window=int(md.get(f"{a}.attention.sliding_window", 0)),
                  swa_pattern=int(md.get(f"{a}.attention.sliding_window_pattern", 6)),
                  attn_scale=1.0 / (float(cfg.head_dim_k) ** 0.5))
    swa_base = md.get(f"{a}.rope.freq_base_swa")
    if swa_base:
        c.extra["rope_freq_base_swa"] = float(swa_base)
    return c


@register("jina-bert-v3")  # 1560
def _jina_bert_v3(cfg: ModelConfig, md) -> ModelConfig:
    """jina-embeddings-v3 (reference src/models/jina-bert-v3.cpp): post-norm
    encoder with NEOX rope and a GLU FFN; its attn_out_norm is the
    encoder's attn_output_norm."""
    cfg.extra["encoder"] = True
    cfg.extra["tensor_remap"] = {"attn_post_norm": "attn_output_norm",
                                 "ffn_post_norm": "layer_output_norm"}
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, use_rms_norm=False, act="gelu")


@register("jina-bert-v2")  # 1862
def _jina_bert_v2(cfg: ModelConfig, md) -> ModelConfig:
    """jina-embeddings v2 (reference src/models/jina-bert-v2.cpp): symmetric
    ALiBi at max bias 8, optional full-width q/k LayerNorm, a GEGLU FFN."""
    cfg.extra["encoder"] = True
    return cfg.with_(rope_type=ROPE_TYPE_NONE, use_rms_norm=False, act="gelu", glu=False,
                     alibi_bias=8.0)


# -- RWKV: its own forward (models/rwkv.py) over the RecurrentState ------------
# The token-shift rows live in the conv window (2 rows of n_embd: slot 0 the
# time mix's, slot 1 the channel mix's) and the wkv state in the ssm plane
# [head_size, n_embd], a layer and a sequence.


def _rwkv_extras(cfg: ModelConfig, md, hybrid: bool = False) -> None:
    hs = int(md.get(f"{cfg.arch}.wkv.head_size", 64))
    cfg.extra.update(memory="recurrent", rwkv=True, wkv_head_size=hs,
                     ssm_d_conv=3, ssm_d_inner=cfg.n_embd, ssm_d_state=hs)
    if hybrid:
        cfg.extra["rwkv_hybrid"] = True


@register("rwkv6")  # 615
def _rwkv6(cfg: ModelConfig, md) -> ModelConfig:
    """RWKV-6 (reference src/models/rwkv6.cpp): LayerNorms, time mix with
    the u bonus and the group-norm tail, channel mix with its receptance
    gate, the residual halved every rescale_every layers."""
    _rwkv_extras(cfg, md)
    cfg.extra["rescale_every"] = int(md.get(f"{cfg.arch}.rescale_every_n_layers", 0))
    return cfg.with_(use_rms_norm=False)


@register("rwkv7")  # 634
def _rwkv7(cfg: ModelConfig, md) -> ModelConfig:
    """RWKV-7 Goose (reference src/models/rwkv7.cpp): the rank-1-update wkv
    state, the value residual from layer 0, LoRA-projected decay, in-context
    learning rate and gate; channel mix without the receptance gate."""
    _rwkv_extras(cfg, md)
    return cfg.with_(use_rms_norm=False)


@register("rwkv6qwen2")  # 1773
def _rwkv6qwen2(cfg: ModelConfig, md) -> ModelConfig:
    """RWKV6-Qwen2 / QRWKV (reference src/models/rwkv6qwen2.cpp): the RWKV-6
    time mix without the u bonus (gated linear attention, sigmoid gate,
    GQA-repeated k/v, k * (1 - w)), Qwen2's SiLU-GLU FFN and RMS norms, one
    token-shift stream."""
    _rwkv_extras(cfg, md, hybrid=True)
    return cfg


@register("arwkv7")  # 1789
def _arwkv7(cfg: ModelConfig, md) -> ModelConfig:
    """ARWKV-7 (reference src/models/arwkv7.cpp): the RWKV-7 time mix without
    the group-norm tail, Qwen2's SiLU-GLU FFN and RMS norms, one token-shift
    stream."""
    _rwkv_extras(cfg, md, hybrid=True)
    return cfg


# -- MLA at MHA width ----------------------------------------------------------


@register("minicpm3")  # 1179
def _minicpm3(cfg: ModelConfig, md) -> ModelConfig:
    """MiniCPM3 (reference src/models/minicpm3.cpp): DeepSeek-2's MLA (q-LoRA
    and the kv latent) at MHA width with MiniCPM's muP scales: embedding 12,
    residual 1.4 / sqrt(L), logits dim_model_base / n_embd; a tied head.
    Its absorbed cache row is (256 + 32 -> 384, 256): K5/K6's second MLA
    pair."""
    a = cfg.arch
    cfg.extra.update(
        kv_lora_rank=int(md.get(f"{a}.attention.kv_lora_rank", 256)),
        q_lora_rank=int(md.get(f"{a}.attention.q_lora_rank", 0) or 0))
    dim_base = float(md.get(f"{a}.embedding_scale_base",
                            md.get(f"{a}.dim_model_base", 256.0)) or 256.0)
    c = cfg.with_(rope_type=ROPE_TYPE_NEOX, n_kv_heads=cfg.n_heads, embd_scale=12.0,
                  residual_scale=1.4 / (cfg.n_layers ** 0.5),
                  logit_scale=dim_base / max(cfg.n_embd, 1), tie_embeddings=True)
    _mla_absorb_extras(c)
    return c


@register("plm")  # 1817
def _plm(cfg: ModelConfig, md) -> ModelConfig:
    """PLM (reference src/models/plm.cpp): DeepSeek-2's MLA without q-LoRA,
    a non-gated ReLU^2 FFN, a tied head."""
    cfg.extra.update(kv_lora_rank=int(md.get("plm.attention.kv_lora_rank", 512)),
                     q_lora_rank=0)
    c = cfg.with_(rope_type=ROPE_TYPE_NEOX, n_kv_heads=cfg.n_heads, act="relu2", glu=False,
                  tie_embeddings=True)
    _mla_absorb_extras(c)
    return c


@register("mistral4")  # 1801
def _mistral4(cfg: ModelConfig, md) -> ModelConfig:
    """Mistral-4: an alias of deepseek2 (reference models.h:1316), its keys
    under its own prefix."""
    md2 = {k.replace("mistral4.", "deepseek2."): v for k, v in md.items()}
    return _deepseek2(cfg.with_(arch="deepseek2"), md2).with_(arch=cfg.arch)


# -- the shared decoder's last text families -----------------------------------


def _as_arr(v) -> tuple[int, ...] | None:
    """A per-layer int array of the metadata as a tuple; None for a scalar
    (uniform across layers)."""
    if v is None:
        return None
    if hasattr(v, "tolist"):
        v = v.tolist()
    if not isinstance(v, (list, tuple)):
        return None
    return tuple(int(x) for x in v)


@register("hy_v3")  # 1979
def _hy_v3(cfg: ModelConfig, md) -> ModelConfig:
    """Hunyuan V3 (reference src/models/hy-v3.cpp): per-head qk norms, NEOX
    rope, a sigmoid router with a selection bias, leading dense layers and
    an always-on shared expert, a tied head."""
    a = cfg.arch
    gating = {1: "softmax", 2: "sigmoid"}.get(
        int(md.get(f"{a}.expert_gating_func", 2) or 2), "sigmoid")
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, qk_norm=True, tie_embeddings=True,
                     expert_gating=gating,
                     expert_weights_norm=bool(md.get(f"{a}.expert_weights_norm", False)),
                     expert_weights_scale=float(md.get(f"{a}.expert_weights_scale", 1.0)),
                     n_expert_shared=int(md.get(f"{a}.expert_shared_count", 1) or 1))


@register("apertus")  # 793
def _apertus(cfg: ModelConfig, md) -> ModelConfig:
    """Apertus (reference src/models/apertus.cpp): per-head qk norms and the
    non-gated xIELU FFN with learned scalars a layer."""
    a = cfg.arch
    n = cfg.n_layers

    def arr(key, default):
        v = md.get(f"{a}.{key}", default)
        if hasattr(v, "tolist"):
            v = v.tolist()
        if not isinstance(v, (list, tuple)):
            v = [float(v)] * n
        return tuple(float(x) for x in v)

    cfg.extra["xielu"] = {"alpha_n": arr("xielu_alpha_n", 0.8),
                          "alpha_p": arr("xielu_alpha_p", 0.8),
                          "beta": arr("xielu_beta", 0.5), "eps": arr("xielu_eps", -1e-6)}
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, qk_norm=True, act="xielu", glu=False)


@register("bitnet")  # 1171
def _bitnet(cfg: ModelConfig, md) -> ModelConfig:
    """BitNet b1.58 (reference src/models/bitnet.cpp): per-tensor scalar
    scales (folded at load), sub-norms before attn_output and ffn_down."""
    return cfg.with_(rope_type=ROPE_TYPE_NEOX)


@register("talkie")  # 1630
def _talkie(cfg: ModelConfig, md) -> ModelConfig:
    """Talkie (reference src/models/talkie.cpp): weightless RMS norms, q/k
    norms after rope, the normed embedding added after every layer times
    its layer_output_scale, a logit scale."""
    cfg.extra.update(weightless_norm=True, embd_skip=True, qk_norm_after_rope=True)
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, qk_norm=True,
                     logit_scale=float(md.get(f"{cfg.arch}.logit_scale", 1.0)))


@register("chameleon")  # 816
def _chameleon(cfg: ModelConfig, md) -> ModelConfig:
    """Chameleon (reference src/models/chameleon.cpp): per-head q/k LayerNorms
    with biases; with swin_norm the norm-after ordering."""
    cfg.extra["qk_layernorm"] = True
    c = cfg.with_(rope_type=ROPE_TYPE_NORM, qk_norm=True)
    if bool(md.get("chameleon.swin_norm", False)):
        c = c.with_(norm_after=True)
    return c


@register("jais2")  # 1715
def _jais2(cfg: ModelConfig, md) -> ModelConfig:
    """Jais-2 (reference src/models/jais2.cpp): LayerNorm blocks, biased
    q/k/v, NEOX rope, a non-gated ReLU^2 FFN with biases, a tied head."""
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, use_rms_norm=False, act="relu2", glu=False,
                     tie_embeddings=True)


@register("maincoder")  # 1239
def _maincoder(cfg: ModelConfig, md) -> ModelConfig:
    """MainCoder (reference src/models/maincoder.cpp): the llama graph."""
    return cfg.with_(rope_type=ROPE_TYPE_NORM)


@register("pangu-embedded")  # 1270
def _pangu_embedded(cfg: ModelConfig, md) -> ModelConfig:
    """Pangu Embedded (reference src/models/pangu-embed.cpp): the llama graph
    with NEOX rope and optional biases."""
    return cfg.with_(rope_type=ROPE_TYPE_NEOX)


@register("deci")  # 1740
def _deci(cfg: ModelConfig, md) -> ModelConfig:
    """DeciLM / Llama-3.1-Nemotron NAS (reference src/models/deci.cpp): the
    llama graph with per-layer head arrays. A layer attends, or is "linear
    attention" (heads > 0, KV heads 0: out = wo . norm(x)), attention-free
    (FFN only, on ffn_norm) or a dummy (identity). The KV memory holds the
    largest KV-head count; each layer pads its writes and slices its
    reads."""
    a = cfg.arch
    heads = _as_arr(md.get(f"{a}.attention.head_count"))
    kvh = _as_arr(md.get(f"{a}.attention.head_count_kv"))
    if heads is not None:
        cfg.extra["n_head_arr"] = heads
    if kvh is not None:
        cfg.extra["n_head_kv_arr"] = kvh
    return cfg.with_(rope_type=ROPE_TYPE_NORM, tie_embeddings=True)


# -- T5's encoder-decoder, the diffusion LMs and the last shared-decoder text
# entries (the JAX package's registry.py entries of the same names, its line
# given)


@register("t5")  # 1047
def _t5(cfg: ModelConfig, md) -> ModelConfig:
    """T5 / flan-t5 / mt5 encoder-decoder (reference src/models/t5.cpp;
    models/t5.py's t5_encode and t5_forward). cfg.n_layers becomes the
    decoder's depth (the layers the KV memory and params["layers"] cover);
    the encoder's depth goes to extra."""
    cfg.extra.update(
        t5=True, encoder_decoder=True,
        rel_buckets=int(md.get("t5.attention.relative_buckets_count", 32)),
        enc_n_layers=cfg.n_layers,
        decoder_start_token=int(md.get("t5.decoder_start_token_id", 0)))
    return cfg.with_(rope_type=ROPE_TYPE_NONE,
                     n_layers=int(md.get("t5.decoder_block_count", cfg.n_layers)))


def _diffusion(cfg: ModelConfig, shift: bool) -> None:
    """A diffusion LM's extras: bidirectional attention over the whole
    sequence (the einsum path, in both packages), generation by iterative
    unmasking (runtime/diffusion.py)."""
    cfg.extra.update(non_causal=True, diffusion=True, diffusion_shift_logits=shift)


@register("dream")  # 827
def _dream(cfg: ModelConfig, md) -> ModelConfig:
    """Dream 7B (reference src/models/dream.cpp): qwen2's graph (q/k/v
    biases, NEOX rope) run bidirectionally; position i is scored with the
    logits of position i - 1. Its biases apply wherever the loader finds
    them."""
    _diffusion(cfg, shift=True)
    return cfg.with_(rope_type=ROPE_TYPE_NEOX)


@register("llada")  # 836
def _llada(cfg: ModelConfig, md) -> ModelConfig:
    """LLaDA 8B (reference src/models/llada.cpp): llama's graph run
    bidirectionally."""
    _diffusion(cfg, shift=False)
    return cfg.with_(rope_type=ROPE_TYPE_NORM)


@register("llada-moe")  # 1367
def _llada_moe(cfg: ModelConfig, md) -> ModelConfig:
    """LLaDA-MoE (reference src/models/llada-moe.cpp): bidirectional, per-head
    q/k norms, a softmax router whose top-k weights stay raw (build_moe_ffn
    norm_w=false, llada-moe.cpp:133)."""
    _diffusion(cfg, shift=False)
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, qk_norm=True, expert_weights_norm=False)


@register("rnd1")  # 1378
def _rnd1(cfg: ModelConfig, md) -> ModelConfig:
    """RND1 (reference src/models/rnd1.cpp): qwen3moe's blocks run
    bidirectionally, the top-k weights normalised."""
    _diffusion(cfg, shift=False)
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, qk_norm=True, expert_weights_norm=True)


@register("afmoe")  # 1573
def _afmoe(cfg: ModelConfig, md) -> ModelConfig:
    """AFMoE (reference src/models/afmoe.cpp): a sigmoid output gate
    (attn_gate) before attn_output, per-head q/k norms, NoPE every
    no_rope_layer_step-th layer, post-norms on both halves, the embedding
    times sqrt(n_embd), leading dense layers, then a sigmoid router with a
    selection bias and shared experts; an optional window pattern."""
    a = cfg.arch
    step = int(md.get(f"{a}.rope.no_rope_layer_step", 0) or 0)
    if step > 0:
        cfg.extra["no_rope_layers"] = tuple(il for il in range(cfg.n_layers)
                                            if (il + 1) % step == 0)
    c = cfg.with_(rope_type=ROPE_TYPE_NEOX, qk_norm=True, post_norms=True,
                  embd_scale=float(cfg.n_embd) ** 0.5,
                  expert_gating=_gating(md, f"{a}.expert_gating_func", 2),
                  expert_weights_norm=bool(md.get(f"{a}.expert_weights_norm", True)),
                  expert_weights_scale=float(md.get(f"{a}.expert_weights_scale", 1.0)),
                  n_expert_shared=int(md.get(f"{a}.expert_shared_count", 0)))
    return _swa_pattern_extra(c, md, a)


@register("laguna")  # 1834
def _laguna(cfg: ModelConfig, md) -> ModelConfig:
    """Laguna (reference src/models/laguna.cpp): qwen3's per-head q/k norms
    with a softplus output gate, per head (a gate n_heads wide, broadcast
    over the head) or per element, told apart by the gate's width; a sigmoid
    router with a selection bias and one shared expert after leading dense
    layers; on the full/window variant the window layers rope
    dimension_count_swa dims at freq_base_swa, without YaRN."""
    a = cfg.arch
    heads = _as_arr(md.get(f"{a}.attention.head_count"))
    if heads is not None and len(set(heads)) > 1:
        cfg.extra["n_head_arr"] = heads
    cfg.extra.update(attn_gate_fn="softplus", swa_first_global=True)
    dims_swa = md.get(f"{a}.rope.dimension_count_swa")
    if dims_swa:
        cfg.extra["rope_dims_swa"] = int(dims_swa)
    c = cfg.with_(rope_type=ROPE_TYPE_NEOX, qk_norm=True,
                  expert_gating=_gating(md, f"{a}.expert_gating_func", 2),
                  expert_weights_norm=bool(md.get(f"{a}.expert_weights_norm", False)),
                  expert_weights_scale=float(md.get(f"{a}.expert_weights_scale", 1.0)),
                  n_expert_shared=int(md.get(f"{a}.expert_shared_count", 1) or 1))
    return _swa_pattern_extra(c, md, a)


@register("openelm")  # 1724
def _openelm(cfg: ModelConfig, md) -> ModelConfig:
    """Apple OpenELM (reference src/models/openelm.cpp): per-layer head and
    KV-head arrays, a file-fused QKV split [q | k | v] by each layer's own
    counts, shared per-head q/k RMSNorms, NEOX rope, a SiLU GLU FFN whose
    width each layer's tensors give, a tied head."""
    a = cfg.arch
    heads = _as_arr(md.get(f"{a}.attention.head_count"))
    kvh = _as_arr(md.get(f"{a}.attention.head_count_kv"))
    if heads is not None:
        cfg.extra["n_head_arr"] = heads
    if kvh is not None:
        cfg.extra["n_head_kv_arr"] = kvh
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, qk_norm=True, tie_embeddings=True)


@register("nanbeige")  # 1757
def _nanbeige(cfg: ModelConfig, md) -> ModelConfig:
    """Nanbeige (reference src/models/nanbeige.cpp): llama's graph with the
    physical stack run num_loops times on shared weights (each logical
    layer keeps its own KV rows), output_norm applied again at each loop
    boundary unless skip_loop_final_norm. cfg.n_layers counts the logical
    layers."""
    a = cfg.arch
    loops = int(md.get(f"{a}.num_loops", 1))
    cfg.extra.update(n_loops=loops,
                     skip_loop_final_norm=bool(md.get(f"{a}.skip_loop_final_norm", False)))
    return cfg.with_(rope_type=ROPE_TYPE_NORM, n_layers=cfg.n_layers * max(loops, 1))


# -- Gemma 3n and Gemma 4 (their own forwards, models/gemma3n.py), the Gemma 4
# MTP assistant (a draft over a target context), MiniMax-M3's block-sparse
# attention on the shared decoder


def _kv_reuse_layers(cfg: ModelConfig, n_shared: int,
                     default_from_start: int | None = None) -> list[int]:
    """The cross-layer KV sharing map (reference llama-model.cpp:2311-2320;
    the JAX package's registry.py:210-227): each layer past
    n_layer_kv_from_start reads the last owned layer of its own window
    class (-1: the layer owns its lines)."""
    L = cfg.n_layers
    from_start = L - n_shared if n_shared > 0 else (default_from_start or L)
    from_start = max(1, min(from_start, L))
    reuse = []
    for il in range(L):
        if il < from_start:
            reuse.append(-1)
            continue
        cls = cfg.is_swa_layer(il)
        reuse.append(next((j for j in range(from_start - 1, -1, -1)
                           if cfg.is_swa_layer(j) == cls), -1))
    return reuse


def _gemma4_class_dims(cfg: ModelConfig, md, a: str) -> ModelConfig:
    """Gemma 4's window pattern (a per-layer array, with swa_pattern 1 as
    the marker that a window pattern is there) and the window layers'
    narrower heads, whose rope spans their own width."""
    pat = md.get(f"{a}.attention.sliding_window_pattern")
    if hasattr(pat, "__len__"):  # a per-layer array
        cfg.extra["is_swa_layers"] = [bool(int(v)) for v in pat]
        cfg = cfg.with_(swa_pattern=1)
    else:
        cfg = cfg.with_(swa_pattern=int(pat or 6))
    cfg.extra["rope_factors_full_only"] = True
    cfg.extra["rope_freq_base_swa"] = float(md.get(f"{a}.rope.freq_base_swa", 10000.0))
    dk_swa = int(md.get(f"{a}.attention.key_length_swa", 0))
    if dk_swa and dk_swa != cfg.head_dim_k:
        cfg.extra["head_dim_k_swa"] = dk_swa
        cfg.extra["head_dim_v_swa"] = int(md.get(f"{a}.attention.value_length_swa", dk_swa))
        cfg.extra["rope_dims_swa"] = dk_swa
    return cfg


@register("gemma3n")  # 229
def _gemma3n(cfg: ModelConfig, md) -> ModelConfig:
    """Gemma 3n (reference src/models/gemma3n.cpp): AltUp streams, LAUREL,
    per-layer token embeddings, Gaussian top-k activation sparsity,
    shared-KV tail layers, V normed without a weight, attention scale 1."""
    c = cfg.with_(rope_type=ROPE_TYPE_NEOX, act="gelu", embd_scale=float(cfg.n_embd) ** 0.5,
                  post_norms=True, qk_norm=True, tie_embeddings=True, attn_scale=1.0,
                  swa_pattern=int(md.get("gemma3n.attention.sliding_window_pattern", 5)))
    c.extra.update(gemma3n=True, v_rms_norm=True)
    c.extra["rope_freq_base_swa"] = float(md.get("gemma3n.rope.freq_base_swa", 10000.0))
    c.extra["n_altup"] = int(md.get("gemma3n.altup.num_inputs", 4))
    c.extra["i_altup_act"] = int(md.get("gemma3n.altup.active_idx", 0))
    c.extra["n_embd_altup"] = int(md.get("gemma3n.embedding_length_per_layer_input", 256))
    # the per-layer std multipliers; the default is the reference's constant
    # (models.h:804-805: the first 10 layers at icdf(0.95))
    sp = md.get("gemma3n.activation_sparsity_scale")
    if sp is None:
        sp = [1.6448533535003662 if il < 10 else 0.0 for il in range(cfg.n_layers)]
    c.extra["act_sparsity_std"] = [float(v) for v in sp]
    n_shared = int(md.get("gemma3n.attention.shared_kv_layers", 0))
    c.extra["kv_reuse"] = _kv_reuse_layers(c, n_shared, default_from_start=min(20, cfg.n_layers))
    return c


@register("gemma4")  # 262
def _gemma4(cfg: ModelConfig, md) -> ModelConfig:
    """Gemma 4 (reference src/models/gemma4.cpp): a per-layer window array
    with narrower window heads, a shared-KV tail, V from the K projection
    where a layer has no attn_v, the dual-branch MoE, per-layer
    embeddings, proportional rope on the full layers, per-layer output
    scalars."""
    c = cfg.with_(rope_type=ROPE_TYPE_NEOX, act="gelu", embd_scale=float(cfg.n_embd) ** 0.5,
                  post_norms=True, qk_norm=True, tie_embeddings=True, attn_scale=1.0,
                  expert_weights_norm=True)
    c = _gemma4_class_dims(c, md, "gemma4")
    c.extra.update(gemma4=True, v_rms_norm=True)
    c.extra["n_embd_altup"] = int(md.get("gemma4.embedding_length_per_layer_input", 0))
    n_shared = int(md.get("gemma4.attention.shared_kv_layers", 0))
    if n_shared > 0:
        c.extra["kv_reuse"] = _kv_reuse_layers(c, n_shared)
    return c


@register("gemma4-assistant")  # 305
def _gemma4_assistant(cfg: ModelConfig, md) -> ModelConfig:
    """The Gemma 4 MTP assistant (reference src/models/gemma4-assistant.cpp):
    a q-only draft whose every layer attends the target context's KV; it
    runs through models.gemma3n.Gemma4AssistantSpeculator, which binds its
    kv_reuse map into the target's layers."""
    c = cfg.with_(rope_type=ROPE_TYPE_NEOX, act="gelu", post_norms=True, qk_norm=True,
                  tie_embeddings=True, attn_scale=1.0)
    c = _gemma4_class_dims(c, md, "gemma4-assistant")
    c.extra["gemma4_assistant"] = True
    c.extra["n_embd_out"] = int(md.get("gemma4-assistant.embedding_length_out", cfg.n_embd))
    c.extra["n_layer_nextn"] = int(md.get("gemma4-assistant.nextn_predict_layers",
                                          cfg.n_layers))
    return c


@register("minimax-m3")  # 1388
def _minimax_m3(cfg: ModelConfig, md) -> ModelConfig:
    """MiniMax-M3 (reference src/models/minimax-m3.cpp, llama-kv-cache-msa.h):
    dense-lead layers, then block-sparse attention: a per-GQA-group indexer
    scores the cached positions, max-pooled over blocks with the local
    blocks forced in, and the top-k blocks gate the mask (on a DSAMemory);
    per-head q/k norms, partial rope, MoE with shared experts and softmax
    or sigmoid gating."""
    a = cfg.arch
    cfg.extra.update(
        msa=True,
        indexer_n_head=int(md.get(f"{a}.attention.indexer.head_count", cfg.n_kv_heads)),
        indexer_head_size=int(md.get(f"{a}.attention.indexer.key_length", 128)),
        indexer_top_k=int(md.get(f"{a}.attention.indexer.top_k", 16)),
        indexer_block_size=int(md.get(f"{a}.attention.indexer.block_size", 64)),
        indexer_local_blocks=int(md.get(f"{a}.attention.indexer.local_blocks", 1)),
        msa_dense_lead=int(md.get(f"{a}.leading_dense_block_count", 0)),
    )
    return cfg.with_(rope_type=ROPE_TYPE_NEOX, qk_norm=True,
                     expert_gating=_gating(md, f"{a}.expert_gating_func", 1),
                     expert_weights_norm=bool(md.get(f"{a}.expert_weights_norm", False)),
                     expert_weights_scale=float(md.get(f"{a}.expert_weights_scale", 1.0)),
                     n_expert_shared=int(md.get(f"{a}.expert_shared_count", 0)))
