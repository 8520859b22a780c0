"""Architecture registry: per-arch config tweaks over the shared decoder.

Port of the JAX package's models/registry.py (analog of reference
src/llama-arch.h LLM_ARCH_* and the per-arch classes of src/models/*.cpp),
for the entries whose graph is the port's shared decoder: each entry takes
the config read from the metadata and the metadata itself, and sets that
family's flags. Any other architecture raises NotImplementedError, among
them deepseek32 (DeepSeek's sparse attention needs the DSA memory) and
deepseek2-ocr (it comes with the multimodal path).
"""

from __future__ import annotations

from typing import Any, Callable

from ..ops.rope import ROPE_TYPE_NEOX, ROPE_TYPE_NORM
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
