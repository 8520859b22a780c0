"""Architecture registry: per-arch config tweaks over the shared decoder.

Port of the JAX package's models/registry.py (analog of reference
src/llama-arch.h LLM_ARCH_* and the per-arch classes of src/models/*.cpp),
for the entries whose graph is the port's shared decoder: each entry takes
the config read from the metadata and the metadata itself, and sets that
family's flags. Any other architecture raises NotImplementedError.
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
