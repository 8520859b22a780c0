"""Model hyperparameters parsed from GGUF metadata, for the llama family.

Analog of reference src/llama-hparams.h + load_arch_hparams (src/models/
llama.cpp:3-33); the subset of the JAX package's ModelConfig that from_gguf
fills for llama, plus the llama entry of its architecture registry.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any

import numpy as np
import torch

from ..gguf.constants import Keys
from ..ops.rope import ROPE_TYPE_NORM


@dataclass
class ModelConfig:
    arch: str
    name: str = ""
    vocab_size: int = 0
    n_embd: int = 0
    n_layers: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim_k: int = 0
    head_dim_v: int = 0
    n_ff: int = 0
    n_ctx_train: int = 0

    rms_eps: float = 1e-5

    rope_type: int = ROPE_TYPE_NORM
    rope_dims: int = 0
    rope_freq_base: float = 10000.0
    rope_freq_scale: float = 1.0
    rope_ext_factor: float = 0.0
    rope_attn_factor: float = 1.0
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_orig_ctx: int = 0

    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    logit_scale: float = 1.0
    attn_scale: float = 0.0  # 0 -> 1/sqrt(head_dim_k)
    sliding_window: int = 0

    compute_dtype: torch.dtype = torch.bfloat16
    extra: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_gguf(cls, md: dict[str, Any]) -> "ModelConfig":
        arch = md.get(Keys.General.ARCHITECTURE, "llama")

        def g(tmpl: str, default=None):
            v = md.get(tmpl.format(arch=arch), default)
            return v.item() if isinstance(v, np.generic) else v

        def as_int(v, default=0):
            if isinstance(v, (list, tuple, np.ndarray)):
                return int(max(v)) if len(v) else default
            return int(v) if v is not None else default

        K = Keys.LLM
        n_embd = as_int(g(K.EMBEDDING_LENGTH, 0))
        n_heads = as_int(g(K.ATTN_HEAD_COUNT, 0))
        n_kv = as_int(g(K.ATTN_HEAD_COUNT_KV, n_heads), n_heads)
        head_k = int(g(K.ATTN_KEY_LENGTH, n_embd // max(n_heads, 1)))
        head_v = int(g(K.ATTN_VALUE_LENGTH, head_k))
        tokens = md.get(Keys.Tokenizer.TOKENS, [])
        cfg = cls(
            arch=arch,
            name=str(md.get(Keys.General.NAME, "")),
            vocab_size=int(g(K.VOCAB_SIZE, len(tokens))),
            n_embd=n_embd,
            n_layers=int(g(K.BLOCK_COUNT, 0)),
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim_k=head_k,
            head_dim_v=head_v,
            n_ff=int(g(K.FEED_FORWARD_LENGTH, 0)),
            n_ctx_train=int(g(K.CONTEXT_LENGTH, 0)),
            rms_eps=float(g(K.ATTN_LAYERNORM_RMS_EPS, 1e-5)),
            rope_dims=int(g(K.ROPE_DIMENSION_COUNT, head_k)),
            rope_freq_base=float(g(K.ROPE_FREQ_BASE, 10000.0)),
            sliding_window=int(g(K.ATTN_SLIDING_WINDOW, 0)),
            logit_scale=float(g(K.LOGIT_SCALE, 1.0)),
            attn_logit_softcap=float(g(K.ATTN_LOGIT_SOFTCAP, 0.0)),
            final_logit_softcap=float(g(K.FINAL_LOGIT_SOFTCAP, 0.0)),
        )
        scaling = g(K.ROPE_SCALING_TYPE)
        factor = g(K.ROPE_SCALING_FACTOR)
        if scaling == "linear" and factor:
            cfg.rope_freq_scale = 1.0 / float(factor)
        elif scaling == "yarn" and factor:
            cfg.rope_freq_scale = 1.0 / float(factor)
            cfg.rope_ext_factor = 1.0
            cfg.rope_orig_ctx = int(g(K.ROPE_SCALING_ORIG_CTX, cfg.n_ctx_train))
            cfg.rope_attn_factor = float(g(K.ROPE_SCALING_ATTN_FACTOR, 1.0))
            cfg.rope_beta_fast = float(g(K.ROPE_SCALING_BETA_FAST, 32.0))
            cfg.rope_beta_slow = float(g(K.ROPE_SCALING_BETA_SLOW, 1.0))
        return apply_arch(cfg)

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


def _llama(cfg: ModelConfig) -> ModelConfig:
    # GGUF llama q/k weights are permuted for NORM-style rope
    # (reference src/models/llama.cpp:99-247)
    return cfg.with_(rope_type=ROPE_TYPE_NORM)


_REGISTRY = {"llama": _llama}


def apply_arch(cfg: ModelConfig) -> ModelConfig:
    fn = _REGISTRY.get(cfg.arch)
    if fn is None:
        raise NotImplementedError(
            f"architecture {cfg.arch!r} not implemented (have: {sorted(_REGISTRY)})")
    return fn(cfg)
