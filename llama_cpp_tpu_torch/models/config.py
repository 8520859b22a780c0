"""Model hyperparameters parsed from GGUF metadata.

Analog of reference src/llama-hparams.h + load_arch_hparams (src/models/
llama.cpp:3-33); the subset of the JAX package's ModelConfig that the
decoder families of the port's registry (models/registry.py) read, with
the block variants of the shared decoder (LayerNorm, the non-gated FFN,
parallel and norm-after residuals, residual scales, ALiBi) and its MoE
variants (gatings, the clamped oai GLU). from_gguf
reads the metadata; the registry's entry for the architecture then sets
that family's flags.
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
    norm_eps: float = 1e-5  # LayerNorm's epsilon
    use_rms_norm: bool = True  # False: LayerNorm (with bias where the file has one)

    rope_type: int = ROPE_TYPE_NORM
    rope_dims: int = 0
    rope_freq_base: float = 10000.0
    rope_freq_scale: float = 1.0
    rope_ext_factor: float = 0.0
    rope_attn_factor: float = 1.0
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_orig_ctx: int = 0

    act: str = "silu"
    glu: bool = True  # gated FFN (SwiGLU/GeGLU); False: down(act(up(x)))
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    logit_scale: float = 1.0
    attn_scale: float = 0.0  # 0 -> 1/sqrt(head_dim_k)
    embd_scale: float = 1.0  # gemma: sqrt(n_embd)

    qk_norm: bool = False  # qwen3/gemma3 per-head rmsnorm on q/k before rope
    post_norms: bool = False  # gemma2/3: post-attention/post-ffn norms
    parallel_residual: bool = False  # gptneox/phi2: x + attn(n(x)) + ffn(n(x))
    shared_parallel_norm: bool = False  # phi2/command-r: one norm feeds both branches
    norm_after: bool = False  # olmo2: x + norm(attn(x)), no pre-norm
    residual_scale: float = 1.0  # granite/minicpm: each branch scaled before its add
    alibi_bias: float = 0.0  # bloom/mpt max_alibi_bias (0 = rope or none)

    sliding_window: int = 0
    swa_pattern: int = 0  # every Nth layer is full-attention (gemma3: 6)

    n_expert: int = 0
    n_expert_used: int = 0
    # router probability function: softmax | sigmoid | softmax_weight (top-k
    # on the logits, then softmax over the selected k: gpt-oss) |
    # sqrt_softplus | sparsemixer (phimoe's two masked-argmax picks)
    expert_gating: str = "softmax"
    moe_act: str = ""  # "" -> act (gated); "swiglu_oai" -> gpt-oss's clamped GLU
    expert_weights_norm: bool = False
    expert_weights_scale: float = 1.0
    n_ff_exp: int = 0
    n_expert_shared: int = 0
    # llama4's interleave step, held as the JAX config holds it; neither package
    # reads it: which layers carry experts is the file's
    moe_every: int = 1

    tie_embeddings: bool = False
    compute_dtype: torch.dtype = torch.bfloat16
    # per-family keys the decoder reads: no_rope_layers (NoPE layer ids),
    # qk_norm_full (q/k RMSNorm over the whole projection), qk_norm_after_rope,
    # weightless_norm (LayerNorm without tensors), clamp_kqv, rope_freq_base_swa,
    # is_swa_layers / swa_first_global (which layers attend over the window),
    # the MoE keys (moe_weight_before, router_jitter, router_raw_input,
    # dense_moe_scale, n_group_experts, expert_group_scale, n_chunk_expert),
    # tensor_remap (the loader's) and the MLA keys (models/registry.py)
    extra: dict[str, Any] = field(default_factory=dict)

    def is_swa_layer(self, il: int) -> bool:
        """Whether layer il attends over the sliding window: as the per-layer
        array is_swa_layers says where the family has one (mimo2, step35),
        else every layer when there is a window and no pattern, else all but
        every swa_pattern-th (the first of each period with swa_first_global:
        cohere2moe)."""
        if self.sliding_window <= 0:
            return False
        arr = self.extra.get("is_swa_layers")
        if arr is not None:
            return bool(arr[il])
        if self.swa_pattern <= 0:
            return True
        if self.extra.get("swa_first_global"):
            return il % self.swa_pattern != 0
        return (il + 1) % self.swa_pattern != 0

    @classmethod
    def from_gguf(cls, md: dict[str, Any]) -> "ModelConfig":
        """The metadata's hyperparameters, before the registry's entry for
        the architecture (models/registry.apply_arch) sets its flags."""
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
            norm_eps=float(g(K.ATTN_LAYERNORM_EPS, 1e-5)),
            rope_dims=int(g(K.ROPE_DIMENSION_COUNT, head_k)),
            rope_freq_base=float(g(K.ROPE_FREQ_BASE, 10000.0)),
            sliding_window=int(g(K.ATTN_SLIDING_WINDOW, 0)),
            n_expert=int(g(K.EXPERT_COUNT, 0)),
            n_expert_used=int(g(K.EXPERT_USED_COUNT, 0)),
            n_ff_exp=int(g(K.EXPERT_FFN_LENGTH, 0)),
            n_expert_shared=int(g(K.EXPERT_SHARED_COUNT, 0)),
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
        return cfg

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)
