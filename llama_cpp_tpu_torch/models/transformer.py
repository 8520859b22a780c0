"""Pre-norm decoder transformer forward pass for the llama family, on the
paged KV pool.

Analog of reference llm_graph_context build_attn / build_ffn (src/llama-
graph.h:1048-1143) and the llama graph (src/models/llama.cpp:99-247); the
llama subset of the JAX package's models/transformer.py with its casts
(bf16 activations, f32 accumulation, f32 logits).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..ops.basic import rms_norm, swiglu
from ..ops.kernels import flash_attn as fa_kernel
from ..ops.qtensor import Weight, embed_lookup, matmul
from ..ops.rope import ROPE_TYPE_NONE, RopeParams, apply_rope
from ..runtime.paged_kv import PagedKVCache
from .config import ModelConfig


class AttnInputs(NamedTuple):
    """Per-step attention metadata, batched [B, T]: each batch row maps to
    one KV sequence; padding tokens carry a negative position and write to
    the pool's trash row."""

    seq_idx: torch.Tensor  # [B] cache sequence per batch row
    positions: torch.Tensor  # [B, T] rope/causal position (< 0 = pad)


def norm(cfg: ModelConfig, x: torch.Tensor, w: dict[str, Weight], key: str) -> torch.Tensor:
    return rms_norm(x, w.get(key), cfg.rms_eps)


def _rope_params(cfg: ModelConfig) -> RopeParams:
    return RopeParams(
        freq_factors=cfg.extra.get("rope_factors_arr"),
        rope_type=cfg.rope_type,
        n_dims=cfg.rope_dims,
        freq_base=cfg.rope_freq_base,
        freq_scale=cfg.rope_freq_scale,
        ext_factor=cfg.rope_ext_factor,
        attn_factor=cfg.rope_attn_factor,
        beta_fast=cfg.rope_beta_fast,
        beta_slow=cfg.rope_beta_slow,
        orig_ctx=cfg.rope_orig_ctx,
    )


def attention_block(cfg: ModelConfig, lw: dict[str, Weight], x: torch.Tensor,
                    inputs: AttnInputs, kv: PagedKVCache, il: int,
                    kernels: bool = True) -> torch.Tensor:
    """Plain GQA attention over the paged pool; writes this step's K/V rows
    in place. kernels=False takes the gather + einsum path everywhere."""
    B, T = x.shape[:2]
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    Dk, Dv = cfg.head_dim_k, cfg.head_dim_v

    if "attn_qkv" in lw:
        qkv = matmul(x, lw["attn_qkv"], kernels=kernels)
        q = qkv[..., : H * Dk]
        k = qkv[..., H * Dk: H * Dk + Hkv * Dk]
        v = qkv[..., H * Dk + Hkv * Dk:]
    elif "attn_qk" in lw:  # q+k fused, v standalone (Q4_K_M's Q6_K attn_v)
        qk = matmul(x, lw["attn_qk"], kernels=kernels)
        q = qk[..., : H * Dk]
        k = qk[..., H * Dk:]
        v = matmul(x, lw["attn_v"], kernels=kernels)
    else:
        q = matmul(x, lw["attn_q"], kernels=kernels)
        k = matmul(x, lw["attn_k"], kernels=kernels)
        v = matmul(x, lw["attn_v"], kernels=kernels)

    q = q.reshape(B, T, H, Dk)
    k = k.reshape(B, T, Hkv, Dk)
    v = v.reshape(B, T, Hkv, Dv)
    if cfg.rope_type != ROPE_TYPE_NONE:
        rp = _rope_params(cfg)
        q = apply_rope(q, inputs.positions, rp)
        k = apply_rope(k, inputs.positions, rp)

    # position-addressed write of the [B, T] token grid (SET_ROWS analog)
    seq_flat = inputs.seq_idx.repeat_interleave(T)
    kv.write_layer(il, seq_flat, inputs.positions.reshape(-1),
                   k.reshape(B * T, Hkv, Dk), v.reshape(B * T, Hkv, Dv),
                   update_pos=il == 0)

    scale = cfg.attn_scale or (1.0 / float(Dk) ** 0.5)
    window = cfg.sliding_window if cfg.sliding_window > 0 else 0
    sinks = lw.get("attn_sinks")  # [H] attention-sink logits
    # the kernel path needs a card, as the JAX package's needs a TPU; where
    # the JAX package would run its kernel, the port's runs or raises
    use_flash = (kernels and x.device.type == "cuda"
                 and fa_kernel.dispatches(Dk, Dv, kv.max_pages * kv.page, T * (H // Hkv)))
    if use_flash:
        out = fa_kernel.mha_flash_paged(
            q, kv, il, inputs.seq_idx, inputs.positions, sm_scale=scale, window=window,
            softcap=cfg.attn_logit_softcap,
            sinks=None if sinks is None else sinks.float()).to(x.dtype)
    else:
        k_seq, v_seq, slot_pos = kv.gather_seq(il, inputs.seq_idx)
        pos = inputs.positions.long()
        slot_pos = slot_pos.long()
        mask = (slot_pos >= 0)[:, None, :] & (slot_pos[:, None, :] <= pos[:, :, None])
        if window > 0:
            mask = mask & (slot_pos[:, None, :] > pos[:, :, None] - window)
        groups = H // Hkv
        mdt = torch.float32 if x.dtype == torch.float32 else torch.bfloat16
        qg = q.reshape(B, T, Hkv, groups, Dk).to(mdt).float()
        scores = torch.einsum("btkgd,bksd->bkgts", qg, k_seq.to(mdt).float()) * scale
        if cfg.attn_logit_softcap:
            cap = cfg.attn_logit_softcap
            scores = torch.tanh(scores / cap) * cap
        scores = scores.masked_fill(~mask[:, None, None], float("-inf"))
        if sinks is not None:
            sink_col = sinks.float().reshape(1, Hkv, groups, 1, 1).expand(
                *scores.shape[:-1], 1)
            probs = torch.softmax(torch.cat([scores, sink_col], dim=-1), dim=-1)[..., :-1]
        else:
            probs = torch.softmax(scores, dim=-1)
        probs = torch.nan_to_num(probs, nan=0.0)  # fully-masked rows
        out = torch.einsum("bkgts,bksd->btkgd", probs.to(mdt).float(), v_seq.to(mdt).float())
        out = out.reshape(B, T, H * Dv).to(x.dtype)
    return matmul(out, lw["attn_output"], kernels=kernels)


def ffn_block(cfg: ModelConfig, lw: dict[str, Weight], x: torch.Tensor,
              kernels: bool = True) -> torch.Tensor:
    if "ffn_gateup" in lw:  # load-time fused gate|up projection
        gu = matmul(x, lw["ffn_gateup"], kernels=kernels)
        half = gu.shape[-1] // 2
        h = swiglu(gu[..., :half], gu[..., half:])
    else:
        h = swiglu(matmul(x, lw["ffn_gate"], kernels=kernels),
                   matmul(x, lw["ffn_up"], kernels=kernels))
    return matmul(h, lw["ffn_down"], kernels=kernels)


def forward(params: dict[str, Any], cfg: ModelConfig, tokens: torch.Tensor,
            inputs: AttnInputs, kv: PagedKVCache, output_rows: torch.Tensor | None = None,
            kernels: bool = True) -> torch.Tensor:
    """tokens [B, T] -> logits [M or B*T, vocab] f32; writes the KV pool in
    place."""
    cdtype = cfg.compute_dtype
    x = embed_lookup(params["token_embd"], tokens.long(), dtype=cdtype)  # [B, T, E]
    for il, lw in enumerate(params["layers"]):
        h = norm(cfg, x, lw, "attn_norm")
        x = x + attention_block(cfg, lw, h, inputs, kv, il, kernels=kernels)
        h = norm(cfg, x, lw, "ffn_norm")
        x = x + ffn_block(cfg, lw, h, kernels=kernels)
    B, T, E = x.shape
    x = x.reshape(B * T, E)
    if output_rows is not None:
        x = x[output_rows]
    x = norm(cfg, x, params, "output_norm")
    out_w = params.get("output")
    if out_w is None:
        out_w = params["token_embd"]
    logits = matmul(x, out_w, dtype=torch.float32, kernels=kernels)
    if cfg.logit_scale != 1.0:
        logits = logits * cfg.logit_scale
    if cfg.final_logit_softcap:
        cap = cfg.final_logit_softcap
        logits = torch.tanh(logits / cap) * cap
    return logits
