"""Decoder transformer forward pass shared by the registry's families
(llama, mistral, qwen2/3, qwen2moe/3moe, gemma/2/3, deepseek2 with its
Multi-head Latent Attention, the families that differ from them only in
block variants: LayerNorm with biases, the non-gated FFN, parallel and
norm-after residuals, residual scales, ALiBi, NoPE layers, learned
positions; and the MoE families: gpt-oss's clamped GLU, llama4's gate on
the expert input, sparsemixer and sqrt_softplus routing, dense FFNs beside
the experts, arctic's MoE branch, GroveMoE's chunk experts; and the hybrid
families, whose layers are recurrent mixers of models/mamba.py on the
recurrent state, attention blocks (gated: qwen3next's attn_gate, qwen35's
[q | gate] wq and interleaved M-RoPE) or Nemotron-H's FFN blocks), dense or
mixture-of-experts, on the paged KV pool, the slot-table cache, the
interleaved sliding-window memory (ISWACache) or a HybridMemory.

Analog of reference llm_graph_context build_attn / build_ffn / build_moe_ffn
(src/llama-graph.h:1048-1143, src/llama-graph.cpp:1955-2075) and the llama,
qwen and gemma graphs (src/models/llama.cpp:99-247, qwen3.cpp, gemma3.cpp);
the subset of the JAX package's models/transformer.py these families take,
with its casts (bf16 activations, f32 accumulation, f32 logits; an f32 bias
promotes what it is added to, as in the JAX package).
"""

from __future__ import annotations

import math
from dataclasses import replace
from typing import Any, NamedTuple

import torch

# silu stays importable from this module, where the llama graph kept it
from ..ops.basic import ACTIVATIONS, layer_norm, rms_norm, silu, xielu  # noqa: F401
from ..ops.kernels import flash_attn as fa_kernel
from ..ops.kernels import qmm_expert as expert_kernel
from ..ops.qtensor import QuantTensor, Weight, dot_f32, embed_lookup, matmul
from ..ops.rope import ROPE_TYPE_NONE, RopeParams, apply_mrope, apply_rope
from ..runtime.kv_cache import ISWACache, KVCache
from ..runtime.memory import DSAMemory, HybridMemory
from ..runtime.paged_kv import PagedKVCache
from . import mamba
from .config import ModelConfig


class AttnInputs(NamedTuple):
    """Per-step attention metadata, batched [B, T]: each batch row maps to
    one KV sequence; padding tokens carry a negative position and write to
    the pool's trash row."""

    seq_idx: torch.Tensor  # [B] cache sequence per batch row
    positions: torch.Tensor  # [B, T] rope/causal position (< 0 = pad)


Memory = PagedKVCache | KVCache | ISWACache | HybridMemory | DSAMemory


def norm(cfg: ModelConfig, x: torch.Tensor, w: dict[str, Weight], key: str) -> torch.Tensor:
    """RMSNorm or LayerNorm (with key + "_bias" where the file has one) per
    cfg.use_rms_norm; a weightless norm is the one whose tensors are absent
    (the JAX package's transformer.py:63-67)."""
    if cfg.use_rms_norm:
        return rms_norm(x, w.get(key), cfg.rms_eps)
    return layer_norm(x, w.get(key), w.get(key + "_bias"), cfg.norm_eps)


def alibi_slopes(n_heads: int, max_bias: float, device=None) -> torch.Tensor:
    """ggml soft_max_ext's ALiBi slope of each head [H] f32 (the JAX
    package's transformer.py:70-80): powers of m0 over the largest power of
    two of heads, odd powers of m1 for the rest. Made on `device` in f64
    (no host copy, so a decode step that adds them can be captured)."""
    n2 = 1 << (n_heads.bit_length() - 1)
    m0 = 2.0 ** (-max_bias / n2)
    m1 = 2.0 ** (-(max_bias / 2.0) / n2)
    h = torch.arange(n_heads, dtype=torch.float64, device=device)
    return torch.where(h < n2, m0 ** (h + 1), m1 ** (2 * (h - n2) + 1)).float()


def _add_bias(y: torch.Tensor, lw: dict[str, Weight], key: str) -> torch.Tensor:
    return y + lw[key] if key in lw else y


def _rope_params(cfg: ModelConfig, il: int) -> RopeParams:
    """Layer il's rope: gemma3's SWA layers take their own base at scale 1,
    its full layers the metadata's base and (linear) scaling; laguna's SWA
    layers rope their own dimension count (rope_dims_swa) without YaRN
    (the JAX package's transformer.py:95-125)."""
    base, scale = cfg.rope_freq_base, cfg.rope_freq_scale
    dims, ext = cfg.rope_dims, cfg.rope_ext_factor
    # gemma4's proportional rope: rope_freqs divides the full layers' only
    factors = cfg.extra.get("rope_factors_arr")
    if cfg.is_swa_layer(il):
        if cfg.extra.get("rope_factors_full_only"):
            factors = None
        if cfg.extra.get("rope_freq_base_swa"):
            base = cfg.extra["rope_freq_base_swa"]
            scale = cfg.extra.get("rope_freq_scale_swa", 1.0)
        if cfg.extra.get("rope_dims_swa"):
            dims, ext = cfg.extra["rope_dims_swa"], 0.0
    return RopeParams(
        freq_factors=factors,
        rope_type=cfg.rope_type,
        n_dims=dims,
        freq_base=base,
        freq_scale=scale,
        ext_factor=ext,
        attn_factor=cfg.rope_attn_factor,
        beta_fast=cfg.rope_beta_fast,
        beta_slow=cfg.rope_beta_slow,
        orig_ctx=cfg.rope_orig_ctx,
    )


def layer_heads(cfg: ModelConfig, il: int) -> tuple[int, int]:
    """Layer il's (query heads, KV heads): the per-layer head arrays where
    the family has them (deci), else the config's. The KV memory holds
    cfg.n_kv_heads, the arrays' largest."""
    ha, hka = cfg.extra.get("n_head_arr"), cfg.extra.get("n_head_kv_arr")
    return (cfg.n_heads if ha is None else int(ha[il]),
            cfg.n_kv_heads if hka is None else int(hka[il]))


def class_head_dims(cfg: ModelConfig, il: int) -> tuple[int, int]:
    """Layer il's (K, V) head dims: gemma4's window layers run narrower
    heads (head_dim_k_swa / head_dim_v_swa), every other layer the
    config's."""
    if cfg.extra.get("head_dim_k_swa") and cfg.is_swa_layer(il):
        dk = int(cfg.extra["head_dim_k_swa"])
        return dk, int(cfg.extra.get("head_dim_v_swa", dk))
    return cfg.head_dim_k, cfg.head_dim_v


def kv_source(cfg: ModelConfig, il: int) -> int:
    """The layer whose KV lines layer il attends: its own, or for a shared
    layer (gemma3n, gemma4: kv_reuse[il] >= 0) the last owned layer of its
    window class, which it neither projects nor writes."""
    reuse = cfg.extra.get("kv_reuse")
    return int(reuse[il]) if reuse is not None and int(reuse[il]) >= 0 else il


def attention_block(cfg: ModelConfig, lw: dict[str, Weight], x: torch.Tensor,
                    inputs: AttnInputs, kv: Memory, il: int,
                    kernels: bool = True, update_pos: bool | None = None) -> torch.Tensor:
    """Plain GQA attention over the paged pool, the slot-table cache or the
    ISWA memory's sub-cache of layer il (its full layers on the pool or a
    slot table, its SWA layers on a ring); writes this step's K/V rows in
    place, and the position labels where update_pos says (by default on
    the memory's first layer). kernels=False takes the gather + einsum path
    everywhere. Gated attention: qwen35's wq emits per-head [q | gate] pairs
    (q_gate_interleaved), qwen3next's gate is its own projection attn_gate;
    either gate's sigmoid scales the attention output before attn_output;
    laguna's attn_gate takes a softplus instead, per head or per element.
    Gemma 3n/4: a shared layer (kv_source) projects q alone and attends its
    source's lines; a layer without attn_v takes V from the raw K
    projection; v_rms_norm norms V per head without a weight; the window
    layers may have their own head dims (class_head_dims). MiniMax-M3's MSA
    layers (indexer_q_proj, on a DSAMemory) select key blocks per GQA group
    from the indexer's scores and attend on the einsum path; its dense-lead
    layers attend the DSAMemory's slot table as any layer does."""
    B, T = x.shape[:2]
    H, Hkv = layer_heads(cfg, il)
    Dk, Dv = class_head_dims(cfg, il)
    mem = kv if isinstance(kv, DSAMemory) else None
    if mem is not None:
        kv = mem.kv
    src_il = kv_source(cfg, il)
    shared = src_il != il

    k = v = None
    if shared:
        q = _add_bias(matmul(x, lw["attn_q"], kernels=kernels), lw, "attn_q_bias")
    elif "attn_qkv" in lw:
        qkv = _add_bias(matmul(x, lw["attn_qkv"], kernels=kernels), lw, "attn_qkv_bias")
        q = qkv[..., : H * Dk]
        k = qkv[..., H * Dk: H * Dk + Hkv * Dk]
        v = qkv[..., H * Dk + Hkv * Dk:]
    elif "attn_qk" in lw:  # q+k fused, v standalone (Q4_K_M's Q6_K attn_v)
        qk = _add_bias(matmul(x, lw["attn_qk"], kernels=kernels), lw, "attn_qk_bias")
        q = qk[..., : H * Dk]
        k = qk[..., H * Dk:]
        v = _add_bias(matmul(x, lw["attn_v"], kernels=kernels), lw, "attn_v_bias")
    else:
        q = _add_bias(matmul(x, lw["attn_q"], kernels=kernels), lw, "attn_q_bias")
        k_raw = matmul(x, lw["attn_k"], kernels=kernels)
        # gemma4's alternative attention: no attn_v, V is the raw K projection
        v = (_add_bias(matmul(x, lw["attn_v"], kernels=kernels), lw, "attn_v_bias")
             if "attn_v" in lw else k_raw)
        k = _add_bias(k_raw, lw, "attn_k_bias")

    gate_q = None
    if cfg.extra.get("q_gate_interleaved") and q.shape[-1] == 2 * H * Dk:
        qg = q.reshape(B, T, H, 2 * Dk)
        q = qg[..., :Dk].reshape(B, T, H * Dk)
        gate_q = qg[..., Dk:].reshape(B, T, H * Dk)

    clamp = cfg.extra.get("clamp_kqv", 0.0)
    if clamp:  # olmo/dbrx: the projected q, k, v clamped
        q = torch.clamp(q, -clamp, clamp)
        if k is not None:
            k, v = torch.clamp(k, -clamp, clamp), torch.clamp(v, -clamp, clamp)
    full_norm = cfg.qk_norm and cfg.extra.get("qk_norm_full", False)
    if full_norm:  # olmo2/olmoe: RMSNorm over the whole projection
        q = rms_norm(q, lw.get("attn_q_norm"), cfg.rms_eps)
        if k is not None:
            k = rms_norm(k, lw.get("attn_k_norm"), cfg.rms_eps)
    q = q.reshape(B, T, H, Dk)
    if k is not None:
        k = k.reshape(B, T, Hkv, Dk)
        v = v.reshape(B, T, Hkv, Dv)
        if cfg.extra.get("v_rms_norm"):  # gemma3n/gemma4: V normed per head, no weight
            v = rms_norm(v, None, cfg.rms_eps)
    after_rope = cfg.extra.get("qk_norm_after_rope", False)
    if cfg.qk_norm and cfg.extra.get("qk_layernorm"):  # chameleon: LayerNorm with bias
        q = layer_norm(q, lw.get("attn_q_norm"), lw.get("attn_q_norm_bias"), cfg.norm_eps)
        if k is not None:
            k = layer_norm(k, lw.get("attn_k_norm"), lw.get("attn_k_norm_bias"), cfg.norm_eps)
    elif cfg.qk_norm and not full_norm and not after_rope:  # per head, before rope
        q = rms_norm(q, lw.get("attn_q_norm"), cfg.rms_eps)
        if k is not None:
            k = rms_norm(k, lw.get("attn_k_norm"), cfg.rms_eps)
    roped = cfg.rope_type != ROPE_TYPE_NONE and il not in cfg.extra.get("no_rope_layers", ())
    if roped:
        rp = _rope_params(cfg, il)
        sections = cfg.extra.get("mrope_sections")
        if sections:
            # interleaved M-RoPE (qwen35's imrope): a text row's position
            # drives the three t/h/w streams
            pos3 = inputs.positions[None].expand(3, *inputs.positions.shape)
            q = apply_mrope(q, pos3, sections, rp)
            if k is not None:
                k = apply_mrope(k, pos3, sections, rp)
        else:
            q = apply_rope(q, inputs.positions, rp)
            if k is not None:
                k = apply_rope(k, inputs.positions, rp)
    if cfg.qk_norm and after_rope and roped:  # hunyuan: per head, after rope
        q = rms_norm(q, lw.get("attn_q_norm"), cfg.rms_eps)
        if k is not None:
            k = rms_norm(k, lw.get("attn_k_norm"), cfg.rms_eps)

    # position-addressed write of the [B, T] token grid (SET_ROWS analog);
    # the ISWA memory's sub-caches each write their position labels on
    # their own first layer; a shared layer writes nothing
    seq_flat = inputs.seq_idx.repeat_interleave(T)
    if not shared:
        k_wr, v_wr = k.reshape(B * T, Hkv, Dk), v.reshape(B * T, Hkv, Dv)
        if Hkv != cfg.n_kv_heads:  # a layer of a head array: padded to the memory's heads
            pad = (0, 0, 0, cfg.n_kv_heads - Hkv)
            k_wr = torch.nn.functional.pad(k_wr, pad)
            v_wr = torch.nn.functional.pad(v_wr, pad)
        kv.write_layer(il, seq_flat, inputs.positions.reshape(-1), k_wr, v_wr,
                       update_pos=update_pos)
    group_sel = None
    if cfg.extra.get("msa") and "indexer_q_proj" in lw and mem is not None:
        group_sel = _msa_blocks(cfg, lw, x, inputs, mem, il, Hkv, seq_flat, kernels)
    scale = cfg.attn_scale or (1.0 / float(Dk) ** 0.5)
    window = cfg.sliding_window if cfg.is_swa_layer(il) else 0
    # the einsum path's operands follow the block input's dtype, as in the
    # JAX package: a q that a bias made f32 is rounded to bf16 there
    out = _attend(cfg, q.to(x.dtype), kv, src_il, inputs, Hkv, Dv, scale, window,
                  lw.get("attn_sinks"), kernels, group_sel).to(x.dtype)
    if "attn_sub_norm" in lw:  # bitnet: the attention output normed before attn_output
        out = rms_norm(out, lw["attn_sub_norm"], cfg.rms_eps)
    if gate_q is not None:
        out = out * torch.sigmoid(gate_q.float()).to(out.dtype)
    if "attn_gate" in lw:  # per element, or per head when it is n_heads wide
        g = matmul(x, lw["attn_gate"], dtype=torch.float32, kernels=kernels)
        # laguna's gate is a softplus, qwen3next's and afmoe's a sigmoid
        g = (torch.nn.functional.softplus(g) if cfg.extra.get("attn_gate_fn") == "softplus"
             else torch.sigmoid(g))
        if g.shape[-1] == H and H * Dv != H:
            out = (out.reshape(B, T, H, Dv) * g[..., None].to(out.dtype)).reshape(B, T, H * Dv)
        else:
            out = out * g.to(out.dtype)
    return _add_bias(matmul(out, lw["attn_output"], kernels=kernels), lw, "attn_output_bias")


def _msa_blocks(cfg: ModelConfig, lw: dict[str, Weight], x: torch.Tensor, inputs: AttnInputs,
                mem: DSAMemory, il: int, Hkv: int, seq_flat: torch.Tensor,
                kernels: bool) -> torch.Tensor:
    """MiniMax-M3's index branch (reference minimax-m3.cpp:100-120; the JAX
    package's transformer.py:312-335): a per-GQA-group indexer query and
    one indexer key a token, each rms-normed and roped, the key written to
    the DSAMemory's indexer cache at the token's position; scores over
    every cached key (causal), max-pooled over blocks of
    indexer_block_size, the indexer_local_blocks blocks ending at the
    query's own forced in, then the top indexer_top_k blocks of each
    (token, group) -> the selected keys [B, Hkv, T, S] bool. The indexer
    cache labels its positions on every MSA layer (the same labels each
    time), so a model whose first layers are dense-lead ones labels them
    too."""
    B, T = x.shape[:2]
    Di = cfg.extra["indexer_head_size"]
    blk = cfg.extra["indexer_block_size"]
    local = cfg.extra.get("indexer_local_blocks", 1)
    rp = _rope_params(cfg, il)
    iq = matmul(x, lw["indexer_q_proj"], kernels=kernels).reshape(B, T, Hkv, Di)
    ik = matmul(x, lw["indexer_k_proj"], kernels=kernels).reshape(B, T, 1, Di)
    iq = apply_rope(rms_norm(iq, lw.get("indexer_q_norm"), cfg.rms_eps), inputs.positions, rp)
    ik = apply_rope(rms_norm(ik, lw.get("indexer_k_norm"), cfg.rms_eps), inputs.positions, rp)
    idx = mem.idx
    idx.write_layer(il, seq_flat, inputs.positions.reshape(-1), ik.reshape(B * T, 1, Di),
                    ik.new_zeros((B * T, 1, idx.v[il].shape[-1])), update_pos=True)
    ik_all = idx.read(il, inputs.seq_idx, dtype=idx.k[il].dtype)[0][:, 0]  # [B, S, Di]
    ipos = idx.pos[inputs.seq_idx.long()].long()  # [B, S]: slot == position
    pos = inputs.positions.long()
    sc = torch.einsum("bthd,bsd->bhts", iq.float(), ik_all.float())
    keep = (ipos >= 0)[:, None, None, :] & (ipos[:, None, None, :] <= pos[:, None, :, None])
    sc = sc.masked_fill(~keep, float("-inf"))
    S = sc.shape[-1]
    nblk = S // blk
    bs = sc.reshape(B, Hkv, T, nblk, blk).amax(dim=-1)  # [B, Hkv, T, nblk]
    qblk = torch.div(pos, blk, rounding_mode="floor")  # [B, T]
    bi = torch.arange(nblk, device=x.device)
    is_local = (bi[None, None] <= qblk[:, :, None]) & (bi[None, None] > qblk[:, :, None] - local)
    bs = bs + torch.where(is_local[:, None], 1e30, 0.0)
    top = _top_k(bs, min(cfg.extra["indexer_top_k"], nblk))  # [B, Hkv, T, k]
    sel = torch.zeros_like(bs, dtype=torch.bool).scatter_(-1, top, True)
    return sel.repeat_interleave(blk, dim=-1)  # [B, Hkv, T, S]


def _attend(cfg: ModelConfig, q: torch.Tensor, kv: Memory, il: int, inputs: AttnInputs,
            Hkv: int, Dv: int, scale: float, window: int, sinks, kernels: bool,
            group_sel: torch.Tensor | None = None) -> torch.Tensor:
    """q [B, T, H, Dk] over layer il's cached K/V (Hkv heads, V rows of Dv)
    -> [B, T, H * Dv]: the attention kernel where the JAX package runs its
    own (f32 out), else gather + einsum in the compute dtype. group_sel
    [B, Hkv, T, S] (MSA's selected keys) takes the einsum path, as in the
    JAX package."""
    B, T, H, Dk = q.shape
    kvc, li = kv.layer_view(il)
    # the kernel path needs a card, as the JAX package's needs a TPU; where
    # the JAX package would run its kernel, the port's runs or raises
    paged = isinstance(kvc, PagedKVCache)
    n_slots = kvc.max_pages * kvc.page if paged else kvc.n_slots
    # a layer of a head array (deci) with fewer KV heads than the memory's
    # takes the einsum path over its own heads, as in the JAX package
    cache_heads = kvc.k[li].shape[0 if paged else 1]
    # ALiBi and non-causal layers take the einsum path, as the JAX package
    # keeps them from its kernels (transformer.py:375-378): the kernels know
    # no slopes and mask causally
    non_causal = cfg.extra.get("non_causal", False)
    use_flash = (kernels and q.device.type == "cuda" and cfg.alibi_bias == 0.0
                 and not non_causal and Hkv == cache_heads and group_sel is None
                 and fa_kernel.dispatches(Dk, Dv, n_slots, T * (H // Hkv)))
    if use_flash:
        # the slot-table kernel takes the cache and seq_idx as they are: no
        # per-step gather of the sequences' cache rows; a ring visits every
        # tile (its slot order is not position order)
        mha = fa_kernel.mha_flash_paged if paged else fa_kernel.mha_flash
        return mha(q.to(torch.bfloat16), kvc, li, inputs.seq_idx, inputs.positions,
                   sm_scale=scale, window=window, softcap=cfg.attn_logit_softcap,
                   sinks=None if sinks is None else sinks.float())
    if paged:
        k_seq, v_seq, slot_pos = kvc.gather_seq(li, inputs.seq_idx)
    else:
        k_seq, v_seq = kvc.read(li, inputs.seq_idx)  # [B, Hkv, S, D]
        slot_pos = kvc.pos[inputs.seq_idx.long()]  # [B, S]
    if Hkv != cache_heads:  # drop this layer's pad heads
        k_seq, v_seq = k_seq[:, :Hkv], v_seq[:, :Hkv]
    pos = inputs.positions.long()
    slot_pos = slot_pos.long()
    mask = (slot_pos >= 0)[:, None, :]
    if not non_causal:  # a non-causal layer (gemma-embedding) sees every valid slot
        mask = mask & (slot_pos[:, None, :] <= pos[:, :, None])
    if window > 0 and non_causal:  # the symmetric window: |p1 - p0| <= window / 2
        mask = mask & ((slot_pos[:, None, :] - pos[:, :, None]).abs() <= window // 2)
    elif window > 0:
        mask = mask & (slot_pos[:, None, :] > pos[:, :, None] - window)
    groups = H // Hkv
    mdt = torch.float32 if q.dtype == torch.float32 else torch.bfloat16
    qg = q.reshape(B, T, Hkv, groups, Dk).to(mdt).float()
    scores = torch.einsum("btkgd,bksd->bkgts", qg, k_seq.to(mdt).float()) * scale
    if cfg.alibi_bias > 0.0:  # slope * (key position - query position), <= 0 when causal
        slopes = alibi_slopes(H, cfg.alibi_bias, q.device).reshape(1, Hkv, groups, 1, 1)
        delta = (slot_pos[:, None, :] - pos[:, :, None]).float()  # [B, T, S]
        scores = scores + slopes * delta[:, None, None]
    if cfg.attn_logit_softcap:
        cap = cfg.attn_logit_softcap
        scores = torch.tanh(scores / cap) * cap
    scores = scores.masked_fill(~mask[:, None, None], float("-inf"))
    if group_sel is not None:  # MSA: each GQA group's selected key blocks
        scores = scores.masked_fill(~group_sel[:, :, None], float("-inf"))
    if sinks is not None:
        sink_col = sinks.float().reshape(1, Hkv, groups, 1, 1).expand(*scores.shape[:-1], 1)
        probs = torch.softmax(torch.cat([scores, sink_col], dim=-1), dim=-1)[..., :-1]
    else:
        probs = torch.softmax(scores, dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)  # fully-masked rows
    out = torch.einsum("bkgts,bksd->btkgd", probs.to(mdt).float(), v_seq.to(mdt).float())
    return out.reshape(B, T, H * Dv)


def mla_kq_scale(cfg: ModelConfig) -> float:
    """DeepSeek's YaRN-corrected attention scale mscale^2 / sqrt(Dk)
    (reference deepseek2.cpp:26-28), Dk the naive head's (qk_nope + qk_rope),
    not the absorbed cache's; 1 / sqrt(Dk) without YaRN."""
    mscale = 1.0
    if cfg.rope_ext_factor > 0.0 and cfg.rope_freq_scale != 1.0:
        log_mul = cfg.extra.get("yarn_log_mul", 0.0)
        ln = math.log(1.0 / cfg.rope_freq_scale)
        mscale = cfg.rope_attn_factor * (1.0 + 0.1 * ln) * (1.0 + 0.1 * log_mul * ln)
    return mscale * mscale / float(cfg.head_dim_k) ** 0.5


def mla_attention_block(cfg: ModelConfig, lw: dict[str, Weight], x: torch.Tensor,
                        inputs: AttnInputs, kv: Memory, il: int,
                        kernels: bool = True, update_pos: bool | None = None) -> torch.Tensor:
    """DeepSeek-2 Multi-head Latent Attention (reference
    src/models/deepseek2.cpp; the JAX package's transformer.py:510-784): q
    from the q-LoRA (attn_q_a, its norm, attn_q_b) or the lite attn_q; the
    shared latent kv_pe = x @ attn_kv_a_mqa, its first kv_lora_rank dims
    rms-normed into c_kv, rope on the tail n_rot dims (q_pe, k_pe) only.
    With mla_k_b/mla_v_b (the loader's split of attn_kv_b) the absorbed
    path: one cached KV head K = [c_kv | 0-pad | k_pe], V = c_kv, q =
    [q_nope @ W_UK | 0 | q_pe], and W_UV applied to the latent output;
    without them the naive expansion of attn_kv_b into H heads of K and V."""
    B, T = x.shape[:2]
    H = cfg.n_heads
    Dk, Dv = cfg.head_dim_k, cfg.head_dim_v
    n_rot = cfg.rope_dims
    nope = Dk - n_rot
    C = cfg.extra["kv_lora_rank"]
    if "attn_q_a" in lw:
        qr = rms_norm(matmul(x, lw["attn_q_a"], kernels=kernels), lw.get("attn_q_a_norm"),
                      cfg.rms_eps)
        q = matmul(qr, lw["attn_q_b"], kernels=kernels)
    else:
        q = matmul(x, lw["attn_q"], kernels=kernels)
    q = q.reshape(B, T, H, Dk)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    kv_pe = matmul(x, lw["attn_kv_a_mqa"], kernels=kernels)  # [B, T, C + n_rot]
    c_kv = rms_norm(kv_pe[..., :C], lw.get("attn_kv_a_norm"), cfg.rms_eps)
    k_pe = kv_pe[..., C:].reshape(B, T, 1, n_rot)
    if cfg.rope_type != ROPE_TYPE_NONE:
        rp = replace(_rope_params(cfg, il), n_dims=n_rot)
        q_pe = apply_rope(q_pe, inputs.positions, rp)
        k_pe = apply_rope(k_pe, inputs.positions, rp)
    scale = mla_kq_scale(cfg)
    seq_flat = inputs.seq_idx.repeat_interleave(T)
    if "mla_k_b" in lw:
        mdt = torch.float32 if x.dtype == torch.float32 else torch.bfloat16
        pad = cfg.extra.get("mla_pad", 0)
        q_abs = torch.einsum("bthn,chn->bthc", q_nope.to(mdt).float(),
                             lw["mla_k_b"].to(mdt).float()).to(x.dtype)
        zq = q_abs.new_zeros((B, T, H, pad))
        qf = torch.cat([q_abs, zq, q_pe.to(x.dtype)], dim=-1)  # [B, T, H, C + pad + n_rot]
        kf = torch.cat([c_kv[:, :, None, :].to(x.dtype), zq[:, :, :1], k_pe.to(x.dtype)],
                       dim=-1)  # [B, T, 1, C + pad + n_rot]
        Dc = qf.shape[-1]
        kv.write_layer(il, seq_flat, inputs.positions.reshape(-1), kf.reshape(B * T, 1, Dc),
                       c_kv.to(x.dtype).reshape(B * T, 1, C), update_pos=update_pos)
        out_lat = _attend(cfg, qf, kv, il, inputs, 1, C, scale, 0, None, kernels)
        out = torch.einsum("bthc,chd->bthd", out_lat.reshape(B, T, H, C).to(mdt).float(),
                           lw["mla_v_b"].to(mdt).float())
        out = out.reshape(B, T, H * Dv).to(x.dtype)
    else:
        kv_dec = matmul(c_kv, lw["attn_kv_b"], kernels=kernels).reshape(B, T, H, nope + Dv)
        v = kv_dec[..., nope:]
        qf = torch.cat([q_nope, q_pe.to(q_nope.dtype)], dim=-1)
        kf = torch.cat([kv_dec[..., :nope], k_pe.to(kv_dec.dtype).expand(B, T, H, n_rot)],
                       dim=-1)
        kv.write_layer(il, seq_flat, inputs.positions.reshape(-1), kf.reshape(B * T, H, Dk),
                       v.reshape(B * T, H, Dv), update_pos=update_pos)
        out = _attend(cfg, qf, kv, il, inputs, H, Dv, scale, 0, None, kernels).to(x.dtype)
    return matmul(out, lw["attn_output"], kernels=kernels)


def ffn_block(cfg: ModelConfig, lw: dict[str, Weight], x: torch.Tensor,
              kernels: bool = True, il: int = -1) -> torch.Tensor:
    """Gated FFN (SwiGLU, GeGLU): act(gate) * up in the activation dtype; or,
    with cfg.glu off, act(up) (GELU, ReLU^2, apertus' xIELU with layer il's
    scalars, in f32); each projection plus its bias where the file has one,
    bitnet's ffn_sub_norm before ffn_down (the JAX package's
    transformer.py:792-826)."""
    if cfg.act == "xielu":
        an, ap, beta, eps = (cfg.extra["xielu"][k][il] for k in ("alpha_n", "alpha_p", "beta",
                                                                 "eps"))

        def act(v):
            return xielu(v.float(), an, ap, beta, eps).to(v.dtype)
    else:
        act = ACTIVATIONS[cfg.act]
    if "ffn_gateup" in lw:  # load-time fused gate|up projection
        gu = matmul(x, lw["ffn_gateup"], kernels=kernels)
        half = gu.shape[-1] // 2
        h = act(gu[..., :half]) * gu[..., half:]
    else:
        up = _add_bias(matmul(x, lw["ffn_up"], kernels=kernels), lw, "ffn_up_bias")
        if cfg.glu:
            gate = _add_bias(matmul(x, lw["ffn_gate"], kernels=kernels), lw, "ffn_gate_bias")
            h = act(gate) * up
        else:
            h = act(up)
    if "ffn_sub_norm" in lw:
        h = rms_norm(h, lw["ffn_sub_norm"], cfg.rms_eps)
    return _add_bias(matmul(h, lw["ffn_down"], kernels=kernels), lw, "ffn_down_bias")


def swiglu_oai(g: torch.Tensor, u: torch.Tensor, alpha: float = 1.702,
               limit: float = 7.0) -> torch.Tensor:
    """gpt-oss's clamped GLU (reference ggml swiglu_oai; the JAX package's
    transformer.py:831-836): min(g, L) * sigmoid(alpha * min(g, L)) *
    (clamp(u, -L, L) + 1)."""
    g = torch.clamp(g, max=limit)
    u = torch.clamp(u, -limit, limit)
    return g * torch.sigmoid(alpha * g) * (u + 1.0)


def _glu(cfg: ModelConfig, g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """An expert's hidden from its gate and up products (biases added)."""
    return swiglu_oai(g, u) if cfg.moe_act == "swiglu_oai" else ACTIVATIONS[cfg.act](g) * u


def _sparsemixer_route(logits: torch.Tensor, eps: float):
    """PhiMoE's sparsemixer at inference (the JAX package's
    transformer.py:1073-1093): two masked-argmax picks, the second over the
    logits with the first's expert masked out; each pick's weight is the
    softmax, at the picked expert, over the experts within the jitter of the
    best. -> (topi [..., 2], topw [..., 2] f32), neither normalised nor
    scaled."""

    def pick(scores):
        mx = scores.max(dim=-1, keepdim=True).values
        factor = torch.maximum(logits.abs(), mx)
        masked = torch.where((mx - scores) / factor > 2 * eps,
                             torch.full_like(scores, float("-inf")), scores)
        idx = torch.argmax(scores, dim=-1)  # the first maximum, as jnp.argmax
        wgt = torch.gather(torch.softmax(masked, dim=-1), -1, idx[..., None])[..., 0]
        return idx, wgt

    i1, w1 = pick(logits)
    first = torch.nn.functional.one_hot(i1, logits.shape[-1]).bool()
    i2, w2 = pick(logits.masked_fill(first, float("-inf")))
    return torch.stack([i1, i2], dim=-1), torch.stack([w1, w2], dim=-1).float()


def _top_k(sel: torch.Tensor, k: int) -> torch.Tensor:
    """The k largest indices in descending order; a stable sort takes the
    lower index first on a tie, as jax.lax.top_k does (torch.topk promises
    no order)."""
    return torch.sort(sel, dim=-1, descending=True, stable=True).indices[..., :k]


# An observer of the top-k routers, for checks that hold two paths' choices
# together (testing.RouteHold): called as route_hook(router input, f32
# selection scores, topi) at every top-k choice, it returns the expert ids to
# take (topi itself, or others). None in normal use.
route_hook = None


def _route(cfg: ModelConfig, lw: dict[str, Weight], x: torch.Tensor, kernels: bool,
           router_x: torch.Tensor | None = None):
    """Router -> (topi [..., k] expert ids, topw [..., k] f32 mix weights):
    logits (+bias) of x (or of router_x: smallthinker routes on the raw
    residual stream) -> gating -> optional selection bias -> top-k
    (route_hook) -> weight post-processing (softmax over the k / norm /
    scale); sparsemixer picks and weighs on its own."""
    x_in = x if router_x is None else router_x
    logits = matmul(x_in, lw["ffn_gate_inp"], dtype=torch.float32, kernels=kernels)
    if "ffn_gate_inp_bias" in lw:
        logits = logits + lw["ffn_gate_inp_bias"].float()
    gating = cfg.expert_gating
    if gating == "sparsemixer":
        return _sparsemixer_route(logits, cfg.extra.get("router_jitter", 0.01))
    if gating == "softmax":
        probs = torch.softmax(logits, dim=-1)
    elif gating == "sigmoid":
        probs = torch.sigmoid(logits)
    elif gating == "softmax_weight":
        probs = logits  # softmax over the selected k below
    elif gating == "sqrt_softplus":
        probs = torch.sqrt(torch.logaddexp(logits, torch.zeros_like(logits)))
    else:
        raise NotImplementedError(f"expert gating {gating!r} is not ported")
    # an expert-selection bias moves the top-k choice only, not the weights
    sel = probs + lw["exp_probs_b"].float() if "exp_probs_b" in lw else probs
    topi = _top_k(sel, cfg.n_expert_used)
    if route_hook is not None:
        topi = route_hook(x_in, sel, topi)
    topw = torch.gather(probs, -1, topi)
    if gating == "softmax_weight":
        topw = torch.softmax(topw, dim=-1)
    if cfg.expert_weights_norm:
        topw = topw / torch.clamp(topw.sum(dim=-1, keepdim=True), min=6.103515625e-5)
    return topi, topw * cfg.expert_weights_scale


def _dequant_experts(w: Weight, idx: torch.Tensor | slice, dtype) -> torch.Tensor:
    """Gather + dequantize expert slices idx ([M] or a slice) -> [M, in, out], in `dtype`
    arithmetic (q and scale cast to it, product and min-add rounded in it),
    as the JAX package's gather and ragged routes do outside its kernel."""
    if isinstance(w, QuantTensor):
        if not w.transposed or w.packed or w.hier:
            raise ValueError("expert stacks are transposed int8 planes with flat scales")
        q = w.q[idx].to(dtype)  # [M, K, O]
        M, K, O = q.shape
        g = w.group
        wd = (q.reshape(M, K // g, g, O) * w.scales[idx].to(dtype)[:, :, None, :])
        wd = wd.reshape(M, K, O)
        if w.mins is not None:
            wd = wd + w.mins[idx].to(dtype).repeat_interleave(g, dim=1)
        return wd
    return w[idx].to(dtype).transpose(1, 2)  # dense [E, out, in]


def _moe_expert_mm(w: Weight, h: torch.Tensor, idx: torch.Tensor, mdt, kernels: bool):
    """h [R, a] . W[idx[r]] per row -> [R, b] f32. On the card, where the
    JAX package runs its indexed-expert kernel (stacked transposed planes),
    the port's kernel runs or raises; elsewhere gather + dequantize + a
    batched product, as the JAX package does off its accelerator."""
    if (kernels and h.device.type == "cuda" and isinstance(w, QuantTensor) and w.transposed
            and w.q.dim() == 3):
        return expert_kernel.qmm_expert(h.to(torch.bfloat16).contiguous(),
                                        idx.to(torch.int32).contiguous(), w)
    wd = _dequant_experts(w, idx, mdt)
    return torch.einsum("ma,mab->mb", h.to(mdt).float(), wd.float())


def _expert_bias(lw, name: str, idx: torch.Tensor):
    return lw[name].float()[idx] if name in lw else 0.0


EXPERT_KEYS = ("ffn_gate_exps", "ffn_up_exps", "ffn_down_exps")
CHUNK_KEYS = ("ffn_gate_chexps", "ffn_up_chexps", "ffn_down_chexps")  # GroveMoE


def _moe_gather(cfg, lw, x, topi, topw, kernels: bool, keys=EXPERT_KEYS) -> torch.Tensor:
    """Per-token gathered expert FFN for decode shapes, y = sum_j w_j *
    FFN_{e_j}(x): only the selected experts' planes are read. With
    moe_weight_before (llama4) the gate weight scales each (token, slot)
    row's input in f32 instead, and the outputs sum unweighted."""
    lead, E = x.shape[:-1], x.shape[-1]
    k = topi.shape[-1]
    xf = x.reshape(-1, E)
    N = xf.shape[0]
    idx = topi.reshape(N * k).long()
    tw = topw.reshape(N, k)
    mdt = torch.float32 if x.dtype == torch.float32 else torch.bfloat16
    gate_key, up_key, down_key = keys

    def emm(key, h):  # h [N*k, a] -> [N*k, b] f32
        return (_moe_expert_mm(lw[key], h, idx, mdt, kernels)
                + _expert_bias(lw, key + "_bias", idx))

    before = cfg.extra.get("moe_weight_before", False)
    if before:
        xk = (xf[:, None].float() * tw[:, :, None]).to(xf.dtype).reshape(N * k, E)
    else:
        xk = xf.repeat_interleave(k, dim=0)  # row n*k + j = token n
    h = _glu(cfg, emm(gate_key, xk), emm(up_key, xk))
    y = emm(down_key, h).reshape(N, k, E)
    return (y if before else y * tw[:, :, None]).sum(dim=1).reshape(*lead, E)


# weights a chunk of the per-expert route dequantizes at once: one Mixtral
# expert (4096 x 14336) alone, 64 of Qwen3-Next's 2048 x 512
RAGGED_CHUNK_WEIGHTS = 1 << 26


def _moe_ragged(cfg, lw, x, topi, topw, kernels: bool, keys=EXPERT_KEYS,
                n_expert: int | None = None) -> torch.Tensor:
    """Per-expert dispatch for prefill-sized token counts: each expert's
    three GEMMs over every token, each (token, slot) pair taking the rows of
    the expert it chose, mixed by gate weight in slot order. Where the JAX
    package leaves the segment GEMMs to XLA's ragged_dot over tokens sorted
    by expert, this visits every expert, dequantizing a chunk of experts at
    a time (at most RAGGED_CHUNK_WEIGHTS weights a projection: all eight of
    a Mixtral layer would be 2.8 GB, so it takes one; 512 small experts take
    eight chunks of 64, not 512 rounds of launches) around batched
    products, with the choice applied on the device: no segment size comes
    to the host, so a decode step can be captured in a CUDA graph. A pair's
    row is the same product as in a segment of its expert's tokens; the
    GEMMs take n_expert / top_k times the rows a segment would. With
    moe_weight_before a token's input to expert e is scaled by its weight
    for e (0 where it did not choose e), as each pair's row is in the JAX
    package's segments."""
    lead, E = x.shape[:-1], x.shape[-1]
    k = topi.shape[-1]
    xf = x.reshape(-1, E)
    N = xf.shape[0]
    tw = topw.reshape(N, k)
    chosen = topi.reshape(N, k)
    mdt = torch.float32 if x.dtype == torch.float32 else torch.bfloat16
    before = cfg.extra.get("moe_weight_before", False)
    xs = xf.to(mdt)
    gate_key, up_key, down_key = keys
    n_exp = n_expert or cfg.n_expert
    w0 = lw[gate_key]
    per_expert = (w0.q if isinstance(w0, QuantTensor) else w0)[0].numel()
    chunk = max(1, min(n_exp, RAGGED_CHUNK_WEIGHTS // per_expert))
    rows = torch.arange(N, device=x.device)[:, None]
    y = torch.zeros((N, k, E), dtype=torch.float32, device=x.device)
    for e0 in range(0, n_exp, chunk):
        sel = slice(e0, min(e0 + chunk, n_exp))
        C = sel.stop - e0
        local = chosen - e0  # [N, k]: the chosen expert's place in the chunk

        def emm(key, h):  # h [1 or C, N, a] -> [C, N, b] f32
            wd = _dequant_experts(lw[key], sel, mdt)  # [C, a, b]
            bias = lw[key + "_bias"].float()[sel][:, None, :] if key + "_bias" in lw else 0.0
            return dot_f32(h.to(mdt).expand(C, -1, -1), wd) + bias

        xe = xs[None]
        if before:  # each expert's input scaled by the token's weight for it
            ids = torch.arange(e0, sel.stop, device=x.device)[:, None, None]
            w_e = (tw[None] * (chosen[None] == ids)).sum(dim=-1, keepdim=True)  # [C, N, 1]
            xe = (xs.float()[None] * w_e).to(mdt)
        h = _glu(cfg, emm(gate_key, xe), emm(up_key, xe))
        picked = emm(down_key, h)[local.clamp(0, C - 1), rows]  # [N, k, E]
        y = torch.where(((local >= 0) & (local < C))[:, :, None], picked, y)
    out = y.sum(dim=1) if before else (y * tw[:, :, None]).sum(dim=1)
    return out.reshape(*lead, E)


def _experts(cfg, lw, x, topi, topw, kernels: bool, keys=EXPERT_KEYS,
             n_expert: int | None = None) -> torch.Tensor:
    """The routed mix on the gather route when tokens * top_k < n_expert
    (decode: the indexed-expert kernel on the card), else on the per-expert
    route -> f32."""
    n_tok = x.numel() // x.shape[-1]
    if n_tok * topi.shape[-1] < (n_expert or cfg.n_expert):
        return _moe_gather(cfg, lw, x, topi, topw, kernels, keys)
    return _moe_ragged(cfg, lw, x, topi, topw, kernels, keys, n_expert)


def moe_block(cfg: ModelConfig, lw: dict[str, Weight], x: torch.Tensor,
              kernels: bool = True, router_x: torch.Tensor | None = None) -> torch.Tensor:
    """Mixture-of-experts FFN (build_moe_ffn analog): router (on router_x
    where given), then the gather route when tokens * top_k < n_expert
    (decode: the indexed-expert kernel on the card) or the per-expert route,
    plus shared experts. Expert parallelism is not ported."""
    topi, topw = _route(cfg, lw, x, kernels, router_x)
    out = _experts(cfg, lw, x, topi, topw, kernels)
    if cfg.n_expert_shared > 0 and "ffn_gate_shexp" in lw:
        h = (ACTIVATIONS[cfg.act](matmul(x, lw["ffn_gate_shexp"], kernels=kernels))
             * matmul(x, lw["ffn_up_shexp"], kernels=kernels))
        sh = matmul(h, lw["ffn_down_shexp"], kernels=kernels).float()
        if "ffn_gate_inp_shexp" in lw:  # sigmoid-gated shared expert
            sh = sh * torch.sigmoid(matmul(x, lw["ffn_gate_inp_shexp"], dtype=torch.float32,
                                           kernels=kernels))
        out = out + sh
    return out.to(x.dtype)


def grovemoe_ffn(cfg: ModelConfig, lw: dict[str, Weight], h: torch.Tensor,
                 kernels: bool = True) -> torch.Tensor:
    """GroveMoE's adjugate experts (reference src/models/grovemoe.cpp; the
    JAX package's transformer.py:1145-1173): the router's top k drive the
    main expert mix and a second mix of per-group chunk experts over the main
    mix's output: main + expert_group_scale * chunk(main) -> f32. Each mix
    takes the gather route at decode shapes, the per-expert one above."""
    n_group = max(1, int(cfg.extra.get("n_group_experts", 1)))
    group_scale = float(cfg.extra.get("expert_group_scale", 0.05))
    n_chunk = int(cfg.extra.get("n_chunk_expert", max(1, cfg.n_expert // n_group)))
    k = cfg.n_expert_used
    probs = torch.softmax(matmul(h, lw["ffn_gate_inp"], dtype=torch.float32, kernels=kernels),
                          dim=-1)
    topi = _top_k(probs, k)
    topw = torch.gather(probs, -1, topi)
    topw = topw / torch.clamp(topw.sum(dim=-1, keepdim=True), min=1e-9)
    topw = topw * cfg.expert_weights_scale
    main = _experts(cfg, lw, h, topi, topw, kernels).to(h.dtype)
    chunk_i = torch.div(topi, n_group, rounding_mode="floor")[..., : min(k, n_chunk)]
    cw = torch.gather(probs, -1, chunk_i)
    cw = cw / torch.clamp(cw.sum(dim=-1, keepdim=True), min=1e-9)
    cw = cw * cfg.expert_weights_scale
    chunk = _experts(cfg, lw, main, chunk_i, cw, kernels, CHUNK_KEYS, n_chunk)
    return main.float() + group_scale * chunk


def _ffn(cfg: ModelConfig, lw: dict[str, Weight], h: torch.Tensor, x_in: torch.Tensor,
         kernels: bool, il: int = -1) -> torch.Tensor:
    """A layer's FFN half on its normed input h (x_in: the layer's input):
    the dense FFN, or the MoE branches of the JAX package's decoder loop
    (transformer.py:1390-1415): arctic's dense FFN plus experts on their own
    norm of the layer input, GroveMoE's chunk experts, the router on the raw
    residual (smallthinker), and a dense FFN summed with the experts (scaled
    by dense_moe_scale: grok) where the layer has both."""
    if cfg.n_expert <= 0 or "ffn_gate_exps" not in lw:
        return ffn_block(cfg, lw, h, kernels=kernels, il=il)
    if "ffn_norm_exps" in lw:
        moe_in = rms_norm(x_in, lw["ffn_norm_exps"], cfg.rms_eps)
        return ffn_block(cfg, lw, h, kernels=kernels).float() + moe_block(cfg, lw, moe_in,
                                                                           kernels=kernels)
    if "ffn_up_chexps" in lw:
        return grovemoe_ffn(cfg, lw, h, kernels=kernels)
    rx = x_in if cfg.extra.get("router_raw_input") else None
    ff = moe_block(cfg, lw, h, kernels=kernels, router_x=rx)
    if "ffn_gate" in lw or "ffn_gateup" in lw:
        ff = ff + ffn_block(cfg, lw, h, kernels=kernels)
        ds = cfg.extra.get("dense_moe_scale", 1.0)
        if ds != 1.0:
            ff = ff * ds
    return ff


def first_attention_layer(cfg: ModelConfig, layers: list[dict[str, Weight]]) -> int:
    """The layer whose attention writes the position labels: the first that
    attends (an SSM mixer, Falcon-H1's, may attend beside it; KDA's
    attn_output is its mixer's own), 0 when none does. The JAX package
    takes the first layer that is no recurrent mixer (transformer.py
    :1253-1254), which on Nemotron-H's pattern M-M-... is an FFN block (and
    on a deci stack that opens with a linear-attention or dummy layer, that
    layer), so its attention layers never label their rows; the two agree
    wherever an attention layer comes first."""
    attends = (None,) + mamba.SSM_MIXERS
    projects = ("attn_q", "attn_qk", "attn_qkv", "attn_kv_a_mqa")  # not deci's linear layers
    return next((i for i, lw in enumerate(layers)
                 if "attn_output" in lw and any(k in lw for k in projects)
                 and mamba.mixer_of(cfg, lw) in attends), 0)


def _mixer_less_ffn(cfg: ModelConfig, lw: dict[str, Weight], h: torch.Tensor,
                    kernels: bool, il: int = -1) -> torch.Tensor:
    """Nemotron-H's FFN block (reference nemotron-h.cpp build_ffn_layer) and
    deci's attention-free layer: the dense FFN on the block norm, or the
    experts with an ungated shared expert (up -> act -> down) beside them
    (the JAX package's transformer.py:1268-1290)."""
    if cfg.n_expert > 0 and "ffn_gate_exps" in lw:
        ff = moe_block(cfg, lw, h, kernels=kernels)
        if "ffn_up_shexp" in lw and "ffn_gate_shexp" not in lw:
            hsh = ACTIVATIONS[cfg.act](matmul(h, lw["ffn_up_shexp"], kernels=kernels))
            ff = ff + matmul(hsh, lw["ffn_down_shexp"], kernels=kernels).to(ff.dtype)
        return ff.to(h.dtype)
    return ffn_block(cfg, lw, h, kernels=kernels, il=il)


def _linear_attention(lw: dict[str, Weight]) -> bool:
    """deci's "linear attention" layer (heads > 0, KV heads 0): attn_output
    alone, no q/k/v and no KV."""
    return "attn_output" in lw and not any(k in lw for k in ("attn_q", "attn_qk", "attn_qkv"))


def forward(params: dict[str, Any], cfg: ModelConfig, tokens: torch.Tensor,
            inputs: AttnInputs, kv: Memory,
            output_rows: torch.Tensor | None = None, kernels: bool = True,
            return_hidden: bool = False, tap=None) -> torch.Tensor:
    """tokens [B, T] -> logits [M or B*T, vocab] f32, or with return_hidden
    the hidden rows after output_norm in the compute dtype (Context.embed);
    writes the memory in place. tap (Context.decode(aux=True)), where given,
    is called as tap(layer, x) with each layer's input x [B, T, E] and, at
    layer n_layers, the pre-output-norm row. A control vector (params["cvec"]) is added
    to the residual after each layer; LoRA-wrapped weights take their base's
    route in matmul.
    On a HybridMemory each layer is what its weights say (the JAX package's
    decoder loop, transformer.py:1252-1371): a recurrent mixer on the
    recurrent state (Falcon-H1's with attention beside it, the two summed),
    an attention block on the KV part, or Nemotron-H's mixer-less FFN block;
    a mixer-only block has no FFN half. With per-layer head arrays (deci) a
    layer may also be linear attention (attn_output of the normed input),
    attention-free (its FFN on ffn_norm) or a dummy (identity). Talkie adds
    its normed embedding, times layer_out_scale, after every layer;
    nanbeige's loops apply output_norm at each loop boundary."""
    cdtype = cfg.compute_dtype
    x = embed_lookup(params["token_embd"], tokens.long(), dtype=cdtype)  # [B, T, E]
    if cfg.embd_scale != 1.0:
        x = (x.float() * cfg.embd_scale).to(x.dtype)
    if "pos_embd" in params:  # learned absolute positions; a pad row reads row 0
        x = x + embed_lookup(params["pos_embd"], inputs.positions.long().clamp_min(0),
                             dtype=cdtype)
    if "token_embd_norm" in params:  # bloom's embedding LayerNorm
        x = layer_norm(x, params["token_embd_norm"], params.get("token_embd_norm_bias"),
                       cfg.norm_eps)
    embd_skip = None
    if cfg.extra.get("embd_skip"):  # talkie: the weightless-normed embedding
        x = rms_norm(x, None, cfg.rms_eps)
        embd_skip = x
    heads = cfg.extra.get("n_head_arr")
    cvec = params.get("cvec")  # [n_layers, n_embd] f32 residual directions
    post = cfg.post_norms or cfg.norm_after
    rscale = cfg.residual_scale
    layers = params["layers"]
    akv = kv.kv if isinstance(kv, HybridMemory) else kv
    first_attn = first_attention_layer(cfg, layers)
    # nanbeige: the loader lists the physical stack n_loops times (the same
    # weight dicts); output_norm again after each loop but the last
    n_loops = cfg.extra.get("n_loops", 1)
    phys = max(len(layers) // max(n_loops, 1), 1)
    loop_norm = n_loops > 1 and not cfg.extra.get("skip_loop_final_norm")
    for il, lw in enumerate(layers):
        if tap is not None:
            tap(il, x)
        x_in = x  # the layer input (arctic's MoE branch, smallthinker's router)
        if (heads is not None and int(heads[il]) == 0
                and not any(k in lw for k in ("ffn_up", "ffn_gateup", "ffn_gate_exps"))):
            continue  # deci's dummy layer: neither attention nor FFN
        # norm-after blocks (olmo2): the mixer sees the raw residual stream
        # and its output is normalised before the add
        h = x if cfg.norm_after else norm(cfg, x, lw, "attn_norm")
        mixer = mamba.mixer_of(cfg, lw)
        # ISWA sub-caches label their positions on their own first layers
        up = None if isinstance(akv, ISWACache) else il == first_attn
        if mixer is None and "attn_output" not in lw:  # Nemotron-H's FFN block
            if "attn_norm" not in lw and "ffn_norm" in lw:  # deci's attention-free layer
                h = norm(cfg, x, lw, "ffn_norm")
            ff = _mixer_less_ffn(cfg, lw, h, kernels, il)
            x = x + (ff * rscale if rscale != 1.0 else ff)
            if cvec is not None:
                x = x + cvec[il].to(x.dtype)
            continue
        if mixer is not None:
            attn, new_conv, s_last = mixer(cfg, lw, h, kv.rs, inputs.seq_idx, il, kernels)
            attn = attn.to(x.dtype)
            kv.rs.put(il, inputs.seq_idx, new_conv, s_last)
            if mixer in mamba.SSM_MIXERS and "attn_output" in lw:
                # Falcon-H1: attention in parallel with the SSM on the same
                # normed input, the two summed
                attn2 = attention_block(cfg, lw, h, inputs, akv, il, kernels=kernels,
                                        update_pos=up)
                attn = attn + attn2.to(attn.dtype)
        elif heads is not None and _linear_attention(lw):  # deci: out = wo . norm(x)
            attn = _add_bias(matmul(h, lw["attn_output"], kernels=kernels), lw,
                             "attn_output_bias").to(x.dtype)
        else:
            blk = mla_attention_block if "attn_kv_a_mqa" in lw else attention_block
            attn = blk(cfg, lw, h, inputs, akv, il, kernels=kernels, update_pos=up)
        if post and "attn_post_norm" in lw:
            attn = rms_norm(attn, lw["attn_post_norm"], cfg.rms_eps)
        if cfg.parallel_residual:
            # x + attn(norm1(x)) + ffn(norm2(x)); phi2 and command-r share one norm
            h2 = h if cfg.shared_parallel_norm else norm(cfg, x, lw, "ffn_norm")
            if cfg.n_expert > 0 and "ffn_gate_exps" in lw:
                ff = moe_block(cfg, lw, h2, kernels=kernels).to(x.dtype)  # cohere2moe
            else:
                ff = ffn_block(cfg, lw, h2, kernels=kernels, il=il)
            x = x + attn + ff
        else:
            x = x + (attn * rscale if rscale != 1.0 else attn)
            if not any(k in lw for k in ("ffn_up", "ffn_gateup", "ffn_gate_exps")):
                # a mixer-only block (Nemotron-H's M and A blocks)
                if cvec is not None:
                    x = x + cvec[il].to(x.dtype)
                continue
            h = x if cfg.norm_after else norm(cfg, x, lw, "ffn_norm")
            ff = _ffn(cfg, lw, h, x_in, kernels, il)
            if post and "ffn_post_norm" in lw:
                ff = rms_norm(ff, lw["ffn_post_norm"], cfg.rms_eps)
            x = x + (ff * rscale if rscale != 1.0 else ff)
        if embd_skip is not None and "layer_out_scale" in lw:
            x = x + embd_skip * lw["layer_out_scale"].reshape(-1)[0].to(x.dtype)
        if cvec is not None:  # control vector (build_cvec analog)
            x = x + cvec[il].to(x.dtype)
        if loop_norm and (il + 1) % phys == 0 and il + 1 < len(layers):
            x = norm(cfg, x, params, "output_norm")
    if tap is not None:
        tap(len(layers), x)
    B, T, E = x.shape
    x = x.reshape(B * T, E)
    if output_rows is not None:
        x = x[output_rows]
    x = norm(cfg, x, params, "output_norm")
    if return_hidden:
        return x
    out_w = params.get("output")
    if out_w is None:
        out_w = params["token_embd"]
    logits = matmul(x, out_w, dtype=torch.float32, kernels=kernels)
    if "output_bias" in params:
        logits = logits + params["output_bias"].float()
    if cfg.logit_scale != 1.0:
        logits = logits * cfg.logit_scale
    if cfg.final_logit_softcap:
        cap = cfg.final_logit_softcap
        logits = torch.tanh(logits / cap) * cap
    return logits
