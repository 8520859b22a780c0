"""Pre-norm decoder transformer forward pass for the llama family, dense or
mixture-of-experts, on the paged KV pool or the slot-table cache.

Analog of reference llm_graph_context build_attn / build_ffn / build_moe_ffn
(src/llama-graph.h:1048-1143, src/llama-graph.cpp:1955-2075) and the llama
graph (src/models/llama.cpp:99-247); the llama subset of the JAX package's
models/transformer.py with its casts (bf16 activations, f32 accumulation,
f32 logits).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..ops.basic import rms_norm, silu, swiglu
from ..ops.kernels import flash_attn as fa_kernel
from ..ops.kernels import qmm_expert as expert_kernel
from ..ops.qtensor import QuantTensor, Weight, dot_f32, embed_lookup, matmul
from ..ops.rope import ROPE_TYPE_NONE, RopeParams, apply_rope
from ..runtime.kv_cache import KVCache
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
                    inputs: AttnInputs, kv: PagedKVCache | KVCache, il: int,
                    kernels: bool = True) -> torch.Tensor:
    """Plain GQA attention over the paged pool or the slot-table cache;
    writes this step's K/V rows in place. kernels=False takes the gather +
    einsum path everywhere."""
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
    paged = isinstance(kv, PagedKVCache)
    n_slots = kv.max_pages * kv.page if paged else kv.n_slots
    use_flash = (kernels and x.device.type == "cuda"
                 and fa_kernel.dispatches(Dk, Dv, n_slots, T * (H // Hkv)))
    if use_flash:
        # the slot-table kernel takes the cache and seq_idx as they are: no
        # per-step gather of the sequences' cache rows
        mha = fa_kernel.mha_flash_paged if paged else fa_kernel.mha_flash
        out = mha(q, kv, il, inputs.seq_idx, inputs.positions, sm_scale=scale, window=window,
                  softcap=cfg.attn_logit_softcap,
                  sinks=None if sinks is None else sinks.float()).to(x.dtype)
    else:
        if paged:
            k_seq, v_seq, slot_pos = kv.gather_seq(il, inputs.seq_idx)
        else:
            k_seq, v_seq = kv.read(il, inputs.seq_idx)  # [B, Hkv, S, D]
            slot_pos = kv.pos[inputs.seq_idx.long()]  # [B, S]
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


def _route(cfg: ModelConfig, lw: dict[str, Weight], x: torch.Tensor, kernels: bool):
    """Router -> (topi [..., k] expert ids, topw [..., k] f32 mix weights):
    logits (+bias) -> gating -> optional selection bias -> top-k -> weight
    post-processing (softmax over the k / norm / scale)."""
    logits = matmul(x, lw["ffn_gate_inp"], dtype=torch.float32, kernels=kernels)
    if "ffn_gate_inp_bias" in lw:
        logits = logits + lw["ffn_gate_inp_bias"].float()
    gating = cfg.expert_gating
    if gating == "softmax":
        probs = torch.softmax(logits, dim=-1)
    elif gating == "sigmoid":
        probs = torch.sigmoid(logits)
    elif gating == "softmax_weight":
        probs = logits  # softmax over the selected k below
    else:
        raise NotImplementedError(f"expert gating {gating!r} is not ported")
    # an expert-selection bias moves the top-k choice only, not the weights
    sel = probs + lw["exp_probs_b"].float() if "exp_probs_b" in lw else probs
    # a stable descending sort takes the lower index first on a tie, as
    # jax.lax.top_k does (torch.topk promises no order)
    topi = torch.sort(sel, dim=-1, descending=True, stable=True).indices[
        ..., : cfg.n_expert_used]
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


def _moe_gather(cfg, lw, x, topi, topw, kernels: bool) -> torch.Tensor:
    """Per-token gathered expert FFN for decode shapes, y = sum_j w_j *
    FFN_{e_j}(x): only the selected experts' planes are read."""
    lead, E = x.shape[:-1], x.shape[-1]
    k = topi.shape[-1]
    xf = x.reshape(-1, E)
    N = xf.shape[0]
    idx = topi.reshape(N * k).long()
    tw = topw.reshape(N, k)
    mdt = torch.float32 if x.dtype == torch.float32 else torch.bfloat16

    def emm(key, h):  # h [N*k, a] -> [N*k, b] f32
        return (_moe_expert_mm(lw[key], h, idx, mdt, kernels)
                + _expert_bias(lw, key + "_bias", idx))

    xk = xf.repeat_interleave(k, dim=0)  # row n*k + j = token n
    h = silu(emm("ffn_gate_exps", xk)) * emm("ffn_up_exps", xk)
    y = emm("ffn_down_exps", h).reshape(N, k, E)
    return (y * tw[:, :, None]).sum(dim=1).reshape(*lead, E)


def _moe_ragged(cfg, lw, x, topi, topw, kernels: bool) -> torch.Tensor:
    """Per-expert dispatch for prefill-sized token counts: each expert's
    three GEMMs over every token, each (token, slot) pair taking the rows of
    the expert it chose, mixed by gate weight in slot order. Where the JAX
    package leaves the segment GEMMs to XLA's ragged_dot over tokens sorted
    by expert, this visits every expert, dequantizing one expert at a time
    (all eight of a Mixtral layer would be 2.8 GB) around torch.matmul, with
    the choice applied on the device: no segment size comes to the host, so
    a decode step can be captured in a CUDA graph. A pair's row is the same
    product as in a segment of its expert's tokens; the GEMMs take
    n_expert / top_k times the rows a segment would."""
    lead, E = x.shape[:-1], x.shape[-1]
    k = topi.shape[-1]
    xf = x.reshape(-1, E)
    N = xf.shape[0]
    tw = topw.reshape(N, k)
    chosen = topi.reshape(N, k)
    mdt = torch.float32 if x.dtype == torch.float32 else torch.bfloat16
    xs = xf.to(mdt)
    y = torch.zeros((N, k, E), dtype=torch.float32, device=x.device)
    for e in range(cfg.n_expert):
        sel = slice(e, e + 1)

        def emm(key, h):  # h [N, a] -> [N, b] f32
            wd = _dequant_experts(lw[key], sel, mdt)[0]
            bias = lw[key + "_bias"].float()[sel] if key + "_bias" in lw else 0.0
            return dot_f32(h.to(mdt), wd) + bias

        h = silu(emm("ffn_gate_exps", xs)) * emm("ffn_up_exps", xs)
        y = torch.where((chosen == e)[:, :, None], emm("ffn_down_exps", h)[:, None, :], y)
    return (y * tw[:, :, None]).sum(dim=1).reshape(*lead, E)


def moe_block(cfg: ModelConfig, lw: dict[str, Weight], x: torch.Tensor,
              kernels: bool = True) -> torch.Tensor:
    """Mixture-of-experts FFN (build_moe_ffn analog): router, then the
    gather route when tokens * top_k < n_expert (decode: the indexed-expert
    kernel on the card) or the per-expert route, plus shared experts.
    Gatings softmax, sigmoid and softmax_weight; sparsemixer, sqrt_softplus,
    gate-before-expert weighting, the clamped oai glu and expert parallelism
    are not ported."""
    topi, topw = _route(cfg, lw, x, kernels)
    n_tok = x.numel() // x.shape[-1]
    if n_tok * cfg.n_expert_used < cfg.n_expert:
        out = _moe_gather(cfg, lw, x, topi, topw, kernels)
    else:
        out = _moe_ragged(cfg, lw, x, topi, topw, kernels)
    if cfg.n_expert_shared > 0 and "ffn_gate_shexp" in lw:
        h = (silu(matmul(x, lw["ffn_gate_shexp"], kernels=kernels))
             * matmul(x, lw["ffn_up_shexp"], kernels=kernels))
        sh = matmul(h, lw["ffn_down_shexp"], kernels=kernels).float()
        if "ffn_gate_inp_shexp" in lw:  # sigmoid-gated shared expert
            sh = sh * torch.sigmoid(matmul(x, lw["ffn_gate_inp_shexp"], dtype=torch.float32,
                                           kernels=kernels))
        out = out + sh
    return out.to(x.dtype)


def forward(params: dict[str, Any], cfg: ModelConfig, tokens: torch.Tensor,
            inputs: AttnInputs, kv: PagedKVCache | KVCache,
            output_rows: torch.Tensor | None = None, kernels: bool = True) -> torch.Tensor:
    """tokens [B, T] -> logits [M or B*T, vocab] f32; writes the KV memory in
    place."""
    cdtype = cfg.compute_dtype
    x = embed_lookup(params["token_embd"], tokens.long(), dtype=cdtype)  # [B, T, E]
    for il, lw in enumerate(params["layers"]):
        h = norm(cfg, x, lw, "attn_norm")
        x = x + attention_block(cfg, lw, h, inputs, kv, il, kernels=kernels)
        h = norm(cfg, x, lw, "ffn_norm")
        if cfg.n_expert > 0 and "ffn_gate_exps" in lw:
            x = x + moe_block(cfg, lw, h, kernels=kernels)
        else:
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
