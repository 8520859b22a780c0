"""T5: the encoder (t5encoder: flan-t5 and mt5 encoders, T5-based embedding
models) and the encoder-decoder's decoder step (t5).

Port of the JAX package's models/t5.py (analog of reference
src/models/t5.cpp's encoder and decoder graphs; the bucket math of
llama_relative_position_bucket, src/llama-graph.cpp:3729): RMSNorm blocks,
attention at scale 1 with a learned bias of relative-position buckets
(bidirectional in the encoder, unidirectional in the decoder's
self-attention, max distance 128; a layer without its own table takes
layer 0's), a gated GELU or a ReLU FFN, the final norm. The decoder's
self-attention reads the slot-table KV memory; its cross-attention reads
the encoder's output (the cross state [B, Ne, E], padded rows masked by
cross_pos < 0) with no position bias, its K/V projected from it on every
call as in the JAX package. Activations in the compute dtype, attention in
f32, as in the JAX package. Projections go through ops.qtensor.matmul (the
qmm kernels where the JAX package takes its own: under 64 rows the decode
kernel, 64-1023 the prefill GEMM); attention is plain PyTorch, as the JAX
package's is plain XLA.
"""

from __future__ import annotations

import math

import torch

from ..ops.basic import ACTIVATIONS, rms_norm
from ..ops.qtensor import embed_lookup, matmul
from .bert import qkv_projections
from .config import ModelConfig


def relative_bucket(rel: torch.Tensor, n_buckets: int, bidirectional: bool) -> torch.Tensor:
    """HF T5's bucket of rel = k_pos - q_pos (the JAX package's t5.py:25-48),
    max distance 128."""
    max_distance = 128
    nb = n_buckets // 2 if bidirectional else n_buckets
    rel = rel.long()
    if bidirectional:
        big = (rel > 0).long() * nb
        rel = rel.abs()
    else:
        big = torch.zeros_like(rel)
        rel = torch.clamp_min(-rel, 0)
    max_exact = nb // 2
    relf = torch.clamp_min(rel, 1).float()
    large = max_exact + (torch.log(relf / max_exact) / math.log(max_distance / max_exact)
                         * (nb - max_exact)).to(torch.int32).long()
    large = torch.clamp_max(large, nb - 1)
    return big + torch.where(rel < max_exact, rel, large)


def _pos_bias(rel_b: torch.Tensor, q_pos: torch.Tensor, k_pos: torch.Tensor, n_buckets: int,
              bidirectional: bool) -> torch.Tensor:
    """rel_b [n_buckets, H] -> the additive bias [B, H, Tq, Sk] f32."""
    bucket = relative_bucket(k_pos[:, None, :] - q_pos[:, :, None], n_buckets, bidirectional)
    return rel_b.float()[bucket].permute(0, 3, 1, 2)


def _attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
          bias: torch.Tensor | None, H: int, Dk: int, Dv: int) -> torch.Tensor:
    """Scale-1 attention with an additive bias in f32: q [B, T, H * Dk], k/v
    [B, H, S, D], mask [B, T, S] -> [B, T, H * Dv] f32."""
    B, T = q.shape[:2]
    qh = q.reshape(B, T, H, Dk).float()
    scores = torch.einsum("bthd,bhsd->bhts", qh, k.float())
    if bias is not None:
        scores = scores + bias
    scores = scores.masked_fill(~mask[:, None], -1e30)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhts,bhsd->bthd", p, v.float()).reshape(B, T, H * Dv)


def _ffn(lw, x: torch.Tensor, kernels: bool) -> torch.Tensor:
    """flan's gated gelu(wi_0) * wi_1 (fused at load, or apart), or T5's
    relu(wi)."""
    mm = lambda v, w: matmul(v, lw[w], kernels=kernels)  # noqa: E731
    if "ffn_gateup" in lw:
        gu = mm(x, "ffn_gateup")
        g, u = gu.chunk(2, dim=-1)
        h = ACTIVATIONS["gelu"](g) * u
    elif "ffn_gate" in lw:
        h = ACTIVATIONS["gelu"](mm(x, "ffn_gate")) * mm(x, "ffn_up")
    else:
        h = ACTIVATIONS["relu"](mm(x, "ffn_up"))
    return mm(h, "ffn_down")


def t5_encode(params, cfg: ModelConfig, tokens: torch.Tensor,
              valid: torch.Tensor | None = None, kernels: bool = True) -> torch.Tensor:
    """The encoder stack -> the final normed hidden states [B, T, E] in the
    compute dtype. `valid` [B, T] masks padding keys (pad queries give
    garbage rows, which the caller drops)."""
    n_bkts = cfg.extra.get("rel_buckets", 32)
    H, Dk, Dv = cfg.n_heads, cfg.head_dim_k, cfg.head_dim_v
    x = embed_lookup(params["token_embd"], tokens.long(), dtype=cfg.compute_dtype)
    B, T = tokens.shape
    pos = torch.arange(T, device=tokens.device)[None].expand(B, T)
    mask = (torch.ones((B, T, T), dtype=torch.bool, device=tokens.device) if valid is None
            else valid.bool()[:, None, :].expand(B, T, T))
    layers = params["enc_layers"]
    rel0 = layers[0].get("attn_rel_b")
    for lw in layers:
        h = rms_norm(x, lw["attn_norm"], cfg.rms_eps)
        q, k, v = qkv_projections(lw, h, H * Dk, H * Dk, kernels)
        k = k.reshape(B, T, H, Dk).transpose(1, 2)
        v = v.reshape(B, T, H, Dv).transpose(1, 2)
        bias = _pos_bias(lw.get("attn_rel_b", rel0), pos, pos, n_bkts, True)
        attn = _attn(q, k, v, mask, bias, H, Dk, Dv)
        x = x + matmul(attn.to(x.dtype), lw["attn_output"], kernels=kernels)
        h = rms_norm(x, lw["ffn_norm"], cfg.rms_eps)
        x = x + _ffn(lw, h, kernels).to(x.dtype)
    return rms_norm(x, params["enc_output_norm"], cfg.rms_eps)


def t5_forward(params, cfg: ModelConfig, tokens: torch.Tensor, inputs, kv,
               output_rows: torch.Tensor | None = None, kernels: bool = True,
               cross: torch.Tensor | None = None, cross_pos: torch.Tensor | None = None,
               return_hidden: bool = False) -> torch.Tensor:
    """The decoder step (the JAX package's t5.py:124-191): tokens [B, T] at
    inputs.positions over the slot-table memory `kv` (written in place),
    attending the encoder's output `cross` [B, Ne, E] (f32) where cross_pos
    [B, Ne] >= 0 -> logits [M or B * T, vocab] f32, or with return_hidden
    the rows after output_norm."""
    if cross is None:
        raise ValueError("t5_forward needs the encoder's output (cross): the encoder-decoder "
                         "flow is Context.prefill / Context.encode")
    n_bkts = cfg.extra.get("rel_buckets", 32)
    H, Dk, Dv = cfg.n_heads, cfg.head_dim_k, cfg.head_dim_v
    B, T = tokens.shape
    x = embed_lookup(params["token_embd"], tokens.long(), dtype=cfg.compute_dtype)
    layers = params["layers"]
    rel0 = layers[0].get("attn_rel_b")
    Ne = cross.shape[1]
    cmask = ((cross_pos >= 0)[:, None, :] if cross_pos is not None
             else torch.ones((B, 1, Ne), dtype=torch.bool, device=x.device))
    pos = inputs.positions.long()
    seq_flat = inputs.seq_idx.repeat_interleave(T)
    for il, lw in enumerate(layers):
        # self-attention over the KV memory
        h = rms_norm(x, lw["attn_norm"], cfg.rms_eps)
        q, k, v = qkv_projections(lw, h, H * Dk, H * Dk, kernels)
        kv.write_layer(il, seq_flat, pos.reshape(-1), k.reshape(B * T, H, Dk),
                       v.reshape(B * T, H, Dv))
        k_seq, v_seq = kv.read(il, inputs.seq_idx, dtype=torch.float32)  # [B, H, S, D]
        slot_pos = kv.pos[inputs.seq_idx.long()].long()  # [B, S]
        mask = (slot_pos >= 0)[:, None, :] & (slot_pos[:, None, :] <= pos[:, :, None])
        bias = _pos_bias(lw.get("attn_rel_b", rel0), pos, slot_pos, n_bkts, False)
        attn = _attn(q, k_seq, v_seq, mask, bias, H, Dk, Dv)
        x = x + matmul(attn.to(x.dtype), lw["attn_output"], kernels=kernels)
        # cross-attention over the encoder's output, no position bias
        h = rms_norm(x, lw["cross_attn_norm"], cfg.rms_eps)
        q = matmul(h, lw["cross_attn_q"], kernels=kernels)
        ck = matmul(cross, lw["cross_attn_k"], kernels=kernels).reshape(B, Ne, H, Dk)
        cv = matmul(cross, lw["cross_attn_v"], kernels=kernels).reshape(B, Ne, H, Dv)
        attn = _attn(q, ck.transpose(1, 2), cv.transpose(1, 2), cmask, None, H, Dk, Dv)
        x = x + matmul(attn.to(x.dtype), lw["cross_attn_output"], kernels=kernels)
        h = rms_norm(x, lw["ffn_norm"], cfg.rms_eps)
        x = x + _ffn(lw, h, kernels).to(x.dtype)
    x = x.reshape(B * T, -1)
    if output_rows is not None:
        x = x[output_rows]
    x = rms_norm(x, params["output_norm"], cfg.rms_eps)
    if return_hidden:
        return x
    out_w = params.get("output")
    logits = matmul(x, params["token_embd"] if out_w is None else out_w, dtype=torch.float32,
                    kernels=kernels)
    if cfg.logit_scale != 1.0:
        logits = logits * cfg.logit_scale
    return logits
