"""BERT-family encoder (embedding and rerank models): bert (XLM-RoBERTa,
BGE-M3), modern-bert, nomic-bert, nomic-bert-moe, neo-bert, eurobert,
jina-bert-v2 and jina-bert-v3.

Port of the JAX package's models/bert.py (analog of reference
src/models/bert.cpp and the per-family encoders): post-norm LayerNorm blocks
with bidirectional attention, learned absolute positions and token types,
or pre-norm encoders (ModernBERT's LayerNorm, whose layer 0 has no
attn_norm; NeoBERT's and EuroBERT's RMSNorm); fused qkv with bias, NEOX or
NORM rope where the family has it, jina-v2's full-width q/k LayerNorm,
bidirectional ALiBi and its second LayerNorm, ModernBERT's symmetric local
window, the GLU variants and nomic-bert-moe's gate-less experts. Runs the
whole sequence at once (llama_encode); the memory passes through unread.

Activations are f32, as in the JAX package. Projections go through
ops.qtensor.matmul, so they take the qmm kernels wherever the JAX package's
matmul takes its Pallas kernels (512-row embed buckets: the prefill GEMM).
Attention and the expert loop are plain PyTorch, as the JAX package runs
them in plain XLA with no kernel.
"""

from __future__ import annotations

from typing import Any

import torch

from ..ops.basic import gelu, layer_norm, rms_norm, silu
from ..ops.qtensor import Weight, embed_lookup, matmul
from ..ops.rope import ROPE_TYPE_NONE, apply_rope
from .config import ModelConfig
from .transformer import AttnInputs, _add_bias, _dequant_experts, _rope_params, _top_k
from .transformer import alibi_slopes


def qkv_projections(lw: dict[str, Weight], h: torch.Tensor, q_dim: int, k_dim: int,
                    kernels: bool, dtype=None):
    """q, k, v of h from a fused attn_qkv, from the loader's q+k fusion
    (attn_qk beside attn_v: a Q4_K_M file's Q6_K attn_v) or from three
    projections, each plus its bias where the file has one."""
    mm = lambda w: matmul(h, lw[w], dtype=dtype, kernels=kernels)  # noqa: E731
    if "attn_qkv" in lw:
        qkv = _add_bias(mm("attn_qkv"), lw, "attn_qkv_bias")
        return qkv[..., :q_dim], qkv[..., q_dim:q_dim + k_dim], qkv[..., q_dim + k_dim:]
    if "attn_qk" in lw:
        qk = _add_bias(mm("attn_qk"), lw, "attn_qk_bias")
        return qk[..., :q_dim], qk[..., q_dim:], _add_bias(mm("attn_v"), lw, "attn_v_bias")
    return tuple(_add_bias(mm(k), lw, k + "_bias") for k in ("attn_q", "attn_k", "attn_v"))


def _attention(cfg: ModelConfig, lw, h: torch.Tensor, positions: torch.Tensor,
               mask: torch.Tensor, il: int, kernels: bool) -> torch.Tensor:
    """Bidirectional attention of one layer on h [B, T, E] -> [B, T, H * Dv]
    f32 before attn_output: masked softmax in f32 (einsum), ALiBi slopes
    times -|p_k - p_q| (jina-v2), the symmetric window |p_k - p_q| <= w / 2
    on a window layer (ModernBERT)."""
    B, T = h.shape[:2]
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    Dk, Dv = cfg.head_dim_k, cfg.head_dim_v
    q, k, v = qkv_projections(lw, h, H * Dk, Hkv * Dk, kernels, torch.float32)
    if "attn_q_norm" in lw:  # jina-bert-v2's full-width q/k LayerNorm
        q = layer_norm(q, lw["attn_q_norm"], lw.get("attn_q_norm_bias"), cfg.norm_eps)
        k = layer_norm(k, lw["attn_k_norm"], lw.get("attn_k_norm_bias"), cfg.norm_eps)
    q = q.float().reshape(B, T, H, Dk)
    k = k.float().reshape(B, T, Hkv, Dk)
    v = v.float().reshape(B, T, Hkv, Dv)
    if cfg.rope_type != ROPE_TYPE_NONE:  # nomic-bert, jina-v3, the pre-norm encoders
        rp = _rope_params(cfg, il)
        q = apply_rope(q, positions, rp)
        k = apply_rope(k, positions, rp)
    g = H // Hkv
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    scores = torch.einsum("bthd,bshd->bhts", q, k) / Dk ** 0.5
    diff = (positions[:, None, :] - positions[:, :, None]).float()  # [B, T, S]: p_k - p_q
    if cfg.alibi_bias > 0.0:  # soft_max_ext adds slope * mask, the mask -|p_k - p_q|
        slopes = alibi_slopes(H, cfg.alibi_bias, h.device).reshape(1, H, 1, 1)
        scores = scores + slopes * (-diff.abs())[:, None]
    lmask = mask
    if cfg.sliding_window > 0 and cfg.is_swa_layer(il):
        lmask = lmask & (diff.abs() <= cfg.sliding_window // 2)
    scores = scores.masked_fill(~lmask[:, None], float("-inf"))
    probs = torch.nan_to_num(torch.softmax(scores, dim=-1), nan=0.0)  # fully-masked rows
    return torch.einsum("bhts,bshd->bthd", probs, v).reshape(B, T, H * Dv)


def _experts(cfg: ModelConfig, lw, x: torch.Tensor, kernels: bool) -> torch.Tensor:
    """nomic-bert-moe's gate-less GELU experts: softmax router, top-k with
    the raw softmax weights (bert.cpp:179-189 passes norm_w = false), each
    expert over every token and weighed by its share of the token (the JAX
    package's einsum a stack row, bert.py:173-195)."""
    probs = torch.softmax(matmul(x, lw["ffn_gate_inp"], dtype=torch.float32, kernels=kernels),
                          dim=-1)
    topi = _top_k(probs, cfg.n_expert_used)
    topw = torch.gather(probs, -1, topi)
    if cfg.expert_weights_norm:
        topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    xf = x.float()
    y = torch.zeros_like(xf)
    for e in range(cfg.n_expert):
        w_e = torch.where(topi == e, topw, torch.zeros_like(topw)).sum(-1)  # [B, T]
        up = _dequant_experts(lw["ffn_up_exps"], slice(e, e + 1), torch.float32)[0]
        down = _dequant_experts(lw["ffn_down_exps"], slice(e, e + 1), torch.float32)[0]
        he = gelu(torch.einsum("bte,ef->btf", xf, up))
        y = y + torch.einsum("btf,fe->bte", he, down) * w_e[..., None]
    return y


def forward(params: dict[str, Any], cfg: ModelConfig, tokens: torch.Tensor,
            inputs: AttnInputs, kv, output_rows: torch.Tensor | None = None,
            kernels: bool = True, return_hidden: bool = False) -> torch.Tensor:
    """tokens [B, T] -> the final hidden rows [M or B*T, E] f32 (an encoder
    has no logits: return_hidden is what it returns either way). Rows at a
    negative position are padding: masked as keys, garbage as queries."""
    B, T = tokens.shape
    eps = cfg.norm_eps
    pos = inputs.positions.long()
    x = embed_lookup(params["token_embd"], tokens.long(), dtype=torch.float32)
    if "token_types" in params:  # the type-0 row (reference bert.cpp)
        x = x + params["token_types"][0].float()
    if "pos_embd" in params:
        x = x + embed_lookup(params["pos_embd"], pos.clamp_min(0), dtype=torch.float32)
    if "token_embd_norm" in params:
        # the BERT family's embedding LayerNorm; the pre-norm RMS encoders
        # have none (neo-bert.cpp, eurobert.cpp)
        x = layer_norm(x, params["token_embd_norm"], params.get("token_embd_norm_bias"), eps)
    valid = pos >= 0
    mask = valid[:, None, :] & valid[:, :, None]  # [B, T, S] bidirectional
    pre_norm = cfg.extra.get("pre_norm_encoder", False)

    def nrm(v, w, b):  # RMSNorm encoders (neo-bert, eurobert) or LayerNorm
        if cfg.use_rms_norm:
            return rms_norm(v, w, cfg.rms_eps).float()
        return layer_norm(v, w, b, eps)

    act = silu if cfg.act == "silu" else gelu
    mm = lambda v, w: matmul(v, w, dtype=torch.float32, kernels=kernels)  # noqa: E731

    for il, lw in enumerate(params["layers"]):
        h_in = x
        if pre_norm:  # ModernBERT's layer 0 has no attn_norm: its embeddings are normed
            h_in = nrm(x, lw["attn_norm"], lw.get("attn_norm_bias")) if "attn_norm" in lw else x
        attn = _attention(cfg, lw, h_in, pos, mask, il, kernels)
        attn = _add_bias(mm(attn, lw["attn_output"]), lw, "attn_output_bias")

        if pre_norm:
            x = x + attn
            h2 = nrm(x, lw["ffn_norm"], lw.get("ffn_norm_bias"))
            if "ffn_gate" in lw:  # eurobert's gated FFN, where the loader kept it apart
                h3 = act(mm(h2, lw["ffn_gate"])) * mm(h2, lw["ffn_up"])
            else:  # fused gate|up halves (ModernBERT GEGLU, NeoBERT SwiGLU, load-time fusion)
                up = mm(h2, lw.get("ffn_gateup", lw.get("ffn_up")))
                half = up.shape[-1] // 2
                h3 = act(up[..., :half]) * up[..., half:]
            x = x + mm(h3, lw["ffn_down"])
            continue

        # post-norm: LN(x + attn)
        x_in = x
        x = layer_norm(x + attn, lw.get("attn_output_norm"), lw.get("attn_output_norm_bias"),
                       eps)
        if "attn_norm_2" in lw:  # jina-v2: the layer input re-added first (bert.cpp:168-171)
            x = layer_norm(x + x_in, lw["attn_norm_2"], lw.get("attn_norm_2_bias"), eps)
        ffn_inp = x
        if "ffn_gateup" in lw:  # load-time fused gate|up (jina-v3's GLU, nomic's)
            gu = mm(x, lw["ffn_gateup"])
            half = gu.shape[-1] // 2
            y = _add_bias(mm(act(gu[..., :half]) * gu[..., half:], lw["ffn_down"]), lw,
                          "ffn_down_bias")
        elif "ffn_up_exps" in lw:
            y = _experts(cfg, lw, x, kernels)
        else:
            up = _add_bias(mm(x, lw["ffn_up"]), lw, "ffn_up_bias")
            if "ffn_gate" in lw:  # a gate the loader kept apart (biased gate or up)
                h = act(mm(x, lw["ffn_gate"])) * up
            elif cfg.n_ff and up.shape[-1] == 2 * cfg.n_ff:
                # jina-v2's up-contains-gate GEGLU (bert.cpp:200)
                h = gelu(up[..., :cfg.n_ff]) * up[..., cfg.n_ff:]
            else:
                h = gelu(up)
            y = _add_bias(mm(h, lw["ffn_down"]), lw, "ffn_down_bias")
        x = layer_norm(ffn_inp + y, lw.get("layer_output_norm"),
                       lw.get("layer_output_norm_bias"), eps)

    if pre_norm and "output_norm" in params:  # ModernBERT's final norm
        x = nrm(x, params["output_norm"], params.get("output_norm_bias"))
    elif "enc_output_norm" in params:  # NeoBERT's enc.output_norm
        x = nrm(x, params["enc_output_norm"], None)
    x = x.reshape(B * T, -1)
    if output_rows is not None:
        x = x[output_rows]
    return x
