"""RWKV-6, RWKV-7 and their qwen2-FFN hybrids (rwkv6qwen2, arwkv7): time mix,
channel mix and the forward over the RecurrentState.

Port of the JAX package's models/rwkv.py (analog of reference
src/models/rwkv6-base.cpp, rwkv7-base.cpp and the GGML_OP_RWKV_WKV6, GLA and
RWKV_WKV7 kernels, ggml/src/ggml-cpu/ops.cpp). The JAX package computes these
recurrences in plain XLA, outside any Pallas kernel, so here they are plain
PyTorch in f32, each as the JAX code computes it: the RWKV-6 and gated
linear attention scans as its associative scan over the tokens (with the
[B, T, H, hs, hs] outer products and the cumulative decay product it
materialises), RWKV-7's rank-1 update as its step loop. The projections go
through ops.qtensor.matmul, so a quantized one runs the qmm kernels wherever
the JAX package runs its own.

The memory is the RecurrentState alone: its conv window holds the token
shifts (2 rows of n_embd: slot 0 the time mix's, slot 1 the channel mix's;
the hybrids' single stream fills both) and its ssm plane the wkv state
[hs, E] a layer and a sequence, read as [B, H, i, j] by reshape(B, hs, H,
hs).transpose(1, 2), so state files interchange with the JAX package's.
"""

from __future__ import annotations

from typing import Any

import torch

from ..ops.basic import layer_norm, rms_norm
from ..ops.qtensor import embed_lookup, matmul
from ..runtime.memory import RecurrentState
from .config import ModelConfig
from .mamba import _linear_combine, associative_scan


def _scan_states(s0: torch.Tensor, a: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
    """S_t = a_t S_{t-1} + kv_t from s0 [B, H, i, j] over a [B, T, H, i, 1]
    and kv [B, T, H, i, j] -> every S_t (post-update), as the JAX package
    takes it: the associative scan from zero, plus the cumulative product
    of the decays times s0."""
    a_b = a.expand(kv.shape)
    _, s_inc = associative_scan(_linear_combine, (a_b, kv), dim=1)
    return s_inc + torch.cumprod(a_b, dim=1) * s0[:, None]


def wkv6_scan(s0, r, k, v, w, u):
    """RWKV-6's wkv: y_t[j] = sum_i r_t[i] (u[i] k_t[i] v_t[j] + S_{t-1}[i,
    j]), S_t[i, j] = w_t[i] S_{t-1}[i, j] + k_t[i] v_t[j]. s0 [B, H, i, j];
    r, k, v, w [B, T, H, hs]; u [H, hs] -> (y [B, T, H, hs], s_T)."""
    kv = k[..., :, None] * v[..., None, :]  # [B, T, H, i, j]
    s_all = _scan_states(s0, w[..., :, None], kv)
    s_prev = torch.cat([s0[:, None], s_all[:, :-1]], dim=1)
    y = torch.einsum("bthi,bthij->bthj", r, u[None, None, :, :, None] * kv + s_prev)
    return y, s_all[:, -1]


def gla_scan(s0, r, k, v, w, scale: float):
    """Gated linear attention (the qrwkv hybrids): RWKV-6's recurrence
    without the u bonus, read after the update: y_t[j] = scale * sum_i
    r_t[i] S_t[i, j] -> (y, s_T)."""
    kv = k[..., :, None] * v[..., None, :]
    s_all = _scan_states(s0, w[..., :, None], kv)
    y = torch.einsum("bthi,bthij->bthj", r, s_all) * scale
    return y, s_all[:, -1]


def wkv7_scan(s0, r, w, k, v, a, b):
    """RWKV-7's wkv, a head's state S[i, j]: sa_i = sum_j a_j S[i, j]; S[i,
    j] = S[i, j] w_j + v_i k_j + sa_i b_j; out_i = sum_j S[i, j] r_j. Inputs
    [B, T, H, hs], s0 [B, H, i, j] -> (out [B, T, H, hs], s_T), a step a
    token as the JAX package's lax.scan, its terms added in the same order.
    A prefill ubatch runs the step T times a layer eagerly, so its operands
    are laid out token-major and cut into per-token columns ([.., hs, 1])
    and rows ([.., 1, hs]) once, and the step is five launches: two
    matrix-vector products, a scale and two fused multiply-adds."""
    def steps(x, col: bool):
        x = x.float().transpose(0, 1).contiguous()
        return (x[..., None] if col else x[..., None, :]).unbind(0)

    S = s0.float()
    outs = []
    for r_t, w_t, k_t, v_t, a_t, b_t in zip(steps(r, True), steps(w, False), steps(k, False),
                                             steps(v, True), steps(a, True), steps(b, False)):
        sa = torch.matmul(S, a_t)  # [B, H, i, 1]
        S = S * w_t
        S.addcmul_(v_t, k_t)
        S.addcmul_(sa, b_t)
        outs.append(torch.matmul(S, r_t))
    return torch.cat(outs, dim=-1).permute(0, 3, 1, 2).contiguous(), S


def _heads(x: torch.Tensor, H: int, hs: int) -> torch.Tensor:
    return x.reshape(*x.shape[:2], H, hs)


def _state_heads(s0: torch.Tensor, H: int, hs: int) -> torch.Tensor:
    """The ssm plane [B, hs, E] -> [B, H, i, j]."""
    return s0.reshape(s0.shape[0], hs, H, hs).transpose(1, 2)


def _state_plane(sT: torch.Tensor) -> torch.Tensor:
    """[B, H, i, j] -> the ssm plane [B, hs, E]."""
    B, H, hs, _ = sT.shape
    return sT.transpose(1, 2).reshape(B, hs, H * hs)


def _group_norm(y: torch.Tensor, lw) -> torch.Tensor:
    """A head's LayerNorm at eps 64e-5 (ggml_norm, no weight), then the
    affine time_mix_ln over E. y [B, T, H, hs] -> [B, T, E] f32."""
    yf = y.float()
    mu = yf.mean(-1, keepdim=True)
    var = ((yf - mu) ** 2).mean(-1, keepdim=True)
    yn = ((yf - mu) * torch.rsqrt(var + 64e-5)).reshape(*y.shape[:2], -1)
    return yn * lw["time_mix_ln"] + lw["time_mix_ln_bias"]


def _mm(x, w, kernels: bool) -> torch.Tensor:
    return matmul(x, w, dtype=torch.float32, kernels=kernels)


def _shifted(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """x_{t-1} - x_t, the previous token of the first row from the state."""
    return torch.cat([shift[:, None], x[:, :-1]], dim=1) - x


def time_mix7(cfg: ModelConfig, lw, x, shift, s0, v_first, kernels: bool = True):
    """RWKV-7's time mix (reference rwkv7-base.cpp build_rwkv7_time_mix): x
    [B, T, E] normed, shift [B, E], s0 [B, hs, E] -> (out, new shift, s_T
    plane, v_first)."""
    B, T, E = x.shape
    hs = cfg.extra["wkv_head_size"]
    H = E // hs
    sx = _shifted(x, shift)
    has_g = "time_mix_g1" in lw
    lf = lw["time_mix_lerp_fused"].reshape(-1, E)  # r, w, k, v, a (, g)
    xr, xw, xk, xv, xa = (x + sx * lf[i] for i in range(5))

    r = _mm(xr, lw["time_mix_receptance"], kernels)
    w = _mm(torch.tanh(_mm(xw, lw["time_mix_w1"], kernels)), lw["time_mix_w2"], kernels)
    w = w + lw["time_mix_w0"].reshape(1, 1, E)
    w = torch.exp(-0.606531 * torch.sigmoid(w))  # e^(-e^-0.5 sigmoid) in [~0.55, 1]
    k = _mm(xk, lw["time_mix_key"], kernels)
    v = _mm(xv, lw["time_mix_value"], kernels)
    if v_first is None:  # layer 0's value, the residual of the layers after it
        v_first = v
    else:
        vmix = torch.sigmoid(_mm(_mm(xv, lw["time_mix_v1"], kernels), lw["time_mix_v2"], kernels)
                             + lw["time_mix_v0"].reshape(1, 1, E))
        v = v + (v_first - v) * vmix
    a = torch.sigmoid(_mm(_mm(xa, lw["time_mix_a1"], kernels), lw["time_mix_a2"], kernels)
                      + lw["time_mix_a0"].reshape(1, 1, E))
    g = None
    if has_g:
        xg = x + sx * lf[5]
        g = _mm(torch.sigmoid(_mm(xg, lw["time_mix_g1"], kernels)), lw["time_mix_g2"], kernels)

    kk = _heads(k * lw["time_mix_k_k"], H, hs)
    kk = kk * torch.rsqrt((kk * kk).sum(dim=-1, keepdim=True) + 1e-12)
    ka = k * lw["time_mix_k_a"]
    k = k + a * ka - ka
    rh, wh, kh, vh, ah = (_heads(t, H, hs) for t in (r, w, k, v, a))
    y, sT = wkv7_scan(_state_heads(s0, H, hs), rh, wh, kh, vh, -kk, kk * ah)
    if "time_mix_ln" in lw:
        yn = _group_norm(y, lw)
    else:  # arwkv7: no group-norm tail
        yn = y.float().reshape(B, T, E)
    # the bonus: a head's (r . k . r_k) re-injects v
    rk = (kh * rh * lw["time_mix_r_k"].reshape(H, hs)).sum(dim=-1, keepdim=True)
    yn = yn + (vh * rk).reshape(B, T, E)
    if g is not None:
        yn = yn * g
    return _mm(yn, lw["time_mix_output"], kernels), x[:, -1], _state_plane(sT), v_first


def time_mix(cfg: ModelConfig, lw, x, shift, s0, kernels: bool = True):
    """RWKV-6's time mix (reference rwkv6-base.cpp build_rwkv6_time_mix), or
    the qrwkv one where the layer has no time_mix_first: no u bonus, a
    sigmoid gate, GQA-repeated k/v, k * (1 - w), gated linear attention at
    head_size^-0.5 and no group-norm tail. -> (out, new shift, s_T plane)."""
    B, T, E = x.shape
    hs = cfg.extra["wkv_head_size"]
    H = E // hs
    sx = _shifted(x, shift)
    xxx = x + sx * lw["time_mix_lerp_x"].reshape(1, 1, E)
    r5 = torch.tanh(_mm(xxx, lw["time_mix_w1"], kernels))  # [B, T, 5 r]
    r5 = r5.reshape(B, T, 5, r5.shape[-1] // 5)
    deltas = torch.einsum("btfr,fer->btfe", r5, lw["time_mix_w2"].float())  # [B, T, 5, E]
    if "time_mix_lerp_fused" in lw:
        lf = lw["time_mix_lerp_fused"].reshape(5, E)
        mixed = [x + sx * (deltas[:, :, i] + lf[i]) for i in range(5)]
    else:
        names = ("time_mix_lerp_w", "time_mix_lerp_k", "time_mix_lerp_v", "time_mix_lerp_r",
                 "time_mix_lerp_g")
        mixed = [x + sx * (deltas[:, :, i] + lw[n].reshape(1, 1, E))
                 for i, n in enumerate(names)]
    xw, xk, xv, xr, xg = mixed
    qrwkv = "time_mix_first" not in lw

    r = _mm(xr, lw["time_mix_receptance"], kernels)
    k = _mm(xk, lw["time_mix_key"], kernels)
    v = _mm(xv, lw["time_mix_value"], kernels)
    if "time_mix_receptance_bias" in lw:  # the qrwkv projections' biases
        r = r + lw["time_mix_receptance_bias"].float()
    if "time_mix_key_bias" in lw:
        k = k + lw["time_mix_key_bias"].float()
    if "time_mix_value_bias" in lw:
        v = v + lw["time_mix_value_bias"].float()
    gate = _mm(xg, lw["time_mix_gate"], kernels)
    g = torch.sigmoid(gate) if qrwkv else torch.nn.functional.silu(gate)

    w = _mm(torch.tanh(_mm(xw, lw["time_mix_decay_w1"], kernels)), lw["time_mix_decay_w2"],
            kernels)
    w = torch.exp(-torch.exp(w + lw["time_mix_decay"].reshape(1, 1, E)))
    if k.shape[-1] != E:  # GQA kv heads: each repeated over its group
        n_kv = k.shape[-1] // hs
        k, v = (t.reshape(B, T, n_kv, 1, hs).expand(B, T, n_kv, H // n_kv, hs).reshape(B, T, E)
                for t in (k, v))
    if qrwkv:
        k = k - k * w  # k * (1 - w)
    rh, kh, vh, wh = (_heads(t, H, hs) for t in (r, k, v, w))
    s0h = _state_heads(s0, H, hs)
    if qrwkv:
        y, sT = gla_scan(s0h, rh, kh, vh, wh, float(hs) ** -0.5)
        yn = y.float().reshape(B, T, E)
    else:
        y, sT = wkv6_scan(s0h, rh, kh, vh, wh, lw["time_mix_first"].float())
        yn = _group_norm(y, lw)
    return _mm(yn * g, lw["time_mix_output"], kernels), x[:, -1], _state_plane(sT)


def channel_mix(cfg: ModelConfig, lw, x, shift, kernels: bool = True):
    """RWKV's channel mix (reference build_rwkv6_channel_mix): relu(k)^2
    through the value projection, gated by the receptance where the layer
    has one (RWKV-6; RWKV-7 drops it) -> (out, new shift)."""
    sx = _shifted(x, shift)
    E = x.shape[-1]
    xk = x + sx * lw["channel_mix_lerp_k"].reshape(1, 1, E)
    k = torch.relu(_mm(xk, lw["channel_mix_key"], kernels)) ** 2
    out = _mm(k, lw["channel_mix_value"], kernels)
    if "channel_mix_receptance" in lw:
        xr = x + sx * lw["channel_mix_lerp_r"].reshape(1, 1, E)
        out = out * torch.sigmoid(_mm(xr, lw["channel_mix_receptance"], kernels))
    return out, x[:, -1]


def forward(params: dict[str, Any], cfg: ModelConfig, tokens: torch.Tensor, inputs,
            mem: RecurrentState, output_rows: torch.Tensor | None = None,
            kernels: bool = True, return_hidden: bool = False) -> torch.Tensor:
    """RWKV-6/7 (reference src/models/rwkv6.cpp, rwkv7.cpp) and the qwen2-FFN
    hybrids (rwkv6qwen2.cpp, arwkv7.cpp: RMS norms, a SiLU-GLU FFN for the
    channel mix, one token-shift stream): tokens [B, T] -> logits [M or B*T,
    vocab] f32, or with return_hidden the hidden rows after output_norm. The
    residual stream is f32, as in the JAX package; the state is written in
    place. Each row's tokens must be consecutive, with no padding rows."""
    from .transformer import ffn_block

    seq_idx = inputs.seq_idx
    hybrid = bool(cfg.extra.get("rwkv_hybrid"))
    x = embed_lookup(params["token_embd"], tokens.long(), dtype=torch.float32)
    if "token_embd_norm" in params:
        x = layer_norm(x, params["token_embd_norm"], params.get("token_embd_norm_bias"),
                       cfg.norm_eps)
    rescale = int(cfg.extra.get("rescale_every", 0))

    def norm(v, w, b):
        if cfg.use_rms_norm:
            return rms_norm(v, w, cfg.rms_eps)
        return layer_norm(v, w, b, cfg.norm_eps)

    v_first = None
    idx = seq_idx.long()
    for il, lw in enumerate(params["layers"]):
        shifts = mem.conv[il][idx].float()  # [B, 2, E]
        s0 = mem.ssm[il][idx]  # [B, hs, E]
        h = norm(x, lw.get("attn_norm"), lw.get("attn_norm_bias"))
        if "time_mix_w0" in lw:
            att, att_shift, sT, v_first = time_mix7(cfg, lw, h, shifts[:, 0], s0, v_first,
                                                    kernels)
        else:
            att, att_shift, sT = time_mix(cfg, lw, h, shifts[:, 0], s0, kernels)
        x = x + att
        if hybrid:  # Qwen2's gated FFN on ffn_norm
            h = norm(x, lw.get("ffn_norm"), lw.get("ffn_norm_bias"))
            x = x + ffn_block(cfg, lw, h, kernels=kernels).to(x.dtype)
            ffn_shift = att_shift
        else:
            h = layer_norm(x, lw.get("attn_norm_2"), lw.get("attn_norm_2_bias"), cfg.norm_eps)
            ffn, ffn_shift = channel_mix(cfg, lw, h, shifts[:, 1], kernels)
            x = x + ffn
        if rescale and (il + 1) % rescale == 0:
            x = x * 0.5
        mem.put(il, seq_idx, torch.stack([att_shift, ffn_shift], dim=1), sT)
    B, T, E = x.shape
    x = x.reshape(B * T, E)
    if output_rows is not None:
        x = x[output_rows]
    x = norm(x, params.get("output_norm"), params.get("output_norm_bias"))
    if return_hidden:
        return x
    out_w = params.get("output")
    if out_w is None:
        out_w = params["token_embd"]
    return _mm(x, out_w, kernels)
