"""The recurrent mixers: Mamba-1 and Mamba-2 selective scans (and PLaMo-2's
mixture of the two), the gated DeltaNet of Qwen3-Next and Qwen3.5 and
Kimi's delta attention with a decay a key channel (KDA), LFM2's short
convolution, and the pure-recurrent forward of the mamba and mamba2
entries.

Port of the JAX package's models/mamba.py (analog of reference
src/models/mamba-base.cpp build_mamba_layer / build_mamba2_layer,
qwen3next.cpp + delta-net-base.cpp, lfm2.cpp build_shortconv_block, and the
GGML_OP_SSM_CONV / GGML_OP_SSM_SCAN kernels). The JAX package runs every
one of these in plain XLA, with no Pallas kernel, so here they are plain
PyTorch, in f32 where the JAX code is f32, each computed as the JAX code
computes it: the two Mamba scans as its associative (log-depth odd/even)
scan over the tokens, the DeltaNet as its step loop. A decode step (T = 1)
is one state update. Each mixer returns (out, new conv window, new SSM
state); the caller writes them into the RecurrentState in place. The
projections go through ops.qtensor.matmul, so a quantized one runs the
qmm kernel wherever the JAX package runs its own.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..ops.basic import rms_norm
from ..ops.qtensor import embed_lookup, matmul
from ..runtime.memory import RecurrentState
from .config import ModelConfig


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) as jax.nn.softplus computes it (logaddexp with 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _slice(t: torch.Tensor, dim: int, start: int, stop: int | None, step: int = 1):
    idx = [slice(None)] * t.dim()
    idx[dim] = slice(start, stop, step)
    return t[tuple(idx)]


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """a0 b0 a1 b1 ... along dim (len(a) is len(b) or len(b) + 1)."""
    n = b.shape[dim]
    head = torch.stack([_slice(a, dim, 0, n), b], dim=dim + 1).flatten(dim, dim + 1)
    if a.shape[dim] == n:
        return head
    return torch.cat([head, _slice(a, dim, n, None)], dim=dim)


def associative_scan(combine: Callable, elems: tuple[torch.Tensor, ...], dim: int):
    """Inclusive scan of `combine` over `dim`: jax.lax.associative_scan's
    algorithm (combine adjacent pairs, scan the half recursively, fill the
    even positions), so the products are taken in its order. The elements
    may broadcast against each other (a Mamba-2 decay is [.., H, 1, 1] under
    a state of [.., H, P, S])."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems
    reduced = combine([_slice(e, dim, 0, n - 1, 2) for e in elems],
                      [_slice(e, dim, 1, None, 2) for e in elems])
    odd = associative_scan(combine, reduced, dim)
    if n % 2 == 0:
        even = combine([_slice(e, dim, 0, e.shape[dim] - 1) for e in odd],
                       [_slice(e, dim, 2, None, 2) for e in elems])
    else:
        even = combine(list(odd), [_slice(e, dim, 2, None, 2) for e in elems])
    even = [torch.cat([_slice(e, dim, 0, 1), r], dim=dim) for e, r in zip(elems, even)]
    return tuple(_interleave(e, o, dim) for e, o in zip(even, odd))


def _linear_combine(left, right):
    """(a1, b1) then (a2, b2) of the recurrence s' = a s + b."""
    a1, b1 = left
    a2, b2 = right
    return a1 * a2, a2 * b1 + b2


def selective_scan(s0, x, dt, A, B, C):
    """First-order linear recurrence h' = exp(dt A) h + dt B x, y = C h.

    s0 [Bt, S, I] initial state; x, dt [Bt, T, I]; A [I, S]; B, C [Bt, T, S]
    -> (y [Bt, T, I], s_T [Bt, S, I]), all f32."""
    a = torch.exp(dt[:, :, None, :] * A.t()[None, None])  # [Bt, T, S, I]
    b = B[..., None] * (dt * x)[:, :, None, :]  # [Bt, T, S, I]
    b[:, 0] = b[:, 0] + a[:, 0] * s0  # the initial state folds into the first step
    _, s_all = associative_scan(_linear_combine, (a, b), dim=1)
    y = torch.einsum("bts,btsi->bti", C, s_all)
    return y, s_all[:, -1]


def causal_conv(conv0: torch.Tensor, xs: torch.Tensor, w: torch.Tensor,
                bias: torch.Tensor | None, d_conv: int, act: bool = True):
    """Depthwise causal conv over time with a rolling window
    (GGML_OP_SSM_CONV): conv0 [B, d_conv - 1, C] the window, xs [B, T, C],
    w [C, d_conv] -> (silu(conv) or the conv itself, new window), f32."""
    T = xs.shape[1]
    cx = torch.cat([conv0.float(), xs], dim=1)  # [B, d_conv - 1 + T, C]
    w = w.float()
    xc = sum(w[:, j] * cx[:, j: j + T, :] for j in range(d_conv))
    if bias is not None:
        xc = xc + bias.float()
    return (torch.nn.functional.silu(xc) if act else xc), cx[:, T:, :]


def _causal_conv(mem: RecurrentState, il: int, seq_idx, xs, lw, d_conv: int):
    """Layer il's conv (ssm_conv1d, its bias) over xs from the sequences'
    windows -> (silu(conv), new window)."""
    conv0 = mem.conv[il][seq_idx.long()]
    return causal_conv(conv0, xs, lw["ssm_conv1d"], lw.get("ssm_conv1d_bias"), d_conv)


def _l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + eps)


def _delta_rule(S, q, k, v, decay, beta):
    """The gated delta rule a token at a time (the JAX package's lax.scan
    step): S <- S * decay; S <- S + k (beta (v - k^T S)); out = q^T S.
    S [B, H, Dk, Dv]; q, k [B, T, H, Dk]; v [B, T, H, Dv]; decay [B, T, H,
    1 or Dk] (a head's, or each key channel's); beta [B, T, H] -> (out [B,
    T, H, Dv], S_T)."""
    # time-major, so each step reads contiguous rows: [T, B, H, 1, D]
    qs, ks, vs = (t.transpose(0, 1).unsqueeze(-2).contiguous() for t in (q, k, v))
    dec = decay.transpose(0, 1)[..., None]  # [T, B, H, 1 or Dk, 1]
    bs = beta.transpose(0, 1)[..., None, None]
    outs = []
    for t in range(q.shape[1]):
        S = S * dec[t]
        delta = (vs[t] - ks[t] @ S) * bs[t]
        S = S + ks[t].transpose(-1, -2) * delta
        outs.append(qs[t] @ S)
    return torch.cat(outs, dim=-2).transpose(1, 2), S


def gated_delta_layer(cfg: ModelConfig, lw, h, mem: RecurrentState, seq_idx, il: int,
                      kernels: bool = True):
    """Qwen3-Next / Qwen3.5 gated DeltaNet mixer (reference
    src/models/qwen3next.cpp build_layer_attn_linear + delta-net-base.cpp):
    S_t = S_{t-1} exp(g_t) + beta_t k_t (v_t - k_t^T S_{t-1} exp(g_t)), out_t
    = q_t^T S_t, run as a step loop over the tokens; then the per-head
    RMSNorm gated by silu(z) and ssm_out -> (out, new conv, S_T)."""
    ex = cfg.extra
    Dk = ex["ssm_d_state"]  # linear_key_head_dim
    Hk = ex["ssm_n_group"]  # linear_num_key_heads
    Hv = ex["ssm_dt_rank"]  # linear_num_value_heads
    d_inner = ex["ssm_d_inner"]  # Hv * Dv
    Dv = d_inner // Hv
    R = Hv // Hk
    key_dim = Hk * Dk
    d_conv = ex["ssm_d_conv"]
    B_, T = h.shape[:2]

    if "ssm_in" in lw:
        # the legacy qkvz projection, interleaved per key head
        # (modeling_qwen3_next.fix_query_key_value_ordering)
        qkvz = matmul(h, lw["ssm_in"], kernels=kernels).float()
        qkvz = qkvz.reshape(B_, T, Hk, 2 * Dk + 2 * R * Dv)
        q, k, v, z = torch.split(qkvz, [Dk, Dk, R * Dv, R * Dv], dim=-1)
        v = v.reshape(B_, T, Hv, Dv)
        z = z.reshape(B_, T, Hv, Dv)
    else:
        # one flat [q | k | v] projection and a separate z gate (qwen35)
        qkv = matmul(h, lw["attn_qkv"], kernels=kernels).float()
        q, k, v = torch.split(qkv, [key_dim, key_dim, d_inner], dim=-1)
        z = matmul(h, lw["attn_gate"], kernels=kernels).float().reshape(B_, T, Hv, Dv)
    if "ssm_ba" in lw:
        ba = matmul(h, lw["ssm_ba"], kernels=kernels).float().reshape(B_, T, Hk, 2 * R)
        b, a = torch.split(ba, [R, R], dim=-1)
        b = b.reshape(B_, T, Hv)
        a = a.reshape(B_, T, Hv)
    else:  # qwen35: separate beta and alpha projections
        b = matmul(h, lw["ssm_beta"], kernels=kernels).float()
        a = matmul(h, lw["ssm_alpha"], kernels=kernels).float()

    # the causal conv over the [q; k; v] channels, silu-activated
    mixed = torch.cat([q.reshape(B_, T, key_dim), k.reshape(B_, T, key_dim),
                       v.reshape(B_, T, d_inner)], dim=-1)
    xc, new_conv = _causal_conv(mem, il, seq_idx, mixed, lw, d_conv)
    q, k, v = torch.split(xc, [key_dim, key_dim, d_inner], dim=-1)
    q = _l2norm(q.reshape(B_, T, Hk, Dk)) * (Dk ** -0.5)
    k = _l2norm(k.reshape(B_, T, Hk, Dk))
    v = v.reshape(B_, T, Hv, Dv)
    if R > 1:  # the key heads repeated across the value heads
        q = q.repeat_interleave(R, dim=2)
        k = k.repeat_interleave(R, dim=2)

    beta = torch.sigmoid(b)  # [B, T, Hv]
    g = lw["ssm_a"].float() * softplus(a + lw["ssm_dt_bias"].float())  # [B, T, Hv]

    S = mem.ssm[il][seq_idx.long()].float()  # [B, Dk, Hv * Dv]
    S = S.reshape(B_, Dk, Hv, Dv).permute(0, 2, 1, 3)  # [B, Hv, Dk, Dv]
    out, S = _delta_rule(S, q, k, v, torch.exp(g)[..., None], beta)  # out [B, T, Hv, Dv]

    # the gated per-head RMSNorm: norm, then the silu(z) gate
    out = rms_norm(out, lw["ssm_norm"], cfg.rms_eps) * torch.nn.functional.silu(z)
    y = matmul(out.reshape(B_, T, d_inner).to(h.dtype), lw["ssm_out"], kernels=kernels)
    s_T = S.permute(0, 2, 1, 3).reshape(B_, Dk, Hv * Dv)
    return y, new_conv, s_T


def kda_layer(cfg: ModelConfig, lw, h, mem: RecurrentState, seq_idx, il: int,
              kernels: bool = True):
    """Kimi Delta Attention (reference src/models/kimi-linear.cpp; vLLM
    kda.py): the gated delta rule with a decay a key channel, S[i, j] *=
    exp(g[i]), g = A_h softplus(f_b(f_a(x)) + dt_bias), over separate causal
    convs of q, k and v; the output RMSNorm gated by sigmoid(g_b(g_a(x)))
    through attn_output -> (out, new conv, S_T)."""
    ex = cfg.extra
    Dh = ex["kda_head_dim"]
    d_conv = ex["ssm_d_conv"]
    Hh = cfg.n_heads
    d_inner = Hh * Dh
    B_, T = h.shape[:2]

    conv0 = mem.conv[il][seq_idx.long()].float()  # [B, d_conv - 1, 3 d_inner]
    if "attn_qkv" in lw:  # the load-time fused q|k|v projection
        proj = torch.chunk(matmul(h, lw["attn_qkv"], kernels=kernels).float(), 3, dim=-1)
    elif "attn_qk" in lw:  # q|k fused, v of another type apart (the Q4_K_M mix)
        proj = (*torch.chunk(matmul(h, lw["attn_qk"], kernels=kernels).float(), 2, dim=-1),
                matmul(h, lw["attn_v"], kernels=kernels).float())
    else:
        proj = [matmul(h, lw[k], kernels=kernels).float() for k in ("attn_q", "attn_k", "attn_v")]
    branches, new_conv = [], []
    for j, cn in enumerate(("ssm_conv1d_q", "ssm_conv1d_k", "ssm_conv1d_v")):
        xp = proj[j]
        xc, nc = causal_conv(conv0[:, :, j * d_inner: (j + 1) * d_inner], xp,
                             lw[cn].reshape(d_inner, d_conv), None, d_conv)
        branches.append(xc)
        new_conv.append(nc)
    q, k, v = branches
    new_conv = torch.cat(new_conv, dim=-1)

    eps = cfg.rms_eps
    q = _l2norm(q.reshape(B_, T, Hh, Dh), eps)
    k = _l2norm(k.reshape(B_, T, Hh, Dh), eps)
    v = v.reshape(B_, T, Hh, Dh)
    g1 = matmul(matmul(h, lw["ssm_f_a"], kernels=kernels).float(), lw["ssm_f_b"],
                kernels=kernels)
    g1 = softplus(g1.float() + lw["ssm_dt_bias"].float())
    A = lw["ssm_a"].float().reshape(-1)[:Hh]  # -exp(A_log), folded at conversion
    g1 = g1.reshape(B_, T, Hh, Dh) * A[None, None, :, None]
    beta = torch.sigmoid(matmul(h, lw["ssm_beta"], kernels=kernels).float())  # [B, T, H]

    S = mem.ssm[il][seq_idx.long()].float().reshape(B_, Dh, Hh, Dh).permute(0, 2, 1, 3)
    out, S = _delta_rule(S, q * (float(Dh) ** -0.5), k, v, torch.exp(g1), beta)

    g2 = matmul(matmul(h, lw["ssm_g_a"], kernels=kernels).float(), lw["ssm_g_b"],
                kernels=kernels)
    out = rms_norm(out, lw["ssm_norm"], eps) * torch.sigmoid(g2.float().reshape(B_, T, Hh, Dh))
    y = matmul(out.reshape(B_, T, d_inner).to(h.dtype), lw["attn_output"], kernels=kernels)
    return y, new_conv, S.permute(0, 2, 1, 3).reshape(B_, Dh, d_inner)


def lfm2_shortconv_layer(cfg: ModelConfig, lw, h, mem: RecurrentState, seq_idx, il: int,
                         kernels: bool = True):
    """LFM2's short convolution (reference src/models/lfm2.cpp
    build_shortconv_block): in_proj -> (b, c, x); y = c * conv(b * x) over a
    rolling window like the Mamba conv, no activation and no gate ->
    (out, new window, the SSM state unchanged)."""
    L = cfg.extra["shortconv_l"]
    bcx = matmul(h, lw["shortconv_in"], kernels=kernels).float()  # [B, T, 3E]
    b, c, x = torch.chunk(bcx, 3, dim=-1)
    idx = seq_idx.long()
    xc, new_conv = causal_conv(mem.conv[il][idx], b * x, lw["shortconv_conv"], None, L,
                               act=False)
    out = matmul((c * xc).to(h.dtype), lw["shortconv_out"], kernels=kernels)
    return out, new_conv, mem.ssm[il][idx]


def mamba1_layer(cfg: ModelConfig, lw, h, mem: RecurrentState, seq_idx, il: int,
                 kernels: bool = True):
    """Mamba-1 mixer (reference build_mamba_layer; FalconMamba's dt/B/C
    RMSNorms where the file has them) -> (out, new conv, s_T)."""
    ex = cfg.extra
    d_conv, d_state = ex["ssm_d_conv"], ex["ssm_d_state"]
    dt_rank, d_inner = ex["ssm_dt_rank"], ex["ssm_d_inner"]
    dt_b_c_rms = bool(ex.get("ssm_dt_b_c_rms", False))

    xz = matmul(h, lw["ssm_in"], dtype=torch.float32, kernels=kernels)  # [B, T, 2I]
    xs, z = xz[..., :d_inner], xz[..., d_inner:]
    xc, new_conv = _causal_conv(mem, il, seq_idx, xs, lw, d_conv)

    x_db = matmul(xc, lw["ssm_x"], dtype=torch.float32, kernels=kernels)  # [B, T, R + 2S]
    dt = x_db[..., :dt_rank]
    Bm = x_db[..., dt_rank: dt_rank + d_state]
    Cm = x_db[..., dt_rank + d_state:]
    if dt_b_c_rms or "ssm_dt_norm" in lw:
        dt = rms_norm(dt, lw.get("ssm_dt_norm"), cfg.rms_eps)
        Bm = rms_norm(Bm, lw.get("ssm_b_norm"), cfg.rms_eps)
        Cm = rms_norm(Cm, lw.get("ssm_c_norm"), cfg.rms_eps)
    dt = matmul(dt, lw["ssm_dt"], dtype=torch.float32, kernels=kernels)
    if "ssm_dt_bias" in lw:
        dt = dt + lw["ssm_dt_bias"]
    dt = softplus(dt)  # [B, T, I]

    s0 = mem.ssm[il][seq_idx.long()]  # [B, S, I] f32
    y, s_last = selective_scan(s0, xc, dt, lw["ssm_a"].float(), Bm, Cm)
    y = y + xc * lw["ssm_d"].float()
    y = y * torch.nn.functional.silu(z)
    out = matmul(y, lw["ssm_out"], dtype=torch.float32, kernels=kernels)  # [B, T, E]
    return out, new_conv, s_last


def mamba2_layer(cfg: ModelConfig, lw, h, mem: RecurrentState, seq_idx, il: int,
                 kernels: bool = True):
    """Mamba-2 mixer (reference build_mamba2_layer, src/models/mamba-base.cpp
    :149): the fused zxBCdt in-projection, the conv over the x|B|C channels,
    a scalar decay a head, grouped B/C, the grouped gated RMSNorm ->
    (out, new conv, s_T). The scan holds [B, T, H, P, S] f32 states."""
    ex = cfg.extra
    d_conv, d_state = ex["ssm_d_conv"], ex["ssm_d_state"]
    d_inner = ex["ssm_d_inner"]
    H, G = ex["ssm_dt_rank"], ex["ssm_n_group"]
    P = d_inner // H
    conv_dim = d_inner + 2 * G * d_state
    B_, T = h.shape[:2]

    zxbcdt = matmul(h, lw["ssm_in"], dtype=torch.float32, kernels=kernels)  # [B, T, 2I+2GS+H]
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner: d_inner + conv_dim]
    dt = zxbcdt[..., d_inner + conv_dim:]  # [B, T, H]

    xBC, new_conv = _causal_conv(mem, il, seq_idx, xBC, lw, d_conv)
    x = xBC[..., :d_inner].reshape(B_, T, H, P)
    Bm = xBC[..., d_inner: d_inner + G * d_state].reshape(B_, T, G, d_state)
    Cm = xBC[..., d_inner + G * d_state:].reshape(B_, T, G, d_state)

    if "ssm_dt_bias" in lw:
        dt = dt + lw["ssm_dt_bias"]
    dt = softplus(dt)  # [B, T, H]
    A = lw["ssm_a"].reshape(-1).float()  # [H]
    a5 = torch.exp(dt * A)[..., None, None]  # [B, T, H, 1, 1]

    rep = H // G
    Bh = Bm.repeat_interleave(rep, dim=2)  # [B, T, H, S]
    Ch = Cm.repeat_interleave(rep, dim=2)
    b = (dt[..., None] * x)[..., None] * Bh[..., None, :]  # [B, T, H, P, S]
    # the initial state: stored [B, S, I] with channel i = h * P + p
    s0 = mem.ssm[il][seq_idx.long()].transpose(1, 2).reshape(B_, H, P, d_state)
    b[:, 0] = b[:, 0] + a5[:, 0] * s0
    del Bm, xBC
    _, s_all = associative_scan(_linear_combine, (a5, b), dim=1)
    del b
    y = torch.einsum("bths,bthps->bthp", Ch, s_all)
    s_last = s_all[:, -1].reshape(B_, d_inner, d_state).transpose(1, 2)
    del s_all
    y = y + x * lw["ssm_d"].reshape(-1).float()[None, None, :, None]
    y = y.reshape(B_, T, d_inner) * torch.nn.functional.silu(z)

    if "ssm_norm" in lw:  # the grouped gated RMSNorm (weight [G, I / G])
        yg = y.reshape(B_, T, G, d_inner // G)
        yg = rms_norm(yg, None, cfg.rms_eps) * lw["ssm_norm"].float()
        y = yg.reshape(B_, T, d_inner)

    out = matmul(y, lw["ssm_out"], dtype=torch.float32, kernels=kernels)
    return out, new_conv, s_last


def plamo2_layer(cfg: ModelConfig, lw, h, mem: RecurrentState, seq_idx, il: int,
                 kernels: bool = True):
    """PLaMo-2's Mamba mixer (reference src/models/plamo2.cpp
    build_plamo2_mamba_layer): a per-head interleaved [z | x] in-projection,
    the conv over x alone, Mamba-1's x_proj after the conv giving
    RMS-normed B, C and dt, Mamba-2's scalar decay a head, and a silu(z)
    gate -> (out, new conv, s_T)."""
    ex = cfg.extra
    d_conv, d_state = ex["ssm_d_conv"], ex["ssm_d_state"]
    d_inner = ex["ssm_d_inner"]
    H = ex["ssm_dt_rank"]  # PLaMo-2 stores its head count in time_step_rank
    P = d_inner // H
    B_, T = h.shape[:2]

    zx = matmul(h, lw["ssm_in"], dtype=torch.float32, kernels=kernels)  # [B, T, 2I]
    zx = zx.reshape(B_, T, H, 2 * P)  # per head [z_h | x_h]
    z = zx[..., :P].reshape(B_, T, d_inner)
    x = zx[..., P:].reshape(B_, T, d_inner)
    x, new_conv = _causal_conv(mem, il, seq_idx, x, lw, d_conv)

    bcdt = matmul(x, lw["ssm_x"], dtype=torch.float32, kernels=kernels)  # [B, T, 2S + dt]
    Bm = rms_norm(bcdt[..., :d_state], lw.get("ssm_b_norm"), cfg.rms_eps)
    Cm = rms_norm(bcdt[..., d_state: 2 * d_state], lw.get("ssm_c_norm"), cfg.rms_eps)
    dt = rms_norm(bcdt[..., 2 * d_state:], lw.get("ssm_dt_norm"), cfg.rms_eps)
    dt = matmul(dt, lw["ssm_dt"], dtype=torch.float32, kernels=kernels)  # [B, T, H]
    if "ssm_dt_bias" in lw:
        dt = dt + lw["ssm_dt_bias"]
    dt = softplus(dt)
    a5 = torch.exp(dt * lw["ssm_a"].reshape(-1).float())[..., None, None]  # [B, T, H, 1, 1]

    xh = x.reshape(B_, T, H, P)
    b = (dt[..., None] * xh)[..., None] * Bm[:, :, None, None, :]  # [B, T, H, P, S]
    s0 = mem.ssm[il][seq_idx.long()].transpose(1, 2).reshape(B_, H, P, d_state)
    b[:, 0] = b[:, 0] + a5[:, 0] * s0
    _, s_all = associative_scan(_linear_combine, (a5, b), dim=1)
    del b
    y = torch.einsum("bts,bthps->bthp", Cm.float(), s_all)
    s_last = s_all[:, -1].reshape(B_, d_inner, d_state).transpose(1, 2)
    del s_all
    y = y + xh * lw["ssm_d"].reshape(-1).float()[None, None, :, None]
    y = torch.nn.functional.silu(z) * y.reshape(B_, T, d_inner)
    out = matmul(y, lw["ssm_out"], dtype=torch.float32, kernels=kernels)
    return out, new_conv, s_last


# the mixers of ssm_in layers, beside which Falcon-H1's attention runs
SSM_MIXERS = (mamba1_layer, mamba2_layer, plamo2_layer)


def mixer_of(cfg: ModelConfig, lw) -> Callable | None:
    """The recurrent mixer of a layer's weights (the JAX package's decoder
    loop, transformer.py:1291-1340), or None for an attention layer."""
    if "ssm_f_a" in lw:
        return kda_layer
    if "ssm_ba" in lw or "ssm_beta" in lw:
        return gated_delta_layer
    if "shortconv_in" in lw:
        return lfm2_shortconv_layer
    if "ssm_in" in lw:
        if cfg.extra.get("plamo2"):
            return plamo2_layer
        return mamba2_layer if cfg.extra.get("ssm_version", 1) == 2 else mamba1_layer
    return None


def forward(params: dict[str, Any], cfg: ModelConfig, tokens: torch.Tensor, inputs,
            mem: RecurrentState, output_rows: torch.Tensor | None = None,
            kernels: bool = True, return_hidden: bool = False) -> torch.Tensor:
    """The pure-recurrent stack (mamba, mamba2): tokens [B, T] -> logits [M
    or B*T, vocab] f32, or with return_hidden the hidden rows after
    output_norm (f32); the state is written in place. The residual stream
    is f32, as in the JAX package. Each row's tokens must be consecutive
    (split_equal's ubatch contract, reference src/llama-batch.h:108), with
    no padding rows."""
    x = embed_lookup(params["token_embd"], tokens.long(), dtype=torch.float32)
    seq_idx = inputs.seq_idx
    for il, lw in enumerate(params["layers"]):
        h = rms_norm(x, lw["attn_norm"], cfg.rms_eps)
        out, new_conv, s_last = mixer_of(cfg, lw)(cfg, lw, h, mem, seq_idx, il, kernels)
        x = x + out
        mem.put(il, seq_idx, new_conv, s_last)
    B, T, E = x.shape
    x = x.reshape(B * T, E)
    if output_rows is not None:
        x = x[output_rows]
    x = rms_norm(x, params["output_norm"], cfg.rms_eps)
    if return_hidden:
        return x
    out_w = params.get("output")
    if out_w is None:
        out_w = params["token_embd"]
    return matmul(x, out_w, dtype=torch.float32, kernels=kernels)
