"""Rotary position embeddings: NORM (adjacent pairs) and NEOX (half-split)
styles plus YaRN scaling and per-pair frequency factors.

Semantics parity: reference ggml GGML_OP_ROPE (ggml/src/ggml-cpu/ops.cpp
ggml_compute_forward_rope_f32, ggml_rope_yarn corrections). GGUF llama
weights are stored permuted for NORM-style rope.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

ROPE_TYPE_NONE = -1
ROPE_TYPE_NORM = 0
ROPE_TYPE_NEOX = 2


@dataclass(frozen=True)
class RopeParams:
    rope_type: int = ROPE_TYPE_NORM
    n_dims: int = 0  # rotated dims (<= head_dim)
    freq_base: float = 10000.0
    freq_scale: float = 1.0  # 1/scaling_factor for linear scaling
    ext_factor: float = 0.0  # YaRN extrapolation mix (0 = off)
    attn_factor: float = 1.0
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    orig_ctx: int = 0  # original training context for YaRN
    # optional per-pair frequency divisors [n_dims/2] (ggml freq_factors)
    freq_factors: object = None


def _yarn_corr_dim(n_dims: int, n_ctx_orig: int, n_rot: float, base: float) -> float:
    # inverse of: 2pi * x^(-2d/D) * L = n_rot  (ggml rope_yarn_corr_dim)
    return n_dims * math.log(n_ctx_orig / (n_rot * 2 * math.pi)) / (2 * math.log(base))


def rope_freqs_and_scale(p: RopeParams, head_dim: int, device=None):
    """Per-pair inverse frequencies [n_dims/2] and the YaRN magnitude scale.

    Returns (inv_freq_interp, inv_freq_extrap, ramp_mix, mscale): the applied
    frequency is mix(interp, extrap) per ggml_rope_yarn."""
    n_dims = p.n_dims or head_dim
    half = n_dims // 2
    exponent = torch.arange(half, dtype=torch.float32, device=device) * (2.0 / n_dims)
    theta_extrap = torch.pow(torch.tensor(p.freq_base, dtype=torch.float32, device=device),
                             -exponent)
    if p.freq_factors is not None:
        ff = torch.as_tensor(p.freq_factors, dtype=torch.float32, device=device)
        theta_extrap = theta_extrap / ff[:half]
    theta_interp = p.freq_scale * theta_extrap
    mscale = p.attn_factor
    if p.ext_factor != 0.0 and p.orig_ctx > 0:
        lo = _yarn_corr_dim(n_dims, p.orig_ctx, p.beta_fast, p.freq_base)
        hi = _yarn_corr_dim(n_dims, p.orig_ctx, p.beta_slow, p.freq_base)
        lo = max(0.0, math.floor(lo))
        hi = min(n_dims - 1, math.ceil(hi))
        i = torch.arange(half, dtype=torch.float32, device=device) * 2.0
        denom = max(hi - lo, 0.001)
        ramp = torch.clamp((i - lo) / denom, 0.0, 1.0)
        ramp_mix = (1.0 - ramp) * p.ext_factor
        mscale = p.attn_factor * (1.0 + 0.1 * math.log(1.0 / p.freq_scale))
    else:
        ramp_mix = torch.zeros(half, dtype=torch.float32, device=device)
    return theta_interp, theta_extrap, ramp_mix, float(mscale)


# (RopeParams fields, head_dim, device) -> (inv_freq [n_dims/2] f32, mscale)
_FREQS: dict[tuple, tuple[torch.Tensor, float]] = {}


def _freqs(p: RopeParams, head_dim: int, device: torch.device) -> tuple[torch.Tensor, float]:
    """The applied per-pair inverse frequencies, mix(interp, extrap), and the
    YaRN magnitude scale, made on `device` once per (params, head_dim,
    device): a decode step then copies nothing from the host, so it can be
    captured in a CUDA graph."""
    ff = p.freq_factors
    ff_key = None if ff is None else np.asarray(ff, dtype=np.float32).tobytes()
    key = (p.rope_type, p.n_dims, p.freq_base, p.freq_scale, p.ext_factor, p.attn_factor,
           p.beta_fast, p.beta_slow, p.orig_ctx, ff_key, head_dim, str(device))
    hit = _FREQS.get(key)
    if hit is None:
        theta_i, theta_e, ramp_mix, mscale = rope_freqs_and_scale(p, head_dim, device)
        hit = _FREQS[key] = (theta_i * (1.0 - ramp_mix) + theta_e * ramp_mix, mscale)
    return hit


def apply_rope(x: torch.Tensor, positions: torch.Tensor, p: RopeParams) -> torch.Tensor:
    """Rotate the first p.n_dims dims of each head.
    x [..., seq, n_heads, head_dim], positions [..., seq]."""
    head_dim = x.shape[-1]
    n_dims = p.n_dims or head_dim
    half = n_dims // 2
    inv_freq, mscale = _freqs(p, head_dim, x.device)  # [half], a Python float
    angles = positions[..., None].float() * inv_freq  # [..., seq, half]
    cos = (torch.cos(angles) * mscale)[..., None, :]  # [..., seq, 1, half]
    sin = (torch.sin(angles) * mscale)[..., None, :]

    xf = x.float()
    if p.rope_type == ROPE_TYPE_NEOX:
        x0 = xf[..., :half]
        x1 = xf[..., half:n_dims]
        rotated = torch.cat([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    else:  # NORM: adjacent pairs
        xr = xf[..., :n_dims].reshape(*xf.shape[:-1], half, 2)
        x0 = xr[..., 0]
        x1 = xr[..., 1]
        rotated = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos],
                              dim=-1).reshape(*xf.shape[:-1], n_dims)
    if n_dims < head_dim:
        rotated = torch.cat([rotated, xf[..., n_dims:]], dim=-1)
    return rotated.to(x.dtype)


# (sections, half, device) -> [half] position stream of each frequency pair
_SEL: dict[tuple, torch.Tensor] = {}


def _imrope_sel(sections: tuple[int, ...], half: int, device: torch.device) -> torch.Tensor:
    """The position stream of each frequency pair, made on `device` once (a
    decode step copies nothing from the host)."""
    key = (tuple(sections), half, str(device))
    hit = _SEL.get(key)
    if hit is None:
        sel = []
        for s in range(half):
            if s % 3 == 1 and s < 3 * sections[1]:
                sel.append(1)
            elif s % 3 == 2 and s < 3 * sections[2]:
                sel.append(2)
            elif s % 3 == 0 and s < 3 * sections[0]:
                sel.append(0)
            else:
                sel.append(3)
        hit = _SEL[key] = torch.tensor(sel, dtype=torch.long, device=device)
    return hit


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, sections: tuple[int, ...],
                p: RopeParams) -> torch.Tensor:
    """Interleaved multimodal rope (GGML_ROPE_TYPE_IMROPE: qwen3vl, qwen35;
    the JAX package's ops/rope.py:114 with interleaved=True): each frequency
    pair takes its angle from one of the t/h/w position streams positions3
    [3, ..., seq]: pair s from h when s % 3 == 1 (s < 3 * sections[1]), w
    when s % 3 == 2, t when s % 3 == 0, else a 4th stream, which is zero for
    text rows (llama-graph.cpp:138), so such pairs stay unrotated; NEOX
    (half-split) rotation. x [..., seq, n_heads, head_dim]."""
    head_dim = x.shape[-1]
    n_dims = p.n_dims or head_dim
    half = n_dims // 2
    inv_freq, mscale = _freqs(p, head_dim, x.device)
    zero = positions3.new_zeros((4 - positions3.shape[0],) + tuple(positions3.shape[1:]))
    ang = torch.cat([positions3, zero], dim=0)[..., None].float() * inv_freq  # [4, ..., half]
    sel = _imrope_sel(sections, half, x.device)
    angles = torch.gather(ang.movedim(0, -1), -1,
                          sel.expand(*ang.shape[1:])[..., None])[..., 0]  # [..., seq, half]
    cos = (torch.cos(angles) * mscale)[..., None, :]
    sin = (torch.sin(angles) * mscale)[..., None, :]
    xf = x.float()
    x0 = xf[..., :half]
    x1 = xf[..., half:n_dims]
    rotated = torch.cat([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    if n_dims < head_dim:
        rotated = torch.cat([rotated, xf[..., n_dims:]], dim=-1)
    return rotated.to(x.dtype)
