"""Elementwise and normalization building blocks. Parity: ggml RMS_NORM,
NORM and GLU ops (reference ggml/include/ggml.h:482-631); the casts follow the JAX
package (f32 arithmetic, result in the input's dtype)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor | None, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor | None, bias: torch.Tensor | None,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last axis (biased variance) in f32, cast back; no
    weight or bias is the non-parametric norm."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x.float()).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU with the tanh approximation (jax.nn.gelu(approximate=True), the
    reference's GGML_OP_GELU) in f32, cast back."""
    return F.gelu(x.float(), approximate="tanh").to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return silu(gate) * up


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0)


def relu2(x: torch.Tensor) -> torch.Tensor:
    """Squared ReLU (nemotron, arcee) in the input's dtype."""
    r = torch.clamp_min(x, 0)
    return r * r


def xielu(x: torch.Tensor, alpha_n: float, alpha_p: float, beta: float,
          eps: float) -> torch.Tensor:
    """Apertus' xIELU (reference ggml op_xielu, ggml-cpu/unary-ops.cpp:55;
    the JAX package's transformer.py:785-789): alpha_p x^2 + beta x above 0,
    (expm1(min(x, eps)) - x) alpha_n + beta x at or below, in x's dtype (the
    caller passes f32)."""
    pos = alpha_p * x * x + beta * x
    neg = (torch.expm1(torch.clamp(x, max=eps)) - x) * alpha_n + beta * x
    return torch.where(x > 0, pos, neg)


ACTIVATIONS = {"silu": silu, "gelu": gelu, "relu": relu, "relu2": relu2}
