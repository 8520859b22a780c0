"""Elementwise and normalization building blocks. Parity: ggml RMS_NORM and
GLU ops (reference ggml/include/ggml.h:482-631); the casts follow the JAX
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


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x.float()).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU with the tanh approximation (jax.nn.gelu(approximate=True), the
    reference's GGML_OP_GELU) in f32, cast back."""
    return F.gelu(x.float(), approximate="tanh").to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return silu(gate) * up


ACTIVATIONS = {"silu": silu, "gelu": gelu}
