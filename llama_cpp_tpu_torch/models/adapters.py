"""LoRA adapters and control vectors (port of the JAX package's
models/adapters.py).

Analog of reference src/llama-adapter.cpp (llama_adapter_lora, cvec) and
build_lora_mm (src/llama-graph.h:1018): the low-rank delta is applied at
runtime as y = x@W^T + scale * (x@A^T)@B^T (ops/qtensor.py LoraWeight), so
adapters hot-swap without touching the quantized base weights, whose
products keep their kernels. GGUF adapter files follow the reference
layout: general.type="adapter", adapter.type="lora", adapter.lora.alpha,
tensors "<base>.lora_a" [rank, n_in] / "<base>.lora_b" [n_out, rank].
Control vectors: general.type="adapter", adapter.type="control_vector",
tensors "direction.<il>" [n_embd] added to the residual stream after layer
il - 1. Every change of the weights raises model.version, so a context's
captured decode loops are made again over the new tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..gguf.reader import read_gguf
from ..ops.qtensor import LoraWeight, QuantTensor
from ..quant.dequant import dequantize_tensor
from .loader import GLOBAL_TENSORS, LAYER_TENSORS, Model


@dataclass
class LoraAdapter:
    alpha: float
    rank: int
    # key: ("layer", il, weight_key) or ("global", weight_key)
    tensors: dict[tuple, tuple[np.ndarray, np.ndarray]]

    @property
    def n_tensors(self) -> int:
        return len(self.tensors)


def lora_key(name: str) -> tuple | None:
    """A GGUF tensor name -> its adapter key, or None."""
    if name in GLOBAL_TENSORS:
        return ("global", GLOBAL_TENSORS[name])
    if name.startswith("blk."):
        parts = name.split(".", 2)
        wk = LAYER_TENSORS.get(parts[2])
        if wk is not None:
            return ("layer", int(parts[1]), wk)
    return None


def load_lora(path: str) -> LoraAdapter:
    f = read_gguf(path)
    md = f.metadata
    if md.get("general.type") not in (None, "adapter"):
        raise ValueError("not an adapter GGUF")
    if md.get("adapter.type", "lora") != "lora":
        raise ValueError(f"unsupported adapter type {md.get('adapter.type')!r}")
    alpha = float(md.get("adapter.lora.alpha", 16.0))

    pairs: dict[tuple, dict[str, np.ndarray]] = {}
    rank = 1
    for name, info in f.tensors.items():
        if name.endswith(".lora_a"):
            base, part = name[: -len(".lora_a")], "a"
        elif name.endswith(".lora_b"):
            base, part = name[: -len(".lora_b")], "b"
        else:
            continue
        key = lora_key(base)
        if key is None:
            continue
        arr = dequantize_tensor(np.asarray(info.data), info.dtype, info.shape)
        pairs.setdefault(key, {})[part] = np.asarray(arr, np.float32)

    tensors = {}
    for key, ab in pairs.items():
        if "a" in ab and "b" in ab:
            tensors[key] = (ab["a"], ab["b"])
            rank = ab["a"].shape[0]
    return LoraAdapter(alpha=alpha, rank=rank, tensors=tensors)


def _fuse_pairs(parts: dict[str, tuple], order: list[str], dims: list[int]):
    """Combine per-projection (A, B) pairs into one pair targeting the fused
    weight: A rows stack, B becomes block-structured over the fused output."""
    total_r = sum(parts[k][0].shape[0] for k in order if k in parts)
    in_d = next(parts[k][0].shape[1] for k in order if k in parts)
    A = np.zeros((total_r, in_d), np.float32)
    B = np.zeros((sum(dims), total_r), np.float32)
    r0 = o0 = 0
    for k, d in zip(order, dims):
        if k in parts:
            a, b = parts[k]
            r = a.shape[0]
            A[r0:r0 + r] = a
            B[o0:o0 + d, r0:r0 + r] = b
            r0 += r
        o0 += d
    return A, B


def _remap_for_fusion(model: Model, tensors: dict) -> dict:
    """Route adapters named after unfused projections onto the load-time
    fused attn_qkv / attn_qk and ffn_gateup weights where those exist
    (models/loader.py _fuse_projections)."""
    cfg = model.cfg
    out: dict = {}
    by_layer: dict[int, dict[str, tuple]] = {}
    fusable = ("attn_q", "attn_k", "attn_v", "ffn_gate", "ffn_up")
    for key, ab in tensors.items():
        if key[0] == "layer" and key[2] in fusable:
            by_layer.setdefault(key[1], {})[key[2]] = ab
        else:
            out[key] = ab
    for il, parts in by_layer.items():
        if il >= len(model.params["layers"]):
            continue
        lw = model.params["layers"][il]
        qkv = {k: v for k, v in parts.items() if k.startswith("attn_")}
        if qkv:
            if "attn_qkv" in lw:
                dims = [cfg.n_heads * cfg.head_dim_k, cfg.n_kv_heads * cfg.head_dim_k,
                        cfg.n_kv_heads * cfg.head_dim_v]
                out[("layer", il, "attn_qkv")] = _fuse_pairs(
                    qkv, ["attn_q", "attn_k", "attn_v"], dims)
            elif "attn_qk" in lw:
                dims = [cfg.n_heads * cfg.head_dim_k, cfg.n_kv_heads * cfg.head_dim_k]
                qk = {k: v for k, v in qkv.items() if k != "attn_v"}
                if qk:
                    out[("layer", il, "attn_qk")] = _fuse_pairs(qk, ["attn_q", "attn_k"], dims)
                if "attn_v" in qkv:
                    out[("layer", il, "attn_v")] = qkv["attn_v"]
            else:
                for k, v in qkv.items():
                    out[("layer", il, k)] = v
        gu = {k: v for k, v in parts.items() if k.startswith("ffn_")}
        if gu:
            if "ffn_gateup" in lw:
                out[("layer", il, "ffn_gateup")] = _fuse_pairs(
                    gu, ["ffn_gate", "ffn_up"], [cfg.n_ff, cfg.n_ff])
            else:
                for k, v in gu.items():
                    out[("layer", il, k)] = v
    return out


def _bf16(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device, torch.bfloat16)


def apply_lora(model: Model, adapter: LoraAdapter, scale: float = 1.0) -> int:
    """Wrap matching weights in LoraWeight (a second adapter replaces the
    first). Returns the number of weights wrapped. Stacked expert weights
    are refused: their products go to the indexed-expert kernel, which
    takes no delta."""
    s = scale * adapter.alpha / max(adapter.rank, 1)
    n = 0
    for key, (a, b) in _remap_for_fusion(model, adapter.tensors).items():
        if key[0] == "global":
            tgt, wk = model.params, key[1]
        else:
            _, il, wk = key
            if il >= len(model.params["layers"]):
                continue
            tgt = model.params["layers"][il]
        base = tgt.get(wk)
        if base is None:
            continue
        if isinstance(base, LoraWeight):
            base = base.base  # replace the previous adapter
        if (base.q if isinstance(base, QuantTensor) else base).dim() == 3:
            raise ValueError(f"LoRA on the stacked expert weight {key} is not supported")
        tgt[wk] = LoraWeight(base=base, a=_bf16(a, model.device), b=_bf16(b, model.device),
                             scale=float(s))
        n += 1
    model.version += 1
    return n


def remove_lora(model: Model) -> int:
    n = 0
    for tgt in [model.params] + list(model.params["layers"]):
        for k, v in list(tgt.items()):
            if isinstance(v, LoraWeight):
                tgt[k] = v.base
                n += 1
    model.version += 1
    return n


# ---------------------------------------------------------------------------
# control vectors (reference llama_adapter_cvec; build_cvec per layer)
# ---------------------------------------------------------------------------

def load_control_vector(path: str, n_layers: int, n_embd: int) -> np.ndarray:
    """-> [n_layers, n_embd] additive residual directions (missing layers 0)."""
    f = read_gguf(path)
    out = np.zeros((n_layers, n_embd), np.float32)
    for name, info in f.tensors.items():
        if not name.startswith("direction."):
            continue
        il = int(name.split(".")[1])
        if 1 <= il <= n_layers:
            # the reference numbers layers from 1 (llama-adapter.cpp cvec load)
            out[il - 1] = dequantize_tensor(np.asarray(info.data), info.dtype, info.shape)
    return out


def apply_control_vector(model: Model, cvec: np.ndarray, strength: float = 1.0) -> None:
    model.params["cvec"] = torch.from_numpy(
        np.ascontiguousarray(cvec * strength, np.float32)).to(model.device)
    model.version += 1


def remove_control_vector(model: Model) -> None:
    model.params.pop("cvec", None)
    model.version += 1
