"""Model loader for the llama family: GGUF file -> (ModelConfig, weights on
the device).

Analog of reference llama_model_loader + llama_model::load_tensors
(src/llama-model-loader.cpp; src/models/llama.cpp:35-94). Weights are read
from the memory-mapped GGUF blob, repacked to planes on the host
(quant/repack.py) and copied to the device once per plane. After load,
same-type projections are fused (q+k, gate+up) and the vocab head is padded.
"""

from __future__ import annotations

import logging
from dataclasses import replace
from typing import Any

import numpy as np
import torch

from ..gguf.reader import GGUFFile, read_gguf
from ..ops.qtensor import QuantTensor, Weight, load_weight, pad_out_features
from ..tokenizer import Tokenizer
from .config import ModelConfig

log = logging.getLogger(__name__)

# layer-tensor suffix -> weight-dict key (the llama subset)
LAYER_TENSORS = {
    "attn_norm.weight": "attn_norm",
    "attn_q.weight": "attn_q",
    "attn_k.weight": "attn_k",
    "attn_v.weight": "attn_v",
    "attn_output.weight": "attn_output",
    "attn_sinks.weight": "attn_sinks",
    # per-tensor scalar scales (folded into the weight at load)
    "attn_q.scale": "attn_q.__scale",
    "attn_k.scale": "attn_k.__scale",
    "attn_v.scale": "attn_v.__scale",
    "attn_output.scale": "attn_output.__scale",
    "ffn_gate.scale": "ffn_gate.__scale",
    "ffn_up.scale": "ffn_up.__scale",
    "ffn_down.scale": "ffn_down.__scale",
    "ffn_norm.weight": "ffn_norm",
    "ffn_gate.weight": "ffn_gate",
    "ffn_up.weight": "ffn_up",
    "ffn_down.weight": "ffn_down",
    # mixture of experts: router, stacked experts, shared experts
    "ffn_gate_inp.weight": "ffn_gate_inp",
    "ffn_gate_inp.bias": "ffn_gate_inp_bias",
    "exp_probs_b.bias": "exp_probs_b",
    "ffn_gate_exps.weight": "ffn_gate_exps",
    "ffn_up_exps.weight": "ffn_up_exps",
    "ffn_down_exps.weight": "ffn_down_exps",
    "ffn_gate_exps.bias": "ffn_gate_exps_bias",
    "ffn_up_exps.bias": "ffn_up_exps_bias",
    "ffn_down_exps.bias": "ffn_down_exps_bias",
    "ffn_gate_shexp.weight": "ffn_gate_shexp",
    "ffn_up_shexp.weight": "ffn_up_shexp",
    "ffn_down_shexp.weight": "ffn_down_shexp",
    "ffn_gate_inp_shexp.weight": "ffn_gate_inp_shexp",
}

GLOBAL_TENSORS = {
    "token_embd.weight": "token_embd",
    "output_norm.weight": "output_norm",
    "output.weight": "output",
    "rope_freqs.weight": "rope_factors",
}

# 1-D tensors stay dense fp32; everything else follows its storage type
# (the router ffn_gate_inp is not a dense key: an F32 router lands as a dense
# compute-dtype [out, in] weight through the storage-type route)
_DENSE_KEYS = {"attn_norm", "ffn_norm", "output_norm", "rope_factors", "attn_sinks",
               "ffn_gate_inp_bias", "exp_probs_b", "ffn_gate_exps_bias", "ffn_up_exps_bias",
               "ffn_down_exps_bias"}


def resolve_device(device) -> torch.device:
    """The entry points run on the card unless the caller asks for the CPU;
    without a card they raise instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run the "
                           "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class Model:
    def __init__(self, cfg: ModelConfig, params: dict[str, Any], device: torch.device,
                 tokenizer: Tokenizer | None = None, gguf: GGUFFile | None = None):
        self.cfg = cfg
        self.params = params
        self.device = device
        self.tokenizer = tokenizer  # None when the file carries no vocab
        self.gguf = gguf  # the parsed file: metadata and tensor index


def load_model(path: str, device="cuda") -> Model:
    """Load a llama-family GGUF model onto `device` (bf16 activations)."""
    dev = resolve_device(device)
    f = read_gguf(path)
    cfg = ModelConfig.from_gguf(f.metadata)
    tokenizer = None
    try:
        tokenizer = Tokenizer.from_gguf(f.metadata)
    except (ValueError, KeyError) as e:
        log.warning("no tokenizer loaded: %s", e)

    layers: list[dict[str, Weight]] = [dict() for _ in range(cfg.n_layers)]
    params: dict[str, Any] = {"layers": layers}
    for name, info in f.tensors.items():
        key = target = None
        if name in GLOBAL_TENSORS:
            key, target = GLOBAL_TENSORS[name], params
        elif name.startswith("blk."):
            _, il, suffix = name.split(".", 2)
            key = LAYER_TENSORS.get(suffix)
            if key is not None and int(il) < cfg.n_layers:
                target = layers[int(il)]
        if key is None or target is None:
            continue
        dense = key in _DENSE_KEYS or len(info.shape) == 1
        # matmul weights store transposed planes; the embedding table stays
        # row-major for the row gather
        transpose = not dense and key != "token_embd" and len(info.shape) >= 2
        target[key] = load_weight(
            np.asarray(info.data), info.dtype, info.shape,
            prefer_quant=not dense,
            dense_dtype=torch.float32 if dense else cfg.compute_dtype,
            transpose=transpose, device=dev)

    stand_ins = {"ffn_down": ("ffn_down_exps",)}  # an MoE layer's experts
    missing = [f"layer {i} missing {k}" for i, lw in enumerate(layers)
               for k in ("attn_norm", "attn_output", "ffn_norm", "ffn_down")
               if k not in lw and not any(a in lw for a in stand_ins.get(k, ()))]
    if missing:
        raise ValueError(f"model load incomplete: {missing[:4]}")
    for lw in layers:
        _fold_scalar_scales(lw)
    for lw in layers:
        _fuse_projections(lw)
    if "rope_factors" in params:
        cfg.extra["rope_factors_arr"] = params["rope_factors"].float().cpu().numpy()
    # vocab-head O padding: 128256-style widths have no wide multiple-of-128
    # divisors; pad to a 4096 multiple once, matmul slices via out_dim
    hw = params.get("output")
    if (isinstance(hw, QuantTensor) and hw.transposed and hw.q.dim() == 2
            and hw.q.shape[1] % 1024 and hw.q.shape[1] >= 16384):
        params["output"] = pad_out_features(hw)
    return Model(cfg, params, dev, tokenizer=tokenizer, gguf=f)


def _fold_scalar_scales(lw: dict) -> None:
    """Fold per-tensor scalar scales (`<w>.scale`, reference
    src/models/bitnet.cpp wq_s/...) into the weight: lossless for quantized
    planes (scale planes multiply) and dense weights alike."""
    for key in [k for k in list(lw) if k.endswith(".__scale")]:
        base = key[: -len(".__scale")]
        s = float(lw.pop(key).reshape(-1)[0])
        w = lw.get(base)
        if w is None or s == 1.0:
            continue
        if isinstance(w, QuantTensor):
            if w.d is not None:
                lw[base] = replace(w, d=w.d * s, dmin=None if w.dmin is None else w.dmin * s)
            else:
                lw[base] = replace(w, scales=w.scales * s,
                                   mins=None if w.mins is None else w.mins * s)
        else:
            lw[base] = w * s


def _concat_weights(ws: list) -> Weight | None:
    """Concatenate same-type projection weights along the output axis."""
    if any(isinstance(w, QuantTensor) and w.q.dim() == 3 for w in ws):
        raise ValueError("stacked expert planes [E, K, O] are not fused along the output "
                         "axis: the expert kernel takes one stack per projection")
    if all(isinstance(w, QuantTensor) for w in ws):
        if len({(w.group, w.ggml_type, w.transposed, w.packed, w.hier, w.sgroup)
                for w in ws}) != 1:
            return None
        if not ws[0].transposed or any(w.q.dim() != 2 for w in ws):
            return None
        if len({w.q.shape[0] for w in ws}) != 1:
            return None
        have_mins = [w.mins is not None for w in ws]
        if any(have_mins) and not all(have_mins):
            return None

        def cat(name):
            parts = [getattr(w, name) for w in ws]
            return None if parts[0] is None else torch.cat(parts, dim=-1)

        return QuantTensor(q=cat("q"), scales=cat("scales"), mins=cat("mins"),
                           group=ws[0].group, ggml_type=ws[0].ggml_type, transposed=True,
                           packed=ws[0].packed, d=cat("d"), dmin=cat("dmin"),
                           sgroup=ws[0].sgroup)
    if all(isinstance(w, torch.Tensor) for w in ws):
        if len({w.dtype for w in ws}) != 1 or any(w.dim() != 2 for w in ws):
            return None
        if len({w.shape[1] for w in ws}) != 1:
            return None
        return torch.cat(ws, dim=0)  # dense [out, in]
    return None


def _fuse_projections(lw: dict) -> None:
    """Fuse Q/K/V and gate/up projections into single matmuls (fewer
    launches per layer). Q4_K_M stores attn_v as Q6_K (reference
    llama_tensor_get_type, src/llama-quant.cpp:424): then q+k fuse and v
    stays standalone."""
    if all(k in lw for k in ("attn_q", "attn_k", "attn_v")):
        fused = _concat_weights([lw["attn_q"], lw["attn_k"], lw["attn_v"]])
        if fused is not None:
            lw["attn_qkv"] = fused
            for k in ("attn_q", "attn_k", "attn_v"):
                del lw[k]
        else:
            fused = _concat_weights([lw["attn_q"], lw["attn_k"]])
            if fused is not None:
                lw["attn_qk"] = fused
                del lw["attn_q"], lw["attn_k"]
    if all(k in lw for k in ("ffn_gate", "ffn_up")):
        fused = _concat_weights([lw["ffn_gate"], lw["ffn_up"]])
        if fused is not None:
            lw["ffn_gateup"] = fused
            del lw["ffn_gate"], lw["ffn_up"]
