"""export-lora: merge a LoRA adapter into a base GGUF (reference
tools/export-lora/export-lora.cpp; port of the JAX package's
tools/export_lora.py, numpy only, whose file it writes byte for byte).

    python -m llama_cpp_tpu_torch.tools.export_lora -m base.gguf --lora a.gguf -o out.gguf

Each matching tensor is dequantized, W + scale * B @ A applied, and
requantized to its original storage type (F16 where the type has no
quantizer); everything else is copied verbatim.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..gguf.constants import GGMLType
from ..gguf.reader import read_gguf
from ..gguf.writer import GGUFWriter
from ..models.adapters import load_lora, lora_key
from ..quant.dequant import dequantize_tensor
from ..quant.quantize import quantize


def merge_lora(base_path: str, lora_path: str, out_path: str, scale: float = 1.0) -> int:
    base = read_gguf(base_path)
    adapter = load_lora(lora_path)
    s = scale * adapter.alpha / max(adapter.rank, 1)

    w = GGUFWriter()
    for k, v in base.metadata.items():
        w.add(k, v)

    n_merged = 0
    for name, info in base.tensors.items():
        key = lora_key(name)
        raw = np.asarray(info.data)
        if key is not None and key in adapter.tensors:
            a, b = adapter.tensors[key]
            W = dequantize_tensor(raw, info.dtype, info.shape).astype(np.float32)
            W = W + s * (b.astype(np.float32) @ a.astype(np.float32))
            dt = GGMLType(info.dtype)
            if dt == GGMLType.F32:
                data = W.astype(np.float32).tobytes()
            elif dt == GGMLType.F16:
                data = W.astype(np.float16).tobytes()
            else:
                try:
                    data = quantize(W, dt).tobytes()
                except (KeyError, NotImplementedError):
                    dt = GGMLType.F16
                    data = W.astype(np.float16).tobytes()
            w.add_tensor(name, data, tuple(reversed(W.shape)), dt)
            n_merged += 1
        else:
            w.add_tensor(name, raw.tobytes(), tuple(reversed(info.shape)), GGMLType(info.dtype))
    w.write(out_path)
    return n_merged


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("export-lora (CUDA port, numpy only)")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("--lora", required=True)
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--lora-scale", type=float, default=1.0)
    args = ap.parse_args(argv)
    n = merge_lora(args.model, args.lora, args.output, args.lora_scale)
    print(f"merged {n} tensors -> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
