"""GGUF -> GGUF requantization (llama-quantize analog; counterpart of the JAX
package's tools/quantize_tool.py, whose output files it writes byte for
byte). Numpy only: it needs no card.

    python -m llama_cpp_tpu_torch.tools.quantize_tool src.gguf dst.gguf q8_0
    python -m llama_cpp_tpu_torch.tools.quantize_tool src.gguf dst.gguf q4_k_m \
        --imatrix imatrix.npz
    python -m llama_cpp_tpu_torch.tools.quantize_tool src.gguf dst.gguf q5_k_m --dry-run

Parity: reference src/llama-quant.cpp: per-tensor target types chosen by
role and file type (llama_tensor_get_type_impl :424, condensed as the JAX
package condenses it), imatrix-weighted quantization, dry-run sizing; the
tools/quantize command line.
"""

from __future__ import annotations

import argparse
import time
from typing import Any

import numpy as np

from ..gguf.constants import FileType, GGMLType
from ..gguf.reader import read_gguf
from ..gguf.writer import GGUFWriter
from ..quant.dequant import dequantize_tensor
from ..quant.quantize import _QUANT, IMATRIX_AWARE, quantize

# file type name -> (default tensor type, general.file_type id)
FTYPES = {
    "f32": (GGMLType.F32, FileType.ALL_F32),
    "f16": (GGMLType.F16, FileType.MOSTLY_F16),
    "bf16": (GGMLType.BF16, FileType.MOSTLY_BF16),
    "q8_0": (GGMLType.Q8_0, FileType.MOSTLY_Q8_0),
    "q4_0": (GGMLType.Q4_0, FileType.MOSTLY_Q4_0),
    "q4_1": (GGMLType.Q4_1, FileType.MOSTLY_Q4_1),
    "q5_0": (GGMLType.Q5_0, FileType.MOSTLY_Q5_0),
    "q5_1": (GGMLType.Q5_1, FileType.MOSTLY_Q5_1),
    "q2_k": (GGMLType.Q2_K, FileType.MOSTLY_Q2_K),
    "q3_k_m": (GGMLType.Q3_K, FileType.MOSTLY_Q3_K_M),
    "q4_k_s": (GGMLType.Q4_K, FileType.MOSTLY_Q4_K_S),
    "q4_k_m": (GGMLType.Q4_K, FileType.MOSTLY_Q4_K_M),
    "q5_k_s": (GGMLType.Q5_K, FileType.MOSTLY_Q5_K_S),
    "q5_k_m": (GGMLType.Q5_K, FileType.MOSTLY_Q5_K_M),
    "q6_k": (GGMLType.Q6_K, FileType.MOSTLY_Q6_K),
    "mxfp4": (GGMLType.MXFP4, FileType.MOSTLY_MXFP4),
    "iq4_nl": (GGMLType.IQ4_NL, FileType.MOSTLY_IQ4_NL),
    "iq4_xs": (GGMLType.IQ4_XS, FileType.MOSTLY_IQ4_XS),
    "iq3_s": (GGMLType.IQ3_S, FileType.MOSTLY_IQ3_S),
    "iq2_xs": (GGMLType.IQ2_XS, FileType.MOSTLY_IQ2_XS),
}


def tensor_target_type(name: str, shape: tuple[int, ...], default: GGMLType,
                       ftype_name: str) -> GGMLType:
    """Role-based type choice (reference llama_tensor_get_type_impl:424,
    condensed): 1-D tensors, norms, biases and rows not a multiple of 256
    stay F32; the head takes Q6_K at the low-bit types, token_embd Q4_K at
    Q2_K; the "_m" mixes give attn_v Q6_K over Q4_K and Q5_K."""
    if len(shape) == 1 or shape[-1] % 256 != 0 or "norm" in name or name.endswith(".bias"):
        return GGMLType.F32
    low_bit = default in (GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q4_0, GGMLType.Q4_K)
    if name == "output.weight" and low_bit:
        return GGMLType.Q6_K
    if name == "token_embd.weight" and default == GGMLType.Q2_K:
        return GGMLType.Q4_K
    if ("_m" in ftype_name and ".attn_v.weight" in name
            and default in (GGMLType.Q4_K, GGMLType.Q5_K)):
        return GGMLType.Q6_K
    return default


def quantize_model(src_path: str, dst_path: str, ftype: str = "q4_k_m",
                   imatrix: dict[str, np.ndarray] | None = None, dry_run: bool = False,
                   progress=None) -> dict[str, Any]:
    """Requantize every tensor of src_path to its target type for `ftype`
    (a tensor already of that type is copied), then write dst_path unless
    dry_run. `imatrix` maps a tensor name to per-column importance weights
    for the IMATRIX_AWARE types. -> counts, bytes in and out, and seconds."""
    ftype = ftype.lower()
    if ftype not in FTYPES:
        raise ValueError(f"unknown ftype {ftype}; have {sorted(FTYPES)}")
    default_type, ftype_id = FTYPES[ftype]
    if default_type not in _QUANT and default_type not in (
            GGMLType.F32, GGMLType.F16, GGMLType.BF16):
        raise ValueError(f"no quantizer for {default_type.name}")

    f = read_gguf(src_path)
    w = GGUFWriter()
    for k, v in f.metadata.items():
        w.add(k, v)
    w.add("general.file_type", np.uint32(int(ftype_id)))
    w.add("general.quantization_version", np.uint32(2))

    stats = {"n_tensors": 0, "in_bytes": 0, "out_bytes": 0, "per_type": {}}
    t0 = time.time()
    for i, (name, info) in enumerate(f.tensors.items()):
        target = tensor_target_type(name, info.shape, default_type, ftype)
        if target == info.dtype:
            data = np.asarray(info.data).tobytes()
        else:
            arr = dequantize_tensor(np.asarray(info.data), info.dtype, info.shape)
            qw = None
            if imatrix is not None and target in IMATRIX_AWARE:
                row_w = imatrix.get(name)
                if row_w is not None and row_w.shape[0] == info.shape[-1]:
                    qw = np.broadcast_to(row_w, arr.shape)
            data = quantize(arr, target, qw=qw).tobytes()
        stats["n_tensors"] += 1
        stats["in_bytes"] += info.n_bytes
        stats["out_bytes"] += len(data)
        stats["per_type"][target.name] = stats["per_type"].get(target.name, 0) + 1
        if not dry_run:
            w.add_tensor(name, data, info.ne, target)
        if progress:
            progress(i + 1, len(f.tensors), name, target.name)
    if not dry_run:
        w.write(dst_path)
    stats["t_s"] = time.time() - t0
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("llama-quantize (PyTorch port)")
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("ftype", nargs="?", default="q4_k_m")
    ap.add_argument("--imatrix", help="imatrix .npz file")
    ap.add_argument("--dry-run", action="store_true")
    args = ap.parse_args(argv)

    imatrix = dict(np.load(args.imatrix)) if args.imatrix else None

    def prog(i, n, name, t):
        print(f"[{i:4d}/{n}] {name} -> {t}", flush=True)

    stats = quantize_model(args.src, args.dst, args.ftype, imatrix, dry_run=args.dry_run,
                           progress=prog)
    mb = 1024 * 1024
    print(f"done: {stats['n_tensors']} tensors, "
          f"{stats['in_bytes']/mb:.1f} MiB -> {stats['out_bytes']/mb:.1f} MiB "
          f"in {stats['t_s']:.1f}s; types: {stats['per_type']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
