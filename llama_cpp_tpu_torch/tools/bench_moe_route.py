"""Device time and peak device memory of the per-expert MoE route
(models/transformer._moe_ragged), the route of every MoE prefill ubatch, at
one 512-token ubatch of each model path's expert stacks: Qwen3-30B-A3B
(128 experts of 2048 x 768, top 8), DeepSeek-V2-Lite (64 of 2048 x 1408,
top 6), DeepSeek-V3 (256 of 7168 x 2048, top 8), gpt-oss-20B (32 of 2880 x
2880, MXFP4-like groups of 32 without mins, biases, the clamped GLU, top 4),
Mixtral-8x7B (8 of 4096 x 14336, top 2), Llama-4-Scout (16 of 5120 x 8192,
top 1, the gate on the expert input) and Qwen3-Next-80B-A3B (512 of 2048 x
512, top 10). Random planes (Q4_K-like gate and up with mins at groups of
32, Q6_K-like down at 16) and random routes from fixed seeds; CUDA events
around each call with the L2 flushed before it (utils/timing.py).

    python -m llama_cpp_tpu_torch.tools.bench_moe_route [--reps 5] [--rounds 2]
        [--save out.pt] [--against other.pt]

Prints one JSON line: the package it imported, the card, and per model the
ms of each round, the peak device memory the call allocates above what it
was given (MiB), and with --against the output's NMSE against another
run's --save. It imports the package by its name only, so with another
checkout first on PYTHONPATH it times that checkout's route on the same
card and inputs: run parent, change, change, parent in one call to compare
two trees.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

# name: (experts, top k, n_embd, expert width, kind); kind "k" is the
# Q4_K/Q6_K mix, "mxfp4" gpt-oss's groups of 32 without mins, with biases
SHAPES = {
    "qwen3-30b-a3b": (128, 8, 2048, 768, "k"),
    "deepseek-v2-lite": (64, 6, 2048, 1408, "k"),
    "deepseek-v3": (256, 8, 7168, 2048, "k"),
    "gpt-oss-20b": (32, 4, 2880, 2880, "mxfp4"),
    "mixtral-8x7b": (8, 2, 4096, 14336, "k"),
    "llama4-scout": (16, 1, 5120, 8192, "k"),
    "qwen3-next-80b-a3b": (512, 10, 2048, 512, "k"),
}
TOKENS = 512  # one prefill ubatch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--save", default=None, help="write each model's output here")
    ap.add_argument("--against", default=None, help="a --save file to hold the outputs to")
    args = ap.parse_args(argv)

    import torch

    import llama_cpp_tpu_torch
    from llama_cpp_tpu_torch.gguf.constants import GGMLType
    from llama_cpp_tpu_torch.models import transformer
    from llama_cpp_tpu_torch.models.config import ModelConfig
    from llama_cpp_tpu_torch.ops.qtensor import QuantTensor
    from llama_cpp_tpu_torch.utils.timing import Timer

    if not torch.cuda.is_available():
        print("bench_moe_route: no CUDA device", file=sys.stderr)
        return 2
    timer = Timer()
    gen = torch.Generator(device="cuda")

    def stack(E, K, O, g, mins, ggml_type):
        q = torch.randint(-8, 8, (E, K, O), generator=gen, device="cuda", dtype=torch.int8)
        sc = torch.rand((E, K // g, O), generator=gen, device="cuda") * 0.02 + 0.001
        mn = -(torch.rand((E, K // g, O), generator=gen, device="cuda") * 0.01) if mins else None
        return QuantTensor(q=q, scales=sc, mins=mn, group=g, ggml_type=int(ggml_type),
                           transposed=True)

    against = torch.load(args.against) if args.against else {}
    saved, rows = {}, {}
    for i, (name, (E, k, D, F, kind)) in enumerate(SHAPES.items()):
        gen.manual_seed(1000 + i)
        mx = kind == "mxfp4"
        cfg = ModelConfig(arch=name, n_embd=D, n_expert=E, n_expert_used=k, act="silu",
                          moe_act="swiglu_oai" if mx else "")
        if name == "llama4-scout":
            cfg.extra["moe_weight_before"] = True
        if mx:
            lw = {key: stack(E, a, b, 32, False, GGMLType.MXFP4)
                  for key, a, b in (("ffn_gate_exps", D, F), ("ffn_up_exps", D, F),
                                    ("ffn_down_exps", F, D))}
            for key, b in (("ffn_gate_exps", F), ("ffn_up_exps", F), ("ffn_down_exps", D)):
                lw[key + "_bias"] = torch.randn((E, b), generator=gen, device="cuda") * 0.01
        else:
            lw = {"ffn_gate_exps": stack(E, D, F, 32, True, GGMLType.Q4_K),
                  "ffn_up_exps": stack(E, D, F, 32, True, GGMLType.Q4_K),
                  "ffn_down_exps": stack(E, F, D, 16, False, GGMLType.Q6_K)}
        x = torch.randn((TOKENS, D), generator=gen, device="cuda").to(torch.bfloat16)
        scores = torch.rand((TOKENS, E), generator=gen, device="cuda")
        top, topi = scores.topk(k, dim=-1)
        topw = torch.softmax(top, dim=-1)

        def fn():
            return transformer._moe_ragged(cfg, lw, x, topi, topw, kernels=True)

        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        ms = [timer(fn, reps=args.reps) for _ in range(args.rounds)]
        row = {"ms": ms, "peak_mib": peak}
        if name in against:
            ref = against[name].to(out.device, torch.float32)
            row["nmse_against"] = float(((out.float() - ref) ** 2).mean()
                                        / ((ref ** 2).mean() + 1e-30))
        rows[name] = row
        if args.save:
            saved[name] = out.float().cpu()
        del lw, x, out
        torch.cuda.empty_cache()
    if args.save:
        torch.save(saved, args.save)
    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        card = torch.cuda.get_device_name(0)
    print(json.dumps({"package": llama_cpp_tpu_torch.__file__, "card": card,
                      "tokens": TOKENS, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
