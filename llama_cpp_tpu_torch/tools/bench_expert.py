"""Device time of the indexed-expert kernel (ops/kernels/qmm_expert.py) at
the expert shapes that chip_smoke.py holds: a Mixtral-8x7B layer's three
products at R=2 (8 experts, Q4_K-like gate/up with mins at groups of 32,
Q6_K-like down at 16) and the Qwen3-30B-A3B gate and down stacks (128
experts, 2048 x 768) at R = 8 and 64 distinct experts and at 64 rows drawn
from 16 experts; DeepSeek-V3's (256 experts, 7168 x 2048 and 2048 x 7168)
at R = 8; gpt-oss-20B's (32 experts of 2880 x 2880, groups of 32, no
mins) at R = 4 and 32 and Llama-4-Scout's (16 experts, 5120 x 8192 and
8192 x 5120) at R = 1 and 8, each where the checkout's kernel takes the
stack (`supported`; a tree before 64-wide steps skips gpt-oss's). Random
planes from the smoke's seeds; CUDA events around each launch with the L2
flushed before it (utils/timing.py).

    python -m llama_cpp_tpu_torch.tools.bench_expert [--reps 20] [--rounds 2]

Prints one JSON line: the package it imported, the card, and per row the
ms of each round and the byte bound (x, ids, each distinct expert's planes
once, out, over 3.35 TB/s). It imports the package by its name only, so a
copy of this file (and of utils/timing.py) in another checkout times that
checkout's kernel, on the same card and in the same call.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)

    import torch

    import llama_cpp_tpu_torch
    from llama_cpp_tpu_torch.gguf.constants import GGMLType
    from llama_cpp_tpu_torch.ops.kernels import qmm_expert
    from llama_cpp_tpu_torch.ops.qtensor import QuantTensor
    from llama_cpp_tpu_torch.utils.timing import Timer

    if not torch.cuda.is_available():
        print("bench_expert: no CUDA device", file=sys.stderr)
        return 2
    timer = Timer()

    def stack(E, K, O, q4, seed, g=None, mins=None):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        g = g or (32 if q4 else 16)
        lo, hi = (0, 16) if q4 else (-32, 32)
        q = torch.randint(lo, hi, (E, K, O), generator=gen, device="cuda", dtype=torch.int8)
        sc = torch.rand((E, K // g, O), generator=gen, device="cuda") * 0.02 + 0.001
        with_mins = q4 if mins is None else mins
        mn = -(torch.rand((E, K // g, O), generator=gen, device="cuda") * 0.1) if with_mins else None
        return QuantTensor(q=q, scales=sc, mins=mn, group=g,
                           ggml_type=int(GGMLType.Q4_K if q4 else GGMLType.Q6_K),
                           transposed=True)

    def row(w, R, pool=None, seed=0):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        E, K, O = w.q.shape
        x = torch.randn((R, K), generator=gen, device="cuda").to(torch.bfloat16)
        if pool is not None:
            ids = torch.randint(0, pool, (R,), generator=gen, device="cuda", dtype=torch.int32)
        else:
            ids = torch.randperm(E, generator=gen, device="cuda")[:R].to(torch.int32)
        ms = [timer(lambda: qmm_expert.qmm_expert(x, ids, w), reps=args.reps)
              for _ in range(args.rounds)]
        per_expert = K * O + (K // w.group) * O * 4 * (2 if w.mins is not None else 1)
        nbytes = R * K * 2 + R * 4 + int(torch.unique(ids).numel()) * per_expert + R * O * 4
        return {"ms": ms, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}

    rows = {}
    for i, (name, K, O, q4) in enumerate((("gate", 4096, 14336, True),
                                          ("up", 4096, 14336, True),
                                          ("down", 14336, 4096, False))):
        w = stack(8, K, O, q4, seed=i)
        rows[f"mixtral {name} R=2"] = row(w, 2)
        del w
    for name, K, O, q4 in (("gate", 2048, 768, True), ("down", 768, 2048, False)):
        w = stack(128, K, O, q4, seed=7)
        for R, pool in ((8, None), (64, None), (64, 16)):
            rows[f"qwen3 {name} R={R}" + (" shared" if pool else "")] = row(w, R, pool)
        del w
    for label, E, K, O, q4, kw, rs in (
            ("deepseek-v3 gate", 256, 7168, 2048, True, {}, (8,)),
            ("deepseek-v3 down", 256, 2048, 7168, False, {}, (8,)),
            ("gpt-oss gate", 32, 2880, 2880, False, {"g": 32, "mins": False}, (4, 32)),
            ("scout gate", 16, 5120, 8192, True, {}, (1, 8)),
            ("scout down", 16, 8192, 5120, False, {}, (1, 8))):
        w = stack(E, K, O, q4, seed=11, **kw)
        if qmm_expert.supported(w):
            for R in rs:
                rows[f"{label} R={R}"] = row(w, R)
        del w
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"package": llama_cpp_tpu_torch.__file__, "card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
