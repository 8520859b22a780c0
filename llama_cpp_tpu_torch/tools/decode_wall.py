"""Wall time of B=1 greedy decode steps on the card, by the host clock, on
a Llama-3-8B-shaped Q4_K_M model with random weights from a seed.

    python -m llama_cpp_tpu_torch.tools.decode_wall [--layers 4] [--depth 512]
        [--steps 32] [--rounds 3] [--model PATH]

Makes the model file (testing.make_bench_llama_gguf, full width, depth cut
to --layers) unless --model names one that exists, loads it, prefills
--depth tokens on sequence 0 of a paged int8 KV pool and times --rounds
runs of --steps decode_one calls after one untimed run. Prints one JSON
line: the package it imported, the card, and the ms a step of each round.

It imports the package by its name only, so a copy of this file in another
checkout's tools/ times that checkout, on the same card and in the same
call when both are run from one command.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--depth", type=int, default=512)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--model", default=None, help="GGUF file; made if it does not exist")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import llama_cpp_tpu_torch
    from llama_cpp_tpu_torch.models.loader import load_model
    from llama_cpp_tpu_torch.runtime.context import Context
    from llama_cpp_tpu_torch.testing import make_bench_llama_gguf

    if not torch.cuda.is_available():
        print("decode_wall: no CUDA device; this tool times the card", file=sys.stderr)
        return 2
    path = args.model or f"llama8b-q4km-{args.layers}l.gguf"
    if not os.path.exists(path):
        make_bench_llama_gguf(path, n_layers=args.layers, seed=0)
    model = load_model(path)
    ctx = Context(model, n_ctx=4096, n_seqs=2, n_ubatch=512, quantized_kv=True)
    prompt = [int(t) for t in np.random.default_rng(7).integers(3, 128256, args.depth)]
    tok = int(np.argmax(ctx.prefill(prompt, seq=0)))
    rounds = []
    for r in range(args.rounds + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            tok = int(ctx.decode_one(tok, seq=0).argmax())
        if r:
            rounds.append((time.perf_counter() - t0) * 1e3 / args.steps)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[:1]
    print(json.dumps({"package": os.path.dirname(llama_cpp_tpu_torch.__file__),
                      "card": card[0] if card else torch.cuda.get_device_name(0),
                      "layers": args.layers, "depth": args.depth, "steps": args.steps,
                      "wall_ms_per_step": rounds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
