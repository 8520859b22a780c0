"""Wall time of greedy decode steps on the card, graphed against eager, on
a Llama-3-8B-shaped Q4_K_M model with random weights from a seed.

    python -m llama_cpp_tpu_torch.tools.decode_wall [--layers 4] [--depth 512]
        [--steps 32] [--rounds 3] [--batches 1,8] [--model PATH]

Makes the model file (testing.make_bench_llama_gguf, full width, depth cut
to --layers) unless --model names one that exists, loads it, and for each
loop, the CUDA-graph loop (Context(graphs=True), one replay a step) and the
eager loop (graphs=False, the same step body launched from the host),
prefills --depth tokens on each of the largest batch's sequences of a paged
int8 KV pool, then at each batch size times --rounds calls of
decode_steps_greedy(--steps) after an untimed one (the graph's capture) by
the host clock, and one more call under torch.profiler for the device time
a step, its kernel launches and the device's busy share. Prints one JSON
line: the package it imported, the card, and per (loop, B) the wall ms a
step of each round, the device ms and launches a step, and the busy share
(device ms over the rounds' best wall ms).

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


def profile_steps(torch, fn, steps: int) -> dict:
    """Run fn() (which runs `steps` decode steps) under torch.profiler ->
    device ms a step (kernels and copies), kernel launches a step and the
    set of kernel names (the host's copies of inputs and ids left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernels = [e for e in device if not e.key.startswith(("Memcpy", "Memset"))]
    return {"device_ms_per_step": sum(e.self_device_time_total for e in device) / 1e3 / steps,
            "launches_per_step": sum(e.count for e in kernels) / steps,
            "kernels": sorted({e.key for e in kernels})}


def measure(torch, ctx, batches, steps: int, rounds: int) -> list[dict]:
    """Per batch size: wall ms a step of `rounds` decode_steps_greedy calls
    of `steps` steps over sequences 0..B-1 (already prefilled), after an
    untimed call, then the profiled call."""
    import numpy as np

    rows = []
    for B in batches:
        seqs = np.arange(B)
        toks = np.full(B, 1, np.int32)
        toks = ctx.decode_steps_greedy(toks, seqs, 2)[:, -1]  # capture / warm-up
        walls = []
        for _ in range(rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = ctx.decode_steps_greedy(toks, seqs, steps)[:, -1]
            walls.append((time.perf_counter() - t0) * 1e3 / steps)
        prof = profile_steps(torch, lambda: ctx.decode_steps_greedy(toks, seqs, steps), steps)
        rows.append({"graphs": ctx.graphs, "B": B, "wall_ms_per_step": walls,
                     "busy_share": prof["device_ms_per_step"] / min(walls), **prof})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--depth", type=int, default=512)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--batches", default="1,8")
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
    batches = [int(b) for b in args.batches.split(",")]
    path = args.model or f"llama8b-q4km-{args.layers}l.gguf"
    if not os.path.exists(path):
        make_bench_llama_gguf(path, n_layers=args.layers, seed=0)
    model = load_model(path)
    rng = np.random.default_rng(7)
    rows = []
    for graphs in (True, False):
        ctx = Context(model, n_ctx=4096, n_seqs=max(batches), n_ubatch=512, quantized_kv=True,
                      graphs=graphs)
        for s in range(max(batches)):
            ctx.prefill([int(t) for t in rng.integers(3, 128256, args.depth)], seq=s)
        rows += measure(torch, ctx, batches, args.steps, args.rounds)
        del ctx
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[:1]
    for r in rows:
        del r["kernels"]
    print(json.dumps({"package": os.path.dirname(llama_cpp_tpu_torch.__file__),
                      "card": card[0] if card else torch.cuda.get_device_name(0),
                      "layers": args.layers, "depth": args.depth, "steps": args.steps,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
