"""Benchmark tool (llama-bench + llama-batched-bench analog; counterpart of
the JAX package's tools/bench_tool.py).

    python -m llama_cpp_tpu_torch.tools.bench_tool -m m.gguf -p 512 -n 32 -o json
    python -m llama_cpp_tpu_torch.tools.bench_tool -m m.gguf --batched -b 1,8

Measures pp{N} (prompt throughput), tg{N} (decode throughput through
Context.generate_ondevice, one graph replay a token on the card), optionally
at KV depth d{N}, and a batched PP/TG/B grid with aggregate S t/s: the
measurement axes of reference tools/llama-bench/llama-bench.cpp:322-362 and
tools/batched-bench. Output: markdown or JSON. Runs on the card unless
--device cpu is given (the plain PyTorch versions, which measure nothing of
the card). --no-quant (dense weights) is not ported and exits with 2.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def bench_pp(ctx, n_prompt: int, n_rep: int = 3) -> float:
    rng = np.random.default_rng(0)
    prompt = list(rng.integers(10, ctx.cfg.vocab_size - 10, n_prompt))
    ctx.seq_rm(0)
    ctx.prefill(prompt)  # warm-up: the caching allocator's first allocations
    times = []
    for _ in range(n_rep):
        ctx.seq_rm(0)
        t0 = time.perf_counter()
        ctx.prefill(prompt)
        times.append(time.perf_counter() - t0)
    return n_prompt / min(times)


def bench_tg(ctx, n_gen: int, depth: int = 0, n_rep: int = 2) -> float:
    rng = np.random.default_rng(0)
    ctx.seq_rm(0)
    if depth:
        ctx.prefill(list(rng.integers(10, ctx.cfg.vocab_size - 10, depth)))
    else:
        ctx.prefill([1])
    # warm-up: captures the B=1 decode graph
    ctx.generate_ondevice([int(rng.integers(10, 100))], max_new_tokens=9, chunk=8)
    best = 0.0
    for _ in range(n_rep):
        ctx.perf.t_decode_ms = 0.0
        ctx.perf.n_decode = 0
        ctx.generate_ondevice(
            [int(rng.integers(10, 100))], max_new_tokens=n_gen + 1, chunk=min(32, n_gen)
        )
        if ctx.perf.n_decode:
            best = max(best, ctx.perf.n_decode / (ctx.perf.t_decode_ms / 1e3))
    return best


def bench_batched(ctx, pp: int, tg: int, batch: int) -> dict:
    """PP/TG/B grid row (batched-bench analog): B parallel sequences."""
    rng = np.random.default_rng(0)
    if batch > ctx.n_seqs:
        raise ValueError(f"batch {batch} > the context's {ctx.n_seqs} sequences")
    t0 = time.perf_counter()
    for b in range(batch):
        ctx.seq_rm(b)
        ctx.prefill(list(rng.integers(10, ctx.cfg.vocab_size - 10, pp)), seq=b)
    t_pp = time.perf_counter() - t0
    toks = rng.integers(10, 100, batch)
    seqs = np.arange(batch)
    ctx.decode_step_multi(toks, seqs)  # warm-up
    t0 = time.perf_counter()
    for _ in range(tg - 1):
        logits = ctx.decode_step_multi(toks, seqs)
        toks = logits.argmax(axis=-1)
    t_tg = time.perf_counter() - t0
    return {
        "PP": pp, "TG": tg, "B": batch,
        "S_PP t/s": round(batch * pp / t_pp, 2),
        "S_TG t/s": round(batch * (tg - 1) / t_tg, 2),
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("llama-bench (CUDA)")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-p", "--n-prompt", type=int, default=512)
    ap.add_argument("-n", "--n-gen", type=int, default=64)
    ap.add_argument("-d", "--depth", type=int, default=0)
    ap.add_argument("-c", "--ctx-size", type=int, default=2048)
    ap.add_argument("--batched", action="store_true", help="PP/TG/B grid")
    ap.add_argument("-b", "--batch-sizes", default="1,2,4,8")
    ap.add_argument("-o", "--output", choices=("md", "json"), default="md")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), or cpu for the plain PyTorch versions")
    ap.add_argument("--no-quant", action="store_true", help="not ported (exits with 2)")
    return ap


def main(argv=None) -> int:
    from .args import apply_env_and_preset

    args = apply_env_and_preset(build_parser(), argv)
    if args.no_quant:
        print("llama-bench: --no-quant is not ported yet to the PyTorch/CUDA package",
              file=sys.stderr)
        return 2

    from ..models.loader import load_model
    from ..runtime.context import Context

    model = load_model(args.model, device=args.device)
    rows = []
    if args.batched:
        batches = [int(b) for b in args.batch_sizes.split(",")]
        ctx = Context(model, n_ctx=args.ctx_size, n_seqs=max(batches), device=args.device)
        for b in batches:
            rows.append(bench_batched(ctx, args.n_prompt, args.n_gen, b))
    else:
        ctx = Context(model, n_ctx=args.ctx_size, n_seqs=1, device=args.device)
        pp = bench_pp(ctx, args.n_prompt)
        tg = bench_tg(ctx, args.n_gen, depth=args.depth)
        label_tg = f"tg{args.n_gen}" + (f"@d{args.depth}" if args.depth else "")
        rows = [
            {"test": f"pp{args.n_prompt}", "t/s": round(pp, 2)},
            {"test": label_tg, "t/s": round(tg, 2)},
        ]

    if args.output == "json":
        print(json.dumps({"model": args.model, "results": rows}, indent=2))
    else:
        keys = list(rows[0].keys())
        print("| " + " | ".join(keys) + " |")
        print("|" + "|".join("---" for _ in keys) + "|")
        for r in rows:
            print("| " + " | ".join(str(r[k]) for k in keys) + " |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
