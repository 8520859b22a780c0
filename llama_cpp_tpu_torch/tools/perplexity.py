"""Perplexity harness (llama-perplexity analog; counterpart of the JAX
package's tools/perplexity.py): sliding-chunk wikitext-style PPL,
KL-divergence against base logits, and multiple-choice scoring.

    python -m llama_cpp_tpu_torch.tools.perplexity -m m.gguf -f text.txt -c 512

Method parity with reference tools/perplexity/perplexity.cpp:444:
tokenize the whole corpus, split into n_ctx chunks, evaluate each chunk in
n_ubatch ubatches with the logits of every row, score only the second half
of each chunk (the first half is context burn-in), PPL = exp(mean nll). KL
mode mirrors --kl-divergence-base. A ubatch of 512 rows runs the vocab head
through the prefill GEMM (K4) on the card; from 1024 rows the product takes
the library route, as the JAX package's does. Runs on the card unless
--device cpu is given; --no-quant loads dense bf16 weights (their products
on the library route).
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass

import numpy as np


@dataclass
class PPLResult:
    ppl: float
    ppl_err: float  # standard error (matches reference +/- reporting)
    n_tokens: int
    nll_sum: float

    def __str__(self):
        return f"PPL = {self.ppl:.4f} +/- {self.ppl_err:.5f} over {self.n_tokens} tokens"


def _log_softmax_row(logits: np.ndarray, target: int) -> float:
    m = logits.max()
    return float(logits[target] - m - math.log(np.exp(logits - m).sum()))


def perplexity(
    ctx,
    text: str | None = None,
    tokens: list[int] | None = None,
    n_ctx: int = 512,
    progress=None,
) -> PPLResult:
    """Compute PPL with the reference chunking: logits for the second half of
    each n_ctx-token chunk are scored against the next token."""
    if tokens is None:
        tok = ctx.model.tokenizer
        tokens = tok.encode(text, add_special=True, parse_special=False)
    n_chunk = len(tokens) // n_ctx
    if n_chunk < 1:
        raise ValueError(f"corpus too small: {len(tokens)} tokens < n_ctx {n_ctx}")

    nll = 0.0
    nll2 = 0.0
    count = 0
    first = max(1, min(n_ctx // 2, n_ctx - 1))
    for ic in range(n_chunk):
        chunk = tokens[ic * n_ctx : (ic + 1) * n_ctx]
        ctx.seq_rm(0)
        logits = eval_chunk_logits(ctx, chunk)
        for j in range(first, n_ctx - 1):
            lp = _log_softmax_row(logits[j].astype(np.float64), chunk[j + 1])
            nll += -lp
            nll2 += lp * lp
            count += 1
        if progress:
            cur = math.exp(nll / count)
            progress(ic + 1, n_chunk, cur)
    mean = nll / count
    var = nll2 / count - mean * mean
    err = math.sqrt(max(var, 0.0) / count) * math.exp(mean)
    return PPLResult(ppl=math.exp(mean), ppl_err=err, n_tokens=count, nll_sum=nll)


def eval_chunk_logits(ctx, chunk: list[int]) -> np.ndarray:
    """All-position logits for one chunk (ubatched through the context)."""
    outs = []
    for off in range(0, len(chunk), ctx.n_ubatch):
        ub = chunk[off : off + ctx.n_ubatch]
        positions = np.arange(off, off + len(ub))
        logits = ctx.decode(
            np.asarray(ub)[None, :],
            np.asarray([0]),
            positions[None, :],
            np.arange(len(ub)),
        )
        outs.append(logits)
    ctx.seq_len[0] = 0
    return np.concatenate(outs, axis=0)


def kl_divergence(
    ctx, tokens: list[int], base_logits: np.ndarray, n_ctx: int = 512
) -> dict:
    """KL(base || current) per token vs saved base logits
    (reference perplexity.cpp:175-255)."""
    n_chunk = len(tokens) // n_ctx
    kls = []
    same_top = 0
    total = 0
    for ic in range(n_chunk):
        chunk = tokens[ic * n_ctx : (ic + 1) * n_ctx]
        ctx.seq_rm(0)
        logits = eval_chunk_logits(ctx, chunk)
        for j in range(n_ctx - 1):
            p = base_logits[ic * n_ctx + j].astype(np.float64)
            q = logits[j].astype(np.float64)
            p = p - p.max()
            q = q - q.max()
            pe = np.exp(p)
            pe /= pe.sum()
            qlse = math.log(np.exp(q).sum())
            plse = math.log(np.exp(p).sum())
            kls.append(float(np.sum(pe * ((p - plse) - (q - qlse)))))
            same_top += int(np.argmax(p) == np.argmax(q))
            total += 1
    return {
        "kl_mean": float(np.mean(kls)),
        "kl_p99": float(np.percentile(kls, 99)),
        "same_top_frac": same_top / max(total, 1),
    }


def continuation_logprob(ctx, context_ids: list[int], cont_ids: list[int]) -> float:
    """Sum log p(cont | context) — the multiple-choice scoring primitive
    (reference hellaswag_score, tools/perplexity/perplexity.cpp:744)."""
    ids = context_ids + cont_ids
    ctx.seq_rm(0)
    logits = eval_chunk_logits(ctx, ids)  # [len(ids)-? , vocab]
    lp = 0.0
    for j, t in enumerate(cont_ids):
        row = logits[len(context_ids) - 1 + j]
        lp += _log_softmax_row(row.astype(np.float64), t)
    return lp


def multiple_choice_score(ctx, tasks: list[dict], progress=None) -> dict:
    """tasks: [{"context": str, "endings": [str...], "label": int}] ->
    accuracy of argmax sum-logprob ending (HellaSwag/MMLU-style scoring,
    reference perplexity.cpp hellaswag/multiple_choice)."""
    tok = ctx.model.tokenizer
    correct = 0
    for i, t in enumerate(tasks):
        c_ids = tok.encode(t["context"], add_special=True, parse_special=False)
        scores = []
        for end in t["endings"]:
            e_ids = tok.encode(end, add_special=False, parse_special=False)
            if not e_ids:
                scores.append(-1e30)
                continue
            scores.append(continuation_logprob(ctx, c_ids, e_ids))
        pick = int(np.argmax(scores))
        correct += int(pick == int(t["label"]))
        if progress:
            progress(i + 1, len(tasks), correct / (i + 1))
    return {"n_tasks": len(tasks), "accuracy": correct / max(len(tasks), 1)}


def winogrande_score(ctx, tasks: list[dict], progress=None) -> dict:
    """tasks: [{"sentence": "... _ ...", "option1": s, "option2": s,
    "answer": 1|2}] — score both substitutions on the trailing clause
    (reference winogrande_score)."""
    tok = ctx.model.tokenizer
    correct = 0
    for i, t in enumerate(tasks):
        pre, _, post = t["sentence"].partition("_")
        scores = []
        for opt in (t["option1"], t["option2"]):
            c_ids = tok.encode(pre + opt, add_special=True, parse_special=False)
            e_ids = tok.encode(post, add_special=False, parse_special=False)
            if not e_ids:
                scores.append(-1e30)
                continue
            # normalize by continuation length (reference uses the trailing
            # clause logprob; options may tokenize to different lengths)
            scores.append(continuation_logprob(ctx, c_ids, e_ids) / len(e_ids))
        pick = int(np.argmax(scores)) + 1
        correct += int(pick == int(t["answer"]))
        if progress:
            progress(i + 1, len(tasks), correct / (i + 1))
    return {"n_tasks": len(tasks), "accuracy": correct / max(len(tasks), 1)}


def build_parser():
    import argparse

    ap = argparse.ArgumentParser("llama-perplexity (CUDA)")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-f", "--file", required=True,
                    help="text corpus, or JSONL for --hellaswag/--winogrande")
    ap.add_argument("-c", "--n-ctx", type=int, default=512)
    ap.add_argument("--no-quant", action="store_true", help="dense bf16 weights")
    ap.add_argument("--hellaswag", action="store_true",
                    help="JSONL: {context, endings[4], label}")
    ap.add_argument("--winogrande", action="store_true",
                    help="JSONL: {sentence, option1, option2, answer}")
    ap.add_argument("--tasks", type=int, default=0, help="limit task count")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), or cpu for the plain PyTorch versions")
    return ap


def main(argv=None) -> int:
    import json

    from ..models.loader import load_model
    from ..runtime.context import Context
    from .args import apply_env_and_preset

    args = apply_env_and_preset(build_parser(), argv)
    model = load_model(args.model, device=args.device, prefer_quant=not args.no_quant)
    ctx = Context(model, n_ctx=args.n_ctx, n_seqs=1, device=args.device)

    def prog(i, n, cur):
        print(f"[{i}/{n}] {cur:.4f}", flush=True)

    if args.hellaswag or args.winogrande:
        with open(args.file, encoding="utf-8") as fh:
            tasks = [json.loads(line) for line in fh if line.strip()]
        if args.tasks:
            tasks = tasks[: args.tasks]
        fn = winogrande_score if args.winogrande else multiple_choice_score
        res = fn(ctx, tasks, progress=prog)
        print(f"accuracy = {res['accuracy']:.4f} over {res['n_tasks']} tasks")
        return 0

    with open(args.file, encoding="utf-8") as fh:
        text = fh.read()
    res = perplexity(ctx, text=text, n_ctx=args.n_ctx, progress=prog)
    print(res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
