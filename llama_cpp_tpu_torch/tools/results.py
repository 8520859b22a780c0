"""Output-drift regression harness (llama-results analog, reference
tools/results: `--check` snapshots model outputs against a previous commit;
counterpart of the JAX package's tools/results.py).

    python -m llama_cpp_tpu_torch.tools.results -m m.gguf -o base.json
    python -m llama_cpp_tpu_torch.tools.results -m m.gguf --check base.json

`record` stores greedy tokens and last-position logits for a set of
prompts; `check` runs them again and reports the drift (exit code 1 when
a token differs or the logits drift past the tolerance). Run before and
after a change with the same GGUF file. Runs on the card unless --device
cpu is given.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

DEFAULT_PROMPTS = (
    [3, 7, 11, 19],
    [42, 42, 42, 42, 42, 42],
    [5, 9, 23, 9, 23, 9, 77, 42],
)


def snapshot(model_path: str, n_tokens: int = 16, prompts=DEFAULT_PROMPTS, device="cuda"):
    from ..models.loader import load_model
    from ..runtime.context import Context

    model = load_model(model_path, device=device)
    out = []
    for prompt in prompts:
        ctx = Context(model, n_ctx=256, n_seqs=1, device=device)
        toks = ctx.generate(list(prompt), max_new_tokens=n_tokens)
        logits = ctx.prefill([toks[-1] if toks else 1])
        out.append({
            "prompt": list(prompt),
            "tokens": [int(t) for t in toks],
            "logits_head": [float(x) for x in np.asarray(logits[:32])],
        })
    return out


def check(model_path: str, baseline: list, n_tokens: int = 16, logit_tol: float = 5e-3,
          device="cuda") -> dict:
    cur = snapshot(model_path, n_tokens, [b["prompt"] for b in baseline], device=device)
    report = {"n": len(baseline), "token_mismatches": 0, "max_logit_drift": 0.0}
    for b, c in zip(baseline, cur):
        if b["tokens"] != c["tokens"]:
            report["token_mismatches"] += 1
        lb = np.asarray(b["logits_head"])
        lc = np.asarray(c["logits_head"])
        drift = float(np.abs(lb - lc).max() / (np.abs(lb).max() + 1e-9))
        report["max_logit_drift"] = max(report["max_logit_drift"], drift)
    report["ok"] = (report["token_mismatches"] == 0
                    and report["max_logit_drift"] < logit_tol)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("llama-results (CUDA)")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-o", "--output", default="results.json")
    ap.add_argument("--check", default=None,
                    help="baseline json to compare against")
    ap.add_argument("-n", "--n-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), or cpu for the plain PyTorch versions")
    args = ap.parse_args(argv)

    if args.check:
        with open(args.check, encoding="utf-8") as fh:
            base = json.load(fh)
        rep = check(args.model, base, args.n_tokens, device=args.device)
        print(json.dumps(rep))
        return 0 if rep["ok"] else 1
    snap = snapshot(args.model, args.n_tokens, device=args.device)
    with open(args.output, "w", encoding="utf-8") as fh:
        json.dump(snap, fh)
    print(f"recorded {len(snap)} prompts -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
