"""llama-diffusion-cli: a diffusion LM's text by iterative unmasking
(reference examples/diffusion/diffusion-cli.cpp; the JAX package's
tools/diffusion_cli.py, with the same flags).

    python -m llama_cpp_tpu_torch.tools.diffusion_cli -m model.gguf -p "..." \\
        --diffusion-steps 64 --diffusion-algorithm confidence [--device cpu]

The context holds one sequence of n_ctx = n_ubatch = --diffusion-max-length
rows, so each step's whole-sequence forward is one ubatch: on the card its
projections take the prefill GEMMs (K3/K4) from 64 rows. Runs on the card
unless --device cpu is given (the plain PyTorch versions).
"""

from __future__ import annotations

import argparse
import sys

from ..runtime.diffusion import ALGORITHMS, DiffusionParams, diffusion_generate


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("llama-diffusion-cli")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-p", "--prompt", default="")
    ap.add_argument("--diffusion-steps", type=int, default=64)
    ap.add_argument("--diffusion-algorithm", default="confidence", choices=ALGORITHMS)
    ap.add_argument("--diffusion-max-length", type=int, default=128)
    ap.add_argument("--diffusion-block-length", type=int, default=0,
                    help="enable block schedule with this block size")
    ap.add_argument("--diffusion-eps", type=float, default=1e-3)
    ap.add_argument("--diffusion-alg-temp", type=float, default=0.0)
    ap.add_argument("--diffusion-add-gumbel-noise", action="store_true")
    ap.add_argument("--temp", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--diffusion-visual", action="store_true",
                    help="print the sequence at every step")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), or cpu for the plain PyTorch versions")
    return ap


def main(argv=None, model=None) -> list[int]:
    """Prints the generated text (the ids where the file has no vocab) and
    returns the ids. `model`: an already loaded model instead of -m's file."""
    from ..models.loader import load_model
    from ..runtime.context import Context

    args = build_parser().parse_args(argv)
    if model is None:
        model = load_model(args.model, device=args.device)
    if not model.cfg.extra.get("diffusion"):
        print(f"warning: arch {model.cfg.arch!r} is not a diffusion LM", file=sys.stderr)
    ctx = Context(model, n_ctx=args.diffusion_max_length, n_seqs=1,
                  n_ubatch=args.diffusion_max_length, device=model.device)
    tok = model.tokenizer
    prompt_ids = tok.encode(args.prompt) if tok else []
    p = DiffusionParams(
        steps=args.diffusion_steps,
        max_length=args.diffusion_max_length,
        algorithm=args.diffusion_algorithm,
        schedule="block" if args.diffusion_block_length else "timestep",
        block_length=args.diffusion_block_length or 32,
        temperature=args.temp,
        eps=args.diffusion_eps,
        alg_temp=args.diffusion_alg_temp,
        seed=args.seed,
        add_gumbel_noise=args.diffusion_add_gumbel_noise,
    )

    def cb(step, seq):
        if args.diffusion_visual and tok:
            print(f"\rstep {step}: {tok.decode([int(t) for t in seq])!r}", end="",
                  file=sys.stderr)

    out = diffusion_generate(ctx, prompt_ids, p, step_cb=cb)
    if args.diffusion_visual:
        print(file=sys.stderr)
    print(tok.decode(out) if tok else out)
    return out


if __name__ == "__main__":
    main()
