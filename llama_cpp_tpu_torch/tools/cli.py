"""One-shot prompt completion from the command line (llama-cli analog,
reference tools/cli; counterpart of the JAX package's tools/cli.py).

    python -m llama_cpp_tpu_torch.tools.cli -m m.gguf -p "..." -n 24 --temp 0

Text in, text out: the prompt is tokenized with the model's vocab, prefilled,
and tokens are sampled by the host sampler chain and printed piece by piece;
the perf line goes to stderr. --grammar, --grammar-file and --json-schema
constrain the sampling with a GBNF grammar (sampling/grammar.py), whose mask
over the vocabulary is applied to each step's logits on the host. Runs on the
card unless --device cpu is given. The flags whose modules are not part of
the port yet (conversation, speculative decoding, prompt cache, multimodal,
LoRA, control vectors, dense weights) are parsed and refused by name with
exit code 2.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

# flag -> its argparse dest; a value other than the default means it was given
NOT_PORTED = {
    "-cnv/--conversation": "conversation", "-md/--model-draft": "model_draft",
    "--spec-ngram": "spec_ngram", "--prompt-cache": "prompt_cache", "--mmproj": "mmproj",
    "--image": "image", "--lora": "lora", "--lora-scale": "lora_scale",
    "--control-vector": "control_vector", "--control-vector-scale": "control_vector_scale",
    "--no-quant": "no_quant", "--draft-max": "draft_max",
}


class Constrained:
    """A sampler chain behind a GBNF grammar: each step's logits masked to
    the tokens the grammar allows, then sampled, and the token fed to the
    grammar (the JAX package's CLI loop, tools/cli.py, as a sampler that
    Context.generate takes)."""

    def __init__(self, chain, grammar):
        self.chain = chain
        self.grammar = grammar

    def sample(self, logits) -> int:
        token = self.chain.sample(self.grammar.filter_logits(np.array(logits, np.float32)))
        self.grammar.accept(token)
        return token


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("llama-cli (CUDA)")
    ap.add_argument("-m", "--model", required=True, help="GGUF model path")
    ap.add_argument("-p", "--prompt", default=None)
    ap.add_argument("-f", "--file", default=None, help="prompt from file")
    ap.add_argument("-n", "--n-predict", type=int, default=128)
    ap.add_argument("-c", "--ctx-size", type=int, default=2048)
    ap.add_argument("--temp", type=float, default=0.8)
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--top-p", type=float, default=0.95)
    ap.add_argument("--min-p", type=float, default=0.05)
    ap.add_argument("--repeat-penalty", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=-1)
    ap.add_argument("--kv-quant", action="store_true", help="int8 KV cache")
    ap.add_argument("--verbose-prompt", action="store_true")
    ap.add_argument("--grammar", default=None, help="GBNF grammar text")
    ap.add_argument("--grammar-file", default=None, help="GBNF grammar from a file")
    ap.add_argument("--json-schema", default=None, help="JSON schema, as a grammar")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), or cpu for the plain PyTorch versions")
    not_ported = ap.add_argument_group("not ported yet (refused with exit code 2)")
    not_ported.add_argument("-cnv", "--conversation", action="store_true")
    not_ported.add_argument("-md", "--model-draft", default=None)
    not_ported.add_argument("--draft-max", type=int, default=None)
    not_ported.add_argument("--spec-ngram", action="store_true")
    not_ported.add_argument("--prompt-cache", default=None)
    not_ported.add_argument("--mmproj", default=None)
    not_ported.add_argument("--image", action="append", default=[])
    not_ported.add_argument("--lora", default=None)
    not_ported.add_argument("--lora-scale", type=float, default=None)
    not_ported.add_argument("--control-vector", default=None)
    not_ported.add_argument("--control-vector-scale", type=float, default=None)
    not_ported.add_argument("--no-quant", action="store_true")
    return ap


def main(argv=None) -> int:
    from ..utils.logging import add_log_args, apply_log_args
    from .args import apply_env_and_preset

    ap = build_parser()
    add_log_args(ap)
    args = apply_env_and_preset(ap, argv)
    apply_log_args(args)
    for flag, dest in NOT_PORTED.items():
        if getattr(args, dest) != ap.get_default(dest):
            print(f"llama-cli: {flag} is not ported yet to the PyTorch/CUDA package",
                  file=sys.stderr)
            return 2

    from ..models.loader import load_model
    from ..runtime.context import Context
    from ..sampling.samplers import SamplerChain, SamplingParams

    print(f"loading {args.model} ...", file=sys.stderr, flush=True)
    model = load_model(args.model, device=args.device)
    tok = model.tokenizer
    if tok is None:
        print("llama-cli: the model file carries no tokenizer", file=sys.stderr)
        return 1
    ctx = Context(model, n_ctx=args.ctx_size, quantized_kv=args.kv_quant, device=args.device)
    print(f"arch={model.cfg.arch} layers={model.cfg.n_layers} vocab={model.cfg.vocab_size} "
          f"device={model.device}", file=sys.stderr)

    grammar = args.grammar
    if args.grammar_file:
        with open(args.grammar_file, encoding="utf-8") as fh:
            grammar = fh.read()
    if args.json_schema:
        from ..sampling.json_schema import schema_to_gbnf

        grammar = schema_to_gbnf(args.json_schema)

    params = SamplingParams(
        temp=args.temp, top_k=args.top_k, top_p=args.top_p, min_p=args.min_p,
        penalty_repeat=args.repeat_penalty,
        seed=args.seed if args.seed >= 0 else 0xFFFFFFFF,
        grammar=grammar or "",
    )
    # model-embedded sampling defaults (general.sampling.*) fill any knob
    # the user left at its CLI default
    defaults = ap.parse_args(["-m", args.model])
    explicit = {f for f, a in (("temp", "temp"), ("top_k", "top_k"), ("top_p", "top_p"),
                               ("min_p", "min_p"), ("penalty_repeat", "repeat_penalty"))
                if getattr(args, a) != getattr(defaults, a)}
    params = params.apply_gguf_defaults(model.gguf.metadata, explicit)

    prompt = args.prompt
    if args.file:
        with open(args.file, encoding="utf-8") as fh:
            prompt = fh.read()
    if prompt is None:
        print("need -p or -f", file=sys.stderr)
        return 1

    ids = tok.encode(prompt, add_special=True, parse_special=True)
    if args.verbose_prompt:
        for t in ids:
            print(f"{t:7d} -> {tok.piece(t)!r}", file=sys.stderr)
    sampler = SamplerChain.from_params(params, tok.vocab)
    if grammar:
        from ..sampling.grammar import GrammarSampler

        sampler = Constrained(sampler, GrammarSampler(grammar, tok))

    def show(token: int) -> None:
        if not tok.is_eog(token):
            sys.stdout.write(tok.piece(token))
            sys.stdout.flush()

    # the loop is Context.generate's; it stops at an end-of-generation token
    # itself, and here one position short of the context as well
    ctx.generate(ids, max_new_tokens=args.n_predict, sampler=sampler, stream=show,
                 stop_fn=lambda _: ctx.seq_len[0] >= ctx.n_ctx - 1)
    sys.stdout.write("\n")

    s = ctx.perf.summary()
    print(f"\nperf: prompt {s['n_prefill']} tok @ {s['prefill_tok_per_s']:.1f} tok/s; "
          f"gen {s['n_decode']} tok @ {s['decode_tok_per_s']:.1f} tok/s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
