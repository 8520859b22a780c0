"""Prompt completion and chat from the command line (llama-cli analog,
reference tools/cli; counterpart of the JAX package's tools/cli.py).

    python -m llama_cpp_tpu_torch.tools.cli -m m.gguf -p "..." -n 24 --temp 0

Text in, text out: the prompt is tokenized with the model's vocab, prefilled,
and tokens are sampled by the host sampler chain and printed piece by piece;
the perf line goes to stderr. -cnv chats over stdin with the model's chat
template (an empty line or the end of input ends it). --grammar,
--grammar-file and --json-schema constrain the sampling with a GBNF grammar
(sampling/grammar.py), whose mask over the vocabulary is applied to each
step's logits on the host. --prompt-cache keeps the prompt's KV in a state
file (runtime/state.py) and reuses its longest common prefix on the next
run. -md (a draft model of the same vocab) or --spec-ngram (prompt lookup)
decode speculatively, --draft-max tokens a verify step
(runtime/speculative.py); a gemma4-assistant draft drafts over the target's
own KV (models/gemma3n.py); the EAGLE3 and DFlash drafts are refused by
their arch with exit code 2. --lora and --control-vector
steer the model (models/adapters.py); --no-quant loads dense bf16 weights.
Runs on the card unless --device cpu is given. Multimodal input (--mmproj,
--image) is not part of the port yet: refused by name with exit code 2.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

# flag -> its argparse dest; a value other than the default means it was given
NOT_PORTED = {"--mmproj": "mmproj", "--image": "image"}


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
    ap.add_argument("-cnv", "--conversation", action="store_true",
                    help="chat over stdin with the model's chat template")
    ap.add_argument("-md", "--model-draft", default=None,
                    help="draft model GGUF for speculative decoding")
    ap.add_argument("--draft-max", type=int, default=8,
                    help="tokens drafted per speculative step")
    ap.add_argument("--spec-ngram", action="store_true",
                    help="self-speculative n-gram (prompt lookup) drafting")
    ap.add_argument("--prompt-cache", default=None,
                    help="session file: reuse the cached prompt prefix")
    ap.add_argument("--lora", default=None, help="LoRA adapter GGUF")
    ap.add_argument("--lora-scale", type=float, default=1.0)
    ap.add_argument("--control-vector", default=None)
    ap.add_argument("--control-vector-scale", type=float, default=1.0)
    ap.add_argument("--no-quant", action="store_true", help="dense bf16 weights")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), or cpu for the plain PyTorch versions")
    not_ported = ap.add_argument_group("not ported yet (refused with exit code 2)")
    not_ported.add_argument("--mmproj", default=None)
    not_ported.add_argument("--image", action="append", default=[])
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

    if args.model_draft:
        from ..runtime.speculative import refused_draft

        arch = refused_draft(args.model_draft)
        if arch:
            print(f"llama-cli: -md with a draft of arch {arch!r} is not ported yet to the "
                  "PyTorch/CUDA package (its draft model is not ported)",
                  file=sys.stderr)
            return 2

    from ..models.loader import load_model
    from ..runtime.context import Context
    from ..sampling.samplers import SamplerChain, SamplingParams

    print(f"loading {args.model} ...", file=sys.stderr, flush=True)
    model = load_model(args.model, device=args.device, prefer_quant=not args.no_quant)
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

    if args.lora:
        from ..models.adapters import apply_lora, load_lora

        n = apply_lora(model, load_lora(args.lora), scale=args.lora_scale)
        print(f"lora: applied {n} tensors from {args.lora}", file=sys.stderr)
    if args.control_vector:
        from ..models.adapters import apply_control_vector, load_control_vector

        cv = load_control_vector(args.control_vector, model.cfg.n_layers, model.cfg.n_embd)
        apply_control_vector(model, cv, strength=args.control_vector_scale)
        print(f"control vector: {args.control_vector}", file=sys.stderr)

    speculator = None
    if ctx.recurrent and (args.model_draft or args.spec_ngram):
        # verifying drafts rolls the memory back past rejected tokens, which
        # a recurrent state cannot do (the server drops speculation alike)
        print("speculative decoding: off, a recurrent state cannot be rolled back",
              file=sys.stderr)
    elif args.model_draft:
        dmodel = load_model(args.model_draft, device=args.device,
                            prefer_quant=not args.no_quant)
        if dmodel.cfg.arch == "gemma4-assistant":
            from ..models.gemma3n import Gemma4AssistantSpeculator

            speculator = Gemma4AssistantSpeculator(dmodel, ctx)
        else:
            from ..runtime.speculative import DraftModelSpeculator

            speculator = DraftModelSpeculator(Context(dmodel, n_ctx=args.ctx_size,
                                                      device=args.device))
    elif args.spec_ngram:
        from ..runtime.speculative import NgramSpeculator

        speculator = NgramSpeculator()

    def run_once(prompt_text: str) -> list[int]:
        """One prompt from an empty sequence: its completion printed piece by
        piece, the ids returned."""
        ctx.seq_rm(0)
        ids = tok.encode(prompt_text, add_special=True, parse_special=True)
        if args.verbose_prompt:
            for t in ids:
                print(f"{t:7d} -> {tok.piece(t)!r}", file=sys.stderr)
        logits = None
        if args.prompt_cache:
            from ..runtime.state import load_state, save_state

            cached = []
            if os.path.exists(args.prompt_cache):
                try:
                    cached = list(load_state(ctx, args.prompt_cache).get("tokens", []))
                except ValueError as e:
                    print(f"prompt cache ignored: {e}", file=sys.stderr)
            n_match = 0
            while (n_match < len(cached) and n_match < len(ids) - 1
                   and cached[n_match] == ids[n_match]):
                n_match += 1
            if ctx.recurrent and n_match < len(cached):
                n_match = 0  # a recurrent state holds all its tokens or none
            if not (ctx.recurrent and n_match):  # a state of exactly the match stays
                ctx.seq_rm(0, p0=n_match)
            if n_match:
                print(f"prompt cache: reused {n_match}/{len(ids)} tokens", file=sys.stderr)
            logits = ctx.prefill(ids[n_match:])
            save_state(ctx, args.prompt_cache, extra={"tokens": list(ids)})
        if speculator is not None and not grammar and logits is None:
            from ..runtime.speculative import speculative_generate

            speculator.reset()

            def show_all(t: int) -> None:
                sys.stdout.write(tok.piece(t))
                sys.stdout.flush()

            out, stats = speculative_generate(
                ctx, speculator, ids, max_new_tokens=args.n_predict, n_draft=args.draft_max,
                sampler=SamplerChain.from_params(params, tok.vocab), stream=show_all)
            acc = stats["n_accept"] / max(stats["n_draft"], 1)
            print(f"\nspec: drafted {stats['n_draft']} accepted {stats['n_accept']} "
                  f"({acc:.0%})", file=sys.stderr)
            return out
        sampler = SamplerChain.from_params(params, tok.vocab)
        if grammar:
            from ..sampling.grammar import GrammarSampler

            sampler = Constrained(sampler, GrammarSampler(grammar, tok))
        if logits is None:
            logits = ctx.prefill(ids)
        out = []
        for _ in range(args.n_predict):
            token = sampler.sample(np.asarray(logits, dtype=np.float32))
            if tok.is_eog(token):
                break
            sys.stdout.write(tok.piece(token))
            sys.stdout.flush()
            out.append(token)
            if ctx.seq_len[0] >= ctx.n_ctx - 1:
                break
            logits = ctx.decode_one(token)
        sys.stdout.write("\n")
        return out

    if args.conversation:
        from ..server.chat import apply_chat_template

        history = []
        print("== interactive chat (empty line to exit) ==", file=sys.stderr)
        while True:
            try:
                user = input("> ")
            except EOFError:
                break
            if not user.strip():
                break
            history.append({"role": "user", "content": user})
            toks = run_once(apply_chat_template(history, tok.vocab.chat_template, "", "",
                                                True))
            history.append({"role": "assistant", "content": tok.decode(toks)})
    else:
        prompt = args.prompt
        if args.file:
            with open(args.file, encoding="utf-8") as fh:
                prompt = fh.read()
        if prompt is None:
            print("need -p or -f (or -cnv)", file=sys.stderr)
            return 1
        run_once(prompt)

    s = ctx.perf.summary()
    print(f"\nperf: prompt {s['n_prefill']} tok @ {s['prefill_tok_per_s']:.1f} tok/s; "
          f"gen {s['n_decode']} tok @ {s['decode_tok_per_s']:.1f} tok/s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
