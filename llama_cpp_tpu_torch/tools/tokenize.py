"""llama-tokenize analog (reference tools/tokenize/tokenize.cpp): tokenize
a prompt/file with a model's vocab and print ids and/or pieces.

Usage:
  python -m llama_cpp_tpu_torch.tools.tokenize -m model.gguf -p "hello world"
  python -m llama_cpp_tpu_torch.tools.tokenize -m model.gguf -f prompt.txt --ids
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser("llama-tokenize")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-p", "--prompt", default=None)
    ap.add_argument("-f", "--file", default=None)
    ap.add_argument("--stdin", action="store_true")
    ap.add_argument("--ids", action="store_true",
                    help="print only the token id array")
    ap.add_argument("--no-bos", action="store_true")
    ap.add_argument("--no-parse-special", action="store_true")
    ap.add_argument("--show-count", action="store_true")
    args = ap.parse_args(argv)

    if args.stdin:
        text = sys.stdin.read()
    elif args.file:
        text = open(args.file).read()
    elif args.prompt is not None:
        text = args.prompt
    else:
        ap.error("need one of -p / -f / --stdin")

    # vocab-only load: skip tensor upload entirely (the reference passes
    # vocab_only=true to llama_model_load)
    from ..gguf.reader import read_gguf
    from ..tokenizer import Tokenizer

    tok = Tokenizer.from_gguf(read_gguf(args.model).metadata)
    ids = tok.encode(text, add_special=not args.no_bos,
                     parse_special=not args.no_parse_special)
    if args.ids:
        print("[" + ", ".join(str(t) for t in ids) + "]")
    else:
        for t in ids:
            try:
                piece = tok.piece(t)
                print(f"{t:6d} -> '{piece}'")
            except Exception:
                print(f"{t:6d} -> (utf-8 decode failure)")
    if args.show_count:
        print(f"Total number of tokens: {len(ids)}")
    return ids


if __name__ == "__main__":
    main()
