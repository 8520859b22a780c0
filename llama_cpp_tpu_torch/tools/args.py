"""Shared CLI argument plumbing: env-var mirrors and preset files.

Analog of reference common/arg.cpp: every flag has a LLAMA_ARG_* environment
mirror, and --preset loads a JSON file of defaults (common/preset.cpp). The
precedence matches the reference: explicit flag > env var > preset > default.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def env_name(flag: str) -> str:
    """--ctx-size -> LLAMA_ARG_CTX_SIZE (reference arg.cpp naming)."""
    return "LLAMA_ARG_" + flag.lstrip("-").replace("-", "_").upper()


def apply_env_and_preset(ap: argparse.ArgumentParser, argv=None) -> argparse.Namespace:
    """Parse with env-var mirrors and optional --preset JSON defaults."""
    argv = list(sys.argv[1:] if argv is None else argv)

    # pre-scan for --preset
    preset: dict = {}
    if "--preset" in argv:
        i = argv.index("--preset")
        path = argv[i + 1]
        del argv[i : i + 2]
        with open(path, encoding="utf-8") as f:
            preset = json.load(f)

    defaults = {}
    for action in ap._actions:
        if not action.option_strings or action.dest == "help":
            continue
        flag = max(action.option_strings, key=len)
        key = action.dest
        env = os.environ.get(env_name(flag))
        src = None
        if env is not None:
            src = env
        elif key in preset:
            src = preset[key]
        elif flag.lstrip("-") in preset:
            src = preset[flag.lstrip("-")]
        if src is None:
            continue
        if isinstance(action, (argparse._StoreTrueAction, argparse._StoreFalseAction)):
            defaults[key] = str(src).lower() in ("1", "true", "yes", "on")
        elif action.type is not None:
            defaults[key] = action.type(src)
        else:
            defaults[key] = src
    if defaults:
        ap.set_defaults(**defaults)
    return ap.parse_args(argv)
