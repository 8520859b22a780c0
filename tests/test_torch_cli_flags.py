"""The port's llama-cli flags beyond plain completion, each against the JAX
CLI on the same files, greedy: --spec-ngram and -md (a Q4_0 draft of the
Q8_0 target's values) with --draft-max, --prompt-cache run twice (the
second run reuses the cached prefix), --lora with --lora-scale,
--control-vector with its scale, and --no-quant print the JAX CLI's text;
-cnv over two turns of stdin prints the port's own chat loop, whose ids are
held teacher-forced against the JAX package's (the two part at a
near-tie); a draft of the eagle3 or dflash arch exits with 2 and names
its arch, and a gemma4-assistant draft over a Gemma 4 target prints the
target's own greedy text (against the JAX CLI too). No grammar is
combined with these flags: the JAX CLI's grammar loop raises on the CPU.

Fixtures: a llama (2 layers, n_embd 256, 4/2 heads of 64, n_ff 512, vocab
256) of seeded values from the JAX package's quantizer at Q8_0 and Q4_0,
a seeded rank-4 LoRA and a control vector (llama_cpp_tpu_torch.testing)."""

import io
import sys

import numpy as np
import pytest
import torch

from llama_cpp_tpu.models.loader import load_model as jax_load_model
from llama_cpp_tpu.runtime.context import Context as JaxContext
from llama_cpp_tpu.testing import make_tiny_llama_gguf as jax_make_tiny
from llama_cpp_tpu.tools import cli as jax_cli
from llama_cpp_tpu_torch.gguf.writer import GGUFWriter
from llama_cpp_tpu_torch.models.loader import load_model
from llama_cpp_tpu_torch.runtime.context import Context
from llama_cpp_tpu_torch.server.chat import apply_chat_template
from llama_cpp_tpu_torch.testing import (make_bench_gemma4_assistant_gguf,
                                         make_bench_gemma4_gguf, make_control_vector_gguf,
                                         make_lora_gguf)
from llama_cpp_tpu_torch.tools import cli

SHAPE = dict(vocab_size=256, n_layers=2, n_embd=256, n_heads=4, n_kv_heads=2, n_ff=512, seed=3)
PROMPT = "the cat is on the mat and that was it"
PROJ = {"attn_q": (256, 256), "attn_v": (128, 256), "ffn_up": (512, 256)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli_flags")
    return {"target": jax_make_tiny(str(d / "t.gguf"), ftype="q8_0", **SHAPE),
            "draft": jax_make_tiny(str(d / "d.gguf"), ftype="q4_0", **SHAPE),
            "lora": make_lora_gguf(str(d / "l.gguf"), 2, PROJ, rank=4, alpha=8.0),
            "cvec": make_control_vector_gguf(str(d / "c.gguf"), 2, 256),
            "dir": d}


def run(main, argv, capsys, stdin=None, monkeypatch=None):
    capsys.readouterr()
    if stdin is not None:
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


FLAGS = {
    "spec_ngram": lambda f: ["--spec-ngram", "--draft-max", "4"],
    "model_draft": lambda f: ["-md", f["draft"], "--draft-max", "3"],
    "lora": lambda f: ["--lora", f["lora"], "--lora-scale", "0.5"],
    "control_vector": lambda f: ["--control-vector", f["cvec"],
                                 "--control-vector-scale", "2"],
    "no_quant": lambda f: ["--no-quant"],
}


@pytest.mark.parametrize("flag", list(FLAGS))
def test_flag_prints_the_jax_clis_text(files, capsys, flag):
    argv = ["-m", files["target"], "-p", PROMPT, "-n", "10", "-c", "256", "--temp", "0",
            *FLAGS[flag](files)]
    rc, out, err = run(cli.main, argv + ["--device", "cpu"], capsys)
    jrc, jout, jerr = run(jax_cli.main, argv, capsys)
    assert rc == jrc == 0 and out == jout and len(out) > 1
    if flag in ("spec_ngram", "model_draft"):
        line = [ln for ln in err.splitlines() if ln.startswith("spec: drafted")]
        assert line and line == [ln for ln in jerr.splitlines() if ln.startswith("spec: ")]


def chat_turns(model, turns, n):
    """The CLI's -cnv loop over the port's Context, greedy: per turn the
    chat template over the history, prefilled from an empty sequence, then
    up to n tokens -> (the text the CLI prints, [(prompt ids, reply ids)])."""
    tok = model.tokenizer
    ctx = Context(model, n_ctx=256, device="cpu")
    history, text, runs = [], "", []
    for user in turns:
        history.append({"role": "user", "content": user})
        ids = tok.encode(apply_chat_template(history, tok.vocab.chat_template, "", "", True),
                         add_special=True, parse_special=True)
        ctx.seq_rm(0)
        logits, out = ctx.prefill(ids), []
        for _ in range(n):
            t = int(np.argmax(logits))
            if tok.is_eog(t):
                break
            out.append(t)
            logits = ctx.decode_one(t)
        text += "> " + "".join(tok.piece(t) for t in out) + "\n"
        history.append({"role": "assistant", "content": tok.decode(out)})
        runs.append((ids, out))
    return text + "> ", runs


def test_conversation_turns_held_against_jax(files, capsys, monkeypatch):
    """-cnv over two turns of stdin prints the port's own chat loop; each
    reply's ids are held teacher-forced against the JAX package's: its
    argmax, or the parting of a near-tie (the JAX logit of the port's id
    within twice that step's largest difference between the two packages'
    logits: each logit of the parting pair moves by at most that much). On
    this file the packages part at a near-tie in the first reply (a gap of
    0.025 against a largest difference of 0.022), so the JAX CLI's second
    prompt, which holds its own first reply, is not the port's: its text is
    not compared."""
    argv = ["-m", files["target"], "-cnv", "-n", "6", "-c", "256", "--temp", "0"]
    rc, out, _ = run(cli.main, argv + ["--device", "cpu"], capsys, "the cat\nand the mat\n\n",
                     monkeypatch)
    model = load_model(files["target"], device="cpu")
    text, runs = chat_turns(model, ["the cat", "and the mat"], 6)
    assert rc == 0 and out == text
    jctx = JaxContext(jax_load_model(files["target"]), n_ctx=256)
    ctx = Context(model, n_ctx=256, device="cpu")
    ties = 0
    for ids, reply in runs:
        ctx.seq_rm(0)
        jctx.seq_rm(0)
        lp, lj = ctx.prefill(ids), np.asarray(jctx.prefill(ids))
        for t in reply:
            if int(np.argmax(lj)) != t:
                assert lj.max() - lj[t] <= 2 * np.abs(lp - lj).max()
                ties += 1
            lp, lj = ctx.decode_one(t), np.asarray(jctx.decode_one(t))
    assert sum(len(r) for _, r in runs) == 12 and ties <= 2


def test_prompt_cache_reuses_the_prefix_as_the_jax_cli(files, capsys):
    d = files["dir"]
    outs = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]), ("jax", jax_cli.main, [])):
        cache = str(d / f"{name}.cache")
        runs = []
        for prompt in (PROMPT, PROMPT + " and so on"):
            runs.append(run(main, ["-m", files["target"], "-p", prompt, "-n", "8", "-c", "256",
                                   "--temp", "0", "--prompt-cache", cache, *extra], capsys))
        outs[name] = runs
    (rc1, out1, err1), (rc2, out2, err2) = outs["port"]
    assert rc1 == rc2 == 0 and "prompt cache: reused" not in err1
    reused = [ln for ln in err2.splitlines() if ln.startswith("prompt cache: reused")]
    assert reused == [ln for ln in outs["jax"][1][2].splitlines()
                      if ln.startswith("prompt cache: reused")] and reused
    assert [out1, out2] == [r[1] for r in outs["jax"]]


# a Gemma 4 target whose last two layers are a window and a full one, and
# its assistant (tests/test_speculative.py _gemma4_pair's layout)
G4_PAIR = dict(n_embd=64, n_heads=4, n_kv_heads=2, head_dim=16, head_dim_swa=8, n_ff=96,
               vocab_size=256, sliding_window=8, f32=True)


@pytest.mark.parametrize("arch", ["eagle3", "dflash", "gemma4-assistant"])
def test_feature_drafts_exit_with_2_and_name_their_arch(files, capsys, arch):
    """eagle3 and dflash are refused by name; a gemma4-assistant draft
    (ported) drafts over its Gemma 4 target: the text is the target's own
    greedy text, as the JAX CLI prints it with the same draft."""
    path = str(files["dir"] / f"{arch}.gguf")
    if arch == "gemma4-assistant":
        target = make_bench_gemma4_gguf(
            str(files["dir"] / "g4.gguf"), n_layers=4, is_swa=(1, 1, 1, 0), shared_kv_layers=0,
            n_embd_per_layer=0, n_expert=0, moe_layers=(), alt_v_layers=(), **G4_PAIR)
        make_bench_gemma4_assistant_gguf(path, n_layers=2, is_swa=(1, 0), n_embd_out=64,
                                         **G4_PAIR)
        argv = ["-m", target, "-p", PROMPT, "-n", "8", "-c", "128", "--temp", "0",
                "--draft-max", "3"]
        rc, out, err = run(cli.main, argv + ["-md", path, "--device", "cpu"], capsys)
        rc0, plain, _ = run(cli.main, argv + ["--device", "cpu"], capsys)
        rcj, jout, _ = run(jax_cli.main, argv + ["-md", path], capsys)
        # the speculative loop's text ends without the plain loop's newline,
        # in both CLIs
        assert rc == rc0 == rcj == 0 and out == jout and out.rstrip() == plain.rstrip() and out
        return
    w = GGUFWriter()
    w.add("general.architecture", arch)
    w.write(path)
    rc, out, err = run(cli.main, ["-m", files["target"], "-p", "the", "-md", path,
                                  "--device", "cpu"], capsys)
    assert rc == 2 and out == "" and repr(arch) in err and "not ported" in err
