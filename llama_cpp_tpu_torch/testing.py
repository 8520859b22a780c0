"""Synthetic model fixtures (analog of reference tests/gguf-model-data.cpp:
fake models generated in memory, no downloads). The bytes written are the
same as the JAX package's fixtures for the same arguments."""

from __future__ import annotations

import functools

import numpy as np

from .gguf.constants import GGML_BLOCK_LAYOUT, GGMLType, Keys, TokenType
from .gguf.writer import GGUFWriter


def tiny_spm_vocab(n_tokens: int = 256) -> dict:
    """Minimal SPM-style vocab: specials + byte tokens + a few words."""
    K = Keys.Tokenizer
    tokens = ["<unk>", "<s>", "</s>"]
    types = [int(TokenType.UNKNOWN), int(TokenType.CONTROL), int(TokenType.CONTROL)]
    scores = [0.0, 0.0, 0.0]
    for b in range(256):
        tokens.append(f"<0x{b:02X}>")
        types.append(int(TokenType.BYTE))
        scores.append(0.0)
    words = ["▁the", "▁a", "▁of", "▁to", "▁and", "▁in", "he", "at", "on", "re",
             "▁is", "▁was", "th", "er", "an", "▁that", "ing", "▁it", "es", "en"]
    # include single chars + prefixes so SPM bigram merging can reach the words
    pieces: dict[str, float] = {}
    for ch in "▁abcdefghijklmnopqrstuvwxyz":
        pieces[ch] = -30.0
    for i, wrd in enumerate(words):
        for plen in range(2, len(wrd)):
            pieces.setdefault(wrd[:plen], -20.0 - plen)
        pieces[wrd] = -float(i)
    for wrd, score in pieces.items():
        tokens.append(wrd)
        types.append(int(TokenType.NORMAL))
        scores.append(score)
    pad = n_tokens - len(tokens)
    for i in range(max(pad, 0)):
        tokens.append(f"▁w{i}")
        types.append(int(TokenType.NORMAL))
        scores.append(-100.0 - i)
    return {
        K.MODEL: "llama",
        K.TOKENS: tokens[:max(n_tokens, len(tokens))],
        K.SCORES: np.asarray(scores[:max(n_tokens, len(scores))], dtype=np.float32),
        K.TOKEN_TYPE: np.asarray(types[:max(n_tokens, len(types))], dtype=np.int32),
        K.BOS_ID: np.uint32(1),
        K.EOS_ID: np.uint32(2),
        K.UNK_ID: np.uint32(0),
        K.ADD_BOS: True,
        K.ADD_SPACE_PREFIX: True,
    }


# fp16 scale-field offsets inside a block, per type (layouts per reference
# ggml/src/ggml-common.h)
_SCALE_FIELDS = {
    GGMLType.Q4_K: ((0, "f16"), (2, "f16")),
    GGMLType.Q6_K: ((208, "f16"),),
}


@functools.lru_cache(maxsize=1)
def _rand_pool() -> np.ndarray:
    return np.random.default_rng(1234).integers(0, 256, size=1 << 24, dtype=np.uint8)


def synth_quant_bytes(rng, n_elements: int, ftype: GGMLType) -> bytes:
    """Random-but-valid packed quantized data without running a quantizer:
    payload bits come from a shared random pool (every bit pattern decodes
    for these formats), the fp16 block scales are overwritten with small
    sane values. Only for uses where the weight values do not matter."""
    pool = _rand_pool()
    lay = GGML_BLOCK_LAYOUT[ftype]
    nb = n_elements // lay.block_size
    total = nb * lay.type_size
    reps = -(-total // pool.size)
    buf = np.tile(pool, reps)[:total].reshape(nb, lay.type_size)
    scale = np.full(nb, rng.uniform(0.002, 0.02), np.float16)
    for off, _kind in _SCALE_FIELDS[ftype]:
        buf[:, off: off + 2] = scale.view(np.uint8).reshape(nb, 2)
    if ftype == GGMLType.Q6_K:  # int8 scales field: keep moderate
        buf[:, 192:208] = buf[:, 192:208] % 31 + 1
    return buf.tobytes()


def _bench_llama_writer(name: str, n_layers: int, n_embd: int, n_heads: int, n_kv_heads: int,
                        n_ff: int, vocab_size: int, n_ctx: int, rope_base: float) -> GGUFWriter:
    """Metadata and vocab of a synthetic llama-arch GGUF."""
    head_dim = n_embd // n_heads
    w = GGUFWriter()
    w.add(Keys.General.ARCHITECTURE, "llama")
    w.add(Keys.General.NAME, name)
    w.add("llama.block_count", np.uint32(n_layers))
    w.add("llama.context_length", np.uint32(n_ctx))
    w.add("llama.embedding_length", np.uint32(n_embd))
    w.add("llama.feed_forward_length", np.uint32(n_ff))
    w.add("llama.attention.head_count", np.uint32(n_heads))
    w.add("llama.attention.head_count_kv", np.uint32(n_kv_heads))
    w.add("llama.attention.layer_norm_rms_epsilon", 1e-5)
    w.add("llama.rope.freq_base", rope_base)
    w.add("llama.rope.dimension_count", np.uint32(head_dim))
    w.add("llama.vocab_size", np.uint32(vocab_size))
    return w


def _add_bench_vocab(w: GGUFWriter, vocab_size: int) -> None:
    vocab = tiny_spm_vocab(min(vocab_size, 512))
    vocab[Keys.Tokenizer.TOKENS] = (
        vocab[Keys.Tokenizer.TOKENS]
        + [f"▁tk{i}" for i in range(vocab_size - len(vocab[Keys.Tokenizer.TOKENS]))])
    vocab[Keys.Tokenizer.SCORES] = np.full(vocab_size, -100.0, np.float32)
    vocab[Keys.Tokenizer.TOKEN_TYPE] = np.concatenate([
        np.asarray(vocab[Keys.Tokenizer.TOKEN_TYPE], np.int32),
        np.ones(vocab_size - len(vocab[Keys.Tokenizer.TOKEN_TYPE]), np.int32)])
    w.add_all(vocab)


def make_bench_llama_gguf(
    path: str,
    n_layers: int = 32,
    n_embd: int = 4096,
    n_heads: int = 32,
    n_kv_heads: int = 8,
    n_ff: int = 14336,
    vocab_size: int = 128256,
    n_ctx: int = 8192,
    seed: int = 0,
) -> str:
    """Llama-3-8B-shaped (by default) GGUF with synthetic packed weights in
    the Q4_K_M mix: Q4_K everywhere, Q6_K for output, attn_v and ffn_down
    (reference llama_tensor_get_type, src/llama-quant.cpp:424)."""
    rng = np.random.default_rng(seed)
    head_dim = n_embd // n_heads
    w = _bench_llama_writer("bench-llama-synthetic", n_layers, n_embd, n_heads, n_kv_heads,
                            n_ff, vocab_size, n_ctx, 500000.0)
    _add_bench_vocab(w, vocab_size)

    t_main, t_heavy = GGMLType.Q4_K, GGMLType.Q6_K

    def emit_q(name, rows, cols, t):
        w.add_tensor(name, synth_quant_bytes(rng, rows * cols, t), (cols, rows), t)

    def emit_f(name, arr):
        arr = np.ascontiguousarray(arr, dtype=np.float32)
        w.add_tensor(name, arr.tobytes(), tuple(reversed(arr.shape)), GGMLType.F32)

    emit_q("token_embd.weight", vocab_size, n_embd, t_main)
    emit_f("output_norm.weight", np.ones(n_embd))
    emit_q("output.weight", vocab_size, n_embd, t_heavy)
    kv_dim = n_kv_heads * head_dim
    for i in range(n_layers):
        b = f"blk.{i}."
        emit_f(b + "attn_norm.weight", np.ones(n_embd))
        emit_q(b + "attn_q.weight", n_embd, n_embd, t_main)
        emit_q(b + "attn_k.weight", kv_dim, n_embd, t_main)
        emit_q(b + "attn_v.weight", kv_dim, n_embd, t_heavy)
        emit_q(b + "attn_output.weight", n_embd, n_embd, t_main)
        emit_f(b + "ffn_norm.weight", np.ones(n_embd))
        emit_q(b + "ffn_gate.weight", n_ff, n_embd, t_main)
        emit_q(b + "ffn_up.weight", n_ff, n_embd, t_main)
        emit_q(b + "ffn_down.weight", n_embd, n_ff, t_heavy)
    w.write(path)
    return path


def make_bench_moe_gguf(
    path: str,
    n_layers: int = 32,
    n_embd: int = 4096,
    n_heads: int = 32,
    n_kv_heads: int = 8,
    n_ff: int = 14336,
    n_expert: int = 8,
    n_expert_used: int = 2,
    vocab_size: int = 32000,
    n_ctx: int = 32768,
    seed: int = 0,
) -> str:
    """Mixtral-8x7B-shaped (by default) llama-arch MoE GGUF with synthetic
    packed weights: per layer an F32 router ffn_gate_inp [n_expert, n_embd]
    and stacked experts ffn_gate_exps / ffn_up_exps (Q4_K) and ffn_down_exps
    (Q6_K); attention and head in make_bench_llama_gguf's mix (the real
    Q4_K_M recipe stores attn_k / attn_v of 8-expert models as Q8_0)."""
    rng = np.random.default_rng(seed)
    head_dim = n_embd // n_heads
    w = _bench_llama_writer("bench-moe-synthetic", n_layers, n_embd, n_heads, n_kv_heads,
                            n_ff, vocab_size, n_ctx, 1000000.0)
    w.add("llama.expert_count", np.uint32(n_expert))
    w.add("llama.expert_used_count", np.uint32(n_expert_used))
    _add_bench_vocab(w, vocab_size)

    t_main, t_heavy = GGMLType.Q4_K, GGMLType.Q6_K

    def emit_q(name, rows, cols, t, stack=()):
        n = rows * cols * int(np.prod(stack, dtype=np.int64))
        w.add_tensor(name, synth_quant_bytes(rng, n, t), (cols, rows, *stack), t)

    def emit_f(name, arr):
        arr = np.ascontiguousarray(arr, dtype=np.float32)
        w.add_tensor(name, arr.tobytes(), tuple(reversed(arr.shape)), GGMLType.F32)

    emit_q("token_embd.weight", vocab_size, n_embd, t_main)
    emit_f("output_norm.weight", np.ones(n_embd))
    emit_q("output.weight", vocab_size, n_embd, t_heavy)
    kv_dim = n_kv_heads * head_dim
    for i in range(n_layers):
        b = f"blk.{i}."
        emit_f(b + "attn_norm.weight", np.ones(n_embd))
        emit_q(b + "attn_q.weight", n_embd, n_embd, t_main)
        emit_q(b + "attn_k.weight", kv_dim, n_embd, t_main)
        emit_q(b + "attn_v.weight", kv_dim, n_embd, t_heavy)
        emit_q(b + "attn_output.weight", n_embd, n_embd, t_main)
        emit_f(b + "ffn_norm.weight", np.ones(n_embd))
        emit_f(b + "ffn_gate_inp.weight", rng.standard_normal((n_expert, n_embd)) * 0.02)
        emit_q(b + "ffn_gate_exps.weight", n_ff, n_embd, t_main, (n_expert,))
        emit_q(b + "ffn_up_exps.weight", n_ff, n_embd, t_main, (n_expert,))
        emit_q(b + "ffn_down_exps.weight", n_embd, n_ff, t_heavy, (n_expert,))
    w.write(path)
    return path
