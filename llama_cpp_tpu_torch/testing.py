"""Synthetic model fixtures (analog of reference tests/gguf-model-data.cpp:
fake models generated in memory, no downloads). The bytes written are the
same as the JAX package's fixtures for the same arguments."""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from .gguf.constants import GGML_BLOCK_LAYOUT, GGMLType, Keys, TokenType
from .gguf.reader import read_gguf
from .gguf.writer import GGUFWriter
from .quant.dequant import dequantize
from .quant.quantize import quantize
from .tools.quantize_tool import FTYPES, tensor_target_type


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


# scale fields inside a block, per type: (byte offset, kind), layouts per
# reference ggml/src/ggml-common.h. Kinds: "f16" a half-precision scale (or
# min), "f32" a single-precision one (Q8_K), "e8m0" MXFP4's exponent byte,
# "ue4m3" NVFP4's four sub-block scale bytes, "iq1m" IQ1_M's half-precision
# scale spread over the top nibbles of its four 16-bit scale words
_SCALE_FIELDS = {
    GGMLType.Q4_0: ((0, "f16"),),
    GGMLType.Q4_1: ((0, "f16"), (2, "f16")),
    GGMLType.Q5_0: ((0, "f16"),),
    GGMLType.Q5_1: ((0, "f16"), (2, "f16")),
    GGMLType.Q8_0: ((0, "f16"),),
    GGMLType.Q8_1: ((0, "f16"), (2, "f16")),
    GGMLType.Q2_K: ((80, "f16"), (82, "f16")),
    GGMLType.Q3_K: ((108, "f16"),),
    GGMLType.Q4_K: ((0, "f16"), (2, "f16")),
    GGMLType.Q5_K: ((0, "f16"), (2, "f16")),
    GGMLType.Q6_K: ((208, "f16"),),
    GGMLType.Q8_K: ((0, "f32"),),
    GGMLType.IQ2_XXS: ((0, "f16"),),
    GGMLType.IQ2_XS: ((0, "f16"),),
    GGMLType.IQ2_S: ((0, "f16"),),
    GGMLType.IQ3_XXS: ((0, "f16"),),
    GGMLType.IQ3_S: ((0, "f16"),),
    GGMLType.IQ1_S: ((0, "f16"),),
    GGMLType.IQ1_M: ((48, "iq1m"),),
    GGMLType.IQ4_NL: ((0, "f16"),),
    GGMLType.IQ4_XS: ((0, "f16"),),
    GGMLType.TQ1_0: ((52, "f16"),),
    GGMLType.TQ2_0: ((64, "f16"),),
    GGMLType.MXFP4: ((0, "e8m0"),),
    GGMLType.NVFP4: ((0, "ue4m3"),),
    GGMLType.Q1_0: ((0, "f16"),),
    GGMLType.Q2_0: ((0, "f16"),),
}


@functools.lru_cache(maxsize=1)
def _rand_pool() -> np.ndarray:
    return np.random.default_rng(1234).integers(0, 256, size=1 << 24, dtype=np.uint8)


def synth_quant_bytes(rng, n_elements: int, ftype: GGMLType, offset: int = 0,
                      scale_mult: float = 1.0) -> bytes:
    """Random-but-valid packed quantized data without running a quantizer:
    payload bits come from a shared random pool (every bit pattern decodes
    for these formats), read from `offset` on, and each block's scale
    fields are overwritten with one small sane scale (0.002-0.02, times
    scale_mult for the half- and single-precision scales; MXFP4's exponent
    byte 2^-8, NVFP4's sub-block scales 2^-7, so no scale overflows). Only
    for uses where the weight values do not matter."""
    pool = _rand_pool()
    if offset:
        pool = np.roll(pool, -offset)
    lay = GGML_BLOCK_LAYOUT[ftype]
    nb = n_elements // lay.block_size
    total = nb * lay.type_size
    reps = -(-total // pool.size)
    buf = np.tile(pool, reps)[:total].reshape(nb, lay.type_size)
    scale = np.full(nb, rng.uniform(0.002, 0.02) * scale_mult, np.float16)
    for off, kind in _SCALE_FIELDS[ftype]:
        if kind == "f16":
            buf[:, off: off + 2] = scale.view(np.uint8).reshape(nb, 2)
        elif kind == "f32":
            buf[:, off: off + 4] = scale.astype(np.float32).view(np.uint8).reshape(nb, 4)
        elif kind == "e8m0":
            buf[:, off] = 120  # 2^(120 - 127) / 2
        elif kind == "ue4m3":
            buf[:, off: off + 4] = 1 << 3  # exponent 1, mantissa 0: 2^-6 / 2
        else:  # iq1m: bits 12-15 of each of the four words hold a nibble of d
            words = buf[:, off: off + 8].copy().view(np.uint16)
            bits = scale.view(np.uint16)[:, None] >> (4 * np.arange(4, dtype=np.uint16))
            words = (words & 0x0FFF) | ((bits & 0xF) << 12)
            buf[:, off: off + 8] = words.view(np.uint8)
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
    """tiny_spm_vocab padded with word pieces to vocab_size, or cut to it
    where the model's vocab is smaller than the tiny vocab."""
    vocab = tiny_spm_vocab(min(vocab_size, 512))
    for key in (Keys.Tokenizer.TOKENS, Keys.Tokenizer.TOKEN_TYPE):
        vocab[key] = vocab[key][:vocab_size]
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


def make_bench_arch_gguf(
    path: str,
    arch: str,
    n_layers: int,
    n_embd: int,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    n_ff: int,
    vocab_size: int,
    n_ctx: int = 4096,
    rope_base: float = 10000.0,
    rms_eps: float = 1e-6,
    qkv_bias: bool = False,
    qk_norm: bool = False,
    post_norms: bool = False,
    tie: bool = False,
    n_expert: int = 0,
    n_expert_used: int = 0,
    n_ff_exp: int = 0,
    shared_expert_ff: int = 0,
    sliding_window: int = 0,
    swa_pattern: int = 0,
    rope_base_swa: float = 0.0,
    rope_linear_factor: float = 0.0,
    attn_softcap: float = 0.0,
    final_softcap: float = 0.0,
    pre_norms: str = "both",
    weightless: bool = False,
    norm_bias: bool = False,
    norm_eps: float = 0.0,
    glu: bool = True,
    ffn_bias: bool = False,
    attn_out_bias: bool = False,
    fused_qkv: bool = False,
    qk_norm_full: bool = False,
    output_bias: bool = False,
    n_positions: int = 0,
    embd_norm: bool = False,
    metadata: dict | None = None,
    synth_scale: float = 1.0,
    sinks: bool = False,
    ffn_norm_name: str = "ffn_norm",
    fused_gateup: bool = False,
    router_bias: bool = False,
    expert_bias: bool = False,
    exp_probs_b: bool = False,
    shared_gate_inp: bool = True,
    n_dense_lead: int = 0,
    dense_ffn: bool = False,
    moe_norm: bool = False,
    chunk_experts: int = 0,
    matrix_type: str = "",
    expert_type: str = "",
    qk_norm_bias: bool = False,
    sub_norms: bool = False,
    tensor_scales: bool = False,
    layer_out_scale: bool = False,
    q_head_scale: bool = False,
    head_arr: tuple[int, ...] | None = None,
    kv_arr: tuple[int, ...] | None = None,
    dummy_layers: tuple[int, ...] = (),
    attn_gate: str = "",
    ff_arr: tuple[int, ...] | None = None,
    mask_token: int = -1,
    indexer_dim: int = 0,
    f32: bool = False,
    ftype: str = "q4_k_m",
    real_quant: bool = False,
    seed: int = 0,
) -> str:
    """A GGUF of one of the registry's decoder families (`arch`) with
    synthetic packed weights. ftype "q4_k_m" is make_bench_llama_gguf's mix:
    Q4_K for token_embd, attn_q/k/output and ffn_gate/up, Q6_K for attn_v,
    ffn_down and output (with tie=True no output: the head is a Q6_K
    token_embd). Any other file type of tools.quantize_tool.FTYPES ("q8_0",
    "q5_k_m", "q5_0", "q4_0", "f16", ...) gives each matrix the type that
    llama-quantize writes for it (tensor_target_type). Norms, biases and the
    router are F32. Each quantized tensor reads the random pool from its own
    seeded offset, so no two tensors share their values; real_quant=True
    instead quantizes seeded f32 values (scale 1/sqrt(in)) with
    quant.quantize, as llama-quantize would (F16/BF16 matrices always hold
    such values).
    Options add the family's tensors: q/k/v biases (qwen2), per-head q/k
    norms (qwen3, gemma3), post-attention and post-FFN norms (gemma2/3);
    n_expert > 0 makes every layer MoE (an F32 router, stacked experts Q4_K
    gate/up and Q6_K down, as make_bench_moe_gguf), shared_expert_ff > 0
    adds a sigmoid-gated shared expert (qwen2moe); the sliding window, its
    pattern and its rope base, linear rope scaling and the softcaps go to
    the metadata. f32=True writes every matrix as F32 random values (scale
    1/sqrt(in)) instead, for exact comparisons.

    The block variants of the dense-decoder families, each written as the
    JAX package's converter writes it: pre_norms "attn" keeps attn_norm
    alone (a shared parallel norm: phi2, command-r), "none" writes no
    pre-norms (norm-after blocks, with post_norms: olmo2, exaone4);
    weightless writes no norm tensor at all (olmo); norm_bias adds the
    LayerNorms' biases (attn_norm, ffn_norm, output_norm); norm_eps writes
    attention.layer_norm_epsilon; glu=False drops ffn_gate (GELU or ReLU^2
    on ffn_up); ffn_bias adds ffn_up/ffn_down (and ffn_gate) biases,
    attn_out_bias attn_output's; fused_qkv writes one attn_qkv [q + 2 kv,
    n_embd] (Q4_K in q4_k_m; with qkv_bias one attn_qkv.bias) instead of
    attn_q/k/v; qk_norm_full makes the q/k norms as wide as the projections
    (olmo2, olmoe); output_bias adds output.bias; n_positions > 0 writes a
    learned position table position_embd [n_positions, n_embd] (F32, as
    llama-quantize leaves it); embd_norm writes token_embd_norm
    with its bias (bloom); metadata adds keys under the arch's prefix
    (ALiBi bias, muP scales, no_rope_layers, clamp_kqv, ...); synth_scale
    multiplies the synthetic blocks' scales (every quantized weight by the
    same factor).

    The MoE families' tensors: sinks adds attn_sinks [n_heads] (gpt-oss,
    mimo2); ffn_norm_name is the file's name for the pre-FFN norm (gpt-oss:
    post_attention_norm); fused_gateup writes one ffn_up of 2 * n_ff rows
    holding gate|up (chatglm, plamo3); router_bias adds ffn_gate_inp.bias,
    expert_bias the three expert stacks' biases [n_expert, out], exp_probs_b
    the selection bias exp_probs_b.bias [n_expert]; shared_gate_inp=False
    leaves the shared expert ungated (no ffn_gate_inp_shexp); the first
    n_dense_lead layers carry a dense FFN of n_ff instead of experts;
    dense_ffn adds a dense FFN of n_ff beside the experts (grok, arctic),
    moe_norm arctic's ffn_norm_exps; chunk_experts > 0 adds GroveMoE's
    chunk-expert stacks ffn_*_chexps of that many experts of n_ff_exp.
    matrix_type gives every quantized matrix that type and expert_type the
    expert stacks theirs (gpt-oss: "q8_0" and "mxfp4"), whatever ftype
    says.

    The last text families' tensors: qk_norm_bias adds the per-head q/k
    norms' biases (chameleon's LayerNorms); sub_norms bitnet's attn_sub_norm
    [n_heads * head_dim] and ffn_sub_norm [n_ff]; tensor_scales a per-tensor
    F32 scale "<name>.scale" [1] beside each projection (bitnet);
    layer_out_scale talkie's layer_output_scale [1] a layer; q_head_scale
    talkie's attn_q_norm [n_heads, 1] (a scalar a head, no k norm).
    head_arr and kv_arr (deci) write the head counts as per-layer arrays: a
    layer of 0 KV heads and some heads is linear attention (attn_norm and a
    square attn_output), one of 0 heads attention-free (its FFN alone, on
    ffn_norm), and a layer in dummy_layers has no tensors at all.
    attn_gate writes an attention output gate attn_gate.weight: "element"
    as wide as the attention output (afmoe, laguna M.1; Q4_K in q4_k_m),
    "head" one row a head (laguna XS.2; F32); ff_arr gives each layer's
    dense FFN its own width (openelm); mask_token >= 0 writes the vocab's
    mask token id (the diffusion LMs); indexer_dim > 0 gives each layer past
    the n_dense_lead ones MiniMax-M3's MSA indexer (indexer.q_proj
    [n_kv_heads * indexer_dim, n_embd], indexer.k_proj [indexer_dim,
    n_embd], Q4_K in q4_k_m, and their per-head norms).
    Left at their defaults they write nothing, so the default files stay
    byte for byte what they were."""
    rng = np.random.default_rng(seed)
    w = GGUFWriter()
    w.add(Keys.General.ARCHITECTURE, arch)
    w.add(Keys.General.NAME, f"bench-{arch}-synthetic")
    P = arch + "."
    for key, val in (("block_count", n_layers), ("context_length", n_ctx),
                     ("embedding_length", n_embd), ("feed_forward_length", n_ff),
                     ("attention.head_count", n_heads), ("attention.head_count_kv", n_kv_heads),
                     ("attention.key_length", head_dim), ("attention.value_length", head_dim),
                     ("rope.dimension_count", head_dim), ("vocab_size", vocab_size)):
        if key == "attention.head_count" and head_arr is not None:
            val = np.asarray(head_arr, np.uint32)
        elif key == "attention.head_count_kv" and kv_arr is not None:
            val = np.asarray(kv_arr, np.uint32)
        w.add(P + key, np.uint32(val) if np.ndim(val) == 0 else val)
    w.add(P + "attention.layer_norm_rms_epsilon", float(rms_eps))
    w.add(P + "rope.freq_base", float(rope_base))
    if n_expert:
        w.add(P + "expert_count", np.uint32(n_expert))
        w.add(P + "expert_used_count", np.uint32(n_expert_used))
        w.add(P + "expert_feed_forward_length", np.uint32(n_ff_exp))
    if shared_expert_ff:
        w.add(P + "expert_shared_count", np.uint32(1))
        w.add(P + "expert_shared_feed_forward_length", np.uint32(shared_expert_ff))
    if sliding_window:
        w.add(P + "attention.sliding_window", np.uint32(sliding_window))
    if swa_pattern:
        w.add(P + "attention.sliding_window_pattern", np.uint32(swa_pattern))
    if rope_base_swa:
        w.add(P + "rope.freq_base_swa", float(rope_base_swa))
    if rope_linear_factor:
        w.add(P + "rope.scaling.type", "linear")
        w.add(P + "rope.scaling.factor", float(rope_linear_factor))
    if attn_softcap:
        w.add(P + "attn_logit_softcapping", float(attn_softcap))
    if final_softcap:
        w.add(P + "final_logit_softcapping", float(final_softcap))
    if norm_eps:
        w.add(P + "attention.layer_norm_epsilon", float(norm_eps))
    for key, val in (metadata or {}).items():
        w.add(P + key, val)
    _add_bench_vocab(w, vocab_size)
    if mask_token >= 0:
        w.add(Keys.Tokenizer.MASK_ID, np.uint32(mask_token))

    q4, q6 = GGMLType.Q4_K, GGMLType.Q6_K

    def emit_f(name, arr):
        arr = np.ascontiguousarray(arr, dtype=np.float32)
        w.add_tensor(name, arr.tobytes(), tuple(reversed(arr.shape)), GGMLType.F32)

    default = FTYPES[ftype][0]

    def emit_q(name, rows, cols, t, stack=()):
        shape = (*reversed(stack), rows, cols)
        if expert_type and "_exps" in name:
            t = GGMLType[expert_type.upper()]
        elif matrix_type:
            t = GGMLType[matrix_type.upper()]
        elif ftype != "q4_k_m":
            t = tensor_target_type(name, shape, default, ftype)
        if f32 or t == GGMLType.F32:
            emit_f(name, rng.standard_normal(shape) / np.sqrt(cols))
            return
        if real_quant or t in (GGMLType.F16, GGMLType.BF16):
            vals = (rng.standard_normal(shape) / np.sqrt(cols)).astype(np.float32)
            data = quantize(vals, t).tobytes()
        else:
            n = rows * cols * int(np.prod(stack, dtype=np.int64))
            data = synth_quant_bytes(rng, n, t, offset=int(rng.integers(1, 1 << 24)),
                                     scale_mult=synth_scale)
        w.add_tensor(name, data, (cols, rows, *stack), t)

    def norm_w(n):
        return 1.0 + 0.1 * rng.standard_normal(n)

    def bias(name, n):
        emit_f(name, 0.1 * rng.standard_normal(n))

    def emit_norm(name, n):  # a norm's weight, and its bias for a LayerNorm
        if not weightless:
            emit_f(name + ".weight", norm_w(n))
            if norm_bias:
                bias(name + ".bias", n)

    emit_q("token_embd.weight", vocab_size, n_embd, q6 if tie else q4)
    if n_positions:  # llama-quantize leaves position embeddings unquantized
        emit_f("position_embd.weight", rng.standard_normal((n_positions, n_embd)) * 0.1)
    if embd_norm:
        emit_f("token_embd_norm.weight", norm_w(n_embd))
        bias("token_embd_norm.bias", n_embd)
    emit_norm("output_norm", n_embd)
    if not tie:
        emit_q("output.weight", vocab_size, n_embd, q6)
        if output_bias:
            bias("output.bias", vocab_size)

    def emit_scale(name):  # bitnet: the projection's per-tensor scale
        if tensor_scales:
            emit_f(name + ".scale", [0.5 + rng.random()])

    for i in range(n_layers):
        b = f"blk.{i}."
        if i in dummy_layers:
            continue
        lh = n_heads if head_arr is None else head_arr[i]
        lkv = n_kv_heads if kv_arr is None else kv_arr[i]
        lff = n_ff if ff_arr is None else ff_arr[i]
        q_dim, kv_dim = lh * head_dim, lkv * head_dim
        if lh and not lkv:  # deci's linear attention: wo of the normed input
            emit_norm(b + "attn_norm", n_embd)
            emit_q(b + "attn_output.weight", n_embd, n_embd, q4)
        if not (lh and lkv):
            if pre_norms == "both":
                emit_norm(b + ffn_norm_name, n_embd)
            emit_q(b + "ffn_gate.weight", n_ff, n_embd, q4)
            emit_q(b + "ffn_up.weight", n_ff, n_embd, q4)
            emit_q(b + "ffn_down.weight", n_embd, n_ff, q6)
            continue
        if pre_norms != "none":
            emit_norm(b + "attn_norm", n_embd)
        if fused_qkv:
            emit_q(b + "attn_qkv.weight", q_dim + 2 * kv_dim, n_embd, q4)
        else:
            emit_q(b + "attn_q.weight", q_dim, n_embd, q4)
            emit_q(b + "attn_k.weight", kv_dim, n_embd, q4)
            emit_q(b + "attn_v.weight", kv_dim, n_embd, q6)
            for name in ("attn_q", "attn_k", "attn_v"):
                emit_scale(b + name)
        emit_q(b + "attn_output.weight", n_embd, q_dim, q4)
        emit_scale(b + "attn_output")
        if attn_gate == "element":
            emit_q(b + "attn_gate.weight", q_dim, n_embd, q4)
        elif attn_gate == "head":
            emit_f(b + "attn_gate.weight", rng.standard_normal((lh, n_embd)) / np.sqrt(n_embd))
        if sub_norms:
            emit_f(b + "attn_sub_norm.weight", norm_w(q_dim))
            emit_f(b + "ffn_sub_norm.weight", norm_w(n_ff))
        if layer_out_scale:
            emit_f(b + "layer_output_scale.weight", [0.1 + 0.2 * rng.random()])
        if q_head_scale:
            emit_f(b + "attn_q_norm.weight", norm_w((lh, 1)))
        if qkv_bias and fused_qkv:
            bias(b + "attn_qkv.bias", q_dim + 2 * kv_dim)
        elif qkv_bias:
            for name, n in (("attn_q", q_dim), ("attn_k", kv_dim), ("attn_v", kv_dim)):
                emit_f(b + name + ".bias", 0.1 * rng.standard_normal(n))
        if attn_out_bias:
            bias(b + "attn_output.bias", n_embd)
        if sinks:
            emit_f(b + "attn_sinks.weight", rng.standard_normal(n_heads))
        if qk_norm:
            emit_f(b + "attn_q_norm.weight", norm_w(q_dim if qk_norm_full else head_dim))
            emit_f(b + "attn_k_norm.weight", norm_w(kv_dim if qk_norm_full else head_dim))
            if qk_norm_bias:
                bias(b + "attn_q_norm.bias", head_dim)
                bias(b + "attn_k_norm.bias", head_dim)
        if post_norms:
            emit_f(b + "post_attention_norm.weight", norm_w(n_embd))
            emit_f(b + "post_ffw_norm.weight", norm_w(n_embd))
        if indexer_dim and i >= n_dense_lead:
            emit_q(b + "indexer.q_proj.weight", n_kv_heads * indexer_dim, n_embd, q4)
            emit_q(b + "indexer.k_proj.weight", indexer_dim, n_embd, q4)
            emit_f(b + "indexer.q_norm.weight", norm_w(indexer_dim))
            emit_f(b + "indexer.k_norm.weight", norm_w(indexer_dim))
        if pre_norms == "both":
            emit_norm(b + ffn_norm_name, n_embd)
        moe = n_expert and i >= n_dense_lead
        if moe:
            if moe_norm:
                emit_f(b + "ffn_norm_exps.weight", norm_w(n_embd))
            emit_f(b + "ffn_gate_inp.weight", rng.standard_normal((n_expert, n_embd)) * 0.02)
            if router_bias:
                bias(b + "ffn_gate_inp.bias", n_expert)
            if exp_probs_b:
                bias(b + "exp_probs_b.bias", n_expert)
            emit_q(b + "ffn_gate_exps.weight", n_ff_exp, n_embd, q4, (n_expert,))
            emit_q(b + "ffn_up_exps.weight", n_ff_exp, n_embd, q4, (n_expert,))
            emit_q(b + "ffn_down_exps.weight", n_embd, n_ff_exp, q6, (n_expert,))
            if expert_bias:
                for name, n in (("gate", n_ff_exp), ("up", n_ff_exp), ("down", n_embd)):
                    emit_f(b + f"ffn_{name}_exps.bias", 0.1 * rng.standard_normal((n_expert, n)))
            if shared_expert_ff:
                if shared_gate_inp:
                    emit_f(b + "ffn_gate_inp_shexp.weight",
                           rng.standard_normal((1, n_embd)) * 0.02)
                emit_q(b + "ffn_gate_shexp.weight", shared_expert_ff, n_embd, q4)
                emit_q(b + "ffn_up_shexp.weight", shared_expert_ff, n_embd, q4)
                emit_q(b + "ffn_down_shexp.weight", n_embd, shared_expert_ff, q6)
            if chunk_experts:
                emit_q(b + "ffn_gate_chexps.weight", n_ff_exp, n_embd, q4, (chunk_experts,))
                emit_q(b + "ffn_up_chexps.weight", n_ff_exp, n_embd, q4, (chunk_experts,))
                emit_q(b + "ffn_down_chexps.weight", n_embd, n_ff_exp, q6, (chunk_experts,))
        if not moe or dense_ffn:
            if fused_gateup:
                emit_q(b + "ffn_up.weight", 2 * lff, n_embd, q4)
            else:
                if glu:
                    emit_q(b + "ffn_gate.weight", lff, n_embd, q4)
                emit_q(b + "ffn_up.weight", lff, n_embd, q4)
            emit_q(b + "ffn_down.weight", n_embd, lff, q6)
            for name in ("ffn_gate", "ffn_up", "ffn_down"):
                emit_scale(b + name)
            if ffn_bias:
                for name, n in [("ffn_gate", n_ff)] * glu + [("ffn_up", n_ff),
                                                             ("ffn_down", n_embd)]:
                    bias(b + name + ".bias", n)
    w.write(path)
    return path


_LN = dict(norm_bias=True, norm_eps=1e-5)  # LayerNorm with biases
_GPT = dict(qkv_bias=True, attn_out_bias=True, ffn_bias=True)  # biases throughout
_MOE = dict(n_expert=8, n_expert_used=2, n_ff_exp=256)
_GRANITE = {"embedding_scale": 6.0, "residual_scale": 0.5, "attention.scale": 0.05,
            "logit_scale": 0.5}
# the dense-decoder families that differ from llama only in block variants:
# each with the make_bench_arch_gguf options that write its tensors and
# metadata as the JAX package's converter (or llama.cpp's) lays them out. The
# sliding windows are 32 (cohere2 and exaone4 at 2 layers: one window layer,
# one full); the learned position tables hold 1024 rows.
FAMILY_LAYOUTS: dict[str, dict] = {
    "phi3": dict(fused_qkv=True),
    "stablelm": dict(**_LN),
    "starcoder2": dict(**_LN, glu=False, **_GPT, rope_base=1e6),
    "smollm3": dict(metadata={"no_rope_layers": [1, 0]}),
    "granite": dict(metadata=_GRANITE),
    "olmo2": dict(pre_norms="none", post_norms=True, qk_norm=True, qk_norm_full=True),
    "glm4": dict(post_norms=True, qkv_bias=True),
    "nemotron": dict(**_LN, glu=False),
    "gpt2": dict(**_LN, glu=False, fused_qkv=True, **_GPT, tie=True, n_positions=1024),
    "gptneox": dict(**_LN, glu=False, fused_qkv=True, **_GPT,
                    metadata={"use_parallel_residual": True}),
    "phi2": dict(**_LN, glu=False, pre_norms="attn", fused_qkv=True, **_GPT, output_bias=True),
    "bloom": dict(**_LN, glu=False, embd_norm=True, fused_qkv=True, **_GPT, tie=True),
    "mpt": dict(norm_eps=1e-5, glu=False, fused_qkv=True,
                metadata={"attention.max_alibi_bias": 8.0}),
    "command-r": dict(norm_eps=1e-5, pre_norms="attn", tie=True,
                      metadata={"logit_scale": 0.0625}),
    "olmoe": dict(qk_norm=True, qk_norm_full=True, **_MOE),
    "falcon": dict(**_LN, glu=False, fused_qkv=True),
    "internlm2": dict(),
    "orion": dict(**_LN),
    "xverse": dict(),
    "baichuan": dict(),
    "exaone": dict(),
    "minicpm": dict(tie=True),
    "jais": dict(**_LN, fused_qkv=True, **_GPT, tie=True,
                 metadata={"attention.max_alibi_bias": 8.0}),
    "arcee": dict(glu=False),
    "cohere2": dict(norm_eps=1e-5, pre_norms="attn", tie=True, sliding_window=32,
                    swa_pattern=2, metadata={"logit_scale": 0.25}),
    "olmo": dict(weightless=True, norm_eps=1e-5, metadata={"attention.clamp_kqv": 0.5}),
    "exaone4": dict(pre_norms="none", post_norms=True, qk_norm=True, sliding_window=32,
                    swa_pattern=2),
    "seed_oss": dict(qkv_bias=True, metadata={"attention.scale": 0.1}),
    "hunyuan-dense": dict(qk_norm=True),
    "ernie4_5": dict(),
    "ernie4_5-moe": dict(**_MOE),
    "dbrx": dict(norm_eps=1e-5, fused_qkv=True, **_MOE, metadata={"attention.clamp_kqv": 8.0}),
    "granitemoe": dict(**_MOE, metadata=_GRANITE),
    "qwen": dict(fused_qkv=True, qkv_bias=True),
    "codeshell": dict(**_LN, glu=False, fused_qkv=True, **_GPT),
    "refact": dict(),
    "plamo": dict(pre_norms="attn"),
    "mistral3": dict(),
    "starcoder": dict(**_LN, glu=False, fused_qkv=True, **_GPT, tie=True, n_kv_heads=1,
                      n_positions=1024),
}


# the mixture-of-experts families on the shared decoder, each with the options
# that write its tensors and metadata as llama.cpp lays them out: 8 experts
# of 256, top 2 (llama4 top 1), shared experts of 256, one dense lead layer
# where the family has them, windows of 16 (one window layer of two)
_SHARED = dict(shared_expert_ff=256, shared_gate_inp=False)
MOE_FAMILY_LAYOUTS: dict[str, dict] = {
    "gpt-oss": dict(qkv_bias=True, attn_out_bias=True, sinks=True,
                    ffn_norm_name="post_attention_norm", **_MOE, router_bias=True,
                    expert_bias=True, sliding_window=16, rope_base=150000.0,
                    rope_base_swa=150000.0, rms_eps=1e-5, matrix_type="q8_0",
                    expert_type="mxfp4",
                    metadata={"rope.scaling.type": "yarn", "rope.scaling.factor": 32.0,
                              "rope.scaling.original_context_length": np.uint32(4096)}),
    "llama4": dict(n_expert=8, n_expert_used=1, n_ff_exp=256, **_SHARED, rope_base=500000.0,
                   rms_eps=1e-5, metadata={"no_rope_layers": [1, 0], "use_qk_norm": True,
                                           "interleave_moe_layer_step": np.uint32(1)}),
    "phimoe": dict(**_LN, qkv_bias=True, attn_out_bias=True, output_bias=True, **_MOE),
    "deepseek": dict(**_MOE, **_SHARED, n_dense_lead=1,
                     metadata={"expert_weights_scale": 1.0}),
    "grok": dict(**_MOE, dense_ffn=True, post_norms=True),
    "arctic": dict(**_MOE, dense_ffn=True, moe_norm=True),
    "grovemoe": dict(qk_norm=True, **_MOE, chunk_experts=4,
                     metadata={"experts_per_group": np.uint32(2), "expert_group_scale": 0.05}),
    "smallthinker": dict(**_MOE),
    "chatglm": dict(fused_qkv=True, qkv_bias=True, fused_gateup=True),
    "glm4moe": dict(qkv_bias=True, **_MOE, **_SHARED, exp_probs_b=True, n_dense_lead=1),
    "dots1": dict(qk_norm=True, **_MOE, **_SHARED, exp_probs_b=True, n_dense_lead=1),
    "bailingmoe": dict(fused_qkv=True, **_MOE, **_SHARED, n_dense_lead=1),
    "bailingmoe2": dict(qk_norm=True, fused_qkv=True, **_MOE, **_SHARED, exp_probs_b=True,
                        n_dense_lead=1, metadata={"expert_gating_func": np.uint32(2)}),
    "hunyuan-moe": dict(qk_norm=True, **_MOE, **_SHARED),
    "exaone-moe": dict(qk_norm=True, **_MOE, **_SHARED, n_dense_lead=1, sliding_window=16,
                       swa_pattern=2),
    "cohere2moe": dict(norm_eps=1e-5, pre_norms="attn", tie=True, sliding_window=16,
                       swa_pattern=2, **_MOE, **_SHARED, metadata={"logit_scale": 0.25}),
    "mellum": dict(qk_norm=True, **_MOE, sliding_window=16, swa_pattern=2,
                   rope_base_swa=10000.0),
    "mimo2": dict(qk_norm=True, sinks=True, **_MOE, sliding_window=16,
                  metadata={"attention.sliding_window_pattern": [1, 0]}),
    "minimax-m2": dict(qk_norm=True, qk_norm_full=True, **_MOE, exp_probs_b=True),
    "step35": dict(**_MOE, **_SHARED, sliding_window=16,
                   metadata={"attention.sliding_window_pattern": [0, 1],
                             "rope.freq_base_swa": 10000.0}),
    "plamo3": dict(fused_qkv=True, qk_norm=True, post_norms=True, fused_gateup=True,
                   sliding_window=16, swa_pattern=2),
}
FAMILY_LAYOUTS.update(MOE_FAMILY_LAYOUTS)

# the shared decoder's last text families (make_bench_arch_gguf), kept apart
# from FAMILY_LAYOUTS: tests/test_torch_families_late.py holds them. deci's
# five layers: full attention, attention at half the KV heads (its writes
# padded to the memory's), linear attention, attention-free, a dummy.
_XIELU = {"xielu_alpha_n": [0.8, 0.6], "xielu_alpha_p": [0.8, 1.1], "xielu_beta": [0.5, 0.4],
          "xielu_eps": [-1e-6, -1e-6]}
LATE_FAMILY_LAYOUTS: dict[str, dict] = {
    "hy_v3": dict(qk_norm=True, tie=True, **_MOE, **_SHARED, exp_probs_b=True, n_dense_lead=1,
                  metadata={"expert_gating_func": np.uint32(2)}),
    "apertus": dict(qk_norm=True, glu=False, metadata=_XIELU),
    "bitnet": dict(sub_norms=True, tensor_scales=True),
    "talkie": dict(weightless=True, fused_qkv=True, q_head_scale=True, layer_out_scale=True,
                   metadata={"logit_scale": 0.5}),
    "chameleon": dict(qk_norm=True, qk_norm_bias=True, norm_eps=1e-5),
    "jais2": dict(**_LN, glu=False, **_GPT, tie=True),
    "maincoder": dict(),
    "pangu-embedded": dict(qkv_bias=True),
    "deci": dict(n_layers=5, head_arr=(8, 8, 8, 0, 0), kv_arr=(4, 2, 0, 0, 0),
                 dummy_layers=(4,)),
}
# the MLA entries at MHA width (make_bench_deepseek2_gguf with their arch):
# MiniCPM3's absorbed row (256 + 32 -> 384, 256), PLM's (512 + 64, 512),
# mistral4 a deepseek2 file under its own name
MLA_FAMILY_LAYOUTS: dict[str, dict] = {
    "minicpm3": dict(q_lora_rank=256, kv_lora_rank=256, qk_nope=64, qk_rope=32, v_dim=64,
                     n_expert=0, tie=True),
    "plm": dict(kv_lora_rank=512, qk_nope=128, qk_rope=64, v_dim=128, n_expert=0, tie=True,
                glu=False),
    "mistral4": dict(kv_lora_rank=512, qk_nope=128, qk_rope=64, v_dim=128, n_dense=1,
                     n_expert=8, n_expert_used=2, n_ff_exp=256, n_expert_shared=1),
}


# the shared decoder's last text entries (make_bench_arch_gguf), each as
# llama.cpp lays it out: afmoe (the sigmoid gate, NoPE on every second
# layer, post-norms, a window layer and a full one, a dense lead layer, then
# 8 experts top 2 with a selection bias and a shared expert), laguna (the
# per-head softplus gate, its window layer roping 64 dims at its own base;
# LAGUNA_ELEMENT_GATE the per-element gate), openelm (4 heads on 2 KV heads,
# then 8 on 4: the first layer below the memory's KV heads; FFNs of two
# widths; a fused QKV) and nanbeige (the stack run twice, output_norm at the
# loop boundary)
LAST_TEXT_LAYOUTS: dict[str, dict] = {
    "afmoe": dict(qk_norm=True, post_norms=True, attn_gate="element", **_MOE, **_SHARED,
                  exp_probs_b=True, n_dense_lead=1, sliding_window=16, swa_pattern=2,
                  metadata={"expert_gating_func": np.uint32(2), "expert_weights_scale": 1.5,
                            "rope.no_rope_layer_step": np.uint32(2)}),
    "laguna": dict(qk_norm=True, attn_gate="head", **_MOE, **_SHARED, exp_probs_b=True,
                   n_dense_lead=1, sliding_window=16, swa_pattern=2, rope_base_swa=10000.0,
                   metadata={"expert_gating_func": np.uint32(2),
                             "rope.dimension_count_swa": np.uint32(64)}),
    "openelm": dict(fused_qkv=True, qk_norm=True, tie=True, head_arr=(4, 8), kv_arr=(2, 4),
                    ff_arr=(1024, 2048)),
    "nanbeige": dict(metadata={"num_loops": np.uint32(2), "skip_loop_final_norm": False}),
}
LAGUNA_ELEMENT_GATE = {**LAST_TEXT_LAYOUTS["laguna"], "attn_gate": "element"}

# the diffusion LMs on the shared decoder, run bidirectionally: dream
# (qwen2's biases, the logits shifted), llada, and the MoE pair (8 experts
# top 2, per-head q/k norms)
DIFFUSION_LAYOUTS: dict[str, dict] = {
    "dream": dict(qkv_bias=True),
    "llada": dict(),
    "llada-moe": dict(qk_norm=True, **_MOE),
    "rnd1": dict(qk_norm=True, **_MOE),
}


def make_bench_diffusion_gguf(path: str, arch: str = "llada", n_layers: int = 32,
                              n_embd: int = 4096, n_heads: int = 32, n_kv_heads: int = 32,
                              n_ff: int = 12288, vocab_size: int = 126464,
                              mask_token: int = 126336, rope_base: float = 500000.0,
                              n_ctx: int = 4096, **kw) -> str:
    """A diffusion LM's GGUF in DIFFUSION_LAYOUTS[arch]'s layout (kw override
    it and pass make_bench_arch_gguf's options: f32, synth_scale, seed,
    ...), LLaDA-8B-Instruct's widths by default (GSAI-ML/LLaDA-8B-Instruct
    config.json: n_embd 4096, 32 heads and 32 KV heads of 128, a SwiGLU FFN
    of 12288, vocab 126464, mask token 126336, rope base 500000), the
    Q4_K_M mix. mask_token -1 takes the vocab's last id."""
    return make_bench_arch_gguf(
        path, arch, n_layers=n_layers, n_embd=n_embd, n_heads=n_heads, n_kv_heads=n_kv_heads,
        head_dim=n_embd // n_heads, n_ff=n_ff, vocab_size=vocab_size, n_ctx=n_ctx,
        rope_base=rope_base, rms_eps=1e-5,
        mask_token=vocab_size - 1 if mask_token < 0 else mask_token,
        **{**DIFFUSION_LAYOUTS[arch], **kw})


def make_tiny_diffusion_gguf(path: str, arch: str = "llada", vocab_size: int = 160,
                             seed: int = 0) -> str:
    """The JAX package's tiny diffusion-LM fixture (its testing.py:363) in
    the port's own writer: llada (llama's graph) or dream (qwen2's, with
    q/k/v biases), 2 layers of 48, 4 heads on 2 KV heads, F32 random
    weights; the vocab's last id is the mask token."""
    rng = np.random.default_rng(seed)
    n_embd, n_heads, n_kv, n_ff, n_layers = 48, 4, 2, 96, 2
    hd = n_embd // n_heads
    w = GGUFWriter()
    w.add(Keys.General.ARCHITECTURE, arch)
    w.add(Keys.General.NAME, f"tiny-{arch}")
    P = arch + "."
    for key, val in (("block_count", n_layers), ("context_length", 256),
                     ("embedding_length", n_embd), ("feed_forward_length", n_ff),
                     ("attention.head_count", n_heads), ("attention.head_count_kv", n_kv),
                     ("attention.key_length", hd), ("attention.value_length", hd)):
        w.add(P + key, np.uint32(val))
    w.add(P + "attention.layer_norm_rms_epsilon", 1e-5)
    w.add(P + "rope.freq_base", 10000.0)
    w.add(P + "rope.dimension_count", np.uint32(hd))
    w.add(P + "vocab_size", np.uint32(vocab_size))
    vocab = tiny_spm_vocab(vocab_size)
    for k in (Keys.Tokenizer.TOKENS, Keys.Tokenizer.SCORES, Keys.Tokenizer.TOKEN_TYPE):
        vocab[k] = vocab[k][:vocab_size]
    vocab[Keys.Tokenizer.MASK_ID] = np.uint32(vocab_size - 1)
    w.add_all(vocab)

    def emit(name, arr):
        arr = np.ascontiguousarray(arr, dtype=np.float32)
        w.add_tensor(name, arr.tobytes(), tuple(reversed(arr.shape)), GGMLType.F32)

    def rand(*shape, scale=None):
        scale = scale or (1.0 / np.sqrt(shape[-1]))
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    emit("token_embd.weight", rand(vocab_size, n_embd, scale=0.05))
    emit("output_norm.weight", 1 + rand(n_embd, scale=0.02))
    emit("output.weight", rand(vocab_size, n_embd))
    for i in range(n_layers):
        b = f"blk.{i}."
        emit(b + "attn_norm.weight", 1 + rand(n_embd, scale=0.02))
        emit(b + "ffn_norm.weight", 1 + rand(n_embd, scale=0.02))
        emit(b + "attn_q.weight", rand(n_heads * hd, n_embd))
        emit(b + "attn_k.weight", rand(n_kv * hd, n_embd))
        emit(b + "attn_v.weight", rand(n_kv * hd, n_embd))
        emit(b + "attn_output.weight", rand(n_embd, n_heads * hd))
        if arch == "dream":  # qwen2's q/k/v biases
            emit(b + "attn_q.bias", rand(n_heads * hd, scale=0.1))
            emit(b + "attn_k.bias", rand(n_kv * hd, scale=0.1))
            emit(b + "attn_v.bias", rand(n_kv * hd, scale=0.1))
        emit(b + "ffn_gate.weight", rand(n_ff, n_embd))
        emit(b + "ffn_up.weight", rand(n_ff, n_embd))
        emit(b + "ffn_down.weight", rand(n_embd, n_ff))
    w.write(path)
    return path


# the recurrent and hybrid families: the mixer a family's "S" layers carry
_MIXER = {"mamba": "mamba1", "jamba": "mamba1", "mamba2": "mamba2", "nemotron_h": "mamba2",
          "nemotron_h_moe": "mamba2", "falcon-h1": "mamba2", "granitehybrid": "mamba2",
          "qwen3next": "delta", "qwen35": "delta_flat", "qwen35moe": "delta_flat",
          "lfm2": "shortconv", "lfm2moe": "shortconv", "plamo2": "plamo2",
          "kimi-linear": "kda"}


def make_bench_hybrid_gguf(
    path: str,
    arch: str,
    pattern: str,
    n_embd: int,
    vocab_size: int,
    n_heads: int = 4,
    n_kv_heads: int = 2,
    head_dim: int = 64,
    rope_dims: int = 0,
    n_ff: int = 512,
    d_inner: int = 512,
    d_state: int = 16,
    n_group: int = 1,
    ssm_heads: int = 8,
    dt_rank: int = 16,
    d_conv: int = 4,
    kv_lora_rank: int = 64,
    mla_nope: int = 32,
    n_expert: int = 0,
    n_expert_used: int = 0,
    n_ff_exp: int = 0,
    shared_expert_ff: int = 0,
    n_ctx: int = 4096,
    rope_base: float = 10000.0,
    rms_eps: float = 1e-6,
    metadata: dict | None = None,
    synth_scale: float = 1.0,
    f32: bool = False,
    seed: int = 0,
) -> str:
    """A GGUF of one of the registry's recurrent or hybrid families (`arch`),
    one block a character of `pattern`: "S" the family's recurrent mixer,
    "A" attention, "H" both in parallel (Falcon-H1), "F" an FFN block
    (Nemotron-H). Every layer but Nemotron-H's and the pure recurrent
    stacks' (mamba, mamba2) carries an FFN half: experts
    (a router, stacks of n_ff_exp, a sigmoid-gated shared expert of
    shared_expert_ff) when n_expert > 0, else a gated FFN of n_ff (Nemotron-H
    and its F blocks: relu^2 on ffn_up alone). The mixers' tensors, as
    llama.cpp's converter lays them out:
      mamba1 (mamba, jamba): ssm_in [2 d_inner, E], ssm_conv1d [d_inner,
        d_conv] and its bias, ssm_x [dt_rank + 2 d_state, d_inner], ssm_dt
        [d_inner, dt_rank] and its bias, ssm_a [d_inner, d_state], ssm_d,
        ssm_out;
      mamba2 (mamba2, nemotron_h, falcon-h1, granitehybrid): ssm_in [2
        d_inner + 2 n_group d_state + ssm_heads, E], the conv over x|B|C,
        ssm_dt.bias, ssm_a and ssm_d [ssm_heads, 1], ssm_norm [n_group,
        d_inner / n_group], ssm_out;
      delta (qwen3next): the per-key-head interleaved qkvz ssm_in and ssm_ba
        (n_group key heads of d_state, ssm_heads value heads of d_inner /
        ssm_heads), the conv over q|k|v, ssm_dt.bias, ssm_a [ssm_heads],
        ssm_norm [head], ssm_out; its attention gate attn_gate [n_heads
        head_dim, E];
      delta_flat (qwen35, qwen35moe): attn_qkv and attn_gate (z), ssm_beta
        and ssm_alpha [ssm_heads, E]; its wq [2 n_heads head_dim, E] holds
        per-head [q | gate] pairs;
      shortconv (lfm2, lfm2moe): shortconv.in_proj [3E, E], shortconv.conv
        [E, d_conv], shortconv.out_proj; the final norm stored as
        token_embd_norm and the head tied;
      plamo2: ssm_in [2 d_inner, E] (per head [z | x]), the conv over x,
        ssm_x [2 d_state + dt_rank, d_inner], ssm_dt [ssm_heads, dt_rank]
        and its bias, ssm_a and ssm_d [ssm_heads], the dt/B/C norms,
        ssm_out; its attention one attn_qkv with q/k norms of a weight a
        head [heads, head_dim], post-norms on both halves, one ffn_up of 2
        n_ff holding gate|up, the head tied;
      kda (kimi-linear): attn_q/k/v [n_heads d_state, E] (one type, so the
        loader fuses them), a conv each ssm_conv1d_q/k/v [n_heads d_state,
        1, d_conv], ssm_f_a/ssm_g_a [d_state, E] and ssm_f_b/ssm_g_b
        [n_heads d_state, d_state], ssm_beta [n_heads, E], ssm_a
        [n_heads, 1], ssm_dt.bias, ssm_norm [d_state], attn_output; its
        attention rope-free MLA on the naive expansion: attn_q [n_heads
        (mla_nope + rope_dims), E], attn_kv_a_mqa [kv_lora_rank + rope_dims,
        E] and its norm, attn_kv_b [n_heads (mla_nope + head_dim),
        kv_lora_rank], V heads of head_dim.
    Per-head q/k norms for qwen3next, qwen35 and lfm2. ssm_a is negative
    (-exp of a normal draw), as a trained model's is. Matrices are written
    in the Q4_K_M mix of make_bench_arch_gguf (synthetic blocks, their
    scales times synth_scale), any whose rows are not a multiple of 256 as
    F32; f32=True writes every matrix F32 (normal values, scale 1/sqrt(in)).
    metadata adds keys under the arch's prefix."""
    rng = np.random.default_rng(seed)
    mixer = _MIXER[arch]
    nemotron = arch.startswith("nemotron_h")
    ffn_half = not nemotron and arch not in ("mamba", "mamba2")
    w = GGUFWriter()
    w.add(Keys.General.ARCHITECTURE, arch)
    w.add(Keys.General.NAME, f"bench-{arch}-synthetic")
    P = arch + "."
    for key, val in (("block_count", len(pattern)), ("context_length", n_ctx),
                     ("embedding_length", n_embd), ("feed_forward_length", n_ff),
                     ("attention.head_count", n_heads), ("attention.head_count_kv", n_kv_heads),
                     ("attention.key_length", head_dim), ("attention.value_length", head_dim),
                     ("rope.dimension_count", rope_dims or head_dim), ("vocab_size", vocab_size),
                     ("ssm.conv_kernel", d_conv), ("ssm.inner_size", d_inner),
                     ("ssm.state_size", d_state),
                     ("ssm.time_step_rank", dt_rank if mixer == "mamba1" else ssm_heads),
                     ("ssm.group_count", 0 if mixer == "plamo2" else n_group)):
        w.add(P + key, np.uint32(val))
    if mixer == "shortconv":
        w.add(P + "shortconv.l_cache", np.uint32(d_conv))
    if mixer == "kda":
        for key, val in (("attention.kv_lora_rank", kv_lora_rank),
                         ("attention.key_length_mla", mla_nope + rope_dims),
                         ("attention.value_length_mla", head_dim), ("kda.head_dim", d_state)):
            w.add(P + key, np.uint32(val))
    w.add(P + "attention.layer_norm_rms_epsilon", float(rms_eps))
    w.add(P + "rope.freq_base", float(rope_base))
    if n_expert:
        w.add(P + "expert_count", np.uint32(n_expert))
        w.add(P + "expert_used_count", np.uint32(n_expert_used))
        w.add(P + "expert_feed_forward_length", np.uint32(n_ff_exp))
    if shared_expert_ff:
        w.add(P + "expert_shared_count", np.uint32(1))
        w.add(P + "expert_shared_feed_forward_length", np.uint32(shared_expert_ff))
    for key, val in (metadata or {}).items():
        w.add(P + key, val)
    _add_bench_vocab(w, vocab_size)

    def emit_f(name, arr):
        arr = np.ascontiguousarray(arr, dtype=np.float32)
        w.add_tensor(name, arr.tobytes(), tuple(reversed(arr.shape)), GGMLType.F32)

    def emit_q(name, rows, cols, t, stack=()):
        if f32 or cols % GGML_BLOCK_LAYOUT[t].block_size:
            emit_f(name, rng.standard_normal((*reversed(stack), rows, cols)) / np.sqrt(cols))
            return
        n = rows * cols * int(np.prod(stack, dtype=np.int64))
        data = synth_quant_bytes(rng, n, t, offset=int(rng.integers(1, 1 << 24)),
                                 scale_mult=synth_scale)
        w.add_tensor(name, data, (cols, rows, *stack), t)

    def norm_w(*shape):
        return 1.0 + 0.1 * rng.standard_normal(shape)

    q4, q6 = GGMLType.Q4_K, GGMLType.Q6_K
    E = n_embd
    tied = mixer in ("shortconv", "plamo2")
    emit_q("token_embd.weight", vocab_size, E, q6 if tied else q4)
    emit_f(("token_embd_norm" if mixer == "shortconv" else "output_norm") + ".weight",
           norm_w(E))
    if not tied:
        emit_q("output.weight", vocab_size, E, q6)
    q_dim, kv_dim = n_heads * head_dim, n_kv_heads * head_dim

    def attention(b):
        if mixer == "kda":  # rope-free MLA, the naive expansion
            emit_q(b + "attn_q.weight", n_heads * (mla_nope + rope_dims), E, q4)
            emit_q(b + "attn_kv_a_mqa.weight", kv_lora_rank + rope_dims, E, q4)
            emit_f(b + "attn_kv_a_norm.weight", norm_w(kv_lora_rank))
            emit_q(b + "attn_kv_b.weight", n_heads * (mla_nope + head_dim), kv_lora_rank, q4)
            emit_q(b + "attn_output.weight", E, n_heads * head_dim, q4)
            return
        if mixer == "plamo2":
            emit_q(b + "attn_qkv.weight", q_dim + 2 * kv_dim, E, q4)
            emit_f(b + "attn_q_norm.weight", norm_w(n_heads, head_dim))
            emit_f(b + "attn_k_norm.weight", norm_w(n_kv_heads, head_dim))
        else:
            emit_q(b + "attn_q.weight", 2 * q_dim if mixer == "delta_flat" else q_dim, E, q4)
            emit_q(b + "attn_k.weight", kv_dim, E, q4)
            emit_q(b + "attn_v.weight", kv_dim, E, q6)
        emit_q(b + "attn_output.weight", E, q_dim, q4)
        if mixer == "delta":
            emit_q(b + "attn_gate.weight", q_dim, E, q4)
        if mixer in ("delta", "delta_flat", "shortconv"):
            emit_f(b + "attn_q_norm.weight", norm_w(head_dim))
            emit_f(b + "attn_k_norm.weight", norm_w(head_dim))

    def recurrent(b):
        if mixer == "mamba1":
            emit_q(b + "ssm_in.weight", 2 * d_inner, E, q4)
            emit_f(b + "ssm_conv1d.weight", 0.4 * rng.standard_normal((d_inner, d_conv)))
            emit_f(b + "ssm_conv1d.bias", 0.02 * rng.standard_normal(d_inner))
            emit_q(b + "ssm_x.weight", dt_rank + 2 * d_state, d_inner, q4)
            emit_q(b + "ssm_dt.weight", d_inner, dt_rank, q4)
            emit_f(b + "ssm_dt.bias", 0.3 * rng.standard_normal(d_inner))
            emit_f(b + "ssm_a", -np.exp(0.5 * rng.standard_normal((d_inner, d_state))))
            emit_f(b + "ssm_d", 0.3 * rng.standard_normal(d_inner))
            emit_q(b + "ssm_out.weight", E, d_inner, q4)
        elif mixer == "mamba2":
            conv_dim = d_inner + 2 * n_group * d_state
            emit_q(b + "ssm_in.weight", d_inner + conv_dim + ssm_heads, E, q4)
            emit_f(b + "ssm_conv1d.weight", 0.4 * rng.standard_normal((conv_dim, d_conv)))
            emit_f(b + "ssm_conv1d.bias", 0.02 * rng.standard_normal(conv_dim))
            emit_f(b + "ssm_dt.bias", 0.3 * rng.standard_normal(ssm_heads))
            emit_f(b + "ssm_a", -np.exp(0.5 * rng.standard_normal((ssm_heads, 1))))
            emit_f(b + "ssm_d", 0.3 * rng.standard_normal((ssm_heads, 1)))
            emit_f(b + "ssm_norm.weight", norm_w(n_group, d_inner // n_group))
            emit_q(b + "ssm_out.weight", E, d_inner, q4)
        elif mixer in ("delta", "delta_flat"):
            key_dim, Dv = n_group * d_state, d_inner // ssm_heads
            if mixer == "delta":
                emit_q(b + "ssm_in.weight", 2 * key_dim + 2 * d_inner, E, q4)
                emit_q(b + "ssm_ba.weight", 2 * ssm_heads, E, q4)
            else:
                emit_q(b + "attn_qkv.weight", 2 * key_dim + d_inner, E, q4)
                emit_q(b + "attn_gate.weight", d_inner, E, q4)
                emit_q(b + "ssm_beta.weight", ssm_heads, E, q4)
                emit_q(b + "ssm_alpha.weight", ssm_heads, E, q4)
            emit_f(b + "ssm_conv1d.weight",
                   0.4 * rng.standard_normal((2 * key_dim + d_inner, d_conv)))
            emit_f(b + "ssm_dt.bias", 0.3 * rng.standard_normal(ssm_heads))
            emit_f(b + "ssm_a", -np.exp(0.5 * rng.standard_normal(ssm_heads)))
            emit_f(b + "ssm_norm.weight", norm_w(Dv))
            emit_q(b + "ssm_out.weight", E, d_inner, q4)
        elif mixer == "kda":
            di = n_heads * d_state
            for name in ("attn_q", "attn_k", "attn_v"):
                emit_q(b + name + ".weight", di, E, q4)
            for name in ("ssm_conv1d_q", "ssm_conv1d_k", "ssm_conv1d_v"):
                emit_f(b + name + ".weight", 0.4 * rng.standard_normal((di, 1, d_conv)))
            for name in ("ssm_f", "ssm_g"):
                emit_q(b + name + "_a.weight", d_state, E, q4)
                emit_q(b + name + "_b.weight", di, d_state, q4)
            emit_q(b + "ssm_beta.weight", n_heads, E, q4)
            emit_f(b + "ssm_a", -np.exp(0.5 * rng.standard_normal((n_heads, 1))))
            emit_f(b + "ssm_dt.bias", 0.3 * rng.standard_normal(di))
            emit_f(b + "ssm_norm.weight", norm_w(d_state))
            emit_q(b + "attn_output.weight", E, di, q4)
        elif mixer == "plamo2":
            emit_q(b + "ssm_in.weight", 2 * d_inner, E, q4)
            emit_f(b + "ssm_conv1d.weight", 0.4 * rng.standard_normal((d_inner, d_conv)))
            emit_q(b + "ssm_x.weight", 2 * d_state + dt_rank, d_inner, q4)
            emit_q(b + "ssm_dt.weight", ssm_heads, dt_rank, q4)
            emit_f(b + "ssm_dt.bias", 0.3 * rng.standard_normal(ssm_heads))
            emit_f(b + "ssm_a", -np.exp(0.5 * rng.standard_normal(ssm_heads)))
            emit_f(b + "ssm_d", 0.3 * rng.standard_normal(ssm_heads))
            for name, n in (("ssm_dt_norm", dt_rank), ("ssm_b_norm", d_state),
                            ("ssm_c_norm", d_state)):
                emit_f(b + name + ".weight", norm_w(n))
            emit_q(b + "ssm_out.weight", E, d_inner, q4)
        else:  # shortconv
            emit_q(b + "shortconv.in_proj.weight", 3 * E, E, q4)
            emit_f(b + "shortconv.conv.weight", 0.4 * rng.standard_normal((E, d_conv)))
            emit_q(b + "shortconv.out_proj.weight", E, E, q4)

    def ffn(b):
        if n_expert:
            emit_f(b + "ffn_gate_inp.weight", rng.standard_normal((n_expert, E)) * 0.02)
            emit_q(b + "ffn_gate_exps.weight", n_ff_exp, E, q4, (n_expert,))
            emit_q(b + "ffn_up_exps.weight", n_ff_exp, E, q4, (n_expert,))
            emit_q(b + "ffn_down_exps.weight", E, n_ff_exp, q6, (n_expert,))
            if shared_expert_ff:
                emit_f(b + "ffn_gate_inp_shexp.weight", rng.standard_normal((1, E)) * 0.02)
                emit_q(b + "ffn_gate_shexp.weight", shared_expert_ff, E, q4)
                emit_q(b + "ffn_up_shexp.weight", shared_expert_ff, E, q4)
                emit_q(b + "ffn_down_shexp.weight", E, shared_expert_ff, q6)
            return
        if mixer == "plamo2":  # one ffn_up holding gate|up
            emit_q(b + "ffn_up.weight", 2 * n_ff, E, q4)
        else:
            if not nemotron:
                emit_q(b + "ffn_gate.weight", n_ff, E, q4)
            emit_q(b + "ffn_up.weight", n_ff, E, q4)
        emit_q(b + "ffn_down.weight", E, n_ff, q6)

    for i, kind in enumerate(pattern):
        b = f"blk.{i}."
        emit_f(b + "attn_norm.weight", norm_w(E))
        if kind in "SH":
            recurrent(b)
        if kind in "AH":
            attention(b)
        if mixer == "plamo2":
            emit_f(b + "attn_post_norm.weight", norm_w(E))
            emit_f(b + "ffn_post_norm.weight", norm_w(E))
        if ffn_half:
            emit_f(b + "ffn_norm.weight", norm_w(E))
        if ffn_half or kind == "F":
            ffn(b)
    w.write(path)
    return path


# the recurrent and hybrid families at a small size (make_bench_hybrid_gguf's
# options): the pattern of blocks and what each family's file carries
HYBRID_LAYOUTS: dict[str, dict] = {
    "mamba": dict(pattern="SS"),
    "mamba2": dict(pattern="SS", d_state=32, n_group=2),
    "jamba": dict(pattern="SA", n_expert=4, n_expert_used=2, n_ff_exp=256),
    "qwen3next": dict(pattern="SSSA", n_expert=8, n_expert_used=4, n_ff_exp=256,
                      shared_expert_ff=256, d_inner=512, d_state=32, n_group=4, ssm_heads=8,
                      rope_dims=32),
    "qwen35": dict(pattern="SA", d_inner=512, d_state=32, n_group=4, ssm_heads=8,
                   metadata={"rope.dimension_sections": np.asarray([3, 3, 2, 0], np.uint32)}),
    "qwen35moe": dict(pattern="SA", n_expert=8, n_expert_used=2, n_ff_exp=256,
                      shared_expert_ff=256, d_inner=512, d_state=32, n_group=4, ssm_heads=8,
                      metadata={"rope.dimension_sections": np.asarray([3, 3, 2, 0],
                                                                      np.uint32)}),
    "lfm2": dict(pattern="SA", d_conv=3),
    "lfm2moe": dict(pattern="SA", d_conv=3, n_expert=8, n_expert_used=2, n_ff_exp=256),
    # an attention block before the first FFN block, where the JAX package
    # labels the KV positions too (models/transformer.py first_attention_layer)
    "nemotron_h": dict(pattern="SAFSF", d_state=32, n_group=2),
    "nemotron_h_moe": dict(pattern="SAF", d_state=32, n_group=2, n_expert=4,
                           n_expert_used=2, n_ff_exp=256),
    "falcon-h1": dict(pattern="HH", d_state=32, n_group=2),
    "granitehybrid": dict(pattern="SA", d_state=32, n_group=2, metadata=_GRANITE),
    "plamo2": dict(pattern="SA", d_state=16, ssm_heads=8, dt_rank=16),
    "kimi-linear": dict(pattern="SA", d_state=32, rope_dims=16, kv_lora_rank=64, mla_nope=32,
                        n_expert=4, n_expert_used=2, n_ff_exp=256, shared_expert_ff=256),
}


def make_bench_qwen3next_gguf(path: str, n_layers: int = 48, synth_scale: float = 1.0,
                              seed: int = 0) -> str:
    """Qwen3-Next-80B-A3B-shaped GGUF (Qwen/Qwen3-Next-80B-A3B-Instruct
    config.json): n_embd 2048; three gated-DeltaNet layers to each gated
    full-attention layer (full_attention_interval 4); attention 16 query
    heads on 2 KV heads of 256, NEOX rope over 64 dims at base 1e7, per-head
    q/k norms, an output gate; DeltaNet 16 key heads and 32 value heads of
    128, conv kernel 4 (ssm.inner_size 4096, state_size 128, group_count 16,
    time_step_rank 32); 512 experts of 512, top 10, softmax with normalised
    weights, one sigmoid-gated shared expert of 512; vocab 151936; the
    Q4_K_M mix; rms eps 1e-6."""
    return make_bench_hybrid_gguf(
        path, "qwen3next", ("SSSA" * -(-n_layers // 4))[:n_layers], 2048, 151936,
        n_heads=16, n_kv_heads=2, head_dim=256, rope_dims=64, n_ff=5120, d_inner=4096,
        d_state=128, n_group=16, ssm_heads=32, n_expert=512, n_expert_used=10, n_ff_exp=512,
        shared_expert_ff=512, n_ctx=262144, rope_base=1e7, synth_scale=synth_scale, seed=seed)


# the first eight blocks of Nemotron-H-8B's hybrid_override_pattern
# ("M-M-M-M*-..."): Mamba-2 M, FFN -, attention *
NEMOTRON_H_8B_PATTERN = "M-M-M-M*"


def make_bench_nemotron_h_gguf(path: str, n_layers: int = 8, synth_scale: float = 1.0,
                               seed: int = 0) -> str:
    """Nemotron-H-8B-shaped GGUF (nvidia/Nemotron-H-8B-Base-8K config.json),
    the first n_layers (at most 8) blocks of its 52-block pattern: Mamba-2
    at 0, 2, 4, 6, relu^2 FFN blocks of 21504 at 1, 3, 5, NoPE attention at
    7; n_embd 4096; Mamba-2 128 heads of 64 (d_inner 8192), 8 groups, state
    128, conv 4; attention 32 heads on 8 KV heads of 128; vocab 131072; rms
    eps 1e-5; the Q4_K_M mix."""
    if n_layers > len(NEMOTRON_H_8B_PATTERN):
        raise ValueError(f"the pattern is written out for {len(NEMOTRON_H_8B_PATTERN)} blocks")
    pattern = NEMOTRON_H_8B_PATTERN[:n_layers].replace("M", "S").replace("-", "F") \
        .replace("*", "A")
    return make_bench_hybrid_gguf(
        path, "nemotron_h", pattern, 4096, 131072, n_heads=32, n_kv_heads=8, head_dim=128,
        n_ff=21504, d_inner=8192, d_state=128, n_group=8, ssm_heads=128, n_ctx=8192,
        rms_eps=1e-5, synth_scale=synth_scale, seed=seed)


def make_bench_gpt_oss_gguf(path: str, n_layers: int = 24, n_embd: int = 2880,
                            n_heads: int = 64, n_kv_heads: int = 8, head_dim: int = 64,
                            n_expert: int = 32, n_expert_used: int = 4, n_ff_exp: int = 2880,
                            vocab_size: int = 201088, n_ctx: int = 131072,
                            sliding_window: int = 128, synth_scale: float = 1.0,
                            f32: bool = False, seed: int = 0) -> str:
    """gpt-oss-20B-shaped (by default; openai/gpt-oss-20b config.json) GGUF:
    2880 wide, 64 query heads on 8 KV heads of 64 with sinks and q/k/v and
    output biases, window layers of 128 and full layers in turn, NEOX rope
    at base 150000 (the window layers' base the same) with YaRN factor 32
    from 4096, 32 experts of 2880 (top 4 of the router's biased logits, then
    a softmax) with biases and the clamped oai GLU, vocab 201088, an untied
    head; experts MXFP4, every other matrix Q8_0 (a block of 32 divides
    2880), norms, biases, sinks and router F32; the pre-FFN norm stored as
    post_attention_norm, as llama.cpp writes it."""
    layout = {**MOE_FAMILY_LAYOUTS["gpt-oss"], "n_expert": n_expert,
              "n_expert_used": n_expert_used, "n_ff_exp": n_ff_exp,
              "sliding_window": sliding_window}
    return make_bench_arch_gguf(path, "gpt-oss", n_layers, n_embd, n_heads, n_kv_heads,
                                head_dim, n_ff_exp, vocab_size, n_ctx, synth_scale=synth_scale,
                                f32=f32, seed=seed, **layout)


def make_bench_llama4_gguf(path: str, n_layers: int = 48, n_embd: int = 5120,
                           n_heads: int = 40, n_kv_heads: int = 8, head_dim: int = 128,
                           n_ff: int = 16384, n_expert: int = 16, n_expert_used: int = 1,
                           n_ff_exp: int = 8192, vocab_size: int = 202048,
                           n_ctx: int = 10485760, ftype: str = "q4_k_m",
                           synth_scale: float = 1.0, f32: bool = False, seed: int = 0) -> str:
    """Llama-4-Scout-17B-16E-shaped (by default; the text config of
    meta-llama/Llama-4-Scout-17B-16E config.json) GGUF: 5120 wide, 40 heads
    on 8 KV heads of 128, NORM rope at base 500000 with every fourth layer
    NoPE (no_rope_layers), the weightless q/k norm after rope (use_qk_norm),
    16 experts of 8192 on every layer (interleave step 1), top 1 by sigmoid
    with the gate on the expert input, an ungated shared expert of 8192,
    vocab 202048, an untied head; the Q4_K_M mix of make_bench_arch_gguf
    (ftype). The config's llama3 rope scaling (factor 16 from 8192) and
    attention temperature tuning are not written: the JAX package's llama4
    graph reads neither."""
    layout = {**MOE_FAMILY_LAYOUTS["llama4"], "n_expert": n_expert,
              "n_expert_used": n_expert_used, "n_ff_exp": n_ff_exp,
              "shared_expert_ff": n_ff_exp,
              "metadata": {**MOE_FAMILY_LAYOUTS["llama4"]["metadata"], "no_rope_layers": [
                  int((i + 1) % 4 != 0) for i in range(n_layers)]}}
    return make_bench_arch_gguf(path, "llama4", n_layers, n_embd, n_heads, n_kv_heads,
                                head_dim, n_ff, vocab_size, n_ctx, ftype=ftype,
                                synth_scale=synth_scale, f32=f32, seed=seed, **layout)


def make_bench_starcoder2_gguf(path: str, n_layers: int = 32, n_embd: int = 4608,
                               n_heads: int = 36, n_kv_heads: int = 4, head_dim: int = 128,
                               n_ff: int = 18432, vocab_size: int = 49152, n_ctx: int = 16384,
                               ftype: str = "q4_k_m", synth_scale: float = 1.0,
                               seed: int = 0) -> str:
    """StarCoder2-7B-shaped (by default; bigcode/starcoder2-7b config.json)
    GGUF: LayerNorm with biases (eps 1e-5), q/k/v and output projections
    with biases, a non-gated GELU FFN of 18432 with biases, NEOX rope at
    base 1e6, 36 query heads on 4 KV heads of 128, an untied head; the
    config's sliding window of 4096 is not written, as neither llama.cpp's
    starcoder2 graph nor the JAX package reads one. ftype and synth_scale
    as make_bench_arch_gguf's."""
    return make_bench_arch_gguf(path, "starcoder2", n_layers, n_embd, n_heads, n_kv_heads,
                                head_dim, n_ff, vocab_size, n_ctx, ftype=ftype,
                                synth_scale=synth_scale, seed=seed,
                                **FAMILY_LAYOUTS["starcoder2"])


def make_bench_command_r_gguf(path: str, n_layers: int = 40, n_embd: int = 8192,
                              n_heads: int = 64, n_kv_heads: int = 64, head_dim: int = 128,
                              n_ff: int = 22528, vocab_size: int = 256000, n_ctx: int = 131072,
                              ftype: str = "q4_k_m", seed: int = 0) -> str:
    """Command-R v01-shaped (by default; CohereForAI/c4ai-command-r-v01
    config.json) GGUF: LayerNorm without bias (eps 1e-5) shared by the
    attention and the SwiGLU FFN of 22528 in a parallel residual, 64 heads
    and 64 KV heads of 128, NORM rope at base 8e6, logit scale 0.0625, a
    tied head (a Q6_K token_embd). ftype as make_bench_arch_gguf's."""
    return make_bench_arch_gguf(path, "command-r", n_layers, n_embd, n_heads, n_kv_heads,
                                head_dim, n_ff, vocab_size, n_ctx, rope_base=8e6, ftype=ftype,
                                seed=seed, **FAMILY_LAYOUTS["command-r"])


def make_bench_qwen3_gguf(path: str, n_layers: int = 36, n_embd: int = 4096, n_heads: int = 32,
                          n_kv_heads: int = 8, head_dim: int = 128, n_ff: int = 12288,
                          vocab_size: int = 151936, n_ctx: int = 40960, ftype: str = "q4_k_m",
                          seed: int = 0) -> str:
    """Qwen3-8B-shaped (by default; Qwen/Qwen3-8B config.json) dense GGUF:
    per-head q/k RMSNorm, NEOX rope at base 1e6, rms eps 1e-6, an untied
    head; ftype as make_bench_arch_gguf's."""
    return make_bench_arch_gguf(path, "qwen3", n_layers, n_embd, n_heads, n_kv_heads,
                                head_dim, n_ff, vocab_size, n_ctx, rope_base=1e6,
                                qk_norm=True, ftype=ftype, seed=seed)


def make_bench_qwen3moe_gguf(path: str, n_layers: int = 48, n_embd: int = 2048,
                             n_heads: int = 32, n_kv_heads: int = 4, head_dim: int = 128,
                             n_expert: int = 128, n_expert_used: int = 8, n_ff_exp: int = 768,
                             vocab_size: int = 151936, n_ctx: int = 40960,
                             ftype: str = "q4_k_m", seed: int = 0) -> str:
    """Qwen3-30B-A3B-shaped (by default; Qwen/Qwen3-30B-A3B config.json)
    MoE GGUF: 128 experts of 768, top 8 with normalised weights, per-head
    q/k RMSNorm, NEOX rope at base 1e6, an untied head; ftype as
    make_bench_arch_gguf's."""
    return make_bench_arch_gguf(path, "qwen3moe", n_layers, n_embd, n_heads, n_kv_heads,
                                head_dim, 6144, vocab_size, n_ctx, rope_base=1e6, qk_norm=True,
                                n_expert=n_expert, n_expert_used=n_expert_used,
                                n_ff_exp=n_ff_exp, ftype=ftype, seed=seed)


def make_bench_gemma3_gguf(path: str, n_layers: int = 34, n_embd: int = 2560, n_heads: int = 8,
                           n_kv_heads: int = 4, head_dim: int = 256, n_ff: int = 10240,
                           vocab_size: int = 262208, sliding_window: int = 1024,
                           swa_pattern: int = 6, n_ctx: int = 131072, seed: int = 0) -> str:
    """Gemma-3-4B-shaped (by default; google/gemma-3-4b-it config.json,
    text_config) GGUF: five sliding-window layers (window 1024, rope base
    1e4) to each full layer (rope base 1e6, linear factor 8), heads of 256
    (query_pre_attn_scalar 256), GeGLU, post-norms, q/k norms and a tied
    head."""
    return make_bench_arch_gguf(path, "gemma3", n_layers, n_embd, n_heads, n_kv_heads,
                                head_dim, n_ff, vocab_size, n_ctx, rope_base=1e6, qk_norm=True,
                                post_norms=True, tie=True, sliding_window=sliding_window,
                                swa_pattern=swa_pattern, rope_base_swa=1e4,
                                rope_linear_factor=8.0, seed=seed)


def _gemma_emitters(w: GGUFWriter, rng, ftype: str, f32: bool, synth_scale: float):
    """-> (emit_f, emit_m, norm_w) of a Gemma 3n/4 fixture: emit_f writes F32
    values; emit_m a matrix (numpy shape [..., out, in]) in the type that
    llama-quantize gives its name under ftype (tensor_target_type: F32 for
    norms and for rows that are no multiple of 256), as synthetic blocks, or
    F32 random values (scale 1/sqrt(in)) with f32; norm_w a norm's weight."""
    default = FTYPES[ftype][0]

    def emit_f(name, arr):
        arr = np.ascontiguousarray(arr, dtype=np.float32)
        w.add_tensor(name, arr.tobytes(), tuple(reversed(arr.shape)), GGMLType.F32)
        return GGMLType.F32, arr.tobytes()

    def emit_m(name, *shape, scale=None):
        """-> (type, the bytes written)."""
        t = tensor_target_type(name, shape, default, ftype)
        if f32 or t == GGMLType.F32:
            return emit_f(name, rng.standard_normal(shape) * (scale or 1.0 / np.sqrt(shape[-1])))
        n = int(np.prod(shape, dtype=np.int64))
        if t in (GGMLType.F16, GGMLType.BF16):
            data = quantize((rng.standard_normal(shape) / np.sqrt(shape[-1])).astype(np.float32),
                            t).tobytes()
        else:
            data = synth_quant_bytes(rng, n, t, offset=int(rng.integers(1, 1 << 24)),
                                     scale_mult=synth_scale)
        w.add_tensor(name, data, tuple(reversed(shape)), t)
        return t, data

    def norm_w(n):
        return 1.0 + 0.1 * rng.standard_normal(n)

    return emit_f, emit_m, norm_w


def _embedded_rms(t: GGMLType, data, n_embd: int) -> float:
    """The RMS of a Gemma token_embd table's rows as the model embeds them
    (times sqrt(n_embd)), from the bytes the file holds."""
    raw = np.frombuffer(bytes(data), np.uint8)
    n = raw.nbytes // GGML_BLOCK_LAYOUT[t].type_size * GGML_BLOCK_LAYOUT[t].block_size
    v = dequantize(raw, t, n)
    return float(np.sqrt(np.mean(np.square(v, dtype=np.float64)) * n_embd))


def _gemma_md(w: GGUFWriter, arch: str, n_layers: int, n_embd: int, n_heads: int,
              n_kv_heads: int, head_dim: int, n_ff: int, vocab_size: int, n_ctx: int,
              rope_base: float, rope_base_swa: float, sliding_window: int, rms_eps: float,
              final_softcap: float, extra: dict) -> None:
    w.add(Keys.General.ARCHITECTURE, arch)
    w.add(Keys.General.NAME, f"bench-{arch}-synthetic")
    P = arch + "."
    for key, val in (("block_count", n_layers), ("context_length", n_ctx),
                     ("embedding_length", n_embd), ("feed_forward_length", n_ff),
                     ("attention.head_count", n_heads), ("attention.head_count_kv", n_kv_heads),
                     ("attention.key_length", head_dim), ("attention.value_length", head_dim),
                     ("rope.dimension_count", head_dim), ("vocab_size", vocab_size),
                     ("attention.sliding_window", sliding_window)):
        w.add(P + key, np.uint32(val))
    w.add(P + "attention.layer_norm_rms_epsilon", float(rms_eps))
    w.add(P + "rope.freq_base", float(rope_base))
    w.add(P + "rope.freq_base_swa", float(rope_base_swa))
    if final_softcap:
        w.add(P + "final_logit_softcapping", float(final_softcap))
    for key, val in extra.items():
        w.add(P + key, val)
    _add_bench_vocab(w, vocab_size)


def make_bench_gemma3n_gguf(path: str, n_layers: int = 35, n_embd: int = 2048, n_heads: int = 8,
                            n_kv_heads: int = 2, head_dim: int = 256, n_ff: int = 16384,
                            vocab_size: int = 262144, n_embd_altup: int = 256, n_altup: int = 4,
                            laurel_rank: int = 64, sliding_window: int = 512,
                            swa_pattern: int = 5, shared_kv_layers: int = 15,
                            final_softcap: float = 30.0, n_ctx: int = 32768,
                            ftype: str = "q4_k_m", f32: bool = False, synth_scale: float = 1.0,
                            seed: int = 0) -> str:
    """A Gemma-3n-E4B-shaped GGUF (by default; google/gemma-3n-E4B
    config.json, text_config): 8 heads on 2 KV heads of 256, four window
    layers (window 512, rope base 1e4) to each full one (rope base 1e6),
    the last shared_kv_layers layers reading the KV of the last owned layer
    of their class, 4 AltUp streams, LAUREL of rank 64, per-layer inputs of
    256 from a 262144-row table, a tied head, final softcap 30; the
    activation sparsity left to the registry's default (the first 10
    layers). Each tensor in the type llama-quantize gives it under ftype
    (_gemma_emitters), or F32 values with f32. Every layer carries its K/V
    projections, as the published files do; a shared layer's go unused."""
    rng = np.random.default_rng(seed)
    w = GGUFWriter()
    _gemma_md(w, "gemma3n", n_layers, n_embd, n_heads, n_kv_heads, head_dim, n_ff, vocab_size,
              n_ctx, 1e6, 1e4, sliding_window, 1e-6, final_softcap, {
                  "attention.sliding_window_pattern": np.uint32(swa_pattern),
                  "attention.shared_kv_layers": np.uint32(shared_kv_layers),
                  "altup.num_inputs": np.uint32(n_altup),
                  "altup.active_idx": np.uint32(0),
                  "embedding_length_per_layer_input": np.uint32(n_embd_altup)})
    emit_f, emit_m, norm_w = _gemma_emitters(w, rng, ftype, f32, synth_scale)
    E, A, Ep, L = n_embd, n_altup, n_embd_altup, n_layers
    emit_m("token_embd.weight", vocab_size, E, scale=0.05)
    emit_f("output_norm.weight", norm_w(E))
    emit_m("per_layer_token_embd.weight", vocab_size, L * Ep, scale=0.05)
    emit_m("per_layer_model_proj.weight", L * Ep, E)
    emit_f("per_layer_proj_norm.weight", norm_w(Ep))
    emit_m("altup_proj.weight", A - 1, E, E)
    emit_m("altup_unembd_proj.weight", A - 1, E, E)
    q_dim, kv_dim = n_heads * head_dim, n_kv_heads * head_dim
    for i in range(L):
        b = f"blk.{i}."
        emit_f(b + "attn_norm.weight", norm_w(E))
        emit_m(b + "attn_q.weight", q_dim, E)
        emit_m(b + "attn_k.weight", kv_dim, E)
        emit_m(b + "attn_v.weight", kv_dim, E)
        emit_m(b + "attn_output.weight", E, q_dim)
        emit_f(b + "attn_q_norm.weight", norm_w(head_dim))
        emit_f(b + "attn_k_norm.weight", norm_w(head_dim))
        emit_f(b + "post_attention_norm.weight", norm_w(E))
        emit_f(b + "ffn_norm.weight", norm_w(E))
        emit_m(b + "ffn_gate.weight", n_ff, E)
        emit_m(b + "ffn_up.weight", n_ff, E)
        emit_m(b + "ffn_down.weight", E, n_ff)
        emit_f(b + "post_ffw_norm.weight", norm_w(E))
        emit_f(b + "altup_correct_coef.weight", rng.standard_normal((A, A)) * 0.1)
        emit_f(b + "altup_correct_scale.weight", norm_w(E))
        emit_f(b + "altup_predict_coef.weight", rng.standard_normal((A * A, A)) * 0.1)
        emit_m(b + "altup_router.weight", A, E)
        emit_f(b + "altup_router_norm.weight", norm_w(E))
        emit_m(b + "laurel_l.weight", laurel_rank, E)
        emit_m(b + "laurel_r.weight", E, laurel_rank)
        emit_f(b + "laurel_post_norm.weight", norm_w(E))
        emit_m(b + "inp_gate.weight", Ep, E)
        emit_m(b + "proj.weight", E, Ep)
        emit_f(b + "post_norm.weight", norm_w(E))
    w.write(path)
    return path


def make_bench_gemma4_gguf(path: str, n_layers: int = 4, n_embd: int = 1024, n_heads: int = 8,
                           n_kv_heads: int = 4, head_dim: int = 256, head_dim_swa: int = 128,
                           n_ff: int = 2048, vocab_size: int = 2048,
                           is_swa: tuple = (1, 0, 1, 1), sliding_window: int = 512,
                           shared_kv_layers: int = 1, n_embd_per_layer: int = 256,
                           n_expert: int = 8, n_expert_used: int = 2, n_ff_exp: int = 256,
                           moe_layers: tuple = (1,), alt_v_layers: tuple = (2,),
                           final_softcap: float = 30.0, n_ctx: int = 4096,
                           ftype: str = "q4_k_m", f32: bool = False, synth_scale: float = 1.0,
                           untied_head: bool = False, block_gain: float | None = None,
                           seed: int = 0) -> str:
    """A Gemma 4 GGUF on the layout of the JAX package's test_gemma4: a
    per-layer window array is_swa (window heads of head_dim_swa, full heads
    of head_dim), the last shared_kv_layers layers without K/V of their
    own, the alt_v_layers without attn_v (V from the K projection), the
    moe_layers with the dual-branch MoE (an F32 router and its scale, fused
    [gate | up] expert stacks and the branches' norms), per-layer inputs
    (none with n_embd_per_layer 0),
    rope_freqs on the full layers, a per-layer output scalar and final
    softcap. Types as make_bench_gemma3n_gguf's. untied_head adds an output
    head of its own; block_gain scales every block's post norms so that each
    block adds about block_gain of the embedded row's RMS (a target whose
    next token nearly follows from the current one, which a mirrored
    assistant, make_bench_gemma4_assistant_gguf's mirror_of, predicts)."""
    rng = np.random.default_rng(seed)
    w = GGUFWriter()
    L = n_layers
    _gemma_md(w, "gemma4", L, n_embd, n_heads, n_kv_heads, head_dim, n_ff, vocab_size, n_ctx,
              1e6, 1e4, sliding_window, 1e-6, final_softcap, {
                  "attention.key_length_swa": np.uint32(head_dim_swa),
                  "attention.value_length_swa": np.uint32(head_dim_swa),
                  "attention.sliding_window_pattern": np.asarray(is_swa, np.uint32),
                  "attention.shared_kv_layers": np.uint32(shared_kv_layers),
                  "embedding_length_per_layer_input": np.uint32(n_embd_per_layer),
                  "expert_count": np.uint32(n_expert),
                  "expert_used_count": np.uint32(n_expert_used),
                  "expert_feed_forward_length": np.uint32(n_ff_exp)})
    emit_f, emit_m, norm_w = _gemma_emitters(w, rng, ftype, f32, synth_scale)
    E, Ep = n_embd, n_embd_per_layer
    t_embd, embd = emit_m("token_embd.weight", vocab_size, E, scale=0.05)
    emit_f("output_norm.weight", norm_w(E))
    if untied_head:
        emit_m("output.weight", vocab_size, E)
    gain = 1.0 if block_gain is None else block_gain * _embedded_rms(t_embd, embd, E)
    emit_f("rope_freqs.weight", np.linspace(1.0, 2.0, head_dim // 2))
    if Ep:
        emit_m("per_layer_token_embd.weight", vocab_size, L * Ep, scale=0.05)
        emit_m("per_layer_model_proj.weight", L * Ep, E)
        emit_f("per_layer_proj_norm.weight", norm_w(Ep))
    for i in range(L):
        b = f"blk.{i}."
        dk = head_dim_swa if is_swa[i] else head_dim
        emit_f(b + "attn_norm.weight", norm_w(E))
        emit_m(b + "attn_q.weight", n_heads * dk, E)
        emit_f(b + "attn_q_norm.weight", norm_w(dk))
        if i < L - shared_kv_layers:
            emit_m(b + "attn_k.weight", n_kv_heads * dk, E)
            if i not in alt_v_layers:
                emit_m(b + "attn_v.weight", n_kv_heads * dk, E)
            emit_f(b + "attn_k_norm.weight", norm_w(dk))
        emit_m(b + "attn_output.weight", E, n_heads * dk)
        emit_f(b + "post_attention_norm.weight", norm_w(E) * gain)
        emit_f(b + "ffn_norm.weight", norm_w(E))
        emit_m(b + "ffn_gate.weight", n_ff, E)
        emit_m(b + "ffn_up.weight", n_ff, E)
        emit_m(b + "ffn_down.weight", E, n_ff)
        emit_f(b + "post_ffw_norm.weight", norm_w(E) * gain)
        if i in moe_layers:
            emit_f(b + "ffn_gate_inp.weight", rng.standard_normal((n_expert, E)) * 0.5)
            emit_f(b + "ffn_gate_inp.scale", norm_w(E))
            emit_f(b + "pre_ffw_norm_2.weight", norm_w(E))
            emit_f(b + "post_ffw_norm_1.weight", norm_w(E))
            emit_f(b + "post_ffw_norm_2.weight", norm_w(E))
            emit_m(b + "ffn_gate_up_exps.weight", n_expert, 2 * n_ff_exp, E)
            emit_m(b + "ffn_down_exps.weight", n_expert, E, n_ff_exp)
        if Ep:
            emit_m(b + "inp_gate.weight", Ep, E)
            emit_m(b + "proj.weight", E, Ep)
            emit_f(b + "post_norm.weight", norm_w(E))
        emit_f(b + "layer_output_scale.weight", [0.98 + 0.01 * i])
    w.write(path)
    return path


def make_bench_gemma4_assistant_gguf(path: str, n_layers: int = 2, n_embd: int = 1024,
                                     n_heads: int = 8, n_kv_heads: int = 4, head_dim: int = 256,
                                     head_dim_swa: int = 128, n_ff: int = 2048,
                                     vocab_size: int = 2048, is_swa: tuple = (1, 0),
                                     sliding_window: int = 512, n_embd_out: int = 1024,
                                     ftype: str = "q4_k_m", f32: bool = False,
                                     synth_scale: float = 1.0, mirror_of: str | None = None,
                                     block_gain: float = 0.15, h_gain: float = 0.05,
                                     seed: int = 1) -> str:
    """A Gemma 4 MTP assistant GGUF for a make_bench_gemma4_gguf target of
    n_embd_out (the JAX package's tests/test_speculative.py _gemma4_pair
    layout): q-only layers (each attends the target's last layer of its
    window class), nextn.pre_projection [n_embd, n_embd + n_embd_out] and
    nextn.post_projection [n_embd_out, n_embd], a tied head of its own.

    mirror_of, the path of a target written with untied_head and
    block_gain, makes an assistant whose drafts that target accepts: its
    pre-projection (Q8_0) passes the token's embedding through and adds the
    target's feature row at h_gain of the embedded row's RMS through a
    random map, its blocks add block_gain each as the target's do, and it
    reads the target's output norm and head (copied), so it predicts the
    token that follows the current one but for near-ties."""
    rng = np.random.default_rng(seed)
    w = GGUFWriter()
    a = "gemma4-assistant"
    _gemma_md(w, a, n_layers, n_embd, n_heads, n_kv_heads, head_dim, n_ff, vocab_size, 4096,
              1e6, 1e4, sliding_window, 1e-6, 0.0, {
                  "attention.key_length_swa": np.uint32(head_dim_swa),
                  "attention.value_length_swa": np.uint32(head_dim_swa),
                  "attention.sliding_window_pattern": np.asarray(is_swa, np.uint32),
                  "embedding_length_out": np.uint32(n_embd_out),
                  "nextn_predict_layers": np.uint32(n_layers)})
    emit_f, emit_m, norm_w = _gemma_emitters(w, rng, ftype, f32, synth_scale)
    E = n_embd
    emit_m("token_embd.weight", vocab_size, E, scale=0.05)
    gain = 1.0
    if mirror_of is None:
        emit_f("output_norm.weight", norm_w(E))
        emit_m("nextn.pre_projection.weight", E, E + n_embd_out)
    else:
        if E != n_embd_out:
            raise ValueError("a mirrored assistant is as wide as its target")
        tf = read_gguf(mirror_of)
        te = tf.tensors["token_embd.weight"]
        x_rms = _embedded_rms(te.dtype, te.data, n_embd_out)
        for name in ("output_norm.weight", "output.weight"):
            info = tf.tensors[name]
            w.add_tensor(name, np.asarray(info.data).tobytes(), info.ne, info.dtype)
        pre = np.concatenate([np.eye(E), rng.standard_normal((E, n_embd_out))
                              * (h_gain * x_rms / np.sqrt(n_embd_out))], axis=1)
        w.add_tensor("nextn.pre_projection.weight",
                     quantize(pre.astype(np.float32), GGMLType.Q8_0).tobytes(),
                     (E + n_embd_out, E), GGMLType.Q8_0)
        gain = block_gain * x_rms
    emit_m("nextn.post_projection.weight", n_embd_out, E)
    for i in range(n_layers):
        b = f"blk.{i}."
        dk = head_dim_swa if is_swa[i] else head_dim
        emit_f(b + "attn_norm.weight", norm_w(E))
        emit_m(b + "attn_q.weight", n_heads * dk, E)
        emit_f(b + "attn_q_norm.weight", norm_w(dk))
        emit_m(b + "attn_output.weight", E, n_heads * dk)
        emit_f(b + "post_attention_norm.weight", norm_w(E) * gain)
        emit_f(b + "ffn_norm.weight", norm_w(E))
        emit_m(b + "ffn_gate.weight", n_ff, E)
        emit_m(b + "ffn_up.weight", n_ff, E)
        emit_m(b + "ffn_down.weight", E, n_ff)
        emit_f(b + "post_ffw_norm.weight", norm_w(E) * gain)
        emit_f(b + "layer_output_scale.weight", [1.0])
    w.write(path)
    return path


# MiniMax-M3's narrow layout: a dense-lead layer (no indexer: its attention
# on the slot table's kernel), then MSA layers with 8 experts top 2 and a
# shared expert; partial rope; indexer keys of 128 in blocks of 64, top 2
MINIMAX_M3_LAYOUT = dict(qk_norm=True, **_MOE, **_SHARED, n_dense_lead=1, indexer_dim=128,
                         metadata={"rope.dimension_count": np.uint32(64),
                                   "attention.indexer.key_length": np.uint32(128),
                                   "attention.indexer.top_k": np.uint32(2),
                                   "attention.indexer.block_size": np.uint32(64),
                                   "attention.indexer.local_blocks": np.uint32(1),
                                   "leading_dense_block_count": np.uint32(1)})


def make_bench_deepseek2_gguf(
    path: str,
    n_layers: int = 27,
    n_embd: int = 2048,
    n_heads: int = 16,
    q_lora_rank: int = 0,
    kv_lora_rank: int = 512,
    qk_nope: int = 128,
    qk_rope: int = 64,
    v_dim: int = 128,
    n_ff: int = 10944,
    n_dense: int = 1,
    n_expert: int = 64,
    n_expert_used: int = 6,
    n_ff_exp: int = 1408,
    n_expert_shared: int = 2,
    gating: str = "softmax",
    weights_norm: bool = False,
    weights_scale: float = 1.0,
    vocab_size: int = 102400,
    n_ctx: int = 163840,
    yarn_factor: float = 40.0,
    yarn_orig_ctx: int = 4096,
    mscale_all_dim: float = 0.707,
    split_kv_b: bool = False,
    arch: str = "deepseek2",
    tie: bool = False,
    glu: bool = True,
    synth_scale: float = 1.0,
    f32: bool = False,
    seed: int = 0,
) -> str:
    """A deepseek2 GGUF (DeepSeek-V2-Lite's widths by default:
    deepseek-ai/DeepSeek-V2-Lite config.json) with synthetic weights, at any
    depth: q from a q-LoRA (q_lora_rank > 0, V3) or a plain attn_q (lite);
    the MLA latent attn_kv_a_mqa [kv_lora + qk_rope, n_embd] with its norm
    and the decompression attn_kv_b [n_heads (qk_nope + v_dim), kv_lora],
    or with split_kv_b=True instead attn_k_b [n_heads, kv_lora, qk_nope]
    and attn_v_b [n_heads, v_dim, kv_lora] holding the same values (as
    current llama.cpp files ship it); n_dense leading dense layers (ffn
    n_ff), then MoE layers of n_expert routed experts of n_ff_exp, top
    n_expert_used, and n_expert_shared shared experts in one FFN of
    n_expert_shared * n_ff_exp; gating "sigmoid" adds the selection bias
    exp_probs_b (V3); the YaRN keys as the converter writes them
    (yarn_log_mul = 0.1 * mscale_all_dim). n_expert=0 makes every layer
    dense.

    The other MLA entries, by `arch`: "mistral4" is the same file under its
    own name; "minicpm3" and "plm" write their head dims as key_length
    (qk_nope + qk_rope) and value_length (v_dim), as their converters do,
    without the _mla keys or YaRN; plm has no q-LoRA. tie=True writes no
    output (the head is the Q6_K token_embd, row-major); glu=False drops
    ffn_gate (plm's ReLU^2 FFN). synth_scale multiplies the synthetic blocks'
    scales.

    Storage types are llama-quantize's Q4_K_M mix as make_bench_arch_gguf
    writes it: Q4_K, Q6_K for ffn_down, the shared and routed experts' down
    and output; a matrix whose rows are not a multiple of 256 takes the
    tool's fallback type, F32 (tools/quantize_tool.tensor_target_type:
    V2-Lite's dense ffn_down of 10944, its experts' down of 1408, attn_k_b's
    rows of qk_nope). With split_kv_b, attn_v_b holds attn_kv_b's Q4_K rows
    byte for byte and attn_k_b the f32 values the port dequantizes attn_kv_b
    to, so both files load to the same model. f32=True writes every matrix
    as F32 random values (scale 1/sqrt(in))."""
    from .ops.qtensor import load_weight

    rng = np.random.default_rng(seed)
    P = arch + "."
    deepseek = arch in ("deepseek2", "mistral4")
    if not n_expert:
        n_dense = n_layers
    w = GGUFWriter()
    w.add(Keys.General.ARCHITECTURE, arch)
    w.add(Keys.General.NAME, f"bench-{arch}-synthetic")
    if deepseek:  # the absorbed lengths, the naive ones under _mla
        dims = (("attention.key_length", kv_lora_rank + qk_rope),
                ("attention.value_length", kv_lora_rank),
                ("attention.key_length_mla", qk_nope + qk_rope),
                ("attention.value_length_mla", v_dim),
                ("rope.scaling.original_context_length", yarn_orig_ctx))
    else:
        dims = (("attention.key_length", qk_nope + qk_rope), ("attention.value_length", v_dim))
    for key, val in (("block_count", n_layers), ("context_length", n_ctx),
                     ("embedding_length", n_embd), ("feed_forward_length", n_ff),
                     ("attention.head_count", n_heads),
                     ("attention.head_count_kv", 1 if deepseek else n_heads), *dims,
                     ("attention.kv_lora_rank", kv_lora_rank),
                     ("rope.dimension_count", qk_rope), ("vocab_size", vocab_size),
                     ("leading_dense_block_count", n_dense), ("expert_count", n_expert),
                     ("expert_used_count", n_expert_used),
                     ("expert_feed_forward_length", n_ff_exp),
                     ("expert_shared_count", n_expert_shared),
                     ("expert_gating_func", 2 if gating == "sigmoid" else 1)):
        w.add(P + key, np.uint32(val))
    if q_lora_rank:
        w.add(P + "attention.q_lora_rank", np.uint32(q_lora_rank))
    w.add(P + "attention.layer_norm_rms_epsilon", 1e-6)
    w.add(P + "rope.freq_base", 10000.0)
    if deepseek:
        w.add(P + "rope.scaling.type", "yarn")
        w.add(P + "rope.scaling.factor", float(yarn_factor))
        w.add(P + "rope.scaling.yarn_log_mul", float(0.1 * mscale_all_dim))
    w.add(P + "expert_weights_norm", bool(weights_norm))
    w.add(P + "expert_weights_scale", float(weights_scale))
    _add_bench_vocab(w, vocab_size)

    q4, q6 = GGMLType.Q4_K, GGMLType.Q6_K

    def emit_f(name, arr):
        arr = np.ascontiguousarray(arr, dtype=np.float32)
        w.add_tensor(name, arr.tobytes(), tuple(reversed(arr.shape)), GGMLType.F32)

    def qbytes(rows, cols, t, stack=()):
        n = rows * cols * int(np.prod(stack, dtype=np.int64))
        return synth_quant_bytes(rng, n, t, offset=int(rng.integers(1, 1 << 24)),
                                 scale_mult=synth_scale)

    def emit_q(name, rows, cols, t, stack=()):
        if f32 or cols % 256:
            vals = rng.standard_normal((*stack, rows, cols), dtype=np.float32)
            emit_f(name, vals * np.float32(1.0 / np.sqrt(cols)))
            return
        w.add_tensor(name, qbytes(rows, cols, t, stack), (cols, rows, *reversed(stack)), t)

    def norm_w(n):
        return 1.0 + 0.1 * rng.standard_normal(n)

    def emit_kv_b(b):
        rows, C = n_heads * (qk_nope + v_dim), kv_lora_rank
        if f32 or C % 256:
            kv_b = rng.standard_normal((rows, C), dtype=np.float32) * np.float32(1 / np.sqrt(C))
            if not split_kv_b:
                emit_f(b + "attn_kv_b.weight", kv_b)
                return
            heads = kv_b.reshape(n_heads, qk_nope + v_dim, C)
            emit_f(b + "attn_k_b.weight", heads[:, :qk_nope].transpose(0, 2, 1))
            emit_f(b + "attn_v_b.weight", heads[:, qk_nope:])
            return
        data = qbytes(rows, C, q4)
        if not split_kv_b:
            w.add_tensor(b + "attn_kv_b.weight", data, (C, rows), q4)
            return
        # the same model split: V rows byte for byte, K as the f32 values the
        # loader dequantizes attn_kv_b's planes to
        row_bytes = C // 256 * GGML_BLOCK_LAYOUT[q4].type_size
        blocks = np.frombuffer(data, np.uint8).reshape(n_heads, qk_nope + v_dim, row_bytes)
        planes = load_weight(np.frombuffer(data, np.uint8), q4, (rows, C), transpose=True)
        wk = planes.dequant(torch.float32).reshape(C, n_heads, qk_nope + v_dim)
        emit_f(b + "attn_k_b.weight", wk[:, :, :qk_nope].permute(1, 0, 2).numpy())
        w.add_tensor(b + "attn_v_b.weight", blocks[:, qk_nope:].tobytes(), (C, v_dim, n_heads),
                     q4)

    emit_q("token_embd.weight", vocab_size, n_embd, q6 if tie else q4)
    emit_f("output_norm.weight", norm_w(n_embd))
    if not tie:
        emit_q("output.weight", vocab_size, n_embd, q6)
    Dq = n_heads * (qk_nope + qk_rope)
    for i in range(n_layers):
        b = f"blk.{i}."
        emit_f(b + "attn_norm.weight", norm_w(n_embd))
        if q_lora_rank:
            emit_q(b + "attn_q_a.weight", q_lora_rank, n_embd, q4)
            emit_f(b + "attn_q_a_norm.weight", norm_w(q_lora_rank))
            emit_q(b + "attn_q_b.weight", Dq, q_lora_rank, q4)
        else:
            emit_q(b + "attn_q.weight", Dq, n_embd, q4)
        emit_q(b + "attn_kv_a_mqa.weight", kv_lora_rank + qk_rope, n_embd, q4)
        emit_f(b + "attn_kv_a_norm.weight", norm_w(kv_lora_rank))
        emit_kv_b(b)
        emit_q(b + "attn_output.weight", n_embd, n_heads * v_dim, q4)
        emit_f(b + "ffn_norm.weight", norm_w(n_embd))
        if i < n_dense:
            if glu:
                emit_q(b + "ffn_gate.weight", n_ff, n_embd, q4)
            emit_q(b + "ffn_up.weight", n_ff, n_embd, q4)
            emit_q(b + "ffn_down.weight", n_embd, n_ff, q6)
            continue
        emit_f(b + "ffn_gate_inp.weight", rng.standard_normal((n_expert, n_embd)) * 0.02)
        if gating == "sigmoid":
            emit_f(b + "exp_probs_b.bias", 0.05 * rng.standard_normal(n_expert))
        emit_q(b + "ffn_gate_exps.weight", n_ff_exp, n_embd, q4, (n_expert,))
        emit_q(b + "ffn_up_exps.weight", n_ff_exp, n_embd, q4, (n_expert,))
        emit_q(b + "ffn_down_exps.weight", n_embd, n_ff_exp, q6, (n_expert,))
        if n_expert_shared:
            ff_sh = n_expert_shared * n_ff_exp
            emit_q(b + "ffn_gate_shexp.weight", ff_sh, n_embd, q4)
            emit_q(b + "ffn_up_shexp.weight", ff_sh, n_embd, q4)
            emit_q(b + "ffn_down_shexp.weight", n_embd, ff_sh, q6)
    w.write(path)
    return path


# -- RWKV: the four entries of models/rwkv.py ----------------------------------

RWKV_ARCHS = ("rwkv6", "rwkv7", "rwkv6qwen2", "arwkv7")


def make_bench_rwkv_gguf(path: str, arch: str = "rwkv7", n_layers: int = 32,
                         n_embd: int = 2560, head_size: int = 64, n_ff: int = 10240,
                         vocab_size: int = 65536, n_kv_heads: int = 0,
                         lora: tuple[int, int, int, int] = (96, 96, 64, 320),
                         gated: bool = True, rescale_every: int = 0, n_ctx: int = 1 << 20,
                         vocab: str = "bench", synth_scale: float = 1.0, f32: bool = False,
                         seed: int = 0) -> str:
    """An RWKV GGUF of `arch` (RWKV_ARCHS) with synthetic weights, laid out as
    the reference's load_arch_tensors (src/models/rwkv6.cpp, rwkv7.cpp,
    rwkv6qwen2.cpp, arwkv7.cpp) and the JAX package's tiny writers: RWKV-7
    World 2.9B's widths by default (BlinkDL/rwkv7-g1 RWKV-x070-World-2.9B:
    n_embd 2560, 40 heads of 64, channel mix 10240, vocab 65536, LoRA ranks
    96 decay, 96 in-context learning rate, 64 value residual, 320 gate).
    lora = (decay, iclr, value, gate) ranks for RWKV-7 and ARWKV-7; RWKV-6
    and RWKV6-Qwen2 take the first as the decay LoRA's and the mixing
    LoRA's rank. rwkv6qwen2's key/value are n_kv_heads heads wide (0: as
    many as the receptance) with biases; the hybrids carry a SiLU-GLU FFN
    of n_ff on ffn_norm and RMS norms. gated=False leaves RWKV-7's gate out.
    The Q4_K_M mix: Q4_K for token_embd and the projections, Q6_K for the
    down projection (channel_mix_value, ffn_down: Q4_K_M's ffn_down on the
    layers where it spends more bits) and output, F32 for the LoRA factors,
    mixing vectors and decays (llama-quantize keeps them: reference
    llama-quant.cpp's time_mix_* exclusions) and the norms; f32=True writes
    every matrix F32 (scale 1/sqrt(in)). vocab "tiny" writes the tiny SPM
    vocab (the JAX package's tiny writers'), "bench" its word-piece
    padding."""
    rng = np.random.default_rng(seed)
    hybrid = arch in ("rwkv6qwen2", "arwkv7")
    v7 = arch in ("rwkv7", "arwkv7")
    H = n_embd // head_size
    w = GGUFWriter()
    w.add(Keys.General.ARCHITECTURE, arch)
    w.add(Keys.General.NAME, f"bench-{arch}-synthetic")
    P = arch + "."
    for key, val in (("block_count", n_layers), ("context_length", n_ctx),
                     ("embedding_length", n_embd), ("feed_forward_length", n_ff),
                     ("wkv.head_size", head_size), ("vocab_size", vocab_size),
                     ("attention.head_count", H if hybrid else 0),
                     ("token_shift_count", 1 if hybrid else 2)):
        w.add(P + key, np.uint32(val))
    if hybrid:
        w.add(P + "attention.head_count_kv", np.uint32(n_kv_heads or H))
        w.add(P + "attention.layer_norm_rms_epsilon", 1e-5)
    else:
        w.add(P + "attention.layer_norm_epsilon", 1e-5)
    if rescale_every:
        w.add(P + "rescale_every_n_layers", np.uint32(rescale_every))
    if vocab == "tiny":
        tv = tiny_spm_vocab(vocab_size)
        for k in (Keys.Tokenizer.TOKENS, Keys.Tokenizer.SCORES, Keys.Tokenizer.TOKEN_TYPE):
            tv[k] = tv[k][:vocab_size]
        w.add_all(tv)
    else:
        _add_bench_vocab(w, vocab_size)

    def emit_f(name, arr):
        arr = np.ascontiguousarray(arr, dtype=np.float32)
        w.add_tensor(name, arr.tobytes(), tuple(reversed(arr.shape)), GGMLType.F32)

    def rand(*shape, scale=None):
        return rng.standard_normal(shape) * (scale or 1.0 / np.sqrt(shape[-1]))

    def mat(name, rows, cols, t=GGMLType.Q4_K):
        if f32 or cols % 256:
            emit_f(name, rand(rows, cols))
            return
        data = synth_quant_bytes(rng, rows * cols, t, offset=int(rng.integers(1, 1 << 24)),
                                 scale_mult=synth_scale)
        w.add_tensor(name, data, (cols, rows), t)

    def norm(name, bias=True):
        emit_f(name + ".weight", 1 + rand(n_embd, scale=0.02))
        if bias:
            emit_f(name + ".bias", rand(n_embd, scale=0.02))

    rw, ra, rv, rg = lora
    mat("token_embd.weight", vocab_size, n_embd)
    if not hybrid:
        norm("token_embd_norm")
    norm("output_norm", bias=not hybrid)
    mat("output.weight", vocab_size, n_embd, GGMLType.Q6_K)
    kv = (n_kv_heads or H) * head_size if arch == "rwkv6qwen2" else n_embd
    for i in range(n_layers):
        b = f"blk.{i}."
        norm(b + "attn_norm", bias=not hybrid)
        if not hybrid:
            norm(b + "attn_norm_2")
        if v7:
            emit_f(b + "time_mix_lerp_fused.weight",
                   rand(6 if gated else 5, 1, 1, n_embd, scale=0.3))
            for name, r in (("w", rw), ("a", ra)) + ((("v", rv),) if i > 0 else ()):
                emit_f(b + f"time_mix_{name}0.weight", rand(n_embd, scale=0.3))
                emit_f(b + f"time_mix_{name}1.weight", rand(r, n_embd))
                emit_f(b + f"time_mix_{name}2.weight", rand(n_embd, r))
            if gated:
                emit_f(b + "time_mix_g1.weight", rand(rg, n_embd))
                emit_f(b + "time_mix_g2.weight", rand(n_embd, rg))
            emit_f(b + "time_mix_k_k.weight", rand(n_embd, scale=0.3))
            emit_f(b + "time_mix_k_a.weight", rand(n_embd, scale=0.3))
            emit_f(b + "time_mix_r_k.weight", rand(H, head_size, scale=0.3))
        else:
            emit_f(b + "time_mix_w1.weight", rand(5 * rw, n_embd))
            emit_f(b + "time_mix_w2.weight", rand(5, n_embd, rw))
            emit_f(b + "time_mix_lerp_x.weight", rand(n_embd, scale=0.3))
            emit_f(b + "time_mix_lerp_fused.weight", rand(5, 1, 1, n_embd, scale=0.3))
            if not hybrid:  # rwkv6qwen2 has no bonus: the qrwkv branch
                emit_f(b + "time_mix_first.weight", rand(H, head_size, scale=0.3))
            emit_f(b + "time_mix_decay.weight", rand(n_embd, scale=0.3))
            emit_f(b + "time_mix_decay_w1.weight", rand(rw, n_embd))
            emit_f(b + "time_mix_decay_w2.weight", rand(n_embd, rw))
            mat(b + "time_mix_gate.weight", n_embd, n_embd)
        mat(b + "time_mix_key.weight", kv, n_embd)
        mat(b + "time_mix_value.weight", kv, n_embd)
        mat(b + "time_mix_receptance.weight", n_embd, n_embd)
        if arch == "rwkv6qwen2":
            for name, n in (("key", kv), ("value", kv), ("receptance", n_embd)):
                emit_f(b + f"time_mix_{name}.bias", rand(n, scale=0.05))
        if not hybrid:  # the group-norm tail (arwkv7 has none)
            norm(b + "time_mix_ln")
        mat(b + "time_mix_output.weight", n_embd, n_embd)
        if hybrid:
            emit_f(b + "ffn_norm.weight", 1 + rand(n_embd, scale=0.02))
            mat(b + "ffn_gate.weight", n_ff, n_embd)
            mat(b + "ffn_up.weight", n_ff, n_embd)
            mat(b + "ffn_down.weight", n_embd, n_ff, GGMLType.Q6_K)
            continue
        emit_f(b + "channel_mix_lerp_k.weight", rand(n_embd, scale=0.3))
        mat(b + "channel_mix_key.weight", n_ff, n_embd)
        mat(b + "channel_mix_value.weight", n_embd, n_ff, GGMLType.Q6_K)
        if not v7:  # RWKV-6's receptance gate
            emit_f(b + "channel_mix_lerp_r.weight", rand(n_embd, scale=0.3))
            mat(b + "channel_mix_receptance.weight", n_embd, n_embd)
    w.write(path)
    return path


_TINY_RWKV = dict(vocab_size=256, n_layers=2, n_embd=64, head_size=16, n_ff=128,
                  lora=(8, 8, 8, 8), vocab="tiny", f32=True)


def make_tiny_rwkv6_gguf(path: str, seed: int = 0, **kw) -> str:
    """The port's copy of the JAX package's tiny RWKV-6 writer: 2 layers,
    n_embd 64, heads of 16, channel mix 128, vocab 256, F32 (the layout of
    make_bench_rwkv_gguf; its own random values)."""
    return make_bench_rwkv_gguf(path, "rwkv6", **{**_TINY_RWKV, **kw}, seed=seed)


def make_tiny_rwkv7_gguf(path: str, seed: int = 0, gated: bool = True, **kw) -> str:
    """The tiny RWKV-7 writer's copy (make_tiny_rwkv6_gguf's widths)."""
    return make_bench_rwkv_gguf(path, "rwkv7", **{**_TINY_RWKV, **kw}, gated=gated, seed=seed)


def make_tiny_rwkv_hybrid_gguf(path: str, arch: str = "rwkv6qwen2", seed: int = 0,
                               n_kv_heads: int = 2, **kw) -> str:
    """The tiny qrwkv hybrid writer's copy: rwkv6qwen2 (key/value on 2 of the
    4 heads, with biases) or arwkv7, each with a SiLU-GLU FFN of 128."""
    return make_bench_rwkv_gguf(path, arch, **{**_TINY_RWKV, **kw},
                                n_kv_heads=n_kv_heads if arch == "rwkv6qwen2" else 0,
                                seed=seed)


def make_bench_deepseek_v3_gguf(path: str, n_layers: int = 61, n_dense: int = 3,
                                seed: int = 0, **kw) -> str:
    """DeepSeek-V3-shaped (deepseek-ai/DeepSeek-V3 config.json) deepseek2
    GGUF: n_embd 7168, 128 heads, q-LoRA 1536, kv_lora 512, qk_nope 128,
    qk_rope 64, v 128, three leading dense layers of 18432, 256 routed
    experts of 2048 (top 8, sigmoid with the selection bias, weights
    normalised and scaled by 2.5) and one shared, vocab 129280, YaRN factor
    40 (mscale_all_dim 1.0); make_bench_deepseek2_gguf's storage types."""
    return make_bench_deepseek2_gguf(
        path, n_layers=n_layers, n_embd=7168, n_heads=128, q_lora_rank=1536, n_ff=18432,
        n_dense=n_dense, n_expert=256, n_expert_used=8, n_ff_exp=2048, n_expert_shared=1,
        gating="sigmoid", weights_norm=True, weights_scale=2.5, vocab_size=129280,
        mscale_all_dim=1.0, seed=seed, **kw)


# ---------------------------------------------------------------------------
# adapter files (the JAX package's tests/test_adapters.py writers)
# ---------------------------------------------------------------------------

def write_lora_gguf(path: str, pairs: dict, alpha: float = 16.0) -> str:
    """A LoRA adapter GGUF: pairs {GGUF base name: (A [r, in], B [out, r])},
    F32 tensors "<base>.lora_a" and "<base>.lora_b"."""
    w = GGUFWriter()
    w.add("general.type", "adapter")
    w.add("adapter.type", "lora")
    w.add("adapter.lora.alpha", float(alpha))
    for base, (a, b) in pairs.items():
        w.add_tensor(base + ".lora_a", a.astype(np.float32).tobytes(),
                     tuple(reversed(a.shape)), GGMLType.F32)
        w.add_tensor(base + ".lora_b", b.astype(np.float32).tobytes(),
                     tuple(reversed(b.shape)), GGMLType.F32)
    w.write(path)
    return path


def make_lora_gguf(path: str, n_layers: int, shapes: dict, rank: int = 16,
                   alpha: float = 16.0, scale: float = 0.05, seed: int = 0) -> str:
    """A seeded LoRA adapter on every layer: shapes {projection: (out, in)}
    (e.g. attn_q, ffn_up), A and B standard normal times `scale`, drawn
    layer by layer in the order of `shapes`."""
    rng = np.random.default_rng(seed)
    pairs = {}
    for il in range(n_layers):
        for name, (out_d, in_d) in shapes.items():
            a = rng.standard_normal((rank, in_d)).astype(np.float32) * scale
            b = rng.standard_normal((out_d, rank)).astype(np.float32) * scale
            pairs[f"blk.{il}.{name}.weight"] = (a, b)
    return write_lora_gguf(path, pairs, alpha)


def make_control_vector_gguf(path: str, n_layers: int, n_embd: int, scale: float = 0.5,
                             seed: int = 3) -> str:
    """A seeded control vector: F32 "direction.<il>" [n_embd] for il = 1 ..
    n_layers (the reference numbers them from 1), standard normal times
    `scale`."""
    w = GGUFWriter()
    w.add("general.type", "adapter")
    w.add("adapter.type", "control_vector")
    rng = np.random.default_rng(seed)
    for il in range(1, n_layers + 1):
        d = rng.standard_normal(n_embd).astype(np.float32) * scale
        w.add_tensor(f"direction.{il}", d.tobytes(), (n_embd,), GGMLType.F32)
    w.write(path)
    return path


class RouteHold:
    """Holds a reference path's top-k expert choices to a path under test's
    where the two part at a near-tie, as teacher forcing holds the ids:
    enter record() while the path under test runs a step, then hold() while
    the reference runs the same step (models/transformer.py route_hook).

    At each router call and row where the two choices part, the reference
    takes the other path's experts if its router input is within nmse_limit
    of the other path's. Each path's choice is the top k of its own scores,
    so a parting's gap (the reference's k-th largest score less its score of
    an expert only the other path chose) is at most twice the largest score
    difference, and the input bound is what keeps that difference small: a
    fault upstream that moves the router input past the limit is not held,
    nor can the step's own error widen the rule. A row not held keeps the
    reference's choice, and the step's logits show it. held and parted list
    the rows: (router call, row, experts only the path under test chose,
    largest gap, largest score difference, input NMSE)."""

    def __init__(self, nmse_limit: float):
        self.nmse_limit = nmse_limit
        self.calls, self.held, self.parted = [], [], []

    @staticmethod
    @contextlib.contextmanager
    def _hooked(hook):
        from .models import transformer

        transformer.route_hook = hook
        try:
            yield
        finally:
            transformer.route_hook = None

    @staticmethod
    def _rows(x, sel, topi):
        return (x.float().reshape(-1, x.shape[-1]).cpu(), sel.float().reshape(
            -1, sel.shape[-1]).cpu(), topi.reshape(-1, topi.shape[-1]).cpu())

    def record(self):
        self.calls, self.held, self.parted = [], [], []

        def hook(x, sel, topi):
            self.calls.append(self._rows(x, sel, topi))
            return topi

        return self._hooked(hook)

    def hold(self):
        calls = iter(range(len(self.calls)))

        def hook(x, sel, topi):
            j = next(calls, None)
            if j is None:
                raise RuntimeError("RouteHold: the reference routed more often than the path "
                                   "under test")
            xk, sk, ik = self.calls[j]
            xr, sr, ir = self._rows(x, sel, topi)
            if ik.shape != ir.shape:
                raise RuntimeError(f"RouteHold: router call {j} chose {tuple(ir.shape)} "
                                   f"against {tuple(ik.shape)}")
            out = ir.clone()
            for r in range(ir.shape[0]):
                only = sorted(set(ik[r].tolist()) - set(ir[r].tolist()))
                if not only:
                    continue
                diff = float((sk[r] - sr[r]).abs().max())
                kth = float(torch.sort(sr[r]).values[-ir.shape[1]])
                gap = max(kth - float(sr[r, e]) for e in only)
                err = float(((xk[r] - xr[r]) ** 2).mean() / ((xr[r] ** 2).mean() + 1e-30))
                row = (j, r, only, gap, diff, err)
                if err < self.nmse_limit:
                    out[r] = ik[r]
                    self.held.append(row)
                else:
                    self.parted.append(row)
            return out.reshape(topi.shape).to(topi.device)

        return self._hooked(hook)


# -- the encoders and embedding models ------------------------------------
# Each BERT-family entry's tensors as llama.cpp's converter lays them out:
# n_types token-type rows, a learned position table of n_positions rows, the
# embedding LayerNorm ("ln": with its bias, "w": weight only), q/k/v apart or
# fused (with biases where the family has them), jina-v2's full-width q/k
# LayerNorms and attn_norm_2, the FFN ("plain": an activation of up;
# "gated": gate and up apart; "fused": one ffn_up of 2 * n_ff holding
# gate|up), the pre-norm blocks (attn_norm from layer 1 on where the
# family's layer 0 has none) and the final norm.
_BERT_POST = dict(n_types=2, embd_norm="ln", post_norm=True)
ENCODER_LAYOUTS: dict[str, dict] = {
    # BAAI/bge-m3 (XLM-RoBERTa): one token type, 8194 positions, biases throughout
    "bert": dict(_BERT_POST, n_types=1, n_positions=8194, qkv_bias=True, out_bias=True,
                 ffn="plain", ffn_bias=True),
    "modern-bert": dict(embd_norm="w", fused_qkv=True, ffn="fused", pre_norm=True,
                        first_attn_norm=1, final="output_norm",
                        metadata={"attention.sliding_window": np.uint32(128),
                                  "attention.sliding_window_pattern": np.uint32(3),
                                  "rope.freq_base_swa": 10000.0}, rope_base=160000.0),
    "nomic-bert": dict(_BERT_POST, fused_qkv=True, ffn="gated"),
    "nomic-bert-moe": dict(_BERT_POST, fused_qkv=True, qkv_bias=True, out_bias=True,
                           ffn="plain", ffn_bias=True, n_expert=8, n_expert_used=2,
                           moe_every=2),
    "neo-bert": dict(fused_qkv=True, ffn="fused", pre_norm=True, final="enc.output_norm"),
    "eurobert": dict(ffn="gated", pre_norm=True, final="output_norm"),
    "jina-bert-v2": dict(_BERT_POST, qkv_bias=True, out_bias=True, qk_norm_full=True,
                         attn_norm_2=True, ffn="fused", down_bias=True),
    "jina-bert-v3": dict(_BERT_POST, fused_qkv=True, qkv_bias=True, out_bias=True,
                         ffn="plain", ffn_bias=True),
}


def make_bench_encoder_gguf(path: str, arch: str, n_layers: int, n_embd: int, n_heads: int,
                            n_ff: int, vocab_size: int, n_ctx: int = 512,
                            norm_eps: float = 1e-5, rope_base: float = 10000.0,
                            f32: bool = False, synth_scale: float = 1.0, seed: int = 0,
                            n_types: int = 0, n_positions: int = 0, embd_norm: str = "",
                            fused_qkv: bool = False, qkv_bias: bool = False,
                            out_bias: bool = False, qk_norm_full: bool = False,
                            attn_norm_2: bool = False, post_norm: bool = False,
                            pre_norm: bool = False, first_attn_norm: int = 0, ffn: str = "plain",
                            ffn_bias: bool = False, down_bias: bool = False,
                            n_expert: int = 0, n_expert_used: int = 0, moe_every: int = 0,
                            final: str = "", metadata: dict | None = None) -> str:
    """A GGUF of one of the BERT-family encoders (`arch`, the options of
    ENCODER_LAYOUTS[arch]) with synthetic packed weights in the Q4_K_M mix
    (Q4_K matrices and token_embd, Q6_K attn_v, ffn_down and the expert down
    stacks; norms, biases, token types, positions and the router F32), or
    with f32 every matrix as F32 values (scale 1/sqrt(in)). nomic-bert-moe's
    every moe_every-th layer (il % moe_every == moe_every - 1) carries
    n_expert gate-less experts of n_ff instead of its dense FFN."""
    rng = np.random.default_rng(seed)
    head_dim = n_embd // n_heads
    w = GGUFWriter()
    w.add(Keys.General.ARCHITECTURE, arch)
    w.add(Keys.General.NAME, f"bench-{arch}-synthetic")
    P = arch + "."
    for key, val in (("block_count", n_layers), ("context_length", n_ctx),
                     ("embedding_length", n_embd), ("feed_forward_length", n_ff),
                     ("attention.head_count", n_heads), ("attention.head_count_kv", n_heads),
                     ("rope.dimension_count", head_dim), ("vocab_size", vocab_size)):
        w.add(P + key, np.uint32(val))
    w.add(P + "attention.layer_norm_epsilon", float(norm_eps))
    w.add(P + "attention.layer_norm_rms_epsilon", float(norm_eps))
    w.add(P + "attention.causal", False)
    w.add(P + "rope.freq_base", float(rope_base))
    if n_expert:
        w.add(P + "expert_count", np.uint32(n_expert))
        w.add(P + "expert_used_count", np.uint32(n_expert_used))
        w.add(P + "moe_every_n_layers", np.uint32(moe_every))
    for key, val in (metadata or {}).items():
        w.add(P + key, val)
    _add_bench_vocab(w, vocab_size)

    q4, q6 = GGMLType.Q4_K, GGMLType.Q6_K

    def emit_f(name, arr):
        arr = np.ascontiguousarray(arr, dtype=np.float32)
        w.add_tensor(name, arr.tobytes(), tuple(reversed(arr.shape)), GGMLType.F32)

    def emit_q(name, rows, cols, t, stack=()):
        shape = (*reversed(stack), rows, cols)
        if f32:
            emit_f(name, rng.standard_normal(shape) / np.sqrt(cols))
            return
        n = rows * cols * int(np.prod(stack, dtype=np.int64))
        data = synth_quant_bytes(rng, n, t, offset=int(rng.integers(1, 1 << 24)),
                                 scale_mult=synth_scale)
        w.add_tensor(name, data, (cols, rows, *stack), t)

    def norm(name, n, bias=True):
        emit_f(name + ".weight", 1.0 + 0.1 * rng.standard_normal(n))
        if bias:
            emit_f(name + ".bias", 0.1 * rng.standard_normal(n))

    def bias(name, n):
        emit_f(name, 0.1 * rng.standard_normal(n))

    E, F, D = n_embd, n_ff, n_heads * head_dim
    emit_q("token_embd.weight", vocab_size, E, q4)
    if n_types:
        emit_f("token_types.weight", 0.1 * rng.standard_normal((n_types, E)))
    if n_positions:
        emit_f("position_embd.weight", 0.1 * rng.standard_normal((n_positions, E)))
    if embd_norm:
        norm("token_embd_norm", E, bias=embd_norm == "ln")
    if final:
        norm(final, E, bias=False)
    for i in range(n_layers):
        b = f"blk.{i}."
        if pre_norm and i >= first_attn_norm:
            norm(b + "attn_norm", E, bias=False)
        if fused_qkv:
            emit_q(b + "attn_qkv.weight", 3 * D, E, q4)
            if qkv_bias:
                bias(b + "attn_qkv.bias", 3 * D)
        else:
            for name, t in (("attn_q", q4), ("attn_k", q4), ("attn_v", q6)):
                emit_q(b + name + ".weight", D, E, t)
                if qkv_bias:
                    bias(b + name + ".bias", D)
        if qk_norm_full:
            norm(b + "attn_q_norm", D)
            norm(b + "attn_k_norm", D)
        emit_q(b + "attn_output.weight", E, D, q4)
        if out_bias:
            bias(b + "attn_output.bias", E)
        if post_norm:
            norm(b + "attn_output_norm", E)
        if attn_norm_2:
            norm(b + "attn_norm_2", E)
        if pre_norm:
            norm(b + "ffn_norm", E, bias=False)
        if moe_every and i % moe_every == moe_every - 1:
            emit_f(b + "ffn_gate_inp.weight", rng.standard_normal((n_expert, E)) * 0.02)
            emit_q(b + "ffn_up_exps.weight", F, E, q4, (n_expert,))
            emit_q(b + "ffn_down_exps.weight", E, F, q6, (n_expert,))
        else:
            if ffn == "gated":
                emit_q(b + "ffn_gate.weight", F, E, q4)
            emit_q(b + "ffn_up.weight", F * (2 if ffn == "fused" else 1), E, q4)
            if ffn_bias:
                bias(b + "ffn_up.bias", F)
            emit_q(b + "ffn_down.weight", E, F, q6)
            if ffn_bias or down_bias:
                bias(b + "ffn_down.bias", E)
        if post_norm:
            norm(b + "layer_output_norm", E)
    w.write(path)
    return path


def make_bench_bge_m3_gguf(path: str, n_layers: int = 24, n_embd: int = 1024,
                           n_heads: int = 16, n_ff: int = 4096, vocab_size: int = 250002,
                           synth_scale: float = 1.0, f32: bool = False, seed: int = 0) -> str:
    """BGE-M3-shaped (by default; BAAI/bge-m3 config.json, XLM-RoBERTa-large in
    GGUF as bert) encoder: 24 post-norm LayerNorm layers of 1024, 16 heads of
    64, a GELU FFN of 4096 with biases throughout, 8194 learned positions, one
    token type, LayerNorm eps 1e-5, vocab 250002; the Q4_K_M mix."""
    return make_bench_encoder_gguf(path, "bert", n_layers, n_embd, n_heads, n_ff, vocab_size,
                                   n_ctx=8192, f32=f32, synth_scale=synth_scale, seed=seed,
                                   **ENCODER_LAYOUTS["bert"])


def make_bench_t5encoder_gguf(path: str, n_layers: int, n_embd: int, n_heads: int, n_ff: int,
                              vocab_size: int, n_buckets: int = 32, f32: bool = False,
                              synth_scale: float = 1.0, seed: int = 0, n_dec_layers: int = 0,
                              tie: bool = False) -> str:
    """A t5encoder GGUF (flan-T5's encoder: enc.blk.N.* with RMSNorm blocks, a
    relative-position bias table attn_rel_b [n_buckets, n_heads] on layer 0,
    the gated GELU FFN, enc.output_norm; rms eps 1e-6) with synthetic
    weights in the Q4_K_M mix, or F32 values with f32. With n_dec_layers > 0
    a t5 (encoder-decoder) GGUF: the decoder's dec.blk.N.* after the
    encoder's, each with its self-attention (attn_rel_b on layer 0), its
    cross-attention cross_attn_{norm,q,k,v,o} (Q4_K, attn_v and cross_attn_v
    Q6_K) and the FFN, dec.output_norm, and a Q6_K output head unless tie;
    decoder_block_count and decoder_start_token_id 0 in the metadata."""
    rng = np.random.default_rng(seed)
    head_dim = n_embd // n_heads
    arch = "t5" if n_dec_layers else "t5encoder"
    w = GGUFWriter()
    w.add(Keys.General.ARCHITECTURE, arch)
    w.add(Keys.General.NAME, f"bench-{arch}-synthetic")
    P = arch + "."
    for key, val in (("block_count", n_layers), ("context_length", 512),
                     ("embedding_length", n_embd), ("feed_forward_length", n_ff),
                     ("attention.head_count", n_heads), ("attention.head_count_kv", n_heads),
                     ("attention.key_length", head_dim), ("attention.value_length", head_dim),
                     ("attention.relative_buckets_count", n_buckets),
                     ("vocab_size", vocab_size)):
        w.add(P + key, np.uint32(val))
    if n_dec_layers:
        w.add(P + "decoder_block_count", np.uint32(n_dec_layers))
        w.add(P + "decoder_start_token_id", np.uint32(0))
    w.add(P + "attention.layer_norm_rms_epsilon", 1e-6)
    _add_bench_vocab(w, vocab_size)
    q4, q6 = GGMLType.Q4_K, GGMLType.Q6_K

    def emit_f(name, arr):
        arr = np.ascontiguousarray(arr, dtype=np.float32)
        w.add_tensor(name, arr.tobytes(), tuple(reversed(arr.shape)), GGMLType.F32)

    def emit_q(name, rows, cols, t):
        if f32:
            emit_f(name, rng.standard_normal((rows, cols)) / np.sqrt(cols))
            return
        data = synth_quant_bytes(rng, rows * cols, t, offset=int(rng.integers(1, 1 << 24)),
                                 scale_mult=synth_scale)
        w.add_tensor(name, data, (cols, rows), t)

    E, F, D = n_embd, n_ff, n_heads * head_dim
    emit_q("token_embd.weight", vocab_size, E, q4)
    emit_f("enc.output_norm.weight", 1.0 + 0.1 * rng.standard_normal(E))

    def block(b, i, cross):
        emit_f(b + "attn_norm.weight", 1.0 + 0.1 * rng.standard_normal(E))
        for name, t in (("attn_q", q4), ("attn_k", q4), ("attn_v", q6)):
            emit_q(b + name + ".weight", D, E, t)
        emit_q(b + "attn_o.weight", E, D, q4)
        if i == 0:
            emit_f(b + "attn_rel_b.weight", 0.5 * rng.standard_normal((n_buckets, n_heads)))
        if cross:
            emit_f(b + "cross_attn_norm.weight", 1.0 + 0.1 * rng.standard_normal(E))
            for name, t in (("cross_attn_q", q4), ("cross_attn_k", q4), ("cross_attn_v", q6)):
                emit_q(b + name + ".weight", D, E, t)
            emit_q(b + "cross_attn_o.weight", E, D, q4)
        emit_f(b + "ffn_norm.weight", 1.0 + 0.1 * rng.standard_normal(E))
        emit_q(b + "ffn_gate.weight", F, E, q4)
        emit_q(b + "ffn_up.weight", F, E, q4)
        emit_q(b + "ffn_down.weight", E, F, q6)

    for i in range(n_layers):
        block(f"enc.blk.{i}.", i, False)
    if n_dec_layers:
        emit_f("dec.output_norm.weight", 1.0 + 0.1 * rng.standard_normal(E))
        if not tie:
            emit_q("output.weight", vocab_size, E, q6)
        for i in range(n_dec_layers):
            block(f"dec.blk.{i}.", i, True)
    w.write(path)
    return path


def make_bench_t5_gguf(path: str, n_layers: int = 24, n_dec_layers: int = 24,
                       n_embd: int = 1024, n_heads: int = 16, n_ff: int = 2816,
                       vocab_size: int = 32128, **kw) -> str:
    """A T5 encoder-decoder GGUF (make_bench_t5encoder_gguf with a decoder),
    flan-t5-large's widths by default (google/flan-t5-large config.json:
    d_model 1024, 16 heads of 64, a gated-GELU FFN of 2816, 24 encoder and
    24 decoder layers, 32 relative-position buckets, vocab 32128, an untied
    head)."""
    return make_bench_t5encoder_gguf(path, n_layers, n_embd, n_heads, n_ff, vocab_size,
                                     n_dec_layers=n_dec_layers, **kw)


# the embedding entries on the shared decoder: EmbeddingGemma (gemma3's
# blocks, bidirectional, symmetric windows of 128 on one layer of two) and
# llama-embed
EMBEDDING_DECODERS: dict[str, dict] = {
    "gemma-embedding": dict(qk_norm=True, post_norms=True, tie=True, sliding_window=128,
                            swa_pattern=2, rope_base=1e6, rope_base_swa=1e4),
    "llama-embed": dict(),
}
EMBEDDING_ARCHS = (*ENCODER_LAYOUTS, "t5encoder", *EMBEDDING_DECODERS)


def make_bench_embedding_gguf(path: str, arch: str, n_layers: int, n_embd: int, n_heads: int,
                              n_ff: int, vocab_size: int, f32: bool = False,
                              synth_scale: float = 1.0, seed: int = 0, **options) -> str:
    """A GGUF of any entry of EMBEDDING_ARCHS in its layout (options override
    it): the BERT family's through make_bench_encoder_gguf, t5encoder's
    through make_bench_t5encoder_gguf, the embedding decoders' through
    make_bench_arch_gguf (half as many KV heads as heads)."""
    kw = dict(f32=f32, synth_scale=synth_scale, seed=seed)
    if arch in ENCODER_LAYOUTS:
        return make_bench_encoder_gguf(path, arch, n_layers, n_embd, n_heads, n_ff, vocab_size,
                                       **kw, **{**ENCODER_LAYOUTS[arch], **options})
    if arch == "t5encoder":
        return make_bench_t5encoder_gguf(path, n_layers, n_embd, n_heads, n_ff, vocab_size,
                                         **kw, **options)
    return make_bench_arch_gguf(path, arch, n_layers, n_embd, n_heads, n_heads // 2,
                                n_embd // n_heads, n_ff, vocab_size, **kw,
                                **{**EMBEDDING_DECODERS[arch], **options})
