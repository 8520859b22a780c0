"""GGUF file-format and ggml-dtype constants (the subset the llama main path
reads: F32/F16/BF16 dense tensors and the Q4_K/Q6_K K-quants).

Format parity (the numbers are the on-disk format): reference
ggml/include/gguf.h:1-30, the dtype enum ggml/include/ggml.h:390-433 and the
block sizes ggml/src/ggml-common.h:178-460.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

GGUF_MAGIC = b"GGUF"
GGUF_VERSION = 3
GGUF_DEFAULT_ALIGNMENT = 32
GGUF_KEY_GENERAL_ALIGNMENT = "general.alignment"

QK_K = 256  # super-block size for K-quants
K_SCALE_SIZE = 12


class GGUFValueType(enum.IntEnum):
    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


class GGMLType(enum.IntEnum):
    """Tensor storage dtypes; values match reference ggml/include/ggml.h."""

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    IQ2_XXS = 16
    IQ2_XS = 17
    IQ3_XXS = 18
    IQ1_S = 19
    IQ4_NL = 20
    IQ3_S = 21
    IQ2_S = 22
    IQ4_XS = 23
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    IQ1_M = 29
    BF16 = 30
    TQ1_0 = 34
    TQ2_0 = 35
    MXFP4 = 39
    NVFP4 = 40
    Q1_0 = 41
    Q2_0 = 42


@dataclass(frozen=True)
class BlockLayout:
    """Size in elements and bytes of one quantization block."""

    block_size: int  # elements per block
    type_size: int  # bytes per block


# the storage types this package reads; others raise at load
GGML_BLOCK_LAYOUT: dict[GGMLType, BlockLayout] = {
    GGMLType.F32: BlockLayout(1, 4),
    GGMLType.F16: BlockLayout(1, 2),
    GGMLType.BF16: BlockLayout(1, 2),
    GGMLType.Q4_K: BlockLayout(QK_K, 2 + 2 + K_SCALE_SIZE + QK_K // 2),
    GGMLType.Q6_K: BlockLayout(QK_K, QK_K // 2 + QK_K // 4 + QK_K // 16 + 2),
}


def type_size_bytes(dtype: GGMLType, n_elements: int) -> int:
    """Byte size of a contiguous row-major tensor of `n_elements` of `dtype`."""
    if dtype not in GGML_BLOCK_LAYOUT:
        raise NotImplementedError(f"GGML type {GGMLType(dtype).name} is not supported")
    layout = GGML_BLOCK_LAYOUT[dtype]
    if n_elements % layout.block_size != 0:
        raise ValueError(
            f"{dtype.name}: {n_elements} elements not divisible by block size "
            f"{layout.block_size}")
    return n_elements // layout.block_size * layout.type_size


class Keys:
    class General:
        ARCHITECTURE = "general.architecture"
        NAME = "general.name"
        ALIGNMENT = "general.alignment"
        FILE_TYPE = "general.file_type"

    class LLM:  # formatted with arch name
        CONTEXT_LENGTH = "{arch}.context_length"
        EMBEDDING_LENGTH = "{arch}.embedding_length"
        BLOCK_COUNT = "{arch}.block_count"
        FEED_FORWARD_LENGTH = "{arch}.feed_forward_length"
        EXPERT_COUNT = "{arch}.expert_count"
        EXPERT_USED_COUNT = "{arch}.expert_used_count"
        EXPERT_FFN_LENGTH = "{arch}.expert_feed_forward_length"
        EXPERT_SHARED_COUNT = "{arch}.expert_shared_count"
        ROPE_DIMENSION_COUNT = "{arch}.rope.dimension_count"
        ROPE_FREQ_BASE = "{arch}.rope.freq_base"
        ROPE_SCALING_TYPE = "{arch}.rope.scaling.type"
        ROPE_SCALING_FACTOR = "{arch}.rope.scaling.factor"
        ROPE_SCALING_ORIG_CTX = "{arch}.rope.scaling.original_context_length"
        ROPE_SCALING_ATTN_FACTOR = "{arch}.rope.scaling.attn_factor"
        ROPE_SCALING_BETA_FAST = "{arch}.rope.scaling.beta_fast"
        ROPE_SCALING_BETA_SLOW = "{arch}.rope.scaling.beta_slow"
        ATTN_HEAD_COUNT = "{arch}.attention.head_count"
        ATTN_HEAD_COUNT_KV = "{arch}.attention.head_count_kv"
        ATTN_LAYERNORM_RMS_EPS = "{arch}.attention.layer_norm_rms_epsilon"
        ATTN_LAYERNORM_EPS = "{arch}.attention.layer_norm_epsilon"
        ATTN_KEY_LENGTH = "{arch}.attention.key_length"
        ATTN_VALUE_LENGTH = "{arch}.attention.value_length"
        ATTN_SLIDING_WINDOW = "{arch}.attention.sliding_window"
        VOCAB_SIZE = "{arch}.vocab_size"
        LOGIT_SCALE = "{arch}.logit_scale"
        ATTN_LOGIT_SOFTCAP = "{arch}.attn_logit_softcapping"
        FINAL_LOGIT_SOFTCAP = "{arch}.final_logit_softcapping"

    class Tokenizer:
        MODEL = "tokenizer.ggml.model"
        PRE = "tokenizer.ggml.pre"
        TOKENS = "tokenizer.ggml.tokens"
        SCORES = "tokenizer.ggml.scores"
        TOKEN_TYPE = "tokenizer.ggml.token_type"
        MERGES = "tokenizer.ggml.merges"
        BOS_ID = "tokenizer.ggml.bos_token_id"
        EOS_ID = "tokenizer.ggml.eos_token_id"
        EOT_ID = "tokenizer.ggml.eot_token_id"
        EOM_ID = "tokenizer.ggml.eom_token_id"
        UNK_ID = "tokenizer.ggml.unknown_token_id"
        SEP_ID = "tokenizer.ggml.seperator_token_id"
        PAD_ID = "tokenizer.ggml.padding_token_id"
        MASK_ID = "tokenizer.ggml.mask_token_id"
        ADD_BOS = "tokenizer.ggml.add_bos_token"
        ADD_EOS = "tokenizer.ggml.add_eos_token"
        ADD_SEP = "tokenizer.ggml.add_sep_token"
        ADD_SPACE_PREFIX = "tokenizer.ggml.add_space_prefix"
        REMOVE_EXTRA_WS = "tokenizer.ggml.remove_extra_whitespaces"
        CHAT_TEMPLATE = "tokenizer.chat_template"


class TokenType(enum.IntEnum):
    """Matches llama_token_type / gguf token_type values."""

    UNDEFINED = 0
    NORMAL = 1
    UNKNOWN = 2
    CONTROL = 3
    USER_DEFINED = 4
    UNUSED = 5
    BYTE = 6
