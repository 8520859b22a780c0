"""Model loader for the registry's families, decoders and encoders: GGUF
file -> (ModelConfig, weights on the device), and the family's graph
(Model.forward_fn). T5's encoder blocks (enc.blk.N.*) land in
params["enc_layers"], its decoder blocks (dec.blk.N.*) in params["layers"];
nanbeige's physical stack is listed once a loop, by reference.

Analog of reference llama_model_loader + llama_model::load_tensors
(src/llama-model-loader.cpp; src/models/llama.cpp:35-94). Weights are read
from the memory-mapped GGUF blob and repacked to planes: on the card the
usual types go up as raw blocks and are cut there (quant/device_planes.py),
elsewhere on the host (quant/repack.py) and copied once per plane. After load,
same-type projections are fused (q+k, gate+up) and the vocab head is padded.
"""

from __future__ import annotations

import logging
from dataclasses import replace
from typing import Any

import numpy as np
import torch

from ..gguf.reader import GGUFFile, read_gguf
from ..ops.qtensor import QuantTensor, Weight, load_weight, pad_out_features
from ..tokenizer import Tokenizer
from .config import ModelConfig
from .registry import apply_arch

log = logging.getLogger(__name__)

# layer-tensor suffix -> weight-dict key (the subset of the JAX package's
# names that the registry's families carry)
LAYER_TENSORS = {
    "attn_norm.weight": "attn_norm",
    "attn_norm.bias": "attn_norm_bias",
    "attn_q.weight": "attn_q",
    "attn_k.weight": "attn_k",
    "attn_v.weight": "attn_v",
    "attn_qkv.weight": "attn_qkv",  # fused in the file (gpt2, falcon, phi3, ...)
    "attn_qkv.bias": "attn_qkv_bias",
    "attn_output.weight": "attn_output",
    "attn_q.bias": "attn_q_bias",
    "attn_k.bias": "attn_k_bias",
    "attn_v.bias": "attn_v_bias",
    "attn_output.bias": "attn_output_bias",
    "attn_q_norm.weight": "attn_q_norm",
    "attn_k_norm.weight": "attn_k_norm",
    "attn_post_norm.weight": "attn_post_norm",
    "post_attention_norm.weight": "attn_post_norm",
    "attn_out_norm.weight": "attn_post_norm",  # grok's attention output norm
    "attn_sinks.weight": "attn_sinks",
    # per-tensor scalar scales (folded into the weight at load)
    "attn_q.scale": "attn_q.__scale",
    "attn_k.scale": "attn_k.__scale",
    "attn_v.scale": "attn_v.__scale",
    "attn_output.scale": "attn_output.__scale",
    "ffn_gate.scale": "ffn_gate.__scale",
    "ffn_up.scale": "ffn_up.__scale",
    "ffn_down.scale": "ffn_down.__scale",
    "ffn_norm.weight": "ffn_norm",
    "ffn_norm.bias": "ffn_norm_bias",
    "ffn_gate.weight": "ffn_gate",
    "ffn_up.weight": "ffn_up",
    "ffn_down.weight": "ffn_down",
    "ffn_gate.bias": "ffn_gate_bias",
    "ffn_up.bias": "ffn_up_bias",
    "ffn_down.bias": "ffn_down_bias",
    "ffn_post_norm.weight": "ffn_post_norm",
    "post_ffw_norm.weight": "ffn_post_norm",
    # mixture of experts: router, stacked experts, shared experts, arctic's
    # MoE-branch norm, GroveMoE's chunk experts
    "ffn_gate_inp.weight": "ffn_gate_inp",
    "ffn_gate_inp.bias": "ffn_gate_inp_bias",
    "exp_probs_b.bias": "exp_probs_b",
    "exp_probs_b": "exp_probs_b",
    "ffn_norm_exps.weight": "ffn_norm_exps",
    "ffn_gate_chexps.weight": "ffn_gate_chexps",
    "ffn_up_chexps.weight": "ffn_up_chexps",
    "ffn_down_chexps.weight": "ffn_down_chexps",
    "ffn_gate_exps.weight": "ffn_gate_exps",
    "ffn_up_exps.weight": "ffn_up_exps",
    "ffn_down_exps.weight": "ffn_down_exps",
    "ffn_gate_exps.bias": "ffn_gate_exps_bias",
    "ffn_up_exps.bias": "ffn_up_exps_bias",
    "ffn_down_exps.bias": "ffn_down_exps_bias",
    "ffn_gate_shexp.weight": "ffn_gate_shexp",
    "ffn_up_shexp.weight": "ffn_up_shexp",
    "ffn_down_shexp.weight": "ffn_down_shexp",
    "ffn_gate_inp_shexp.weight": "ffn_gate_inp_shexp",
    # DeepSeek-2 Multi-head Latent Attention (reference src/models/deepseek2.cpp
    # load_arch_tensors); attn_k_b / attn_v_b are the decompression shipped
    # split, as current llama.cpp DeepSeek files ship it
    "attn_q_a.weight": "attn_q_a",
    "attn_q_a_norm.weight": "attn_q_a_norm",
    "attn_q_b.weight": "attn_q_b",
    "attn_kv_a_mqa.weight": "attn_kv_a_mqa",
    "attn_kv_a_norm.weight": "attn_kv_a_norm",
    "attn_kv_b.weight": "attn_kv_b",
    "attn_k_b.weight": "attn_k_b",
    "attn_v_b.weight": "attn_v_b",
    # the recurrent mixers (reference src/llama-arch.cpp LLM_TENSOR_SSM_*,
    # LLM_TENSOR_SHORTCONV_*): Mamba-1/2, the gated DeltaNet's beta/alpha
    # (fused ssm_ba: qwen3next; separate: qwen35), LFM2's short conv, and
    # the gated attention's output gate
    "ssm_in.weight": "ssm_in",
    "ssm_conv1d.weight": "ssm_conv1d",
    "ssm_conv1d.bias": "ssm_conv1d_bias",
    "ssm_x.weight": "ssm_x",
    "ssm_dt.weight": "ssm_dt",
    "ssm_dt.bias": "ssm_dt_bias",
    "ssm_a": "ssm_a",
    "ssm_d": "ssm_d",
    "ssm_out.weight": "ssm_out",
    "ssm_dt_norm.weight": "ssm_dt_norm",
    "ssm_b_norm.weight": "ssm_b_norm",
    "ssm_c_norm.weight": "ssm_c_norm",
    "ssm_norm.weight": "ssm_norm",
    "ssm_ba.weight": "ssm_ba",
    "ssm_beta.weight": "ssm_beta",
    "ssm_alpha.weight": "ssm_alpha",
    "ssm_conv1d_q.weight": "ssm_conv1d_q",  # KDA (kimi-linear): a conv each of q, k, v
    "ssm_conv1d_k.weight": "ssm_conv1d_k",
    "ssm_conv1d_v.weight": "ssm_conv1d_v",
    "ssm_f_a.weight": "ssm_f_a",
    "ssm_f_b.weight": "ssm_f_b",
    "ssm_g_a.weight": "ssm_g_a",
    "ssm_g_b.weight": "ssm_g_b",
    "shortconv.conv.weight": "shortconv_conv",
    "shortconv.in_proj.weight": "shortconv_in",
    "shortconv.out_proj.weight": "shortconv_out",
    "attn_gate.weight": "attn_gate",
    # the BERT family's post-norms (reference src/llama-arch.cpp:422-431),
    # jina-v2's second LayerNorm and its full-width q/k LayerNorms' biases
    "attn_output_norm.weight": "attn_output_norm",
    "attn_output_norm.bias": "attn_output_norm_bias",
    "layer_output_norm.weight": "layer_output_norm",
    "layer_output_norm.bias": "layer_output_norm_bias",
    "attn_norm_2.weight": "attn_norm_2",
    "attn_norm_2.bias": "attn_norm_2_bias",
    "attn_q_norm.bias": "attn_q_norm_bias",
    "attn_k_norm.bias": "attn_k_norm_bias",
    # bitnet's sub-norms before attn_output and ffn_down; talkie's per-layer
    # scale of its embedding skip
    "attn_sub_norm.weight": "attn_sub_norm",
    "ffn_sub_norm.weight": "ffn_sub_norm",
    "layer_output_scale.weight": "layer_out_scale",
    # RWKV-6 and RWKV-7 (reference src/llama-arch.cpp LLM_TENSOR_TIME_MIX_*,
    # LLM_TENSOR_CHANNEL_MIX_*), with the qrwkv hybrids' biases
    **{f"time_mix_{n}.weight": f"time_mix_{n}" for n in (
        "w1", "w2", "lerp_x", "lerp_w", "lerp_k", "lerp_v", "lerp_r", "lerp_g", "lerp_fused",
        "first", "decay", "decay_w1", "decay_w2", "key", "value", "receptance", "gate", "ln",
        "output", "w0", "a0", "a1", "a2", "v0", "v1", "v2", "g1", "g2", "k_k", "k_a", "r_k")},
    "time_mix_key.bias": "time_mix_key_bias",
    "time_mix_value.bias": "time_mix_value_bias",
    "time_mix_receptance.bias": "time_mix_receptance_bias",
    "time_mix_ln.bias": "time_mix_ln_bias",
    **{f"channel_mix_{n}.weight": f"channel_mix_{n}" for n in (
        "lerp_k", "lerp_r", "key", "value", "receptance")},
    # Gemma 3n's AltUp, LAUREL and per-layer inputs (reference
    # llama-arch.cpp:485-497); Gemma 4's dual-branch MoE norms, router
    # scale and fused gate|up experts (llama-arch.cpp:403-423)
    "altup_correct_coef.weight": "altup_correct_coef",
    "altup_correct_scale.weight": "altup_correct_scale",
    "altup_predict_coef.weight": "altup_predict_coef",
    "altup_router.weight": "altup_router",
    "altup_router_norm.weight": "altup_router_norm",
    "laurel_l.weight": "laurel_l",
    "laurel_r.weight": "laurel_r",
    "laurel_post_norm.weight": "laurel_post_norm",
    "inp_gate.weight": "per_layer_inp_gate",
    "proj.weight": "per_layer_proj",
    "post_norm.weight": "per_layer_post_norm",
    "pre_ffw_norm_2.weight": "ffn_pre_norm_2",
    "post_ffw_norm_1.weight": "ffn_post_norm_1",
    "post_ffw_norm_2.weight": "ffn_post_norm_2",
    "ffn_gate_inp.scale": "ffn_gate_inp_s",
    "ffn_gate_up_exps.weight": "ffn_gate_up_exps",
    # MiniMax-M3's block-sparse indexer (llama-arch.cpp:608-610)
    "indexer.q_proj.weight": "indexer_q_proj",
    "indexer.k_proj.weight": "indexer_k_proj",
    "indexer.q_norm.weight": "indexer_q_norm",
    "indexer.k_norm.weight": "indexer_k_norm",
}

# T5's encoder blocks, enc.blk.N.*, and decoder blocks, dec.blk.N.* (reference
# llama-arch.cpp LLM_TENSOR_ENC_* and LLM_TENSOR_DEC_*; the JAX package's
# loader.py:192-208): the decoder's carry the cross-attention's
T5_LAYER_TENSORS = {
    "attn_q.weight": "attn_q",
    "attn_k.weight": "attn_k",
    "attn_v.weight": "attn_v",
    "attn_o.weight": "attn_output",
    "attn_rel_b.weight": "attn_rel_b",
    "attn_norm.weight": "attn_norm",
    "cross_attn_q.weight": "cross_attn_q",
    "cross_attn_k.weight": "cross_attn_k",
    "cross_attn_v.weight": "cross_attn_v",
    "cross_attn_o.weight": "cross_attn_output",
    "cross_attn_norm.weight": "cross_attn_norm",
    "ffn_gate.weight": "ffn_gate",
    "ffn_up.weight": "ffn_up",
    "ffn_down.weight": "ffn_down",
    "ffn_norm.weight": "ffn_norm",
}

GLOBAL_TENSORS = {
    "token_embd.weight": "token_embd",
    "position_embd.weight": "pos_embd",  # learned absolute positions (gpt2, starcoder)
    "token_embd_norm.weight": "token_embd_norm",  # bloom's embedding LayerNorm
    "token_embd_norm.bias": "token_embd_norm_bias",
    "output_norm.weight": "output_norm",
    "output_norm.bias": "output_norm_bias",
    "output.weight": "output",
    "output.bias": "output_bias",
    "rope_freqs.weight": "rope_factors",
    "enc.output_norm.weight": "enc_output_norm",  # neo-bert's, T5 encoder's final norm
    "dec.output_norm.weight": "output_norm",  # T5 decoder's final norm
    "token_types.weight": "token_types",  # the BERT family's token-type rows
    # the rank head (loaded, not read: the server's rerank scores embedding cosine)
    "cls.weight": "cls",
    "cls.bias": "cls_bias",
    "cls.output.weight": "cls_out",
    "cls.output.bias": "cls_out_bias",
    # Gemma 3n/4's per-layer token embeddings and AltUp projections; the
    # Gemma 4 assistant's projections in and out (llama-arch.cpp:503-504)
    "per_layer_token_embd.weight": "per_layer_token_embd",
    "per_layer_model_proj.weight": "per_layer_model_proj",
    "per_layer_proj_norm.weight": "per_layer_proj_norm",
    "altup_proj.weight": "altup_proj",
    "altup_unembd_proj.weight": "altup_unembd_proj",
    "nextn.pre_projection.weight": "nextn_proj_pre",
    "nextn.post_projection.weight": "nextn_proj_post",
}

# 1-D tensors stay dense fp32; everything else follows its storage type
# (the router ffn_gate_inp is not a dense key: an F32 router lands as a dense
# compute-dtype [out, in] weight through the storage-type route)
_DENSE_KEYS = {"attn_norm", "attn_norm_bias", "attn_q_norm", "attn_k_norm", "attn_post_norm",
               "ffn_norm", "ffn_norm_bias", "attn_q_a_norm", "attn_kv_a_norm",
               "ffn_post_norm", "output_norm", "output_norm_bias", "rope_factors",
               "attn_q_bias", "attn_k_bias", "attn_v_bias", "attn_qkv_bias",
               "attn_output_bias", "ffn_gate_bias", "ffn_up_bias", "ffn_down_bias",
               "output_bias", "token_embd_norm", "token_embd_norm_bias",
               "attn_sinks", "ffn_gate_inp_bias", "exp_probs_b",
               "ffn_gate_exps_bias", "ffn_up_exps_bias", "ffn_down_exps_bias",
               "ssm_conv1d", "ssm_conv1d_bias", "ssm_dt_bias", "ssm_a", "ssm_d",
               "ssm_dt_norm", "ssm_b_norm", "ssm_c_norm", "ssm_norm",
               "attn_output_norm", "attn_output_norm_bias", "layer_output_norm",
               "layer_output_norm_bias", "attn_norm_2", "attn_norm_2_bias", "token_types",
               "cls_bias", "cls_out_bias", "attn_rel_b", "attn_sub_norm", "ffn_sub_norm",
               "layer_out_scale",
               # RWKV's mixing vectors, bonus, decay and group norm, and RWKV-6's
               # [5, E, r] decay LoRA, read by einsum (the JAX package's list)
               "time_mix_lerp_x", "time_mix_lerp_w", "time_mix_lerp_k", "time_mix_lerp_v",
               "time_mix_lerp_r", "time_mix_lerp_g", "time_mix_lerp_fused", "time_mix_first",
               "time_mix_decay", "time_mix_ln", "time_mix_ln_bias", "time_mix_w2",
               "channel_mix_lerp_k", "channel_mix_lerp_r",
               # Gemma 3n's small AltUp and LAUREL tensors and its AltUp
               # projections (exact f32, no planes), Gemma 4's MoE norms
               "altup_correct_coef", "altup_predict_coef", "altup_router_norm",
               "altup_correct_scale", "laurel_post_norm", "per_layer_post_norm",
               "per_layer_proj_norm", "altup_proj", "altup_unembd_proj",
               "ffn_pre_norm_2", "ffn_post_norm_1", "ffn_post_norm_2", "ffn_gate_inp_s"}
# gather tables: row-major, not transposed planes
_ROW_TABLES = ("token_embd", "pos_embd", "per_layer_token_embd")


def resolve_device(device) -> torch.device:
    """The entry points run on the card unless the caller asks for the CPU;
    without a card they raise instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run the "
                           "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class Model:
    def __init__(self, cfg: ModelConfig, params: dict[str, Any], device: torch.device,
                 tokenizer: Tokenizer | None = None, gguf: GGUFFile | None = None):
        self.cfg = cfg
        self.params = params
        self.device = device
        self.tokenizer = tokenizer  # None when the file carries no vocab
        self.gguf = gguf  # the parsed file: metadata and tensor index
        # raised whenever a weight is replaced in params (adapters): a
        # context's captured decode loops read the tensors they were made over
        self.version = 0

    @property
    def forward_fn(self):
        """The family's graph (the JAX package's loader.py:338-378): the BERT
        family's encoder, T5's decoder step over the encoder's output (its
        cross state), T5's encoder alone (no return_hidden, as in the JAX
        package), RWKV's forward, the pure-recurrent forward, or the shared
        decoder. RWKV is asked first: its memory is recurrent too."""
        if self.cfg.extra.get("encoder"):
            from . import bert

            return bert.forward
        if self.cfg.extra.get("encoder_decoder"):
            from . import t5

            return t5.t5_forward
        if self.cfg.extra.get("t5_encoder_only"):
            from . import t5

            def enc_only(params, cfg, tokens, inputs, kv, output_rows=None, kernels=True):
                return t5.t5_encode(params, cfg, tokens, kernels=kernels)
            return enc_only
        if self.cfg.extra.get("gemma3n"):
            from . import gemma3n

            return gemma3n.forward
        if self.cfg.extra.get("gemma4"):
            from . import gemma3n

            return gemma3n.forward_gemma4
        if self.cfg.extra.get("gemma4_assistant"):
            def no_standalone(*a, **k):
                raise RuntimeError("gemma4-assistant is an MTP drafter over a target context; "
                                   "use models.gemma3n.Gemma4AssistantSpeculator")
            return no_standalone
        if self.cfg.extra.get("rwkv"):
            from . import rwkv

            return rwkv.forward
        if self.cfg.extra.get("memory") == "recurrent":
            from . import mamba

            return mamba.forward
        from . import transformer

        return transformer.forward


def load_model(path: str, device="cuda", prefer_quant: bool = True,
               dense_dtype: torch.dtype = torch.bfloat16) -> Model:
    """Load a GGUF model of one of the registry's architectures onto
    `device`. prefer_quant=False (--no-quant) loads every matrix as a dense
    weight, whose products take the library route, as the JAX package
    leaves them to XLA. dense_dtype is the activations' and the dense
    matrices' dtype (torch.float32 for exact comparisons), as the JAX
    package's load_model takes it."""
    dev = resolve_device(device)
    f = read_gguf(path)
    cfg = apply_arch(ModelConfig.from_gguf(f.metadata), f.metadata)
    cfg.compute_dtype = dense_dtype
    tokenizer = None
    try:
        tokenizer = Tokenizer.from_gguf(f.metadata)
    except (ValueError, KeyError) as e:
        log.warning("no tokenizer loaded: %s", e)

    layers: list[dict[str, Weight]] = [dict() for _ in range(cfg.n_layers)]
    params: dict[str, Any] = {"layers": layers}
    if cfg.extra.get("t5"):  # the encoder's blocks beside the (empty) decoder list
        params["enc_layers"] = [dict() for _ in range(cfg.extra.get("enc_n_layers",
                                                                    cfg.n_layers))]
    for name, info in f.tensors.items():
        key = target = None
        if name in GLOBAL_TENSORS:
            key, target = GLOBAL_TENSORS[name], params
        elif name.startswith("blk."):
            _, il, suffix = name.split(".", 2)
            key = LAYER_TENSORS.get(suffix)
            if key is not None and int(il) < cfg.n_layers:
                target = layers[int(il)]
        elif name.startswith(("enc.blk.", "dec.blk.")) and "enc_layers" in params:
            part, _, il, suffix = name.split(".", 3)
            key = T5_LAYER_TENSORS.get(suffix)
            group = params["enc_layers"] if part == "enc" else layers
            if key is not None and int(il) < len(group):
                target = group[int(il)]
        if key is None or target is None:
            continue
        # a family's own name for a role (gpt-oss stores its pre-FFN norm as
        # attn_post_norm; chatglm and plamo3 their fused gate|up as ffn_up)
        key = cfg.extra.get("tensor_remap", {}).get(key, key)
        dense = key in _DENSE_KEYS or len(info.shape) == 1
        # matmul weights store transposed planes; the embedding table stays
        # row-major for the row gather
        transpose = not dense and key not in _ROW_TABLES and len(info.shape) >= 2
        target[key] = load_weight(
            np.asarray(info.data), info.dtype, info.shape,
            prefer_quant=prefer_quant and not dense,
            dense_dtype=torch.float32 if dense else cfg.compute_dtype,
            transpose=transpose, device=dev)

    if cfg.extra.get("t5_encoder_only"):  # the encoder's blocks are the ones that run
        layers = params["enc_layers"]
    # nanbeige: the file holds the physical stack; the logical layers past it
    # are filled below by reference (the JAX package's loader.py:519-521)
    n_loops = int(cfg.extra.get("n_loops", 1))
    if n_loops > 1:
        layers = layers[: cfg.n_layers // n_loops]
    # an MoE layer's experts; a file-fused gate|up
    stand_ins = {"ffn_down": ("ffn_down_exps",), "ffn_up": ("ffn_gateup", "ffn_up_exps")}
    if cfg.extra.get("kv_lora_rank") and any("attn_kv_a_mqa" not in lw and "ssm_f_a" not in lw
                                             for lw in layers):
        raise ValueError("model load incomplete: an MLA layer without attn_kv_a_mqa")
    missing = [f"layer {i} missing {k}" for i, lw in enumerate(layers)
               for k in required_layer_tensors(cfg)
               if k not in lw and not any(a in lw for a in stand_ins.get(k, ()))]
    if cfg.extra.get("memory") == "hybrid":
        missing += [f"layer {i} has neither attention nor a recurrent mixer nor an FFN"
                    for i, lw in enumerate(layers)
                    if not any(k in lw for k in ("ssm_in", "attn_output", "shortconv_in",
                                                 "ffn_up", "ssm_beta", "ffn_gate_exps"))]
    if missing:
        raise ValueError(f"model load incomplete: {missing[:4]}")
    for lw in layers:
        _fold_scalar_scales(lw)
    if cfg.extra.get("kv_lora_rank"):
        for lw in layers:
            _fuse_presplit_mla_kv(lw, cfg)
    # qwen35's wq holds per-head [q | gate] pairs at twice the width: a fused
    # q|k|v would be split at the wrong columns, so its projections stay apart
    if not cfg.extra.get("q_gate_interleaved"):
        # a shared-KV layer (gemma3n, gemma4) keeps a standalone attn_q for
        # its q-only projection
        reuse = cfg.extra.get("kv_reuse")
        for il, lw in enumerate(layers):
            _fuse_projections(lw, fuse_qkv=reuse is None or int(reuse[il]) < 0)
    for lw in layers:  # gemma4's fused [gate | up] expert stacks
        if "ffn_gate_up_exps" in lw:
            lw["ffn_gate_exps"], lw["ffn_up_exps"] = _split_gateup_exps(
                lw.pop("ffn_gate_up_exps"))
    if cfg.extra.get("mla_absorb"):
        for lw in layers:
            _split_mla_kv_b(lw, cfg)
    if "rope_factors" in params:
        cfg.extra["rope_factors_arr"] = params["rope_factors"].float().cpu().numpy()
    if n_loops > 1:
        # logical layer il is physical il % n_phys: the same dicts, so the
        # same tensors on the card, not n_loops copies (the JAX package's
        # loader.py:594-599); each logical layer keeps its own KV rows
        params["layers"] = list(layers) * n_loops
    # vocab-head O padding: 128256-style widths have no wide multiple-of-128
    # divisors; pad to a 4096 multiple once, matmul slices via out_dim
    hw = params.get("output")
    if (isinstance(hw, QuantTensor) and hw.transposed and hw.q.dim() == 2
            and hw.q.shape[1] % 1024 and hw.q.shape[1] >= 16384):
        params["output"] = pad_out_features(hw)
    return Model(cfg, params, dev, tokenizer=tokenizer, gguf=f)


def required_layer_tensors(cfg: ModelConfig) -> tuple[str, ...]:
    """The tensors every layer of the family must carry (the JAX package's
    loader.py:524-548): none for T5's encoder; a pre-norm encoder's FFN norm
    and up projection, a post-norm encoder's attention output norm and up
    projection; a recurrent stack's SSM projections; a hybrid's attn_norm
    alone (its mixer or FFN is checked a layer); RWKV's time mix and its
    channel mix or, on the qwen2-FFN hybrids, ffn_up; T5's decoder blocks
    their self-attention, cross-attention and FFN; per-layer head arrays
    (deci, openelm) allow partial blocks, so none; a weightless norm carries
    no norm tensors, a shared parallel norm (phi2, command-r) is attn_norm
    alone, norm-after blocks carry post-norms instead of pre-norms."""
    if cfg.extra.get("t5_encoder_only"):
        return ()
    if cfg.extra.get("encoder_decoder"):
        return ("attn_norm", "attn_output", "cross_attn_norm", "cross_attn_q", "cross_attn_k",
                "cross_attn_v", "cross_attn_output", "ffn_norm", "ffn_down")
    if cfg.extra.get("pre_norm_encoder"):
        return ("ffn_norm", "ffn_up")
    if cfg.extra.get("encoder"):
        return ("attn_output_norm", "ffn_up")
    if cfg.extra.get("rwkv_hybrid"):
        return ("attn_norm", "time_mix_key", "ffn_up")
    if cfg.extra.get("rwkv"):
        return ("attn_norm", "time_mix_key", "channel_mix_key")
    if cfg.extra.get("memory") == "recurrent":
        return ("attn_norm", "ssm_in", "ssm_out")
    if cfg.extra.get("memory") == "hybrid":
        return ("attn_norm",)
    if cfg.extra.get("n_head_arr") is not None:
        return ()
    if cfg.extra.get("weightless_norm"):
        norms: tuple[str, ...] = ()
    elif cfg.shared_parallel_norm:
        norms = ("attn_norm",)
    elif cfg.norm_after:
        norms = ("attn_post_norm", "ffn_post_norm")
    else:
        norms = ("attn_norm", "ffn_norm")
    return norms + ("attn_output", "ffn_down")


def _fold_scalar_scales(lw: dict) -> None:
    """Fold per-tensor scalar scales (`<w>.scale`, reference
    src/models/bitnet.cpp wq_s/...) into the weight: lossless for quantized
    planes (scale planes multiply) and dense weights alike."""
    for key in [k for k in list(lw) if k.endswith(".__scale")]:
        base = key[: -len(".__scale")]
        s = float(lw.pop(key).reshape(-1)[0])
        w = lw.get(base)
        if w is None or s == 1.0:
            continue
        if isinstance(w, QuantTensor):
            if w.d is not None:
                lw[base] = replace(w, d=w.d * s, dmin=None if w.dmin is None else w.dmin * s)
            else:
                lw[base] = replace(w, scales=w.scales * s,
                                   mins=None if w.mins is None else w.mins * s)
        else:
            lw[base] = w * s


def _file_order_f32(w: Weight) -> torch.Tensor:
    """A weight's values in f32 in the file's (numpy) orientation: quantized
    planes dequantized (transposed ones turned back), dense ones as they
    are."""
    if isinstance(w, QuantTensor):
        d = w.dequant(torch.float32)
        return d.transpose(-1, -2) if w.transposed else d
    return w.float()


def _fuse_presplit_mla_kv(lw: dict, cfg: ModelConfig) -> None:
    """The MLA decompression shipped split, attn_k_b [H, C, nope] and
    attn_v_b [H, Dv, C] (file order; ggml {nope, C, H} and {C, Dv, H}),
    reassembled into the fused attn_kv_b [H * (nope + Dv), C]: head h's rows
    are k_b[h]^T then v_b[h] (the JAX package's loader.py:646-667). The
    fused weight is dense in the compute dtype, from the f32 values, so
    every MLA path downstream is shared."""
    if "attn_k_b" not in lw or "attn_kv_b" in lw:
        return
    kb = _file_order_f32(lw.pop("attn_k_b"))
    vb = _file_order_f32(lw.pop("attn_v_b"))
    C = kb.shape[1]
    fused = torch.cat([kb.transpose(1, 2), vb], dim=1)  # [H, nope + Dv, C]
    lw["attn_kv_b"] = fused.reshape(-1, C).to(cfg.compute_dtype)


def _split_mla_kv_b(lw: dict, cfg: ModelConfig) -> None:
    """attn_kv_b [H * (nope + Dv), C] -> the absorbed path's dense operands
    mla_k_b [C, H, nope] (W_UK, folded into q) and mla_v_b [C, H, Dv] (W_UV,
    applied to the latent attention output) (the JAX package's
    loader.py:670-690). A quantized weight is dequantized to bf16; a dense
    one keeps its dtype."""
    w = lw.pop("attn_kv_b", None)
    if w is None:
        return
    nope = cfg.head_dim_k - cfg.rope_dims
    if isinstance(w, QuantTensor):
        dq = w.dequant(torch.bfloat16)
        if not w.transposed:
            dq = dq.t()
    else:
        dq = w.t()
    dq = dq.reshape(dq.shape[0], cfg.n_heads, nope + cfg.head_dim_v)
    lw["mla_k_b"] = dq[:, :, :nope].contiguous()
    lw["mla_v_b"] = dq[:, :, nope:].contiguous()


def _concat_weights(ws: list) -> Weight | None:
    """Concatenate same-type projection weights along the output axis."""
    if any(isinstance(w, QuantTensor) and w.q.dim() == 3 for w in ws):
        raise ValueError("stacked expert planes [E, K, O] are not fused along the output "
                         "axis: the expert kernel takes one stack per projection")
    if all(isinstance(w, QuantTensor) for w in ws):
        if len({(w.group, w.ggml_type, w.transposed, w.packed, w.hier, w.sgroup)
                for w in ws}) != 1:
            return None
        if not ws[0].transposed or any(w.q.dim() != 2 for w in ws):
            return None
        if len({w.q.shape[0] for w in ws}) != 1:
            return None
        have_mins = [w.mins is not None for w in ws]
        if any(have_mins) and not all(have_mins):
            return None

        def cat(name):
            parts = [getattr(w, name) for w in ws]
            return None if parts[0] is None else torch.cat(parts, dim=-1)

        return QuantTensor(q=cat("q"), scales=cat("scales"), mins=cat("mins"),
                           group=ws[0].group, ggml_type=ws[0].ggml_type, transposed=True,
                           packed=ws[0].packed, d=cat("d"), dmin=cat("dmin"),
                           sgroup=ws[0].sgroup)
    if all(isinstance(w, torch.Tensor) for w in ws):
        if len({w.dtype for w in ws}) != 1 or any(w.dim() != 2 for w in ws):
            return None
        if len({w.shape[1] for w in ws}) != 1:
            return None
        return torch.cat(ws, dim=0)  # dense [out, in]
    return None


def _split_gateup_exps(w: Weight) -> tuple[Weight, Weight]:
    """A fused [gate | up] expert stack -> its gate and up stacks: the first
    half of the output rows is the gate (the JAX package's
    loader.py:624-645)."""
    if isinstance(w, QuantTensor):
        F = w.q.shape[-1] // 2

        def half(sl):
            return replace(w, **{k: None if getattr(w, k) is None else
                                 getattr(w, k)[..., sl].contiguous()
                                 for k in ("q", "scales", "mins", "d", "dmin")})

        return half(slice(None, F)), half(slice(F, None))
    F = w.shape[-2] // 2
    return w[..., :F, :].contiguous(), w[..., F:, :].contiguous()


def _fuse_projections(lw: dict, fuse_qkv: bool = True) -> None:
    """Fuse Q/K/V and gate/up projections into single matmuls (fewer
    launches per layer). Q4_K_M stores attn_v as Q6_K (reference
    llama_tensor_get_type, src/llama-quant.cpp:424): then q+k fuse and v
    stays standalone. Biases follow the JAX package's rule: projections fuse
    only when all of them or none carry a bias (the fused bias is
    attn_qkv_bias or attn_qk_bias), and gate/up only when neither does; a
    file's own attn_qkv stays as it is; fuse_qkv=False (a shared-KV layer)
    leaves the attention projections apart."""
    names = ("attn_q", "attn_k", "attn_v")
    if fuse_qkv and all(k in lw for k in names) and "attn_qkv" not in lw:
        fused = _concat_weights([lw[k] for k in names])
        biased = [f"{k}_bias" in lw for k in names]
        if fused is not None and (all(biased) or not any(biased)):
            lw["attn_qkv"] = fused
            if all(biased):
                lw["attn_qkv_bias"] = torch.cat([lw.pop(f"{k}_bias") for k in names])
            for k in names:
                del lw[k]
        elif fused is None:
            fused = _concat_weights([lw["attn_q"], lw["attn_k"]])
            biased = biased[:2]
            if fused is not None and (all(biased) or not any(biased)):
                lw["attn_qk"] = fused
                if all(biased):
                    lw["attn_qk_bias"] = torch.cat([lw.pop(f"{k}_bias") for k in names[:2]])
                del lw["attn_q"], lw["attn_k"]
    if (all(k in lw for k in ("ffn_gate", "ffn_up"))
            and "ffn_gate_bias" not in lw and "ffn_up_bias" not in lw):
        fused = _concat_weights([lw["ffn_gate"], lw["ffn_up"]])
        if fused is not None:
            lw["ffn_gateup"] = fused
            del lw["ffn_gate"], lw["ffn_up"]
