"""The port's LoRA adapters and control vectors (models/adapters.py,
ops/qtensor.py LoraWeight) and export-lora (tools/export_lora.py) on the
CPU, against the JAX package on the same seeded GGUF bytes: runtime LoRA
logits against the JAX package's apply_lora on quantized and dense
(--no-quant) weights; runtime LoRA against the export-lora-merged file;
lora_scale 0 and remove_lora give the base's logits bit for bit; the
control vector against the JAX package's; export-lora's file byte-equal to
the JAX tool's on F32, Q8_0 and Q4_K bases; the adapter's q/k/v and
gate/up pairs land on the fused weights; a change of adapters drops a
context's decode loops, whose next steps equal a fresh context's; a dense
load (--no-quant) of every plane type equals the host's dequantization.

Each comparison with the JAX package is held to NMSE 1e-4 or to twice the
two packages' difference without the adapter, whichever is larger (bf16
activations: about 1e-4 on the Q8_0 fixture). Fixtures: a llama of seeded
values (2 layers, n_embd 256, 4/2 heads of 64, n_ff 512, vocab 256) from the
JAX package's quantizer at Q8_0, Q4_K and F32; a seeded rank-4 adapter on
attn_q, attn_k, attn_v, ffn_gate, ffn_up and ffn_down of both layers and a
control vector (llama_cpp_tpu_torch.testing writers)."""

import filecmp

import numpy as np
import pytest
import torch

from llama_cpp_tpu.models import adapters as jad
from llama_cpp_tpu.models.loader import load_model as jax_load_model
from llama_cpp_tpu.runtime.context import Context as JaxContext
from llama_cpp_tpu.testing import make_tiny_llama_gguf as jax_make_tiny
from llama_cpp_tpu.tools.export_lora import merge_lora as jax_merge_lora
from llama_cpp_tpu_torch.models import adapters
from llama_cpp_tpu_torch.models.loader import load_model
from llama_cpp_tpu_torch.ops.qtensor import LoraWeight, QuantTensor, load_weight
from llama_cpp_tpu_torch.quant.dequant import dequantize_tensor
from llama_cpp_tpu_torch.quant.repack import PLANE_TYPES
from llama_cpp_tpu_torch.runtime.context import Context
from llama_cpp_tpu_torch.testing import (make_control_vector_gguf, make_lora_gguf,
                                         synth_quant_bytes)
from llama_cpp_tpu_torch.tools.export_lora import merge_lora

SHAPE = dict(vocab_size=256, n_layers=2, n_embd=256, n_heads=4, n_kv_heads=2, n_ff=512, seed=3)
CTX = dict(n_ctx=128, n_seqs=1, n_ubatch=32)
PROMPT = [4, 9, 23, 9, 77, 42, 17, 88, 3, 61, 7, 200, 31, 5]
PROJ = {"attn_q": (256, 256), "attn_k": (128, 256), "attn_v": (128, 256),
        "ffn_gate": (512, 256), "ffn_up": (512, 256), "ffn_down": (256, 512)}


def nmse(a, b):
    return float(np.mean((a - b) ** 2) / (np.mean(b ** 2) + 1e-30))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_adapters")
    out = {ft: jax_make_tiny(str(d / f"{ft}.gguf"), ftype=ft, **SHAPE)
           for ft in ("q8_0", "q4_k", "f32")}
    out["lora"] = make_lora_gguf(str(d / "lora.gguf"), 2, PROJ, rank=4, alpha=8.0, scale=0.05)
    out["cvec"] = make_control_vector_gguf(str(d / "cvec.gguf"), 2, 256)
    out["dir"] = d
    return out


def logits(model, prompt=PROMPT):
    return Context(model, device="cpu", **CTX).prefill(prompt)


def jax_logits(model):
    return np.asarray(JaxContext(model, **CTX).prefill(PROMPT))


@pytest.mark.parametrize("ftype,prefer_quant", [("q8_0", True), ("q8_0", False)],
                         ids=["quantized", "dense"])
def test_lora_equals_jax(files, ftype, prefer_quant):
    model = load_model(files[ftype], device="cpu", prefer_quant=prefer_quant)
    jmodel = jax_load_model(files[ftype], prefer_quant=prefer_quant)
    base = nmse(logits(model), jax_logits(jmodel))
    n = adapters.apply_lora(model, adapters.load_lora(files["lora"]), scale=1.0)
    jn = jad.apply_lora(jmodel, jad.load_lora(files["lora"]), scale=1.0)
    assert n == jn == 6  # qkv, gateup and down of 2 layers
    with_lora = logits(model)
    assert nmse(with_lora, jax_logits(jmodel)) < max(1e-4, 2 * base)
    assert nmse(with_lora, logits(load_model(files[ftype], device="cpu",
                                             prefer_quant=prefer_quant))) > 1e-3


def test_lora_targets_the_fused_weights(files):
    model = load_model(files["q8_0"], device="cpu")
    adapters.apply_lora(model, adapters.load_lora(files["lora"]), scale=0.5)
    lw = model.params["layers"][0]
    assert {k for k, w in lw.items() if isinstance(w, LoraWeight)} == {
        "attn_qkv", "ffn_gateup", "ffn_down"}
    qkv = lw["attn_qkv"]
    assert isinstance(qkv.base, QuantTensor) and qkv.a.dtype == torch.bfloat16
    assert tuple(qkv.a.shape) == (12, 256) and tuple(qkv.b.shape) == (512, 12)
    assert qkv.scale == 0.5 * 8.0 / 4


def test_scale_zero_and_remove_give_the_base_bit_for_bit(files):
    model = load_model(files["q8_0"], device="cpu")
    base = logits(model)
    adapter = adapters.load_lora(files["lora"])
    adapters.apply_lora(model, adapter, scale=0.0)
    assert np.array_equal(logits(model), base)
    adapters.apply_lora(model, adapter, scale=1.0)  # replaces the first
    assert not np.allclose(logits(model), base)
    assert adapters.remove_lora(model) == 6
    assert np.array_equal(logits(model), base)


def test_lora_runtime_equals_the_merged_file(files):
    """Runtime LoRA on the F32 base against export-lora's merged file, both
    loaded as bf16 weights: the same product up to the roundings (runtime:
    A, B and the rank-4 intermediate in bf16; merged: W + s B A rounded to
    bf16 once), NMSE about 1.9e-4 here in both packages; held to 1e-3."""
    out = str(files["dir"] / "merged_f32.gguf")
    assert merge_lora(files["f32"], files["lora"], out) == 12
    model = load_model(files["f32"], device="cpu")
    adapters.apply_lora(model, adapters.load_lora(files["lora"]))
    assert nmse(logits(model), logits(load_model(out, device="cpu"))) < 1e-3


@pytest.mark.parametrize("ftype", ["f32", "q8_0", "q4_k"])
def test_export_lora_file_equals_the_jax_tools(files, ftype):
    d = files["dir"]
    ours, theirs = str(d / f"port_{ftype}.gguf"), str(d / f"jax_{ftype}.gguf")
    n = merge_lora(files[ftype], files["lora"], ours, scale=0.7)
    assert n == jax_merge_lora(files[ftype], files["lora"], theirs, scale=0.7) == 12
    assert filecmp.cmp(ours, theirs, shallow=False)


def test_control_vector_equals_jax_and_is_removed(files):
    model = load_model(files["q8_0"], device="cpu")
    jmodel = jax_load_model(files["q8_0"])
    base_logits = logits(model)
    base = nmse(base_logits, jax_logits(jmodel))
    cv = adapters.load_control_vector(files["cvec"], 2, 256)
    jcv = jad.load_control_vector(files["cvec"], 2, 256)
    assert np.array_equal(cv, jcv) and np.abs(cv).sum() > 0
    adapters.apply_control_vector(model, cv, strength=1.5)
    jad.apply_control_vector(jmodel, jcv, strength=1.5)
    steered = logits(model)
    assert nmse(steered, jax_logits(jmodel)) < max(1e-4, 2 * base)
    assert nmse(steered, base_logits) > 1e-3
    adapters.remove_control_vector(model)
    assert np.array_equal(logits(model), base_logits)


def test_adapter_changes_drop_the_decode_loops(files):
    """A context's decode loop made before an adapter change is dropped;
    the next steps equal a fresh context's over the adapted model."""
    model = load_model(files["q8_0"], device="cpu")
    ctx = Context(model, device="cpu", **CTX)
    ctx.prefill(PROMPT)
    before = ctx.decode_loop(1)
    adapters.apply_lora(model, adapters.load_lora(files["lora"]))
    adapters.apply_control_vector(model, adapters.load_control_vector(files["cvec"], 2, 256))
    assert ctx.decode_loop(1) is not before
    ctx.seq_rm(0)
    ctx.prefill(PROMPT)
    got = ctx.decode_steps_greedy(np.asarray([5]), np.asarray([0]), 6)
    fresh = Context(model, device="cpu", **CTX)
    fresh.prefill(PROMPT)
    assert np.array_equal(got, fresh.decode_steps_greedy(np.asarray([5]), np.asarray([0]), 6))


def test_no_quant_equals_jax(files):
    """--no-quant: every matrix a dense bf16 weight, the logits the JAX
    package's prefer_quant=False model's."""
    model = load_model(files["q4_k"], device="cpu", prefer_quant=False)
    assert not any(isinstance(w, QuantTensor) for lw in model.params["layers"]
                   for w in lw.values())
    assert model.params["layers"][0]["attn_qkv"].dtype == torch.bfloat16
    got = logits(model)
    want = jax_logits(jax_load_model(files["q4_k"], prefer_quant=False))
    assert nmse(got, want) < 1e-4


@pytest.mark.parametrize("ggml_type", sorted(PLANE_TYPES, key=int), ids=lambda t: t.name)
def test_dense_load_equals_the_host_dequantization(ggml_type):
    """--no-quant dequantizes a plane type's row-major planes where they
    land: bit for bit the host's dequantize_tensor, cast once to bf16."""
    raw = np.frombuffer(synth_quant_bytes(np.random.default_rng(int(ggml_type)), 64 * 512,
                                          ggml_type), np.uint8)
    w = load_weight(raw, ggml_type, (64, 512), prefer_quant=False)
    want = torch.from_numpy(dequantize_tensor(raw, ggml_type, (64, 512))).to(torch.bfloat16)
    assert w.dtype == torch.bfloat16 and torch.equal(w, want)
