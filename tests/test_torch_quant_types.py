"""Every GGUF storage type the JAX package reads, in the PyTorch port,
against the JAX package bit for bit: dequantization (the 27 block types of
its _DEQUANT, F64 and the integer types), flat and hierarchical plane
extraction (its numpy path; the card's cutter of expert stacks,
quant/device_planes.py, run here against the host planes), load_weight's
planes, flags and dequantized weight (transposed and row-major; the
dequant-only types as dense bf16),
and the quantizers' bytes with and without importance weights. Then the
indexed-expert product's plain version on Q8_0 stacks against the JAX
kernel in interpret mode, and the tiny llama model at Q8_0, Q4_0 and Q5_K_M
through both packages.

The block bytes come from the JAX quantizer where it has one, else from
seeded synthetic blocks with sane scale fields (testing.synth_quant_bytes).

Tolerances: the planes, dequantized values and quantized bytes are equal;
the expert product as tests/test_torch_qmm_expert.py holds it; the models'
prefill and teacher-forced decode logits NMSE < 1e-4 with equal greedy ids
(both packages read the same planes; they sum f32 products in different
orders). Torch runs on one thread here: under pytest-xdist's workers on a
shared CPU its thread pool costs these small products more than the work."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import llama_cpp_tpu.quant.dequant as JD
import llama_cpp_tpu.quant.repack as JR
from llama_cpp_tpu.models.loader import load_model as jax_load_model
from llama_cpp_tpu.ops.pallas.qmm import qmm_planes_expert as jax_qmm_expert
from llama_cpp_tpu.ops.qtensor import load_weight as jax_load_weight
from llama_cpp_tpu.runtime.context import Context as JaxContext
from llama_cpp_tpu.testing import make_tiny_llama_gguf as jax_make_tiny
from llama_cpp_tpu.tools.quantize_tool import quantize_model as jax_quantize_model
from llama_cpp_tpu_torch.gguf.constants import GGML_BLOCK_LAYOUT, GGMLType, type_size_bytes
from llama_cpp_tpu_torch.models.loader import load_model
from llama_cpp_tpu_torch.ops import qtensor as tq
from llama_cpp_tpu_torch.ops.kernels import qmm_expert as tqe
from llama_cpp_tpu_torch.quant import dequant as D
from llama_cpp_tpu_torch.quant import quantize as Q
from llama_cpp_tpu_torch.quant import repack as R
from llama_cpp_tpu_torch.runtime.context import Context
from llama_cpp_tpu_torch.testing import synth_quant_bytes

JQ = importlib.import_module("llama_cpp_tpu.quant.quantize")  # the package re-exports quantize()

O, K = 128, 512  # K a multiple of 512: the hierarchical types keep superblock factors
BLOCK_TYPES = sorted(JD._DEQUANT, key=int)
DENSE_TYPES = (GGMLType.F32, GGMLType.F16, GGMLType.BF16, GGMLType.F64, GGMLType.I8,
               GGMLType.I16, GGMLType.I32, GGMLType.I64)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ids_of(types):
    return [GGMLType(t).name.lower() for t in types]


def weights(o=O, k=K, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((o, k)) * 0.1).astype(np.float32)


def raw_bytes(t, o=O, k=K, seed=0) -> np.ndarray:
    """The JAX quantizer's bytes of seeded weights where it has a quantizer,
    else seeded synthetic blocks."""
    if t in JQ._QUANT:
        return JQ.quantize(weights(o, k, seed), t)
    return np.frombuffer(synth_quant_bytes(np.random.default_rng(seed), o * k, GGMLType(t),
                                           offset=1 + 977 * int(t)), np.uint8)


def test_every_jax_type_has_a_block_layout():
    """The port sizes (and so reads) every tensor the JAX package reads."""
    import llama_cpp_tpu.gguf.constants as JC

    assert set(GGML_BLOCK_LAYOUT) == set(JC.GGML_BLOCK_LAYOUT)
    for t, lay in JC.GGML_BLOCK_LAYOUT.items():
        mine = GGML_BLOCK_LAYOUT[GGMLType(int(t))]
        assert (mine.block_size, mine.type_size) == (lay.block_size, lay.type_size)
        assert type_size_bytes(GGMLType(int(t)), lay.block_size * 3) == lay.type_size * 3


@pytest.mark.parametrize("t", BLOCK_TYPES, ids=ids_of(BLOCK_TYPES))
def test_dequantize_matches_jax(t):
    raw = raw_bytes(t, seed=int(t))
    got = D.dequantize(raw, GGMLType(int(t)), O * K)
    ref = JD.dequantize(raw, t, O * K)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("t", DENSE_TYPES, ids=ids_of(DENSE_TYPES))
def test_dequantize_dense_and_integer_types_match_jax(t):
    rng = np.random.default_rng(int(t))
    raw = rng.integers(0, 256, 64 * GGML_BLOCK_LAYOUT[t].type_size, dtype=np.uint8)
    if t in (GGMLType.F32, GGMLType.F16, GGMLType.BF16, GGMLType.F64):  # finite values
        raw = np.ascontiguousarray(rng.standard_normal(64).astype(
            {GGMLType.F32: np.float32, GGMLType.F16: np.float16, GGMLType.BF16: np.float32,
             GGMLType.F64: np.float64}[t])).view(np.uint8)
        if t == GGMLType.BF16:
            raw = raw.reshape(-1, 4)[:, 2:].reshape(-1).copy()
    got = D.dequantize(raw.tobytes(), t, 64)
    np.testing.assert_array_equal(got, JD.dequantize(raw.tobytes(), t, 64))


@pytest.mark.parametrize("chunk", [R.CHUNK, 2048], ids=["whole", "chunked"])
@pytest.mark.parametrize("t", sorted(R._PLANES, key=int), ids=ids_of(sorted(R._PLANES, key=int)))
def test_extract_planes_matches_jax(monkeypatch, t, chunk):
    """Flat planes equal the JAX package's numpy extractor's, whether the
    tensor is extracted whole or CHUNK elements at a time."""
    assert set(R._PLANES) == {GGMLType(int(x)) for x in JR._PLANES}
    monkeypatch.setattr(R, "CHUNK", chunk)
    raw = raw_bytes(t, seed=20 + int(t))
    got = R.extract_planes(raw, t, O * K)
    ref = JR._PLANES[t](raw, O * K)
    assert got[3] == ref[3] and len(got) == len(ref) == 4
    for a, b in zip(got[:3], ref[:3]):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("experts_a_pass", [2, 5], ids=["chunked", "whole"])
@pytest.mark.parametrize("t, shape", [(GGMLType.Q4_K, (5, 256, 512)),
                                      (GGMLType.Q6_K, (5, 192, 512)),
                                      (GGMLType.Q8_0, (5, 128, 2880)),
                                      (GGMLType.MXFP4, (5, 192, 2880))],
                         ids=["q4_k", "q6_k", "q8_0", "mxfp4"])
def test_device_expert_stack_equals_the_host_planes(t, shape, experts_a_pass):
    """quant/device_planes.expert_stack (the card's route for transposed
    expert stacks, run here on the CPU) gives load_weight's host planes,
    scales and mins in the [E, K, O] layout bit for bit, whole or a few
    experts a pass."""
    from llama_cpp_tpu_torch.quant import device_planes

    assert device_planes.DEVICE_PLANE_TYPES <= set(R._PLANES)
    lay = GGML_BLOCK_LAYOUT[t]
    per = shape[1] * shape[2] // lay.block_size * lay.type_size  # bytes an expert
    raw = np.frombuffer(synth_quant_bytes(np.random.default_rng(int(t)), int(np.prod(shape)), t),
                        np.uint8)
    ref = tq.load_weight(raw, t, shape, transpose=True)
    q, sc, mn, g = device_planes.expert_stack(raw, t, shape, "cpu",
                                              chunk_bytes=experts_a_pass * per)
    assert g == ref.group and (mn is None) == (ref.mins is None)
    assert torch.equal(q, ref.q) and torch.equal(sc, ref.scales)
    assert mn is None or torch.equal(mn, ref.mins)


@pytest.mark.parametrize("chunk", [R.CHUNK, 2048], ids=["whole", "chunked"])
@pytest.mark.parametrize("t", sorted(R._HIER, key=int), ids=ids_of(sorted(R._HIER, key=int)))
def test_extract_planes_hier_matches_jax(monkeypatch, t, chunk):
    assert set(R._HIER) == {GGMLType(int(x)) for x in JR._HIER}
    monkeypatch.setattr(R, "CHUNK", chunk)
    raw = raw_bytes(t, seed=40 + int(t))
    got = R.extract_planes_hier(raw, t, O * K)
    ref = JR._HIER[t](raw, O * K)
    assert got[5] == ref[5]
    for a, b in zip(got[:5], ref[:5]):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("transpose", [True, False], ids=["transposed", "row_major"])
@pytest.mark.parametrize("t", BLOCK_TYPES, ids=ids_of(BLOCK_TYPES))
def test_load_weight_matches_jax(t, transpose):
    """Planes, flags (packed, hier, group) and the dequantized weight equal
    the JAX load_weight's: the packing rule (any plane of at most 16 levels
    nibble-packed, its offset folded into the mins) at Q4_0, Q4_1, Q2_K,
    Q3_K, TQ2_0, IQ1_S; the dequant-only types as dense bf16 weights."""
    raw = raw_bytes(t, seed=60 + int(t))
    jw = jax_load_weight(raw, t, (O, K), prefer_quant=True, transpose=transpose)
    tw = tq.load_weight(raw, GGMLType(int(t)), (O, K), prefer_quant=True, transpose=transpose)
    if not hasattr(jw, "q"):  # a dense weight
        assert isinstance(tw, torch.Tensor) and tw.dtype == torch.bfloat16
        assert t not in R._PLANES
        np.testing.assert_array_equal(tw.float().numpy(), np.asarray(jw, np.float32))
        return
    assert t in R._PLANES
    assert (tw.group, tw.ggml_type, tw.transposed, tw.packed, tw.hier) == (
        jw.group, jw.ggml_type, jw.transposed, jw.packed, jw.hier)
    if transpose:
        assert tw.packed == (t in (GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q2_K, GGMLType.Q3_K,
                                   GGMLType.Q4_K, GGMLType.TQ2_0, GGMLType.IQ1_S))
        assert tw.hier == (t in R._HIER)
    for name in ("q", "scales", "mins", "d", "dmin"):
        a, b = getattr(jw, name), getattr(tw, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    np.testing.assert_array_equal(tw.dequant(torch.float32).numpy(),
                                  np.asarray(jw.dequant(jnp.float32)))


@pytest.mark.parametrize("t", [GGMLType.Q8_0, GGMLType.Q4_0, GGMLType.Q5_K],
                         ids=["q8_0", "q4_0", "q5_k"])
def test_take_rows_matches_jax(t):
    """The embedding gather on a row-major table of a new type."""
    raw = raw_bytes(t, seed=80)
    jw = jax_load_weight(raw, t, (O, K), transpose=False)
    tw = tq.load_weight(raw, t, (O, K), transpose=False)
    ids = np.array([[0, 5, 127], [7, 7, 1]], np.int32)
    ref = np.asarray(jw.take_rows(jnp.asarray(ids), jnp.float32))
    got = tw.take_rows(torch.from_numpy(ids).long(), torch.float32).numpy()
    np.testing.assert_array_equal(got, ref)


QUANT_TYPES = sorted(JQ._QUANT, key=int)


@pytest.mark.parametrize("t", QUANT_TYPES, ids=ids_of(QUANT_TYPES))
def test_quantize_matches_jax(t):
    assert set(Q._QUANT) == {GGMLType(int(x)) for x in JQ._QUANT}
    x = weights(seed=100 + int(t))
    got = Q.quantize(x, GGMLType(int(t)))
    ref = JQ.quantize(x, t)
    assert got.dtype == np.uint8 and got.size == type_size_bytes(GGMLType(int(t)), x.size)
    np.testing.assert_array_equal(got, ref)


IMATRIX_TYPES = sorted(JQ.IMATRIX_AWARE, key=int)


@pytest.mark.parametrize("t", IMATRIX_TYPES, ids=ids_of(IMATRIX_TYPES))
def test_quantize_with_importance_weights_matches_jax(t):
    assert {int(x) for x in Q.IMATRIX_AWARE} == {int(x) for x in JQ.IMATRIX_AWARE}
    x = weights(seed=120 + int(t))
    qw = np.broadcast_to(np.random.default_rng(5).random(K).astype(np.float32) + 0.1, x.shape)
    got = Q.quantize(x, GGMLType(int(t)), qw=qw)
    np.testing.assert_array_equal(got, JQ.quantize(x, t, qw=qw))


def test_expert_product_on_q8_0_stacks_matches_jax_kernel():
    """K7's plain version on a Q8_0 expert stack (flat f32 scales, groups of
    32, no mins) as both loaders lay it out, against the JAX package's
    qmm_planes_expert in interpret mode."""
    E, k, o, rows = 4, 512, 256, 6
    rng = np.random.default_rng(140)
    raw = JQ.quantize((rng.standard_normal((E, o, k)) * 0.1).astype(np.float32),
                      GGMLType.Q8_0)
    jw = jax_load_weight(raw, GGMLType.Q8_0, (E, o, k), transpose=True)
    tw = tq.load_weight(raw, GGMLType.Q8_0, (E, o, k), transpose=True)
    assert tqe.supported(tw) and tw.group == 32 and tw.mins is None
    np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw.q))
    x = torch.from_numpy(rng.standard_normal((rows, k)).astype(np.float32)).to(torch.bfloat16)
    ids = rng.integers(0, E, rows).astype(np.int32)
    x8 = np.broadcast_to(x.float().numpy()[:, None], (rows, 8, k)).copy()
    ref = np.asarray(jax_qmm_expert(jnp.asarray(x8, jnp.bfloat16), jnp.asarray(ids), jw.q,
                                    jw.scales, None, group=32, interpret=True))
    got = tqe.qmm_expert(x, torch.from_numpy(ids), tw).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 5e-3
    assert float(np.mean((got - ref) ** 2) / np.mean(ref ** 2)) < 1e-4


# -- the tiny llama model at the new types -----------------------------------

TINY = dict(vocab_size=512, n_layers=2, n_embd=512, n_heads=4, n_kv_heads=2, n_ff=1024, seed=3)
CTX = dict(n_ctx=256, n_seqs=1, n_ubatch=64)


@pytest.fixture(scope="module", params=["q8_0", "q4_0", "q5_k_m"])
def tiny_models(request, tmp_path_factory):
    """The JAX make_tiny_llama_gguf at q8_0 or q4_0, and a Q5_K_M file that
    the JAX quantize tool made from the f32 fixture, in both packages."""
    d = tmp_path_factory.mktemp("quant_types")
    ftype = request.param
    if ftype == "q5_k_m":
        src = jax_make_tiny(str(d / "f32.gguf"), ftype="f32", **TINY)
        path = str(d / "q5_k_m.gguf")
        jax_quantize_model(src, path, "q5_k_m")
    else:
        path = jax_make_tiny(str(d / f"{ftype}.gguf"), ftype=ftype, **TINY)
    return ftype, load_model(path, device="cpu"), jax_load_model(path)


def nmse(got, ref):
    return float(np.mean((got - ref) ** 2) / np.mean(ref ** 2))


def test_tiny_model_loads_the_file_types_planes(tiny_models):
    ftype, model, _ = tiny_models
    lw = model.params["layers"][0]
    want = {"q8_0": GGMLType.Q8_0, "q4_0": GGMLType.Q4_0, "q5_k_m": GGMLType.Q5_K}[ftype]
    assert lw["ffn_gateup"].ggml_type == want and lw["attn_output"].ggml_type == want
    if ftype == "q5_k_m":  # attn_v is Q6_K: q and k fuse, v stays alone
        assert "attn_qk" in lw and lw["attn_v"].ggml_type == GGMLType.Q6_K
        assert lw["attn_qk"].hier and lw["attn_qk"].mins is not None
    else:
        assert "attn_qkv" in lw and not lw["attn_qkv"].hier
        assert lw["attn_qkv"].packed == (ftype == "q4_0")


def test_tiny_model_logits_and_ids_match_jax(tiny_models):
    """Prefill logits and 8 teacher-forced decode steps (the JAX greedy ids
    fed to both) at NMSE < 1e-4, and the greedy ids equal."""
    _, model, jmodel = tiny_models
    prompt = [int(t) for t in np.random.default_rng(9).integers(3, 512, 40)]
    ctx = Context(model, device="cpu", **CTX)
    jctx = JaxContext(jmodel, **CTX)
    got, ref = ctx.prefill(prompt), jctx.prefill(prompt)
    ids, jids = [], []
    for _ in range(8):
        assert nmse(got, ref) < 1e-4
        ids.append(int(np.argmax(got)))
        jids.append(int(np.argmax(ref)))
        got, ref = ctx.decode_one(jids[-1]), jctx.decode_one(jids[-1])
    assert ids == jids
    assert len(set(jids)) > 2


@pytest.mark.parametrize("ftype", ["q8_0", "q5_k_m"])
def test_real_quant_qwen3_fixture_matches_jax(tmp_path, ftype):
    """The port's real-quantizer fixture (seeded values through its own
    quantize, each tensor at llama-quantize's type for the file type) on
    the Qwen3 graph against the JAX package, held as tests/
    test_torch_archs.py holds the Qwen3 entry: 8 teacher-forced steps'
    logits at NMSE < 1e-3 (XLA's excess precision and its per-head q/k
    norms leave near 1e-4 on quantizer weights, ROADMAP queue 3), the
    argmax equal at every step whose JAX top-2 gap exceeds 0.1, and ids
    that vary."""
    from llama_cpp_tpu_torch.testing import make_bench_arch_gguf

    path = make_bench_arch_gguf(str(tmp_path / "m.gguf"), "qwen3", 2, 512, 4, 2, 128, 1024,
                                512, rope_base=1e6, qk_norm=True, ftype=ftype, real_quant=True)
    model, jmodel = load_model(path, device="cpu"), jax_load_model(path)
    assert model.params["layers"][0]["ffn_gateup"].ggml_type == (
        GGMLType.Q8_0 if ftype == "q8_0" else GGMLType.Q5_K)
    prompt = [int(t) for t in np.random.default_rng(11).integers(3, 512, 40)]
    ctx, jctx = Context(model, device="cpu", **CTX), JaxContext(jmodel, **CTX)
    got, ref = ctx.prefill(prompt), jctx.prefill(prompt)
    jids, decided = [], 0
    for _ in range(8):
        assert nmse(got, ref) < 1e-3
        top2 = np.sort(ref)[-2:]
        if top2[1] - top2[0] > 0.1:
            assert int(np.argmax(got)) == int(np.argmax(ref))
            decided += 1
        jids.append(int(np.argmax(ref)))
        got, ref = ctx.decode_one(jids[-1]), jctx.decode_one(jids[-1])
    assert decided >= 4 and len(set(jids)) > 2


def test_q8_0_moe_fixture_matches_jax(tmp_path):
    """make_bench_qwen3moe_gguf at ftype q8_0: the expert stacks load as
    the indexed-expert kernel's Q8_0 layout (int8, flat f32 scales, groups
    of 32, no mins), and the prefill logits match the JAX package's at
    NMSE < 1e-3 (the tolerance of tests/test_torch_archs.py)."""
    from llama_cpp_tpu_torch.testing import make_bench_qwen3moe_gguf

    path = make_bench_qwen3moe_gguf(str(tmp_path / "moe.gguf"), n_layers=1, n_embd=256,
                                    n_heads=2, n_kv_heads=1, head_dim=128, n_expert=4,
                                    n_expert_used=2, n_ff_exp=256, vocab_size=512, ftype="q8_0")
    model, jmodel = load_model(path, device="cpu"), jax_load_model(path)
    for key in ("ffn_gate_exps", "ffn_up_exps", "ffn_down_exps"):
        w = model.params["layers"][0][key]
        assert w.ggml_type == GGMLType.Q8_0 and tqe.supported(w)
        assert (w.group, w.mins, w.hier) == (32, None, False)
    prompt = [int(t) for t in np.random.default_rng(12).integers(3, 512, 40)]
    got = Context(model, device="cpu", **CTX).prefill(prompt)
    ref = JaxContext(jmodel, **CTX).prefill(prompt)
    assert nmse(got, ref) < 1e-3
