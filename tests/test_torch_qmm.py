"""Quantized weights and the qmm kernel's plain version in the PyTorch port,
against the JAX package: plane extraction and dequantization bit for bit,
and qmm against the Pallas qmm in interpret mode.

Tolerance for qmm: NMSE < 1e-4 (the JAX package's own, test_pallas_qmm).
Interpret mode runs the packed dots in f32 with the mins as a separate f32
term, the port rounds the dequantized weight (mins included) to bf16."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llama_cpp_tpu.gguf import GGMLType
from llama_cpp_tpu.ops.pallas.qmm import qmm as jax_qmm
from llama_cpp_tpu.ops.qtensor import load_weight as jax_load_weight
from llama_cpp_tpu.ops.qtensor import pad_out_features as jax_pad_out_features
from llama_cpp_tpu.quant import quantize
from llama_cpp_tpu.quant.dequant import dequantize as jax_dequantize
from llama_cpp_tpu_torch.ops import qtensor as tq
from llama_cpp_tpu_torch.ops.kernels import qmm as tqmm
from llama_cpp_tpu_torch.quant.dequant import dequantize

O, K = 256, 512


def raw_weight(qtype, o=O, k=K, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((o, k)) * 0.1).astype(np.float32)
    return np.frombuffer(quantize(w, qtype), np.uint8)


def nmse(got, ref):
    return float(np.mean((got - ref) ** 2) / np.mean(ref ** 2))


@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q6_K], ids=["q4_k", "q6_k"])
def test_dequantize_bit_exact(qtype):
    raw = raw_weight(qtype)
    ref = jax_dequantize(raw, qtype, O * K)
    got = dequantize(raw, qtype, O * K)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("transpose", [True, False], ids=["transposed", "row_major"])
@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q6_K], ids=["q4_k", "q6_k"])
def test_load_weight_planes_and_dequant_bit_exact(qtype, transpose):
    raw = raw_weight(qtype, seed=1)
    jw = jax_load_weight(raw, qtype, (O, K), prefer_quant=True, transpose=transpose)
    tw = tq.load_weight(raw, qtype, (O, K), prefer_quant=True, transpose=transpose)
    assert (tw.group, tw.ggml_type, tw.transposed, tw.packed, tw.hier) == (
        jw.group, jw.ggml_type, jw.transposed, jw.packed, jw.hier)
    if transpose:
        # hierarchical K-quant planes; Q4_K nibble-packed half-split
        assert tw.hier and tw.packed == (qtype == GGMLType.Q4_K)
    for name in ("q", "scales", "mins", "d", "dmin"):
        a, b = getattr(jw, name), getattr(tw, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    ref = np.asarray(jw.dequant(jnp.float32))
    got = tw.dequant(torch.float32).numpy()
    np.testing.assert_array_equal(got, ref)


def test_take_rows_matches_jax():
    raw = raw_weight(GGMLType.Q4_K, seed=2)
    jw = jax_load_weight(raw, GGMLType.Q4_K, (O, K), transpose=False)
    tw = tq.load_weight(raw, GGMLType.Q4_K, (O, K), transpose=False)
    ids = np.array([[0, 5, 255], [7, 7, 1]], np.int32)
    ref = np.asarray(jw.take_rows(jnp.asarray(ids), jnp.float32))
    got = tw.take_rows(torch.from_numpy(ids).long(), torch.float32).numpy()
    np.testing.assert_array_equal(got, ref)


def test_pad_out_features_matches_jax():
    raw = raw_weight(GGMLType.Q6_K, o=300, seed=3)
    jw = jax_pad_out_features(jax_load_weight(raw, GGMLType.Q6_K, (300, K), transpose=True),
                              multiple=128)
    tw = tq.pad_out_features(tq.load_weight(raw, GGMLType.Q6_K, (300, K), transpose=True),
                             multiple=128)
    assert tw.q.shape == tuple(jw.q.shape) == (K, 384)
    assert tw.out_features == jw.out_features == 300
    np.testing.assert_array_equal(tw.dequant(torch.float32).numpy(),
                                  np.asarray(jw.dequant(jnp.float32)))


@pytest.mark.parametrize("n", [1, 8, 64])
@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q6_K], ids=["q4_k", "q6_k"])
def test_qmm_plain_matches_jax_pallas(qtype, n):
    raw = raw_weight(qtype, seed=4)
    jw = jax_load_weight(raw, qtype, (O, K), prefer_quant=True, transpose=True)
    tw = tq.load_weight(raw, qtype, (O, K), prefer_quant=True, transpose=True)
    assert tqmm.supported(tw)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((n, K)).astype(np.float32) * 0.5).to(torch.bfloat16)
    ref = np.asarray(jax_qmm(jnp.asarray(x.float().numpy(), jnp.bfloat16), jw, interpret=True))
    got = tqmm.qmm(x, tw)  # CPU tensor -> the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, O)
    assert nmse(got.numpy(), ref) < 1e-4


def test_matmul_routes_by_row_count():
    """Below XLA_PREFILL_MIN_N rows the qmm route, at and above it one
    dequantization and a matmul; on the CPU both compute the same."""
    raw = raw_weight(GGMLType.Q4_K, seed=6)
    tw = tq.load_weight(raw, GGMLType.Q4_K, (O, K), transpose=True)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((tq.XLA_PREFILL_MIN_N, K)).astype(np.float32))
    x = x.to(torch.bfloat16)
    big = tq.matmul(x, tw)
    small = tq.matmul(x[:3], tw)
    assert big.dtype == torch.bfloat16 and big.shape == (tq.XLA_PREFILL_MIN_N, O)
    torch.testing.assert_close(small, big[:3], rtol=0, atol=0)
    plain = tq.matmul(x[:3], tw, kernels=False)
    torch.testing.assert_close(plain, small, rtol=0, atol=0)


def test_split_count_divides_and_fills():
    # decode GEMV of the fused gate|up plane: K/2 = 2048 packed rows
    s = tqmm.split_count(4096, True, 1, 28672, 4096 * 28672 // 2, gemv=True)
    assert s > 1 and (2048 // 64) % s == 0 and 224 * s <= 4096
    # the tensor-core path splits K, not plane rows
    s = tqmm.split_count(14336, False, 32, 4096, 14336 * 4096, gemv=False)
    assert s > 1 and (14336 // 64) % s == 0 and 4 * 32 * s <= 4096
    # a wide prefill needs no split, a narrow one does
    assert tqmm.split_count(4096, True, 512, 28672, 4096 * 28672 // 2, gemv=False) == 1
    assert tqmm.split_count(4096, False, 512, 1024, 4096 * 1024, gemv=False) > 1
    # the vocab head at B = 1 hardly any
    assert tqmm.split_count(4096, False, 1, 131072, 4096 * 131072, gemv=True) <= 4
    # flat planes with K = 768: splits still divide the 64-row units
    s = tqmm.split_count(768, True, 1, 256, 768 * 256 // 2, gemv=True)
    assert (384 // 64) % s == 0


@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q6_K], ids=["q4_k", "q6_k"])
def test_qmm_plain_matches_jax_pallas_flat_scales(qtype, n):
    """K = 768 is no multiple of 512: both packages keep flat f32 scales,
    and the JAX dispatch still runs its Pallas kernel on them."""
    k = 768
    raw = raw_weight(qtype, k=k, seed=8)
    jw = jax_load_weight(raw, qtype, (O, k), prefer_quant=True, transpose=True)
    tw = tq.load_weight(raw, qtype, (O, k), prefer_quant=True, transpose=True)
    assert not tw.hier and not jw.hier and tw.packed == jw.packed
    assert tqmm.dispatches(tw) and tqmm.supported(tw)
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32) * 0.5).to(torch.bfloat16)
    ref = np.asarray(jax_qmm(jnp.asarray(x.float().numpy(), jnp.bfloat16), jw, interpret=True))
    got = tqmm.qmm(x, tw)
    assert nmse(got.numpy(), ref) < 1e-4


@pytest.mark.parametrize("qtype,o,k,transpose,rows", [
    (GGMLType.Q4_K, 256, 512, True, 1), (GGMLType.Q6_K, 256, 512, True, 63),
    (GGMLType.Q4_K, 256, 768, True, 8), (GGMLType.Q6_K, 256, 768, True, 512),
    (GGMLType.Q6_K, 300, 512, True, 1), (GGMLType.Q4_K, 256, 512, False, 1),
    (GGMLType.Q4_K, 256, 512, True, 1024)],
    ids=["q4_k_hier", "q6_k_hier", "q4_k_flat", "q6_k_flat_prefill", "o_not_tileable",
         "row_major", "xla_prefill"])
def test_matmul_takes_the_kernel_where_jax_dispatches(monkeypatch, qtype, o, k, transpose, rows):
    """The port's matmul sends a call to its qmm kernel exactly where the
    JAX package's pallas_qmm_dispatch runs its Pallas kernel."""
    import llama_cpp_tpu.ops.pallas.qmm as jqmm

    raw = raw_weight(qtype, o=o, k=k, seed=10)
    jw = jax_load_weight(raw, qtype, (o, k), prefer_quant=True, transpose=transpose)
    tw = tq.load_weight(raw, qtype, (o, k), prefer_quant=True, transpose=transpose)
    monkeypatch.setattr(jqmm, "qmm", lambda x, qt, interpret=False: "kernel")
    jax_kernel = jqmm.pallas_qmm_dispatch(jnp.zeros((rows, k), jnp.bfloat16), jw) == "kernel"
    calls = []
    monkeypatch.setattr(tqmm, "qmm", lambda x, w: calls.append(x.shape) or tqmm.qmm_plain(x, w))
    tq.matmul(torch.zeros((rows, k), dtype=torch.bfloat16), tw)
    assert bool(calls) == jax_kernel


# main-path shapes of the wgmma prefill GEMM: (K, O, packed) of a Llama-3-8B
# layer (Q4_K attn_qk, attn_output, ffn_gateup; Q6_K attn_v, ffn_down), of a
# TinyLlama-1.1B layer (heads of 64) and flat planes with K = 768
PREFILL_SHAPES = {
    "attn_qk": (4096, 5120, True), "attn_output": (4096, 4096, True),
    "ffn_gateup": (4096, 28672, True), "attn_v": (4096, 1024, False),
    "ffn_down": (14336, 4096, False), "tiny_attn_qk": (2048, 2304, True),
    "tiny_attn_output": (2048, 2048, True), "tiny_ffn_gateup": (2048, 11264, True),
    "tiny_attn_v": (2048, 256, False), "tiny_ffn_down": (5632, 2048, False),
    "flat_k768": (768, 256, True)}


@pytest.mark.parametrize("n", [64, 512, 1023])
@pytest.mark.parametrize("shape", list(PREFILL_SHAPES))
def test_prefill_plan_divides_and_fills(shape, n):
    """Every split of the wgmma GEMM's grid is a whole number of 64-deep K
    steps (64-row plane blocks, two steps each when packed), and the grid
    fills the card's 132 SMs or the plan says why it cannot."""
    K, O, packed = PREFILL_SHAPES[shape]
    plan = tqmm.prefill_plan(n, K, O, packed)
    rows = K // 2 if packed else K
    assert rows % (plan.splits * 64) == 0
    assert plan.steps * 64 * plan.splits == K
    assert plan.row_blocks == -(-n // 128) and plan.col_blocks * 128 == O
    assert plan.blocks >= 132 or plan.note
    assert (plan.note == "") == (plan.blocks >= 132)


def test_prefill_plan_splits_the_narrow_shapes():
    """At the 512-row ubatch attn_v (8 column blocks) is split; the wide
    shapes are not."""
    assert tqmm.prefill_plan(512, 4096, 1024, False).splits > 1
    for K, O, packed in (PREFILL_SHAPES["ffn_gateup"], PREFILL_SHAPES["attn_qk"]):
        assert tqmm.prefill_plan(512, K, O, packed).splits == 1


@pytest.mark.parametrize("rows,cuda_kernel", [
    (4, "qmm4_planes/gemv"), (5, "qmm4_planes/mma"), (63, "qmm4_planes/mma"),
    (64, "qmm4_planes_prefill/wgmma"), (1023, "qmm4_planes_prefill/wgmma"), (1024, None)])
def test_kernel_name_routes_by_row_count(monkeypatch, rows, cuda_kernel):
    """The GEMV up to 4 rows, the mma.sync GEMM to 63, the wgmma GEMM from 64
    (the JAX PREFILL_MIN_N) to 1023; from 1024 rows the matmul route
    dequantizes once and calls torch.matmul (XLA_PREFILL_MIN_N)."""
    raw = raw_weight(GGMLType.Q4_K, seed=11)
    tw = tq.load_weight(raw, GGMLType.Q4_K, (O, K), transpose=True)
    calls = []
    monkeypatch.setattr(tqmm, "qmm", lambda x, w: calls.append(x.shape[0]) or
                        tqmm.qmm_plain(x, w))
    tq.matmul(torch.zeros((rows, K), dtype=torch.bfloat16), tw)
    assert calls == ([] if cuda_kernel is None else [rows])
    if cuda_kernel is not None:
        assert tqmm.kernel_name(tw, rows) == cuda_kernel
        assert cuda_kernel in tqmm.launches
    # the mma.sync GEMM forced at prefill rows keeps its own counter
    assert tqmm.kernel_name(tw, 200, prefill_min_n=1024) == "qmm4_planes_prefill/mma"


@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q6_K], ids=["q4_k", "q6_k"])
def test_qmm_plain_matches_jax_pallas_ragged_prefill(qtype):
    """A ragged prefill ubatch (200 rows, which the JAX wrapper pads to a
    multiple of 8) through the JAX prefill kernel in interpret mode."""
    raw = raw_weight(qtype, seed=12)
    jw = jax_load_weight(raw, qtype, (O, K), prefer_quant=True, transpose=True)
    tw = tq.load_weight(raw, qtype, (O, K), prefer_quant=True, transpose=True)
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal((200, K)).astype(np.float32) * 0.5)
    x = x.to(torch.bfloat16)
    ref = np.asarray(jax_qmm(jnp.asarray(x.float().numpy(), jnp.bfloat16), jw, interpret=True))
    got = tqmm.qmm(x, tw)
    assert tuple(got.shape) == ref.shape == (200, O)
    assert nmse(got.numpy(), ref) < 1e-4


def wgmma_dequant(w) -> torch.Tensor:
    """W as the wgmma prefill kernel forms it: packed planes with the
    group's scale and min rounded to bf16 and one bf16 FMA (its
    product and sum are exact in f32 here); int8 planes as the plain
    version."""
    if not w.packed:
        return w.dequant(torch.bfloat16).float()

    def bf(t):
        return t.to(torch.bfloat16).float()

    q = w.unpack_q().float()
    k, o = q.shape
    wf = q.reshape(k // w.group, w.group, o) * bf(w.eff_scales())[:, None]
    if w.mins is not None:
        wf = wf + bf(w.eff_mins())[:, None]
    return bf(wf.reshape(k, o))


@pytest.mark.parametrize("qtype,k", [(GGMLType.Q4_K, 4096), (GGMLType.Q6_K, 4096),
                                     (GGMLType.Q4_K, 768)], ids=["q4_k", "q6_k", "q4_k_flat"])
def test_wgmma_dequant_rounding_within_tolerance(qtype, k):
    """The wgmma kernel's cheaper rounding of packed planes (scale and min to
    bf16 first) keeps its product within NMSE 1e-4 of the plain version on
    weights made by the quantizer, the card-only tests' tolerance."""
    raw = raw_weight(qtype, o=512, k=k, seed=14)
    tw = tq.load_weight(raw, qtype, (512, k), prefer_quant=True, transpose=True)
    rng = np.random.default_rng(15)
    x = torch.from_numpy(rng.standard_normal((64, k)).astype(np.float32)).to(torch.bfloat16)
    got = x.float() @ wgmma_dequant(tw)
    assert nmse(got.numpy(), tqmm.qmm_plain(x, tw).numpy()) < 1e-4
