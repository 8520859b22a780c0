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
    (4, "qmm4_planes/decode"), (5, "qmm4_planes/decode"), (63, "qmm4_planes/decode"),
    (64, "qmm4_planes_prefill/wgmma"), (1023, "qmm4_planes_prefill/wgmma"), (1024, None)])
def test_kernel_name_routes_by_row_count(monkeypatch, rows, cuda_kernel):
    """Packed planes: the decode kernel up to 63 rows, the wgmma GEMM from
    64 (the JAX PREFILL_MIN_N) to 1023; from 1024 rows the matmul route
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


# -- the decode kernel (csrc/qmm_decode.cu), 1-63 rows ---------------------------

# every plane layout the decode kernel takes: (packed, group, hier, mins)
DECODE_LAYOUTS = {f"{'p' if p else 'i'}{g}_{'hier' if h else 'flat'}{'_mins' if m else ''}":
                  (p, g, h, m) for p in (True, False) for g in (16, 32)
                  for h in (True, False) for m in (True, False)}


def decode_planes(packed, group, hier, mins, K=512, O=256, seed=0):
    """Random planes of one layout as numpy arrays: q (nibble pairs or int8),
    scales, mins, d, dmin (hierarchical: int8 sub-scales and sub-mins, f32
    per-256 d and pre-negated dmin)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-128, 128, (K // 2 if packed else K, O)).astype(np.int8)
    if hier:
        sc = rng.integers(1, 64, (K // group, O)).astype(np.int8)
        mn = rng.integers(0, 64, (K // group, O)).astype(np.int8) if mins else None
        d = (rng.random((K // 256, O)) * 1e-3 + 1e-4).astype(np.float32)
        dm = -(rng.random((K // 256, O)) * 1e-3).astype(np.float32) if mins else None
    else:
        sc = (rng.random((K // group, O)) * 0.02 + 1e-3).astype(np.float32)
        mn = -(rng.random((K // group, O)) * 0.1).astype(np.float32) if mins else None
        d = dm = None
    return q, sc, mn, d, dm


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fmaf of f32 tensors: a * b + c with one rounding to f32."""
    return (a.double() * b.double() + c.double()).float()


def decode_emulation(x: torch.Tensor, w) -> torch.Tensor:
    """The decode kernel's arithmetic in plain PyTorch, in f32 where the
    card's step is f32 (the order of the f32 sums across groups, split-K
    ranges and the two warps of a slice is not modelled).

    Up to 8 rows each weight reaches the tensor cores unscaled and biased:
    a nibble as 128 + q (bf16 128.0 with the nibble in its mantissa); an
    int8 byte as its two nibbles of q + 128, the low one as 128 + lo, the
    high one as 2048 + 16 hi (bf16 2048.0, mantissa step 16), by two MMAs
    into one f32 sum of 2304 + q. Each group's f32 sum of those times bf16
    x is scaled once: acc = fmaf(s, sum, fmaf(m - bias * s, xsum, acc)),
    with s = sub * d and m = subm * dmin in f32 and xsum the group's f32
    sum of x, so the bias leaves through the mins term.

    From 9 rows: W = bf16(q * bf16(s) + bf16(m)), one rounding of an exact
    bf16 FMA in the A fragment, and f32 sums of W times x."""
    K, O, g = w.in_features, w.q.shape[1], w.group
    N = x.shape[0]
    xb = x.to(torch.bfloat16).float()
    s = w.eff_scales()
    m = w.eff_mins() if w.mins is not None else torch.zeros_like(s)
    if w.packed:
        q = w.unpack_q().int()
        parts = [128 + q]
        bias = 128.0
    else:
        q = w.q.int()
        u = q & 0xFF  # the byte, unsigned
        parts = [128 + (u & 0xF), 2048 + 16 * ((u >> 4) ^ 8)]
        bias = 2304.0
        assert torch.equal(parts[0] + parts[1], 2304 + q)
    if tqmm.decode_tiles(N) > 1:
        def bf(t):
            return t.to(torch.bfloat16).double()

        wq = q.double().reshape(K // g, g, O) * bf(s)[:, None] + bf(m)[:, None]
        return xb @ wq.reshape(K, O).to(torch.bfloat16).float()
    mb = fma32(torch.full_like(s, -bias), s, m)  # min - bias * scale, per group
    acc = torch.zeros((N, O))
    for gi in range(K // g):
        tmp = torch.zeros((N, O))
        xs = torch.zeros((N, 1))
        for k0 in range(gi * g, (gi + 1) * g, 16):  # the k16 steps of the group
            xk = xb[:, k0:k0 + 16]
            for p in parts:
                tmp = tmp + xk @ p[k0:k0 + 16].float()
            xs = xs + xk.sum(1, keepdim=True)
        acc = fma32(s[gi].expand(N, O), tmp, fma32(mb[gi].expand(N, O), xs.expand(N, O), acc))
    return acc


def decode_layout_weight(layout):
    """A QuantTensor of random planes of one decode layout (CPU) and its
    numpy planes."""
    packed, group, hier, mins = DECODE_LAYOUTS[layout]
    planes = decode_planes(packed, group, hier, mins, seed=len(layout))
    q, sc, mn, d, dm = (None if a is None else torch.from_numpy(a) for a in planes)
    w = tq.QuantTensor(q=q, scales=sc, mins=mn, group=group, ggml_type=int(GGMLType.Q4_K),
                       transposed=True, packed=packed, d=d, dmin=dm)
    return w, planes


@pytest.mark.parametrize("layout", list(DECODE_LAYOUTS))
def test_decode_emulation_matches_jax_pallas(layout):
    """The decode kernel's arithmetic, emulated, against the JAX package's
    qmm4_planes / qmm_planes in interpret mode at every layout and N = 1, 5,
    8 (the biased integer sums scaled once a group in f32), 33 and 63 (the
    weights scaled in bf16). NMSE < 1e-4, the JAX package's own tolerance
    (test_pallas_qmm): both sides keep f32 sums; they differ by where W is
    rounded to bf16 (never, or once after a bf16-rounded scale and min,
    here; once in the Pallas kernel), which is near 1e-5 on these planes."""
    import llama_cpp_tpu.ops.pallas.qmm as jqmm

    w, (q, sc, mn, d, dm) = decode_layout_weight(layout)
    assert tqmm.supported(w) and tqmm.dispatches(w)
    rng = np.random.default_rng(16)
    x = torch.from_numpy(rng.standard_normal((64, 512)).astype(np.float32)).to(torch.bfloat16)
    fn = jqmm.qmm4_planes if w.packed else jqmm.qmm_planes

    def j(a):
        return None if a is None else jnp.asarray(a)

    ref = np.asarray(fn(jnp.asarray(x.float().numpy(), jnp.bfloat16), j(q), j(sc), j(mn), j(d),
                        j(dm), group=w.group, interpret=True))
    for n in (1, 5, 8, 33, 63):
        got = decode_emulation(x[:n], w)
        assert got.shape == (n, 256)
        assert nmse(got.numpy(), ref[:n]) < 1e-4, n


@pytest.mark.parametrize("layout", list(DECODE_LAYOUTS))
def test_decode_bias_cancels_through_the_mins(layout):
    """Up to 8 rows the kernel sums biased weights (128 + q, or 2304 + q
    for int8 planes) and takes the bias back out through the mins term
    (min - bias * scale times the group's sum of x). In f32 that
    cancellation costs almost nothing: the emulated kernel is within NMSE
    1e-9 of the exact function q * scale + min in float64 at N = 1, 4, 8
    (it reads near 1e-12 on these planes; a bf16 rounding of W, the plain
    version's, costs near 3e-6)."""
    w, _ = decode_layout_weight(layout)
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.standard_normal((8, 512)).astype(np.float32)).to(torch.bfloat16)
    q = (w.unpack_q() if w.packed else w.q).double()
    wq = q.reshape(512 // w.group, w.group, 256) * w.eff_scales().double()[:, None]
    if w.mins is not None:
        wq = wq + w.eff_mins().double()[:, None]
    exact = x.double() @ wq.reshape(512, 256)
    for n in (1, 4, 8):
        got = decode_emulation(x[:n], w)
        assert nmse(got.double().numpy(), exact[:n].numpy()) < 1e-9, n


@pytest.mark.parametrize("n,cols", [(1, 4096), (8, 4096), (32, 4096), (33, 4096), (63, 1024),
                                    (1, 131072), (32, 131072), (63, 131072)])
def test_kernel_name_sends_every_decode_row_count_to_the_decode_kernel(n, cols):
    """Int8 and packed planes alike take the decode kernel at 1-63 rows and
    the wgmma GEMM from 64, at attn_v's, ffn_down's and the head's widths."""
    w = tq.QuantTensor(q=torch.zeros((256, cols), dtype=torch.int8),
                       scales=torch.zeros((16, cols), dtype=torch.int8), mins=None, group=16,
                       ggml_type=int(GGMLType.Q6_K), transposed=True,
                       d=torch.zeros((1, cols)), dmin=None)
    packed = tq.QuantTensor(q=w.q[:128], scales=w.scales, mins=None, group=16,
                            ggml_type=int(GGMLType.Q4_K), transposed=True, packed=True,
                            d=w.d, dmin=None)
    assert tqmm.kernel_name(w, n) == "qmm_planes/decode"
    assert tqmm.kernel_name(packed, n) == "qmm4_planes/decode"
    assert tqmm.kernel_name(w, 64) == "qmm_planes_prefill/wgmma"
    assert tqmm.kernel_name(packed, 64) == "qmm4_planes_prefill/wgmma"


# main-path shapes of the decode kernel: (K, O, packed), the prefill GEMM's
# and the 4096 x 128256 vocab head padded to 131072 columns
DECODE_SHAPES = {**PREFILL_SHAPES, "head": (4096, 131072, False)}


@pytest.mark.parametrize("n", [1, 8, 32, 63])
@pytest.mark.parametrize("shape", list(DECODE_SHAPES))
def test_decode_plan_divides_and_fills(shape, n):
    """Every split of the decode kernel's grid is a whole number of 64-row
    plane blocks, and the grid fills the card's 132 SMs (two blocks an SM
    is the aim) or the plan says why it cannot."""
    K, O, packed = DECODE_SHAPES[shape]
    plan = tqmm.decode_plan(n, K, O, packed)
    rows = K // 2 if packed else K
    assert rows % (plan.splits * 64) == 0
    assert plan.stages * 64 * plan.splits == rows
    assert plan.col_blocks * 128 == O and plan.n_tiles == tqmm.decode_tiles(n)
    assert (plan.note == "") == (plan.blocks >= 132)
    assert plan.blocks <= 4 * 2 * 132 or plan.splits == 1


@pytest.mark.parametrize("nt", [1, 2, 4, 8])
def test_decode_blocks_fit_two_an_sm(nt):
    """At every layout a block's shared memory (the planner's copy of the
    kernel's layout) lets two blocks share an SM's 228 KB."""
    for packed in (True, False):
        for group in (16, 32):
            stages, smem = tqmm.decode_smem(nt, packed, group)
            assert stages in (3, 4)
            assert 2 * (smem + 1024) <= 233472


@pytest.mark.parametrize("transpose", [True, False], ids=["transposed", "row_major"])
@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q6_K], ids=["q4_k", "q6_k"])
def test_library_route_sums_bf16_operands_in_f32(monkeypatch, qtype, transpose):
    """From XLA_PREFILL_MIN_N rows the product is the reference's
    jnp.dot(bf16 x, bf16 W, preferred_element_type=f32): bf16 operands, f32
    sums, an f32 result where f32 is asked for (not a bf16-rounded one). The
    weight is dequantized a slab of columns at a time (three ragged slabs
    here), each slab bit for bit the columns of the whole dequantization."""
    monkeypatch.setattr(tq, "LIBRARY_SLAB", 96)
    tw = tq.load_weight(raw_weight(qtype, seed=5), qtype, (O, K), prefer_quant=True,
                        transpose=transpose)
    whole = tw.dequant(torch.bfloat16)
    for o0 in range(0, O, 96):
        slab = tw.column_slab(o0, min(o0 + 96, O)).dequant(torch.bfloat16)
        cut = whole[:, o0:o0 + 96] if transpose else whole[o0:o0 + 96]
        assert torch.equal(slab, cut)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((tq.XLA_PREFILL_MIN_N, K)).astype(np.float32))
    x = x.to(torch.bfloat16)
    y = tq.matmul(x, tw, dtype=torch.float32)
    wd = (whole if transpose else whole.t()).double()
    exact = x.double() @ wd
    assert y.dtype == torch.float32 and y.shape == (tq.XLA_PREFILL_MIN_N, O)
    err = float((y.double() - exact).abs().max() / exact.abs().max())
    assert err < 1e-5  # f32 sums; a bf16-rounded result would be near 4e-3 off
    assert torch.equal(tq.matmul(x, tw, dtype=torch.float32, kernels=False), y)
