"""Card-only tests of the PyTorch port: each CUDA kernel against its plain
PyTorch version, and the main path's kernel route against its plain route,
on a small model. They skip without an NVIDIA GPU. This file imports nothing
of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from llama_cpp_tpu_torch.gguf.constants import GGMLType
from llama_cpp_tpu_torch.models.loader import load_model
from llama_cpp_tpu_torch.ops import qtensor as tq
from llama_cpp_tpu_torch.ops.kernels import flash_attn as tfa
from llama_cpp_tpu_torch.ops.kernels import qmm as tqmm
from llama_cpp_tpu_torch.ops.kernels import qmm_bench as tqb
from llama_cpp_tpu_torch.ops.kernels import qmm_expert as tqe
from llama_cpp_tpu_torch.runtime.context import Context
from llama_cpp_tpu_torch.testing import (make_bench_llama_gguf, make_bench_moe_gguf,
                                         synth_quant_bytes)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run `python -m pytest --noconftest -m gpu "
                    "tests/test_torch_gpu.py` on the card")
    return torch.device("cuda")


def nmse(got, ref):
    got, ref = got.float(), ref.float()
    return float(((got - ref) ** 2).mean() / (ref ** 2).mean())


@pytest.mark.parametrize("n", [1, 3, 5, 8, 16, 32, 64, 512])
@pytest.mark.parametrize("qtype,K", [(GGMLType.Q4_K, 1024), (GGMLType.Q6_K, 1024),
                                     (GGMLType.Q4_K, 768), (GGMLType.Q6_K, 768)],
                         ids=["q4_k", "q6_k", "q4_k_flat", "q6_k_flat"])
def test_qmm_kernel_matches_plain(cuda_device, qtype, K, n):
    """GEMV and tensor-core GEMM against the plain version, on hierarchical
    planes (K % 512 == 0) and flat f32 scales (K = 768). NMSE < 1e-4: the
    GEMV skips the plain version's bf16 rounding of W (an NMSE near 1e-6),
    the GEMM differs only in summation order."""
    O = 384
    rng = np.random.default_rng(int(qtype) + n + K)
    raw = np.frombuffer(synth_quant_bytes(rng, O * K, qtype), np.uint8)
    w = tq.load_weight(raw, qtype, (O, K), transpose=True, device=cuda_device)
    assert tqmm.dispatches(w) and tqmm.supported(w)
    assert w.hier == (K % 512 == 0) and w.packed == (qtype == GGMLType.Q4_K)
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    x = torch.randn((n, K), generator=gen, device=cuda_device).to(torch.bfloat16)
    name = tqmm.kernel_name(w, n)
    before = tqmm.launches[name]
    got = tqmm.qmm(x, w)
    torch.cuda.synchronize()
    assert tqmm.launches[name] == before + 1
    assert got.shape == (n, O) and torch.isfinite(got).all()
    assert nmse(got, tqmm.qmm_plain(x, w)) < 1e-4


def synth_planes(device, packed: bool, group: int, hier: bool, mins: bool, K=512, O=256,
                 seed=0):
    """A random plane QuantTensor of any layout the kernel takes."""
    rng = np.random.default_rng(seed)
    rows = K // 2 if packed else K
    q = rng.integers(-128, 128, (rows, O)).astype(np.int8)
    if hier:
        sc = rng.integers(1, 64, (K // group, O)).astype(np.int8)
        mn = rng.integers(0, 64, (K // group, O)).astype(np.int8) if mins else None
        d = (rng.random((K // 256, O)) * 1e-3).astype(np.float32)
        dm = -(rng.random((K // 256, O)) * 1e-3).astype(np.float32) if mins else None
    else:
        sc = (rng.random((K // group, O)) * 0.02).astype(np.float32)
        mn = -(rng.random((K // group, O)) * 0.1).astype(np.float32) if mins else None
        d = dm = None

    def t(a):
        return None if a is None else torch.from_numpy(a).to(device)

    return tq.QuantTensor(q=t(q), scales=t(sc), mins=t(mn), group=group,
                          ggml_type=int(GGMLType.Q4_K), transposed=True, packed=packed,
                          d=t(d), dmin=t(dm))


@pytest.mark.parametrize("gemv_max_n", [8, 0], ids=["gemv", "mma"])
@pytest.mark.parametrize("packed,group,hier,mins", [
    (True, 16, True, True), (True, 16, False, False), (False, 32, True, False),
    (False, 32, False, True), (True, 32, False, True), (False, 16, False, False)],
    ids=["p16_hier_mins", "p16_flat", "i32_hier", "i32_flat_mins", "p32_flat_mins",
         "i16_flat"])
def test_qmm_kernel_every_layout(cuda_device, packed, group, hier, mins, gemv_max_n):
    """Each plane layout the JAX dispatch sends to its kernel, through the
    GEMV and the GEMM forced, at 1-8 rows."""
    w = synth_planes(cuda_device, packed, group, hier, mins)
    assert tqmm.dispatches(w) and tqmm.supported(w)
    for n in (1, 2, 4, 8):
        x = torch.randn((n, 512), device=cuda_device).to(torch.bfloat16)
        got = tqmm.qmm(x, w, gemv_max_n=gemv_max_n)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        assert nmse(got, tqmm.qmm_plain(x, w)) < 1e-4, n


def test_qmm_raises_on_what_the_kernel_does_not_take(cuda_device):
    rng = np.random.default_rng(0)
    raw = np.frombuffer(synth_quant_bytes(rng, 128 * 512, GGMLType.Q4_K), np.uint8)
    w = tq.load_weight(raw, GGMLType.Q4_K, (128, 512), transpose=True, device=cuda_device)
    with pytest.raises(ValueError):
        tqmm.qmm(torch.zeros((2, 512), device=cuda_device), w)  # f32, not bf16
    with pytest.raises(ValueError):
        tqmm.qmm(torch.zeros((512, 2), device=cuda_device, dtype=torch.bfloat16).t(), w)


def paged_case(device, B=3, Hkv=2, G=4, T=5, D=128, page=128, depths=(300, 129, 40), seed=0,
               bf16=False):
    gen = torch.Generator(device=device).manual_seed(seed)
    mp = 4
    n_pages = B * mp + 1
    S = n_pages * page
    if bf16:
        k = torch.randn((Hkv, S, D), generator=gen, device=device).to(torch.bfloat16)
        v = torch.randn((Hkv, S, D), generator=gen, device=device).to(torch.bfloat16)
        ks = vs = None
    else:
        k = torch.randint(-127, 128, (Hkv, S, D), generator=gen, device=device,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, (Hkv, S, D), generator=gen, device=device,
                          dtype=torch.int8)
        ks = torch.rand((Hkv, S), generator=gen, device=device) * 0.02 + 0.005
        vs = torch.rand((Hkv, S), generator=gen, device=device) * 0.02 + 0.005
    pos = torch.full((S,), -1, dtype=torch.int32, device=device)
    table = torch.full((B, mp), n_pages - 1, dtype=torch.int32, device=device)
    for b, dep in enumerate(depths):
        n = dep + T
        for j in range(-(-n // page)):
            pid = b * mp + j
            table[b, j] = pid
            cnt = min(page, n - j * page)
            pos[pid * page: pid * page + cnt] = torch.arange(j * page, j * page + cnt,
                                                             dtype=torch.int32)
    q = (torch.randn((B, Hkv, G * T, D), generator=gen, device=device) * 0.5).to(torch.bfloat16)
    row_pos = torch.stack([(dep + torch.arange(T, dtype=torch.int32)).repeat(G)
                           for dep in depths]).to(device)
    row_pos[-1, -1] = -1  # a padding row
    sinks = torch.randn((Hkv, G * T), generator=gen, device=device)
    return (q, k, v, row_pos, pos, table, ks, vs), sinks, page


@pytest.mark.parametrize("bf16", [False, True], ids=["int8_pool", "bf16_pool"])
@pytest.mark.parametrize("window,softcap,use_sinks,T", [
    (0, 0.0, False, 1), (0, 0.0, False, 5), (96, 2.0, True, 5), (64, 0.0, True, 1)],
    ids=["decode", "prefill", "all", "decode_window_sinks"])
def test_paged_attention_kernel_matches_plain(cuda_device, window, softcap, use_sinks, T, bf16):
    args, sinks, page = paged_case(cuda_device, T=T, bf16=bf16)
    kw = dict(sm_scale=1.0 / np.sqrt(128), window=window, softcap=softcap, page=page)
    sinks = sinks if use_sinks else None
    before = tfa.launches["flash_attention_paged"]
    got = tfa.flash_attention_paged(*args, sinks, **kw)
    torch.cuda.synchronize()
    assert tfa.launches["flash_attention_paged"] == before + 1
    ref = tfa.flash_attention_paged_plain(*args, sinks, **kw)
    valid = args[3] >= 0  # [B, R]
    g, r = got.transpose(1, 2)[valid], ref.transpose(1, 2)[valid]
    assert torch.isfinite(g).all()
    assert nmse(g, r) < 1e-5


def test_paged_attention_raises_on_what_the_kernel_does_not_take(cuda_device):
    args, _, page = paged_case(cuda_device, D=32)  # heads of 64 and 128 run
    with pytest.raises(ValueError):
        tfa.flash_attention_paged(*args, sm_scale=0.125, page=page)
    args, _, page = paged_case(cuda_device)
    with pytest.raises(ValueError):  # an int8 pool without its scales
        tfa.flash_attention_paged(*args[:6], sm_scale=0.125, page=page)


@pytest.mark.parametrize("quantized_kv", [True, False], ids=["int8_kv", "bf16_kv"])
def test_main_path_kernel_route_matches_plain_route(cuda_device, tmp_path, quantized_kv):
    """A small bench-shaped model on the card: prefill and batched greedy
    decode through the kernels, held against Context(kernels=False)."""
    path = make_bench_llama_gguf(str(tmp_path / "m.gguf"), n_layers=2, n_embd=512,
                                 n_heads=4, n_kv_heads=2, n_ff=1024, vocab_size=512, seed=0)
    model = load_model(path)
    prompt = [int(t) for t in np.random.default_rng(1).integers(3, 512, 200)]
    for counter in (tqmm.launches, tfa.launches):
        for key in counter:
            counter[key] = 0
    ctx = Context(model, n_ctx=512, n_seqs=4, n_ubatch=128, quantized_kv=quantized_kv)
    got = ctx.prefill(prompt)
    ids = ctx.decode_steps_greedy(np.array([int(np.argmax(got))]), np.array([0]), 4)
    assert tfa.launches["flash_attention_paged"] > 0 and tfa.launches["flash_attention"] == 0
    assert tqmm.launches["qmm4_planes_prefill/mma"] > 0
    assert tqmm.launches["qmm_planes/gemv"] > 0
    ref_ctx = Context(model, n_ctx=512, n_seqs=4, n_ubatch=128, quantized_kv=quantized_kv,
                      kernels=False)
    ref = ref_ctx.prefill(prompt)
    assert nmse(torch.from_numpy(got), torch.from_numpy(ref)) < 5e-3
    assert ids.shape == (1, 4)


@pytest.mark.parametrize("bf16", [False, True], ids=["int8_pool", "bf16_pool"])
@pytest.mark.parametrize("T", [1, 5], ids=["decode", "prefill"])
def test_paged_attention_kernel_heads_of_64(cuda_device, T, bf16):
    args, sinks, page = paged_case(cuda_device, T=T, D=64, bf16=bf16)
    kw = dict(sm_scale=0.125, window=96, softcap=2.0, page=page)
    got = tfa.flash_attention_paged(*args, sinks, **kw)
    torch.cuda.synchronize()
    ref = tfa.flash_attention_paged_plain(*args, sinks, **kw)
    valid = args[3] >= 0
    assert nmse(got.transpose(1, 2)[valid], ref.transpose(1, 2)[valid]) < 1e-5


def slot_case(device, D=128, T=5, G=4, Hkv=2, n_seqs=5, S=512, bf16=False, ring=False, seed=0):
    """A slot-table cache with ragged fills; batch rows pick sequences 3, 0
    and 3 again through seq_idx."""
    gen = torch.Generator(device=device).manual_seed(seed)
    fills = [300, 129, 40, 450, 7]
    if bf16:
        k = torch.randn((n_seqs, Hkv, S, D), generator=gen, device=device).to(torch.bfloat16)
        v = torch.randn((n_seqs, Hkv, S, D), generator=gen, device=device).to(torch.bfloat16)
        ks = vs = None
    else:
        k = torch.randint(-127, 128, (n_seqs, Hkv, S, D), generator=gen, device=device,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, (n_seqs, Hkv, S, D), generator=gen, device=device,
                          dtype=torch.int8)
        ks = torch.rand((n_seqs, Hkv, S), generator=gen, device=device) * 0.02 + 0.005
        vs = torch.rand((n_seqs, Hkv, S), generator=gen, device=device) * 0.02 + 0.005
    pos = torch.full((n_seqs, S), -1, dtype=torch.int32)
    for s, f in enumerate(fills):
        pos[s, :f] = torch.arange(f, dtype=torch.int32)
        if ring:
            pos[s] = torch.roll(pos[s], 200 + 11 * s)
    seq_idx = torch.tensor([3, 0, 3], dtype=torch.int32, device=device)
    q = (torch.randn((3, Hkv, G * T, D), generator=gen, device=device) * 0.5).to(torch.bfloat16)
    row_pos = torch.stack([(fills[s] - T + torch.arange(T, dtype=torch.int32)).repeat(G)
                           for s in (3, 0, 3)]).to(device)
    row_pos[-1, -1] = -1  # a padding row
    sinks = torch.randn((Hkv, G * T), generator=gen, device=device)
    return (q, k, v, row_pos, pos.to(device), seq_idx, ks, vs), sinks


@pytest.mark.parametrize("ring", [False, True], ids=["table", "ring"])
@pytest.mark.parametrize("bf16", [False, True], ids=["int8", "bf16"])
@pytest.mark.parametrize("D", [64, 128], ids=["d64", "d128"])
@pytest.mark.parametrize("window,softcap,use_sinks,T", [
    (0, 0.0, False, 1), (0, 0.0, False, 5), (96, 2.0, True, 5), (64, 0.0, True, 1)],
    ids=["decode", "prefill", "all", "decode_window_sinks"])
def test_slot_attention_kernel_matches_plain(cuda_device, window, softcap, use_sinks, T, D,
                                             bf16, ring):
    args, sinks = slot_case(cuda_device, D=D, T=T, bf16=bf16, ring=ring)
    kw = dict(sm_scale=1.0 / np.sqrt(D), window=window, softcap=softcap, ring=ring)
    sinks = sinks if use_sinks else None
    before = tfa.launches["flash_attention"]
    got = tfa.flash_attention(*args, sinks, **kw)
    torch.cuda.synchronize()
    assert tfa.launches["flash_attention"] == before + 1
    ref = tfa.flash_attention_plain(*args, sinks, **kw)
    valid = args[3] >= 0
    g, r = got.transpose(1, 2)[valid], ref.transpose(1, 2)[valid]
    assert torch.isfinite(g).all()
    assert nmse(g, r) < 1e-5


def test_slot_attention_raises_on_what_the_kernel_does_not_take(cuda_device):
    args, _ = slot_case(cuda_device, D=32)
    with pytest.raises(ValueError):
        tfa.flash_attention(*args, sm_scale=0.125)
    args, _ = slot_case(cuda_device)
    with pytest.raises(ValueError):  # an int8 cache without its scales
        tfa.flash_attention(*args[:6], sm_scale=0.125)
    with pytest.raises(ValueError):  # seq_idx must be int32
        tfa.flash_attention(*args[:5], args[5].long(), *args[6:], sm_scale=0.125)


@pytest.mark.parametrize("mins", [False, True], ids=["scales", "scales_mins"])
@pytest.mark.parametrize("E,K,O,R,g", [
    (8, 1024, 512, 2, 32), (8, 512, 1024, 1, 16), (4, 768, 256, 9, 32), (128, 256, 384, 64, 16),
    (2, 2048, 128, 17, 32)],
    ids=["top2", "one_row", "shared_experts", "many_experts", "five_rows_an_expert"])
def test_expert_kernel_matches_plain(cuda_device, E, K, O, R, g, mins):
    """The indexed-expert kernel against its plain version: NMSE < 1e-4 (the
    kernel skips the plain version's bf16 rounding of W)."""
    gen = torch.Generator(device=cuda_device).manual_seed(E + R)
    q = torch.randint(-127, 128, (E, K, O), generator=gen, device=cuda_device, dtype=torch.int8)
    sc = torch.randn((E, K // g, O), generator=gen, device=cuda_device) * 0.02
    mn = torch.randn((E, K // g, O), generator=gen, device=cuda_device) * 0.01 if mins else None
    w = tq.QuantTensor(q=q, scales=sc, mins=mn, group=g, ggml_type=int(GGMLType.Q4_K),
                       transposed=True)
    x = torch.randn((R, K), generator=gen, device=cuda_device).to(torch.bfloat16)
    ids = torch.randint(0, E, (R,), generator=gen, device=cuda_device, dtype=torch.int32)
    before = tqe.launches["qmm_planes_expert"]
    got = tqe.qmm_expert(x, ids, w)
    torch.cuda.synchronize()
    assert tqe.launches["qmm_planes_expert"] == before + 1
    assert got.shape == (R, O) and torch.isfinite(got).all()
    assert nmse(got, tqe.qmm_expert_plain(x, ids, w)) < 1e-4


def test_expert_kernel_raises_on_what_it_does_not_take(cuda_device):
    q = torch.zeros((2, 256, 128), dtype=torch.int8, device=cuda_device)
    sc = torch.ones((2, 8, 128), device=cuda_device)
    w = tq.QuantTensor(q=q, scales=sc, mins=None, group=32, ggml_type=int(GGMLType.Q4_K),
                       transposed=True)
    x = torch.zeros((2, 256), dtype=torch.bfloat16, device=cuda_device)
    ids = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        tqe.qmm_expert(x.float(), ids, w)
    with pytest.raises(ValueError):
        tqe.qmm_expert(x, ids.long(), w)
    with pytest.raises(ValueError):  # a 2-D plane is the plain qmm's
        tqe.qmm_expert(x, ids, tq.QuantTensor(q=q[0], scales=sc[0], mins=None, group=32,
                                              ggml_type=int(GGMLType.Q4_K), transposed=True))


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slots"])
@pytest.mark.parametrize("heads", [4, 8], ids=["d128", "d64"])
def test_moe_path_kernel_route_matches_plain_route(cuda_device, tmp_path, paged, heads):
    """A small Mixtral-shaped model on the card: the ragged prefill, B = 1
    decode through the indexed-expert kernel and batched decode, on either
    memory, held against Context(kernels=False)."""
    path = make_bench_moe_gguf(str(tmp_path / "moe.gguf"), n_layers=2, n_embd=512,
                               n_heads=heads, n_kv_heads=2, n_ff=1024, n_expert=8,
                               n_expert_used=2, vocab_size=512, seed=0)
    model = load_model(path)
    prompt = [int(t) for t in np.random.default_rng(1).integers(3, 512, 200)]
    for counter in (tqmm.launches, tfa.launches, tqe.launches):
        for key in counter:
            counter[key] = 0
    kw = dict(n_ctx=512, n_seqs=4, n_ubatch=128, quantized_kv=True, paged=paged)
    ctx = Context(model, **kw)
    got = ctx.prefill(prompt)
    step = ctx.decode_one(int(np.argmax(got)))
    ids = ctx.decode_steps_greedy(np.array([int(np.argmax(step))]), np.array([0]), 4)
    assert tqe.launches["qmm_planes_expert"] == 3 * 2 * 5  # three a layer and B = 1 step
    assert tfa.launches["flash_attention_paged" if paged else "flash_attention"] > 0
    assert tfa.launches["flash_attention" if paged else "flash_attention_paged"] == 0
    ref_ctx = Context(model, kernels=False, **kw)
    ref = ref_ctx.prefill(prompt)
    assert nmse(torch.from_numpy(got), torch.from_numpy(ref)) < 5e-3
    ref_step = ref_ctx.decode_one(int(np.argmax(got)))
    assert nmse(torch.from_numpy(step), torch.from_numpy(ref_step)) < 5e-3
    assert ids.shape == (1, 4)


# -- the microbenchmark's probe kernels (csrc/qmm_bench.cu) ----------------------

BENCH_SHAPES = [(4096, 28672), (14336, 4096), (4096, 6144), (2048, 512), (1024, 256)]


def bench_planes(device, K, O, seed=0, rows=8):
    """Even/odd packed planes with every byte value (high nibbles 8..15 make
    negative int8 bytes), f32 scales and mins, and x."""
    rng = np.random.default_rng(seed)
    qp = torch.from_numpy(rng.integers(0, 256, (K // 2, O), np.uint8).view(np.int8))
    sc = torch.from_numpy((rng.normal(size=(K // 32, O)) * 0.05).astype(np.float32))
    mn = torch.from_numpy((rng.normal(size=(K // 32, O)) * 0.1).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(rows, K)).astype(np.float32)).to(torch.bfloat16)
    return tuple(t.to(device) for t in (x, qp, sc, mn))


@pytest.mark.parametrize("K,O", BENCH_SHAPES)
def test_stream_planes_kernel_matches_plain(cuda_device, K, O):
    """The stream probe against its plain version; f32 sums of up to 42
    values of magnitude up to 128 in another order: rtol 1e-5, atol 1e-4."""
    x, qp, sc, mn = bench_planes(cuda_device, K, O, seed=K + O)
    before = tqb.launches["stream_planes"]
    got = tqb.stream_planes(x, qp, sc, mn, group=32)
    torch.cuda.synchronize()
    assert tqb.launches["stream_planes"] == before + 1
    ref = tqb.stream_planes_plain(x, qp, sc, mn, group=32)
    assert got.shape == (8, O)
    assert torch.allclose(got, ref, rtol=1e-5, atol=1e-4)


def test_stream_planes_kernel_other_tile(cuda_device):
    """tk2 is part of the function: 512-row tiles sum other rows than 1024."""
    x, qp, sc, mn = bench_planes(cuda_device, 4096, 512, seed=3)
    a = tqb.stream_planes(x, qp, sc, mn, group=32, tk2=512)
    b = tqb.stream_planes(x, qp, sc, mn, group=32, tk2=1024)
    torch.cuda.synchronize()
    assert torch.allclose(a, tqb.stream_planes_plain(x, qp, sc, mn, group=32, tk2=512),
                          rtol=1e-5, atol=1e-4)
    assert not torch.allclose(a, b)


@pytest.mark.parametrize("K,O", [s for s in BENCH_SHAPES if s[0] % 2048 == 0])
def test_qmm4_variant_kernels_match_plain_and_each_other(cuda_device, K, O):
    """Both unpacks against the plain version (NMSE < 1e-4: a group's sum is
    scaled in f32 where the plain version rounds W to bf16, near 1e-6), and
    equal to the bit: the same integers in the same summation order."""
    x, qp, sc, mn = bench_planes(cuda_device, K, O, seed=K + O, rows=16)
    fp = tqb.qmm4_variant(x, qp, sc, mn, group=32, unpack="fp")
    i16 = tqb.qmm4_variant(x, qp, sc, mn, group=32, unpack="i16")
    torch.cuda.synchronize()
    ref = tqb.qmm4_variant_plain(x, qp, sc, mn, group=32)
    assert nmse(i16, ref) < 1e-4
    assert torch.equal(fp, i16)


@pytest.mark.parametrize("to,tk", [(128, 256), (256, 1024), (512, 2048), (512, 512),
                                   (1024, 1024), (2048, 2048), (2048, 512), (128, 4096)])
@pytest.mark.parametrize("K,O", [(4096, 28672), (14336, 4096), (4096, 6144), (4096, 128256)])
def test_qmm_tiled_kernels_match_plain(cuda_device, K, O, to, tk):
    """The tile sweep, flat and tile by tile, is one function: every tile the
    kernel takes against the plain version, and the two layouts against each
    other (same stages, same order: equal bits). The wrapper raises on a tile
    that does not divide the shape: the 4096 x 128256 vocab head takes only
    128 and 256 columns a block."""
    x, qp, sc, mn = bench_planes(cuda_device, K, O, seed=to + tk)
    if tqb.tile_unsupported(8, to, tk, K, O):  # the tile does not divide the shape
        with pytest.raises(ValueError):
            tqb.qmm_tiled(x, qp, sc, mn, group=32, tn=8, to=to, tk=tk)
        return
    flat = tqb.qmm_tiled(x, qp, sc, mn, group=32, tn=8, to=to, tk=tk)
    q4, sc4, mn4 = tqb.tile_planes_4d(qp, sc, mn, to, tk)
    tiled = tqb.qmm_tiled4d(x, q4, sc4, mn4, group=32, to=to, tk=tk)
    torch.cuda.synchronize()
    ref = tqb.qmm4_variant_plain(x, qp, sc, mn, group=32)
    assert nmse(flat, ref) < 1e-4
    assert torch.equal(flat, tiled)


def test_qmm_bench_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    x, qp, sc, mn = bench_planes(cuda_device, 2048, 512)
    with pytest.raises(ValueError):
        tqb.qmm4_variant(x[:4], qp, sc, mn, group=32)  # rows not a multiple of 8
    with pytest.raises(ValueError):
        tqb.qmm4_variant(x, qp, sc, mn, group=16)
    with pytest.raises(ValueError):
        tqb.qmm_tiled(x, qp, sc, mn, group=32, tn=16, to=512, tk=2048)
    with pytest.raises(ValueError):
        tqb.qmm_tiled(x, qp, sc, mn, group=32, tn=8, to=64, tk=2048)
    with pytest.raises(ValueError):
        tqb.qmm4_variant(x.float(), qp, sc, mn, group=32)
    with pytest.raises(ValueError):
        tqb.stream_planes(x, qp[:, :128], sc[:, :128], mn[:, :128], group=32)  # not contiguous
    with pytest.raises(ValueError):
        tqb.qmm4_variant(x, qp.cpu(), sc, mn, group=32)
