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
from llama_cpp_tpu_torch.runtime.context import Context
from llama_cpp_tpu_torch.testing import make_bench_llama_gguf, synth_quant_bytes

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
    args, _, page = paged_case(cuda_device, D=64)
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
    assert all(n > 0 for n in tfa.launches.values())
    assert tqmm.launches["qmm4_planes_prefill/mma"] > 0
    assert tqmm.launches["qmm_planes/gemv"] > 0
    ref_ctx = Context(model, n_ctx=512, n_seqs=4, n_ubatch=128, quantized_kv=quantized_kv,
                      kernels=False)
    ref = ref_ctx.prefill(prompt)
    assert nmse(torch.from_numpy(got), torch.from_numpy(ref)) < 5e-3
    assert ids.shape == (1, 4)
