"""Card-only tests of the PyTorch port: each CUDA kernel against its plain
PyTorch version, and the main path's kernel route against its plain route,
on a small model. They skip without an NVIDIA GPU. This file imports nothing
of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from llama_cpp_tpu_torch.gguf.constants import GGML_BLOCK_LAYOUT, GGMLType
from llama_cpp_tpu_torch.models.loader import load_model
from llama_cpp_tpu_torch.ops import qtensor as tq
from llama_cpp_tpu_torch.ops.kernels import flash_attn as tfa
from llama_cpp_tpu_torch.ops.kernels import qmm as tqmm
from llama_cpp_tpu_torch.ops.kernels import qmm_bench as tqb
from llama_cpp_tpu_torch.ops.kernels import qmm_expert as tqe
from llama_cpp_tpu_torch.runtime import decode_graph
from llama_cpp_tpu_torch.runtime.context import Context
from llama_cpp_tpu_torch.runtime.decode_graph import DeviceSampler
from llama_cpp_tpu_torch.quant.repack import PLANE_TYPES
from llama_cpp_tpu_torch.testing import (make_bench_llama_gguf, make_bench_moe_gguf,
                                         make_bench_qwen3_gguf, synth_quant_bytes)

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


def fa_launches(name):
    """Launches of both CUDA kernels (prefill and decode) of an attention
    kernel's layout."""
    return tfa.launches[f"{name}/prefill"] + tfa.launches[f"{name}/decode"]


@pytest.mark.parametrize("n", [1, 3, 5, 8, 16, 32, 64, 512])
@pytest.mark.parametrize("qtype,K", [(GGMLType.Q4_K, 1024), (GGMLType.Q6_K, 1024),
                                     (GGMLType.Q4_K, 768), (GGMLType.Q6_K, 768)],
                         ids=["q4_k", "q6_k", "q4_k_flat", "q6_k_flat"])
def test_qmm_kernel_matches_plain(cuda_device, qtype, K, n):
    """The kernel each row count is routed to (the decode kernel below 64
    rows, the wgmma GEMM from 64) against the plain version, on
    hierarchical planes (K % 512 == 0) and flat f32 scales (K = 768).
    NMSE < 1e-4: the decode kernel skips the plain version's bf16 rounding
    of W up to 8 rows (near 1e-6) and rounds scale and min to bf16 above
    (near 1e-5), the wgmma GEMM rounds packed planes' scale and min to bf16
    first (near 1e-5 on these planes)."""
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


PLANE_TYPE_LIST = sorted(PLANE_TYPES, key=int)


@pytest.mark.parametrize("n", [1, 8, 64])
@pytest.mark.parametrize("qtype", PLANE_TYPE_LIST, ids=[t.name.lower() for t in PLANE_TYPE_LIST])
def test_qmm_kernel_on_every_plane_type(cuda_device, qtype, n):
    """Every storage type with planes, as load_weight lays it out from
    synthetic blocks (hierarchical for the six superblock types at K =
    1024, nibble-packed where the values span 16 levels), through the
    kernel its row count is routed to, against the plain version: NMSE <
    1e-4 as above."""
    O, K = 384, 1024
    rng = np.random.default_rng(int(qtype) + n)
    raw = np.frombuffer(synth_quant_bytes(rng, O * K, qtype), np.uint8)
    w = tq.load_weight(raw, qtype, (O, K), transpose=True, device=cuda_device)
    assert tqmm.dispatches(w) and tqmm.supported(w)
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    x = torch.randn((n, K), generator=gen, device=cuda_device).to(torch.bfloat16)
    name = tqmm.kernel_name(w, n)
    before = tqmm.launches[name]
    got = tqmm.qmm(x, w)
    torch.cuda.synchronize()
    assert tqmm.launches[name] == before + 1
    assert got.shape == (n, O) and torch.isfinite(got).all()
    assert nmse(got, tqmm.qmm_plain(x, w)) < 1e-4


@pytest.mark.parametrize("R", [1, 8, 64])
def test_expert_kernel_on_q8_0_stacks(cuda_device, R):
    """K7 on a Q8_0 expert stack (int8, flat f32 scales, groups of 32, no
    mins) as the loader lays it out, against its plain version."""
    E, O, K = 16, 256, 512
    rng = np.random.default_rng(R)
    raw = np.frombuffer(synth_quant_bytes(rng, E * O * K, GGMLType.Q8_0), np.uint8)
    w = tq.load_weight(raw, GGMLType.Q8_0, (E, O, K), transpose=True, device=cuda_device)
    assert tqe.supported(w) and w.group == 32 and w.mins is None
    gen = torch.Generator(device=cuda_device).manual_seed(R)
    x = torch.randn((R, K), generator=gen, device=cuda_device).to(torch.bfloat16)
    ids = torch.randint(0, E, (R,), generator=gen, device=cuda_device, dtype=torch.int32)
    before = tqe.launches["qmm_planes_expert"]
    got = tqe.qmm_expert(x, ids, w)
    torch.cuda.synchronize()
    assert tqe.launches["qmm_planes_expert"] == before + 1
    assert nmse(got, tqe.qmm_expert_plain(x, ids, w)) < 1e-4


@pytest.mark.parametrize("t, shape", [(GGMLType.Q4_K, (9, 512, 2048)),
                                      (GGMLType.Q6_K, (9, 2048, 512)),
                                      (GGMLType.Q8_0, (9, 192, 2880)),
                                      (GGMLType.MXFP4, (9, 2880, 2880))],
                         ids=["q4_k", "q6_k", "q8_0", "mxfp4"])
def test_expert_stacks_cut_on_the_card_equal_the_host_planes(cuda_device, monkeypatch, t,
                                                             shape):
    """load_weight cuts a transposed expert stack's planes on the card
    (quant/device_planes.py), four experts a pass here: the same planes,
    scales and mins as the host's extraction."""
    from llama_cpp_tpu_torch.quant import device_planes

    lay = GGML_BLOCK_LAYOUT[t]
    monkeypatch.setattr(device_planes, "CHUNK_BYTES",
                        4 * shape[1] * shape[2] // lay.block_size * lay.type_size)
    raw = np.frombuffer(synth_quant_bytes(np.random.default_rng(int(t)), int(np.prod(shape)), t),
                        np.uint8)
    w = tq.load_weight(raw, t, shape, transpose=True, device=cuda_device)
    ref = tq.load_weight(raw, t, shape, transpose=True)
    assert w.q.is_cuda and w.group == ref.group and (w.mins is None) == (ref.mins is None)
    assert torch.equal(w.q.cpu(), ref.q) and torch.equal(w.scales.cpu(), ref.scales)
    assert w.mins is None or torch.equal(w.mins.cpu(), ref.mins)


@pytest.mark.parametrize("t,shape", [(GGMLType.Q4_K, (768, 4096)), (GGMLType.Q6_K, (768, 4096)),
                                     (GGMLType.Q4_K, (2048, 256)), (GGMLType.Q8_0, (768, 4096)),
                                     (GGMLType.Q4_0, (768, 4096)), (GGMLType.Q5_0, (768, 4096)),
                                     (GGMLType.MXFP4, (768, 4096))],
                         ids=["q4_k", "q6_k", "q4_k_flat", "q8_0", "q4_0", "q5_0", "mxfp4"])
@pytest.mark.parametrize("transpose", [True, False], ids=["matmul", "table"])
def test_matrices_cut_on_the_card_equal_the_host_planes(cuda_device, monkeypatch, t, shape,
                                                        transpose):
    """load_weight cuts a 2-D matrix's planes on the card (quant/
    device_planes.py), a few rows a pass through the pinned buffers here:
    every field (q, the flat or hierarchical scales and mins, the nibble
    packing) bit for bit the host's extraction."""
    from llama_cpp_tpu_torch.quant import device_planes

    monkeypatch.setattr(device_planes, "CHUNK_BYTES", 1 << 20)
    raw = np.frombuffer(synth_quant_bytes(np.random.default_rng(int(t)), int(np.prod(shape)), t),
                        np.uint8)
    w = tq.load_weight(raw, t, shape, transpose=transpose, device=cuda_device)
    ref = tq.load_weight(raw, t, shape, transpose=transpose)
    assert w.q.is_cuda and (w.packed, w.group, w.sgroup) == (ref.packed, ref.group, ref.sgroup)
    for f in ("q", "scales", "mins", "d", "dmin"):
        a, b = getattr(w, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        assert a is None or (a.dtype == b.dtype and torch.equal(a.cpu(), b)), f


@pytest.mark.parametrize("t,shape,transpose", [(GGMLType.Q4_K, (768, 4096), True),
                                               (GGMLType.Q8_0, (768, 4096), False),
                                               (GGMLType.Q6_K, (6, 2048, 512), True)],
                         ids=["q4_k", "q8_0_table", "q6_k_stack"])
def test_planes_cut_on_a_card_that_is_not_the_current_one(cuda_device, monkeypatch, t, shape,
                                                          transpose):
    """A load onto the second card while the first is current, a few rows
    (one expert) a pass: the raw blocks' copies and the events that free
    the pinned buffers go on the target card's stream, so each buffer is
    refilled only after its copy has read it, and the planes equal the
    host's."""
    from llama_cpp_tpu_torch.quant import device_planes

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    lay = GGML_BLOCK_LAYOUT[t]
    row = shape[-1] // lay.block_size * lay.type_size
    monkeypatch.setattr(device_planes, "CHUNK_BYTES", row * (shape[1] if len(shape) == 3 else 4))
    raw = np.frombuffer(synth_quant_bytes(np.random.default_rng(int(t)), int(np.prod(shape)), t),
                        np.uint8)
    ref = tq.load_weight(raw, t, shape, transpose=transpose)
    with torch.cuda.device(0):
        w = tq.load_weight(raw, t, shape, transpose=transpose, device="cuda:1")
    assert w.q.device == torch.device("cuda:1")
    for f in ("q", "scales", "mins", "d", "dmin"):
        a, b = getattr(w, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        assert a is None or torch.equal(a.cpu(), b), f


def test_heads_wider_than_the_kernels_refuse_by_name(cuda_device, tmp_path):
    """Full heads of 512 (Gemma 4's full layers at full width): the JAX
    package's kernel takes them, the port's attention kernels have no such
    instantiation, so a prefill on the card raises naming the head dims the
    kernels take instead of running the plain attention."""
    from llama_cpp_tpu_torch.testing import make_bench_gemma4_gguf

    path = make_bench_gemma4_gguf(str(tmp_path / "g4.gguf"), n_layers=2, n_embd=256,
                                  n_heads=2, n_kv_heads=1, head_dim=512, head_dim_swa=128,
                                  n_ff=512, vocab_size=512, is_swa=(1, 0), sliding_window=64,
                                  shared_kv_layers=0, n_embd_per_layer=0, n_expert=0,
                                  moe_layers=(), alt_v_layers=())
    ctx = Context(load_model(path), n_ctx=512, n_seqs=1, n_ubatch=128, quantized_kv=True)
    with pytest.raises(ValueError, match=r"head dims alike in \(32, 64, 128, 256\)"):
        ctx.prefill(list(range(3, 40)))


@pytest.mark.parametrize("ftype", ["q8_0", "q5_k_m", "q4_0"])
def test_new_file_types_kernel_route_matches_plain_route(cuda_device, tmp_path, ftype):
    """A small Qwen3 model at each new file type: prefill and greedy decode
    through the kernels against Context(kernels=False); the products go
    through the kernels of the file's planes (int8 for Q8_0 and Q5_K_M,
    packed for Q4_0's layers)."""
    path = make_bench_qwen3_gguf(str(tmp_path / "m.gguf"), n_layers=2, n_embd=512, n_heads=4,
                                 n_kv_heads=2, head_dim=128, n_ff=1024, vocab_size=1024,
                                 ftype=ftype)
    model = load_model(path)
    prompt = [int(t) for t in np.random.default_rng(2).integers(3, 1024, 200)]
    for key in tqmm.launches:
        tqmm.launches[key] = 0
    ctx = Context(model, n_ctx=512, n_seqs=2, n_ubatch=128, quantized_kv=True)
    got = ctx.prefill(prompt)
    ids = ctx.generate(prompt, 8, seq=1)
    packed = ftype == "q4_0"
    assert tqmm.launches["qmm_planes/decode"] > 0
    assert (tqmm.launches["qmm4_planes/decode"] > 0) == packed
    assert (tqmm.launches["qmm4_planes_prefill/wgmma"] > 0) == packed
    assert (tqmm.launches["qmm_planes_prefill/wgmma"] > 0) == (not packed)
    ref_ctx = Context(model, n_ctx=512, n_seqs=2, n_ubatch=128, quantized_kv=True,
                      kernels=False)
    assert nmse(torch.from_numpy(got), torch.from_numpy(ref_ctx.prefill(prompt))) < 5e-3
    assert ids == ref_ctx.generate(prompt, 8, seq=1)


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


@pytest.mark.parametrize("packed,group,hier,mins", [
    (True, 16, True, True), (True, 16, False, False), (False, 32, True, False),
    (False, 32, False, True), (True, 32, False, True), (False, 16, False, False)],
    ids=["p16_hier_mins", "p16_flat", "i32_hier", "i32_flat_mins", "p32_flat_mins",
         "i16_flat"])
def test_qmm_kernel_every_layout(cuda_device, packed, group, hier, mins):
    """Each plane layout the JAX dispatch sends to its kernel, through the
    decode kernel at 1-8 rows."""
    w = synth_planes(cuda_device, packed, group, hier, mins)
    assert tqmm.dispatches(w) and tqmm.supported(w)
    for n in (1, 2, 4, 8):
        x = torch.randn((n, 512), device=cuda_device).to(torch.bfloat16)
        got = tqmm.qmm(x, w)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        assert nmse(got, tqmm.qmm_plain(x, w)) < 1e-4, n


PREFILL_LAYOUTS = {
    "p16_hier_mins": (True, 16, True, True), "p16_flat": (True, 16, False, False),
    "i32_hier": (False, 32, True, False), "i32_flat_mins": (False, 32, False, True),
    "p32_flat_mins": (True, 32, False, True), "i16_flat": (False, 16, False, False),
    "p32_hier_mins": (True, 32, True, True), "i16_hier": (False, 16, True, False)}


@pytest.mark.parametrize("layout", list(PREFILL_LAYOUTS))
def test_qmm_wgmma_kernel_every_layout(cuda_device, layout):
    """The wgmma prefill GEMM at ragged and full ubatches (64, 65, 200, 512
    and 1023 rows) on every plane layout the kernel takes, the two of the
    Q4_K/Q6_K main path included: NMSE < 1e-4 from the plain version (packed
    planes' scale and min are rounded to bf16 before W, near 1e-5 on these
    random planes; int8 planes round W as the plain version does)."""
    w = synth_planes(cuda_device, *PREFILL_LAYOUTS[layout])
    assert tqmm.dispatches(w) and tqmm.supported(w)
    name = ("qmm4_planes" if w.packed else "qmm_planes") + "_prefill/wgmma"
    for n in (64, 65, 200, 512, 1023):
        x = torch.randn((n, 512), device=cuda_device).to(torch.bfloat16)
        before = tqmm.launches[name]
        got = tqmm.qmm(x, w)
        torch.cuda.synchronize()
        assert tqmm.launches[name] == before + 1
        assert got.shape == (n, 256) and torch.isfinite(got).all()
        assert nmse(got, tqmm.qmm_plain(x, w)) < 1e-4, n


@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q6_K], ids=["q4_k", "q6_k"])
def test_qmm_wgmma_kernel_deep_k(cuda_device, qtype):
    """K = 14336 x O = 4096 (an 8B ffn_down) at 512 and 200 rows: 64-bit
    plane offsets, and split-K where the plan splits."""
    rng = np.random.default_rng(int(qtype))
    K, O = 14336, 4096
    raw = np.frombuffer(synth_quant_bytes(rng, O * K, qtype), np.uint8)
    w = tq.load_weight(raw, qtype, (O, K), transpose=True, device=cuda_device)
    for n in (512, 200):
        x = torch.randn((n, K), device=cuda_device).to(torch.bfloat16)
        got = tqmm.qmm(x, w)
        torch.cuda.synchronize()
        assert nmse(got, tqmm.qmm_plain(x, w)) < 1e-4, n


DECODE_ROWS = (1, 2, 3, 4, 5, 7, 8, 9, 16, 17, 32, 33, 63)


def one_split_plan(n, K, O, packed, group=None):
    """The decode kernel's grid with K unsplit (no partial sums)."""
    units = (K // 2 if packed else K) // 64
    return tqmm.DecodePlan(O // 128, 1, units, tqmm.decode_tiles(n), "")


@pytest.mark.parametrize("layout", list(PREFILL_LAYOUTS))
def test_qmm_decode_kernel_every_layout(cuda_device, monkeypatch, layout):
    """The decode kernel at every row count class (1-63: one, two,
    four and eight n-tiles, full and ragged) on every plane layout it takes:
    NMSE < 1e-4 from the plain version (up to 8 rows q stays exact and the
    scale f32, where the plain version rounds W to bf16: near 1e-6; from 9
    rows W is formed from a bf16 scale and min: near 1e-5). A second launch
    agrees to the bit (the partial sums add in a fixed order), and one split
    (no partial sums) within summation order."""
    w = synth_planes(cuda_device, *PREFILL_LAYOUTS[layout])
    assert tqmm.dispatches(w) and tqmm.supported(w)
    name = ("qmm4_planes" if w.packed else "qmm_planes") + "/decode"
    for n in DECODE_ROWS:
        x = torch.randn((n, 512), device=cuda_device).to(torch.bfloat16)
        before = tqmm.launches[name]
        got = tqmm.qmm(x, w)
        torch.cuda.synchronize()
        assert tqmm.launches[name] == before + 1
        assert got.shape == (n, 256) and torch.isfinite(got).all()
        assert nmse(got, tqmm.qmm_plain(x, w)) < 1e-4, n
        assert torch.equal(tqmm.qmm(x, w), got), n
        with monkeypatch.context() as m:
            m.setattr(tqmm, "decode_plan", one_split_plan)
            assert nmse(tqmm.qmm(x, w), got) < 1e-10, n


DECODE_SHAPES = {"deep_k": (GGMLType.Q4_K, 14336, 4096), "deep_k_q6": (GGMLType.Q6_K, 14336, 4096),
                 "narrow_o": (GGMLType.Q6_K, 4096, 1024), "narrow_o_q4": (GGMLType.Q4_K, 4096, 1024)}


@pytest.mark.parametrize("shape", list(DECODE_SHAPES))
def test_qmm_decode_kernel_main_path_shapes(cuda_device, shape):
    """K = 14336 (an 8B ffn_down: 64-bit plane offsets, the longest split)
    and O = 1024 (an 8B attn_v: 8 column blocks, the most splits) at 1, 8,
    32 and 63 rows."""
    qtype, K, O = DECODE_SHAPES[shape]
    rng = np.random.default_rng(K + O + int(qtype))
    raw = np.frombuffer(synth_quant_bytes(rng, O * K, qtype), np.uint8)
    w = tq.load_weight(raw, qtype, (O, K), transpose=True, device=cuda_device)
    assert tqmm.decode_plan(8, K, O, w.packed).splits > 1
    for n in (1, 8, 32, 63):
        x = torch.randn((n, K), device=cuda_device).to(torch.bfloat16)
        got = tqmm.qmm(x, w)
        torch.cuda.synchronize()
        assert nmse(got, tqmm.qmm_plain(x, w)) < 1e-4, n


def test_qmm_decode_kernel_vocab_head(cuda_device):
    """The 4096 x 128256 Q6_K head, padded to 131072 columns (1024 column
    blocks, more than a wave): the padded columns are cut off."""
    rng = np.random.default_rng(3)
    V, K = 128256, 4096
    raw = np.frombuffer(synth_quant_bytes(rng, V * K, GGMLType.Q6_K), np.uint8)
    w = tq.pad_out_features(tq.load_weight(raw, GGMLType.Q6_K, (V, K), transpose=True,
                                           device=cuda_device))
    assert w.q.shape == (K, 131072) and w.out_features == V
    wd = w.dequant(torch.bfloat16).float()
    for n in (1, 8, 32):
        x = torch.randn((n, K), device=cuda_device).to(torch.bfloat16)
        got = tqmm.qmm(x, w)
        torch.cuda.synchronize()
        assert got.shape == (n, V)
        assert nmse(got, x.float() @ wd) < 1e-4, n


@pytest.mark.parametrize("what", ["group_64", "sgroup_512", "o_not_128", "k_not_256",
                                  "row_major", "stacked"])
def test_qmm_decode_raises_on_layouts_it_does_not_take(cuda_device, what):
    """Each layout outside `supported` raises on a CUDA tensor at decode
    rows instead of running anything."""
    w = synth_planes(cuda_device, True, 32, True, True)
    K = 512
    if what == "group_64":
        w = tq.QuantTensor(q=w.q, scales=w.scales[::2].contiguous(), mins=None, group=64,
                           ggml_type=w.ggml_type, transposed=True, packed=True)
    elif what == "sgroup_512":
        w = tq.QuantTensor(q=w.q, scales=w.scales, mins=w.mins, group=32, ggml_type=w.ggml_type,
                           transposed=True, packed=True, d=w.d[:1].contiguous(),
                           dmin=w.dmin[:1].contiguous(), sgroup=512)
    elif what == "o_not_128":
        w = synth_planes(cuda_device, False, 16, False, False, O=192)
    elif what == "k_not_256":
        K = 384
        w = synth_planes(cuda_device, False, 16, False, False, K=384)
    elif what == "row_major":
        w = tq.QuantTensor(q=w.q.t().contiguous(), scales=w.scales, mins=None, group=32,
                           ggml_type=w.ggml_type, transposed=False, packed=False)
        K = w.in_features
    elif what == "stacked":
        w = tq.QuantTensor(q=w.q[None].contiguous(), scales=w.scales[None].float(), mins=None,
                           group=32, ggml_type=w.ggml_type, transposed=True, packed=True)
    x = torch.zeros((3, K), device=cuda_device, dtype=torch.bfloat16)
    before = dict(tqmm.launches)
    with pytest.raises(ValueError):
        tqmm.qmm(x, w)
    assert tqmm.launches == before


def test_qmm_decode_smem_matches_the_planner(cuda_device):
    """The planner's copy of the decode kernel's shared-memory layout
    (ops/kernels/qmm.py decode_smem) equals the kernel's own."""
    import ctypes

    from llama_cpp_tpu_torch.ops.kernels import build

    fn = build.library("qmm_decode.cu").qmm_decode_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    for nt in (1, 2, 4, 8):
        for packed in (True, False):
            for group in (16, 32):
                assert fn(nt, int(packed), group) == tqmm.decode_smem(nt, packed, group)[1]


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
    mp = max(4, max(-(-(dep + T) // page) for dep in depths) + 1)
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
    key = f"flash_attention_paged/{tfa.route(args[0].shape[2])}"
    before = tfa.launches[key]
    got = tfa.flash_attention_paged(*args, sinks, **kw)
    torch.cuda.synchronize()
    assert tfa.launches[key] == before + 1
    ref = tfa.flash_attention_paged_plain(*args, sinks, **kw)
    valid = args[3] >= 0  # [B, R]
    g, r = got.transpose(1, 2)[valid], ref.transpose(1, 2)[valid]
    assert torch.isfinite(g).all()
    assert nmse(g, r) < 1e-5


def test_paged_attention_raises_on_what_the_kernel_does_not_take(cuda_device):
    args, _, page = paged_case(cuda_device, D=96)  # heads of 32, 64, 128 and 256 run
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
    assert tfa.launches["flash_attention_paged/prefill"] > 0
    assert tfa.launches["flash_attention_paged/decode"] > 0
    assert fa_launches("flash_attention") == 0
    assert tqmm.launches["qmm4_planes_prefill/wgmma"] > 0
    assert tqmm.launches["qmm_planes_prefill/wgmma"] > 0
    assert tqmm.launches["qmm4_planes/decode"] > 0
    assert tqmm.launches["qmm_planes/decode"] > 0
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


@pytest.mark.parametrize("bf16", [False, True], ids=["int8_pool", "bf16_pool"])
@pytest.mark.parametrize("T", [1, 5], ids=["decode", "prefill"])
@pytest.mark.parametrize("D", [32, 256], ids=["d32", "d256"])
def test_paged_attention_kernel_heads_of_32_and_256(cuda_device, D, T, bf16):
    args, sinks, page = paged_case(cuda_device, T=T, D=D, bf16=bf16)
    kw = dict(sm_scale=1.0 / np.sqrt(D), window=96, softcap=2.0, page=page)
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
@pytest.mark.parametrize("D", [64, 128, 32, 256], ids=["d64", "d128", "d32", "d256"])
@pytest.mark.parametrize("window,softcap,use_sinks,T", [
    (0, 0.0, False, 1), (0, 0.0, False, 5), (96, 2.0, True, 5), (64, 0.0, True, 1)],
    ids=["decode", "prefill", "all", "decode_window_sinks"])
def test_slot_attention_kernel_matches_plain(cuda_device, window, softcap, use_sinks, T, D,
                                             bf16, ring):
    args, sinks = slot_case(cuda_device, D=D, T=T, bf16=bf16, ring=ring)
    kw = dict(sm_scale=1.0 / np.sqrt(D), window=window, softcap=softcap, ring=ring)
    sinks = sinks if use_sinks else None
    key = f"flash_attention/{tfa.route(args[0].shape[2])}"
    before = tfa.launches[key]
    got = tfa.flash_attention(*args, sinks, **kw)
    torch.cuda.synchronize()
    assert tfa.launches[key] == before + 1
    ref = tfa.flash_attention_plain(*args, sinks, **kw)
    valid = args[3] >= 0
    g, r = got.transpose(1, 2)[valid], ref.transpose(1, 2)[valid]
    assert torch.isfinite(g).all()
    assert nmse(g, r) < 1e-5


def test_slot_attention_raises_on_what_the_kernel_does_not_take(cuda_device):
    args, _ = slot_case(cuda_device, D=96)
    with pytest.raises(ValueError):
        tfa.flash_attention(*args, sm_scale=0.125)
    args, _ = slot_case(cuda_device)
    with pytest.raises(ValueError):  # an int8 cache without its scales
        tfa.flash_attention(*args[:6], sm_scale=0.125)
    with pytest.raises(ValueError):  # seq_idx must be int32
        tfa.flash_attention(*args[:5], args[5].long(), *args[6:], sm_scale=0.125)


# -- the two attention kernels: routes, head dims, memories, masks -------------

ROUTE_ROWS = {"decode_below": tfa.PREFILL_MIN_ROWS - 1, "prefill_at": tfa.PREFILL_MIN_ROWS}
MASKS = {"causal": dict(window=0, softcap=0.0, sinks=False),
         "window_softcap_sinks": dict(window=96, softcap=2.0, sinks=True)}


def held(fn, plain, args, sinks, kw, mask):
    """One launch of the kernel through its route, against the plain
    version on the valid rows."""
    kw = dict(kw, window=mask["window"], softcap=mask["softcap"])
    sinks = sinks if mask["sinks"] else None
    name = "flash_attention_paged" if fn is tfa.flash_attention_paged else "flash_attention"
    key = f"{name}/{tfa.route(args[0].shape[2])}"
    before = dict(tfa.launches)
    got = fn(*args, sinks, **kw)
    torch.cuda.synchronize()
    assert tfa.launches == {**before, key: before[key] + 1}
    ref = plain(*args, sinks, **kw)
    valid = args[3] >= 0
    g, r = got.transpose(1, 2)[valid], ref.transpose(1, 2)[valid]
    assert torch.isfinite(got).all()
    assert (got.transpose(1, 2)[~valid] == 0).all()  # padding rows come out as 0
    assert nmse(g, r) < 1e-5
    return got


@pytest.mark.parametrize("mask", list(MASKS), ids=list(MASKS))
@pytest.mark.parametrize("rows", list(ROUTE_ROWS), ids=list(ROUTE_ROWS))
@pytest.mark.parametrize("bf16", [False, True], ids=["int8", "bf16"])
@pytest.mark.parametrize("D", [32, 64, 128, 256], ids=["d32", "d64", "d128", "d256"])
def test_paged_attention_routes_every_head_dim(cuda_device, D, bf16, rows, mask):
    """Both kernels of the pool at every head dim and memory type, one row
    below the prefill threshold and at it (one query head a KV head)."""
    args, sinks, page = paged_case(cuda_device, G=1, T=ROUTE_ROWS[rows], D=D, bf16=bf16)
    held(tfa.flash_attention_paged, tfa.flash_attention_paged_plain, args, sinks,
         dict(sm_scale=1.0 / np.sqrt(D), page=page), MASKS[mask])


@pytest.mark.parametrize("mask", list(MASKS), ids=list(MASKS))
@pytest.mark.parametrize("rows", list(ROUTE_ROWS), ids=list(ROUTE_ROWS))
@pytest.mark.parametrize("bf16", [False, True], ids=["int8", "bf16"])
@pytest.mark.parametrize("D", [32, 64, 128, 256], ids=["d32", "d64", "d128", "d256"])
def test_slot_attention_routes_every_head_dim(cuda_device, D, bf16, rows, mask):
    args, sinks = slot_case(cuda_device, D=D, G=1, T=ROUTE_ROWS[rows], bf16=bf16)
    held(tfa.flash_attention, tfa.flash_attention_plain, args, sinks,
         dict(sm_scale=1.0 / np.sqrt(D)), MASKS[mask])


@pytest.mark.parametrize("G,T", [(4, 1), (4, 5), (3, 33), (4, 16), (4, 25), (1, 200)],
                         ids=["r4", "r20", "r99", "r64", "r100", "r200"])
@pytest.mark.parametrize("page", [64, 512], ids=["page64", "page512"])
def test_paged_attention_pages_and_ragged_rows(cuda_device, page, G, T):
    """Pages of one tile and of eight; row counts that fill no whole decode
    row group or prefill row tile."""
    args, sinks, page = paged_case(cuda_device, G=G, T=T, page=page, bf16=False)
    held(tfa.flash_attention_paged, tfa.flash_attention_paged_plain, args, sinks,
         dict(sm_scale=0.088, page=page), MASKS["window_softcap_sinks"])


@pytest.mark.parametrize("T", [1, 16, 50], ids=["decode", "prefill_r64", "prefill_r200"])
@pytest.mark.parametrize("bf16", [False, True], ids=["int8", "bf16"])
def test_slot_attention_ring_both_routes(cuda_device, bf16, T):
    args, sinks = slot_case(cuda_device, T=T, bf16=bf16, ring=True)
    held(tfa.flash_attention, tfa.flash_attention_plain, args, sinks,
         dict(sm_scale=0.088, ring=True), MASKS["window_softcap_sinks"])


@pytest.mark.parametrize("bf16", [False, True], ids=["int8", "bf16"])
def test_decode_splits_agree_and_repeat(cuda_device, monkeypatch, bf16):
    """At decode the live tiles of a deep sequence are split over many
    blocks (B=1, two KV heads); the merge by the last block holds to the
    plain version as one split does (each split rounds its P to bf16 against
    its own running max, so the two differ by that rounding, an NMSE near
    5e-6), and gives the same bits every call."""
    args, sinks, page = paged_case(cuda_device, B=1, G=4, T=1, depths=(1900,), page=512,
                                   bf16=bf16)
    assert tfa.decode_splits(1, 2, 4, 16) > 8
    kw = dict(sm_scale=0.088, window=0, softcap=0.0, page=page)
    many = tfa.flash_attention_paged(*args, sinks, **kw)
    again = tfa.flash_attention_paged(*args, sinks, **kw)
    monkeypatch.setattr(tfa, "decode_splits", lambda *a: 1)
    one = tfa.flash_attention_paged(*args, sinks, **kw)
    torch.cuda.synchronize()
    assert torch.equal(many, again)
    ref = tfa.flash_attention_paged_plain(*args, sinks, **kw)
    assert nmse(many, ref) < 1e-5 and nmse(one, ref) < 1e-5
    assert nmse(many, one) < 2e-5


def test_decode_is_one_launch(cuda_device):
    """One decode call runs one CUDA kernel: the split merge is the last
    block's, not a second kernel's."""
    from torch.profiler import ProfilerActivity, profile

    args, sinks, page = paged_case(cuda_device, B=1, G=4, T=1, depths=(1900,), page=512)
    kw = dict(sm_scale=0.088, page=page)
    tfa.flash_attention_paged(*args, sinks, **kw)  # scratch and counters exist
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tfa.flash_attention_paged(*args, sinks, **kw)
        torch.cuda.synchronize()
    kernels = [(e.key, e.count) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "fa_decode" in kernels[0][0] and kernels[0][1] == 1, kernels


@pytest.mark.parametrize("D", [32, 64, 128, 256], ids=["d32", "d64", "d128", "d256"])
def test_attention_shared_memory_budget(cuda_device, D):
    """Every block fits the card's 227 KB; at heads up to 128 the decode
    kernel fits two blocks an SM (a prefill block of two warpgroups takes
    one)."""
    for prefill in (True, False):
        for bf16 in (True, False):
            b = tfa.smem_bytes(D, prefill, bf16)
            assert 0 < b + 2048 <= 232448
            if D <= 128 and not prefill:
                assert 2 * (b + 3072) <= 233472, (D, prefill, bf16, b)


def expert_case(device, E, K, O, R, g, mins, pick="random"):
    gen = torch.Generator(device=device).manual_seed(E + R)
    q = torch.randint(-127, 128, (E, K, O), generator=gen, device=device, dtype=torch.int8)
    sc = torch.randn((E, K // g, O), generator=gen, device=device) * 0.02
    mn = torch.randn((E, K // g, O), generator=gen, device=device) * 0.01 if mins else None
    w = tq.QuantTensor(q=q, scales=sc, mins=mn, group=g, ggml_type=int(GGMLType.Q4_K),
                       transposed=True)
    x = torch.randn((R, K), generator=gen, device=device).to(torch.bfloat16)
    if pick == "distinct":
        ids = torch.randperm(E, generator=gen, device=device)[:R].to(torch.int32)
    else:
        ids = torch.randint(0, E, (R,), generator=gen, device=device, dtype=torch.int32)
    if pick == "one":
        ids[:] = E - 1
    return x, ids, w


@pytest.mark.parametrize("mins", [False, True], ids=["scales", "scales_mins"])
@pytest.mark.parametrize("E,K,O,R,g,pick", [
    (8, 1024, 512, 2, 32, "random"), (8, 512, 1024, 1, 16, "random"),
    (4, 768, 256, 9, 32, "random"), (128, 256, 384, 64, 16, "random"),
    (2, 2048, 128, 17, 32, "random"), (8, 768, 256, 8, 16, "one"), (8, 2048, 384, 9, 32, "one"),
    (128, 2048, 768, 64, 32, "random"), (16, 768, 2048, 64, 16, "random"),
    (64, 256, 256, 400, 16, "random"), (128, 2048, 768, 8, 32, "distinct"),
    (8, 4096, 1024, 2, 16, "distinct")],
    ids=["top2", "one_row", "shared_experts", "many_experts", "five_rows_an_expert",
         "eight_of_one", "nine_of_one", "qwen3_gate", "qwen3_down_shared", "rows_400",
         "qwen3_top8", "mixtral_top2"])
def test_expert_kernel_matches_plain(cuda_device, E, K, O, R, g, mins, pick):
    """The indexed-expert kernel against its plain version: NMSE < 1e-4 (the
    kernel skips the plain version's bf16 rounding of W). Distinct experts
    keep the first copies the kernel issues before it groups the rows; rows
    that share one (R <= E) make it drop them."""
    x, ids, w = expert_case(cuda_device, E, K, O, R, g, mins, pick)
    before = tqe.launches["qmm_planes_expert"]
    got = tqe.qmm_expert(x, ids, w)
    torch.cuda.synchronize()
    assert tqe.launches["qmm_planes_expert"] == before + 1
    assert got.shape == (R, O) and torch.isfinite(got).all()
    assert nmse(got, tqe.qmm_expert_plain(x, ids, w)) < 1e-4


def test_expert_kernel_past_two_gib_of_planes(cuda_device):
    """A stack of 128 x 2048 x 8320 int8 planes (2.18 GB, so expert 127's
    planes start past 2^31 bytes): the last experts' rows against the plain
    version."""
    E, K, O, g = 128, 2048, 8320, 32
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    q = torch.randint(-127, 128, (E, K, O), generator=gen, device=cuda_device, dtype=torch.int8)
    sc = torch.rand((E, K // g, O), generator=gen, device=cuda_device) * 0.02
    mn = torch.randn((E, K // g, O), generator=gen, device=cuda_device) * 0.01
    w = tq.QuantTensor(q=q, scales=sc, mins=mn, group=g, ggml_type=int(GGMLType.Q4_K),
                       transposed=True)
    assert E * K * O > 2 ** 31
    x = torch.randn((4, K), generator=gen, device=cuda_device).to(torch.bfloat16)
    ids = torch.tensor([127, 0, 126, 127], dtype=torch.int32, device=cuda_device)
    got = tqe.qmm_expert(x, ids, w)
    torch.cuda.synchronize()
    assert nmse(got, tqe.qmm_expert_plain(x, ids, w)) < 1e-4


def test_expert_kernel_is_one_launch_and_repeatable(cuda_device):
    """One call runs one CUDA kernel (the split merge is the last block's),
    the same ids give the same bits twice on one stream (the split counters
    reset themselves), and ids out of [0, E) read the clamped expert."""
    from torch.profiler import ProfilerActivity, profile

    x, ids, w = expert_case(cuda_device, 8, 14336, 512, 2, 16, False)  # split K
    assert tqe.max_splits(2, 14336, 512, tqe.slots(cuda_device, 16, False)) > 1
    first = tqe.qmm_expert(x, ids, w)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        second = tqe.qmm_expert(x, ids, w)
        torch.cuda.synchronize()
    kernels = [(e.key, e.count) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "qmm_expert" in kernels[0][0] and kernels[0][1] == 1, kernels
    assert torch.equal(first, second)
    wild = torch.tensor([-5, 99], dtype=torch.int32, device=cuda_device)
    clamped = torch.tensor([0, 7], dtype=torch.int32, device=cuda_device)
    assert torch.equal(tqe.qmm_expert(x, wild, w), tqe.qmm_expert(x, clamped, w))


def test_expert_kernel_plans_as_its_wrapper(cuda_device):
    """The kernel's split rule is the wrapper's split_count, and the grid's
    slots are two blocks an SM (the shared memory and registers fit)."""
    import ctypes

    lib = tqe._lib()
    lib.qmm_expert_split_count.argtypes = [ctypes.c_int] * 4
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for g in (16, 32):
        for mins in (False, True):
            assert tqe.slots(cuda_device, g, mins) == 2 * sms
    for ct in (1, 6, 16, 32, 112):
        for ng in (1, 2, 8, 16, 50, 64, 300):
            for ku in (4, 12, 32, 64, 224):
                assert lib.qmm_expert_split_count(ct, ng, ku, 264) == tqe.split_count(
                    ct, ng, ku, 264), (ct, ng, ku)


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
    big = tqe.MAX_ROWS + 1
    with pytest.raises(ValueError):  # more rows than the kernel's group table
        tqe.qmm_expert(torch.zeros((big, 256), dtype=torch.bfloat16, device=cuda_device),
                       torch.zeros(big, dtype=torch.int32, device=cuda_device), w)


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
    # three a layer and B = 1 step: decode_one, the graph's warm-up steps and 4 replays
    assert tqe.launches["qmm_planes_expert"] == 3 * 2 * (1 + decode_graph.WARMUP_STEPS + 4)
    assert fa_launches("flash_attention_paged" if paged else "flash_attention") > 0
    assert fa_launches("flash_attention" if paged else "flash_attention_paged") == 0
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


VARIANT_SHAPES = [s for s in BENCH_SHAPES if s[0] % 2048 == 0 and s[1] % 512 == 0]


@pytest.mark.parametrize("rows", [8, 16, 32])
@pytest.mark.parametrize("K,O", VARIANT_SHAPES)
def test_qmm4_variant_kernels_match_plain_and_each_other(cuda_device, K, O, rows):
    """Both unpacks against the plain version (NMSE < 1e-4: a group's sum is
    scaled in f32 where the plain version rounds W to bf16, near 1e-6), and
    equal to the bit: the same integers in the same summation order."""
    x, qp, sc, mn = bench_planes(cuda_device, K, O, seed=K + O, rows=rows)
    fp = tqb.qmm4_variant(x, qp, sc, mn, group=32, unpack="fp")
    i16 = tqb.qmm4_variant(x, qp, sc, mn, group=32, unpack="i16")
    torch.cuda.synchronize()
    ref = tqb.qmm4_variant_plain(x, qp, sc, mn, group=32)
    assert nmse(i16, ref) < 1e-4
    assert torch.equal(fp, i16)


@pytest.mark.parametrize("unpack", ["fp", "i16"])
def test_qmm4_variant_is_one_launch_and_repeatable(cuda_device, unpack):
    """One call runs one CUDA kernel, the B2 kernel (the split merge is the
    last block's), and gives the same bits twice on one stream (the split
    counters reset themselves)."""
    from torch.profiler import ProfilerActivity, profile

    x, qp, sc, mn = bench_planes(cuda_device, 4096, 4096, seed=4)
    assert tqb.variant_plan(8, 4096, 4096).splits > 1
    first = tqb.qmm4_variant(x, qp, sc, mn, group=32, unpack=unpack)
    torch.cuda.synchronize()
    before = tqb.launches[f"qmm4_variant/{unpack}"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        second = tqb.qmm4_variant(x, qp, sc, mn, group=32, unpack=unpack)
        torch.cuda.synchronize()
    kernels = [(e.key, e.count) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "qmm4_variant_kernel" in kernels[0][0], kernels
    assert kernels[0][1] == 1 and tqb.launches[f"qmm4_variant/{unpack}"] == before + 1
    assert torch.equal(first, second)


def test_qmm4_variant_fresh_planes_after_free(cuda_device):
    """Planes freed and made anew with the same shape (the caching allocator
    hands back the same addresses) still match the plain version: a cached
    tensor map holds only what its key holds."""
    for seed in (5, 6, 7):
        x, qp, sc, mn = bench_planes(cuda_device, 4096, 6144, seed=seed, rows=16)
        got = tqb.qmm4_variant(x, qp, sc, mn, group=32, unpack="fp")
        torch.cuda.synchronize()
        assert nmse(got, tqb.qmm4_variant_plain(x, qp, sc, mn, group=32)) < 1e-4
        del x, qp, sc, mn, got


def test_qmm4_variant_plan_matches_the_card(cuda_device):
    """variant_plan's blocks an SM, shared memory and SM count are the
    kernel's on this card."""
    lib = tqb._variant_lib()
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for n in (8, 16, 32):
        p = tqb.variant_plan(n, 4096, 28672)
        assert lib.qmm4_variant_smem_bytes(p.n_tiles) == tqb.variant_smem(p.n_tiles)
        for fp in (0, 1):
            assert lib.qmm4_variant_blocks_per_sm(p.n_tiles, fp) == p.blocks_per_sm
        assert p.slots == p.blocks_per_sm * sms and p.blocks <= p.slots


def test_conformance_sweep_on_the_card(cuda_device):
    """Every row of the reference's sweep through the port's kernel, one
    launch of its route's kernel each, within NMSE 5e-3 of the f64 oracle;
    the MLA rows (K and V heads that differ) through the MLA instantiation."""
    from llama_cpp_tpu_torch.tools import conformance

    rows = conformance.run(cuda_device)
    assert len(rows) == 120
    bad = [r for r in rows if r.status != "PASS"]
    assert not bad, bad
    assert all(r.route == "flash_attention_paged/mla decode" for r in rows
               if r.config.startswith("mla-576"))


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
    x2, qp2, sc2, mn2 = bench_planes(cuda_device, 1024, 256)
    with pytest.raises(ValueError, match="tile"):  # outside the reference's tile (8, 512, 2048)
        tqb.qmm4_variant(x2, qp2, sc2, mn2, group=32)


# -- the decode loop on CUDA graphs (runtime/decode_graph.py) ---------------------

GRAPH_SHAPE = dict(n_layers=2, n_embd=512, n_heads=4, n_kv_heads=2, n_ff=1024, vocab_size=512,
                   seed=0)


@pytest.fixture(scope="module")
def graph_models(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run `python -m pytest --noconftest -m gpu "
                    "tests/test_torch_gpu.py` on the card")
    d = tmp_path_factory.mktemp("graphs")
    llama = load_model(make_bench_llama_gguf(str(d / "m.gguf"), **GRAPH_SHAPE))
    moe = load_model(make_bench_moe_gguf(str(d / "moe.gguf"), n_expert=8, n_expert_used=2,
                                         **GRAPH_SHAPE))
    return {"llama": llama, "moe": moe}


def prefilled(model, n_seqs, graphs, **kw):
    """A context over n_seqs sequences of ragged prompts -> (ctx, first ids)."""
    ctx = Context(model, n_ctx=1024, n_seqs=n_seqs, n_ubatch=128, quantized_kv=True,
                  graphs=graphs, **kw)
    rng = np.random.default_rng(3)
    firsts = [int(np.argmax(ctx.prefill([int(t) for t in rng.integers(3, 512, 40 + 7 * s)],
                                        seq=s))) for s in range(n_seqs)]
    return ctx, np.asarray(firsts, np.int32)


def same_memory(a, b):
    """Equal position labels and equal K/V rows wherever a position is held
    (the trash rows take the graph's warm-up writes, labels included, and
    are not compared)."""
    live = a.kv.pos >= 0
    if not torch.equal(live, b.kv.pos >= 0) or not torch.equal(a.kv.pos[live], b.kv.pos[live]):
        return False
    bufs = list(zip(a.kv.k + a.kv.v, b.kv.k + b.kv.v))
    if a.kv.quantized:
        bufs += list(zip(a.kv.k_scale + a.kv.v_scale, b.kv.k_scale + b.kv.v_scale))
    for x, y in bufs:
        if a.paged:  # [Hkv, S_pool, ...], labels [S_pool]
            x, y = x[:, live], y[:, live]
        else:  # [n_seqs, Hkv, S, ...], labels [n_seqs, S]
            x, y = x.transpose(1, 2)[live], y.transpose(1, 2)[live]
        if not torch.equal(x, y):
            return False
    return bool(live.any())


@pytest.mark.parametrize("B", [1, 8, 32])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slots"])
def test_graphed_ids_equal_eager_ids(graph_models, B, paged):
    """decode_steps_greedy replaying the bucket's graph against the same step
    launched eagerly (graphs=False): equal ids and a bit-equal KV memory."""
    runs = []
    for graphs in (True, False):
        ctx, firsts = prefilled(graph_models["llama"], B, graphs, paged=paged)
        runs.append((ctx, ctx.decode_steps_greedy(firsts, np.arange(B), 16)))
    (g, ids), (e, ref) = runs
    np.testing.assert_array_equal(ids, ref)
    assert same_memory(g, e)
    loop = g.decode_loop(B)
    assert loop.graph is not None and loop.replays == 16
    assert e.decode_loop(B).graph is None


@pytest.mark.parametrize("B", [1, 8])
def test_moe_graphed_ids_equal_eager_ids(graph_models, B):
    """B=1 through the indexed-expert kernel, B=8 through the per-expert
    route, replayed against eager."""
    runs = []
    for graphs in (True, False):
        ctx, firsts = prefilled(graph_models["moe"], B, graphs)
        runs.append((ctx, ctx.decode_steps_greedy(firsts, np.arange(B), 12)))
    (g, ids), (e, ref) = runs
    np.testing.assert_array_equal(ids, ref)
    assert same_memory(g, e) and g.decode_loop(B).replays == 12


def test_hundred_replays_match_eager_and_count_launches(graph_models):
    """100 consecutive replays (the kernels' split counters reset themselves
    across replays); the launch counters count every replay."""
    counts = []
    outs = []
    for graphs in (False, True):
        ctx, firsts = prefilled(graph_models["llama"], 1, graphs)
        for counter in (tqmm.launches, tfa.launches):
            for key in counter:
                counter[key] = 0
        outs.append(ctx.decode_steps_greedy(firsts, np.arange(1), 100))
        counts.append({k: v for c in (tqmm.launches, tfa.launches) for k, v in c.items()})
    np.testing.assert_array_equal(outs[0], outs[1])
    eager, graphed = counts
    assert eager["qmm4_planes/decode"] > 0 and eager["flash_attention_paged/decode"] > 0
    for key, n in eager.items():  # the graph's warm-up steps ran eagerly too
        assert graphed[key] == n // 100 * (100 + decode_graph.WARMUP_STEPS), key


def test_replay_stays_right_after_an_eager_call_grows_the_scratch(graph_models):
    """The graph holds the scratch it was captured with: an eager call on the
    capture stream that grows the indexed-expert kernel's scratch (its work
    and tile counters), then the old buffers freed and their memory
    overwritten, do not change the replay's ids (Mixtral-shaped model, B=1:
    K7 three times a layer)."""
    g, firsts = prefilled(graph_models["moe"], 1, True)
    e, _ = prefilled(graph_models["moe"], 1, False)
    seqs = np.arange(1)
    first = g.decode_steps_greedy(firsts, seqs, 4)
    np.testing.assert_array_equal(first, e.decode_steps_greedy(firsts, seqs, 4))
    loop = g.decode_loop(1)
    key = (torch.device("cuda", torch.cuda.current_device()).index, loop.stream.cuda_stream)
    old = tqe._SCRATCH[key]
    assert all(any(t is h for h in loop.held) for t in old)
    x, ids, w = expert_case(torch.device("cuda"), 64, 256, 1024, 512, 16, True)
    with torch.cuda.stream(loop.stream):
        tqe.qmm_expert(x, ids, w)
    torch.cuda.synchronize()
    assert tqe._SCRATCH[key][1] is not old[1]  # the counters grew
    del old, x, ids, w
    torch.cuda.empty_cache()
    junk = torch.full((1 << 28,), -7.0, device="cuda")  # 1 GiB over the freed memory
    got = g.decode_steps_greedy(first[:, -1], seqs, 12)
    ref = e.decode_steps_greedy(first[:, -1], seqs, 12)
    del junk
    np.testing.assert_array_equal(got, ref)
    assert same_memory(g, e)


def test_reset_drops_the_graphs(graph_models):
    ctx, firsts = prefilled(graph_models["llama"], 1, True)
    ctx.decode_steps_greedy(firsts, np.arange(1), 4)
    old = ctx.decode_loop(1)
    assert old.graph is not None
    ctx.reset()
    assert not ctx._loops
    ref, _ = prefilled(graph_models["llama"], 1, False)
    ctx2, firsts = prefilled(graph_models["llama"], 1, True)
    for c in (ctx, ref):  # the same prompt again on the reset context
        c.reset()
        c.prefill([5, 6, 7, 8], seq=0)
    got = ctx.decode_steps_greedy(np.asarray([9]), np.arange(1), 8)
    np.testing.assert_array_equal(got, ref.decode_steps_greedy(np.asarray([9]), np.arange(1), 8))
    assert ctx.decode_loop(1) is not old and ctx.decode_loop(1).graph is not None


def test_sampled_on_the_card_repeats_and_top_k_one_is_greedy(graph_models):
    ctx, _ = prefilled(graph_models["llama"], 2, True)
    ctx.reset()
    p = [int(t) for t in np.random.default_rng(4).integers(3, 512, 60)]
    runs, replays = [], []
    for seed, k in ((1, 40), (1, 40), (1, 1)):
        runs.append(ctx.generate_ondevice(p, max_new_tokens=24, temp=0.8, top_k=k, seed=seed,
                                          chunk=8))
        loop = ctx.decode_loop(1, DeviceSampler(0.8, k))
        replays.append(loop.replays if loop.graph is not None else None)
        ctx.reset()
    greedy = ctx.generate_ondevice(p, max_new_tokens=24, chunk=8)
    assert runs[0] == runs[1] and runs[2] == greedy
    assert replays == [23, 23, 23]  # the first id comes from the prefill's logits


def test_sampler_draws_on_the_card_follow_the_softmax(cuda_device):
    from scipy import stats

    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -0.5, -1.0, -2.0, 3.0], device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    draws = DeviceSampler(0.7, 0)(logits.expand(20000, 8), gen).cpu().numpy()
    probs = torch.softmax(logits / 0.7, dim=-1).cpu().numpy().astype(np.float64)
    counts = np.bincount(draws, minlength=8)
    assert stats.chisquare(counts, probs / probs.sum() * len(draws)).pvalue > 1e-3


@pytest.mark.parametrize("B", [1, 2, 3, 4, 5, 6, 7, 8])
def test_graphed_server_steps_equal_eager(graph_models, B):
    """The server's one-step calls on the card: decode_step_multi (the
    bucket's LOGITS loop, [B, vocab] f32 to the host) and decode_step_greedy
    (one step of the greedy loop), replayed, against the same calls under
    graphs=False; B of the bucket's rows live, the rest padding."""
    runs = []
    for graphs in (True, False):
        ctx, firsts = prefilled(graph_models["llama"], 8, graphs)
        seqs = np.arange(B)
        logits = [ctx.decode_step_multi(firsts[:B], seqs) for _ in range(2)]
        ids = ctx.decode_step_greedy(np.argmax(logits[-1], axis=-1), seqs)
        runs.append((ctx, logits, ids))
    (g, g_logits, g_ids), (e, e_logits, e_ids) = runs
    for a, b in zip(g_logits, e_logits):
        assert a.shape == (B, 512) and a.dtype == np.float32
        assert nmse(torch.from_numpy(a), torch.from_numpy(b)) < 1e-6
        np.testing.assert_array_equal(np.argmax(a, -1), np.argmax(b, -1))
    np.testing.assert_array_equal(g_ids, e_ids)
    bucket = g._batch_bucket(B)
    multi = g.decode_loop(bucket, decode_graph.LOGITS)
    assert multi.graph is not None and multi.replays == 2 and multi.graph_bytes > 0
    assert g.decode_loop(bucket).replays == 1
    assert e.decode_loop(bucket, decode_graph.LOGITS).graph is None
    assert same_memory(g, e)


def test_capture_holds_while_another_thread_makes_http_requests(graph_models):
    """The port's server on the card: a thread keeps asking /health, /props,
    /slots, /metrics and /tokenize while greedy requests make the scheduler
    capture its B = 1, 2 and 4 graphs; every capture holds, every decode
    step after them is a replay, and each reply equals Context.generate."""
    import json
    import threading
    import urllib.request

    from llama_cpp_tpu_torch.server.app import run_server

    model = graph_models["llama"]
    box, ready = {}, threading.Event()
    server_thread = threading.Thread(target=run_server, args=(model,), daemon=True, kwargs=dict(
        host="127.0.0.1", port=0, n_seqs=4, n_ctx=1024, n_ubatch=128, quantized_kv=True,
        ready=lambda s: (box.setdefault("s", s), ready.set())))
    server_thread.start()
    assert ready.wait(60)
    server = box["s"]
    url = f"http://127.0.0.1:{server.port}"

    def call(path, body=None):
        data = None if body is None else json.dumps(body).encode()
        with urllib.request.urlopen(urllib.request.Request(url + path, data=data),
                                    timeout=120) as r:
            return json.loads(r.read()) if path != "/metrics" else r.read().decode()

    stop, polls = threading.Event(), []

    def poll():
        while not stop.is_set():
            for path in ("/health", "/props", "/slots", "/metrics"):
                polls.append(call(path))
            polls.append(call("/tokenize", {"content": "the cat"}))

    rng = np.random.default_rng(9)
    prompts = [[int(t) for t in rng.integers(3, 512, 30 + 11 * i)] for i in range(4)]
    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    try:
        for n in (1, 2, 4, 4):
            replies = [None] * n

            def ask(i):
                replies[i] = call("/completion", {
                    "prompt": prompts[i], "n_predict": 12, "temperature": 0,
                    "ignore_eos": True, "return_tokens": True, "cache_prompt": False})

            threads = [threading.Thread(target=ask, args=(i,)) for i in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            ref = Context(model, n_ctx=1024, n_ubatch=128, quantized_kv=True, graphs=False)
            for i in range(n):
                want = ref.generate(prompts[i], 12)
                ref.reset()
                assert replies[i]["tokens"] == want
    finally:
        stop.set()
        poller.join(timeout=60)
        server.shutdown()
        server_thread.join(timeout=60)
    assert len(polls) > 10 and not server_thread.is_alive()
    loops = server.app.ctx._loops
    assert {b for b, _ in loops} == {1, 2, 4}
    assert all(loop.graph is not None and loop.replays > 0 for loop in loops.values())


def test_capture_raises_instead_of_falling_back(graph_models, monkeypatch):
    """A step that reads a tensor to the host cannot be captured: on a CUDA
    context the loop raises with the reason. Last in this file: a refused
    capture leaves nothing behind, but nothing after it depends on that."""
    ctx, firsts = prefilled(graph_models["llama"], 1, True)
    forward = Context._forward

    def reads_the_host(self, *a):
        logits = forward(self, *a)
        if float(logits[0, 0]) > 1e30:
            raise AssertionError("unreachable")
        return logits

    monkeypatch.setattr(Context, "_forward", reads_the_host)
    with pytest.raises(RuntimeError, match="could not be captured as a CUDA graph"):
        ctx.decode_steps_greedy(firsts, np.arange(1), 4)
    assert ctx.decode_loop(1).graph is None


@pytest.mark.parametrize("T,n_pos", [(1, 2304), (512, 2048), (3, 700)],
                         ids=["decode_wrapped", "ubatch_wrapped", "decode_unwrapped"])
def test_ring_mode_kernel_matches_plain_at_gemma_shape(cuda_device, T, n_pos):
    """K6 in ring mode (every tile visited: slot order is not position
    order) at a Gemma-3-4B window layer: int8 ring of 1792 slots, 4 KV
    heads of 256, G=2, window 1024; one ring launch a call; NMSE < 1e-4."""
    S, cap, Hkv, D, G, B = 1792, 1791, 4, 256, 2, 3
    gen = torch.Generator(device="cuda").manual_seed(T)
    k = torch.randint(-127, 128, (B, Hkv, S, D), generator=gen, device="cuda", dtype=torch.int8)
    v = torch.randint(-127, 128, (B, Hkv, S, D), generator=gen, device="cuda", dtype=torch.int8)
    ks = torch.rand((B, Hkv, S), generator=gen, device="cuda") * 0.02 + 0.005
    vs = torch.rand((B, Hkv, S), generator=gen, device="cuda") * 0.02 + 0.005
    pos = torch.full((B, S), -1, dtype=torch.int32, device="cuda")
    held = torch.arange(max(0, n_pos - cap), n_pos, dtype=torch.int32, device="cuda")
    pos[:, held.long() % cap] = held
    q = (torch.randn((B, Hkv, G * T, D), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
    rp = (n_pos - T + torch.arange(T, device="cuda", dtype=torch.int32)).repeat(G)
    args = (q, k, v, rp[None].expand(B, G * T).contiguous(), pos,
            torch.tensor([2, 0, 1], dtype=torch.int32, device="cuda"), ks, vs)
    kw = dict(sm_scale=1 / 16, window=1024, ring=True)
    before = dict(tfa.ring_launches)
    got = tfa.flash_attention(*args, **kw)
    torch.cuda.synchronize()
    route = tfa.route(G * T)
    assert tfa.ring_launches[f"flash_attention/{route} ring"] == before[
        f"flash_attention/{route} ring"] + 1
    assert nmse(got, tfa.flash_attention_plain(*args, **kw)) < 1e-4


@pytest.fixture(scope="module")
def family_models(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run `python -m pytest --noconftest -m gpu "
                    "tests/test_torch_gpu.py` on the card")
    from llama_cpp_tpu_torch.testing import make_bench_arch_gguf

    d = tmp_path_factory.mktemp("families")
    shape = dict(n_layers=3, n_embd=1024, n_heads=8, n_kv_heads=4, vocab_size=512)
    return {
        "gemma3": load_model(make_bench_arch_gguf(
            str(d / "gemma3.gguf"), "gemma3", head_dim=256, n_ff=2048, tie=True,
            post_norms=True, qk_norm=True, sliding_window=128, swa_pattern=3,
            rope_base=1e6, rope_base_swa=1e4, rope_linear_factor=8.0, **shape)),
        "qwen3moe": load_model(make_bench_arch_gguf(
            str(d / "qwen3moe.gguf"), "qwen3moe", head_dim=128, n_ff=2048, qk_norm=True,
            n_expert=32, n_expert_used=4, n_ff_exp=512, rope_base=1e6, **shape)),
    }


@pytest.mark.parametrize("family", ["gemma3", "qwen3moe"])
def test_family_kernels_match_plain_and_graphs_match_eager(family_models, family):
    """The kernel path against Context(kernels=False) on a 600-token prefill
    (NMSE < 5e-3; gemma3's window layers wrap their rings of 511 positions), then
    decode_steps_greedy at B=4 graphed against eager: equal ids; gemma3's
    window layers launch K6 in ring mode, qwen3moe's experts K7."""
    model = family_models[family]
    p = [int(t) for t in np.random.default_rng(5).integers(3, 512, 600)]
    kw = dict(n_ctx=1024, n_seqs=4, n_ubatch=128, quantized_kv=True)
    for counter in (tfa.ring_launches, tqe.launches):
        for key in counter:
            counter[key] = 0
    got = Context(model, **kw).prefill(p)
    ref = Context(model, kernels=False, **kw).prefill(p)
    assert nmse(torch.from_numpy(got), torch.from_numpy(ref)) < 5e-3
    runs = []
    for graphs in (True, False):
        ctx, firsts = prefilled(model, 4, graphs)
        runs.append(ctx.decode_steps_greedy(firsts, np.arange(4), 12))
    np.testing.assert_array_equal(runs[0], runs[1])
    if family == "gemma3":
        assert ctx.kv.swa.ring and ctx.kv.swa.n_slots == 512
        assert all(n > 0 for n in tfa.ring_launches.values())
    else:
        assert sum(tqe.launches.values()) > 0


# -- the MLA instantiation: one KV head, K rows of 576 or 640 and V rows of 512, or
# -- K rows of 384 and V rows of 256 (MiniCPM3)

def mla_memory(device, paged, Dk, bf16, fills, n_rows, seed=0, Dv=512):
    """A one-head memory of K rows of Dk and V rows of Dv (int8 with row
    scales, or bf16): the pool [1, n_rows, D] with its position labels, or a
    slot table [len(fills), 1, n_rows, D]; sequence s holds positions 0 ..
    fills[s] - 1."""
    gen = torch.Generator(device=device).manual_seed(seed)
    lead = (1,) if paged else (len(fills), 1)
    shape_k, shape_v = (*lead, n_rows, Dk), (*lead, n_rows, Dv)
    if bf16:
        k = (torch.randn(shape_k, generator=gen, device=device) * 0.5).to(torch.bfloat16)
        v = torch.randn(shape_v, generator=gen, device=device).to(torch.bfloat16)
        ks = vs = None
    else:
        k = torch.randint(-127, 128, shape_k, generator=gen, device=device, dtype=torch.int8)
        v = torch.randint(-127, 128, shape_v, generator=gen, device=device, dtype=torch.int8)
        ks = torch.rand(shape_k[:-1], generator=gen, device=device) * 0.004 + 0.001
        vs = torch.rand(shape_v[:-1], generator=gen, device=device) * 0.02 + 0.005
    return k, v, ks, vs, gen


def mla_paged_case(device, Dk=640, G=16, T=1, bf16=False, page=256, depths=(700, 300, 40),
                   Dv=512):
    B = len(depths)
    mp = max(-(-(d + T) // page) for d in depths) + 1
    n_pages = B * mp + 1
    k, v, ks, vs, gen = mla_memory(device, True, Dk, bf16, depths, n_pages * page, Dv=Dv)
    pos = torch.full((n_pages * page,), -1, dtype=torch.int32)
    table = torch.full((B, mp), n_pages - 1, dtype=torch.int32)
    for b, dep in enumerate(depths):
        n = dep + T
        for j in range(-(-n // page)):
            pid = b * mp + j
            table[b, j] = pid
            cnt = min(page, n - j * page)
            pos[pid * page: pid * page + cnt] = torch.arange(j * page, j * page + cnt,
                                                             dtype=torch.int32)
    q = (torch.randn((B, 1, G * T, Dk), generator=gen, device=device) * 0.5).to(torch.bfloat16)
    row_pos = torch.stack([(dep + torch.arange(T, dtype=torch.int32)).repeat(G)
                           for dep in depths]).to(device)
    row_pos[-1, -1] = -1  # a padding row
    return (q, k, v, row_pos, pos.to(device), table.to(device), ks, vs), dict(page=page)


def mla_slot_case(device, Dk=640, G=16, T=1, bf16=False, S=1024, fills=(300, 129, 40, 700),
                  Dv=512):
    k, v, ks, vs, gen = mla_memory(device, False, Dk, bf16, fills, S, Dv=Dv)
    pos = torch.full((len(fills), S), -1, dtype=torch.int32)
    for s, f in enumerate(fills):
        pos[s, :f] = torch.arange(f, dtype=torch.int32)
    picks = (3, 0, 3)
    seq_idx = torch.tensor(picks, dtype=torch.int32, device=device)
    q = (torch.randn((3, 1, G * T, Dk), generator=gen, device=device) * 0.5).to(torch.bfloat16)
    row_pos = torch.stack([(fills[s] - T + torch.arange(T, dtype=torch.int32)).repeat(G)
                           for s in picks]).to(device)
    row_pos[-1, -1] = -1
    return (q, k, v, row_pos, pos.to(device), seq_idx, ks, vs), {}


MLA_ROWS = {"decode16": (16, 1), "decode48": (16, 3), "prefill128": (16, 8),
            "v3_decode128": (128, 1)}  # (G, T)


def mla_held(paged, args, kw, Dk):
    fn = tfa.flash_attention_paged if paged else tfa.flash_attention
    plain = tfa.flash_attention_paged_plain if paged else tfa.flash_attention_plain
    name = "flash_attention_paged" if paged else "flash_attention"
    key = f"{name}/mla {tfa.route(args[0].shape[2])}"
    sm = 3.0 / np.sqrt(Dk)
    before = dict(tfa.launches)
    got = fn(*args, sm_scale=sm, **kw)
    torch.cuda.synchronize()
    assert tfa.launches == {**before, key: before[key] + 1}
    ref = plain(*args, sm_scale=sm, **kw)
    valid = args[3] >= 0
    g, r = got.transpose(1, 2)[valid], ref.transpose(1, 2)[valid]
    assert got.shape[-1] == args[2].shape[-1] and torch.isfinite(got).all()
    assert (got.transpose(1, 2)[~valid] == 0).all()
    assert nmse(g, r) < 1e-5
    return got


@pytest.mark.parametrize("rows", list(MLA_ROWS), ids=list(MLA_ROWS))
@pytest.mark.parametrize("bf16", [False, True], ids=["int8", "bf16"])
@pytest.mark.parametrize("Dk", [576, 640], ids=["dk576", "dk640"])
@pytest.mark.parametrize("paged", [True, False], ids=["pool", "slots"])
def test_mla_kernel_matches_plain(cuda_device, paged, Dk, bf16, rows):
    """Each MLA instantiation (pool and slot table, Dk 576 and 640, int8 and
    bf16, the 16-row and 64-row decode blocks and the prefill route) against
    its plain version, one launch of its route's kernel; NMSE < 1e-5 (p *
    v_scale rounded to bf16 against the plain version's f32)."""
    G, T = MLA_ROWS[rows]
    make = mla_paged_case if paged else mla_slot_case
    args, kw = make(cuda_device, Dk=Dk, G=G, T=T, bf16=bf16)
    mla_held(paged, args, kw, Dk)


# MiniCPM3-4B's rows: 40 query heads on the one KV head; (G, T)
MLA_384_ROWS = {"decode1": (1, 1), "decode8": (8, 1), "decode40": (40, 1),
                "prefill_ubatch": (40, 512)}


@pytest.mark.parametrize("rows", list(MLA_384_ROWS), ids=list(MLA_384_ROWS))
@pytest.mark.parametrize("bf16", [False, True], ids=["int8", "bf16"])
@pytest.mark.parametrize("paged", [True, False], ids=["pool", "slots"])
def test_mla_384_256_matches_plain(cuda_device, paged, bf16, rows):
    """The (384, 256) instantiation (MiniCPM3: kv_lora_rank 256, 32 rope
    dims padded to 384) at 1, 8 and 40 decode rows (40: no multiple of the
    16-row block, the 64-row block holds them with 24 rows past R) and a
    prefill ubatch of 40 heads x 512 tokens, on the pool and the slot table,
    int8 and bf16, against its plain version; NMSE < 1e-5, one launch of its
    route's kernel under the MLA keys, rows past R untouched."""
    G, T = MLA_384_ROWS[rows]
    make = mla_paged_case if paged else mla_slot_case
    args, kw = make(cuda_device, Dk=384, Dv=256, G=G, T=T, bf16=bf16)
    got = mla_held(paged, args, kw, 384)
    assert got.shape[2] == G * T


@pytest.mark.parametrize("paged", [True, False], ids=["pool", "slots"])
def test_mla_decode_splits_merge_and_repeat(cuda_device, monkeypatch, paged):
    """The decode route's split merge (the last block's, counters reset)
    gives the same bits on a second launch and agrees with one split."""
    make = mla_paged_case if paged else mla_slot_case
    args, kw = make(cuda_device, G=16, T=1, bf16=False)
    first = mla_held(paged, args, kw, 640)
    again = mla_held(paged, args, kw, 640)
    assert torch.equal(first, again)
    monkeypatch.setattr(tfa, "mla_splits", lambda *a: 1)
    one = mla_held(paged, args, kw, 640)
    assert nmse(first, one) < 1e-5


def test_mla_raises_on_what_it_does_not_take(cuda_device):
    args, kw = mla_paged_case(cuda_device)
    for extra in (dict(window=64), dict(softcap=2.0)):
        with pytest.raises(ValueError, match="MLA"):
            tfa.flash_attention_paged(*args, sm_scale=0.05, **kw, **extra)
    sinks = torch.zeros((1, args[0].shape[2]), device=cuda_device)
    with pytest.raises(ValueError, match="MLA"):
        tfa.flash_attention_paged(*args, sinks, sm_scale=0.05, **kw)
    q, k, v = args[:3]
    two = (q.expand(-1, 2, -1, -1).contiguous(), k.expand(2, -1, -1).contiguous(),
           v.expand(2, -1, -1).contiguous())
    with pytest.raises(ValueError, match="one KV head"):  # two KV heads
        tfa.flash_attention_paged(*two, *args[3:], sm_scale=0.05, **kw)
    with pytest.raises(ValueError):  # V rows of 448
        tfa.flash_attention_paged(q, k, v[..., :448].contiguous(), *args[3:], sm_scale=0.05,
                                  **kw)
    sargs, _ = mla_slot_case(cuda_device)
    with pytest.raises(ValueError, match="MLA"):
        tfa.flash_attention(*sargs, sm_scale=0.05, ring=True)


def test_mla_shared_memory_budget(cuda_device):
    """Every MLA block fits the card's 227 KB beside its static memory."""
    for Dk, Dv in tfa.MLA_DIMS:
        for wide in (True, False):
            for bf16 in (True, False):
                b = tfa.mla_smem_bytes(Dk, wide, bf16, Dv)
                assert 0 < b + 2048 <= 232448, (Dk, Dv, wide, bf16, b)
    assert tfa.mla_smem_bytes(512, True, True) == -1
    assert tfa.mla_smem_bytes(384, True, True) == -1  # (384, 512) is no pair


@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q8_0],
                         ids=["q4_k", "q6_k", "q8_0"])
def test_expert_stack_loads_on_the_card_as_on_the_host(cuda_device, qtype):
    """An expert stack's planes transposed on the card are the host's bytes."""
    rng = np.random.default_rng(3)
    shape = (4, 384, 512)
    raw = np.frombuffer(synth_quant_bytes(rng, int(np.prod(shape)), qtype), np.uint8)
    card = tq.load_weight(raw, qtype, shape, transpose=True, device=cuda_device)
    host = tq.load_weight(raw, qtype, shape, transpose=True, device="cpu")
    assert card.transposed and card.q.shape == (4, 512, 384) and card.group == host.group
    for name in ("q", "scales", "mins"):
        a, b = getattr(card, name), getattr(host, name)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.is_contiguous() and torch.equal(a.cpu(), b), name


# -- the dense-decoder families: LayerNorm, biases, non-gated FFN, parallel and
# norm-after residuals, NoPE, ALiBi, learned positions ----------------------

@pytest.mark.parametrize("T", [1, 3, 8], ids=["decode", "decode_r27", "prefill_r72"])
@pytest.mark.parametrize("bf16", [False, True], ids=["int8_pool", "bf16_pool"])
def test_paged_attention_kernel_nine_rows_a_kv_head(cuda_device, T, bf16):
    """G = 9 query heads a KV head (StarCoder2-7B's 36 on 4), not a power of
    two: 9, 27 rows on the decode kernel, 72 on the prefill kernel."""
    args, _, page = paged_case(cuda_device, G=9, T=T, bf16=bf16)
    kw = dict(sm_scale=1.0 / np.sqrt(128), page=page)
    key = f"flash_attention_paged/{tfa.route(args[0].shape[2])}"
    before = tfa.launches[key]
    got = tfa.flash_attention_paged(*args, **kw)
    torch.cuda.synchronize()
    assert tfa.launches[key] == before + 1
    ref = tfa.flash_attention_paged_plain(*args, **kw)
    valid = args[3] >= 0
    g, r = got.transpose(1, 2)[valid], ref.transpose(1, 2)[valid]
    assert torch.isfinite(g).all() and nmse(g, r) < 1e-5


@pytest.mark.parametrize("T", [1, 8], ids=["decode", "prefill_r72"])
def test_slot_attention_kernel_nine_rows_a_kv_head(cuda_device, T):
    args, _ = slot_case(cuda_device, G=9, T=T)
    kw = dict(sm_scale=1.0 / np.sqrt(128))
    got = tfa.flash_attention(*args, **kw)
    ref = tfa.flash_attention_plain(*args, **kw)
    valid = args[3] >= 0
    g, r = got.transpose(1, 2)[valid], ref.transpose(1, 2)[valid]
    assert torch.isfinite(g).all() and nmse(g, r) < 1e-5


FAMILY_SHAPE = dict(n_layers=2, n_embd=1024, n_heads=8, n_kv_heads=4, head_dim=128, n_ff=2048,
                    vocab_size=1024, n_ctx=1024)
# entry -> what it carries through the kernels
FAMILY_CASES = {
    "starcoder2": "LayerNorm with biases, biased q/k/v/output, non-gated GELU with biases",
    "nemotron": "LayerNorm, non-gated ReLU^2",
    "command-r": "parallel residual on one weight-only LayerNorm, logit scale, tied head",
    "gptneox": "parallel residual on two LayerNorms, file-fused biased QKV",
    "olmo2": "norm-after blocks, whole-projection q/k RMSNorm",
    "smollm3": "a NoPE layer",
    "bloom": "ALiBi, the embedding LayerNorm: no attention kernel",
    "gpt2": "learned positions, no rope",
    "cohere2": "ISWA rings with NoPE full layers and a parallel residual",
}


@pytest.fixture(scope="module")
def dense_families(tmp_path_factory):
    """The entries of FAMILY_CASES at FAMILY_SHAPE, synthetic block scales
    divided by 256: at the default scale a biased model's attention is near
    one-hot, and the kernels' bf16 q and P (the JAX package's kernels' too)
    against the plain path's f32 pick other keys."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run `python -m pytest --noconftest -m gpu "
                    "tests/test_torch_gpu.py` on the card")
    from llama_cpp_tpu_torch.testing import FAMILY_LAYOUTS, make_bench_arch_gguf

    d = tmp_path_factory.mktemp("dense_families")
    return {arch: load_model(make_bench_arch_gguf(
        str(d / f"{arch}.gguf"), arch, synth_scale=1.0 / 256,
        **{**FAMILY_SHAPE, **FAMILY_LAYOUTS[arch]})) for arch in FAMILY_CASES}


def _zero_counts():
    for counter in (tqmm.launches, tfa.launches, tfa.ring_launches):
        for key in counter:
            counter[key] = 0


@pytest.mark.parametrize("arch", list(FAMILY_CASES))
def test_dense_family_kernels_match_plain_and_graphs_match_eager(dense_families, arch):
    """The kernel path against Context(kernels=False) on a 300-token prefill
    (NMSE < 5e-3), the qmm kernels launched at both routes; attention on K5
    (K6 in ring mode on the window layers) except ALiBi's, which launches
    neither; then decode_steps_greedy at B=4 graphed against eager: equal
    ids."""
    model = dense_families[arch]
    p = [int(t) for t in np.random.default_rng(6).integers(3, 1024, 300)]
    kw = dict(n_ctx=1024, n_seqs=4, n_ubatch=128, quantized_kv=True)
    _zero_counts()
    got = Context(model, **kw).prefill(p)
    ref = Context(model, kernels=False, **kw).prefill(p)
    assert np.isfinite(got).all()
    assert nmse(torch.from_numpy(got), torch.from_numpy(ref)) < 5e-3
    assert tqmm.launches["qmm4_planes_prefill/wgmma"] > 0
    if model.cfg.alibi_bias:
        assert sum(tfa.launches.values()) == 0
    else:
        assert tfa.launches["flash_attention_paged/prefill"] > 0
    assert (sum(tfa.ring_launches.values()) > 0) == (model.cfg.sliding_window > 0)
    runs = []
    for graphs in (True, False):
        ctx, firsts = prefilled(model, 4, graphs)
        runs.append(ctx.decode_steps_greedy(firsts, np.arange(4), 12))
    np.testing.assert_array_equal(runs[0], runs[1])
    assert tqmm.launches["qmm4_planes/decode"] > 0
    if model.cfg.alibi_bias:
        assert sum(tfa.launches.values()) == 0


@pytest.mark.parametrize("paged", [True, False], ids=["pool", "slots"])
def test_nope_context_shift_matches_plain(dense_families, paged):
    """smollm3 (layer 1 NoPE): context_shift on the kernel path against the
    plain path shifted alike (each layer's K re-roped, as the JAX package's
    shift_seq does): 6 teacher-forced steps within NMSE 5e-3, and graphed
    greedy steps equal to eager after the shift."""
    model = dense_families["smollm3"]
    p = [int(t) for t in np.random.default_rng(7).integers(3, 1024, 400)]
    kw = dict(n_ctx=1024, n_seqs=1, n_ubatch=128, quantized_kv=True, paged=paged)
    ctxs = [Context(model, **kw), Context(model, graphs=False, **kw),
            Context(model, kernels=False, **kw)]
    for c in ctxs:
        c.prefill(p)
        assert c.context_shift(0, n_keep=32, n_discard=128) == 128
    g, e, plain = ctxs
    ids_g = g.decode_steps_greedy(np.asarray([11]), np.asarray([0]), 6)
    ids_e = e.decode_steps_greedy(np.asarray([11]), np.asarray([0]), 6)
    np.testing.assert_array_equal(ids_g, ids_e)
    e.seq_rm(0, p0=int(e.seq_len[0]) - 6)
    for t in [11] + [int(x) for x in ids_e[0][:5]]:
        assert nmse(torch.from_numpy(e.decode_one(t)),
                    torch.from_numpy(plain.decode_one(t))) < 5e-3


# -- the MoE families: K7 at gpt-oss's and Llama-4-Scout's widths, and the
# families' kernel path ----------------------------------------------------

# (E, K, O, group, mins, R, pick): gpt-oss's MXFP4-like stacks (2880 = 45
# stages of 64 rows and 22 column tiles of 128 plus one of 64; groups of 32,
# no mins) at a decode token's 4 experts and at 32 rows; Scout's gate/up
# (Q4_K-like, 5120 -> 8192) and down (Q6_K-like, 8192 -> 5120) at top 1 and
# 8 rows; a half column tile with a split K; and Mixtral's gate at R = 2, an
# old shape, held to the same limit
EXPERT_WIDTHS = {
    "gpt_oss_r4": (32, 2880, 2880, 32, False, 4, "distinct"),
    "gpt_oss_r32": (32, 2880, 2880, 32, False, 32, "random"),
    "scout_gate_r1": (16, 5120, 8192, 32, True, 1, "distinct"),
    "scout_gate_r8": (16, 5120, 8192, 32, True, 8, "random"),
    "scout_down_r1": (16, 8192, 5120, 16, False, 1, "distinct"),
    "scout_down_r8": (16, 8192, 5120, 16, False, 8, "random"),
    "half_tile_split": (4, 8192, 320, 16, True, 3, "random"),
    "mixtral_gate_r2": (8, 4096, 14336, 32, True, 2, "distinct"),
}


@pytest.mark.parametrize("case", list(EXPERT_WIDTHS))
def test_expert_kernel_at_the_moe_family_widths(cuda_device, case):
    """K7 against its plain version at NMSE < 1e-5, one launch a call; the
    columns of a half column tile past O are never stored (the output's
    last row and the next row's first columns agree with the plain
    version)."""
    E, K, O, g, mins, R, pick = EXPERT_WIDTHS[case]
    x, ids, w = expert_case(cuda_device, E, K, O, R, g, mins, pick)
    assert tqe.supported(w)
    before = tqe.launches["qmm_planes_expert"]
    got = tqe.qmm_expert(x, ids, w)
    torch.cuda.synchronize()
    assert tqe.launches["qmm_planes_expert"] == before + 1
    assert got.shape == (R, O) and torch.isfinite(got).all()
    assert nmse(got, tqe.qmm_expert_plain(x, ids, w)) < 1e-5


def test_expert_kernel_on_mxfp4_stacks_at_gpt_oss_width(cuda_device):
    """gpt-oss's expert stack as the loader lays out MXFP4 (int8 flat-g32
    planes, no mins) from synthetic bytes, 32 x 2880 x 2880: K7 takes it and
    agrees with the plain version at a decode token's 4 experts."""
    rng = np.random.default_rng(4)
    shape = (32, 2880, 2880)
    raw = np.frombuffer(synth_quant_bytes(rng, int(np.prod(shape)), GGMLType.MXFP4), np.uint8)
    w = tq.load_weight(raw, GGMLType.MXFP4, shape, transpose=True, device=cuda_device)
    assert tqe.supported(w) and w.group == 32 and w.mins is None and not w.hier
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.randn((4, 2880), generator=gen, device=cuda_device).to(torch.bfloat16)
    ids = torch.tensor([31, 0, 17, 5], dtype=torch.int32, device=cuda_device)
    got = tqe.qmm_expert(x, ids, w)
    assert nmse(got, tqe.qmm_expert_plain(x, ids, w)) < 1e-5


MOE_FAMILY_CASES = {
    "gpt-oss": "MXFP4 experts with biases and the clamped GLU, sinks, window layers on rings",
    "llama4": "the gate on the expert input at top 1, a shared expert, a NoPE layer",
    "grovemoe": "chunk experts on the mix's output",
}


@pytest.fixture(scope="module")
def moe_families(tmp_path_factory):
    """The entries of MOE_FAMILY_CASES at FAMILY_SHAPE, synthetic block
    scales divided by 256, as dense_families'."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run `python -m pytest --noconftest -m gpu "
                    "tests/test_torch_gpu.py` on the card")
    from llama_cpp_tpu_torch.testing import FAMILY_LAYOUTS, make_bench_arch_gguf

    d = tmp_path_factory.mktemp("moe_families")
    return {arch: load_model(make_bench_arch_gguf(
        str(d / f"{arch}.gguf"), arch, synth_scale=1.0 / 256,
        **{**FAMILY_SHAPE, **FAMILY_LAYOUTS[arch]})) for arch in MOE_FAMILY_CASES}


@pytest.mark.parametrize("arch", list(MOE_FAMILY_CASES))
def test_moe_family_kernels_match_plain_and_graphs_match_eager(moe_families, arch):
    """The kernel path against Context(kernels=False) on a 300-token prefill
    (NMSE < 5e-3), then decode_steps_greedy at B=1 graphed against eager
    (equal ids) with K7 launched at the decode steps."""
    model = moe_families[arch]
    p = [int(t) for t in np.random.default_rng(6).integers(3, 1024, 300)]
    kw = dict(n_ctx=1024, n_seqs=1, n_ubatch=128, quantized_kv=True)
    got = Context(model, **kw).prefill(p)
    ref = Context(model, kernels=False, **kw).prefill(p)
    assert np.isfinite(got).all()
    assert nmse(torch.from_numpy(got), torch.from_numpy(ref)) < 5e-3
    before = tqe.launches["qmm_planes_expert"]
    runs = []
    for graphs in (True, False):
        ctx, firsts = prefilled(model, 1, graphs)
        runs.append(ctx.decode_steps_greedy(firsts, np.arange(1), 12))
    np.testing.assert_array_equal(runs[0], runs[1])
    assert tqe.launches["qmm_planes_expert"] > before


# embedding entries -> what their embed (or encode) takes on the card
EMBEDDING_CASES = {
    "bert": "post-norm LayerNorm encoder with biases: K3/K4 at the 512-row bucket",
    "modern-bert": "pre-norm encoder, layer 0 without attn_norm, local windows",
    "gemma-embedding": "non-causal gemma3 blocks on F32 values: no attention kernel",
    "llama-embed": "the llama decoder over a 520-slot table: the einsum attention",
    "t5encoder": "T5's encoder: K1/K2 at 7 tokens, K3/K4 at 200",
}
# entries whose narrow Q4_K_M file here is ill-conditioned on this prompt:
# rounding only its block scales to bf16, as the prefill GEMM does, turns one
# of the 160 rows of the plain path itself into another, so their values are
# F32 (their products on the library route); chip_smoke.py holds
# gemma-embedding's Q4_K_M file on the kernels (another file and prompt)
EMBEDDING_F32 = ("gemma-embedding",)


@pytest.fixture(scope="module")
def embedding_models(tmp_path_factory):
    """The entries of EMBEDDING_CASES at n_embd 1024, 2 layers, heads of 128,
    the Q4_K_M mix with synthetic block scales / 256 (F32 values for
    EMBEDDING_F32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run `python -m pytest --noconftest -m gpu "
                    "tests/test_torch_gpu.py` on the card")
    from llama_cpp_tpu_torch.testing import make_bench_embedding_gguf

    d = tmp_path_factory.mktemp("embedding_models")
    return {arch: load_model(make_bench_embedding_gguf(
        str(d / f"{arch}.gguf"), arch, n_layers=2, n_embd=1024, n_heads=8, n_ff=2048,
        vocab_size=1024, synth_scale=1.0 / 256, f32=arch in EMBEDDING_F32))
        for arch in EMBEDDING_CASES}


@pytest.mark.parametrize("arch", list(EMBEDDING_CASES))
def test_embedding_kernels_match_plain(embedding_models, arch):
    """Context.embed of 160 tokens (a 512-row bucket) or Context.encode of
    7 and 200 tokens on the kernel path against Context(kernels=False)
    (NMSE < 5e-3): the qmm kernels of the bucket's row count launched (none
    on F32 values), no attention kernel (the encoders' attention is plain, gemma-embedding's is
    non-causal, a 520-slot table is no multiple of 128)."""
    model = embedding_models[arch]
    kw = dict(n_ctx=1024, n_seqs=1, n_ubatch=512)
    rng = np.random.default_rng(8)
    _zero_counts()
    if arch == "t5encoder":
        for n, key in ((7, "qmm4_planes/decode"), (200, "qmm4_planes_prefill/wgmma")):
            toks = [int(t) for t in rng.integers(3, 1024, n)]
            before = tqmm.launches[key]
            got = Context(model, **kw).encode(toks)
            assert tqmm.launches[key] > before
            ref = Context(model, kernels=False, **kw).encode(toks)
            assert np.isfinite(got).all()
            assert nmse(torch.from_numpy(got), torch.from_numpy(ref)) < 5e-3
    else:
        toks = [int(t) for t in rng.integers(3, 1024, 160)]
        got = Context(model, **kw).embed(toks, pooling="none")
        quantized = arch not in EMBEDDING_F32
        assert (tqmm.launches["qmm4_planes_prefill/wgmma"] > 0) == quantized
        assert (tqmm.launches["qmm_planes_prefill/wgmma"] > 0) == quantized
        assert tqmm.launches["qmm4_planes/decode"] == tqmm.launches["qmm_planes/decode"] == 0
        ref = Context(model, kernels=False, **kw).embed(toks, pooling="none")
        assert np.isfinite(got).all()
        assert nmse(torch.from_numpy(got), torch.from_numpy(ref)) < 5e-3
    assert sum(tfa.launches.values()) == 0


def test_embedding_bucket_of_1024_rows_takes_the_library_route(embedding_models):
    """600 tokens bucket to 1024 rows: every product on the library route,
    as the JAX package's XLA_PREFILL_MIN_N leaves it to XLA; no kernel."""
    model = embedding_models["bert"]
    toks = [int(t) for t in np.random.default_rng(9).integers(3, 1024, 600)]
    _zero_counts()
    got = Context(model, n_ctx=1024, n_seqs=1).embed(toks)
    assert sum(tqmm.launches.values()) == 0 and sum(tfa.launches.values()) == 0
    ref = Context(model, kernels=False, n_ctx=1024, n_seqs=1).embed(toks)
    assert nmse(torch.from_numpy(got), torch.from_numpy(ref)) < 5e-3


# -- T5's encoder-decoder, the diffusion LMs, the last shared-decoder entries --

@pytest.fixture(scope="module")
def late_entry_models(tmp_path_factory):
    """flan-t5's blocks at 1024 wide (16 heads of 64, 2 encoder and 2 decoder
    layers, vocab 1024), the four diffusion entries and the last text
    entries (laguna with both gate shapes) at FAMILY_SHAPE; the Q4_K_M mix
    with synthetic block scales / 256."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run `python -m pytest --noconftest -m gpu "
                    "tests/test_torch_gpu.py` on the card")
    from llama_cpp_tpu_torch.testing import (DIFFUSION_LAYOUTS, LAGUNA_ELEMENT_GATE,
                                             LAST_TEXT_LAYOUTS, make_bench_arch_gguf,
                                             make_bench_diffusion_gguf, make_bench_t5_gguf)

    d = tmp_path_factory.mktemp("late_entries")
    sc = dict(synth_scale=1.0 / 256)
    models = {"t5": load_model(make_bench_t5_gguf(str(d / "t5.gguf"), n_layers=2,
                                                  n_dec_layers=2, vocab_size=1024, **sc))}
    shape = {k: v for k, v in FAMILY_SHAPE.items() if k not in ("n_ctx", "head_dim")}
    for arch in DIFFUSION_LAYOUTS:
        models[arch] = load_model(make_bench_diffusion_gguf(
            str(d / f"{arch}.gguf"), arch, mask_token=-1, **shape, **sc))
    layouts = {**LAST_TEXT_LAYOUTS, "laguna-element": LAGUNA_ELEMENT_GATE}
    for name, layout in layouts.items():
        arch = name.split("-")[0]
        models[name] = load_model(make_bench_arch_gguf(str(d / f"{name}.gguf"), arch,
                                                       **{**FAMILY_SHAPE, **layout}, **sc))
    return models


def test_t5_kernels_match_plain_and_refuse_the_device_loops(late_entry_models):
    """A 96-token prompt through T5's encoder (K3/K4 at its 128-row bucket,
    and at the cross K/V projections) and 8 decoder steps (K1/K2), each
    step's logits teacher-forced against Context(kernels=False) (NMSE <
    5e-3); no attention kernel (T5's attention is plain in both packages);
    the on-device loops raise naming t5."""
    model = late_entry_models["t5"]
    p = [int(t) for t in np.random.default_rng(4).integers(3, 1024, 96)]
    kw = dict(n_ctx=512, n_seqs=2, n_ubatch=512, quantized_kv=True)
    _zero_counts()
    kern, plain = Context(model, **kw), Context(model, kernels=False, **kw)
    assert not kern.paged
    lk, lp = kern.prefill(p), plain.prefill(p)
    for key in ("qmm4_planes_prefill/wgmma", "qmm_planes_prefill/wgmma", "qmm4_planes/decode",
                "qmm_planes/decode"):
        assert tqmm.launches[key] > 0, key
    errs = [nmse(torch.from_numpy(lk), torch.from_numpy(lp))]
    for _ in range(8):
        t = int(np.argmax(lp))
        lk, lp = kern.decode_one(t), plain.decode_one(t)
        errs.append(nmse(torch.from_numpy(lk), torch.from_numpy(lp)))
    assert np.isfinite(lk).all() and max(errs) < 5e-3, errs
    assert sum(tfa.launches.values()) == 0
    with pytest.raises(NotImplementedError, match="'t5'"):
        kern.decode_steps_greedy(np.asarray([5]), np.asarray([0]), 4)
    with pytest.raises(NotImplementedError, match="'t5'"):
        kern.generate_ondevice(p, max_new_tokens=4, seq=1)


@pytest.mark.parametrize("arch", ["dream", "llada", "llada-moe", "rnd1"])
def test_diffusion_step_takes_the_prefill_gemms(late_entry_models, arch):
    """One diffusion step's whole-sequence forward (128 rows, half of them
    the mask) on the kernel path against the plain path (NMSE < 5e-3 at the
    masked rows): K3 and K4 launch in the step, no decode kernel, no
    attention kernel (non-causal: the einsum path in both packages), no K7
    (the per-expert route at 128 rows)."""
    from llama_cpp_tpu_torch.runtime.diffusion import step_logits

    model = late_entry_models[arch]
    mask = model.tokenizer.vocab.mask_id
    seq = np.full(128, mask, np.int64)
    seq[:64] = np.random.default_rng(5).integers(3, 1000, 64)
    kw = dict(n_ctx=128, n_seqs=1, n_ubatch=128)
    _zero_counts()
    before = tqe.launches["qmm_planes_expert"]
    got = step_logits(Context(model, **kw), seq)
    assert tqmm.launches["qmm4_planes_prefill/wgmma"] > 0
    assert tqmm.launches["qmm_planes_prefill/wgmma"] > 0
    assert tqmm.launches["qmm4_planes/decode"] == tqmm.launches["qmm_planes/decode"] == 0
    assert sum(tfa.launches.values()) == 0 and tqe.launches["qmm_planes_expert"] == before
    ref = step_logits(Context(model, kernels=False, **kw), seq)
    assert np.isfinite(got).all()
    assert nmse(torch.from_numpy(got[64:]), torch.from_numpy(ref[64:])) < 5e-3


@pytest.mark.parametrize("name", ["afmoe", "laguna", "laguna-element", "openelm", "nanbeige"])
def test_last_text_entries_match_plain_and_graphs_match_eager(late_entry_models, name):
    """The kernel path against Context(kernels=False) on a 300-token prefill
    (NMSE < 5e-3), K5 launched (openelm's first layer, at fewer KV heads
    than the memory, on the einsum path), then decode_steps_greedy at B=1
    graphed against eager (equal ids), with K7 at the decode steps of the
    MoE entries."""
    model = late_entry_models[name]
    p = [int(t) for t in np.random.default_rng(6).integers(3, 1024, 300)]
    kw = dict(n_ctx=1024, n_seqs=1, n_ubatch=128, quantized_kv=True)
    _zero_counts()
    got = Context(model, **kw).prefill(p)
    assert fa_launches("flash_attention_paged") > 0
    ref = Context(model, kernels=False, **kw).prefill(p)
    assert np.isfinite(got).all()
    assert nmse(torch.from_numpy(got), torch.from_numpy(ref)) < 5e-3
    before = tqe.launches["qmm_planes_expert"]
    runs = []
    for graphs in (True, False):
        ctx, firsts = prefilled(model, 1, graphs)
        runs.append(ctx.decode_steps_greedy(firsts, np.arange(1), 12))
    np.testing.assert_array_equal(runs[0], runs[1])
    assert (tqe.launches["qmm_planes_expert"] > before) == (model.cfg.n_expert > 0)


def test_nanbeige_loops_share_the_card_storage(late_entry_models):
    """nanbeige's logical layers past the physical stack are the same
    tensors on the card (equal data_ptr), not copies."""
    layers = late_entry_models["nanbeige"].params["layers"]
    n_loops = late_entry_models["nanbeige"].cfg.extra["n_loops"]
    phys = len(layers) // n_loops
    assert n_loops == 2 and len(layers) == 2 * phys
    for il in range(phys, len(layers)):
        for key, w in layers[il].items():
            a, b = w, layers[il % phys][key]
            a, b = (a.q, b.q) if isinstance(a, tq.QuantTensor) else (a, b)
            assert a.data_ptr() == b.data_ptr(), (il, key)
