"""quant/device_planes.py's cutters for 2-D matrices, run on the CPU (the
card runs the same torch code on its tensors): bit for bit the host's
extraction of quant/repack.py, for every type they cover, cut a few rows a
pass (a small chunk_bytes), and ops/qtensor.load_weight's result through
them (device_planes.cuts_on forced) equal to its host route's, field by
field: Q4_K and Q6_K hierarchical, the flat types transposed (Q4_0 packed
with its nibble offset folded into the mins, Q4_K packed without one, the
int8 types unpacked) and as row-major tables."""

import numpy as np
import pytest
import torch

from llama_cpp_tpu_torch.gguf.constants import GGMLType
from llama_cpp_tpu_torch.ops.qtensor import QuantTensor, load_weight
from llama_cpp_tpu_torch.quant import device_planes, repack
from llama_cpp_tpu_torch.testing import synth_quant_bytes

FLAT = sorted(device_planes.MATRIX_PLANE_TYPES, key=int)
HIER = sorted(device_planes.MATRIX_HIER_TYPES, key=int)
FIELDS = ("q", "scales", "mins", "d", "dmin")


def raw_of(t, O, K, seed=0):
    rng = np.random.default_rng(seed)
    return np.frombuffer(synth_quant_bytes(rng, O * K, t, offset=11 + seed), np.uint8)


def bits(a) -> np.ndarray:
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


SMALL = 4000  # raw bytes a pass: a few rows, so every matrix takes several


@pytest.fixture
def small_chunks(monkeypatch):
    """load_weight's passes at SMALL bytes."""
    monkeypatch.setattr(device_planes, "CHUNK_BYTES", SMALL)


def test_the_cutters_cover_the_usual_types():
    assert set(FLAT) == {GGMLType.Q8_0, GGMLType.Q4_0, GGMLType.Q5_0, GGMLType.Q4_K,
                         GGMLType.Q6_K, GGMLType.MXFP4}
    assert set(HIER) == {GGMLType.Q4_K, GGMLType.Q6_K}
    assert set(FLAT) <= repack.PLANE_TYPES and set(HIER) <= repack.HIER_TYPES
    assert device_planes.DEVICE_PLANE_TYPES <= set(FLAT)
    assert not device_planes.cuts_on("cpu")


@pytest.mark.parametrize("shape", [(24, 512), (7, 256)])
@pytest.mark.parametrize("t", FLAT, ids=lambda t: t.name)
def test_matrix_flat_equals_extract_planes(t, shape):
    O, K = shape
    raw = raw_of(t, O, K)
    q, sc, mn, g = device_planes.matrix_flat(raw, t, shape, "cpu", chunk_bytes=SMALL)
    hq, hs, hm, hg = repack.extract_planes(raw, t, O * K)
    assert g == hg and tuple(q.shape) == shape and tuple(sc.shape) == (O, K // g)
    assert np.array_equal(bits(q), bits(hq)) and np.array_equal(bits(sc), bits(hs))
    assert (mn is None) == (hm is None)
    if mn is not None:
        assert np.array_equal(bits(mn), bits(hm))


@pytest.mark.parametrize("shape", [(24, 1024), (5, 512)])
@pytest.mark.parametrize("t", HIER, ids=lambda t: t.name)
def test_matrix_hier_equals_extract_planes_hier(t, shape):
    O, K = shape
    raw = raw_of(t, O, K, seed=1)
    got = device_planes.matrix_hier(raw, t, shape, "cpu", chunk_bytes=SMALL)
    ref = repack.extract_planes_hier(raw, t, O * K)
    assert got[-1] == ref[-1]
    for a, b in zip(got[:-1], ref[:-1]):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.shape[0] == O and np.array_equal(bits(a), bits(b))


def _load(raw, t, shape, transpose, on_card, monkeypatch):
    monkeypatch.setattr(device_planes, "cuts_on", lambda device: on_card)
    return load_weight(raw, t, shape, transpose=transpose, device="cpu")


def assert_same(a: QuantTensor, b: QuantTensor):
    for f in ("group", "ggml_type", "transposed", "packed", "sgroup"):
        assert getattr(a, f) == getattr(b, f), f
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and x.shape == y.shape, f
            assert np.array_equal(bits(x), bits(y)), f


# (type, shape): Q4_K and Q6_K at K % 512 == 0 take the hierarchical planes;
# Q4_K at K = 256 the flat ones, nibble-packed; Q4_0 packs with its offset 8
LOADS = [(GGMLType.Q4_K, (64, 1024)), (GGMLType.Q6_K, (64, 1024)), (GGMLType.Q4_K, (64, 256)),
         (GGMLType.Q4_0, (64, 512)), (GGMLType.Q5_0, (64, 512)), (GGMLType.Q8_0, (64, 512)),
         (GGMLType.MXFP4, (64, 512)), (GGMLType.Q6_K, (48, 256))]


@pytest.mark.parametrize("transpose", [True, False], ids=["matmul", "table"])
@pytest.mark.parametrize("t,shape", LOADS, ids=[f"{t.name}-{s[1]}" for t, s in LOADS])
def test_load_weight_cut_here_equals_the_host_route(small_chunks, monkeypatch, t, shape,
                                                    transpose):
    raw = raw_of(t, *shape, seed=2)
    host = _load(raw, t, shape, transpose, False, monkeypatch)
    cut = _load(raw, t, shape, transpose, True, monkeypatch)
    assert_same(cut, host)


def test_the_nibble_offset_is_folded_on_both_routes(monkeypatch):
    """Q4_0's values -8..7 pack with offset 8 (mins = -8 * scale); Q4_K's
    0..15 pack with none (its own mins)."""
    for t, shape, has_mins in ((GGMLType.Q4_0, (64, 512), True),
                               (GGMLType.Q4_K, (64, 256), True)):
        raw = raw_of(t, *shape, seed=3)
        cut = _load(raw, t, shape, True, True, monkeypatch)
        assert cut.packed and (cut.mins is not None) == has_mins
        if t == GGMLType.Q4_0:
            np.testing.assert_array_equal(bits(cut.mins), bits(-8 * cut.scales))


def test_the_uploader_hands_over_the_bytes():
    up = device_planes._Uploader("cpu", 1000)
    raw = np.arange(1000, dtype=np.uint8)
    assert torch.equal(up.put(raw[10:500]), torch.from_numpy(raw[10:500].copy()))
