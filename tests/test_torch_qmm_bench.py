"""The microbenchmark's probe kernels: the port's plain PyTorch versions
(ops/kernels/qmm_bench.py) against the TPU kernels of scripts/bench_qmm.py,
which run here in Pallas interpret mode.

The script is loaded under another module name and the loaded module's `pl`
is replaced by an object that forwards to jax.experimental.pallas with
pallas_call(interpret=True); nothing in the repository changes. The same
numpy arrays go to both sides. Interpret mode runs the bf16 dots in f32, so
the products agree to NMSE near 3e-6; the limit is the reference's
conformance threshold, 5e-3."""

import functools
import importlib.util
import os
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as real_pl

from llama_cpp_tpu_torch.ops.kernels import qmm_bench as tqb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NMSE_LIMIT = 5e-3
GROUP = 32


@pytest.fixture(scope="module")
def ref():
    """scripts/bench_qmm.py with its Pallas calls in interpret mode."""
    spec = importlib.util.spec_from_file_location(
        "bench_qmm_reference", os.path.join(ROOT, "scripts", "bench_qmm.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    interp = types.SimpleNamespace(**{k: getattr(real_pl, k) for k in dir(real_pl)
                                      if not k.startswith("__")})
    interp.pallas_call = functools.partial(real_pl.pallas_call, interpret=True)
    mod.pl = interp
    return mod


def planes(K, O, seed, rows=8):
    """Every byte value (high nibbles 8..15 are negative int8 bytes)."""
    rng = np.random.default_rng(seed)
    qp = rng.integers(0, 256, (K // 2, O), np.uint8).view(np.int8)
    assert (qp < 0).any()
    sc = (rng.normal(size=(K // GROUP, O)) * 0.05).astype(np.float32)
    mn = (rng.normal(size=(K // GROUP, O)) * 0.1).astype(np.float32)
    x = rng.normal(size=(rows, K)).astype(np.float32)
    return x, qp, sc, mn


def to_jax(x, *rest):
    return (jnp.asarray(x, jnp.bfloat16), *(jnp.asarray(a) for a in rest))


def to_torch(x, *rest):
    return (torch.from_numpy(x).to(torch.bfloat16), *(torch.from_numpy(a) for a in rest))


def nmse(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.mean((got - want) ** 2) / np.mean(want ** 2))


# K/2 = 1024 takes the script's tk2 = 1024 branch; K/2 = 1536 and 512 the 512 one
@pytest.mark.parametrize("K,O", [(2048, 512), (3072, 256), (1024, 512)])
def test_stream_planes_plain_matches_the_tpu_kernel(ref, K, O):
    """f32 sums of the same values, in the same order or another: rtol 1e-5."""
    a = planes(K, O, seed=K + O)
    want = np.asarray(ref.stream_planes(*to_jax(*a), group=GROUP))
    got = tqb.stream_planes(*to_torch(*a), group=GROUP).numpy()
    assert got.shape == want.shape == (8, O)
    assert (K // 2) % 1024 == 0 or tqb.stream_tile_rows(K // 2) == 512
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_stream_planes_tile_rows_are_part_of_the_function():
    a = to_torch(*planes(4096, 256, seed=5))
    at_512 = tqb.stream_planes_plain(*a, group=GROUP, tk2=512)
    at_1024 = tqb.stream_planes_plain(*a, group=GROUP)
    assert tqb.stream_tile_rows(2048) == 1024
    assert not torch.allclose(at_512, at_1024)


@pytest.mark.parametrize("kernel", ["_qmm4_fp_kernel", "_qmm4_i16_kernel"])
@pytest.mark.parametrize("K,O,rows", [(2048, 512, 8), (4096, 512, 16)])
def test_qmm4_variant_plain_matches_the_tpu_kernels(ref, kernel, K, O, rows):
    a = planes(K, O, seed=K + rows, rows=rows)
    want = ref._variant_call(getattr(ref, kernel), *to_jax(*a), group=GROUP)
    unpack = "fp" if "fp" in kernel else "i16"
    got = tqb.qmm4_variant(*to_torch(*a), group=GROUP, unpack=unpack).numpy()
    assert got.shape == (rows, O)
    assert nmse(got, want) < NMSE_LIMIT


@pytest.mark.parametrize("to,tk", [(256, 1024), (512, 2048), (128, 512)])
def test_qmm_tiled4d_plain_matches_the_tpu_kernel(ref, to, tk):
    K, O = 2048, 512
    a = planes(K, O, seed=to + tk)
    x, qp, sc, mn = to_torch(*a)
    q4, sc4, mn4 = tqb.tile_planes_4d(qp, sc, mn, to, tk)
    assert q4.shape == (K // tk, O // to, tk // 2, to)
    assert sc4.shape == mn4.shape == (K // tk, O // to, tk // GROUP, to)
    want = ref.qmm_tiled4d(jnp.asarray(a[0], jnp.bfloat16), jnp.asarray(q4.numpy()),
                           jnp.asarray(sc4.numpy()), jnp.asarray(mn4.numpy()),
                           group=GROUP, to=to, tk=tk)
    got = tqb.qmm_tiled4d(x, q4, sc4, mn4, group=GROUP, to=to, tk=tk).numpy()
    assert nmse(got, want) < NMSE_LIMIT


@pytest.mark.parametrize("to,tk", [(256, 512), (512, 2048)])
def test_qmm_tiled_is_the_function_of_the_variant_and_the_4d_kernel(ref, to, tk):
    """The reference's qmm_tiled cannot run (next test); its function is
    what it computed when written: that of _qmm4_i16_kernel and of
    qmm_tiled4d, whatever the tile."""
    K, O = 2048, 512
    a = planes(K, O, seed=tk)
    x, qp, sc, mn = to_torch(*a)
    got = tqb.qmm_tiled(x, qp, sc, mn, group=GROUP, tn=8, to=to, tk=tk).numpy()
    i16 = ref._variant_call(ref._qmm4_i16_kernel, *to_jax(*a), group=GROUP)
    q4, sc4, mn4 = tqb.tile_planes_4d(qp, sc, mn, to, tk)
    b4 = ref.qmm_tiled4d(jnp.asarray(a[0], jnp.bfloat16), jnp.asarray(q4.numpy()),
                         jnp.asarray(sc4.numpy()), jnp.asarray(mn4.numpy()),
                         group=GROUP, to=to, tk=tk)
    assert nmse(got, i16) < NMSE_LIMIT
    assert nmse(got, b4) < NMSE_LIMIT


def test_the_reference_qmm_tiled_cannot_run(ref):
    """It passes five operands to a kernel body that takes seven since the
    half-split rework. The day it is repaired this test says so, and the
    port's qmm_tiled can be held against it directly."""
    a = to_jax(*planes(2048, 512, seed=1))
    with pytest.raises(TypeError):
        ref.qmm_tiled(*a, group=GROUP, tn=8, to=512, tk=2048)


def test_plain_version_against_a_numpy_evaluation():
    """The even/odd pairing written out: byte r holds rows 2r (low nibble)
    and 2r+1 (high)."""
    K, O = 256, 64
    x, qp, sc, mn = planes(K, O, seed=9)
    u = qp.view(np.uint8).astype(np.int64)
    w = np.empty((K, O), np.float64)
    w[0::2], w[1::2] = u & 0xF, u >> 4
    xb = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
    want = xb @ (w * np.repeat(sc, GROUP, axis=0) + np.repeat(mn, GROUP, axis=0))
    got = tqb.qmm4_variant_plain(*to_torch(x, qp, sc, mn), group=GROUP).numpy()
    assert nmse(got, want) < 1e-4  # W rounded to bf16 once


@pytest.mark.parametrize("to,tk", [(128, 256), (512, 1024), (256, 2048)])
def test_tile_planes_4d_round_trips(to, tk):
    _, qp, sc, mn = to_torch(*planes(4096, 1024, seed=to))
    tiled = tqb.tile_planes_4d(qp, sc, mn, to, tk)
    assert all(t.is_contiguous() for t in tiled)
    for back, flat in zip(tqb.untile_planes_4d(*tiled), (qp, sc, mn)):
        assert torch.equal(back, flat)
    # tile (1, 1) is rows [tk/2, tk) x columns [to, 2 to) of the flat plane
    assert torch.equal(tiled[0][1, 1], qp[tk // 2: tk, to: 2 * to])
    with pytest.raises(ValueError):
        tqb.tile_planes_4d(qp, sc, mn, 384, tk)


def test_tile_predicate_names_what_the_kernel_does_not_take():
    assert tqb.tile_unsupported(8, 512, 2048, 4096, 28672) is None
    assert "rows" in tqb.tile_unsupported(16, 512, 2048, 4096, 28672)
    assert "columns" in tqb.tile_unsupported(8, 7168, 1024, 4096, 28672)
    assert "divide" in tqb.tile_unsupported(8, 512, 2048, 4096, 128256)
    assert tqb.tile_unsupported(8, 256, 1024, 4096, 128256) is None


def test_bench_qmm_entry_point_rehearses_on_the_cpu_and_needs_a_card_otherwise(capsys):
    from llama_cpp_tpu_torch.tools import bench_qmm

    assert bench_qmm.main(["stream", "fp", "i16", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "stream ceiling" in out and "qmm4 fp-unpack" in out and "not measured" in out
    assert "qmm4 fp/i16 plan: 14 column blocks x 8 K splits" in out
    assert "GB/s" not in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_qmm.main(["stream"])
    with pytest.raises(SystemExit):
        bench_qmm.main(["no-such-case", "--device", "cpu"])


# -- B2's card design: its planning rule and its arithmetic ----------------------

PLAN_SHAPES = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096), (2048, 512)]


@pytest.mark.parametrize("n", [8, 16, 32])
@pytest.mark.parametrize("K,O", PLAN_SHAPES)
def test_variant_plan_covers_every_column_and_k_range_once(K, O, n):
    """The kernel's blocks (column tile x, K split y, rows z) cover each
    column, each 64-row range of plane bytes and each row of x exactly once,
    never with more blocks than the card holds at once."""
    p = tqb.variant_plan(n, K, O)
    ranges = K // 2 // 64
    cover = np.zeros((O // 128, ranges, n), np.int64)
    for x in range(p.col_blocks):
        for y in range(p.splits):
            for z in range(p.row_blocks):
                rows = slice(z * 8 * p.n_tiles, min(n, (z + 1) * 8 * p.n_tiles))
                cover[x, y * p.stages: (y + 1) * p.stages, rows] += 1
    assert (cover == 1).all()
    assert p.col_blocks * 128 == O and p.splits * p.stages == ranges
    assert p.n_tiles == tqb.variant_tiles(n) and p.row_blocks == -(-n // (8 * p.n_tiles))
    assert p.blocks <= p.slots == 132 * p.blocks_per_sm
    assert p.blocks_per_sm * (tqb.variant_smem(p.n_tiles) + 1024) <= 233472
    if p.splits > 1:  # split only to give the SMs blocks, never past one an SM
        assert p.blocks <= 132
    if (K, O) == (4096, 28672):
        assert p.blocks > 112 and p.splits == 1 and p.note == ""
    if p.blocks < 132:
        assert p.note


def emulate_variant(x, qp, sc, mn, splits):
    """The B2 kernel's arithmetic in numpy: the nibbles exact as 128 + n,
    their products with bf16 x summed per scale group in f32 (the tensor
    cores' exact products, f32 sums), one f32 scaling a group and column,
    the bias and the mins through the group sums of x, each K split's sum in
    group order, the splits merged in split order."""
    xb = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    N, K = xb.shape
    u = qp.view(np.uint8)
    w = np.empty((K, u.shape[1]), np.float32)
    w[0::2], w[1::2] = 128 + (u & 0xF), 128 + (u >> 4)
    groups = K // GROUP
    out = np.zeros((N, u.shape[1]), np.float32)
    for s in range(splits):
        acc = np.zeros_like(out)
        for gi in range(s * groups // splits, (s + 1) * groups // splits):
            k = slice(gi * GROUP, (gi + 1) * GROUP)
            gsum = (xb[:, k] @ w[k]).astype(np.float32)
            xs = xb[:, k].sum(axis=1, dtype=np.float32)[:, None]
            bias = (mn[gi] - np.float32(128) * sc[gi]).astype(np.float32)
            acc = (sc[gi] * gsum + (bias * xs + acc)).astype(np.float32)
        out = (out + acc).astype(np.float32)
    return out


@pytest.mark.parametrize("kernel", ["_qmm4_fp_kernel", "_qmm4_i16_kernel"])
@pytest.mark.parametrize("K,O,rows", [(2048, 512, 8), (4096, 512, 16), (2048, 1024, 32)])
def test_variant_kernel_arithmetic_matches_the_tpu_kernels(ref, kernel, K, O, rows):
    """The emulation at the kernel's own K split (variant_plan) against the
    TPU bodies in interpret mode (NMSE < 5e-3), and against the plain
    version, which rounds W to bf16 where the kernel scales exact sums in
    f32 (NMSE < 1e-4, near 1e-6)."""
    a = planes(K, O, seed=K + O + rows, rows=rows)
    splits = tqb.variant_plan(rows, K, O).splits
    assert splits > 1
    got = emulate_variant(*a, splits)
    want = ref._variant_call(getattr(ref, kernel), *to_jax(*a), group=GROUP)
    assert nmse(got, want) < NMSE_LIMIT
    assert nmse(got, tqb.qmm4_variant_plain(*to_torch(*a), group=GROUP).numpy()) < 1e-4


def test_variant_wrapper_checks_the_unpack_and_takes_any_shape_on_the_cpu():
    """On the CPU the plain version takes any shape; the card's domain (the
    reference's tile (8, 512, 2048), group 32) is held in
    tests/test_torch_gpu.py."""
    x, qp, sc, mn = to_torch(*planes(1024, 512, seed=2))
    assert tqb.qmm4_variant(x, qp, sc, mn, group=GROUP).shape == (8, 512)
    with pytest.raises(ValueError, match="unpack"):
        tqb.qmm4_variant(x, qp, sc, mn, group=GROUP, unpack="i8")
