"""The indexed-expert product of the PyTorch port (K7's plain version, and
an emulation of the CUDA kernel's arithmetic and row grouping) against the
JAX package's qmm_planes_expert (Pallas, interpret mode on the CPU, as
tests/test_pallas_qmm.py runs it): stacked int8 planes with flat f32
scales, with and without mins, groups of 16 and 32, rows that share experts;
and the kernel's pure planning rules (expert groups, K splits).

Tolerance: max error over the largest reference value < 5e-3 (interpret
mode runs the kernel's dots in f32 where the plain version rounds
q * scale to bf16 as the TPU does), NMSE < 1e-4."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llama_cpp_tpu.ops.pallas.qmm import qmm_planes_expert as jax_qmm_expert
from llama_cpp_tpu_torch.gguf.constants import GGMLType
from llama_cpp_tpu_torch.ops.kernels import qmm_expert as tqe
from llama_cpp_tpu_torch.ops.qtensor import QuantTensor


def make_case(E, K, O, R, g, mins, seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 127, (E, K, O)).astype(np.int8)
    sc = (rng.standard_normal((E, K // g, O)) * 0.02).astype(np.float32)
    mn = (rng.standard_normal((E, K // g, O)) * 0.01).astype(np.float32) if mins else None
    x = torch.from_numpy(rng.standard_normal((R, K)).astype(np.float32)).to(torch.bfloat16)
    ids = rng.integers(0, E, R).astype(np.int32)
    return q, sc, mn, x, ids


def stack(q, sc, mn, g) -> QuantTensor:
    return QuantTensor(q=torch.from_numpy(q), scales=torch.from_numpy(sc),
                       mins=None if mn is None else torch.from_numpy(mn), group=g,
                       ggml_type=int(GGMLType.Q4_K), transposed=True)


@pytest.mark.parametrize("mins", [False, True], ids=["scales", "scales_mins"])
@pytest.mark.parametrize("E,K,O,R,g", [(4, 512, 256, 6, 32), (4, 512, 256, 6, 16),
                                       (8, 256, 384, 1, 32), (3, 768, 128, 9, 16)],
                         ids=["g32", "g16", "one_row", "shared_experts"])
def test_expert_product_matches_jax_kernel(E, K, O, R, g, mins):
    q, sc, mn, x, ids = make_case(E, K, O, R, g, mins, seed=E + K + R)
    x8 = np.broadcast_to(x.float().numpy()[:, None], (R, 8, K)).copy()
    ref = np.asarray(jax_qmm_expert(
        jnp.asarray(x8, jnp.bfloat16), jnp.asarray(ids), jnp.asarray(q), jnp.asarray(sc),
        None if mn is None else jnp.asarray(mn), group=g, interpret=True))
    w = stack(q, sc, mn, g)
    assert tqe.supported(w)
    got = tqe.qmm_expert(x, torch.from_numpy(ids), w).numpy()
    assert got.shape == ref.shape == (R, O)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 5e-3
    assert float(np.mean((got - ref) ** 2) / np.mean(ref ** 2)) < 1e-4


def test_expert_product_is_the_per_row_dense_product():
    """Against x[r] @ dequant(W)[ids[r]] in f32: the same function up to the
    bf16 rounding of W (NMSE < 1e-4)."""
    q, sc, mn, x, ids = make_case(4, 512, 256, 7, 32, True, seed=3)
    w = stack(q, sc, mn, 32)
    wd = w.dequant(torch.float32)  # [E, K, O]
    ref = torch.stack([x[r].float() @ wd[int(ids[r])] for r in range(len(ids))])
    got = tqe.qmm_expert_plain(x, torch.from_numpy(ids), w)
    assert float(((got - ref) ** 2).mean() / (ref ** 2).mean()) < 1e-4


@pytest.mark.parametrize("change,ok", [
    ({}, True), ({"packed": True}, False), ({"transposed": False}, False),
    ({"group": 64}, False), ({"hier": True}, False), ({"two_d": True}, False),
    ({"K": 128}, False), ({"O": 64}, False)],
    ids=["stack", "packed", "row_major", "group64", "hier", "2d", "k128", "o64"])
def test_supported_names_what_the_kernel_takes(change, ok):
    K, O, g = change.get("K", 256), change.get("O", 128), change.get("group", 32)
    q = torch.zeros((2, K, O), dtype=torch.int8)
    sc = torch.ones((2, max(K // g, 1), O))
    if change.get("two_d"):
        q, sc = q[0], sc[0]
    w = QuantTensor(q=q, scales=sc, mins=None, group=g, ggml_type=int(GGMLType.Q4_K),
                    transposed=change.get("transposed", True),
                    packed=change.get("packed", False),
                    d=torch.ones((2, 1, O)) if change.get("hier") else None)
    assert tqe.supported(w) == ok


def test_split_count_divides_k_into_64_row_units():
    for K, O, R in [(4096, 14336, 2), (14336, 4096, 2), (2048, 768, 64), (768, 2048, 8),
                    (256, 128, 1)]:
        for n_groups in range(-(-R // 8), R + 1):
            s = tqe.split_count(O // 128, n_groups, K // 64, SLOTS)
            assert 1 <= s <= 16 and K % (s * 64) == 0 and s * 64 <= K


SLOTS = 264  # an H100's 132 SMs at two blocks an SM


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fmaf of f32 tensors: a * b + c with one rounding to f32."""
    return (a.double() * b.double() + c.double()).float()


def expert_emulation(x: torch.Tensor, ids, w, slots: int = SLOTS) -> torch.Tensor:
    """The CUDA kernel's arithmetic in plain PyTorch, in f32 where the
    card's step is f32 (the order of the sums inside one MMA is not
    modelled). The rows go in the kernel's expert groups (up to 8 rows of
    one expert a pass), K in its splits. Each int8 weight reaches the tensor
    cores exact and biased, as the two nibbles of q + 128: 128 + lo and 2048
    + 16 hi (bf16 128.0 and 2048.0 with the nibble in the mantissa), two
    MMAs into one f32 sum of 2304 + q a 16-row slab. Each scale group's sum
    starts from zero and is scaled once: acc = fmaf(s, sum, fmaf(m - 2304 s,
    xsum, acc)), xsum the group's f32 sum of x, so the bias and the mins
    leave through it. A split's partial sums add in split order."""
    R, K = x.shape
    E, _, O = w.q.shape
    g = w.group
    groups = tqe.expert_groups([int(i) for i in ids], E)
    splits = tqe.split_count(O // 128, len(groups), K // 64, slots)
    xb = x.to(torch.bfloat16).float()
    u = w.q.int() & 0xFF  # the byte, unsigned
    lo = (128 + (u & 0xF)).float()
    hi = (2048 + 16 * ((u >> 4) ^ 8)).float()
    assert torch.equal(lo + hi, 2304 + w.q.float())
    out = torch.zeros((R, O))
    for e, rows in groups:
        xr = xb[list(rows)]  # [n, K]
        n = len(rows)
        sc = w.scales[e].float()
        mb = fma32(torch.full_like(sc, -2304.0), sc,
                   w.mins[e].float() if w.mins is not None else torch.zeros_like(sc))
        # per 16-row slab: the lo and hi MMAs' f32 sums and the slab's sum of x
        xs16 = xr.reshape(n, K // 16, 16)
        plo = torch.einsum("nsk,sko->sno", xs16, lo[e].reshape(K // 16, 16, O))
        phi = torch.einsum("nsk,sko->sno", xs16, hi[e].reshape(K // 16, 16, O))
        px = xs16.sum(-1).T[:, :, None]  # [slabs, n, 1]
        total = torch.zeros((n, O))
        per_split = K // g // splits
        for sp in range(splits):
            acc = torch.zeros((n, O))
            for gi in range(sp * per_split, (sp + 1) * per_split):
                tmp = torch.zeros((n, O))
                xsum = torch.zeros((n, 1))
                for sl in range(gi * g // 16, (gi + 1) * g // 16):
                    tmp = (tmp + plo[sl]) + phi[sl]
                    xsum = xsum + px[sl]
                acc = fma32(sc[gi].expand(n, O), tmp, fma32(mb[gi].expand(n, O),
                                                            xsum.expand(n, O), acc))
            total = total + acc
        out[list(rows)] = total
    return out


# (E, K, O, ids): one row; 4, 8 and 9 rows of one expert beside others; 128
# experts drawn at random
EMULATION_CASES = {
    "one_row": (8, 256, 128, [5]),
    "four_of_one": (4, 256, 128, [2, 0, 2, 2, 2]),
    "eight_of_one": (4, 256, 128, [1] * 8 + [3]),
    "nine_of_one": (4, 256, 128, [0, 3, 3, 3, 1, 3, 3, 3, 3, 3, 3]),
    "experts_128": (128, 256, 128, None),
}


def emulation_case(case, g, mins):
    E, K, O, ids = EMULATION_CASES[case]
    R = 16 if ids is None else len(ids)
    q, sc, mn, x, rnd = make_case(E, K, O, R, g, mins, seed=E + R + g)
    ids = rnd if ids is None else np.asarray(ids, np.int32)
    return q, sc, mn, x, ids


@pytest.mark.parametrize("case", list(EMULATION_CASES))
@pytest.mark.parametrize("g,mins", [(32, True), (16, False), (32, False), (16, True)],
                         ids=["g32_mins", "g16", "g32", "g16_mins"])
def test_kernel_emulation_matches_jax_kernel(case, g, mins):
    """The CUDA kernel's arithmetic, emulated, against the JAX package's
    qmm_planes_expert in interpret mode: both keep f32 sums and differ by the
    TPU kernel's bf16 rounding of q * scale, which the card kernel skips."""
    q, sc, mn, x, ids = emulation_case(case, g, mins)
    R, K = x.shape
    x8 = np.broadcast_to(x.float().numpy()[:, None], (R, 8, K)).copy()
    ref = np.asarray(jax_qmm_expert(
        jnp.asarray(x8, jnp.bfloat16), jnp.asarray(ids), jnp.asarray(q), jnp.asarray(sc),
        None if mn is None else jnp.asarray(mn), group=g, interpret=True))
    got = expert_emulation(x, ids, stack(q, sc, mn, g)).numpy()
    assert got.shape == ref.shape == (R, q.shape[2])
    assert np.abs(got - ref).max() / np.abs(ref).max() < 5e-3
    assert float(np.mean((got - ref) ** 2) / np.mean(ref ** 2)) < 1e-4


@pytest.mark.parametrize("g,mins", [(32, True), (16, False), (32, False), (16, True)],
                         ids=["g32_mins", "g16", "g32", "g16_mins"])
def test_kernel_bias_cancels_through_the_group_sums(g, mins):
    """The kernel sums 2304 + q and takes the bias back out through the
    group sums of x (min - 2304 * scale). In f32 that costs almost nothing:
    the emulation is within NMSE 1e-9 of the exact function q * scale + min
    in float64 (a bf16 rounding of W, the plain version's, costs near 1e-6),
    with the rows of several groups and a K split."""
    q, sc, mn, x, ids = emulation_case("nine_of_one", g, mins)
    w = stack(q, sc, mn, g)
    got = expert_emulation(x, ids, w).double()
    wd = w.dequant(torch.float64)  # [E, K, O]
    ref = torch.stack([x[r].double() @ wd[int(ids[r])] for r in range(len(ids))])
    assert float(((got - ref) ** 2).mean() / (ref ** 2).mean()) < 1e-9


@pytest.mark.parametrize("ids,groups", [
    ([5], [(5, (0,))]),
    ([0, 1, 2, 3], [(0, (0,)), (1, (1,)), (2, (2,)), (3, (3,))]),
    ([2, 0, 2, 2, 2], [(2, (0, 2, 3, 4)), (0, (1,))]),
    ([1] * 8 + [3], [(1, tuple(range(8))), (3, (8,))]),
    ([0, 3, 3, 3, 1, 3, 3, 3, 3, 3, 3],
     [(0, (0,)), (3, (1, 2, 3, 5, 6, 7, 8, 9)), (1, (4,)), (3, (10,))]),
    ([7] * 17, [(7, tuple(range(8))), (7, tuple(range(8, 16))), (7, (16,))]),
    ([-3, 9, 2, 4], [(0, (0,)), (3, (1, 3)), (2, (2,))]),
], ids=["one_row", "distinct", "four_of_one", "eight_of_one", "nine_of_one", "seventeen",
        "clamped"])
def test_expert_groups_lead_in_row_order(ids, groups):
    """Rows numbered among their expert's rows in row order; every eighth
    leads a group of up to 8; groups in leader row order; ids clamped to
    [0, E), never outside the stack (E = 4 for "clamped", else 8)."""
    assert tqe.expert_groups(ids, 4 if min(ids) < 0 or max(ids) > 7 else 8) == groups


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_expert_groups_cover_every_row_once(seed):
    rng = np.random.default_rng(seed)
    E = [8, 16, 128][seed]
    ids = rng.integers(0, E // 4, rng.integers(1, 200)).tolist()
    groups = tqe.expert_groups(ids, E)
    rows = sorted(r for _, rs in groups for r in rs)
    assert rows == list(range(len(ids)))
    for e, rs in groups:
        assert 1 <= len(rs) <= 8 and list(rs) == sorted(rs)
        assert all(ids[r] == e for r in rs)
    leaders = [rs[0] for _, rs in groups]
    assert leaders == sorted(leaders)
    # a group is full unless it is its expert's last
    for i, (e, rs) in enumerate(groups):
        if any(e2 == e for e2, _ in groups[i + 1:]):
            assert len(rs) == 8


@pytest.mark.parametrize("shape,n_groups,want", [
    ("mixtral_gateup", 2, 4), ("mixtral_down", 2, 4), ("qwen3_gate_r8", 8, 4),
    ("qwen3_down_r8", 8, 1), ("qwen3_gate_r64", 64, 2), ("qwen3_down_r64_shared", 16, 1)])
def test_split_count_at_the_main_shapes(shape, n_groups, want):
    """K is split only where the (column tile x group) pairs fill less than
    45% of 264 slots, leave a partial second wave or units of 64 stages and
    more: four ways at Mixtral's gate/up (224 pairs of 64 stages; two would
    leave 1.7 waves) and its down (64 pairs of 224 stages), two at Qwen3's
    gate with 64 groups (384 pairs: 1.45 waves unsplit), not at its down."""
    K, O = {"mixtral_gateup": (4096, 14336), "mixtral_down": (14336, 4096),
            "qwen3_gate_r8": (2048, 768), "qwen3_down_r8": (768, 2048),
            "qwen3_down_r64_shared": (768, 2048), "qwen3_gate_r64": (2048, 768)}[shape]
    assert tqe.split_count(O // 128, n_groups, K // 64, SLOTS) == want


@pytest.mark.parametrize("R,E,K,O,grid,splits", [
    (2, 8, 4096, 14336, 264, 4), (8, 128, 768, 2048, 128, 1), (8, 128, 2048, 768, 192, 4),
    (64, 128, 768, 2048, 264, 1), (1, 8, 256, 128, 4, 4), (9, 4, 256, 128, 16, 0)])
def test_distinct_plan_sizes_the_grid_to_the_units(R, E, K, O, grid, splits):
    """One block a unit where the rows' distinct experts give fewer units
    than the card holds (Qwen3's down at R=8: 16 column tiles x 8; its
    gate: 6 x 8 x 4 splits), else the slots (Mixtral's gate/up at R=2: 112
    x 2 x 4 splits), else the
    slots; the split to guess with, none where the rows outnumber the
    experts (9 rows of 4: 4 groups x 4 splits for the grid), and never more
    than the scratch holds."""
    assert tqe.distinct_plan(R, E, K, O, SLOTS) == (grid, splits)
    assert splits <= tqe.max_splits(R, K, O, SLOTS)


@pytest.mark.parametrize("R,K,O", [(1, 256, 128), (2, 4096, 14336), (2, 14336, 4096),
                                   (8, 2048, 768), (64, 768, 2048), (512, 2048, 768)])
def test_max_splits_bounds_every_group_count(R, K, O):
    """The scratch the wrapper sizes by max_splits holds the kernel's split
    at any ids of R rows (ceil(R/8) to R groups)."""
    s_max = tqe.max_splits(R, K, O, SLOTS)
    assert 1 <= s_max <= 16
    for n in range(-(-R // 8), R + 1):
        assert tqe.split_count(O // 128, n, K // 64, SLOTS) <= s_max
