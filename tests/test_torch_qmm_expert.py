"""The indexed-expert product of the PyTorch port (K7's plain version)
against the JAX package's qmm_planes_expert (Pallas, interpret mode on the
CPU, as tests/test_pallas_qmm.py runs it): stacked int8 planes with flat f32
scales, with and without mins, groups of 16 and 32, rows that share experts.

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
        s = tqe.split_count(K, O, R)
        assert s >= 1 and K % (s * 64) == 0 and s * 64 <= K
