"""The slot-table KVCache of the PyTorch port against the JAX package's
(runtime/kv_cache.py): the same writes (single row, a contiguous prefill
run with padding rows, a batched scatter), seq_rm and seq_cp leave the same
position table and, on every slot that holds a position, the same K/V bytes
and row scales (int8) or values (bf16). Slots without a position are
masked by every reader and not compared: the JAX contiguous write parks
padding rows behind the run, the port's scatter sends them to the trash
slot."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_tpu.runtime.kv_cache import KVCache as JaxKVCache
from llama_cpp_tpu_torch.models.from_jax import kv_cache_from_jax
from llama_cpp_tpu_torch.runtime.kv_cache import KVCache

L, NSEQ, SLOTS, HKV, D = 2, 3, 64, 2, 32
KV = pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])


def bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).to(torch.bfloat16)


def pair(quantized, ring=False):
    return (KVCache.create(L, NSEQ, SLOTS, HKV, D, quantized=quantized, ring=ring),
            JaxKVCache.create(L, NSEQ, SLOTS, HKV, D, quantized=quantized, ring=ring))


@functools.partial(jax.jit, static_argnums=(1, 6))
def jax_write(jkv, layer, seq_idx, positions, k, v, contiguous):
    # jitted, as inside the JAX package's step functions (XLA rewrites the
    # quantizer's amax / 127 to a product with the f32 reciprocal)
    return jkv.write_layer(layer, seq_idx, positions, k, v, contiguous=contiguous)


def write_both(kv, jkv, layer, seq_idx, positions, rng, contiguous=False):
    n = len(seq_idx)
    k = bf16(rng.standard_normal((n, HKV, D)).astype(np.float32))
    v = bf16(rng.standard_normal((n, HKV, D)).astype(np.float32))
    kv.write_layer(layer, torch.tensor(seq_idx), torch.tensor(positions), k, v)
    return jax_write(jkv, layer, jnp.asarray(seq_idx, jnp.int32),
                     jnp.asarray(positions, jnp.int32),
                     jnp.asarray(k.float().numpy(), jnp.bfloat16),
                     jnp.asarray(v.float().numpy(), jnp.bfloat16), contiguous)


def assert_same(kv, jkv):
    pos = np.asarray(jkv.pos)
    live = pos >= 0  # [n_seqs, slots]
    np.testing.assert_array_equal(np.where(live, kv.pos.numpy(), -1), np.where(live, pos, -1))
    assert ((kv.pos.numpy() >= 0) == live).all()
    for li in range(L):
        for mine, theirs in ((kv.k[li], jkv.k[li]), (kv.v[li], jkv.v[li])):
            a = mine.float().numpy().transpose(0, 2, 1, 3)[live]
            b = np.asarray(theirs.astype(jnp.float32)).transpose(0, 2, 1, 3)[live]
            np.testing.assert_array_equal(a, b)
        if kv.quantized:
            for mine, theirs in ((kv.k_scale[li], jkv.k_scale[li]),
                                 (kv.v_scale[li], jkv.v_scale[li])):
                np.testing.assert_array_equal(mine.numpy().transpose(0, 2, 1)[live],
                                              np.asarray(theirs).transpose(0, 2, 1)[live])


def fill(kv, jkv, rng):
    """Prefill runs (with padding rows) on two sequences, a batched decode
    scatter with a padding row, a single-row decode; every layer."""
    for layer in range(L):
        jkv = write_both(kv, jkv, layer, [0] * 16, list(range(12)) + [-1] * 4, rng, True)
        jkv = write_both(kv, jkv, layer, [2] * 8, list(range(8)), rng, True)
        jkv = write_both(kv, jkv, layer, [0, 2, 0, 0], [12, 8, -1, -(1 << 20)], rng)
        jkv = write_both(kv, jkv, layer, [2], [9], rng)
    return jkv


@KV
def test_writes_store_the_same_rows(quantized):
    kv, jkv = pair(quantized)
    jkv = fill(kv, jkv, np.random.default_rng(0))
    assert kv.quantized == quantized and kv.n_slots == SLOTS and kv.capacity == SLOTS - 1
    assert_same(kv, jkv)
    assert [kv.seq_len(s) for s in range(NSEQ)] == [int(jkv.seq_len(s)) for s in range(NSEQ)]
    assert kv.seq_len(0) == 13 and kv.seq_len(2) == 10


@KV
def test_read_dequantizes_as_jax_does(quantized):
    kv, jkv = pair(quantized)
    jkv = fill(kv, jkv, np.random.default_rng(1))
    live = np.asarray(jkv.pos) >= 0
    for li in range(L):
        k, v = kv.read(li)
        jk, jv = jkv.read(li)
        for a, b in ((k, jk), (v, jv)):
            np.testing.assert_array_equal(
                a.float().numpy().transpose(0, 2, 1, 3)[live],
                np.asarray(b.astype(jnp.float32)).transpose(0, 2, 1, 3)[live])
    ks, _ = kv.read(0, torch.tensor([2, 0]))
    np.testing.assert_array_equal(ks.float().numpy(), kv.read(0)[0][[2, 0]].float().numpy())


@KV
def test_seq_rm_and_seq_cp_match_jax(quantized):
    kv, jkv = pair(quantized)
    jkv = fill(kv, jkv, np.random.default_rng(2))
    kv.seq_cp(1, 0)
    jkv = jkv.seq_cp(1, 0)
    kv.seq_rm(0, 5)
    jkv = jkv.seq_rm(0, 5)
    kv.seq_rm(2, 2, 4)
    jkv = jkv.seq_rm(2, 2, 4)
    assert_same(kv, jkv)
    assert kv.seq_len(0) == 5 and kv.seq_len(1) == 13 and kv.seq_len(2) == 8
    kv.seq_cp(1, 1)  # onto itself: nothing moves
    assert_same(kv, jkv)
    # the copy does not alias its source: a later write to seq 0 leaves seq 1
    before = kv.k[0][1].clone()
    write_both(kv, jkv, 0, [0], [3], np.random.default_rng(3))
    assert torch.equal(kv.k[0][1], before)


@pytest.mark.parametrize("ring", [False, True], ids=["table", "ring"])
def test_slot_of_matches_jax(ring):
    kv, jkv = pair(False, ring=ring)
    pos = np.array([0, 1, 62, 63, 64, 200, -1, -(1 << 20)], np.int32)
    np.testing.assert_array_equal(kv.slot_of(torch.from_numpy(pos)).numpy(),
                                  np.asarray(jkv.slot_of(jnp.asarray(pos))))
    assert kv.layer_view(1) == (kv, 1) and kv.ring == ring


@KV
def test_kv_cache_from_jax_carries_the_state(quantized):
    kv, jkv = pair(quantized)
    jkv = fill(kv, jkv, np.random.default_rng(4))
    conv = kv_cache_from_jax(jax.tree_util.tree_map(np.asarray, jkv))
    assert conv.quantized == quantized and conv.ring is False and len(conv.k) == L
    assert_same(conv, jkv)
    np.testing.assert_array_equal(conv.pos.numpy(), np.asarray(jkv.pos))
