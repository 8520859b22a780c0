"""The PyTorch port's paged KV pool (in-place writes) against the JAX
package's functional PagedKVCache: the same writes, sequence removals and
page copies leave bit-identical pools, labels and tables."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama_cpp_tpu.runtime.paged_kv import PagedKVCache as JaxPool
from llama_cpp_tpu.runtime.paged_kv import PageAllocator as JaxAllocator
from llama_cpp_tpu_torch.runtime.paged_kv import KVCacheFull, PageAllocator, PagedKVCache

L, N_SEQS, N_PAGES, MAX_PAGES, HKV, D, PAGE = 2, 3, 6, 3, 2, 16, 8


def make_pools(quantized: bool):
    table = np.array([[0, 1, 5], [2, 5, 5], [3, 4, 5]], np.int32)  # 5 = trash page
    jp = JaxPool.create(L, N_SEQS, N_PAGES, MAX_PAGES, HKV, D, dtype=jnp.bfloat16,
                        quantized=quantized, page=PAGE)
    tp = PagedKVCache.create(L, N_SEQS, N_PAGES, MAX_PAGES, HKV, D, dtype=torch.bfloat16,
                             quantized=quantized, page=PAGE)
    from dataclasses import replace

    jp = replace(jp, table=jnp.asarray(table))
    tp.table.copy_(torch.from_numpy(table))
    return jp, tp


def rows(n, seed):
    x = np.random.default_rng(seed).standard_normal((n, HKV, D)).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16)


def assert_same(jp, tp):
    for il in range(L):
        for name in ("k", "v") + (("k_scale", "v_scale") if tp.quantized else ()):
            a = np.asarray(getattr(jp, name)[il]).astype(np.float32)
            b = getattr(tp, name)[il].float().numpy()
            np.testing.assert_array_equal(b, a, err_msg=f"{name}[{il}]")
    np.testing.assert_array_equal(tp.pos.numpy(), np.asarray(jp.pos))
    np.testing.assert_array_equal(tp.table.numpy(), np.asarray(jp.table))


@functools.partial(jax.jit, static_argnums=(1,))
def _jax_write(jp, il, seqs, positions, k, v):
    # jitted, as inside the JAX package's step functions (XLA's rewrite of
    # the int8 scale division is part of what the pool stores)
    return jp.write_layer(il, seqs, positions, k, v)


def write_both(jp, tp, il, seqs, positions, seed):
    k, v = rows(len(seqs), seed), rows(len(seqs), seed + 100)
    jp = _jax_write(jp, il, jnp.asarray(seqs), jnp.asarray(positions),
                    jnp.asarray(k.float().numpy(), jnp.bfloat16),
                    jnp.asarray(v.float().numpy(), jnp.bfloat16))
    tp.write_layer(il, torch.from_numpy(seqs), torch.from_numpy(positions), k, v)
    return jp


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_write_layer_matches_jax(quantized):
    jp, tp = make_pools(quantized)
    # a prefill run of seq 0 across a page boundary, then a batched decode
    # step with a padding row (position -1 -> trash row)
    for il in range(L):
        jp = write_both(jp, tp, il, np.zeros(11, np.int32), np.arange(11, dtype=np.int32),
                        seed=il)
        jp = write_both(jp, tp, il, np.array([0, 1, 2, 0], np.int32),
                        np.array([11, 0, 3, -1], np.int32), seed=10 + il)
    assert_same(jp, tp)
    slots = tp.slot_of(torch.tensor([0, 1, 2, 0]), torch.tensor([11, 0, 3, -(1 << 20)]))
    assert slots.tolist() == [1 * PAGE + 3, 2 * PAGE, 3 * PAGE + 3, tp.trash_slot]
    kj, vj, pj = jp.gather_seq(1, jnp.asarray([0, 2]))
    kt, vt, pt = tp.gather_seq(1, torch.tensor([0, 2]))
    np.testing.assert_array_equal(kt.float().numpy(), np.asarray(kj).astype(np.float32))
    np.testing.assert_array_equal(vt.float().numpy(), np.asarray(vj).astype(np.float32))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))


@pytest.mark.parametrize("p0,p1", [(0, 1 << 30), (5, 1 << 30), (2, 4)])
def test_seq_rm_matches_jax(p0, p1):
    jp, tp = make_pools(True)
    jp = write_both(jp, tp, 0, np.zeros(12, np.int32), np.arange(12, dtype=np.int32), seed=3)
    jp = write_both(jp, tp, 0, np.full(4, 2, np.int32), np.arange(4, dtype=np.int32), seed=4)
    jp = jp.seq_rm(0, p0, p1)
    tp.seq_rm(0, p0, p1)
    assert_same(jp, tp)
    assert tp.seq_len(0) == int(jp.seq_len(0)) and tp.seq_len(2) == 4


def test_copy_pages_matches_jax():
    jp, tp = make_pools(True)
    for il in range(L):
        jp = write_both(jp, tp, il, np.zeros(10, np.int32), np.arange(10, dtype=np.int32),
                        seed=20 + il)
    src, dst = np.array([0, 1], np.int32), np.array([3, 4], np.int32)
    jp = jp.copy_pages(jnp.asarray(src), jnp.asarray(dst))
    tp.copy_pages(torch.from_numpy(src), torch.from_numpy(dst))
    assert_same(jp, tp)


def test_page_allocator_matches_jax():
    ja, ta = JaxAllocator(2, 5, 3, 8), PageAllocator(2, 5, 3, 8)
    for a in (ja, ta):
        a.ensure(0, 9)
        a.ensure(1, 3)
        a.trim(0, 4)
        a.ensure(1, 17)
    np.testing.assert_array_equal(ta.table, ja.table)
    assert ta.free == ja.free and list(ta.count) == list(ja.count)
    with pytest.raises(KVCacheFull):
        ta.ensure(0, 24)
