"""Flash attention of the PyTorch port against the JAX package's Pallas
kernels in interpret mode on the CPU. Paged (flash_attention_paged /
mha_flash_paged): int8 KV pool, GQA rows, page 128, two batch rows, causal
mask with window, softcap and sinks. Slot table (flash_attention /
mha_flash): int8 and bf16 caches, head dims 64 and 128, the same options,
ring tables, and batch rows that pick their sequence through seq_idx where
the JAX caller gathers cache[seq_idx]; NMSE < 5e-3 there, the reference's
conformance threshold (its kernel rounds P and the scaled K/V to bf16).
Only rows with a valid position are compared (padding rows are garbage by
contract).

Tolerance: NMSE < 1e-4. The TPU kernel rounds p * v_scale to bf16 before
the P.V product; the port's plain version keeps f32 (relative error about
2^-9 per term, an NMSE near 1e-6)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llama_cpp_tpu.ops.pallas.flash_attn import flash_attention as jax_fa
from llama_cpp_tpu.ops.pallas.flash_attn import flash_attention_paged as jax_fa_paged
from llama_cpp_tpu.ops.pallas.flash_attn import mha_flash as jax_mha
from llama_cpp_tpu.ops.pallas.flash_attn import mha_flash_paged as jax_mha_paged
from llama_cpp_tpu.runtime.paged_kv import PagedKVCache as JaxPagedKVCache
from llama_cpp_tpu_torch.ops.kernels import flash_attn as tfa
from llama_cpp_tpu_torch.runtime.kv_cache import KVCache
from llama_cpp_tpu_torch.runtime.paged_kv import PagedKVCache

HKV, G, T, D, PAGE, P, MP = 2, 2, 4, 128, 128, 8, 4
DEPTHS = (200, 150)


def bf16_round(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def make_case(seed: int, bf16: bool = False, D: int = D):
    """Int8 pool (or a bf16 one without scales) where sequence b holds
    positions [0, depth_b + T) in pages 2b, 2b+1; the q rows are the last T
    positions, GQA-folded (row g*T+t)."""
    rng = np.random.default_rng(seed)
    if bf16:
        k = bf16_round(rng.standard_normal((HKV, P * PAGE, D)).astype(np.float32))
        v = bf16_round(rng.standard_normal((HKV, P * PAGE, D)).astype(np.float32))
        ks = vs = None
    else:
        k = rng.integers(-127, 128, (HKV, P * PAGE, D)).astype(np.int8)
        v = rng.integers(-127, 128, (HKV, P * PAGE, D)).astype(np.int8)
        ks = (rng.random((HKV, P * PAGE)) * 0.02 + 0.005).astype(np.float32)
        vs = (rng.random((HKV, P * PAGE)) * 0.02 + 0.005).astype(np.float32)
    table = np.full((len(DEPTHS), MP), P - 1, np.int32)
    pos = np.full(P * PAGE, -1, np.int32)
    for b, dep in enumerate(DEPTHS):
        n = dep + T
        for j in range(-(-n // PAGE)):
            pid = 2 * b + j
            table[b, j] = pid
            cnt = min(PAGE, n - j * PAGE)
            pos[pid * PAGE: pid * PAGE + cnt] = np.arange(j * PAGE, j * PAGE + cnt)
    q = bf16_round(rng.standard_normal((len(DEPTHS), HKV, G * T, D)).astype(np.float32) * 0.5)
    row_pos = np.stack([np.tile(dep + np.arange(T), G) for dep in DEPTHS]).astype(np.int32)
    row_pos[1, -1] = -1  # one padding row
    sinks = rng.standard_normal((HKV, G * T)).astype(np.float32)
    return dict(q=q, k=k, v=v, ks=ks, vs=vs, table=table, pos=pos, row_pos=row_pos,
                sinks=sinks)


def nmse(got, ref):
    return float(np.mean((got - ref) ** 2) / np.mean(ref ** 2))


def paged_parity(window, softcap, use_sinks, bf16, D=D):
    c = make_case(0, bf16=bf16, D=D)
    sm = 1.0 / np.sqrt(D)
    kvdt = jnp.bfloat16 if bf16 else jnp.int8
    ref = np.asarray(jax_fa_paged(
        jnp.asarray(c["q"], jnp.bfloat16), jnp.asarray(c["k"].reshape(HKV, P, PAGE, D), kvdt),
        jnp.asarray(c["v"].reshape(HKV, P, PAGE, D), kvdt), jnp.asarray(c["row_pos"]),
        jnp.asarray(c["pos"].reshape(P, 1, PAGE)), jnp.asarray(c["table"]),
        sinks=jnp.asarray(c["sinks"]) if use_sinks else None,
        k_scale4=None if bf16 else jnp.asarray(c["ks"].reshape(HKV, P, 1, PAGE)),
        v_scale4=None if bf16 else jnp.asarray(c["vs"].reshape(HKV, P, 1, PAGE)),
        sm_scale=sm, window=window, softcap=softcap, page=PAGE, interpret=True))

    def t(a, dt=None):
        return None if a is None else torch.from_numpy(a).to(dt) if dt else torch.from_numpy(a)

    kvt = torch.bfloat16 if bf16 else None
    got = tfa.flash_attention_paged(
        t(c["q"], torch.bfloat16), t(c["k"], kvt), t(c["v"], kvt), t(c["row_pos"]),
        t(c["pos"]), t(c["table"]), t(c["ks"]), t(c["vs"]),
        t(c["sinks"]) if use_sinks else None, sm_scale=sm, window=window,
        softcap=softcap, page=PAGE).numpy()
    assert got.shape == ref.shape == (len(DEPTHS), HKV, G * T, D)
    valid = c["row_pos"] >= 0  # [B, R]
    g = got.transpose(0, 2, 1, 3)[valid]
    r = ref.transpose(0, 2, 1, 3)[valid]
    assert np.isfinite(g).all()
    assert nmse(g, r) < 1e-4


@pytest.mark.parametrize("window,softcap,use_sinks,bf16", [
    (0, 0.0, False, False), (64, 0.0, False, False), (0, 2.0, False, False),
    (0, 0.0, True, False), (96, 2.0, True, False), (0, 0.0, False, True),
    (96, 2.0, True, True)],
    ids=["causal", "window", "softcap", "sinks", "all", "bf16_pool", "bf16_pool_all"])
def test_paged_attention_matches_jax(window, softcap, use_sinks, bf16):
    paged_parity(window, softcap, use_sinks, bf16)


@pytest.mark.parametrize("window,softcap,use_sinks", [(0, 0.0, False), (96, 2.0, True)],
                         ids=["causal", "all"])
@pytest.mark.parametrize("bf16", [False, True], ids=["int8_pool", "bf16_pool"])
@pytest.mark.parametrize("head_dim", [32, 256], ids=["d32", "d256"])
def test_paged_attention_head_dims_match_jax(head_dim, bf16, window, softcap, use_sinks):
    """Heads of 32 and 256, which the JAX package also runs through its
    paged kernel."""
    paged_parity(window, softcap, use_sinks, bf16, D=head_dim)


def test_mha_flash_paged_gqa_fold_matches_jax():
    """The GQA fold wrapper over a pool object: query head h = h_kv*G + g."""
    c = make_case(1)
    B = len(DEPTHS)
    rng = np.random.default_rng(2)
    q = bf16_round(rng.standard_normal((B, T, HKV * G, D)).astype(np.float32) * 0.5)
    positions = np.stack([dep + np.arange(T) for dep in DEPTHS]).astype(np.int32)
    seq_idx = np.arange(B, dtype=np.int32)
    sm = 1.0 / np.sqrt(D)
    jpool = JaxPagedKVCache(
        k=(jnp.asarray(c["k"]),), v=(jnp.asarray(c["v"]),), pos=jnp.asarray(c["pos"]),
        table=jnp.asarray(c["table"]), k_scale=(jnp.asarray(c["ks"]),),
        v_scale=(jnp.asarray(c["vs"]),), page=PAGE)
    ref = np.asarray(jax_mha_paged(jnp.asarray(q, jnp.bfloat16), jpool, 0,
                                   jnp.asarray(seq_idx), jnp.asarray(positions),
                                   sm_scale=sm, interpret=True))
    pool = PagedKVCache(
        k=[torch.from_numpy(c["k"])], v=[torch.from_numpy(c["v"])],
        pos=torch.from_numpy(c["pos"]), table=torch.from_numpy(c["table"]),
        k_scale=[torch.from_numpy(c["ks"])], v_scale=[torch.from_numpy(c["vs"])], page=PAGE)
    got = tfa.mha_flash_paged(torch.from_numpy(q).to(torch.bfloat16), pool, 0,
                              torch.from_numpy(seq_idx), torch.from_numpy(positions),
                              sm_scale=sm).numpy()
    assert got.shape == ref.shape == (B, T, HKV * G * D)
    assert nmse(got, ref) < 1e-4


@pytest.mark.parametrize("dk,dv,n_slots,rows", [
    (128, 128, 1024, 4), (64, 64, 1024, 4), (64, 64, 1024, 16), (128, 128, 1000, 4),
    (96, 96, 1024, 32), (256, 128, 512, 1)],
    ids=["d128", "d64_decode", "d64_prefill", "slots_untileable", "d96", "d256"])
def test_attention_takes_the_kernel_where_jax_does(monkeypatch, dk, dv, n_slots, rows):
    """The port's gate for the paged kernel is the JAX package's: its
    flash_supported on an accelerator plus the small-head row rule."""
    import llama_cpp_tpu.ops.pallas.flash_attn as jfa

    monkeypatch.setattr(jfa, "_FORCE", True)  # as on a TPU
    jax_kernel = jfa.flash_supported(dk, dv, n_slots) and not (min(dk, dv) < 128 and rows < 16)
    assert tfa.dispatches(dk, dv, n_slots, rows) == jax_kernel


# -- slot table --------------------------------------------------------------

N_SEQS, S_SLOTS, R_ROWS = 4, 256, 12
SEQ_IDX = np.array([2, 0, 2], np.int32)  # two batch rows share a sequence


def slot_case(D, quantized, ring=False, seed=0):
    """A cache of N_SEQS sequences with ragged fills; ring tables hold their
    positions rotated (slot order is not position order)."""
    rng = np.random.default_rng(seed)
    fills = [170, 90, 200, 30]
    if quantized:
        k = rng.integers(-127, 128, (N_SEQS, HKV, S_SLOTS, D)).astype(np.int8)
        v = rng.integers(-127, 128, (N_SEQS, HKV, S_SLOTS, D)).astype(np.int8)
        ks = (rng.random((N_SEQS, HKV, S_SLOTS)) * 0.02 + 0.005).astype(np.float32)
        vs = (rng.random((N_SEQS, HKV, S_SLOTS)) * 0.02 + 0.005).astype(np.float32)
    else:
        k = bf16_round(rng.standard_normal((N_SEQS, HKV, S_SLOTS, D)).astype(np.float32))
        v = bf16_round(rng.standard_normal((N_SEQS, HKV, S_SLOTS, D)).astype(np.float32))
        ks = vs = None
    cp = np.full((N_SEQS, S_SLOTS), -1, np.int32)
    for s, f in enumerate(fills):
        cp[s, :f] = np.arange(f)
        if ring:
            cp[s] = np.roll(cp[s], 100 + 7 * s)
    q = bf16_round(rng.standard_normal((len(SEQ_IDX), HKV, R_ROWS, D)).astype(np.float32) * 0.5)
    row_pos = np.stack([rng.integers(0, fills[s], R_ROWS) for s in SEQ_IDX]).astype(np.int32)
    row_pos[0, -2:] = -1  # padding rows
    sinks = rng.standard_normal((HKV, R_ROWS)).astype(np.float32)
    return dict(q=q, k=k, v=v, ks=ks, vs=vs, cp=cp, row_pos=row_pos, sinks=sinks)


@pytest.mark.parametrize("ring", [False, True], ids=["table", "ring"])
@pytest.mark.parametrize("window,softcap,use_sinks", [
    (0, 0.0, False), (64, 0.0, False), (0, 2.0, False), (0, 0.0, True), (96, 2.0, True)],
    ids=["causal", "window", "softcap", "sinks", "all"])
@pytest.mark.parametrize("quantized", [True, False], ids=["int8", "bf16"])
@pytest.mark.parametrize("D", [64, 128, 32, 256], ids=["d64", "d128", "d32", "d256"])
def test_slot_table_attention_matches_jax(D, quantized, window, softcap, use_sinks, ring):
    c = slot_case(D, quantized, ring, seed=D + window)
    sm = 1.0 / np.sqrt(D)
    kvdt = jnp.int8 if quantized else jnp.bfloat16

    def sel(a, dt=None):  # the JAX caller's gather of the batch rows' sequences
        return None if a is None else jnp.asarray(a[SEQ_IDX], dt)

    ref = np.asarray(jax_fa(
        jnp.asarray(c["q"], jnp.bfloat16), sel(c["k"], kvdt), sel(c["v"], kvdt),
        jnp.asarray(c["row_pos"]), sel(c["cp"]),
        sinks=jnp.asarray(c["sinks"]) if use_sinks else None, k_scale=sel(c["ks"]),
        v_scale=sel(c["vs"]), sm_scale=sm, window=window, softcap=softcap, interpret=True,
        ring=ring))

    def t(a, dt=None):
        return None if a is None else torch.from_numpy(a).to(dt) if dt else torch.from_numpy(a)

    kvt = None if quantized else torch.bfloat16
    got = tfa.flash_attention(
        t(c["q"], torch.bfloat16), t(c["k"], kvt), t(c["v"], kvt), t(c["row_pos"]), t(c["cp"]),
        t(SEQ_IDX), t(c["ks"]), t(c["vs"]), t(c["sinks"]) if use_sinks else None, sm_scale=sm,
        window=window, softcap=softcap, ring=ring).numpy()
    assert got.shape == ref.shape == (len(SEQ_IDX), HKV, R_ROWS, D)
    valid = c["row_pos"] >= 0
    g = got.transpose(0, 2, 1, 3)[valid]
    r = ref.transpose(0, 2, 1, 3)[valid]
    assert np.isfinite(g).all()
    assert nmse(g, r) < 5e-3


@pytest.mark.parametrize("D", [64, 128], ids=["d64", "d128"])
def test_mha_flash_gqa_fold_matches_jax(D):
    """The GQA fold wrapper over a KVCache object, sequences picked by
    seq_idx inside the port's function."""
    c = slot_case(D, True, seed=5)
    B = len(SEQ_IDX)
    rng = np.random.default_rng(6)
    q = bf16_round(rng.standard_normal((B, T, HKV * G, D)).astype(np.float32) * 0.5)
    positions = np.stack([[170, 90, 200, 30][s] - T + np.arange(T)
                          for s in SEQ_IDX]).astype(np.int32)
    sinks = rng.standard_normal(HKV * G).astype(np.float32)
    sm = 1.0 / np.sqrt(D)
    ref = np.asarray(jax_mha(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(c["k"][SEQ_IDX]), jnp.asarray(c["v"][SEQ_IDX]),
        jnp.asarray(positions), jnp.asarray(c["cp"][SEQ_IDX]), sm_scale=sm,
        sinks=jnp.asarray(sinks), k_scale=jnp.asarray(c["ks"][SEQ_IDX]),
        v_scale=jnp.asarray(c["vs"][SEQ_IDX]), interpret=True))
    cache = KVCache(k=[torch.from_numpy(c["k"])], v=[torch.from_numpy(c["v"])],
                    pos=torch.from_numpy(c["cp"]), k_scale=[torch.from_numpy(c["ks"])],
                    v_scale=[torch.from_numpy(c["vs"])])
    got = tfa.mha_flash(torch.from_numpy(q).to(torch.bfloat16), cache, 0,
                        torch.from_numpy(SEQ_IDX), torch.from_numpy(positions), sm_scale=sm,
                        sinks=torch.from_numpy(sinks)).numpy()
    assert got.shape == ref.shape == (B, T, HKV * G * D)
    assert nmse(got, ref) < 5e-3


@pytest.mark.parametrize("dk,dv,page,dtype,ok", [
    (128, 128, 512, torch.int8, True), (64, 64, 256, torch.bfloat16, True),
    (32, 32, 512, torch.int8, True), (256, 256, 512, torch.bfloat16, True),
    (128, 64, 512, torch.int8, False), (128, 128, 96, torch.int8, False),
    (128, 128, 512, torch.float16, False)],
    ids=["d128", "d64", "d32", "d256", "dk_ne_dv", "page96", "f16"])
def test_supported_names_what_the_kernels_take(dk, dv, page, dtype, ok):
    """Head dims 32, 64, 128 and 256 run; unequal K/V dims raise on the card
    where the JAX package would run its kernel."""
    assert tfa.supported(dk, dv, page, dtype) == ok


@pytest.mark.parametrize("head_dim", [32, 64, 96, 128, 192, 256, 512])
def test_supported_agrees_with_dispatches_for_equal_head_dims(head_dim):
    """Where K and V heads are alike and at most 256 wide, the kernels take
    exactly the head dims the JAX package sends to its kernel (at a prefill
    row count). Wider multiples of 128 (512 here) come with no arch the port
    loads and still raise."""
    sent = tfa.dispatches(head_dim, head_dim, 1024, 64)
    assert tfa.supported(head_dim, head_dim, 512, torch.int8) == (sent and head_dim <= 256)
