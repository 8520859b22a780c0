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


def make_case(seed: int, bf16: bool = False, D: int = D, G: int = G, T: int = T):
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


# -- the CUDA kernels' arithmetic, emulated ------------------------------------
#
# The card's two kernels (csrc/flash_attn_common.cuh) compute the reference's
# function with its roundings: bf16 q times k (int8 values are exact in bf16)
# into f32, the k scale and sm_scale on the f32 score, softcap, mask, an
# online softmax in f32 (in the log2 domain, by exp2), p * v_scale rounded to
# bf16 times v into f32. The prefill kernel (PREFILL_MIN_ROWS rows or more)
# walks a block's live tiles in order, a 64-column tile a pass, its block
# being 128 query rows (64 for heads of 256) whose largest position sets the
# live limit; the decode kernel gives each of a block's 4 warps a 16-row
# chunk of every tile of its split, merges the warps, and the last block
# merges the splits in order with the sink term. The emulation below follows
# that order; it is held against the JAX kernels in interpret mode and the
# port's plain versions (NMSE < 1e-4, the port's tolerance against JAX).

LOG2E = 1.4426950408889634


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _online(state, q, k, v, ks, vs, cp, rp, sm_scale, window, softcap):
    """One pass of the online softmax: q [r, D], k/v [c, D], ks/vs [c] or
    None, cp [c], rp [r]; state (m, l, acc) with m in the log2 domain."""
    m, l, acc = state
    s = q @ k.T
    if ks is not None:
        s = s * ks[None]
    s = s * sm_scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    vis = (cp[None] >= 0) & (cp[None] <= rp[:, None])
    if window > 0:
        vis = vis & (cp[None] > rp[:, None] - window)
    s = torch.where(vis, s * LOG2E, torch.tensor(float("-inf")))
    m_new = torch.maximum(m, s.max(dim=1).values)
    dead = m_new == float("-inf")
    alpha = torch.where(dead, torch.ones_like(m), torch.exp2(m - m_new))
    p = torch.where(dead[:, None], torch.zeros_like(s), torch.exp2(s - m_new[:, None]))
    pv = p if vs is None else p * vs[None]
    return m_new, l * alpha + p.sum(dim=1), acc * alpha[:, None] + _bf16(pv) @ v


def _merge(states):
    """(max, sum, acc) of several online softmaxes over disjoint columns."""
    M = torch.stack([s[0] for s in states]).max(dim=0).values
    L = torch.zeros_like(M)
    A = torch.zeros_like(states[0][2])
    for m, l, acc in states:
        w = torch.where(M == float("-inf"), torch.zeros_like(m), torch.exp2(m - M))
        L = L + l * w
        A = A + acc * w[:, None]
    return M, L, A


def _finish(state, sink):
    """The sink logit in the denominator, then the normalisation (0 for a
    row with nothing visible)."""
    M, L, A = state
    scale = torch.ones_like(M)
    if sink is not None:
        sk = sink * LOG2E
        mf = torch.maximum(M, sk)
        scale = torch.where(M == float("-inf"), torch.zeros_like(M), torch.exp2(M - mf))
        L = L * scale + torch.exp2(sk - mf)
    inv = torch.where(L > 0, scale / torch.where(L > 0, L, torch.ones_like(L)),
                      torch.zeros_like(L))
    return A * inv[:, None]


def kernel_emulation(q, kt, vt, kst, vst, cpt, row_pos, sinks, live, max_tiles, *,
                     sm_scale, window=0, softcap=0.0):
    """The kernels' arithmetic over each batch row's tiles in visit order:
    q [B, Hkv, R, D] (bf16 values), kt/vt [B, Hkv, n*64, D], kst/vst [B, Hkv,
    n*64] or None, cpt [B, n*64], row_pos [B, R], sinks [Hkv, R] or None;
    live(rmax) -> the live tiles of rows whose largest position is rmax."""
    B, Hkv, R, D = q.shape
    out = torch.zeros((B, Hkv, R, D))
    prefill = tfa.route(R) == "prefill"
    block = (64 if D > 128 else 128) if prefill else 8
    splits = 1 if prefill else tfa.decode_splits(B, Hkv, R, max_tiles)
    for b in range(B):
        for h in range(Hkv):
            def cols(c0, c1):
                return (kt[b, h, c0:c1], vt[b, h, c0:c1],
                        None if kst is None else kst[b, h, c0:c1],
                        None if vst is None else vst[b, h, c0:c1], cpt[b, c0:c1])

            for r0 in range(0, R, block):
                r1 = min(r0 + block, R)
                qb, rp = q[b, h, r0:r1], row_pos[b, r0:r1]
                n = live(int(rp.max()))
                empty = (torch.full((r1 - r0,), float("-inf")), torch.zeros(r1 - r0),
                         torch.zeros((r1 - r0, D)))
                if prefill:
                    st = empty
                    for t in range(n):
                        st = _online(st, qb, *cols(t * 64, t * 64 + 64), rp, sm_scale, window,
                                     softcap)
                else:
                    tps = -(-n // splits)
                    parts = []
                    for sp in range(-(-n // tps)):  # the splits that hold tiles
                        warps = []
                        for w in range(4):
                            ws = empty
                            for t in range(sp * tps, min(sp * tps + tps, n)):
                                c0 = t * 64 + 16 * w
                                ws = _online(ws, qb, *cols(c0, c0 + 16), rp, sm_scale, window,
                                             softcap)
                            warps.append(ws)
                        parts.append(_merge(warps))
                    st = _merge(parts)
                out[b, h, r0:r1] = _finish(st, None if sinks is None else sinks[h, r0:r1])
    return out


def paged_emulation(q, k, v, row_pos, pos, table, ks, vs, sinks, *, page, **kw):
    """kernel_emulation over the pool: batch row b visits table[b]'s pages."""
    MP = table.shape[1]
    rows = (table.long()[:, :, None] * page + torch.arange(page)).reshape(len(table), -1)
    kt = k.float()[:, rows].permute(1, 0, 2, 3)
    vt = v.float()[:, rows].permute(1, 0, 2, 3)
    kst = None if ks is None else ks[:, rows].permute(1, 0, 2)
    vst = None if vs is None else vs[:, rows].permute(1, 0, 2)

    def live(rmax):
        fl = rmax // page if rmax >= 0 else -1
        return min(max(fl + 1, 1), MP) * (page // 64)

    return kernel_emulation(q.float(), kt, vt, kst, vst, pos[rows].long(), row_pos.long(),
                            sinks, live, MP * page // 64, **kw)


def slots_emulation(q, k, v, row_pos, col_pos, seq_idx, ks, vs, sinks, *, ring=False, **kw):
    """kernel_emulation over a slot table: batch row b reads seq_idx[b]."""
    S = k.shape[2]
    sel = seq_idx.long().clamp(0, k.shape[0] - 1)

    def live(rmax):
        fl = rmax // 64 if rmax >= 0 else -1
        return S // 64 if ring else min(max(fl + 1, 1), S // 64)

    return kernel_emulation(q.float(), k[sel].float(), v[sel].float(),
                            None if ks is None else ks[sel], None if vs is None else vs[sel],
                            col_pos[sel].long(), row_pos.long(), sinks, live, S // 64, **kw)


ROUTE_GT = {"decode": (2, 4), "prefill": (2, 32)}  # (G, T): R = 8 and R = 64 rows


@pytest.mark.parametrize("route", list(ROUTE_GT))
@pytest.mark.parametrize("bf16", [False, True], ids=["int8_pool", "bf16_pool"])
@pytest.mark.parametrize("head_dim", [32, 64, 128, 256], ids=["d32", "d64", "d128", "d256"])
def test_kernel_emulation_matches_jax_paged(head_dim, bf16, route):
    """Both routes at every head dim and memory type over the pool; heads of
    64 and 256 with window, softcap and sinks, 32 and 128 causal."""
    g, t = ROUTE_GT[route]
    assert tfa.route(g * t) == route
    c = make_case(3, bf16=bf16, D=head_dim, G=g, T=t)
    masks = head_dim in (64, 256)
    window, softcap = (96, 2.0) if masks else (0, 0.0)
    sm = 1.0 / np.sqrt(head_dim)
    kvdt = jnp.bfloat16 if bf16 else jnp.int8
    ref = np.asarray(jax_fa_paged(
        jnp.asarray(c["q"], jnp.bfloat16),
        jnp.asarray(c["k"].reshape(HKV, P, PAGE, head_dim), kvdt),
        jnp.asarray(c["v"].reshape(HKV, P, PAGE, head_dim), kvdt), jnp.asarray(c["row_pos"]),
        jnp.asarray(c["pos"].reshape(P, 1, PAGE)), jnp.asarray(c["table"]),
        sinks=jnp.asarray(c["sinks"]) if masks else None,
        k_scale4=None if bf16 else jnp.asarray(c["ks"].reshape(HKV, P, 1, PAGE)),
        v_scale4=None if bf16 else jnp.asarray(c["vs"].reshape(HKV, P, 1, PAGE)),
        sm_scale=sm, window=window, softcap=softcap, page=PAGE, interpret=True))

    def t_(a):
        return None if a is None else torch.from_numpy(a)

    args = (t_(c["q"]).to(torch.bfloat16), t_(c["k"]), t_(c["v"]), t_(c["row_pos"]),
            t_(c["pos"]), t_(c["table"]), t_(c["ks"]), t_(c["vs"]),
            t_(c["sinks"]) if masks else None)
    if bf16:
        args = args[:1] + (args[1].to(torch.bfloat16), args[2].to(torch.bfloat16)) + args[3:]
    kw = dict(sm_scale=sm, window=window, softcap=softcap, page=PAGE)
    emu = paged_emulation(*args, **kw).numpy()
    plain = tfa.flash_attention_paged_plain(*args, **kw).numpy()
    valid = c["row_pos"] >= 0
    e, r, p_ = (a.transpose(0, 2, 1, 3)[valid] for a in (emu, ref, plain))
    assert (emu.transpose(0, 2, 1, 3)[~valid] == 0).all()  # padding rows are 0
    assert nmse(e, r) < 1e-4
    assert nmse(e, p_) < 1e-4


@pytest.mark.parametrize("route", list(ROUTE_GT))
@pytest.mark.parametrize("ring", [False, True], ids=["table", "ring"])
@pytest.mark.parametrize("bf16", [False, True], ids=["int8", "bf16"])
def test_kernel_emulation_matches_jax_slots(bf16, ring, route):
    """The slot table on both routes, ring tables included, window, softcap
    and sinks on; batch rows pick sequences through seq_idx."""
    g, t = ROUTE_GT[route]
    c = slot_case(128, not bf16, ring, seed=11)
    rng = np.random.default_rng(12)
    R = g * t
    q = bf16_round(rng.standard_normal((len(SEQ_IDX), HKV, R, 128)).astype(np.float32) * 0.5)
    row_pos = np.stack([rng.integers(0, [170, 90, 200, 30][s], R)
                        for s in SEQ_IDX]).astype(np.int32)
    row_pos[0, -1] = -1
    sinks = rng.standard_normal((HKV, R)).astype(np.float32)
    sm = 1.0 / np.sqrt(128)
    kvdt = jnp.int8 if not bf16 else jnp.bfloat16

    def sel(a, dt=None):
        return None if a is None else jnp.asarray(a[SEQ_IDX], dt)

    ref = np.asarray(jax_fa(
        jnp.asarray(q, jnp.bfloat16), sel(c["k"], kvdt), sel(c["v"], kvdt),
        jnp.asarray(row_pos), sel(c["cp"]), sinks=jnp.asarray(sinks), k_scale=sel(c["ks"]),
        v_scale=sel(c["vs"]), sm_scale=sm, window=96, softcap=2.0, interpret=True, ring=ring))

    def t_(a, dt=None):
        return None if a is None else torch.from_numpy(a).to(dt) if dt else torch.from_numpy(a)

    kvt = torch.bfloat16 if bf16 else None
    args = (t_(q, torch.bfloat16), t_(c["k"], kvt), t_(c["v"], kvt), t_(row_pos), t_(c["cp"]),
            t_(SEQ_IDX), t_(c["ks"]), t_(c["vs"]), t_(sinks))
    kw = dict(sm_scale=sm, window=96, softcap=2.0, ring=ring)
    emu = slots_emulation(*args, **kw).numpy()
    plain = tfa.flash_attention_plain(*args, **kw).numpy()
    valid = row_pos >= 0
    e, r, p_ = (a.transpose(0, 2, 1, 3)[valid] for a in (emu, ref, plain))
    assert nmse(e, r) < 5e-3  # the JAX slot kernel rounds the scaled K/V to bf16 too
    assert nmse(e, p_) < 1e-4


@pytest.mark.parametrize("depth,Hkv", [(1900, 1), (1900, 8), (700, 2), (60, 1)],
                         ids=["deep_one_head", "deep_eight_heads", "mid", "one_tile"])
def test_decode_split_merge_emulation(monkeypatch, depth, Hkv):
    """The decode kernel's merge of its splits (the last block's, in split
    order) against one split and the plain version: each split rounds P to
    bf16 against its own running max, an NMSE near 1e-6 either way."""
    rng = np.random.default_rng(depth + Hkv)
    page, MP, G = 128, 16, 4
    S_pool = (MP + 1) * page
    k = torch.from_numpy(rng.integers(-127, 128, (Hkv, S_pool, 64)).astype(np.int8))
    v = torch.from_numpy(rng.integers(-127, 128, (Hkv, S_pool, 64)).astype(np.int8))
    ks = torch.from_numpy((rng.random((Hkv, S_pool)) * 0.02 + 0.005).astype(np.float32))
    vs = torch.from_numpy((rng.random((Hkv, S_pool)) * 0.02 + 0.005).astype(np.float32))
    pos = torch.full((S_pool,), -1, dtype=torch.int32)
    pos[: depth + 1] = torch.arange(depth + 1, dtype=torch.int32)
    table = torch.arange(MP, dtype=torch.int32)[None]
    q = torch.from_numpy(rng.standard_normal((1, Hkv, G, 64)).astype(np.float32)).to(
        torch.bfloat16)
    row_pos = torch.full((1, G), depth, dtype=torch.int32)
    sinks = torch.from_numpy(rng.standard_normal((Hkv, G)).astype(np.float32))
    args = (q, k, v, row_pos, pos, table, ks, vs, sinks)
    kw = dict(sm_scale=0.125, page=page)
    assert tfa.decode_splits(1, Hkv, G, MP * page // 64) > 1
    many = paged_emulation(*args, **kw)
    plain = tfa.flash_attention_paged_plain(*args, **kw)
    monkeypatch.setattr(tfa, "decode_splits", lambda *a: 1)
    one = paged_emulation(*args, **kw)
    assert nmse(many.numpy(), plain.numpy()) < 1e-5
    assert nmse(one.numpy(), plain.numpy()) < 1e-5


@pytest.mark.parametrize("rows", [1, 4, 8, 16, 63, 64, 65, 2048])
def test_route_takes_the_prefill_kernel_from_the_threshold(rows):
    """Rows below PREFILL_MIN_ROWS go to the decode kernel, from it to the
    prefill kernel; the decode kernel's splits stay within its bound and
    fill one block an SM where the tiles allow."""
    assert tfa.route(rows) == ("prefill" if rows >= tfa.PREFILL_MIN_ROWS else "decode")
    for B, Hkv, max_tiles in ((1, 8, 64), (1, 1, 512), (32, 8, 16), (8, 4, 3)):
        s = tfa.decode_splits(B, Hkv, rows, max_tiles)
        groups = B * Hkv * -(-rows // 8)
        assert 1 <= s <= min(max_tiles, 64)
        assert s == min(max_tiles, 64) or groups * s >= 132
