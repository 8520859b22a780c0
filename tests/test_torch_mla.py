"""The attention kernels' MLA instantiation (one KV head, K rows of 576 or
640, V rows of 512: DeepSeek's absorbed latent cache) on the CPU: the
port's plain versions of K5 (flash_attention_paged) and K6 (flash_attention)
at these dims against the JAX package's Pallas kernels in interpret mode on
the same inputs, and an emulation of the CUDA kernel's arithmetic
(csrc/flash_attn_mla.cuh) held against both.

The CUDA kernel walks KV sub-tiles of 16 rows in order through an online
softmax (bf16 q times k into f32, the k scale and sm_scale on the score, p *
v_scale rounded to bf16 times v into f32), a block being 64 query rows (16
on the decode route up to 16 rows) whose largest position sets the live
limit; two warps of a row group each own half of Dv (256 columns) and
recompute the same scores; the decode route splits the live 64-row tiles
over blocks and the last block merges the splits in order.

Tolerances: NMSE < 1e-4 between the emulation, the plain versions and the
JAX paged kernel (p * v_scale rounded to bf16 against f32, an NMSE near
1e-6); NMSE < 5e-3 against the JAX slot kernel, which also rounds the
scaled K/V to bf16 (the reference's conformance threshold)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import llama_cpp_tpu.ops.pallas.flash_attn as jfa
from llama_cpp_tpu.ops.pallas.flash_attn import flash_attention as jax_fa
from llama_cpp_tpu.ops.pallas.flash_attn import flash_attention_paged as jax_fa_paged
from llama_cpp_tpu.ops.pallas.flash_attn import mha_flash_paged as jax_mha_paged
from llama_cpp_tpu.runtime.paged_kv import PagedKVCache as JaxPagedKVCache
from llama_cpp_tpu_torch.ops.kernels import flash_attn as tfa
from llama_cpp_tpu_torch.runtime.paged_kv import PagedKVCache
from llama_cpp_tpu_torch.tools import conformance

PAGE, P, MP, DV = 128, 8, 4, 512
DEPTHS = (200, 150)
ROUTES = {"decode": (16, 1), "prefill": (16, 4)}  # (G, T): R = 16 and 64 rows
LOG2E = 1.4426950408889634


def bf16_round(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def nmse(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.mean((got - ref) ** 2) / np.mean(ref ** 2))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_case(seed: int, Dk: int, bf16: bool, G: int, T: int):
    """A one-head pool of P pages (int8 with row scales, or bf16) where
    batch row b holds positions [0, depth_b + T) in pages 2b, 2b + 1 (and on
    in order); the q rows are the last T positions of each of G heads (row
    g * T + t), one a padding row."""
    rng = np.random.default_rng(seed)
    if bf16:
        k = bf16_round(rng.standard_normal((1, P * PAGE, Dk)).astype(np.float32) * 0.5)
        v = bf16_round(rng.standard_normal((1, P * PAGE, DV)).astype(np.float32))
        ks = vs = None
    else:
        k = rng.integers(-127, 128, (1, P * PAGE, Dk)).astype(np.int8)
        v = rng.integers(-127, 128, (1, P * PAGE, DV)).astype(np.int8)
        ks = (rng.random((1, P * PAGE)) * 0.004 + 0.001).astype(np.float32)
        vs = (rng.random((1, P * PAGE)) * 0.02 + 0.005).astype(np.float32)
    table = np.full((len(DEPTHS), MP), P - 1, np.int32)
    pos = np.full(P * PAGE, -1, np.int32)
    for b, dep in enumerate(DEPTHS):
        n = dep + T
        for j in range(-(-n // PAGE)):
            pid = 2 * b + j
            table[b, j] = pid
            cnt = min(PAGE, n - j * PAGE)
            pos[pid * PAGE: pid * PAGE + cnt] = np.arange(j * PAGE, j * PAGE + cnt)
    q = bf16_round(rng.standard_normal((len(DEPTHS), 1, G * T, Dk)).astype(np.float32) * 0.5)
    row_pos = np.stack([np.tile(dep + np.arange(T), G) for dep in DEPTHS]).astype(np.int32)
    row_pos[1, -1] = -1
    return dict(q=q, k=k, v=v, ks=ks, vs=vs, table=table, pos=pos, row_pos=row_pos,
                sm=3.0 / np.sqrt(Dk))


def port_args(c, bf16):
    kvt = torch.bfloat16 if bf16 else None

    def t(a, dt=None):
        return None if a is None else torch.from_numpy(a).to(dt) if dt else torch.from_numpy(a)

    return (t(c["q"], torch.bfloat16), t(c["k"], kvt), t(c["v"], kvt), t(c["row_pos"]),
            t(c["pos"]), t(c["table"]), t(c["ks"]), t(c["vs"]))


# -- an emulation of the CUDA kernel's arithmetic --------------------------------

def _online(state, q, k, v, ks, vs, cp, rp, sm_scale):
    """One 16-row sub-tile through the online softmax; the two Dv halves
    take the same P (each warp of a row group recomputes it)."""
    m, l, acc = state
    s = q @ k.T
    if ks is not None:
        s = s * ks[None]
    s = s * sm_scale
    vis = (cp[None] >= 0) & (cp[None] <= rp[:, None])
    s = torch.where(vis, s * LOG2E, torch.tensor(float("-inf")))
    m_new = torch.maximum(m, s.max(dim=1).values)
    dead = m_new == float("-inf")
    alpha = torch.where(dead, torch.ones_like(m), torch.exp2(m - m_new))
    p = torch.where(dead[:, None], torch.zeros_like(s), torch.exp2(s - m_new[:, None]))
    pv = (p if vs is None else p * vs[None]).to(torch.bfloat16).float()
    halves = [pv @ v[:, h * 256:(h + 1) * 256] for h in range(DV // 256)]
    return m_new, l * alpha + p.sum(dim=1), acc * alpha[:, None] + torch.cat(halves, dim=1)


def mla_emulation(q, k, v, row_pos, pos, table, ks, vs, *, sm_scale, page=PAGE):
    """The kernel over the pool, block by block, split by split."""
    B, _, R, Dk = q.shape
    MP_ = table.shape[1]
    rows = (table.long()[:, :, None] * page + torch.arange(page)).reshape(B, -1)
    prefill = tfa.route(R) == "prefill"
    block = 64 if prefill or R > 16 else 16
    splits = 1 if prefill else tfa.mla_splits(B, 1, MP_ * page // 64)
    out = torch.zeros((B, 1, R, DV))
    for b in range(B):
        kt, vt, cp = k[0, rows[b]].float(), v[0, rows[b]].float(), pos[rows[b]].long()
        kst = None if ks is None else ks[0, rows[b]]
        vst = None if vs is None else vs[0, rows[b]]
        for r0 in range(0, R, block):
            r1 = min(r0 + block, R)
            qb, rp = q[b, 0, r0:r1].float(), row_pos[b, r0:r1].long()
            rmax = int(rp.max())
            n = min(max((rmax // page if rmax >= 0 else -1) + 1, 1), MP_) * (page // 64)
            tps = -(-n // splits)
            parts = []
            for sp in range(-(-n // tps)):
                st = (torch.full((r1 - r0,), float("-inf")), torch.zeros(r1 - r0),
                      torch.zeros((r1 - r0, DV)))
                for t in range(sp * tps, min(sp * tps + tps, n)):
                    for c0 in range(t * 64, t * 64 + 64, 16):
                        sl = slice(c0, c0 + 16)
                        st = _online(st, qb, kt[sl], vt[sl], None if kst is None else kst[sl],
                                     None if vst is None else vst[sl], cp[sl], rp, sm_scale)
                parts.append(st)
            M = torch.stack([s[0] for s in parts]).max(dim=0).values
            L, A = torch.zeros_like(M), torch.zeros((r1 - r0, DV))
            for m, l, acc in parts:
                w = torch.where(M == float("-inf"), torch.zeros_like(m), torch.exp2(m - M))
                L, A = L + l * w, A + acc * w[:, None]
            out[b, 0, r0:r1] = torch.where(L[:, None] > 0, A / torch.where(
                L > 0, L, torch.ones_like(L))[:, None], torch.zeros_like(A))
    return out


def jax_paged(c, bf16, Dk):
    kvdt = jnp.bfloat16 if bf16 else jnp.int8
    return np.asarray(jax_fa_paged(
        jnp.asarray(c["q"], jnp.bfloat16), jnp.asarray(c["k"].reshape(1, P, PAGE, Dk), kvdt),
        jnp.asarray(c["v"].reshape(1, P, PAGE, DV), kvdt), jnp.asarray(c["row_pos"]),
        jnp.asarray(c["pos"].reshape(P, 1, PAGE)), jnp.asarray(c["table"]),
        k_scale4=None if bf16 else jnp.asarray(c["ks"].reshape(1, P, 1, PAGE)),
        v_scale4=None if bf16 else jnp.asarray(c["vs"].reshape(1, P, 1, PAGE)),
        sm_scale=c["sm"], page=PAGE, interpret=True))


def valid_rows(c, *outs):
    valid = c["row_pos"] >= 0
    return [np.asarray(o).transpose(0, 2, 1, 3)[valid] for o in outs]


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("bf16", [False, True], ids=["int8", "bf16"])
@pytest.mark.parametrize("Dk", [576, 640], ids=["dk576", "dk640"])
def test_paged_plain_and_emulation_match_jax(Dk, bf16, route):
    """K5 at (Dk, 512), one KV head, both routes, int8 and bf16 pools: the
    port's plain version and the kernel's emulation against the JAX
    package's flash_attention_paged in interpret mode."""
    G, T = ROUTES[route]
    assert tfa.route(G * T) == route
    c = make_case(1, Dk, bf16, G, T)
    ref = jax_paged(c, bf16, Dk)
    args = port_args(c, bf16)
    plain = tfa.flash_attention_paged(*args, sm_scale=c["sm"], page=PAGE).numpy()
    emu = mla_emulation(*args, sm_scale=c["sm"]).numpy()
    assert plain.shape == emu.shape == ref.shape == (2, 1, G * T, DV)
    e, r, p_ = valid_rows(c, emu, ref, plain)
    assert (emu.transpose(0, 2, 1, 3)[c["row_pos"] < 0] == 0).all()
    assert nmse(p_, r) < 1e-4
    assert nmse(e, r) < 1e-4
    assert nmse(e, p_) < 1e-4


@pytest.mark.parametrize("bf16", [False, True], ids=["int8", "bf16"])
@pytest.mark.parametrize("Dk", [576, 640], ids=["dk576", "dk640"])
def test_slot_plain_matches_jax(Dk, bf16):
    """K6 at (Dk, 512), one KV head: the port's flash_attention reads
    sequence seq_idx[b] of the slot table in place where the JAX caller
    gathers cache[seq_idx] for its flash_attention (interpret mode); at 576,
    which the JAX slot kernel does not take (no lane multiple), against the
    reference's f64 oracle (tools/conformance.ref_attention)."""
    rng = np.random.default_rng(Dk)
    n_seqs, S, G, T = 3, 512, 16, 2
    fills = (300, 129, 40)
    if bf16:
        k = bf16_round(rng.standard_normal((n_seqs, 1, S, Dk)).astype(np.float32) * 0.5)
        v = bf16_round(rng.standard_normal((n_seqs, 1, S, DV)).astype(np.float32))
        ks = vs = None
    else:
        k = rng.integers(-127, 128, (n_seqs, 1, S, Dk)).astype(np.int8)
        v = rng.integers(-127, 128, (n_seqs, 1, S, DV)).astype(np.int8)
        ks = (rng.random((n_seqs, 1, S)) * 0.004 + 0.001).astype(np.float32)
        vs = (rng.random((n_seqs, 1, S)) * 0.02 + 0.005).astype(np.float32)
    cp = np.full((n_seqs, S), -1, np.int32)
    for s, f in enumerate(fills):
        cp[s, :f] = np.arange(f)
    seq_idx = np.asarray([2, 0], np.int32)
    q = bf16_round(rng.standard_normal((2, 1, G * T, Dk)).astype(np.float32) * 0.5)
    row_pos = np.stack([np.tile(fills[s] - T + np.arange(T), G) for s in seq_idx]).astype(
        np.int32)
    sm = 3.0 / np.sqrt(Dk)
    kvdt = jnp.bfloat16 if bf16 else jnp.int8

    def sel(a, dt=None):
        return None if a is None else jnp.asarray(a[seq_idx], dt)

    if Dk % 128 == 0:
        ref = np.asarray(jax_fa(jnp.asarray(q, jnp.bfloat16), sel(k, kvdt), sel(v, kvdt),
                                jnp.asarray(row_pos), sel(cp), k_scale=sel(ks),
                                v_scale=sel(vs), sm_scale=sm, interpret=True))
    else:  # the JAX slot kernel takes lane multiples only: the reference's f64 oracle
        ref = conformance.ref_attention(q, k[seq_idx], v[seq_idx], row_pos, cp[seq_idx], sm,
                                        k_scale=None if ks is None else ks[seq_idx],
                                        v_scale=None if vs is None else vs[seq_idx])
    kvt = torch.bfloat16 if bf16 else None

    def t(a, dt=None):
        return None if a is None else torch.from_numpy(a).to(dt) if dt else torch.from_numpy(a)

    got = tfa.flash_attention(t(q, torch.bfloat16), t(k, kvt), t(v, kvt), t(row_pos), t(cp),
                              t(seq_idx), t(ks), t(vs), sm_scale=sm).numpy()
    assert got.shape == ref.shape == (2, 1, G * T, DV)
    assert nmse(got, ref) < 5e-3


@pytest.mark.parametrize("depth", [60, 1900], ids=["one_tile", "deep"])
def test_decode_split_merge_emulation(monkeypatch, depth):
    """The decode route's merge of its splits (16-row block, the live tiles
    spread one or more a split) against one split and the plain version."""
    rng = np.random.default_rng(depth)
    page, mp, G = 128, 16, 16
    S_pool = (mp + 1) * page
    k = torch.from_numpy(rng.integers(-127, 128, (1, S_pool, 640)).astype(np.int8))
    v = torch.from_numpy(rng.integers(-127, 128, (1, S_pool, DV)).astype(np.int8))
    ks = torch.from_numpy((rng.random((1, S_pool)) * 0.004 + 0.001).astype(np.float32))
    vs = torch.from_numpy((rng.random((1, S_pool)) * 0.02 + 0.005).astype(np.float32))
    pos = torch.full((S_pool,), -1, dtype=torch.int32)
    pos[: depth + 1] = torch.arange(depth + 1, dtype=torch.int32)
    table = torch.arange(mp, dtype=torch.int32)[None]
    q = torch.from_numpy(rng.standard_normal((1, 1, G, 640)).astype(np.float32) * 0.5).to(
        torch.bfloat16)
    row_pos = torch.full((1, G), depth, dtype=torch.int32)
    args = (q, k, v, row_pos, pos, table, ks, vs)
    sm = 3.0 / np.sqrt(640)
    assert tfa.mla_splits(1, 1, mp * page // 64) > 1
    many = mla_emulation(*args, sm_scale=sm, page=page)
    plain = tfa.flash_attention_paged_plain(*args, sm_scale=sm, page=page)
    monkeypatch.setattr(tfa, "mla_splits", lambda *a: 1)
    one = mla_emulation(*args, sm_scale=sm, page=page)
    assert nmse(many.numpy(), plain.numpy()) < 1e-5
    assert nmse(one.numpy(), plain.numpy()) < 1e-5


def test_mha_flash_paged_fold_at_mla_dims():
    """The GQA fold over a port PagedKVCache at (640, 512) with 16 query
    heads on the one KV head, against the JAX mha_flash_paged (interpret) on
    the same pool."""
    c = make_case(5, 640, False, 16, 3)
    B, T, G = 2, 3, 16
    q4 = c["q"].reshape(B, G, T, 640).transpose(0, 2, 1, 3)  # [B, T, H, Dk]
    positions = c["row_pos"][:, :T].copy()
    positions[1, -1] = -1
    seq_idx = np.arange(B, dtype=np.int32)
    jpool = JaxPagedKVCache(
        k=(jnp.asarray(c["k"]),), v=(jnp.asarray(c["v"]),), pos=jnp.asarray(c["pos"]),
        table=jnp.asarray(c["table"]), k_scale=(jnp.asarray(c["ks"]),),
        v_scale=(jnp.asarray(c["vs"]),), page=PAGE)
    ref = np.asarray(jax_mha_paged(jnp.asarray(q4, jnp.bfloat16), jpool, 0,
                                   jnp.asarray(seq_idx), jnp.asarray(positions),
                                   sm_scale=c["sm"], interpret=True))
    pool = PagedKVCache(
        k=[torch.from_numpy(c["k"])], v=[torch.from_numpy(c["v"])],
        pos=torch.from_numpy(c["pos"]), table=torch.from_numpy(c["table"]),
        k_scale=[torch.from_numpy(c["ks"])], v_scale=[torch.from_numpy(c["vs"])], page=PAGE)
    got = tfa.mha_flash_paged(torch.from_numpy(np.ascontiguousarray(q4)).to(torch.bfloat16),
                              pool, 0, torch.from_numpy(seq_idx), torch.from_numpy(positions),
                              sm_scale=c["sm"]).numpy()
    assert got.shape == ref.shape == (B, T, G * DV)
    keep = positions >= 0
    assert nmse(got[keep], ref[keep]) < 1e-4


@pytest.mark.parametrize("dk,dv,heads,ok", [
    (640, 512, 1, True), (576, 512, 1, True), (640, 512, 2, False), (576, 448, 1, False),
    (192, 128, 16, False), (512, 512, 1, False)],
    ids=["dk640", "dk576", "two_heads", "dv448", "naive_192_128", "d512_alike"])
def test_supported_takes_the_mla_pairs_over_one_head(dk, dv, heads, ok):
    """The kernels take (576 | 640, 512) over one KV head and no other
    unequal pair; int8 and bf16 memories of whole tiles only."""
    assert tfa.supported(dk, dv, 512, torch.int8, heads) == ok
    assert tfa.supported(dk, dv, 512, torch.bfloat16, heads) == ok
    assert not tfa.supported(dk, dv, 96, torch.int8, heads)
    assert not tfa.supported(dk, dv, 512, torch.float16, heads)


@pytest.mark.parametrize("dk,dv", [(640, 512), (576, 512), (192, 128)],
                         ids=["absorbed", "conformance_576", "naive"])
def test_dispatch_at_mla_dims_is_the_jax_packages(monkeypatch, dk, dv):
    """Where the JAX package sends DeepSeek's attention to its kernel: the
    absorbed cache (640, 512) goes, the naive expansion (192, 128) does not
    (192 is no lane multiple), nor 576 (only the conformance rows call the
    kernel at 576, directly)."""
    monkeypatch.setattr(jfa, "_FORCE", True)  # as on a TPU
    for rows in (16, 128):
        assert tfa.dispatches(dk, dv, 4608, rows) == jfa.flash_supported(dk, dv, 4608)
    assert tfa.dispatches(640, 512, 4608, 16)
    assert not tfa.dispatches(192, 128, 4608, 128)


def test_mla_splits_fill_the_card_within_the_bound():
    """One block a row tile (all rows of a KV head), so the splits alone
    fill the 132 SMs where the live tiles allow, at most 64."""
    assert tfa.mla_splits(1, 1, 64) == 64
    assert tfa.mla_splits(1, 1, 33) == 33
    assert tfa.mla_splits(8, 1, 64) == 17
    assert tfa.mla_splits(64, 1, 64) == 3
    assert all(1 <= tfa.mla_splits(b, 1, t) <= min(t, 64) for b in (1, 3, 200) for t in (1, 9))
