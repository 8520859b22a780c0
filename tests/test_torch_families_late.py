"""The shared decoder's last text families of the port, each against the JAX
package on the CPU: hy_v3, apertus (xIELU), bitnet (sub-norms, folded
per-tensor scales), talkie (the embedding skip), chameleon (q/k LayerNorms
with biases), jais2, maincoder, pangu-embedded, deci (per-layer head
arrays: attention at the memory's KV heads and at fewer, linear attention,
attention-free and dummy layers), and the MLA entries at MHA width:
minicpm3 (the absorbed row of (384, 256)), plm and mistral4.

One fixture an entry, written by testing.make_bench_arch_gguf with
testing.LATE_FAMILY_LAYOUTS (2 layers, n_embd 256, heads of 64, vocab 256;
deci 5 layers) or make_bench_deepseek2_gguf with MLA_FAMILY_LAYOUTS, read
by both packages from the same bytes: layer keys, flags and extras equal;
f32 logits of a 24-token prefill and 3 decode steps within NMSE 1e-5; 8
greedy ids equal; the Q4_K_M file's prefill logits within NMSE 5e-3 (the
synthetic block scales divided by 256, as on the card's paths). The JAX
package's own test writers (tests/test_archs2.py, tests/test_archs3.py)
supply a second file for bitnet, talkie, minicpm3 and deci's special layers.
xielu against the JAX function; the plain MLA attention at (384, 256) and
40 query heads on the one KV head (K5 on the pool, K6 on the slot table,
int8 and bf16) against the JAX package's Pallas kernels in interpret mode.
Every entry of the JAX registry the port does not register raises by name
(tests/test_torch_families.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_tpu.models import transformer as jtf
from llama_cpp_tpu.models.loader import load_model as jax_load_model
from llama_cpp_tpu.ops.pallas.flash_attn import flash_attention as jax_fa
from llama_cpp_tpu.ops.pallas.flash_attn import flash_attention_paged as jax_fa_paged
from llama_cpp_tpu.runtime.context import Context as JaxContext
from llama_cpp_tpu_torch.models.loader import load_model
from llama_cpp_tpu_torch.models.registry import supported_archs
from llama_cpp_tpu_torch.ops import basic
from llama_cpp_tpu_torch.ops.kernels import flash_attn as tfa
from llama_cpp_tpu_torch.runtime.context import Context
from llama_cpp_tpu_torch.runtime.paged_kv import PagedKVCache
from llama_cpp_tpu_torch.testing import (LATE_FAMILY_LAYOUTS, MLA_FAMILY_LAYOUTS,
                                         make_bench_arch_gguf, make_bench_deepseek2_gguf)

SHAPE = dict(n_layers=2, n_embd=256, n_heads=4, n_kv_heads=2, head_dim=64, n_ff=512,
             vocab_size=256, n_ctx=256)
# deci at these widths: 4 heads on 2 KV heads, then on 1 (padded), linear
# attention, attention-free, dummy
DECI = dict(head_arr=(4, 4, 4, 0, 0), kv_arr=(2, 1, 0, 0, 0))
MLA_SHAPE = dict(n_layers=2, n_embd=256, n_heads=4, n_ff=512, vocab_size=256, n_ff_exp=256)
ARCHS = list(LATE_FAMILY_LAYOUTS) + list(MLA_FAMILY_LAYOUTS)
ARCH = pytest.mark.parametrize("arch", ARCHS)
SLICE = ("rwkv6", "rwkv7", "rwkv6qwen2", "arwkv7", "minicpm3", "plm", "mistral4", "hy_v3",
         "apertus", "bitnet", "talkie", "chameleon", "jais2", "maincoder", "pangu-embedded",
         "deci")
FLAGS = ("rope_type", "act", "glu", "use_rms_norm", "norm_eps", "norm_after", "residual_scale",
         "embd_scale", "logit_scale", "qk_norm", "n_heads", "n_kv_heads", "head_dim_k",
         "head_dim_v", "rope_dims", "expert_gating", "expert_weights_norm",
         "expert_weights_scale", "n_expert_shared", "tie_embeddings")
EXTRAS = ("xielu", "qk_layernorm", "embd_skip", "weightless_norm", "qk_norm_after_rope",
          "n_head_arr", "n_head_kv_arr", "kv_lora_rank", "q_lora_rank", "mla_absorb",
          "mla_pad", "cache_n_kv_heads", "cache_head_dim_k", "cache_head_dim_v")
CTX = dict(n_ctx=64, n_seqs=1, n_ubatch=32)
NMSE_F32 = 1e-5
NMSE_QUANT = 5e-3


def nmse(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.mean((got - ref) ** 2) / (np.mean(ref ** 2) + 1e-30))


def prompt(length, seed=0, vocab=256):
    return [int(t) for t in np.random.default_rng(seed).integers(3, vocab - 1, length)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small steps under pytest-xdist's workers on a shared CPU: torch's
    thread pool would spend more than the work on waking its threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write(path, arch, **kw):
    if arch in MLA_FAMILY_LAYOUTS:
        return make_bench_deepseek2_gguf(path, arch=arch, **{**MLA_SHAPE,
                                                             **MLA_FAMILY_LAYOUTS[arch], **kw})
    extra = DECI if arch == "deci" else {}
    return make_bench_arch_gguf(path, arch, **{**SHAPE, **LATE_FAMILY_LAYOUTS[arch], **extra,
                                               **kw})


@pytest.fixture(scope="module")
def f32_models(tmp_path_factory):
    """arch -> (port model, JAX model), both f32 from one f32 file, made at
    first use."""
    made = {}

    def get(arch):
        if arch not in made:
            path = write(str(tmp_path_factory.mktemp(arch) / f"{arch}.gguf"), arch, f32=True)
            made[arch] = (load_model(path, device="cpu", dense_dtype=torch.float32),
                          jax_load_model(path, dense_dtype=jnp.float32))
        return made[arch]

    return get


def port_ctx(model, **kw):
    return Context(model, device="cpu", **{**CTX, **kw})


def jax_ctx(jmodel, **kw):
    return JaxContext(jmodel, kv_dtype=jnp.float32, **{**CTX, **kw})


def test_supported_archs_cover_the_slice():
    assert set(SLICE) <= set(supported_archs())


@ARCH
def test_layer_keys_and_flags_match_jax(f32_models, arch):
    model, jmodel = f32_models(arch)
    assert [set(lw) for lw in model.params["layers"]] == [
        set(lw) for lw in jmodel.params["layers"]]
    assert set(model.params) == set(jmodel.params)
    for name in FLAGS:
        assert getattr(model.cfg, name) == pytest.approx(getattr(jmodel.cfg, name)), name
    for key in EXTRAS:
        assert model.cfg.extra.get(key) == jmodel.cfg.extra.get(key), key


def _prefill_and_steps(model, jmodel, **kw):
    ctx, jctx = port_ctx(model, **kw), jax_ctx(jmodel, **kw)
    p = prompt(24, seed=3)
    errs = [nmse(ctx.prefill(p), np.asarray(jctx.prefill(p)))]
    for t in (5, 77, 140):
        errs.append(nmse(ctx.decode_one(t), np.asarray(jctx.decode_one(t))))
    return errs


@ARCH
def test_f32_prefill_and_decode_match_jax(f32_models, arch):
    model, jmodel = f32_models(arch)
    assert max(_prefill_and_steps(model, jmodel)) <= NMSE_F32


@ARCH
def test_greedy_ids_match_jax(f32_models, arch):
    model, jmodel = f32_models(arch)
    p = prompt(12, seed=2)
    assert port_ctx(model).generate(p, max_new_tokens=8) == jax_ctx(jmodel).generate(
        p, max_new_tokens=8)


@ARCH
def test_quantized_logits_match_jax(tmp_path, arch):
    """The Q4_K_M file in bf16 through both packages: every row of a
    24-token ubatch within NMSE 5e-3."""
    path = write(str(tmp_path / f"{arch}.gguf"), arch, synth_scale=1.0 / 256)
    toks = np.asarray(prompt(24, seed=4))[None]
    args = (toks, np.asarray([0]), np.arange(24)[None], np.arange(24))
    got = port_ctx(load_model(path, device="cpu")).decode(*args)
    ref = JaxContext(jax_load_model(path), **CTX).decode(*args)
    assert nmse(got, ref) < NMSE_QUANT


@pytest.mark.parametrize("arch", ["deci", "minicpm3", "chameleon"])
def test_slot_table_matches_jax(f32_models, arch):
    """The slot-table memory (Context(paged=False)) against the JAX
    package's."""
    model, jmodel = f32_models(arch)
    assert max(_prefill_and_steps(model, jmodel, paged=False)) <= NMSE_F32


def test_deci_memory_holds_the_largest_kv_heads(f32_models):
    """deci's pool holds the arrays' largest KV-head count; the layer at
    fewer KV heads writes its rows padded (zeros in the pad heads); the
    first attention layer labels the positions."""
    model, _ = f32_models("deci")
    ctx = port_ctx(model)
    pool = ctx.kv
    assert isinstance(pool, PagedKVCache) and pool.k[0].shape[0] == 2 == model.cfg.n_kv_heads
    ctx.prefill(prompt(9))
    table = pool.table[0].long()
    rows = (table[:, None] * pool.page + torch.arange(pool.page)).reshape(-1)
    labels = pool.pos[rows]
    assert sorted(int(p) for p in labels if p >= 0) == list(range(9))
    written = rows[labels >= 0]
    assert pool.k[1][1, written].abs().sum() == 0 and pool.k[1][0, written].abs().sum() > 0


@pytest.mark.parametrize("an,ap,beta,eps", [(0.8, 0.8, 0.5, -1e-6), (0.3, 1.7, 0.1, -1e-3),
                                            (1.2, 0.05, 0.9, -0.5)])
def test_xielu_matches_jax(an, ap, beta, eps):
    x = np.random.default_rng(7).standard_normal((3, 257)).astype(np.float32) * 3
    got = basic.xielu(torch.from_numpy(x), an, ap, beta, eps).numpy()
    ref = np.asarray(jtf.xielu(jnp.asarray(x), an, ap, beta, eps))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


# -- the JAX package's own test writers ------------------------------------------

def _jax_file_bitnet(path):
    from test_archs2 import E, FF, H, HD, HKV, L, _common, _writer, emit

    from llama_cpp_tpu.gguf.constants import GGMLType

    w = _writer("bitnet")
    _common(w, tie=True)
    for i in range(L):
        b = f"blk.{i}."
        emit(w, b + "attn_norm.weight", E, ones=True)
        emit(w, b + "attn_sub_norm.weight", E, ones=True)
        for nm, rows, cols in (("attn_q", H * HD, E), ("attn_k", HKV * HD, E),
                               ("attn_v", HKV * HD, E), ("attn_output", E, E),
                               ("ffn_gate", FF, E), ("ffn_up", FF, E), ("ffn_down", E, FF)):
            emit(w, b + nm + ".weight", rows, cols)
            w.add_tensor(b + nm + ".scale", np.asarray([0.5], np.float32).tobytes(), (1,),
                         GGMLType.F32)
        emit(w, b + "ffn_norm.weight", E, ones=True)
        emit(w, b + "ffn_sub_norm.weight", FF, ones=True)
    w.write(path)


def _jax_file_talkie(path):
    from test_archs2 import E, FF, H, HD, HKV, L, V, _writer, emit

    from llama_cpp_tpu.gguf.constants import GGMLType

    w = _writer("talkie", extra_md={"logit_scale": np.float32(0.5)})
    emit(w, "token_embd.weight", V, E, scale=0.05)
    emit(w, "output.weight", V, E)
    for i in range(L):
        b = f"blk.{i}."
        emit(w, b + "attn_qkv.weight", H * HD + 2 * HKV * HD, E)
        emit(w, b + "attn_q_norm.weight", H, 1, ones=True)
        emit(w, b + "attn_output.weight", E, H * HD)
        emit(w, b + "ffn_gate.weight", FF, E)
        emit(w, b + "ffn_up.weight", FF, E)
        emit(w, b + "ffn_down.weight", E, FF)
        w.add_tensor(b + "layer_output_scale.weight", np.asarray([0.1], np.float32).tobytes(),
                     (1,), GGMLType.F32)
    w.write(path)


def _jax_file_minicpm3(path):
    from test_archs2 import E, FF, H, L, _common, _writer, emit

    n_rot, nope, dv, kvr, qr = 8, 8, 16, 16, 24
    hd_k = n_rot + nope
    w = _writer("minicpm3", n_rot=n_rot, extra_md={
        "attention.kv_lora_rank": np.uint32(kvr), "attention.q_lora_rank": np.uint32(qr),
        "attention.key_length": np.uint32(hd_k), "attention.value_length": np.uint32(dv)})
    _common(w, tie=True)
    for i in range(L):
        b = f"blk.{i}."
        emit(w, b + "attn_norm.weight", E, ones=True)
        emit(w, b + "attn_q_a.weight", qr, E)
        emit(w, b + "attn_q_a_norm.weight", qr, ones=True)
        emit(w, b + "attn_q_b.weight", H * hd_k, qr)
        emit(w, b + "attn_kv_a_mqa.weight", kvr + n_rot, E)
        emit(w, b + "attn_kv_a_norm.weight", kvr, ones=True)
        emit(w, b + "attn_kv_b.weight", H * (nope + dv), kvr)
        emit(w, b + "attn_output.weight", E, H * dv)
        emit(w, b + "ffn_norm.weight", E, ones=True)
        emit(w, b + "ffn_gate.weight", FF, E)
        emit(w, b + "ffn_up.weight", FF, E)
        emit(w, b + "ffn_down.weight", E, FF)
    w.write(path)


def _jax_file_deci(path):
    """test_archs3's 4-layer mix: attention, linear attention,
    attention-free, dummy."""
    from test_archs3 import E, FF, H, HKV, V, _emit_fn, _emit_llama_layer, _writer

    w = _writer("deci", n_layers=4, heads=[H, H, 0, 0], kv=[HKV, 0, 0, 0])
    emit, _ = _emit_fn(8)
    emit(w, "token_embd.weight", V, E, scale=0.05)
    emit(w, "output_norm.weight", E, ones=True)
    emit(w, "output.weight", V, E)
    _emit_llama_layer(emit, w, "blk.0.")
    emit(w, "blk.1.attn_norm.weight", E, ones=True)
    emit(w, "blk.1.attn_output.weight", E, E)
    for il in (1, 2):
        emit(w, f"blk.{il}.ffn_norm.weight", E, ones=True)
        emit(w, f"blk.{il}.ffn_gate.weight", FF, E)
        emit(w, f"blk.{il}.ffn_up.weight", FF, E)
        emit(w, f"blk.{il}.ffn_down.weight", E, FF)
    w.write(path)


JAX_FILES = {"bitnet": _jax_file_bitnet, "talkie": _jax_file_talkie,
             "minicpm3": _jax_file_minicpm3, "deci": _jax_file_deci}


@pytest.mark.parametrize("arch", list(JAX_FILES))
def test_jax_test_writer_files_match_jax(tmp_path, arch):
    """The JAX package's own tiny files of these entries (its numeric tests'
    tensor inventories, vocab 96): f32 logits of a prefill and 3 steps
    within NMSE 1e-5, and 6 greedy ids equal."""
    path = str(tmp_path / f"{arch}.gguf")
    JAX_FILES[arch](path)
    model = load_model(path, device="cpu", dense_dtype=torch.float32)
    jmodel = jax_load_model(path, dense_dtype=jnp.float32)
    ctx, jctx = port_ctx(model), jax_ctx(jmodel)
    p = prompt(13, seed=6, vocab=96)
    assert nmse(ctx.prefill(p), np.asarray(jctx.prefill(p))) <= NMSE_F32
    for t in (5, 40, 90):
        assert nmse(ctx.decode_one(t), np.asarray(jctx.decode_one(t))) <= NMSE_F32
    assert port_ctx(model).generate(p, max_new_tokens=6) == jax_ctx(jmodel).generate(
        p, max_new_tokens=6)


# -- the plain MLA attention at (384, 256) against the JAX kernels -----------------

DK, DV, G = 384, 256, 40  # MiniCPM3-4B's absorbed row, 40 query heads on one KV head


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _kv(rng, lead, bf16):
    if bf16:
        k = _bf16(rng.standard_normal((*lead, DK)).astype(np.float32) * 0.5)
        v = _bf16(rng.standard_normal((*lead, DV)).astype(np.float32))
        return k, v, None, None
    k = rng.integers(-127, 128, (*lead, DK)).astype(np.int8)
    v = rng.integers(-127, 128, (*lead, DV)).astype(np.int8)
    ks = (rng.random(lead) * 0.004 + 0.001).astype(np.float32)
    vs = (rng.random(lead) * 0.02 + 0.005).astype(np.float32)
    return k, v, ks, vs


def _torch(a, dt=None):
    return None if a is None else (torch.from_numpy(a).to(dt) if dt else torch.from_numpy(a))


@pytest.mark.parametrize("T", [1, 2], ids=["decode40", "rows80"])
@pytest.mark.parametrize("bf16", [False, True], ids=["int8", "bf16"])
def test_mla_384_slot_plain_matches_jax(bf16, T):
    """K6's plain version at (384, 256), G = 40 (40 and 80 rows a KV head),
    reading sequence seq_idx[b] of the slot table where the JAX caller
    gathers it for its flash_attention (interpret mode): NMSE < 5e-3, the
    JAX slot kernel rounding the scaled K/V to bf16."""
    rng = np.random.default_rng(T + 2 * bf16)
    n_seqs, S, fills = 3, 256, (200, 70, 131)
    k, v, ks, vs = _kv(rng, (n_seqs, 1, S), bf16)
    cp = np.full((n_seqs, S), -1, np.int32)
    for s, f in enumerate(fills):
        cp[s, :f] = np.arange(f)
    seq_idx = np.asarray([2, 0], np.int32)
    q = _bf16(rng.standard_normal((2, 1, G * T, DK)).astype(np.float32) * 0.5)
    row_pos = np.stack([np.tile(fills[s] - T + np.arange(T), G) for s in seq_idx]).astype(
        np.int32)
    sm = 3.0 / np.sqrt(DK)
    kvdt = jnp.bfloat16 if bf16 else jnp.int8

    def sel(a, dt=None):
        return None if a is None else jnp.asarray(a[seq_idx], dt)

    ref = np.asarray(jax_fa(jnp.asarray(q, jnp.bfloat16), sel(k, kvdt), sel(v, kvdt),
                            jnp.asarray(row_pos), sel(cp), k_scale=sel(ks), v_scale=sel(vs),
                            sm_scale=sm, interpret=True))
    kvt = torch.bfloat16 if bf16 else None
    got = tfa.flash_attention(_torch(q, torch.bfloat16), _torch(k, kvt), _torch(v, kvt),
                              _torch(row_pos), _torch(cp), _torch(seq_idx), _torch(ks),
                              _torch(vs), sm_scale=sm).numpy()
    assert tfa.is_mla(DK, DV) and got.shape == ref.shape == (2, 1, G * T, DV)
    assert nmse(got, ref) < 5e-3


@pytest.mark.parametrize("bf16", [False, True], ids=["int8", "bf16"])
def test_mla_384_paged_plain_matches_jax(bf16):
    """K5's plain version at (384, 256), G = 40 at one token (40 rows, one a
    padding row) over a pool of 128-row pages, against the JAX package's
    flash_attention_paged in interpret mode: NMSE < 1e-4."""
    rng = np.random.default_rng(11 + bf16)
    page, n_pages, mp, depths = 128, 6, 3, (200, 90)
    k, v, ks, vs = _kv(rng, (1, n_pages * page), bf16)
    table = np.full((2, mp), n_pages - 1, np.int32)
    pos = np.full(n_pages * page, -1, np.int32)
    for b, dep in enumerate(depths):
        for j in range(-(-(dep + 1) // page)):
            pid = 2 * b + j
            table[b, j] = pid
            cnt = min(page, dep + 1 - j * page)
            pos[pid * page: pid * page + cnt] = np.arange(j * page, j * page + cnt)
    q = _bf16(rng.standard_normal((2, 1, G, DK)).astype(np.float32) * 0.5)
    row_pos = np.stack([np.full(G, dep) for dep in depths]).astype(np.int32)
    row_pos[1, -1] = -1
    sm = 3.0 / np.sqrt(DK)
    kvdt = jnp.bfloat16 if bf16 else jnp.int8
    ref = np.asarray(jax_fa_paged(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k.reshape(1, n_pages, page, DK), kvdt),
        jnp.asarray(v.reshape(1, n_pages, page, DV), kvdt), jnp.asarray(row_pos),
        jnp.asarray(pos.reshape(n_pages, 1, page)), jnp.asarray(table),
        k_scale4=None if bf16 else jnp.asarray(ks.reshape(1, n_pages, 1, page)),
        v_scale4=None if bf16 else jnp.asarray(vs.reshape(1, n_pages, 1, page)),
        sm_scale=sm, page=page, interpret=True))
    kvt = torch.bfloat16 if bf16 else None
    got = tfa.flash_attention_paged(_torch(q, torch.bfloat16), _torch(k, kvt), _torch(v, kvt),
                                    _torch(row_pos), _torch(pos), _torch(table), _torch(ks),
                                    _torch(vs), sm_scale=sm, page=page).numpy()
    valid = row_pos >= 0
    g, r = got.transpose(0, 2, 1, 3)[valid], ref.transpose(0, 2, 1, 3)[valid]
    assert got.shape == ref.shape == (2, 1, G, DV)
    assert nmse(g, r) < 1e-4
