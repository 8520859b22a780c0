"""The shared decoder's last text entries in the port, each against the JAX
package on the CPU: afmoe (the sigmoid output gate, periodic NoPE,
post-norms, embedding times sqrt(n_embd), a dense lead layer, the sigmoid
router with a selection bias and shared experts), laguna (the softplus
output gate per head and per element, its window layers roping
rope_dims_swa dims without YaRN), openelm (per-layer head arrays over a
file-fused QKV, per-layer FFN widths) and nanbeige (the physical stack
looped by reference, output_norm at the loop boundary).

One fixture an entry, written by testing.make_bench_arch_gguf with
testing.LAST_TEXT_LAYOUTS (2 layers, n_embd 256, heads of 64, vocab 256;
laguna's window layer ropes 32 of its 64 dims here, openelm's FFNs are 256
and 512 wide), read by both packages from the same bytes: layer keys,
flags and extras equal; f32 logits of a 24-token prefill and 3 decode
steps within NMSE 1e-5; 8 greedy ids equal; the Q4_K_M file's prefill
logits within NMSE 5e-3 (synthetic block scales / 256). The JAX package's
own test writers (tests/test_archs2_numeric.py, tests/test_archs3.py)
supply a second file of each, laguna's with both gate shapes, nanbeige's
with and without the loop norm; nanbeige's loops equal the unrolled stack
written as llama."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_tpu.models import transformer as jtf
from llama_cpp_tpu.models.loader import load_model as jax_load_model
from llama_cpp_tpu.runtime.context import Context as JaxContext
from llama_cpp_tpu_torch.models import transformer as ttf
from llama_cpp_tpu_torch.models.loader import load_model
from llama_cpp_tpu_torch.models.registry import supported_archs
from llama_cpp_tpu_torch.runtime.context import Context
from llama_cpp_tpu_torch.testing import (DIFFUSION_LAYOUTS, LAGUNA_ELEMENT_GATE,
                                         LAST_TEXT_LAYOUTS, make_bench_arch_gguf)

SHAPE = dict(n_layers=2, n_embd=256, n_heads=4, n_kv_heads=2, head_dim=64, n_ff=512,
             vocab_size=256, n_ctx=256)
LAYOUTS = {**LAST_TEXT_LAYOUTS, "laguna-element": LAGUNA_ELEMENT_GATE}
# narrower than the card's: openelm's FFNs and laguna's window rope
CPU_OPTIONS = {
    "openelm": dict(ff_arr=(256, 512)),
    "laguna": dict(metadata={**LAST_TEXT_LAYOUTS["laguna"]["metadata"],
                             "rope.dimension_count_swa": np.uint32(32)}),
}
CPU_OPTIONS["laguna-element"] = CPU_OPTIONS["laguna"]
ARCH = pytest.mark.parametrize("name", list(LAYOUTS))
FLAGS = ("rope_type", "act", "glu", "qk_norm", "post_norms", "embd_scale", "n_heads",
         "n_kv_heads", "head_dim_k", "rope_dims", "n_layers", "sliding_window", "swa_pattern",
         "expert_gating", "expert_weights_norm", "expert_weights_scale", "n_expert_shared",
         "tie_embeddings")
EXTRAS = ("no_rope_layers", "attn_gate_fn", "swa_first_global", "rope_dims_swa",
          "rope_freq_base_swa", "n_head_arr", "n_head_kv_arr", "n_loops", "skip_loop_final_norm")
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


def write(path, name, **kw):
    arch = name.split("-")[0]
    return make_bench_arch_gguf(path, arch, **{**SHAPE, **LAYOUTS[name],
                                               **CPU_OPTIONS.get(name, {}), **kw})


@pytest.fixture(scope="module")
def f32_models(tmp_path_factory):
    """name -> (port model, JAX model), both f32 from one f32 file, made at
    first use."""
    made = {}

    def get(name):
        if name not in made:
            path = write(str(tmp_path_factory.mktemp(name) / f"{name}.gguf"), name, f32=True)
            made[name] = (load_model(path, device="cpu", dense_dtype=torch.float32),
                          jax_load_model(path, dense_dtype=jnp.float32))
        return made[name]

    return get


def port_ctx(model, **kw):
    return Context(model, device="cpu", **{**CTX, **kw})


def jax_ctx(jmodel, **kw):
    return JaxContext(jmodel, kv_dtype=jnp.float32, **{**CTX, **kw})


def test_supported_archs_cover_the_slice():
    """t5, the diffusion LMs and this file's entries are registered; 13 of
    the JAX registry's still raise by name (tests/test_torch_families.py),
    now that gemma3n, gemma4, gemma4-assistant and minimax-m3 are ported
    (tests/test_torch_gemma3n.py, tests/test_torch_msa.py)."""
    from llama_cpp_tpu.models.registry import supported_archs as jax_supported_archs

    want = {"t5", *DIFFUSION_LAYOUTS, *LAST_TEXT_LAYOUTS}
    assert len(want) == 9 and want <= set(supported_archs())
    assert len(set(jax_supported_archs()) - set(supported_archs())) == 13


@ARCH
def test_layer_keys_and_flags_match_jax(f32_models, name):
    model, jmodel = f32_models(name)
    assert [set(lw) for lw in model.params["layers"]] == [
        set(lw) for lw in jmodel.params["layers"]]
    assert set(model.params) == set(jmodel.params)
    for flag in FLAGS:
        assert getattr(model.cfg, flag) == pytest.approx(getattr(jmodel.cfg, flag)), flag
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
def test_f32_prefill_and_decode_match_jax(f32_models, name):
    model, jmodel = f32_models(name)
    assert max(_prefill_and_steps(model, jmodel)) <= NMSE_F32


@ARCH
def test_greedy_ids_match_jax(f32_models, name):
    model, jmodel = f32_models(name)
    p = prompt(12, seed=2)
    assert port_ctx(model).generate(p, max_new_tokens=8) == jax_ctx(jmodel).generate(
        p, max_new_tokens=8)


@ARCH
def test_quantized_logits_match_jax(tmp_path, name):
    """The Q4_K_M file in bf16 through both packages: every row of a
    24-token ubatch within NMSE 5e-3."""
    path = write(str(tmp_path / f"{name}.gguf"), name, synth_scale=1.0 / 256)
    toks = np.asarray(prompt(24, seed=4))[None]
    args = (toks, np.asarray([0]), np.arange(24)[None], np.arange(24))
    got = port_ctx(load_model(path, device="cpu")).decode(*args)
    ref = JaxContext(jax_load_model(path), **CTX).decode(*args)
    assert nmse(got, ref) < NMSE_QUANT


@pytest.mark.parametrize("name", ["openelm", "nanbeige", "laguna"])
def test_slot_table_matches_jax(f32_models, name):
    """The slot-table memory (Context(paged=False)) against the JAX
    package's."""
    model, jmodel = f32_models(name)
    assert max(_prefill_and_steps(model, jmodel, paged=False)) <= NMSE_F32


def test_laguna_window_layers_rope_their_own_dims(f32_models):
    """laguna's window layer (layer 1: the first of each period is full)
    ropes rope_dims_swa dims at freq_base_swa without YaRN, its full layer
    the config's: the JAX package's _rope_params field for field."""
    model, jmodel = f32_models("laguna")
    for il in range(2):
        rp, jrp = ttf._rope_params(model.cfg, il), jtf._rope_params(jmodel.cfg, il)
        for f in ("n_dims", "freq_base", "freq_scale", "ext_factor"):
            assert getattr(rp, f) == getattr(jrp, f), (il, f)
    assert ttf._rope_params(model.cfg, 1).n_dims == 32 != ttf._rope_params(model.cfg, 0).n_dims


def test_openelm_layers_take_their_own_heads(f32_models):
    """openelm's memory holds the arrays' largest KV-head count; each layer's
    fused QKV is split by its own counts."""
    model, _ = f32_models("openelm")
    assert model.cfg.extra["n_head_arr"] == (4, 8) and model.cfg.n_kv_heads == 4
    assert [ttf.layer_heads(model.cfg, il) for il in range(2)] == [(4, 2), (8, 4)]
    assert port_ctx(model).kv.k[0].shape[0] == 4


def test_nanbeige_layers_are_the_physical_dicts(f32_models):
    """The logical layers past the physical stack are the physical dicts
    themselves (no copies); the memory holds a layer for each logical one."""
    model, jmodel = f32_models("nanbeige")
    layers = model.params["layers"]
    assert model.cfg.n_layers == len(layers) == 4 == len(jmodel.params["layers"])
    assert layers[2] is layers[0] and layers[3] is layers[1]
    assert len(port_ctx(model).kv.k) == 4


# -- the JAX package's own test writers ------------------------------------------

def _jax_file_afmoe(path):
    """tests/test_archs2_numeric.py's test_afmoe_numeric file."""
    from test_archs2 import E, FF, H, HD, L, _common, _emit_moe, _std_attn, _writer, emit

    w = _writer("afmoe", extra_md={
        "expert_count": np.uint32(4), "expert_used_count": np.uint32(2),
        "expert_gating_func": np.uint32(2), "expert_weights_norm": np.bool_(True),
        "expert_weights_scale": np.float32(1.5)})
    _common(w)
    for i in range(L):
        b = f"blk.{i}."
        _std_attn(w, b, qk_norm=True)
        emit(w, b + "attn_gate.weight", H * HD, E)
        emit(w, b + "attn_post_norm.weight", E, ones=True)
        emit(w, b + "ffn_norm.weight", E, ones=True)
        emit(w, b + "ffn_post_norm.weight", E, ones=True)
        _emit_moe(w, b, 4, FF)
        emit(w, b + "exp_probs_b.bias", 4, scale=0.1)
    w.write(path)


def _jax_file_laguna(path, per_head):
    """tests/test_archs3.py's _laguna_writer: both gate shapes of the same
    per-head weights, a dense lead layer, sigmoid MoE with a shared expert."""
    from pathlib import Path

    from test_archs3 import _laguna_writer

    assert _laguna_writer(Path(path).parent, 60, per_head, Path(path).name) == path


def _jax_file_openelm(path):
    """tests/test_archs3.py's test_openelm_numeric file: (4, 2) then (2, 1)
    heads, a fused QKV, shared [head_dim] q/k norms, a tied head."""
    from test_archs3 import E, FF, HD, V, _emit_fn, _writer

    heads, kvh = [4, 2], [2, 1]
    w = _writer("openelm", heads=heads, kv=kvh)
    emit, _ = _emit_fn(21)
    emit(w, "token_embd.weight", V, E, scale=0.05)
    emit(w, "output_norm.weight", E)
    for i in range(2):
        b = f"blk.{i}."
        nq, nk = heads[i], kvh[i]
        emit(w, b + "attn_norm.weight", E)
        emit(w, b + "attn_qkv.weight", (nq + 2 * nk) * HD, E)
        emit(w, b + "attn_q_norm.weight", HD)
        emit(w, b + "attn_k_norm.weight", HD)
        emit(w, b + "attn_output.weight", E, nq * HD)
        emit(w, b + "ffn_norm.weight", E)
        emit(w, b + "ffn_gate.weight", FF, E)
        emit(w, b + "ffn_up.weight", FF, E)
        emit(w, b + "ffn_down.weight", E, FF)
    w.write(path)


def _jax_file_nanbeige(path, skip, arch="nanbeige", seed=12):
    """tests/test_archs3.py's nanbeige files: 2 physical layers looped twice;
    with arch "llama" the same weights unrolled into 4 layers."""
    from test_archs3 import E, FF, L, V, _emit_fn, _emit_llama_layer, _writer

    from llama_cpp_tpu.gguf.constants import GGMLType

    if arch == "nanbeige":
        w = _writer("nanbeige", n_layers=L, extra_md={"num_loops": np.uint32(2),
                                                      "skip_loop_final_norm": skip})
    else:
        w = _writer("llama", n_layers=2 * L)
    emit, st = _emit_fn(seed)
    emit(w, "token_embd.weight", V, E, scale=0.05)
    emit(w, "output_norm.weight", E)
    emit(w, "output.weight", V, E)
    for i in range(L):
        _emit_llama_layer(emit, w, f"blk.{i}.")
    if arch == "llama":
        for i in range(L):
            for suf in ("attn_norm", "attn_q", "attn_k", "attn_v", "attn_output", "ffn_norm",
                        "ffn_gate", "ffn_up", "ffn_down"):
                arr = st[f"blk.{i}.{suf}.weight"]
                w.add_tensor(f"blk.{i + L}.{suf}.weight", arr.tobytes(),
                             tuple(reversed(arr.shape)), GGMLType.F32)
    w.write(path)


JAX_FILES = {"afmoe": _jax_file_afmoe,
             "laguna_head": lambda p: _jax_file_laguna(p, True),
             "laguna_element": lambda p: _jax_file_laguna(p, False),
             "openelm": _jax_file_openelm,
             "nanbeige_skip": lambda p: _jax_file_nanbeige(p, True),
             "nanbeige_norm": lambda p: _jax_file_nanbeige(p, False)}


@pytest.mark.parametrize("name", list(JAX_FILES))
def test_jax_test_writer_files_match_jax(tmp_path, name):
    """The JAX package's own tiny files of these entries (vocab 96): f32
    logits of a prefill and 3 steps within NMSE 1e-5, and 6 greedy ids
    equal."""
    path = str(tmp_path / f"{name}.gguf")
    JAX_FILES[name](path)
    model = load_model(path, device="cpu", dense_dtype=torch.float32)
    jmodel = jax_load_model(path, prefer_quant=False, dense_dtype=jnp.float32)
    ctx, jctx = port_ctx(model), jax_ctx(jmodel)
    p = prompt(13, seed=6, vocab=96)
    assert nmse(ctx.prefill(p), np.asarray(jctx.prefill(p))) <= NMSE_F32
    for t in (5, 40, 90):
        assert nmse(ctx.decode_one(t), np.asarray(jctx.decode_one(t))) <= NMSE_F32
    assert port_ctx(model).generate(p, max_new_tokens=6) == jax_ctx(jmodel).generate(
        p, max_new_tokens=6)


def _logits(path, p):
    model = load_model(path, device="cpu", dense_dtype=torch.float32)
    return port_ctx(model).prefill(p)


def test_laguna_gate_shapes_agree(tmp_path):
    """The per-head softplus gate equals the per-element gate whose rows are
    head-constant (tests/test_archs3.py's check, on the port)."""
    a, b = (str(tmp_path / f"{n}.gguf") for n in ("h", "e"))
    _jax_file_laguna(a, True)
    _jax_file_laguna(b, False)
    p = prompt(9, seed=7, vocab=96)
    np.testing.assert_allclose(_logits(a, p), _logits(b, p), rtol=1e-5, atol=1e-5)


def test_nanbeige_loops_equal_the_unrolled_stack(tmp_path):
    """nanbeige with skip_loop_final_norm equals a llama file holding the
    same two layers twice (exact up to f32 sums), and the loop norm changes
    the logits."""
    paths = {k: str(tmp_path / f"{k}.gguf") for k in ("skip", "norm", "llama")}
    _jax_file_nanbeige(paths["skip"], True)
    _jax_file_nanbeige(paths["norm"], False)
    _jax_file_nanbeige(paths["llama"], True, arch="llama")
    p = prompt(9, seed=8, vocab=96)
    looped = _logits(paths["skip"], p)
    np.testing.assert_allclose(looped, _logits(paths["llama"], p), rtol=1e-5, atol=1e-5)
    assert not np.allclose(looped, _logits(paths["norm"], p))


def test_params_from_jax_keep_nanbeige_loops_shared(f32_models):
    """params_from_jax(n_loops=2) converts the physical stack once and lists
    it twice, as the loader does; the converted model's logits are the
    loaded model's bit for bit."""
    import jax

    from llama_cpp_tpu_torch.models.from_jax import params_from_jax
    from llama_cpp_tpu_torch.models.loader import Model

    model, jmodel = f32_models("nanbeige")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jmodel.params), n_loops=2)
    assert params["layers"][2] is params["layers"][0]
    converted = Model(model.cfg, params, torch.device("cpu"))
    p = prompt(11, seed=9)
    np.testing.assert_array_equal(port_ctx(converted).prefill(p), port_ctx(model).prefill(p))
