"""The diffusion LMs in the port against the JAX package on the CPU:
runtime/diffusion.py (the port's own copy of the JAX module) over the
port's Context, the four registry entries (dream, llada, llada-moe,
rnd1: the shared decoder run bidirectionally) and llama-diffusion-cli.

On the tiny f32 llada and dream fixtures (testing.make_tiny_diffusion_gguf,
the same bytes as the JAX package's writer) diffusion_generate gives the
JAX function's ids for each of the five confidence algorithms under both
schedules, greedy, sampled at temperature 0.7 and with gumbel noise;
Dream's step scores position i with the logits of i - 1. The MoE pair's
logits match on the JAX package's numeric test files
(tests/test_archs2_numeric.py) within NMSE 1e-5, and every entry's narrow
file (testing.DIFFUSION_LAYOUTS) within 1e-5 in f32 and 5e-3 in the Q4_K_M
mix."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_tpu.models.loader import load_model as jax_load_model
from llama_cpp_tpu.runtime import diffusion as jdiff
from llama_cpp_tpu.runtime.context import Context as JaxContext
from llama_cpp_tpu.testing import make_tiny_diffusion_gguf as jax_make_tiny_diffusion
from llama_cpp_tpu.tools import diffusion_cli as jax_diffusion_cli
from llama_cpp_tpu_torch.models.loader import load_model
from llama_cpp_tpu_torch.runtime import diffusion
from llama_cpp_tpu_torch.runtime.context import Context
from llama_cpp_tpu_torch.testing import (DIFFUSION_LAYOUTS, make_bench_diffusion_gguf,
                                         make_tiny_diffusion_gguf)
from llama_cpp_tpu_torch.tools import diffusion_cli

NMSE_F32 = 1e-5
NMSE_QUANT = 5e-3
PROMPT = [3, 17, 42]
CTX = dict(n_ctx=32, n_seqs=1, n_ubatch=32)
SAMPLING = {"greedy": dict(temperature=0.0), "temp": dict(temperature=0.7),
            "gumbel": dict(temperature=0.7, add_gumbel_noise=True)}
SHAPE = dict(n_layers=2, n_embd=256, n_heads=4, n_kv_heads=2, n_ff=512, vocab_size=256,
             n_ctx=256, mask_token=-1)
FLAGS = ("rope_type", "qk_norm", "expert_weights_norm", "expert_gating", "n_heads",
         "n_kv_heads", "head_dim_k")
EXTRAS = ("non_causal", "diffusion", "diffusion_shift_logits")


def nmse(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.mean((got - ref) ** 2) / (np.mean(ref ** 2) + 1e-30))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small steps under pytest-xdist's workers on a shared CPU: torch's
    thread pool would spend more than the work on waking its threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """arch -> (path, port Context, JAX Context) over the tiny f32 fixture
    (seed 8, as the JAX package's test_engine.py writes it)."""
    out = {}
    for arch in ("llada", "dream"):
        path = make_tiny_diffusion_gguf(str(tmp_path_factory.mktemp(arch) / f"{arch}.gguf"),
                                        arch=arch, seed=8)
        model = load_model(path, device="cpu", dense_dtype=torch.float32)
        jmodel = jax_load_model(path, prefer_quant=False, dense_dtype=jnp.float32)
        out[arch] = (path, Context(model, device="cpu", **CTX),
                     JaxContext(jmodel, kv_dtype=jnp.float32, **CTX))
    return out


def test_tiny_fixture_is_the_jax_writers(tiny, tmp_path):
    for arch in ("llada", "dream"):
        ref = jax_make_tiny_diffusion(str(tmp_path / f"{arch}.gguf"), arch=arch, seed=8)
        assert open(tiny[arch][0], "rb").read() == open(ref, "rb").read()


@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("schedule", ["timestep", "block"])
@pytest.mark.parametrize("algorithm", diffusion.ALGORITHMS)
@pytest.mark.parametrize("arch", ["llada", "dream"])
def test_diffusion_generate_matches_jax(tiny, arch, algorithm, schedule, sampling):
    """16 positions, 8 steps (blocks of 8 on the block schedule), seed 1;
    margin's ranking with gumbel noise at alg_temp 0.5: the JAX function's
    ids."""
    _, ctx, jctx = tiny[arch]
    kw = dict(steps=8, max_length=16, algorithm=algorithm, schedule=schedule, block_length=8,
              seed=1, alg_temp=0.5 if algorithm == "margin" else 0.0, **SAMPLING[sampling])
    got = diffusion.diffusion_generate(ctx, PROMPT, diffusion.DiffusionParams(**kw))
    ref = jdiff.diffusion_generate(jctx, PROMPT, jdiff.DiffusionParams(**kw))
    assert got == ref and len(got) == 16 - len(PROMPT)


def test_transfer_counts_match_jax():
    for masks, steps in ((13, 8), (7, 8), (32, 5), (0, 3)):
        assert diffusion._num_transfer_tokens(masks, steps) == jdiff._num_transfer_tokens(
            masks, steps)


def test_dream_scores_a_position_with_the_logits_before_it(tiny):
    """Dream's step_logits are the whole sequence's logits shifted down by
    one row (row 0 kept); llada's are not shifted; both the JAX forward's."""
    seq = np.asarray(PROMPT + [159] * 13)
    for arch, shifted in (("dream", True), ("llada", False)):
        _, ctx, jctx = tiny[arch]
        got = diffusion.step_logits(ctx, seq)
        ctx.seq_rm(0)
        raw = ctx.decode(seq[None], np.asarray([0]), np.arange(16)[None], np.arange(16))
        want = np.concatenate([raw[:1], raw[:-1]]) if shifted else raw
        np.testing.assert_array_equal(got, want)
        jctx.seq_rm(0)
        jraw = np.asarray(jctx.decode(seq[None], np.asarray([0]), np.arange(16)[None],
                                      np.arange(16)))
        assert nmse(raw, jraw) <= NMSE_F32


def test_non_causal_rows_see_later_tokens(tiny):
    """Bidirectional: row 0's logits change with the tail, as in the JAX
    package's test_engine.py."""
    _, ctx, _ = tiny["llada"]
    a = diffusion.step_logits(ctx, np.asarray(PROMPT + [5] * 13))
    b = diffusion.step_logits(ctx, np.asarray(PROMPT + [9] * 13))
    assert not np.allclose(a[0], b[0])


def test_mask_token_from_the_vocab_or_raises(tiny):
    _, ctx, _ = tiny["llada"]
    assert ctx.model.tokenizer.vocab.mask_id == 159
    tok, ctx.model.tokenizer = ctx.model.tokenizer, None
    try:
        with pytest.raises(ValueError, match="mask token"):
            diffusion.diffusion_generate(ctx, PROMPT, diffusion.DiffusionParams(steps=2,
                                                                                max_length=8))
    finally:
        ctx.model.tokenizer = tok


def _jax_moe_file(path, arch):
    """tests/test_archs2_numeric.py's test_diffusion_moe_numeric file."""
    from test_archs2_numeric import L, _common, _emit_moe, _std_attn, _writer, emit

    w = _writer(arch, extra_md={"expert_count": np.uint32(4), "expert_used_count": np.uint32(2)})
    _common(w)
    for i in range(L):
        b = f"blk.{i}."
        _std_attn(w, b, qk_norm=True)
        emit(w, b + "ffn_norm.weight", 64, ones=True)
        _emit_moe(w, b, 4, 96)
    w.write(path)


@pytest.mark.parametrize("arch", ["llada-moe", "rnd1"])
def test_moe_pair_logits_match_jax_on_its_test_file(tmp_path, arch):
    """The JAX package's numeric test file of each (raw top-k weights on
    llada-moe, normalised on rnd1): every row of a whole-sequence forward
    within NMSE 1e-5, and the router's flags."""
    from test_archs2_numeric import TOKENS

    path = str(tmp_path / f"{arch}.gguf")
    _jax_moe_file(path, arch)
    model = load_model(path, device="cpu", dense_dtype=torch.float32)
    jmodel = jax_load_model(path, prefer_quant=False, dense_dtype=jnp.float32)
    assert model.cfg.expert_weights_norm == jmodel.cfg.expert_weights_norm == (arch == "rnd1")
    toks = np.asarray(TOKENS)[None]
    T = toks.shape[1]
    args = (toks, np.asarray([0]), np.arange(T)[None], np.arange(T))
    got = Context(model, device="cpu", n_ctx=64, n_seqs=1).decode(*args)
    ref = JaxContext(jmodel, kv_dtype=jnp.float32, n_ctx=64, n_seqs=1).decode(*args)
    assert nmse(got, ref) <= NMSE_F32


@pytest.fixture(scope="module")
def narrow(tmp_path_factory):
    """arch -> (f32 path, port model, JAX model) of DIFFUSION_LAYOUTS' files."""
    made = {}

    def get(arch):
        if arch not in made:
            path = make_bench_diffusion_gguf(
                str(tmp_path_factory.mktemp(arch) / f"{arch}.gguf"), arch, **SHAPE, f32=True)
            made[arch] = (path, load_model(path, device="cpu", dense_dtype=torch.float32),
                          jax_load_model(path, dense_dtype=jnp.float32))
        return made[arch]

    return get


ARCH = pytest.mark.parametrize("arch", list(DIFFUSION_LAYOUTS))


@ARCH
def test_flags_and_layers_match_jax(narrow, arch):
    _, model, jmodel = narrow(arch)
    assert [set(lw) for lw in model.params["layers"]] == [set(lw) for lw in
                                                          jmodel.params["layers"]]
    for name in FLAGS:
        assert getattr(model.cfg, name) == getattr(jmodel.cfg, name), name
    for key in EXTRAS:
        assert model.cfg.extra.get(key) == jmodel.cfg.extra.get(key), key
    assert model.tokenizer.vocab.mask_id == 255


@ARCH
def test_narrow_step_logits_match_jax(narrow, arch):
    """One step's forward over 48 rows, the tail the mask: f32 within NMSE
    1e-5."""
    _, model, jmodel = narrow(arch)
    seq = np.full(48, 255)
    seq[:20] = np.random.default_rng(3).integers(3, 250, 20)
    kw = dict(n_ctx=48, n_seqs=1, n_ubatch=48)
    got = diffusion.step_logits(Context(model, device="cpu", **kw), seq)
    # the JAX module's loop does its step's forward inline: the same calls
    jctx = JaxContext(jmodel, kv_dtype=jnp.float32, **kw)
    jctx.seq_rm(0)
    raw = np.asarray(jctx.decode(seq[None], np.asarray([0]), np.arange(48)[None],
                                 np.arange(48)))
    if jmodel.cfg.extra.get("diffusion_shift_logits"):
        raw = np.concatenate([raw[:1], raw[:-1]])
    assert nmse(got, raw) <= NMSE_F32


@ARCH
def test_narrow_generate_matches_jax(narrow, arch):
    """diffusion_generate on the f32 narrow file, 6 steps of 32 rows: the
    JAX function's ids."""
    _, model, jmodel = narrow(arch)
    kw = dict(n_ctx=32, n_seqs=1, n_ubatch=32)
    p = dict(steps=6, max_length=32, seed=2)
    prompt = [int(t) for t in np.random.default_rng(4).integers(3, 250, 9)]
    got = diffusion.diffusion_generate(Context(model, device="cpu", **kw), prompt,
                                       diffusion.DiffusionParams(**p))
    ref = jdiff.diffusion_generate(JaxContext(jmodel, kv_dtype=jnp.float32, **kw), prompt,
                                   jdiff.DiffusionParams(**p))
    assert got == ref


@ARCH
def test_quantized_step_logits_match_jax(tmp_path, arch):
    """The Q4_K_M file (synthetic block scales / 256) in bf16 through both
    packages: a 64-row step's logits within NMSE 5e-3."""
    path = make_bench_diffusion_gguf(str(tmp_path / f"{arch}.gguf"), arch, **SHAPE,
                                     synth_scale=1.0 / 256)
    seq = np.full(64, 255)
    seq[:24] = np.random.default_rng(5).integers(3, 250, 24)
    kw = dict(n_ctx=64, n_seqs=1, n_ubatch=64)
    got = diffusion.step_logits(Context(load_model(path, device="cpu"), device="cpu", **kw), seq)
    jctx = JaxContext(jax_load_model(path), **kw)
    raw = np.asarray(jctx.decode(seq[None], np.asarray([0]), np.arange(64)[None],
                                 np.arange(64)))
    if arch == "dream":
        raw = np.concatenate([raw[:1], raw[:-1]])
    assert nmse(got, raw) < NMSE_QUANT


def test_diffusion_cli_prints_the_jax_clis_text(tiny, capsys):
    """llama-diffusion-cli with the same flags as the JAX package's (both
    load the file in their default dtype): the same printed text; its ids
    are diffusion_generate's on a Context of n_ctx = n_ubatch =
    max_length."""
    path = tiny["llada"][0]
    argv = ["-m", path, "-p", "the cat", "--diffusion-steps", "8", "--diffusion-max-length",
            "16", "--diffusion-block-length", "8", "--diffusion-algorithm", "entropy"]
    capsys.readouterr()
    ids = diffusion_cli.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    jax_diffusion_cli.main(argv)
    assert out == capsys.readouterr().out
    model = load_model(path, device="cpu")
    prompt = model.tokenizer.encode("the cat")
    want = diffusion.diffusion_generate(
        Context(model, device="cpu", n_ctx=16, n_seqs=1, n_ubatch=16), prompt,
        diffusion.DiffusionParams(steps=8, max_length=16, algorithm="entropy",
                                  schedule="block", block_length=8))
    assert ids == want and out == model.tokenizer.decode(ids) + "\n"


def test_diffusion_cli_warns_on_a_causal_model(tmp_path, capsys):
    from llama_cpp_tpu_torch.testing import make_bench_llama_gguf

    path = make_bench_llama_gguf(str(tmp_path / "l.gguf"), n_layers=1, n_embd=256, n_heads=4,
                                 n_kv_heads=2, n_ff=512, vocab_size=256)
    with pytest.raises(ValueError, match="mask token"):
        diffusion_cli.main(["-m", path, "--diffusion-steps", "1", "--diffusion-max-length", "8",
                            "--device", "cpu"])
    assert "is not a diffusion LM" in capsys.readouterr().err
