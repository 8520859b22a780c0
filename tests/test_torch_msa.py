"""The port's minimax-m3 entry (MSA block-sparse attention on a DSAMemory)
against the JAX package on the CPU, on the layout of the JAX package's
tests/test_archs2.py::test_minimax_m3_msa (2 layers, n_embd 64, 4/2 heads
of 16, rope on 8 dims, indexer keys of 16 in blocks of 8, 4 experts top 2
with a shared expert; testing.make_bench_arch_gguf with its indexer) read
by both from the same f32 bytes, a 40-token prompt:

  * at top_k >= n_blocks every block is selected: ids and logits equal
    the dense twin's (the same weights, MSA off); at top_k = 1 the ids
    equal the JAX package's, and so at top_k = 2;
  * the indexer cache holds the JAX cache's keys at every labelled slot;
  * a dense-lead layer (no indexer) attends the DSAMemory's slot table;
    the indexer cache is labelled by the MSA layers themselves;
  * the memory's sequence ops, per-sequence blobs (both ways with the JAX
    package) and whole-context files (the port's own layout; the JAX
    package's refused with a ValueError).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_tpu.models.loader import load_model as jax_load_model
from llama_cpp_tpu.runtime import state as jax_state
from llama_cpp_tpu.runtime.context import Context as JaxContext
from llama_cpp_tpu_torch.models.loader import load_model
from llama_cpp_tpu_torch.runtime import state
from llama_cpp_tpu_torch.runtime.context import Context
from llama_cpp_tpu_torch.runtime.memory import DSAMemory
from llama_cpp_tpu_torch.testing import MINIMAX_M3_LAYOUT, make_bench_arch_gguf

SHAPE = dict(n_layers=2, n_embd=64, n_heads=4, n_kv_heads=2, head_dim=16, n_ff=96,
             vocab_size=96, n_ctx=256)
PROMPT = [3, 5, 9, 2, 7, 11, 13, 17] * 5  # 40 tokens: 5 blocks of 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def layout(top_k: int, dense_lead: int = 0) -> dict:
    md = {**MINIMAX_M3_LAYOUT["metadata"], "rope.dimension_count": np.uint32(8),
          "attention.indexer.key_length": np.uint32(16),
          "attention.indexer.top_k": np.uint32(top_k),
          "attention.indexer.block_size": np.uint32(8)}
    return {**MINIMAX_M3_LAYOUT, "metadata": md, "indexer_dim": 16, "n_dense_lead": dense_lead,
            "n_expert": 4, "n_expert_used": 2, "n_ff_exp": 32, "shared_expert_ff": 32}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("msa")
    made = {}

    def get(top_k, dense_lead=0):
        key = (top_k, dense_lead)
        if key not in made:
            path = make_bench_arch_gguf(str(d / f"m{top_k}-{dense_lead}.gguf"), "minimax-m3",
                                        f32=True, **SHAPE, **layout(top_k, dense_lead))
            made[key] = path
        return made[key]

    return get


def port(path):
    return load_model(path, device="cpu", prefer_quant=False, dense_dtype=torch.float32)


def jax(path):
    return jax_load_model(path, prefer_quant=False, dense_dtype=jnp.float32)


def port_ctx(model, **kw):
    return Context(model, n_ctx=64, n_seqs=2, device="cpu", **kw)


def jax_ctx(model):
    return JaxContext(model, n_ctx=64, n_seqs=2, kv_dtype=jnp.float32)


def test_entry_and_memory_match_jax(files):
    model, jmodel = port(files(64)), jax(files(64))
    for key in ("msa", "indexer_head_size", "indexer_top_k", "indexer_block_size",
                "indexer_local_blocks"):
        assert model.cfg.extra[key] == jmodel.cfg.extra[key], key
    for field in ("expert_gating", "expert_weights_norm", "n_expert_shared", "rope_dims"):
        assert getattr(model.cfg, field) == getattr(jmodel.cfg, field), field
    assert [set(lw) for lw in model.params["layers"]] == [
        set(lw) for lw in jmodel.params["layers"]]
    ctx = port_ctx(model)
    assert isinstance(ctx.kv, DSAMemory) and not ctx.paged
    assert ctx.kv.idx.k[0].shape == (2, 1, ctx.n_slots, 16)


def test_all_blocks_selected_equals_the_dense_twin(files):
    model = port(files(64))
    ctx = port_ctx(model)
    logits, ids = ctx.prefill(PROMPT), ctx.generate(PROMPT, 4, seq=1)
    model.cfg.extra.pop("msa")
    dense = port_ctx(model)
    np.testing.assert_allclose(logits, dense.prefill(PROMPT), rtol=1e-5, atol=1e-5)
    assert ids == dense.generate(PROMPT, 4, seq=1)


@pytest.mark.parametrize("top_k", [1, 2, 64])
def test_ids_match_jax(files, top_k):
    path = files(top_k)
    assert port_ctx(port(path)).generate(PROMPT, 4) == jax_ctx(jax(path)).generate(PROMPT, 4)


def test_top_1_selection_is_sparse(files):
    """At top_k = 1 only the query's own block is kept: the logits part from
    the all-blocks model's on the same weights."""
    sparse = port_ctx(port(files(1))).prefill(PROMPT)
    full = port_ctx(port(files(64))).prefill(PROMPT)
    assert np.abs(sparse - full).max() > 1e-3


def test_indexer_cache_holds_the_jax_keys(files):
    path = files(1)
    ctx, jctx = port_ctx(port(path)), jax_ctx(jax(path))
    ctx.prefill(PROMPT)
    jctx.prefill(PROMPT)
    pos = ctx.kv.idx.pos[0].numpy()
    assert np.array_equal(pos, np.asarray(jctx.kv.idx.pos[0]))
    held = pos >= 0
    assert held.sum() == len(PROMPT)
    for il in range(SHAPE["n_layers"]):
        np.testing.assert_allclose(ctx.kv.idx.k[il][0, 0].numpy()[held],
                                   np.asarray(jctx.kv.idx.k[il][0, 0])[held],
                                   rtol=1e-5, atol=1e-5)


def test_dense_lead_layer_on_the_slot_table(files):
    """A dense-lead layer (no indexer) attends the DSAMemory's slot table;
    the MSA layer labels the indexer cache itself, so at top_k >= n_blocks
    the model still equals its dense twin."""
    model = port(files(64, 1))
    assert "indexer_q_proj" not in model.params["layers"][0]
    assert "indexer_q_proj" in model.params["layers"][1]
    ctx = port_ctx(model)
    logits = ctx.prefill(PROMPT)
    assert (ctx.kv.idx.pos[0] >= 0).sum() == len(PROMPT)
    model.cfg.extra.pop("msa")
    np.testing.assert_allclose(logits, port_ctx(model).prefill(PROMPT), rtol=1e-5, atol=1e-5)


def test_sequence_ops_reach_both_caches(files):
    ctx = port_ctx(port(files(1)))
    ctx.prefill(PROMPT, seq=0)
    ctx.seq_cp(1, 0)
    for cache in (ctx.kv.kv, ctx.kv.idx):
        assert torch.equal(cache.pos[1], cache.pos[0]) and torch.equal(cache.k[1][1],
                                                                        cache.k[1][0])
    ctx.seq_rm(1, p0=20)
    for cache in (ctx.kv.kv, ctx.kv.idx):
        assert int((cache.pos[1] >= 0).sum()) == 20


def test_sequence_blob_round_trip_and_from_jax(files):
    path = files(1)
    ctx = port_ctx(port(path))
    ctx.prefill(PROMPT[:30], seq=0)
    blob = state.save_seq_state(ctx, 0)
    want = ctx.decode_one(PROMPT[30], seq=0)
    other = port_ctx(port(path))
    assert state.load_seq_state(other, 1, blob) == 30
    np.testing.assert_array_equal(other.decode_one(PROMPT[30], seq=1), want)
    # a blob the JAX package wrote loads here and continues as it does there
    jctx = jax_ctx(jax(path))
    jctx.prefill(PROMPT[:30], seq=0)
    jblob = jax_state.save_seq_state(jctx, 0)
    fresh = port_ctx(port(path))
    assert state.load_seq_state(fresh, 0, jblob) == 30
    np.testing.assert_allclose(fresh.decode_one(PROMPT[30], seq=0),
                               np.asarray(jctx.decode_one(PROMPT[30], seq=0)),
                               rtol=1e-4, atol=1e-4)


def test_whole_context_file_round_trip_and_jax_refused(files, tmp_path):
    path = files(1)
    ctx = port_ctx(port(path))
    ctx.prefill(PROMPT, seq=0)
    f = str(tmp_path / "s.npz")
    state.save_state(ctx, f)
    names = [n for n, _ in state.memory_tensors(ctx.kv)]
    assert "kv.pos" in names and "idx.k.1" in names
    fresh = port_ctx(port(path))
    state.load_state(fresh, f)
    np.testing.assert_array_equal(fresh.decode_one(PROMPT[0], seq=0),
                                  ctx.decode_one(PROMPT[0], seq=0))
    jctx = jax_ctx(jax(path))
    jctx.prefill(PROMPT, seq=0)
    jf = str(tmp_path / "j.npz")
    jax_state.save_state(jctx, jf)
    with pytest.raises(ValueError):
        state.load_state(port_ctx(port(path)), jf)


def test_a_jax_prefill_continues_in_the_port(files):
    """The JAX package's params and memory after its prefill
    (models/from_jax.py) give the port's next step the JAX next step's
    logits."""
    from jax.tree_util import tree_map

    from llama_cpp_tpu_torch.models.from_jax import dsa_from_jax, params_from_jax

    path = files(1)
    model, jctx = port(path), jax_ctx(jax(path))
    jctx.prefill(PROMPT, seq=0)
    model.params = params_from_jax(tree_map(np.asarray, jctx.model.params))
    ctx = port_ctx(model)
    ctx.kv = dsa_from_jax(tree_map(np.asarray, jctx.kv))
    ctx.seq_len[0] = len(PROMPT)
    np.testing.assert_allclose(ctx.decode_one(PROMPT[0], seq=0),
                               np.asarray(jctx.decode_one(PROMPT[0], seq=0)),
                               rtol=1e-4, atol=1e-4)
