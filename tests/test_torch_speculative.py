"""The port's speculative decoding (runtime/speculative.py) against the JAX
package on the CPU, on the same seeded GGUF bytes: the n-gram lookup equals
JAX's NgramSpeculator.draft on random token lists; n-gram and draft-model
speculative_generate give the JAX package's ids and the port's plain
greedy ids, exactly (both run their plain versions here); a speculator whose
drafts are always rejected leaves the ids unchanged (rollback), and after a
rejection no row of the sequence past its length keeps a position label.

Fixtures: a llama (2 layers, n_embd 256, 4/2 heads of 64, n_ff 512, vocab
256) of seeded values from the JAX package's quantizer, the target at Q8_0
and its draft at Q4_0: the same values, so the draft's greedy ids agree with
the target's at some steps and not at others."""

import numpy as np
import pytest
import torch

from llama_cpp_tpu.models.loader import load_model as jax_load_model
from llama_cpp_tpu.runtime.context import Context as JaxContext
from llama_cpp_tpu.runtime import speculative as jspec
from llama_cpp_tpu.testing import make_tiny_llama_gguf as jax_make_tiny
from llama_cpp_tpu_torch.models.loader import load_model
from llama_cpp_tpu_torch.runtime.context import Context
from llama_cpp_tpu_torch.runtime.speculative import (
    DraftModelSpeculator,
    NgramSpeculator,
    speculative_generate,
)

SHAPE = dict(vocab_size=256, n_layers=2, n_embd=256, n_heads=4, n_kv_heads=2, n_ff=512,
             seed=3)
CTX = dict(n_ctx=128, n_seqs=1, n_ubatch=32)
PROMPT = [5, 9, 23, 9, 23, 9, 23, 42, 17, 9, 23, 9, 23, 42]
N_NEW = 20
MEM = pytest.mark.parametrize("paged", [True, False], ids=["paged", "slots"])


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_spec")
    return (jax_make_tiny(str(d / "target.gguf"), ftype="q8_0", **SHAPE),
            jax_make_tiny(str(d / "draft.gguf"), ftype="q4_0", **SHAPE))


@pytest.fixture(scope="module")
def models(paths):
    return [load_model(p, device="cpu") for p in paths]


@pytest.fixture(scope="module")
def plain_ids(models):
    return {paged: Context(models[0], device="cpu", paged=paged, **CTX).generate(PROMPT, N_NEW)
            for paged in (True, False)}


@pytest.fixture(scope="module")
def jax_runs(paths):
    """The JAX package's n-gram and draft-model runs on the same files."""
    target, draft = (jax_load_model(p) for p in paths)
    ng = jspec.speculative_generate(JaxContext(target, **CTX), jspec.NgramSpeculator(1, 3),
                                    PROMPT, N_NEW, n_draft=4)
    dm = jspec.speculative_generate(
        JaxContext(target, **CTX), jspec.DraftModelSpeculator(JaxContext(draft, **CTX)),
        PROMPT, N_NEW, n_draft=4)
    return {"ngram": ng, "draft": dm}


@pytest.mark.parametrize("seed", range(10))
def test_ngram_lookup_equals_jax(seed):
    """Random token lists over small alphabets (so suffixes recur) at every
    (n_min, n_max) and draft length: the port's draft is the JAX package's."""
    rng = np.random.default_rng(seed)
    for _ in range(20):
        toks = [int(t) for t in rng.integers(0, 2 + seed % 4, int(rng.integers(1, 40)))]
        n_min = int(rng.integers(1, 3))
        n_max = n_min + int(rng.integers(0, 3))
        n = int(rng.integers(1, 9))
        got = NgramSpeculator(n_min, n_max).draft(toks, n)
        assert got == jspec.NgramSpeculator(n_min, n_max).draft(toks, n)
        assert len(got) <= n


def test_ngram_lookup_examples():
    sp = NgramSpeculator(n_min=1, n_max=3)
    assert sp.draft([1, 2, 3, 4, 1, 2, 3], 2) == [4, 1]
    assert sp.draft([7, 8, 9], 4) == []


@MEM
def test_ngram_spec_ids_equal_jax_and_generate(models, plain_ids, jax_runs, paged):
    out, stats = speculative_generate(Context(models[0], device="cpu", paged=paged, **CTX),
                                      NgramSpeculator(1, 3), PROMPT, N_NEW, n_draft=4)
    assert out == plain_ids[paged] == jax_runs["ngram"][0]
    assert stats == jax_runs["ngram"][1] and stats["n_accept"] > 0 and len(out) == N_NEW


@MEM
def test_draft_model_spec_ids_equal_jax_and_generate(models, plain_ids, jax_runs, paged):
    """A draft of other weights: some drafts accepted, some rolled back, the
    ids the target's own."""
    ctx = Context(models[0], device="cpu", paged=paged, **CTX)
    spec = DraftModelSpeculator(Context(models[1], device="cpu", paged=paged, **CTX))
    out, stats = speculative_generate(ctx, spec, PROMPT, N_NEW, n_draft=4)
    assert out == plain_ids[paged] == jax_runs["draft"][0]
    assert stats == jax_runs["draft"][1]
    assert 0 < stats["n_accept"] < stats["n_draft"]


class Rejected:
    """Drafts that are never the model's tokens, every other step none."""

    def __init__(self):
        self.calls = 0

    def draft(self, tokens, n):
        self.calls += 1
        return [255, 254, 253, 252, 251, 250, 249, 248][: n if self.calls % 2 else 0]

    def reset(self):
        pass


@MEM
@pytest.mark.parametrize("n_draft", [3, 8], ids=["verify8", "verify16"])
def test_rollback_keeps_the_ids(models, plain_ids, paged, n_draft):
    """Verify steps of 4 and 9 rows (buckets of 8 and 16), every draft
    rejected: the suffix seq_rm rolls each back and the ids stay the plain
    run's."""
    ctx = Context(models[0], device="cpu", paged=paged, **CTX)
    out, stats = speculative_generate(ctx, Rejected(), PROMPT, N_NEW, n_draft=n_draft)
    assert out == plain_ids[paged]
    assert stats["n_accept"] == 0 and stats["n_draft"] > 0


@MEM
def test_rejected_rows_carry_no_position(models, paged):
    """After one verify step whose drafts are all rejected, the sequence's
    rows hold exactly positions 0 .. seq_len - 1: the rejected rows inside
    the kept page are labelled -1, so the next verify's attention cannot
    read them."""
    ctx = Context(models[0], device="cpu", paged=paged, **CTX)
    out, stats = speculative_generate(ctx, Rejected(), PROMPT, 10, n_draft=8)
    n = int(ctx.seq_len[0])
    if paged:
        pos = ctx.kv.seq_slot_pos(torch.tensor([0]))[0]
    else:
        pos = ctx.kv.pos[0]
    live = sorted(int(p) for p in pos if p >= 0)
    assert live == list(range(n)) and n == len(PROMPT) + len(out) - 1
    assert stats["n_draft"] == 8 + 6 + 4 + 2 and stats["n_accept"] == 0
