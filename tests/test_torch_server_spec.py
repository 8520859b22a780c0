"""The port's llama-server features beyond plain decoding, on the CPU:
speculative decoding in the scheduler (n-gram and draft model: every
slot's [token | drafts] rows verified in one batched decode, padding rows
included) gives the non-speculative scheduler's greedy ids; a served
--spec ngram round gives Context.generate's ids; POST /slots/{id} saves,
erases and restores a slot, after which a request that reuses the slot's
prefix answers as on a server that never saved; a request longer than
n_ctx finishes with all its tokens through context shifts, each id held
teacher-forced against the port's and the JAX package's steps with the same
shifts, on the pool and the slot table.

Fixtures: a llama (2 layers, n_embd 256, 4/2 heads of 64, n_ff 512, vocab
256) of seeded values from the JAX package's quantizer, Q8_0 (the target)
and Q4_0 (its draft)."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from llama_cpp_tpu.models.loader import load_model as jax_load_model
from llama_cpp_tpu.runtime.context import Context as JaxContext
from llama_cpp_tpu.testing import make_tiny_llama_gguf as jax_make_tiny
from llama_cpp_tpu_torch.models.loader import load_model
from llama_cpp_tpu_torch.runtime.context import Context
from llama_cpp_tpu_torch.sampling.samplers import SamplingParams
from llama_cpp_tpu_torch.server import app as server_app
from llama_cpp_tpu_torch.server.scheduler import GenTask, Scheduler

SHAPE = dict(vocab_size=256, n_layers=2, n_embd=256, n_heads=4, n_kv_heads=2, n_ff=512, seed=3)
CTX = dict(n_ctx=128, n_seqs=4, n_ubatch=32)
PROMPTS = [[5, 9, 23, 9, 23, 9, 23, 42, 17, 9, 23], [4, 8, 15, 16, 23, 42, 4, 8, 15],
           [100, 101, 102, 100, 101], [7, 7, 7, 7, 7, 7, 7]]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_server_spec")
    return {ft: jax_make_tiny(str(d / f"{ft}.gguf"), ftype=ft, **SHAPE)
            for ft in ("q8_0", "q4_0")}


@pytest.fixture(scope="module")
def models(paths):
    return {ft: load_model(p, device="cpu") for ft, p in paths.items()}


def run_tasks(sched, prompts, n_predict):
    """Submit every prompt at once (greedy, ignore_eos) -> their results."""
    done = [threading.Event() for _ in prompts]
    out = [None] * len(prompts)

    def finish(i):
        def cb(result):
            out[i] = result
            done[i].set()
        return cb

    sched.start()
    try:
        for i, p in enumerate(prompts):
            sched.submit(GenTask(prompt_ids=list(p), params=SamplingParams(temp=0.0),
                                 max_tokens=n_predict, ignore_eos=True, done_cb=finish(i)))
        assert all(e.wait(120) for e in done)
    finally:
        sched.stop()
    return out


@pytest.fixture(scope="module")
def plain_results(models):
    return run_tasks(Scheduler(Context(models["q8_0"], device="cpu", **CTX)), PROMPTS[:3], 16)


@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_speculative_scheduler_ids_equal_the_plain_schedulers(models, plain_results, mode):
    ctx = Context(models["q8_0"], device="cpu", **CTX)
    factory = server_app.spec_factory(ctx, draft_model=models["q4_0"] if mode == "draft"
                                      else None, spec="ngram" if mode == "ngram" else "")
    sched = Scheduler(ctx, spec_factory=factory, n_draft=4)
    got = run_tasks(sched, PROMPTS[:3], 16)  # 3 slots: the verify batch pads a fourth row
    assert [r["tokens"] for r in got] == [r["tokens"] for r in plain_results]
    assert all(r["finish_reason"] == "length" and r["n_generated"] == 16 for r in got)
    m = sched.metrics
    assert 0 < m["draft_tokens_accepted"] <= m["draft_tokens_total"]
    if mode == "draft":
        assert m["draft_tokens_accepted"] < m["draft_tokens_total"]


class Served:
    def __init__(self, model, **kw):
        box, ready = {}, threading.Event()
        self.thread = threading.Thread(
            target=server_app.run_server, args=(model,), daemon=True,
            kwargs=dict(host="127.0.0.1", port=0, device="cpu",
                        ready=lambda s: (box.setdefault("s", s), ready.set()), **kw))
        self.thread.start()
        assert ready.wait(60)
        self.server = box["s"]
        self.url = f"http://127.0.0.1:{self.server.port}"

    def request(self, path, body=None):
        data = None if body is None else json.dumps(body).encode()
        try:
            with urllib.request.urlopen(urllib.request.Request(self.url + path, data=data),
                                        timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def close(self):
        self.server.shutdown()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


def test_served_ngram_round_equals_generate(models):
    s = Served(models["q8_0"], spec="ngram", n_draft=4, **{**CTX, "n_seqs": 2})
    try:
        replies = [s.request("/completion", {"prompt": p, "n_predict": 12, "temperature": 0,
                                             "ignore_eos": True, "return_tokens": True})
                   for p in PROMPTS[:2]]
        drafted = s.server.app.sched.metrics["draft_tokens_total"]
    finally:
        s.close()
    for (status, body), p in zip(replies, PROMPTS):
        want = Context(models["q8_0"], device="cpu", **CTX).generate(p, 12)
        assert status == 200 and body["tokens"] == want
    assert drafted > 0


def test_slot_save_erase_restore(models, tmp_path):
    """Save slot 0 after a request, erase it, restore it: a second request
    that shares the first's prefix reuses the restored rows and answers as
    on a server that never saved."""
    first = {"prompt": PROMPTS[0], "n_predict": 8, "temperature": 0, "return_tokens": True}
    second = {"prompt": PROMPTS[0] + [77, 78], "n_predict": 8, "temperature": 0,
              "return_tokens": True}
    s = Served(models["q8_0"], slot_save_dir=str(tmp_path), **{**CTX, "n_seqs": 1})
    try:
        assert s.request("/completion", first)[0] == 200
        status, saved = s.request("/slots/0?action=save", {"filename": "s0.bin"})
        assert status == 200 and saved["n_written"] == (tmp_path / "s0.bin").stat().st_size
        assert s.request("/slots/0?action=erase", {})[1] == {"id_slot": 0, "erased": True}
        assert int(s.server.app.ctx.seq_len[0]) == 0
        status, restored = s.request("/slots/0?action=restore", {"filename": "s0.bin"})
        assert status == 200 and restored["n_restored"] == len(PROMPTS[0]) + 7
        status, got = s.request("/completion", second)
        cached = s.server.app.sched.metrics["tokens_prompt_cached_total"]
        assert s.request("/slots/0?action=restore", {"filename": "none.bin"})[0] == 404
        assert s.request("/slots/9?action=save", {})[0] == 400
        assert s.request("/slots/0?action=fly", {})[0] == 400
    finally:
        s.close()
    ref = Served(models["q8_0"], **{**CTX, "n_seqs": 1})
    try:
        ref.request("/completion", first)
        want = ref.request("/completion", second)[1]
    finally:
        ref.close()
    assert status == 200 and got["tokens"] == want["tokens"] and cached == len(PROMPTS[0])


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slots"])
def test_request_past_n_ctx_completes_through_context_shifts(models, paths, paged):
    """n_ctx 64, 100 tokens asked: the slot shifts its context (twice) and
    finishes with all 100. Each id is held teacher-forced, with the shifts
    at the scheduler's points, against the port's own steps (its argmax,
    exactly) and the JAX package's (its argmax, or the parting of a
    near-tie: the JAX logit of the port's id within twice the step's
    largest difference between the two packages' logits; this fixture has
    one at step 23, a gap of 0.0076)."""
    kw = dict(n_ctx=64, n_seqs=1, n_ubatch=32)
    got = run_tasks(Scheduler(Context(models["q8_0"], device="cpu", paged=paged, **kw)),
                    PROMPTS[:1], 100)[0]
    assert got["finish_reason"] == "length" and got["n_generated"] == 100
    ctx = Context(models["q8_0"], device="cpu", paged=paged, **kw)
    jctx = JaxContext(jax_load_model(paths["q8_0"]), paged=paged, **kw)
    lp, lj = ctx.prefill(PROMPTS[0]), np.asarray(jctx.prefill(PROMPTS[0]))
    shifts = ties = 0
    for t in got["tokens"]:
        assert t == int(np.argmax(lp))
        if int(np.argmax(lj)) != t:
            assert lj.max() - lj[t] <= 2 * np.abs(lp - lj).max()
            ties += 1
        if int(ctx.seq_len[0]) + 1 >= kw["n_ctx"]:
            assert ctx.context_shift(0) == jctx.context_shift(0)
            shifts += 1
        lp, lj = ctx.decode_one(t), np.asarray(jctx.decode_one(t))
    assert shifts == 2 and ties <= 2


def test_server_refuses_a_feature_draft(tmp_path, capsys):
    """A draft whose speculator reads the target's features (here eagle3)
    exits with 2 and names its arch, before any model is loaded."""
    from llama_cpp_tpu_torch.gguf.writer import GGUFWriter

    path = str(tmp_path / "eagle3.gguf")
    w = GGUFWriter()
    w.add("general.architecture", "eagle3")
    w.write(path)
    rc = server_app.main(["-m", "absent.gguf", "-md", path, "--device", "cpu"])
    err = capsys.readouterr().err
    assert rc == 2 and "'eagle3'" in err and "not ported" in err
