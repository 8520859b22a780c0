"""The port's Context under the JAX package's server scheduler
(llama_cpp_tpu/server/scheduler.py) on the CPU: the members the scheduler
and server read (recurrent, aux_layers, set_aux_capture, decode's aux
keyword, memory_breakdown), and two greedy requests served through it, whose
tokens must equal Context.generate's. The scheduler itself is framework-free;
this test imports both packages."""

import threading

import numpy as np
import pytest
import torch

from llama_cpp_tpu.sampling.samplers import SamplingParams
from llama_cpp_tpu.server.scheduler import GenTask, Scheduler
from llama_cpp_tpu_torch.models.loader import load_model
from llama_cpp_tpu_torch.runtime.context import Context
from llama_cpp_tpu_torch.testing import make_bench_llama_gguf

SHAPE = dict(n_layers=2, n_embd=512, n_heads=4, n_kv_heads=2, n_ff=1024, vocab_size=512,
             seed=0)
CTX = dict(n_ctx=256, n_seqs=2, n_ubatch=64, quantized_kv=True, device="cpu")
PROMPTS = ([5, 17, 300, 42, 9, 77, 120], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 200])


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    path = make_bench_llama_gguf(str(tmp_path_factory.mktemp("sched") / "m.gguf"), **SHAPE)
    return load_model(path, device="cpu")


def test_scheduler_serves_two_greedy_requests_as_generate_does(model):
    n_new = 6
    want = [Context(model, **CTX).generate(p, max_new_tokens=n_new) for p in PROMPTS]
    sched = Scheduler(Context(model, **CTX))
    results, done = {}, [threading.Event() for _ in PROMPTS]
    sched.start()
    try:
        for i, p in enumerate(PROMPTS):
            def cb(result, i=i):
                results[i] = result
                done[i].set()

            sched.submit(GenTask(prompt_ids=list(p), params=SamplingParams(temp=0.0),
                                 max_tokens=n_new, ignore_eos=True, done_cb=cb))
        assert all(ev.wait(timeout=300) for ev in done), "generation timed out"
    finally:
        sched.stop()
    assert [results[i]["tokens"] for i in range(len(PROMPTS))] == want


def test_memory_breakdown_counts_the_model_and_the_kv_memory(model):
    ctx = Context(model, **CTX)
    mb = ctx.memory_breakdown()
    assert set(mb) == {"model_bytes", "memory_bytes", "total_bytes"}
    kv = ctx.kv
    want_kv = sum(t.numel() * t.element_size()
                  for t in [*kv.k, *kv.v, *kv.k_scale, *kv.v_scale, kv.pos, kv.table])
    assert mb["memory_bytes"] == want_kv
    emb = model.params["token_embd"]
    assert mb["model_bytes"] > emb.q.numel()  # the planes of every weight
    assert mb["total_bytes"] == mb["model_bytes"] + mb["memory_bytes"]


def test_speculator_members_refuse_by_name(model):
    """recurrent and aux_layers read as a plain transformer's; a feature
    capture needs its layers named first (decode(aux=True) refuses
    without them), then returns each named layer's input rows, the
    pre-output-norm row for layer n_layers, beside the same logits."""
    ctx = Context(model, **CTX)
    assert ctx.recurrent is False and ctx.aux_layers == ()
    ctx.set_aux_capture(())  # nothing to capture
    with pytest.raises(ValueError, match="set_aux_capture"):
        ctx.decode(np.asarray([[5, 6]]), np.asarray([0]), np.asarray([[0, 1]]),
                   np.asarray([1]), aux=True)
    ctx.set_aux_capture((1, model.cfg.n_layers))
    lg_aux, feats = ctx.decode(np.asarray([[5, 6]]), np.asarray([0]), np.asarray([[0, 1]]),
                               np.asarray([1]), aux=True)
    assert feats.shape == (1, 2, 2 * model.cfg.n_embd) and np.isfinite(feats).all()
    ctx.seq_rm(0)
    logits = ctx.decode(np.asarray([[5, 6]]), np.asarray([0]), np.asarray([[0, 1]]),
                        np.asarray([1]), aux=False)
    assert logits.shape == (1, SHAPE["vocab_size"]) and np.isfinite(logits).all()
    np.testing.assert_array_equal(lg_aux, logits)
    assert torch.is_tensor(ctx.kv.pos)
