"""The PyTorch port's mixture-of-experts decode steps against the JAX package
on the CPU, on tests/test_torch_moe.py's second model (a llama-arch MoE whose
matrices the JAX package's Q4_K quantizer made from random values: 2
layers, n_embd 512, 4 experts of 512, top-2): teacher-forced decode steps
against the JAX package's, and batched greedy decode rows against their own
B = 1 runs. A file of its own so that pytest-xdist's --dist loadfile runs
these steps beside tests/test_torch_moe.py, on another worker. Torch runs on
one thread here, as in the other port files."""

import numpy as np
import pytest
import torch

from llama_cpp_tpu.models.loader import load_model as jax_load_model
from llama_cpp_tpu.runtime.context import Context as JaxContext
from llama_cpp_tpu_torch.models.loader import load_model
from llama_cpp_tpu_torch.runtime.context import Context

from test_torch_moe import CTX, MEM, make_quantized_moe_gguf, nmse, prompts


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def quantized_models(tmp_path_factory):
    path = make_quantized_moe_gguf(str(tmp_path_factory.mktemp("torch_moe_q") / "q.gguf"))
    return load_model(path, device="cpu"), jax_load_model(path)


@MEM
def test_teacher_forced_steps_with_quantizer_weights_match_jax(quantized_models, paged):
    """Both packages consume the JAX package's greedy ids; each step's logits
    agree to NMSE < 1e-3 and the argmax agrees wherever the JAX top-2 gap
    exceeds 0.1 (a closer near-tie may part free-running ids: the two sum
    f32 products in different orders)."""
    model, jmodel = quantized_models
    prompt = prompts(1, 40, seed=6)[0]
    ctx = Context(model, quantized_kv=True, device="cpu", paged=paged, **CTX)
    jctx = JaxContext(jmodel, quantized_kv=True, paged=paged, **CTX)
    got, ref = ctx.prefill(prompt), jctx.prefill(prompt)
    decided, seen = 0, set()
    for _ in range(12):
        assert nmse(got, ref) < 1e-3
        top2 = np.sort(ref)[-2:]
        if top2[1] - top2[0] > 0.1:
            assert int(np.argmax(got)) == int(np.argmax(ref))
            decided += 1
        tok = int(np.argmax(ref))
        seen.add(tok)
        got, ref = ctx.decode_one(tok), jctx.decode_one(tok)
    assert decided >= 6 and len(seen) > 3


def test_decode_steps_greedy_rows_are_independent(quantized_models):
    """Batched greedy decode at B = 3 (6 slots >= 4 experts: the ragged
    route) gives each sequence the ids of its own B = 1 decode (the gather
    route): XLA:CPU has no bf16 x bf16 -> f32 dot for the JAX batched step,
    so the batch is held against the port's own B = 1 steps, and those
    against JAX above."""
    model, _ = quantized_models
    ps = prompts(3, 30, seed=8)
    ctx = Context(model, quantized_kv=True, device="cpu", **CTX)
    one = Context(model, quantized_kv=True, device="cpu", **CTX)
    first, ref = [], []
    for s, p in enumerate(ps):
        p = p[: 20 + 4 * s]
        first.append(int(np.argmax(ctx.prefill(p, seq=s))))
        ref.append(one.generate(p, 7, seq=s)[1:])
    got = ctx.decode_steps_greedy(np.asarray(first), np.arange(3), 6)
    np.testing.assert_array_equal(got, np.asarray(ref))
