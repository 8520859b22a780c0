"""The port's llama-server (llama_cpp_tpu_torch/server/, standard-library
HTTP over the continuous-batching scheduler) on the CPU, against the JAX
package's ServerApp (aiohttp test client) on the same GGUF: the same
content, finish reason and usage on every generation route, greedy; four
concurrent greedy requests equal Context.generate; a pool too small for
every slot finishes a victim with "length" and serves the rest; the
routes and flags whose modules are not ported (multimodal input, parallel
serving, the router) answer 501 or exit 2 and name the module (the
embedding routes: tests/test_torch_encoders.py); and the scheduler's one-step calls, decode_step_greedy
and decode_step_multi through the decode loops, equal the eager ubatch
step (Context.decode) at changing batch sizes with padding rows."""

import asyncio
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from llama_cpp_tpu.models.loader import load_model as jax_load_model
from llama_cpp_tpu.runtime.context import Context as JaxContext
from llama_cpp_tpu.server.app import ServerApp as JaxServerApp
from llama_cpp_tpu.server.scheduler import Scheduler as JaxScheduler
from llama_cpp_tpu.testing import make_tiny_llama_gguf as jax_make_tiny
from llama_cpp_tpu_torch.models.loader import load_model
from llama_cpp_tpu_torch.runtime.context import Context
from llama_cpp_tpu_torch.server import app as server_app

CTX = dict(n_ctx=256, n_seqs=4, n_ubatch=64, quantized_kv=True)
PROMPT = "the cat is on the mat and that was it"
MESSAGES = [{"role": "system", "content": "be brief"},
            {"role": "user", "content": "the cat"}]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    """Weights from the JAX package's quantizer (Q4_K): their greedy ids vary."""
    return jax_make_tiny(str(tmp_path_factory.mktemp("server") / "q4k.gguf"), vocab_size=512,
                         n_layers=2, n_embd=512, n_heads=4, n_kv_heads=2, n_ff=1024,
                         ftype="q4_k", seed=3)


@pytest.fixture(scope="module")
def model(gguf):
    return load_model(gguf, device="cpu")


class Served:
    """The port's server in a thread on a free port of 127.0.0.1."""

    def __init__(self, model, **kw):
        box, ready = {}, threading.Event()

        def on_ready(server):
            box["server"] = server
            ready.set()

        self.thread = threading.Thread(
            target=server_app.run_server, args=(model,), daemon=True,
            kwargs=dict(host="127.0.0.1", port=0, ready=on_ready, **kw))
        self.thread.start()
        assert ready.wait(60), "the server did not start"
        self.server = box["server"]
        self.url = f"http://127.0.0.1:{self.server.port}"

    def request(self, path, body=None):
        """-> (status, bytes); body None makes a GET."""
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(self.url + path, data=data,
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def close(self):
        self.server.shutdown()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


@pytest.fixture(scope="module")
def port_server(model):
    s = Served(model, n_seqs=CTX["n_seqs"], n_ctx=CTX["n_ctx"], n_ubatch=CTX["n_ubatch"],
               quantized_kv=True)
    yield s
    s.close()


@pytest.fixture(scope="module")
def jax_server(gguf):
    """The JAX package's ServerApp over its own Context on the same file,
    answered through aiohttp's test client on a private event loop."""
    sched = JaxScheduler(JaxContext(jax_load_model(gguf), **CTX))
    sched.start()
    loop = asyncio.new_event_loop()
    client = TestClient(TestServer(JaxServerApp(sched, model_name="model").app), loop=loop)
    loop.run_until_complete(client.start_server())

    def request(path, body):
        async def go():
            r = await client.post(path, json=body)
            return r.status, await r.read()
        return loop.run_until_complete(go())

    yield request
    loop.run_until_complete(client.close())
    loop.close()
    sched.stop()


def sse_events(raw: bytes) -> list:
    """The JSON objects of an SSE body, ending before `data: [DONE]`."""
    lines = [ln[6:] for ln in raw.decode().split("\n\n") if ln.startswith("data: ")]
    assert lines[-1] == "[DONE]"
    return [json.loads(ln) for ln in lines[:-1]]


def answer(route, raw):
    """What both servers must agree on: the text, the finish reason and
    the usage (ids and timestamps differ)."""
    if route == "chat_stream":
        events = sse_events(raw)
        text = "".join(e["choices"][0]["delta"].get("content") or "" for e in events)
        return text, events[-1]["choices"][0]["finish_reason"], events[-1]["usage"]
    if route == "completion_stream":
        events = sse_events(raw)
        text = "".join(e["choices"][0]["text"] for e in events)
        return text, events[-1]["choices"][0]["finish_reason"], events[-1]["usage"]
    out = json.loads(raw)
    if route in ("completion", "v1_completions"):
        return out["choices"][0]["text"], out["choices"][0]["finish_reason"], out["usage"]
    if route in ("chat", "chat_stop"):
        c = out["choices"][0]
        return c["message"]["content"], c["finish_reason"], out["usage"]
    if route == "messages":
        return out["content"][0]["text"], out["stop_reason"], out["usage"]
    if route == "responses":
        return out["output_text"], out["status"], out["usage"]
    return out  # tokenize, detokenize, infill


ROUTES = {
    "completion": ("/completion", {"prompt": PROMPT, "n_predict": 6, "temperature": 0}),
    "v1_completions": ("/v1/completions", {"prompt": "the mat", "max_tokens": 5,
                                           "temperature": 0, "stop": [" w9"]}),
    "completion_stream": ("/completion", {"prompt": PROMPT, "n_predict": 6, "temperature": 0,
                                          "stream": True}),
    "chat": ("/v1/chat/completions", {"messages": MESSAGES, "max_tokens": 6,
                                      "temperature": 0}),
    "chat_stream": ("/v1/chat/completions", {"messages": MESSAGES, "max_tokens": 6,
                                             "temperature": 0, "stream": True}),
    "chat_stop": ("/v1/chat/completions", {"messages": MESSAGES[1:], "max_tokens": 6,
                                           "temperature": 0, "stop": "w"}),
    "messages": ("/v1/messages", {"system": "be brief", "messages": MESSAGES[1:],
                                  "max_tokens": 5, "temperature": 0}),
    "responses": ("/v1/responses", {"input": "the cat", "instructions": "be brief",
                                    "max_output_tokens": 4, "temperature": 0}),
    "infill": ("/infill", {"input_prefix": "the", "input_suffix": "mat", "n_predict": 4,
                           "temperature": 0}),
    "tokenize": ("/tokenize", {"content": PROMPT, "add_special": True}),
    "detokenize": ("/detokenize", {"tokens": [1, 288, 259, 262, 298, 301]}),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_route_answers_as_the_jax_app(port_server, jax_server, route):
    path, body = ROUTES[route]
    status, raw = port_server.request(path, body)
    jstatus, jraw = jax_server(path, body)
    assert status == jstatus == 200
    got, ref = answer(route, raw), answer(route, jraw)
    assert got == ref
    if isinstance(ref, tuple):  # a generation: the tokens it counted
        usage = ref[2]
        assert usage.get("completion_tokens", usage.get("output_tokens")) >= 1


def test_stream_equals_non_stream(port_server):
    path, body = ROUTES["chat"]
    _, plain = port_server.request(path, body)
    _, streamed = port_server.request(path, {**body, "stream": True})
    text, finish, usage = answer("chat_stream", streamed)
    ref = json.loads(plain)
    assert text == ref["choices"][0]["message"]["content"]
    assert finish == ref["choices"][0]["finish_reason"] and usage == ref["usage"]


def test_four_concurrent_greedy_requests_equal_generate(model, port_server):
    """Four requests at once (continuous batching at B = 4, 3, ... as they
    finish), each with its own prompt and length: each reply's ids are
    Context.generate's for that prompt."""
    tok = model.tokenizer
    prompts = [PROMPT, "the mat", "that was it and the cat", "on"]
    n_new = [7, 4, 6, 5]
    replies = [None] * 4

    def ask(i):
        replies[i] = port_server.request("/completion", {
            "prompt": prompts[i], "n_predict": n_new[i], "temperature": 0,
            "ignore_eos": True, "return_tokens": True, "cache_prompt": False})

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    for i, (status, raw) in enumerate(replies):
        ids = tok.encode(prompts[i], add_special=True, parse_special=True)
        want = Context(model, n_ctx=256, device="cpu", quantized_kv=True).generate(ids, n_new[i])
        out = json.loads(raw)
        assert status == 200 and out["tokens"] == want
        assert out["choices"][0]["text"] == "".join(tok.piece(t) for t in want)
    metrics = port_server.request("/metrics")[1].decode()
    assert "llamacpp_tpu_tokens_predicted_total" in metrics


def test_a_full_pool_finishes_a_victim_with_length(model):
    """Two 200-token prompts in a pool of 3 pages of 256 rows: both cross
    into a second page at the same step, the pool has one page left, so the
    scheduler finishes one request early with "length" and the other gets
    every token it asked for."""
    s = Served(model, n_seqs=2, n_ctx=512, n_ubatch=64, quantized_kv=True, kv_total=768)
    try:
        assert s.server.app.ctx.alloc.n_pages == 4  # 3 and the trash page
        rng = np.random.default_rng(5)
        prompts = [[int(t) for t in rng.integers(3, 512, 200)] for _ in range(2)]
        replies = [None] * 2

        def ask(i):
            replies[i] = s.request("/completion", {
                "prompt": prompts[i], "n_predict": 64, "temperature": 0, "ignore_eos": True,
                "cache_prompt": False})

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        outs = [json.loads(raw) for _, raw in replies]
        counts = sorted(o["usage"]["completion_tokens"] for o in outs)
        assert [o["choices"][0]["finish_reason"] for o in outs] == ["length", "length"]
        assert counts[0] < 64 == counts[1]
    finally:
        s.close()


REFUSED_ROUTES = {
    "image_chat": ("/v1/chat/completions", {"messages": [{"role": "user", "content": [
        {"type": "text", "text": "what is it"},
        {"type": "image_url", "image_url": {"url": "data:image/png;base64,AAAA"}}]}]},
        "multimodal/mtmd.py"),
}


@pytest.mark.parametrize("route", list(REFUSED_ROUTES))
def test_unported_route_answers_501_and_names_its_module(port_server, route):
    path, body, module = REFUSED_ROUTES[route]
    status, raw = port_server.request(path, body)
    assert status == 501
    err = json.loads(raw)["error"]
    assert module in err and "not ported" in err


def test_routes_of_the_front_end(port_server):
    assert port_server.request("/health") == (200, b'{"status": "ok"}')
    props = json.loads(port_server.request("/props")[1])
    assert props["n_slots"] == CTX["n_seqs"] and props["memory_breakdown"]["total_bytes"] > 0
    slots = json.loads(port_server.request("/slots")[1])
    assert [s["state"] for s in slots] == ["IDLE"] * CTX["n_seqs"]
    assert json.loads(port_server.request("/v1/models")[1])["data"][0]["id"]
    status, html = port_server.request("/")
    assert status == 200 and b"<html" in html.lower()
    assert port_server.request("/nowhere")[0] == 404
    assert port_server.request("/completion", "not an object")[0] == 400


REFUSED_FLAGS = [["--mmproj", "mm.gguf"], ["--tp", "2"], ["--dp", "2"], ["--pp", "2"], ["--ep"],
                 ["--coordinator", "h:1"], ["-m", "b.gguf"]]


@pytest.mark.parametrize("flag", REFUSED_FLAGS, ids=[f[0] for f in REFUSED_FLAGS])
def test_unported_flag_exits_with_2_and_names_itself(capsys, flag):
    rc = server_app.main(["-m", "a.gguf", "--device", "cpu", *flag])
    err = capsys.readouterr().err
    assert rc == 2 and "not ported" in err
    assert (flag[0] in err) if flag[0] != "-m" else ("second -m" in err and "router" in err)


def test_one_step_calls_equal_the_eager_ubatch_step(model):
    """decode_step_multi and decode_step_greedy (one step of the batch
    bucket's decode loop, padding rows at PAD_POS) against Context.decode of
    the same tokens (the eager ubatch step, padding rows at -1), as slots
    join and leave: B = 3, 1, 4, 2, 3 over buckets of 4, 1, 4, 2, 4."""
    rng = np.random.default_rng(2)
    loop_ctx, ref_ctx = (Context(model, device="cpu", **CTX) for _ in range(2))
    for s in range(4):
        p = [int(t) for t in rng.integers(3, 512, 20 + 9 * s)]
        np.testing.assert_array_equal(loop_ctx.prefill(p, seq=s), ref_ctx.prefill(p, seq=s))
    for step, seqs in enumerate(([0, 2, 3], [1], [3, 1, 0, 2], [2, 0], [1, 3, 2])):
        seqs = np.asarray(seqs)
        toks = rng.integers(3, 512, len(seqs))
        pos = ref_ctx.seq_len[seqs]
        ref = ref_ctx.decode(toks[:, None], seqs, pos[:, None], np.arange(len(seqs)))
        ref_ctx.seq_len[seqs] += 1
        if step % 2 == 0:
            got = loop_ctx.decode_step_multi(toks, seqs)
            np.testing.assert_array_equal(got, ref)
        else:
            got = loop_ctx.decode_step_greedy(toks, seqs)
            np.testing.assert_array_equal(got, np.argmax(ref, axis=-1))
        np.testing.assert_array_equal(loop_ctx.seq_len, ref_ctx.seq_len)
    assert {k for k in loop_ctx._loops} == {(4, None), (1, loop_ctx.decode_loop(1).sampler),
                                            (2, loop_ctx.decode_loop(2).sampler)}
    assert all(loop.graph is None for loop in loop_ctx._loops.values())  # the CPU is eager


def test_a_full_pool_raises_before_the_step(model):
    """KVCacheFull comes from the page allocator before the step runs: the
    lengths and the memory stay as they were."""
    from llama_cpp_tpu_torch.runtime.paged_kv import KVCacheFull

    ctx = Context(model, device="cpu", n_ctx=512, n_seqs=2, n_ubatch=64, quantized_kv=True,
                  kv_total=512)
    for s in range(2):
        ctx.prefill([5] * 256, seq=s)  # each sequence's first page full
    before = ctx.seq_len.copy()
    pos = ctx.kv.pos.clone()
    with pytest.raises(KVCacheFull):
        ctx.decode_step_multi(np.asarray([7, 8]), np.arange(2))
    np.testing.assert_array_equal(ctx.seq_len, before)
    assert torch.equal(ctx.kv.pos, pos)
