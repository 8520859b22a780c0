"""HTTP server: OpenAI + Anthropic compatible API over the continuous-batching
scheduler (llama-server analog; counterpart of the JAX package's
server/app.py, with the same handlers and the same JSON).

    python -m llama_cpp_tpu_torch.server.app -m m.gguf -np 4 --kv-quant

The front end is the standard library's `http.server.ThreadingHTTPServer`:
one thread a connection parses the request, posts a GenTask to the
scheduler and waits on a queue for its deltas and result. Only the
scheduler thread touches the card (runtime state reached from a handler,
such as /props' memory breakdown, goes through `Scheduler.run_sync`), so a
CUDA graph captured on that thread sees no other thread's CUDA calls.
Runs on the card unless --device cpu is given.

Requests take the JAX app's fields, and two of the reference server's
that it ignores: `ignore_eos` and, on /completion, `return_tokens` (the
generated ids in "tokens").

Routes: /, /health, /props, /metrics, /v1/models, GET /slots, POST
/slots/{id}?action=save|restore|erase (a slot's KV as a state file in the
slot directory, runtime/state.py), /tokenize, /detokenize, /completion,
/v1/completions, /v1/chat/completions (stream and not, tools),
/v1/messages, /v1/responses, /infill, /v1/embeddings (L2-normalised
Context.embed vectors of one input or a list), /v1/rerank and /rerank (the
documents by the cosine of their embedding with the query's, as the JAX
app scores them, not by the file's rank head), and /tools and /tools/call
(the tools of the MCP servers given with --mcp, server/mcp.py). With -md (a
draft model of the same vocab) or --spec ngram each slot decodes
speculatively, --draft-max tokens a verify step (server/scheduler.py).
Refused with 501 and the module they need: chat messages with image or
audio parts (multimodal/mtmd.py); refused with exit code 2: --mmproj, the
eagle3 and dflash drafts, a second -m and parallel or multi-host serving.
A gemma4-assistant draft drafts over each slot's own target sequence
(models/gemma3n.Gemma4AssistantSpeculator).
"""

from __future__ import annotations

import json
import logging
import os
import queue
import sys
import tempfile
import time
import uuid
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Iterator
from urllib.parse import parse_qs, urlsplit

import numpy as np

from ..sampling.samplers import SamplingParams
from .chat import apply_chat_template
from .chat_parser import StreamingChatParser, detect_format
from .scheduler import GenTask, Scheduler

log = logging.getLogger("server")

MEDIA_REFUSED = "image and audio chat parts (multimodal/mtmd.py, --mmproj)"


def _sampling_from_request(body: dict[str, Any],
                           model_md: dict | None = None) -> SamplingParams:
    p = SamplingParams()
    if model_md:
        # model-embedded defaults (general.sampling.*, llama-arch.cpp:157)
        # seed per-request knobs; explicit request fields still win below
        p = p.apply_gguf_defaults(model_md)
    p.temp = float(body.get("temperature", p.temp))
    p.top_p = float(body.get("top_p", p.top_p))
    p.top_k = int(body.get("top_k", p.top_k))
    p.min_p = float(body.get("min_p", p.min_p))
    p.typical_p = float(body.get("typical_p", p.typical_p))
    p.penalty_repeat = float(body.get("repeat_penalty", p.penalty_repeat))
    p.penalty_freq = float(body.get("frequency_penalty", 0.0))
    p.penalty_present = float(body.get("presence_penalty", 0.0))
    p.penalty_last_n = int(body.get("repeat_last_n", p.penalty_last_n))
    p.dry_multiplier = float(body.get("dry_multiplier", 0.0))
    p.xtc_probability = float(body.get("xtc_probability", 0.0))
    p.mirostat = int(body.get("mirostat", 0))
    p.mirostat_tau = float(body.get("mirostat_tau", p.mirostat_tau))
    p.mirostat_eta = float(body.get("mirostat_eta", p.mirostat_eta))
    p.adaptive_target = float(body.get("adaptive_target", p.adaptive_target))
    p.adaptive_decay = float(body.get("adaptive_decay", p.adaptive_decay))
    if "seed" in body and body["seed"] is not None:
        p.seed = int(body["seed"]) & 0xFFFFFFFF
    if body.get("reasoning_budget") is not None:
        p.reasoning_budget = int(body["reasoning_budget"])
    if body.get("thinking_budget") is not None:  # alias
        p.reasoning_budget = int(body["thinking_budget"])
    if body.get("logit_bias"):
        p.logit_bias = {int(k): float(v) for k, v in body["logit_bias"].items()}
    return p


@dataclass
class Response:
    """A handler's answer: a body of bytes, or with `stream` SSE events
    written as they come (chunked transfer encoding)."""

    status: int = 200
    body: bytes = b""
    content_type: str = "application/json"
    stream: Iterator[bytes] | None = None


def json_response(obj, status: int = 200) -> Response:
    return Response(status, json.dumps(obj).encode())


def _not_ported(what: str) -> Response:
    return json_response({"error": f"{what} is not ported yet to the PyTorch/CUDA package"},
                         status=501)


def _sse(obj) -> bytes:
    return f"data: {json.dumps(obj)}\n\n".encode()


class _Pending:
    """A submitted task's deltas and result, in the order the scheduler
    thread produced them."""

    def __init__(self, sched: Scheduler, task: GenTask, stream: bool):
        self.task = task
        self.events: queue.Queue = queue.Queue()
        task.done_cb = lambda result: self.events.put(("done", result))
        if stream:
            task.stream_cb = lambda d: self.events.put(("delta", d))
        sched.submit(task)

    def __iter__(self):
        """Yields ("delta", d) until ("done", result), which it yields last."""
        while True:
            kind, item = self.events.get()
            yield kind, item
            if kind == "done":
                return

    def result(self) -> dict:
        for kind, item in self:
            if kind == "done":
                return item
        raise RuntimeError("the scheduler ended the task without a result")


class ServerApp:
    def __init__(self, scheduler: Scheduler, model_name: str = "model",
                 slot_save_dir: str | None = None):
        self.sched = scheduler
        self.model_name = model_name
        self.ctx = scheduler.ctx
        self.tok = scheduler.ctx.model.tokenizer
        self.t_start = time.time()
        self.slot_save_dir = slot_save_dir or tempfile.gettempdir()
        self.mcp = None  # McpManager, set by run_server when --mcp is given
        self.routes: dict[tuple[str, str], Callable[[dict], Response]] = {
            ("GET", "/"): self.webui,
            ("GET", "/index.html"): self.webui,
            ("GET", "/health"): self.health,
            ("GET", "/props"): self.props,
            ("GET", "/metrics"): self.metrics,
            ("GET", "/v1/models"): self.models,
            ("GET", "/slots"): self.slots,
            ("GET", "/tools"): self.tools_list,
            ("POST", "/tools/call"): self.tools_call,
            ("POST", "/tokenize"): self.tokenize,
            ("POST", "/detokenize"): self.detokenize,
            ("POST", "/completion"): self.completions,
            ("POST", "/v1/completions"): self.completions,
            ("POST", "/v1/chat/completions"): self.chat_completions,
            ("POST", "/v1/messages"): self.anthropic_messages,
            ("POST", "/v1/responses"): self.responses,
            ("POST", "/infill"): self.infill,
            ("POST", "/v1/embeddings"): self.embeddings,
            ("POST", "/v1/rerank"): self.rerank,
            ("POST", "/rerank"): self.rerank,
        }

    def handle(self, method: str, path: str, body: dict,
               query: dict[str, str] | None = None) -> Response:
        route = self.routes.get((method, path))
        if route is not None:
            return route(body)
        if method == "POST" and path.startswith("/slots/"):
            return self.slot_action(path[len("/slots/"):], (query or {}).get("action", ""),
                                    body)
        return json_response({"error": f"no route {method} {path}"}, status=404)

    # -- helpers ---------------------------------------------------------
    def _text_messages(self, messages: list) -> list | None:
        """OpenAI/Anthropic content arrays -> messages of text; None when a
        part carries an image or audio (multimodal input is not ported)."""
        out = []
        for m in messages:
            c = m.get("content")
            if not isinstance(c, list):
                out.append(m)
                continue
            parts = []
            for part in c:
                t = part.get("type")
                if t in ("text", "input_text"):
                    parts.append(part.get("text", ""))
                elif t in ("image_url", "input_image", "image", "input_audio"):
                    return None
            out.append({**m, "content": "".join(parts)})
        return out

    def _prompt_from_chat(self, body: dict) -> str:
        template = body.get("chat_template") or (
            self.tok.vocab.chat_template if self.tok else None
        )
        bos = self.tok.piece(self.tok.bos_id) if self.tok and self.tok.bos_id >= 0 else ""
        eos = self.tok.piece(self.tok.eos_id) if self.tok and self.tok.eos_id >= 0 else ""
        return apply_chat_template(
            body.get("messages", []), template, bos, eos, True, body.get("tools")
        )

    def _make_task(self, body: dict, prompt: str | list[int]) -> GenTask:
        if isinstance(prompt, str):
            ids = self.tok.encode(prompt, add_special=True, parse_special=True)
        else:
            ids = list(prompt)
        max_ctx = self.ctx.n_ctx
        if len(ids) >= max_ctx - 1:
            ids = ids[-(max_ctx - 64) :]
        stop = body.get("stop") or []
        if isinstance(stop, str):
            stop = [stop]
        grammar = body.get("grammar", "")
        if body.get("response_format", {}).get("type") == "json_object" and not grammar:
            from ..sampling.json_schema import JSON_GBNF

            grammar = JSON_GBNF
        if body.get("response_format", {}).get("type") == "json_schema" and not grammar:
            from ..sampling.json_schema import schema_to_gbnf

            schema = body["response_format"].get("json_schema", {}).get("schema", {})
            grammar = schema_to_gbnf(schema)
        return GenTask(
            prompt_ids=ids,
            params=_sampling_from_request(
                body, getattr(self.ctx.model.gguf, "metadata", None)),
            max_tokens=int(
                body.get("max_tokens")
                or body.get("max_completion_tokens")
                or body.get("n_predict")
                or 256
            ),
            stop_strings=list(stop),
            ignore_eos=bool(body.get("ignore_eos", False)),
            grammar=grammar,
            grammar_lazy=bool(body.get("grammar_lazy", False)),
            grammar_trigger_patterns=tuple(
                body.get("grammar_trigger_patterns", ())),
            grammar_trigger_tokens=tuple(
                body.get("grammar_trigger_tokens", ())),
            cache_prompt=bool(body.get("cache_prompt", True)),
        )

    @staticmethod
    def _usage(result: dict) -> dict:
        return {
            "prompt_tokens": result["n_prompt"],
            "completion_tokens": result["n_generated"],
            "total_tokens": result["n_prompt"] + result["n_generated"],
        }

    # -- endpoints -------------------------------------------------------
    def webui(self, body):
        from .webui import WEBUI_HTML

        return Response(body=WEBUI_HTML.encode(), content_type="text/html")

    def health(self, body):
        return json_response({"status": "ok"})

    def props(self, body):
        cfg = self.ctx.cfg
        return json_response(
            {
                "model": self.model_name,
                "n_ctx": self.ctx.n_ctx,
                "n_slots": self.sched.n_slots,
                "arch": cfg.arch,
                "n_params_layers": cfg.n_layers,
                "vocab_size": cfg.vocab_size,
                "chat_template": (self.tok.vocab.chat_template if self.tok else None)
                or "",
                # reference memory-breakdown reporting (llama-context.cpp:3235)
                "memory_breakdown": self.sched.run_sync(self.ctx.memory_breakdown),
            }
        )

    def metrics(self, body):
        m = self.sched.metrics
        lines = [
            "# TYPE llamacpp_tpu_requests_total counter",
            f"llamacpp_tpu_requests_total {m['requests_total']}",
            "# TYPE llamacpp_tpu_tokens_predicted_total counter",
            f"llamacpp_tpu_tokens_predicted_total {m['tokens_predicted_total']}",
            "# TYPE llamacpp_tpu_tokens_prompt_total counter",
            f"llamacpp_tpu_tokens_prompt_total {m['tokens_prompt_total']}",
            "# TYPE llamacpp_tpu_busy_slots gauge",
            f"llamacpp_tpu_busy_slots {m['busy_slots']}",
            "# TYPE llamacpp_tpu_uptime_seconds gauge",
            f"llamacpp_tpu_uptime_seconds {time.time() - self.t_start:.1f}",
        ]
        return Response(body=("\n".join(lines) + "\n").encode(), content_type="text/plain")

    def models(self, body):
        return json_response(
            {
                "object": "list",
                "data": [
                    {
                        "id": self.model_name,
                        "object": "model",
                        "created": int(self.t_start),
                        "owned_by": "llama_cpp_tpu",
                    }
                ],
            }
        )

    def slots(self, body):
        def snapshot():
            return [{"id": s.idx, "state": s.state.name, "n_generated": len(s.generated),
                     "task_id": s.task.task_id if s.task else None}
                    for s in self.sched.slots]

        return json_response(self.sched.run_sync(snapshot))

    def slot_action(self, sid: str, action: str, body: dict) -> Response:
        """POST /slots/{id}?action=save|restore|erase: a slot's KV as a
        per-sequence state file in the slot directory (reference
        tools/server slot save/restore), on the scheduler thread."""
        from ..runtime.state import load_seq_state, save_seq_state

        try:
            slot = int(sid)
        except ValueError:
            slot = -1
        if not 0 <= slot < self.sched.n_slots:
            return json_response({"error": "invalid slot id"}, status=400)
        fname = os.path.basename(str(body.get("filename", f"slot{slot}.bin")))
        path = os.path.join(self.slot_save_dir, fname)
        if action == "save":
            blob = self.sched.run_sync(lambda: save_seq_state(self.ctx, slot))
            with open(path, "wb") as f:
                f.write(blob)
            return json_response({"id_slot": slot, "filename": fname, "n_written": len(blob)})
        if action == "restore":
            if not os.path.exists(path):
                return json_response({"error": "file not found"}, status=404)
            with open(path, "rb") as f:
                blob = f.read()
            n = self.sched.run_sync(lambda: load_seq_state(self.ctx, slot, blob))
            return json_response({"id_slot": slot, "filename": fname, "n_restored": n})
        if action == "erase":
            self.sched.run_sync(lambda: self.ctx.seq_rm(slot))
            return json_response({"id_slot": slot, "erased": True})
        return json_response({"error": "unknown action"}, status=400)

    def tools_list(self, body):
        return json_response({"tools": self.mcp.definitions() if self.mcp is not None else []})

    def tools_call(self, body):
        if self.mcp is None:
            return json_response({"error": "no tools configured"}, status=400)
        try:
            result = self.mcp.call(body.get("name", ""), body.get("arguments", {}))
        except Exception as e:
            return json_response({"error": str(e)}, status=400)
        return json_response(result)

    def tokenize(self, body):
        ids = self.tok.encode(
            body.get("content", ""),
            add_special=bool(body.get("add_special", False)),
            parse_special=bool(body.get("with_pieces", True)),
        )
        return json_response({"tokens": ids})

    def detokenize(self, body):
        return json_response({"content": self.tok.decode(body.get("tokens", []))})

    def _unit_embedding(self, text: str) -> np.ndarray:
        """Context.embed of a text's ids (cut to n_ctx - 1), on the scheduler
        thread, L2-normalised (the JAX app's +1e-12)."""
        ids = self.tok.encode(text, add_special=True)[: self.ctx.n_ctx - 1]
        vec = self.sched.run_sync(lambda: self.ctx.embed(ids))
        return vec / (np.linalg.norm(vec) + 1e-12)

    def embeddings(self, body):
        inputs = body.get("input", "")
        if isinstance(inputs, str):
            inputs = [inputs]
        data = [{"object": "embedding", "index": i,
                 "embedding": [float(x) for x in self._unit_embedding(text)]}
                for i, text in enumerate(inputs)]
        return json_response({"object": "list", "data": data, "model": self.model_name,
                              "usage": {"prompt_tokens": 0, "total_tokens": 0}})

    def rerank(self, body):
        """Query-document relevance (reference /v1/rerank): the cosine of the
        normalised embeddings, highest first, then the first top_n."""
        docs = body.get("documents", [])
        top_n = int(body.get("top_n", len(docs)))
        qv = self._unit_embedding(body.get("query", ""))
        results = [{"index": i, "relevance_score": float(qv @ self._unit_embedding(d))}
                   for i, d in enumerate(docs)]
        results.sort(key=lambda r: -r["relevance_score"])
        return json_response({"model": self.model_name, "object": "list",
                              "results": results[:top_n],
                              "usage": {"prompt_tokens": 0, "total_tokens": 0}})

    def completions(self, body):
        prompt = body.get("prompt", "")
        task = self._make_task(body, prompt)
        rid = f"cmpl-{uuid.uuid4().hex[:20]}"
        if body.get("stream"):
            return self._stream_openai(task, rid, chat=False)
        result = _Pending(self.sched, task, stream=False).result()
        out = {
            "id": rid,
            "object": "text_completion",
            "created": int(time.time()),
            "model": self.model_name,
            "choices": [
                {
                    "text": result["text"],
                    "index": 0,
                    "logprobs": None,
                    "finish_reason": result["finish_reason"],
                }
            ],
            "usage": self._usage(result),
        }
        if body.get("return_tokens"):  # the reference server's field: the ids generated
            out["tokens"] = result["tokens"]
        return json_response(out)

    def _chat_parse_format(self, body: dict) -> str:
        """Stream-parse format for this request: tool-call grammar sniffed
        from the chat template when tools are declared, else content+think."""
        if not body.get("tools"):
            return "generic"
        template = body.get("chat_template") or (
            self.tok.vocab.chat_template if self.tok else None
        )
        return detect_format(template)

    def chat_completions(self, body):
        messages = self._text_messages(body.get("messages", []))
        if messages is None:
            return _not_ported(MEDIA_REFUSED)
        body = {**body, "messages": messages}
        prompt = self._prompt_from_chat(body)
        task = self._make_task(body, prompt)
        rid = f"chatcmpl-{uuid.uuid4().hex[:20]}"
        fmt = self._chat_parse_format(body)
        if body.get("stream"):
            return self._stream_openai(task, rid, chat=True, fmt=fmt)
        result = _Pending(self.sched, task, stream=False).result()
        finish = result["finish_reason"]
        parser = StreamingChatParser(fmt)
        parser.put(result["text"])
        parser.finish()
        parsed = parser.result
        message = {"role": "assistant", "content": parsed.content or None}
        if parsed.reasoning:
            message["reasoning_content"] = parsed.reasoning
        calls = [
            {"id": t.id, "type": "function",
             "function": {"name": t.name, "arguments": t.arguments}}
            for t in parsed.tool_calls
        ]
        if not calls and body.get("tools"):
            from .tool_calls import parse_tool_calls

            content, calls = parse_tool_calls(result["text"])
            if calls:
                message["content"] = content or None
        if calls:
            message["tool_calls"] = calls
            finish = "tool_calls"
        if message["content"] is None and not calls and not parsed.reasoning:
            message["content"] = result["text"]
        return json_response(
            {
                "id": rid,
                "object": "chat.completion",
                "created": int(time.time()),
                "model": self.model_name,
                "choices": [
                    {
                        "index": 0,
                        "message": message,
                        "finish_reason": finish,
                    }
                ],
                "usage": self._usage(result),
            }
        )

    def responses(self, body):
        """OpenAI Responses API (reference tools/server routes
        post_responses_oai): `input` is a string or message list; the reply
        wraps the text in a message output item."""
        inp = body.get("input", "")
        messages = []
        if body.get("instructions"):
            messages.append({"role": "system",
                             "content": body["instructions"]})
        if isinstance(inp, str):
            messages.append({"role": "user", "content": inp})
        else:
            for m in inp:
                content = m.get("content")
                if isinstance(content, list):  # typed content parts
                    content = "".join(
                        c.get("text", "") for c in content
                        if c.get("type") in ("input_text", "output_text", "text"))
                messages.append({"role": m.get("role", "user"),
                                 "content": content})
        chat_body = dict(body)
        chat_body["messages"] = messages
        if "max_output_tokens" in body:
            chat_body["max_tokens"] = body["max_output_tokens"]
        prompt = self._prompt_from_chat(chat_body)
        task = self._make_task(chat_body, prompt)
        rid = f"resp_{uuid.uuid4().hex[:20]}"
        result = _Pending(self.sched, task, stream=False).result()
        return json_response({
            "id": rid,
            "object": "response",
            "created_at": int(time.time()),
            "model": self.model_name,
            "status": "completed",
            "output": [{
                "type": "message",
                "id": f"msg_{uuid.uuid4().hex[:16]}",
                "role": "assistant",
                "status": "completed",
                "content": [{"type": "output_text", "text": result["text"],
                             "annotations": []}],
            }],
            "output_text": result["text"],
            "usage": {
                "input_tokens": result["n_prompt"],
                "output_tokens": result["n_generated"],
                "total_tokens": result["n_prompt"] + result["n_generated"],
            },
        })

    def _stream_openai(self, task: GenTask, rid: str, chat: bool,
                       fmt: str = "generic") -> Response:
        pending = _Pending(self.sched, task, stream=True)
        obj_type = "chat.completion.chunk" if chat else "text_completion"
        # streaming-diff parser (reference chat-peg-parser + compute_diffs):
        # re-parses the accumulated text each token and yields structured
        # content / reasoning_content / tool_calls deltas
        parser = StreamingChatParser(fmt) if chat else None

        def chunk_for(choice) -> bytes:
            return _sse({"id": rid, "object": obj_type,
                         "created": int(time.time()),
                         "model": self.model_name, "choices": [choice]})

        def emit(d, final: bool = False) -> Iterator[bytes]:
            if not chat:
                yield chunk_for({"index": 0, "text": d["delta"], "finish_reason": None})
                return
            diffs = parser.finish() if final else parser.put(d["delta"])
            for delta in diffs:
                yield chunk_for({"index": 0, "delta": delta, "finish_reason": None})

        def events() -> Iterator[bytes]:
            result = None
            try:
                if chat:
                    yield chunk_for({"index": 0, "delta": {"role": "assistant"},
                                     "finish_reason": None})
                for kind, item in pending:
                    if kind == "delta":
                        yield from emit(item)
                    else:
                        result = item
            finally:
                if result is None:  # the client left first: stop generating for it
                    task.cancelled = True
            finish = result["finish_reason"]
            if chat:
                yield from emit(None, final=True)
                if parser.result.tool_calls:
                    finish = "tool_calls"
            final_choice = (
                {"index": 0, "delta": {}, "finish_reason": finish}
                if chat
                else {"index": 0, "text": "", "finish_reason": finish}
            )
            yield _sse({
                "id": rid,
                "object": obj_type,
                "created": int(time.time()),
                "model": self.model_name,
                "choices": [final_choice],
                "usage": self._usage(result),
            })
            yield b"data: [DONE]\n\n"

        return Response(content_type="text/event-stream", stream=events())

    # -- Anthropic /v1/messages -----------------------------------------
    def anthropic_messages(self, body):
        messages = list(body.get("messages", []))
        if body.get("system"):
            messages.insert(0, {"role": "system", "content": body["system"]})
        messages = self._text_messages(messages)
        if messages is None:
            return _not_ported(MEDIA_REFUSED)
        template = self.tok.vocab.chat_template if self.tok else None
        prompt = apply_chat_template(messages, template, "", "", True)
        params = {
            "temperature": body.get("temperature", 1.0),
            "top_p": body.get("top_p", 0.95),
            "top_k": body.get("top_k", 40),
            "max_tokens": body.get("max_tokens", 256),
            "stop": body.get("stop_sequences", []),
        }
        task = self._make_task(params, prompt)
        rid = f"msg_{uuid.uuid4().hex[:24]}"
        result = _Pending(self.sched, task, stream=False).result()
        stop_reason = {
            "stop": "end_turn",
            "length": "max_tokens",
            "cancelled": "end_turn",
        }.get(result["finish_reason"], "end_turn")
        return json_response(
            {
                "id": rid,
                "type": "message",
                "role": "assistant",
                "model": self.model_name,
                "content": [{"type": "text", "text": result["text"]}],
                "stop_reason": stop_reason,
                "stop_sequence": None,
                "usage": {
                    "input_tokens": result["n_prompt"],
                    "output_tokens": result["n_generated"],
                },
            }
        )

    def infill(self, body):
        prefix = body.get("input_prefix", "")
        suffix = body.get("input_suffix", "")
        # FIM token layout depends on model; use common llama-style markers
        prompt = f"<|fim_prefix|>{prefix}<|fim_suffix|>{suffix}<|fim_middle|>"
        task = self._make_task(body, prompt)
        result = _Pending(self.sched, task, stream=False).result()
        return json_response(
            {"content": result["text"], "stop": result["finish_reason"] == "stop"}
        )


class _Handler(BaseHTTPRequestHandler):
    """One connection's requests: the body parsed as JSON, the app's
    Response written with a length, or chunk by chunk for a stream."""

    protocol_version = "HTTP/1.1"
    server: "LlamaServer"

    def do_GET(self):
        self._serve("GET")

    def do_POST(self):
        self._serve("POST")

    def _serve(self, method: str) -> None:
        url = urlsplit(self.path)
        path = url.path
        query = {k: v[-1] for k, v in parse_qs(url.query).items()}
        n = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(n) if n else b""
        try:
            body = json.loads(raw) if raw.strip() else {}
        except json.JSONDecodeError as e:
            return self._write(json_response({"error": f"invalid JSON: {e}"}, status=400))
        if not isinstance(body, dict):
            return self._write(json_response({"error": "the body is not a JSON object"},
                                             status=400))
        try:
            resp = self.server.app.handle(method, path, body, query)
        except Exception as e:  # a handler's fault answers 500; the server keeps serving
            log.exception("%s %s failed", method, path)
            resp = json_response({"error": f"{type(e).__name__}: {e}"}, status=500)
        self._write(resp)

    def _write(self, resp: Response) -> None:
        self.send_response(resp.status)
        self.send_header("Content-Type", resp.content_type)
        if resp.stream is None:
            self.send_header("Content-Length", str(len(resp.body)))
            self.end_headers()
            self.wfile.write(resp.body)
            return
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        try:
            for chunk in resp.stream:
                self.wfile.write(b"%x\r\n%s\r\n" % (len(chunk), chunk))
                self.wfile.flush()
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            resp.stream.close()  # cancels the task
            self.close_connection = True

    def log_message(self, fmt, *args):
        log.debug("%s " + fmt, self.address_string(), *args)


class LlamaServer(ThreadingHTTPServer):
    """The HTTP server over one ServerApp: bound at construction, serving
    from serve_forever(); close() stops the scheduler too."""

    daemon_threads = True

    def __init__(self, app: ServerApp, host: str, port: int):
        self.app = app
        super().__init__((host, port), _Handler)

    @property
    def port(self) -> int:
        return self.server_address[1]

    def close(self) -> None:
        self.server_close()
        self.app.sched.stop()
        if self.app.mcp is not None:
            self.app.mcp.shutdown()


def spec_factory(ctx, draft_model=None, spec: str = ""):
    """The scheduler's per-slot speculator factory (reference per-slot
    drafting, server-context.cpp:3001), or None: with a draft model (a
    loaded Model or a GGUF path) one draft Context of the target's geometry
    holds one draft sequence per slot; with spec "ngram" each slot looks up
    its own history. The draft's Context is made at the first slot's
    launch, on the scheduler thread, the only thread that touches the card."""
    from ..runtime.speculative import DraftModelSpeculator, NgramSpeculator

    if draft_model is not None:
        from ..models.loader import Model, load_model
        from ..runtime.context import Context

        if not isinstance(draft_model, Model):
            draft_model = load_model(draft_model, device=ctx.device)
        if draft_model.cfg.arch == "gemma4-assistant":  # a draft over the target's own KV
            from ..models.gemma3n import Gemma4AssistantSpeculator

            return lambda i: Gemma4AssistantSpeculator(draft_model, ctx, seq=i)
        drafts = {}

        def make(i):
            if "ctx" not in drafts:
                drafts["ctx"] = Context(draft_model, n_ctx=ctx.n_ctx, n_seqs=ctx.n_seqs,
                                        device=ctx.device)
            return DraftModelSpeculator(drafts["ctx"], seq=i)

        return make
    if spec == "ngram":
        return lambda i: NgramSpeculator()
    return None


def run_server(model, host: str = "0.0.0.0", port: int = 8080, n_seqs: int = 4,
               device="cuda", ready: Callable[[LlamaServer], None] | None = None,
               draft_model=None, spec: str = "", n_draft: int = 8,
               mcp: list[str] | None = None, slot_save_dir: str | None = None,
               **ctx_kw) -> None:
    """Serve `model` (a loaded Model, or a GGUF path loaded onto `device`)
    until shutdown(): a Context of n_seqs sequences (ctx_kw: n_ctx,
    n_ubatch, quantized_kv, kv_total, graphs, ...), its scheduler thread and
    the HTTP server. draft_model (a Model or a path) or spec="ngram" turn on
    speculative decoding of n_draft tokens a step; mcp is a list of MCP
    server commands whose tools /tools lists; slot_save_dir holds the
    slots' state files. `ready(server)` is called once the socket is bound
    (port 0 takes a free port: server.port), before serving starts."""
    from ..models.loader import Model, load_model
    from ..runtime.context import Context

    if not isinstance(model, Model):
        model = load_model(model, device=device)
    ctx = Context(model, n_seqs=n_seqs, device=model.device, **ctx_kw)
    sched = Scheduler(ctx, spec_factory=spec_factory(ctx, draft_model, spec), n_draft=n_draft)
    mcp_mgr = None
    if mcp:
        from .mcp import McpManager

        mcp_mgr = McpManager()
        mcp_mgr.start(list(mcp))
    sched.start()
    try:
        app = ServerApp(sched, model_name=model.cfg.name or "model",
                        slot_save_dir=slot_save_dir)
        app.mcp = mcp_mgr
        server = LlamaServer(app, host, port)
    except OSError:
        sched.stop()
        if mcp_mgr is not None:
            mcp_mgr.shutdown()
        raise
    try:
        if ready is not None:
            ready(server)
        server.serve_forever()
    finally:
        server.close()


# flag -> (argparse dest, the module it needs); a value other than the
# default is refused with exit code 2
NOT_PORTED_FLAGS = {
    "--mmproj": ("mmproj", "multimodal input (multimodal/mtmd.py)"),
    "--tp": ("tp", "parallel serving (parallel/)"),
    "--dp": ("dp", "parallel serving (parallel/)"),
    "--pp": ("pp", "parallel serving (parallel/)"),
    "--ep": ("ep", "expert parallelism (parallel/expert.py)"),
    "--coordinator": ("coordinator", "multi-host serving (parallel/distributed.py)"),
    "--num-hosts": ("num_hosts", "multi-host serving (parallel/distributed.py)"),
    "--host-id": ("host_id", "multi-host serving (parallel/distributed.py)"),
}


def build_parser():
    import argparse

    ap = argparse.ArgumentParser(
        "llama-server (CUDA)",
        description="OpenAI- and Anthropic-compatible server over the continuous-batching "
        "scheduler: completions, chat, messages, responses, infill, tokenize, embeddings "
        "(/v1/embeddings) and rerank (/v1/rerank, /rerank); chat parts with images or audio "
        "are refused with 501.")
    ap.add_argument("-m", "--model", action="append", required=True,
                    help="model path, or name=path (one model: the multi-model router "
                    "is not ported)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("-c", "--ctx-size", type=int, default=2048)
    ap.add_argument("-np", "--parallel", type=int, default=4)
    ap.add_argument("--kv-total", type=int, default=0,
                    help="total KV token budget shared by all slots (paged "
                    "pool size; default: parallel * ctx-size)")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8-quantized KV cache (type_k/type_v q8_0 analog)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), or cpu for the plain PyTorch versions")
    ap.add_argument("-md", "--model-draft", default=None,
                    help="draft model for speculative decoding")
    ap.add_argument("--spec", default="", choices=["", "ngram"],
                    help="self-speculation mode (prompt-lookup ngram)")
    ap.add_argument("--draft-max", type=int, default=8, help="max drafted tokens per step")
    ap.add_argument("--mcp", action="append", default=[],
                    help="MCP server command whose tools /tools lists (repeatable)")
    not_ported = ap.add_argument_group("not ported yet (refused with exit code 2)")
    not_ported.add_argument("--mmproj", default=None)
    not_ported.add_argument("--tp", type=int, default=0)
    not_ported.add_argument("--dp", type=int, default=0)
    not_ported.add_argument("--pp", type=int, default=1)
    not_ported.add_argument("--ep", action="store_true")
    not_ported.add_argument("--coordinator", default=None)
    not_ported.add_argument("--num-hosts", type=int, default=None)
    not_ported.add_argument("--host-id", type=int, default=None)
    return ap


def main(argv=None) -> int:
    from ..tools.args import apply_env_and_preset
    from ..utils.logging import add_log_args, apply_log_args

    ap = build_parser()
    add_log_args(ap)
    args = apply_env_and_preset(ap, argv)
    apply_log_args(args)
    for flag, (dest, module) in NOT_PORTED_FLAGS.items():
        if getattr(args, dest) != ap.get_default(dest):
            print(f"llama-server: {flag} is not ported yet to the PyTorch/CUDA package "
                  f"({module})", file=sys.stderr)
            return 2
    if len(args.model) > 1:
        print("llama-server: a second -m is not ported yet to the PyTorch/CUDA package "
              "(the multi-model router, server/router.py)", file=sys.stderr)
        return 2
    if args.model_draft:
        from ..runtime.speculative import refused_draft

        arch = refused_draft(args.model_draft)
        if arch:
            print(f"llama-server: -md with a draft of arch {arch!r} is not ported yet to the "
                  "PyTorch/CUDA package (its draft model is not ported)",
                  file=sys.stderr)
            return 2
    path = args.model[0].split("=", 1)[-1]
    print(f"loading {path} ...", file=sys.stderr, flush=True)

    def ready(server):
        print(f"llama-server listening on http://{args.host}:{server.port}", file=sys.stderr,
              flush=True)

    run_server(path, host=args.host, port=args.port, ready=ready, n_seqs=args.parallel,
               device=args.device, n_ctx=args.ctx_size, kv_total=args.kv_total or None,
               quantized_kv=args.kv_quant, draft_model=args.model_draft, spec=args.spec,
               n_draft=args.draft_max, mcp=args.mcp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
