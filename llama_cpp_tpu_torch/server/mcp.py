"""MCP (Model Context Protocol) client manager.

Analog of the reference's tools/server/server-mcp.cpp: the serving layer
spawns MCP servers as child processes and speaks JSON-RPC over stdio NDJSON
(initialize → notifications/initialized → tools/list → tools/call), exposing
their tools to clients/webui through the /tools endpoints (server-tools.cpp).

Host-side only; resilient to slow/unresponsive children via timeouts and a
non-blocking reader thread (the reference polls for the same reason:
server-mcp.cpp mcp_pump_ndjson). A copy of the JAX package's
server/mcp.py (standard library only), so the port imports nothing of it.
"""

from __future__ import annotations

import json
import logging
import shlex
import subprocess
import threading
from typing import Any

log = logging.getLogger(__name__)

MAX_LINE = 8 * 1024 * 1024  # drop oversized NDJSON lines (reference cap)


class McpError(RuntimeError):
    pass


class McpClient:
    """One MCP server child process, JSON-RPC 2.0 over stdio."""

    def __init__(self, command: str, timeout: float = 30.0):
        self.command = command
        self.timeout = timeout
        self.proc: subprocess.Popen | None = None
        self.tools: list[dict] = []
        self.server_info: dict = {}
        self._next_id = 1
        self._lock = threading.Lock()
        self._pending: dict[int, threading.Event] = {}
        self._results: dict[int, Any] = {}
        self._reader: threading.Thread | None = None
        self._running = False

    # -- transport ---------------------------------------------------------
    def _pump(self):
        assert self.proc is not None and self.proc.stdout is not None
        for raw in self.proc.stdout:
            if not self._running:
                break
            if len(raw) > MAX_LINE:
                continue
            line = raw.strip()
            if not line:
                continue
            try:
                msg = json.loads(line)
            except json.JSONDecodeError:
                continue
            mid = msg.get("id")
            if mid is None:
                continue  # notification from server; ignored
            with self._lock:
                ev = self._pending.pop(mid, None)
                if ev is not None:
                    self._results[mid] = msg
                    ev.set()

    def _send(self, msg: dict):
        assert self.proc is not None and self.proc.stdin is not None
        self.proc.stdin.write(json.dumps(msg) + "\n")
        self.proc.stdin.flush()

    def _request(self, method: str, params: dict | None = None) -> dict:
        with self._lock:
            mid = self._next_id
            self._next_id += 1
            ev = threading.Event()
            self._pending[mid] = ev
        req = {"jsonrpc": "2.0", "id": mid, "method": method}
        if params is not None:
            req["params"] = params
        self._send(req)
        if not ev.wait(self.timeout):
            with self._lock:
                self._pending.pop(mid, None)
            raise McpError(f"mcp request timed out: {method}")
        with self._lock:
            resp = self._results.pop(mid)
        if "error" in resp:
            err = resp["error"]
            raise McpError(f"{method}: {err.get('message', err)}")
        return resp.get("result", {})

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        self.proc = subprocess.Popen(
            shlex.split(self.command),
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL,
            text=True,
            bufsize=1,
        )
        self._running = True
        self._reader = threading.Thread(target=self._pump, daemon=True)
        self._reader.start()
        result = self._request(
            "initialize",
            {
                "protocolVersion": "2024-11-05",
                "capabilities": {},
                "clientInfo": {"name": "llama_cpp_tpu-server",
                               "version": "1.0"},
            },
        )
        self.server_info = result.get("serverInfo", {})
        self._send({"jsonrpc": "2.0", "method": "notifications/initialized"})
        self.tools = self._request("tools/list").get("tools", [])

    def call(self, name: str, arguments: dict) -> dict:
        return self._request("tools/call",
                             {"name": name, "arguments": arguments})

    def shutdown(self):
        self._running = False
        if self.proc is not None:
            try:
                self.proc.terminate()
                self.proc.wait(timeout=3)
            except Exception:
                try:
                    self.proc.kill()
                except Exception:
                    pass
            self.proc = None


def _normalize_result(result: dict) -> dict:
    """MCP tools/call result → flat /tools contract (reference
    server-mcp.cpp:194 normalization): concatenate text content parts."""
    parts = []
    for c in result.get("content", []):
        if c.get("type") == "text":
            parts.append(c.get("text", ""))
        else:
            parts.append(json.dumps(c))
    return {
        "output": "\n".join(parts),
        "is_error": bool(result.get("isError", False)),
    }


class McpManager:
    """Aggregates tools from N MCP child servers; names are prefixed with
    the server index on collision."""

    def __init__(self):
        self.clients: list[McpClient] = []
        self._by_name: dict[str, tuple[McpClient, str]] = {}

    def start(self, commands: list[str], timeout: float = 30.0):
        for cmd in commands:
            cl = McpClient(cmd, timeout=timeout)
            try:
                cl.start()
            except Exception as e:  # child failed; skip, keep serving
                log.warning("mcp server %r failed to start: %s", cmd, e)
                cl.shutdown()
                continue
            self.clients.append(cl)
            for t in cl.tools:
                name = t.get("name", "")
                key = name
                if key in self._by_name:
                    key = f"mcp{len(self.clients) - 1}_{name}"
                self._by_name[key] = (cl, name)

    @property
    def empty(self) -> bool:
        return not self._by_name

    def definitions(self) -> list[dict]:
        out = []
        for key, (cl, name) in self._by_name.items():
            for t in cl.tools:
                if t.get("name") == name:
                    d = dict(t)
                    d["name"] = key
                    d["type"] = "mcp"
                    out.append(d)
                    break
        return out

    def call(self, name: str, arguments: dict) -> dict:
        if name not in self._by_name:
            raise McpError(f"unknown tool: {name}")
        cl, real = self._by_name[name]
        return _normalize_result(cl.call(real, arguments))

    def shutdown(self):
        for cl in self.clients:
            cl.shutdown()
        self.clients.clear()
        self._by_name.clear()
