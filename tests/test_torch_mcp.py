"""The port's MCP client manager (server/mcp.py, standard library only)
and the /tools routes of its llama-server: a real MCP server child process
speaking JSON-RPC over stdio NDJSON (initialize, tools/list, tools/call);
the client's lifecycle, the manager's normalization and errors, a command
that fails to start skipped; /tools and /tools/call served by run_server
with --mcp, each answered as the JAX app answers (tests/test_mcp.py), and
/tools of a server without MCP servers empty, /tools/call refused."""

import json
import sys
import textwrap
import threading
import urllib.error
import urllib.request

import pytest
import torch

from llama_cpp_tpu_torch.models.loader import load_model
from llama_cpp_tpu_torch.server import app as server_app
from llama_cpp_tpu_torch.server.mcp import McpClient, McpError, McpManager
from llama_cpp_tpu_torch.testing import make_bench_llama_gguf

MCP_SERVER = textwrap.dedent(
    """
    import json, sys
    for line in sys.stdin:
        msg = json.loads(line)
        m, mid = msg.get("method"), msg.get("id")
        if m == "initialize":
            out = {"jsonrpc": "2.0", "id": mid, "result": {
                "protocolVersion": "2024-11-05",
                "serverInfo": {"name": "echo-mcp", "version": "0.1"},
                "capabilities": {"tools": {}}}}
        elif m == "notifications/initialized":
            continue
        elif m == "tools/list":
            out = {"jsonrpc": "2.0", "id": mid, "result": {"tools": [
                {"name": "echo", "description": "echo text back",
                 "inputSchema": {"type": "object",
                                 "properties": {"text": {"type": "string"}}}},
                {"name": "fail", "description": "always errors",
                 "inputSchema": {"type": "object"}}]}}
        elif m == "tools/call":
            p = msg["params"]
            if p["name"] == "echo":
                out = {"jsonrpc": "2.0", "id": mid, "result": {
                    "content": [{"type": "text", "text": "echo: " + p["arguments"]["text"]}]}}
            else:
                out = {"jsonrpc": "2.0", "id": mid, "result": {
                    "content": [{"type": "text", "text": "boom"}], "isError": True}}
        else:
            out = {"jsonrpc": "2.0", "id": mid,
                   "error": {"code": -32601, "message": "no method " + str(m)}}
        sys.stdout.write(json.dumps(out) + "\\n")
        sys.stdout.flush()
    """
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mcp_cmd(tmp_path_factory):
    srv = tmp_path_factory.mktemp("torch_mcp") / "mcp_srv.py"
    srv.write_text(MCP_SERVER)
    return f"{sys.executable} {srv}"


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    path = make_bench_llama_gguf(str(tmp_path_factory.mktemp("torch_mcp_m") / "m.gguf"),
                                 n_layers=1, n_embd=256, n_heads=4, n_kv_heads=2, n_ff=512,
                                 vocab_size=512)
    return load_model(path, device="cpu")


def test_client_lifecycle(mcp_cmd):
    cl = McpClient(mcp_cmd, timeout=10)
    cl.start()
    proc = cl.proc
    try:
        assert cl.server_info.get("name") == "echo-mcp"
        assert [t["name"] for t in cl.tools] == ["echo", "fail"]
        assert cl.call("echo", {"text": "hi"})["content"][0]["text"] == "echo: hi"
    finally:
        cl.shutdown()
    assert proc.poll() is not None  # the child is gone


def test_manager_normalization(mcp_cmd):
    mgr = McpManager()
    mgr.start([mcp_cmd], timeout=10)
    try:
        assert not mgr.empty
        defs = mgr.definitions()
        assert {d["name"] for d in defs} == {"echo", "fail"}
        assert all(d["type"] == "mcp" for d in defs)
        assert mgr.call("echo", {"text": "x"}) == {"output": "echo: x", "is_error": False}
        assert mgr.call("fail", {})["is_error"] is True
        with pytest.raises(McpError):
            mgr.call("nope", {})
    finally:
        mgr.shutdown()


def test_manager_skips_a_bad_command():
    mgr = McpManager()
    mgr.start([f"{sys.executable} -c 'import sys; sys.exit(1)'"], timeout=3)
    assert mgr.empty
    mgr.shutdown()


def serve(model, **kw):
    box, ready = {}, threading.Event()
    th = threading.Thread(target=server_app.run_server, args=(model,), daemon=True, kwargs=dict(
        host="127.0.0.1", port=0, n_seqs=1, n_ctx=64, n_ubatch=16, device="cpu",
        ready=lambda s: (box.setdefault("s", s), ready.set()), **kw))
    th.start()
    assert ready.wait(60)
    return box["s"], th


def request(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=data), timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("with_mcp", [True, False], ids=["mcp", "none"])
def test_tools_routes_of_the_server(model, mcp_cmd, with_mcp):
    srv, th = serve(model, mcp=[mcp_cmd] if with_mcp else None)
    url = f"http://127.0.0.1:{srv.port}"
    procs = [c.proc for c in srv.app.mcp.clients] if with_mcp else []
    try:
        status, body = request(url + "/tools")
        names = {t["name"] for t in body["tools"]}
        assert status == 200 and names == ({"echo", "fail"} if with_mcp else set())
        status, body = request(url + "/tools/call", {"name": "echo", "arguments": {"text": "y"}})
        if with_mcp:
            assert status == 200 and body == {"output": "echo: y", "is_error": False}
            assert request(url + "/tools/call", {"name": "zzz"})[0] == 400
        else:
            assert status == 400 and body["error"] == "no tools configured"
    finally:
        srv.shutdown()
        th.join(timeout=30)
    assert not th.is_alive()
    # closing the server stops its MCP children
    assert len(procs) == with_mcp and all(p.wait(10) is not None for p in procs)
