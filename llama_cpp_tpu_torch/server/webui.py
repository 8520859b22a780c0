"""Built-in web UI: a single-file chat client served at `/`.

Analog of the reference's tools/ui (Svelte webui bundled into llama-server):
streaming chat over /v1/chat/completions SSE with reasoning display,
generation settings, and a tools panel backed by /tools (MCP). Kept as one
dependency-free HTML document so the server stays a single artifact.
"""

WEBUI_HTML = r"""<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>llama.cpp-tpu</title>
<style>
  :root {
    --bg: #101418; --panel: #1a2026; --border: #2a323a; --text: #e6e9ec;
    --dim: #9aa5ad; --accent: #4f9cf0; --user: #24303c; --think: #7f8c99;
  }
  * { box-sizing: border-box; }
  body { margin: 0; background: var(--bg); color: var(--text);
         font: 15px/1.5 system-ui, sans-serif; display: flex;
         flex-direction: column; height: 100vh; }
  header { padding: 10px 16px; border-bottom: 1px solid var(--border);
           display: flex; gap: 12px; align-items: center; }
  header h1 { font-size: 15px; margin: 0; font-weight: 600; }
  header .model { color: var(--dim); font-size: 13px; }
  header .right { margin-left: auto; display: flex; gap: 8px; }
  #chat { flex: 1; overflow-y: auto; padding: 16px; }
  .msg { max-width: 820px; margin: 0 auto 14px; padding: 10px 14px;
         border-radius: 10px; white-space: pre-wrap; word-break: break-word; }
  .msg.user { background: var(--user); margin-left: 15%; }
  .msg.assistant { background: var(--panel); margin-right: 15%; }
  .msg .role { font-size: 11px; color: var(--dim); margin-bottom: 4px;
               text-transform: uppercase; letter-spacing: .06em; }
  .think { color: var(--think); font-style: italic; border-left: 3px solid
           var(--border); padding-left: 10px; margin: 6px 0; font-size: 13px; }
  .toolcall { background: #15202b; border: 1px solid var(--border);
              border-radius: 8px; padding: 8px 10px; margin: 6px 0;
              font: 12px/1.5 ui-monospace, monospace; }
  footer { padding: 12px 16px; border-top: 1px solid var(--border); }
  .inputrow { max-width: 820px; margin: 0 auto; display: flex; gap: 8px; }
  textarea { flex: 1; background: var(--panel); color: var(--text);
             border: 1px solid var(--border); border-radius: 10px;
             padding: 10px 12px; resize: none; font: inherit; height: 46px; }
  button { background: var(--accent); border: 0; color: #fff; padding: 0 18px;
           border-radius: 10px; font: inherit; cursor: pointer; }
  button.secondary { background: var(--panel); color: var(--dim);
                     border: 1px solid var(--border); }
  button:disabled { opacity: .5; cursor: default; }
  dialog { background: var(--panel); color: var(--text); border: 1px solid
           var(--border); border-radius: 12px; padding: 18px; min-width: 320px; }
  dialog::backdrop { background: rgba(0,0,0,.5); }
  dialog label { display: flex; justify-content: space-between; gap: 12px;
                 margin: 8px 0; font-size: 14px; color: var(--dim); }
  dialog input { width: 110px; background: var(--bg); border: 1px solid
                 var(--border); color: var(--text); border-radius: 6px;
                 padding: 4px 8px; }
  #tools { font: 12px/1.6 ui-monospace, monospace; max-height: 300px;
           overflow-y: auto; }
  .stat { color: var(--dim); font-size: 12px; margin-top: 4px;
          text-align: center; }
</style>
</head>
<body>
<header>
  <h1>llama.cpp-tpu</h1>
  <span class="model" id="model">…</span>
  <div class="right">
    <button class="secondary" onclick="showTools()">tools</button>
    <button class="secondary" onclick="document.getElementById('settings').showModal()">settings</button>
    <button class="secondary" onclick="resetChat()">new chat</button>
  </div>
</header>
<div id="chat"></div>
<footer>
  <div class="inputrow">
    <textarea id="input" placeholder="Send a message…  (Enter to send, Shift+Enter for newline)"></textarea>
    <button id="send" onclick="send()">Send</button>
  </div>
  <div class="stat" id="stat"></div>
</footer>

<dialog id="settings">
  <h3 style="margin-top:0">Generation settings</h3>
  <label>temperature <input id="s_temp" type="number" step="0.1" value="0.8"></label>
  <label>top_p <input id="s_top_p" type="number" step="0.05" value="0.95"></label>
  <label>max_tokens <input id="s_max" type="number" value="512"></label>
  <label>reasoning budget <input id="s_budget" type="number" value="-1"></label>
  <label>system prompt <input id="s_sys" type="text" value=""></label>
  <div style="text-align:right;margin-top:10px">
    <button onclick="document.getElementById('settings').close()">done</button>
  </div>
</dialog>

<dialog id="toolsdlg">
  <h3 style="margin-top:0">Server tools</h3>
  <div id="tools">loading…</div>
  <div style="text-align:right;margin-top:10px">
    <button onclick="document.getElementById('toolsdlg').close()">close</button>
  </div>
</dialog>

<script>
let messages = [];
let busy = false;

fetch('/props').then(r => r.json()).then(p => {
  document.getElementById('model').textContent =
    (p.model_path || p.model || 'model') + ' · ctx ' + (p.n_ctx || '?');
}).catch(() => {});

function el(tag, cls, text) {
  const e = document.createElement(tag);
  if (cls) e.className = cls;
  if (text !== undefined) e.textContent = text;
  return e;
}

function addMsg(role) {
  const m = el('div', 'msg ' + role);
  m.appendChild(el('div', 'role', role));
  const think = el('div', 'think'); think.style.display = 'none';
  const body = el('div', 'body');
  m.appendChild(think); m.appendChild(body);
  document.getElementById('chat').appendChild(m);
  m.scrollIntoView({block: 'end'});
  return {root: m, think, body};
}

function resetChat() {
  messages = [];
  document.getElementById('chat').innerHTML = '';
  document.getElementById('stat').textContent = '';
}

async function showTools() {
  document.getElementById('toolsdlg').showModal();
  const box = document.getElementById('tools');
  try {
    const r = await fetch('/tools');
    const j = await r.json();
    const tools = j.tools || [];
    box.textContent = tools.length
      ? tools.map(t => t.name + ' — ' + (t.description || '').slice(0, 120)).join('\n')
      : 'no tools configured (start with --mcp "cmd")';
  } catch (e) { box.textContent = 'error: ' + e; }
}

async function send() {
  if (busy) return;
  const input = document.getElementById('input');
  const text = input.value.trim();
  if (!text) return;
  input.value = '';
  busy = true;
  document.getElementById('send').disabled = true;

  const sys = document.getElementById('s_sys').value.trim();
  if (sys && !messages.some(m => m.role === 'system'))
    messages.unshift({role: 'system', content: sys});
  messages.push({role: 'user', content: text});
  const um = addMsg('user'); um.body.textContent = text;

  const am = addMsg('assistant');
  let content = '', reasoning = '';
  const t0 = performance.now();
  let ntok = 0;
  try {
    const body = {
      messages, stream: true,
      temperature: +document.getElementById('s_temp').value,
      top_p: +document.getElementById('s_top_p').value,
      max_tokens: +document.getElementById('s_max').value,
    };
    const budget = +document.getElementById('s_budget').value;
    if (budget >= 0) body.reasoning_budget = budget;
    const resp = await fetch('/v1/chat/completions', {
      method: 'POST', headers: {'Content-Type': 'application/json'},
      body: JSON.stringify(body),
    });
    const reader = resp.body.getReader();
    const dec = new TextDecoder();
    let buf = '';
    for (;;) {
      const {done, value} = await reader.read();
      if (done) break;
      buf += dec.decode(value, {stream: true});
      let idx;
      while ((idx = buf.indexOf('\n\n')) >= 0) {
        const line = buf.slice(0, idx).trim(); buf = buf.slice(idx + 2);
        if (!line.startsWith('data: ') || line === 'data: [DONE]') continue;
        const ev = JSON.parse(line.slice(6));
        const d = ev.choices && ev.choices[0] && ev.choices[0].delta;
        if (!d) continue;
        ntok++;
        if (d.reasoning_content) {
          reasoning += d.reasoning_content;
          am.think.style.display = '';
          am.think.textContent = reasoning;
        }
        if (d.content) { content += d.content; am.body.textContent = content; }
        if (d.tool_calls) {
          for (const tc of d.tool_calls) {
            let n = am.root.querySelector('[data-tc="' + tc.index + '"]');
            if (!n) {
              n = el('div', 'toolcall'); n.dataset.tc = tc.index;
              n.dataset.name = ''; n.dataset.args = '';
              am.root.appendChild(n);
            }
            if (tc.function && tc.function.name) n.dataset.name = tc.function.name;
            if (tc.function && tc.function.arguments) n.dataset.args += tc.function.arguments;
            n.textContent = '→ ' + n.dataset.name + '(' + n.dataset.args + ')';
          }
        }
        am.root.scrollIntoView({block: 'end'});
      }
    }
    messages.push({role: 'assistant', content});
    const dt = (performance.now() - t0) / 1000;
    document.getElementById('stat').textContent =
      ntok + ' chunks · ' + dt.toFixed(1) + 's';
  } catch (e) {
    am.body.textContent = content + '\n[error: ' + e + ']';
  } finally {
    busy = false;
    document.getElementById('send').disabled = false;
  }
}

document.getElementById('input').addEventListener('keydown', e => {
  if (e.key === 'Enter' && !e.shiftKey) { e.preventDefault(); send(); }
});
</script>
</body>
</html>
"""
