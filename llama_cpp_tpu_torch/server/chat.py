"""Chat template engine: Jinja rendering of GGUF-embedded templates with
built-in fallbacks for the common families.

Parity: reference llama_chat_apply_template (src/llama-chat.cpp, ~40 known
templates) + the full Jinja path (common/jinja/). We use jinja2 directly for
model templates and keep hand-rolled fallbacks for the major formats.
"""

from __future__ import annotations

from typing import Any


def _render_jinja(template: str, messages, bos: str, eos: str, add_gen: bool, tools=None) -> str:
    import jinja2

    env = jinja2.Environment(
        loader=jinja2.BaseLoader(), trim_blocks=True, lstrip_blocks=True
    )

    def raise_exception(msg):
        raise jinja2.TemplateError(msg)

    def strftime_now(fmt):
        import datetime

        return datetime.datetime.now().strftime(fmt)

    env.globals["raise_exception"] = raise_exception
    env.globals["strftime_now"] = strftime_now
    env.filters["tojson"] = lambda x, **kw: __import__("json").dumps(x, **kw)
    tmpl = env.from_string(template)
    return tmpl.render(
        messages=messages,
        bos_token=bos,
        eos_token=eos,
        add_generation_prompt=add_gen,
        tools=tools,
    )


def _chatml(messages, add_gen: bool) -> str:
    out = []
    for m in messages:
        out.append(f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n")
    if add_gen:
        out.append("<|im_start|>assistant\n")
    return "".join(out)


def _llama3(messages, add_gen: bool) -> str:
    out = ["<|begin_of_text|>"]
    for m in messages:
        out.append(
            f"<|start_header_id|>{m['role']}<|end_header_id|>\n\n{m['content']}<|eot_id|>"
        )
    if add_gen:
        out.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
    return "".join(out)


def _llama2(messages, add_gen: bool) -> str:
    out = []
    system = ""
    for m in messages:
        if m["role"] == "system":
            system = m["content"]
        elif m["role"] == "user":
            content = m["content"]
            if system:
                content = f"<<SYS>>\n{system}\n<</SYS>>\n\n{content}"
                system = ""
            out.append(f"[INST] {content} [/INST]")
        else:
            out.append(f" {m['content']} ")
    return "".join(out)


def _gemma(messages, add_gen: bool) -> str:
    out = []
    for m in messages:
        role = "model" if m["role"] == "assistant" else "user"
        out.append(f"<start_of_turn>{role}\n{m['content']}<end_of_turn>\n")
    if add_gen:
        out.append("<start_of_turn>model\n")
    return "".join(out)


_FALLBACKS = {
    "chatml": _chatml,
    "llama3": _llama3,
    "llama2": _llama2,
    "gemma": _gemma,
}


def detect_template_family(template: str | None) -> str:
    if not template:
        return "chatml"
    if "<|im_start|>" in template:
        return "chatml"
    if "start_header_id" in template or "<|eot_id|>" in template:
        return "llama3"
    if "[INST]" in template:
        return "llama2"
    if "start_of_turn" in template:
        return "gemma"
    return "chatml"


def apply_chat_template(
    messages: list[dict[str, Any]],
    template: str | None = None,
    bos: str = "",
    eos: str = "",
    add_generation_prompt: bool = True,
    tools=None,
) -> str:
    """Render messages to a prompt string. Uses the model's Jinja template
    when present, falling back to the detected family formatter."""
    msgs = []
    for m in messages:
        content = m.get("content", "")
        if isinstance(content, list):  # OpenAI content-parts form
            content = "".join(
                p.get("text", "") for p in content if p.get("type") == "text"
            )
        msgs.append({"role": m.get("role", "user"), "content": content})
    if template:
        try:
            return _render_jinja(template, msgs, bos, eos, add_generation_prompt, tools)
        except Exception:
            pass
    fam = detect_template_family(template)
    return _FALLBACKS[fam](msgs, add_generation_prompt)
