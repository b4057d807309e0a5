"""GGUF chat-template rendering (llama.cpp parity): the port's copy of
``distributed_llm_pipeline_tpu/serving/chat_template.py``.

llama.cpp renders OpenAI ``messages`` through the Jinja template embedded in
GGUF metadata (``tokenizer.chat_template``, written by convert scripts from
the HF tokenizer config; rendered by its vendored *minja* engine). Same
contract here via jinja2, with the variables real-world templates use:
``messages``, ``add_generation_prompt``, ``bos_token``, ``eos_token``, plus
the ``raise_exception`` helper minja provides.

The template is UNTRUSTED content from a model file, so it renders inside
jinja2's :class:`~jinja2.sandbox.ImmutableSandboxedEnvironment` — attribute
access that could reach Python internals raises instead of executing.
Any template failure falls back to the built-in heuristic prompt format
(the caller handles that), never a 500.
"""

from __future__ import annotations

# guards for untrusted templates: source size, rendered size, and range()
# iteration caps. These bound resource use; they are not a full execution
# timeout (a template that loops without producing output can still spin —
# the same residual trust llama.cpp extends to minja templates in model
# files; loading a model already implies running its template).
MAX_TEMPLATE_BYTES = 256 * 1024
MAX_RENDER_CHARS = 2 * 1024 * 1024
MAX_RANGE = 100_000

_compiled: dict[str, object] = {}  # template source -> compiled Template


class ChatTemplateError(ValueError):
    pass


def _text_of(m: dict) -> str:
    c = m.get("content")
    if isinstance(c, str):
        return c
    if isinstance(c, list):  # OpenAI content-parts form
        texts = [p["text"] for p in c
                 if isinstance(p, dict) and p.get("type") == "text"]
        if texts:
            return "".join(texts)
    if c is None:
        return ""
    raise ChatTemplateError(
        f"unsupported message content: {type(c).__name__}")


def render_chat_template(template: str, messages: list[dict], *,
                         bos_token: str = "", eos_token: str = "",
                         add_generation_prompt: bool = True) -> str:
    """Render ``messages`` through a GGUF-embedded Jinja chat template.

    Raises :class:`ChatTemplateError` on any template problem (syntax,
    sandbox violation, template-raised exception) so callers can fall back.
    """
    try:
        import jinja2
        from jinja2.sandbox import ImmutableSandboxedEnvironment
    except ImportError as e:  # pragma: no cover - jinja2 ships in this env
        raise ChatTemplateError(f"jinja2 unavailable: {e}") from None

    if len(template) > MAX_TEMPLATE_BYTES:
        raise ChatTemplateError(
            f"chat template too large ({len(template)} bytes)")

    def raise_exception(msg: str = "chat template error"):
        raise ChatTemplateError(str(msg))

    def strftime_now(fmt: str) -> str:
        import datetime

        return datetime.datetime.now().strftime(fmt)

    def capped_range(*args):
        r = range(*args)
        if len(r) > MAX_RANGE:
            raise ChatTemplateError(
                f"chat template range() over {len(r)} items (cap {MAX_RANGE})")
        return r

    # compile once per template string (immutable per loaded model; real
    # chat templates are tens of KB of Jinja — parsing per request would
    # land in TTFT)
    compiled = _compiled.get(template)
    if compiled is None:
        env = ImmutableSandboxedEnvironment(
            trim_blocks=True, lstrip_blocks=True,
            undefined=jinja2.ChainableUndefined)
        env.globals["raise_exception"] = raise_exception
        env.globals["strftime_now"] = strftime_now
        env.globals["range"] = capped_range
        try:
            compiled = env.from_string(template)
        except jinja2.TemplateError as e:
            raise ChatTemplateError(f"chat template failed: {e}") from None
        if len(_compiled) > 8:  # a handful of loaded models at most
            _compiled.clear()
        _compiled[template] = compiled
    # normalize content to plain strings (templates index message['content'])
    msgs = [{**m, "content": _text_of(m)} for m in messages]
    try:
        # stream the render so a runaway template is cut at the output cap
        # instead of allocating without bound
        parts: list[str] = []
        size = 0
        for piece in compiled.generate(
                messages=msgs, add_generation_prompt=add_generation_prompt,
                bos_token=bos_token, eos_token=eos_token):
            parts.append(piece)
            size += len(piece)
            if size > MAX_RENDER_CHARS:
                raise ChatTemplateError(
                    f"chat template rendered over {MAX_RENDER_CHARS} chars")
        return "".join(parts)
    except ChatTemplateError:
        raise
    except jinja2.TemplateError as e:
        raise ChatTemplateError(f"chat template failed: {e}") from None
    except Exception as e:  # sandbox violations raise SecurityError etc.
        raise ChatTemplateError(f"chat template failed: {e!r}") from None
