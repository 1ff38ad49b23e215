"""Chat templating for ``/v1/chat/completions``.

The port keeps its own copy of the JAX package's ``serving/chat_template.py``
(it imports nothing from that package). Rendering contract:

- ``phi`` style renders ``Human: ...`` / ``Assistant: ...`` turns;
- ``opt`` style renders ``User: ...`` / ``Assistant: ...`` turns;
- an optional single leading *system* message is hoisted to the top as plain
  text;
- when ``add_generation_prompt`` is true, the assistant prefix is appended so
  the model continues as the assistant.

Model-family default: phi-2 -> phi style; everything else -> opt style
(generic user/assistant). A tokenizer-provided template (real HF
checkpoints) wins over the default, and a template file (``--chat-template``)
over both, matching vLLM's precedence.
"""

from __future__ import annotations

from typing import List, Optional

import jinja2

PHI_STYLE = """\
{%- if messages and messages[0].role == 'system' -%}
{{ messages[0].content }}

{% set messages = messages[1:] %}
{%- endif -%}
{%- for m in messages -%}
{%- if m.role == 'user' -%}
Human: {{ m.content }}
{% elif m.role == 'assistant' -%}
Assistant: {{ m.content }}
{% endif -%}
{%- endfor -%}
{%- if add_generation_prompt -%}
Assistant:{%- endif -%}
"""

OPT_STYLE = """\
{%- if messages and messages[0].role == 'system' -%}
{{ messages[0].content }}

{% set messages = messages[1:] %}
{%- endif -%}
{%- for m in messages -%}
{%- if m.role == 'user' -%}
User: {{ m.content }}
{% elif m.role == 'assistant' -%}
Assistant: {{ m.content }}
{% endif -%}
{%- endfor -%}
{%- if add_generation_prompt -%}
Assistant:{%- endif -%}
"""

_STYLES = {"phi": PHI_STYLE, "opt": OPT_STYLE}


def default_style_for_model(model_name: str) -> str:
    return "phi" if "phi" in model_name.lower() else "opt"


class ChatTemplater:
    """Render chat messages to a prompt string.

    Precedence (mirrors vLLM's --chat-template behavior): explicit template file
    > tokenizer-embedded template > family default style.
    """

    def __init__(self, model_name: str, tokenizer=None,
                 template_path: Optional[str] = None,
                 style: Optional[str] = None):
        self._tokenizer = tokenizer
        self._env = jinja2.Environment(keep_trailing_newline=True)
        source: Optional[str] = None
        if template_path:
            with open(template_path) as fh:
                source = fh.read()
        elif style:
            source = _STYLES[style]
        self._template = self._env.from_string(source) if source else None
        self._fallback = self._env.from_string(
            _STYLES[default_style_for_model(model_name)])

    def render(self, messages: List[dict], add_generation_prompt: bool = True
               ) -> str:
        msgs = [dict(role=m.get("role", "user"), content=m.get("content", ""))
                for m in messages]
        if self._template is not None:
            return self._template.render(messages=msgs,
                                         add_generation_prompt=add_generation_prompt)
        if self._tokenizer is not None and hasattr(self._tokenizer, "_tok") and \
                getattr(self._tokenizer._tok, "chat_template", None):
            return self._tokenizer.apply_chat_template(
                msgs, add_generation_prompt=add_generation_prompt)
        return self._fallback.render(messages=msgs,
                                     add_generation_prompt=add_generation_prompt)
