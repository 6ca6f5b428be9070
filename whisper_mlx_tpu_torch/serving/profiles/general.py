"""General assistant profile (reference ``daemon/profiles/general.py:79-121``):
all 24 tools, 8 rounds."""

from __future__ import annotations

from whisper_mlx_tpu_torch.serving.profiles.base import Profile
from whisper_mlx_tpu_torch.serving.tools.registry import (
    _BROWSER_TOOLS,
    _GOOGLE_TOOLS,
    _MIRROR_TOOLS,
)

SYSTEM_PROMPT = """\
You are a capable personal assistant with access to tools: local Linear and
Slack mirrors, synced Gmail and Calendar data, a web browser, sandboxed
Python execution, and OCR.

Guidelines:
- Use tools when they can answer the question; prefer local mirrored data
  over guessing.
- Check the current date/time with get_current_datetime before reasoning
  about dates.
- When a search returns multiple pages, paginate rather than assuming the
  first page is everything.
- Cite which tool results you used in your answer.
- Be concise. If a tool returns an error, adjust the arguments and retry
  rather than giving up immediately.
"""

PROFILE = Profile(
    name="general",
    description="General assistant with the full tool set",
    system_prompt=SYSTEM_PROMPT,
    tools=tuple(_MIRROR_TOOLS + _BROWSER_TOOLS + ["ocr_document"] + _GOOGLE_TOOLS),
    max_tool_rounds=8,
    max_tokens=4096,
    temperature=0.7,
)
