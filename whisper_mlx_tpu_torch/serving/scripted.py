"""Deterministic scripted LLM engine — golden-session serving fixture.

The reference's daemon e2e can assert real semantics ("what is 2+2" → "4",
reference tests/test_daemon_e2e.py:617-670) because it downloads real
weights; this image has no weights, so a random model can only be
schema-checked. This engine closes that gap: a JSON script maps prompt
patterns to fixed completions, so the FULL serving stack — ChatML prompt
build, tool-call parse, registry execution, tool-response feedback,
SSE event stream, session persistence — runs end-to-end with assertable
outputs (tests/test_golden_session.py).

Script format (QWEN_SCRIPTED_MODEL=/path/to/script.json):

    {"rules": [
        {"match": "2+2", "response": "<tool_call>{\"name\": \"run_python\",
            \"arguments\": {\"code\": \"print(2+2)\"}}</tool_call>"},
        {"match": "<tool_response>", "response": "The answer is {{tool_response}}."}
    ], "default": "I don't know."}

Rule selection: the LAST rule whose ``match`` substring occurs in the prompt
wins (later rules cover later agent rounds, e.g. the tool-response round).
``{{tool_response}}`` interpolates the content of the last
``<tool_response>…</tool_response>`` block in the prompt.
"""

from __future__ import annotations

import json
import re
import time
from typing import Iterator

from whisper_mlx_tpu_torch.inference.generate import GenerationResult

_TOOL_RESPONSE_RE = re.compile(r"<tool_response>\s*(.*?)\s*</tool_response>", re.S)


class ScriptedEngine:
    """Drop-in for LLMEngine's generate/stream_generate/continuous surface."""

    def __init__(self, script: dict):
        self.rules = list(script.get("rules", []))
        self.default = script.get("default", "")
        self.tokenizer = None  # parity with LLMEngine attribute surface

    @classmethod
    def from_file(cls, path: str) -> "ScriptedEngine":
        with open(path) as f:
            return cls(json.load(f))

    def _complete(self, prompt: str) -> str:
        chosen = self.default
        for rule in self.rules:
            if rule.get("match", "") in prompt:
                chosen = rule.get("response", "")
        if "{{tool_response}}" in chosen:
            blocks = _TOOL_RESPONSE_RE.findall(prompt)
            chosen = chosen.replace("{{tool_response}}", blocks[-1] if blocks else "")
        return chosen

    def generate(self, prompt: str, max_tokens: int = 512,
                 temperature: float = 0.0, **kw) -> GenerationResult:
        t0 = time.perf_counter()
        text = self._complete(prompt)
        dt = max(time.perf_counter() - t0, 1e-9)
        return GenerationResult(
            text=text, tokens=[], prompt_tokens=len(prompt.split()),
            generation_tokens=len(text.split()),
            prompt_tps=len(prompt.split()) / dt,
            generation_tps=len(text.split()) / dt,
        )

    def stream_generate(self, prompt: str, max_tokens: int = 512,
                        temperature: float = 0.0, **kw) -> Iterator[str]:
        """Yield word-sized chunks so SSE token events exercise streaming."""
        text = self._complete(prompt)
        parts = re.findall(r"\S+\s*", text)
        for part in parts:
            yield part

    def continuous(self, slots: int = 4) -> "ScriptedEngine":
        """Batch-mode shim: scripted completion is already request-isolated."""
        return self

    def submit(self, prompt: str, max_tokens: int = 512,
               temperature: float = 0.0) -> "_ScriptedHandle":
        return _ScriptedHandle(self._complete(prompt))


class _ScriptedHandle:
    def __init__(self, text: str):
        self._text = text

    def text_stream(self) -> Iterator[str]:
        for part in re.findall(r"\S+\s*", self._text):
            yield part

    def result_text(self) -> str:
        return self._text
