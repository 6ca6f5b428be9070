"""Lazy tool registry (reference ``daemon/tools/registry.py``).

Tools register as (module, attribute) pairs and import only on first use
(reference registry.py:46-78). ``execute`` runs sync tools directly and
guards against accidentally-returned coroutines; ``execute_async`` awaits
async tools and pushes sync ones to a thread (reference :91-139). Errors
are caught and returned as JSON strings so the agent loop can react
(reference :111-113,137-139).

The registry population mirrors the reference's 24 tools
(reference registry.py:185-239): 9 mirror + 10 browser + 1 ocr + 4 google.
"""

from __future__ import annotations

import asyncio
import importlib
import inspect
import json
import logging
import threading
from typing import Any

from whisper_mlx_tpu_torch.serving.tools.base import Tool, ToolSpec

logger = logging.getLogger("qwen.tools")


class ToolRegistry:
    def __init__(self) -> None:
        self._tools: dict[str, Tool] = {}
        self._lazy: dict[str, tuple[str, str]] = {}
        self._lock = threading.Lock()

    # -- registration -------------------------------------------------------

    def register(self, tool: Tool) -> None:
        self._tools[tool.name] = tool

    def register_lazy(self, name: str, module: str, attr: str = "TOOL") -> None:
        self._lazy[name] = (module, attr)

    def _load_lazy(self, name: str) -> Tool | None:
        with self._lock:
            if name in self._tools:
                return self._tools[name]
            entry = self._lazy.get(name)
            if entry is None:
                return None
            module_name, attr = entry
            try:
                module = importlib.import_module(module_name)
                tool = getattr(module, attr)
            except Exception as exc:  # import errors surface at call time
                logger.warning("lazy tool %s failed to load: %s", name, exc)
                return None
            self._tools[name] = tool
            return tool

    # -- lookup -------------------------------------------------------------

    @property
    def available_tools(self) -> list[str]:
        return sorted(set(self._tools) | set(self._lazy))

    def get(self, name: str) -> Tool | None:
        return self._tools.get(name) or self._load_lazy(name)

    def get_tools(self, names: list[str] | tuple[str, ...] | None = None) -> list[Tool]:
        names = list(names) if names is not None else self.available_tools
        out = []
        for n in names:
            t = self.get(n)
            if t is not None:
                out.append(t)
        return out

    def get_all_specs(self) -> list[ToolSpec]:
        return [t.spec for t in self.get_tools()]

    # -- execution ----------------------------------------------------------

    def execute(self, name: str, arguments: dict[str, Any]) -> str:
        tool = self.get(name)
        if tool is None:
            return json.dumps({"error": f"unknown tool: {name}"})
        try:
            result = tool.execute(**arguments)
            if inspect.iscoroutine(result):
                # sync path can't await; run it on a fresh loop (reference
                # registry.py:91-113 coroutine guard)
                result = asyncio.run(result)
            return result if isinstance(result, str) else json.dumps(result)
        except Exception as exc:
            logger.exception("tool %s failed", name)
            return json.dumps({"error": f"{type(exc).__name__}: {exc}"})

    async def execute_async(self, name: str, arguments: dict[str, Any]) -> str:
        tool = self.get(name)
        if tool is None:
            return json.dumps({"error": f"unknown tool: {name}"})
        try:
            if tool.is_async:
                result = await tool.execute(**arguments)
            else:
                result = await asyncio.to_thread(lambda: tool.execute(**arguments))
            return result if isinstance(result, str) else json.dumps(result)
        except Exception as exc:
            logger.exception("tool %s failed", name)
            return json.dumps({"error": f"{type(exc).__name__}: {exc}"})


_registry: ToolRegistry | None = None
_registry_lock = threading.Lock()

_PKG = "whisper_mlx_tpu_torch.serving.tools"

# the reference's 24 lazy registrations (reference registry.py:185-239)
_MIRROR_TOOLS = [
    "get_current_datetime", "run_python", "search_linear_issues",
    "get_linear_issue", "list_linear_events", "search_slack_messages",
    "get_slack_thread", "list_recent_slack_activity", "lookup_user",
]
_BROWSER_TOOLS = [
    "web_search", "browser_navigate", "browser_get_text", "browser_click",
    "browser_get_elements", "browser_wait", "browser_paste_code",
    "browser_type_slow", "browser_press_key", "browser_analyze_page",
]
_GOOGLE_TOOLS = ["search_emails", "get_email", "search_calendar", "get_calendar_event"]


def _populate_registry(reg: ToolRegistry) -> None:
    for name in _MIRROR_TOOLS:
        reg.register_lazy(name, f"{_PKG}.mirror.{name}")
    for name in _BROWSER_TOOLS:
        reg.register_lazy(name, f"{_PKG}.browser.{name}")
    reg.register_lazy("ocr_document", f"{_PKG}.ocr.ocr_document")
    for name in _GOOGLE_TOOLS:
        reg.register_lazy(name, f"{_PKG}.google.{name}")


def get_registry() -> ToolRegistry:
    global _registry
    with _registry_lock:
        if _registry is None:
            _registry = ToolRegistry()
            _populate_registry(_registry)
        return _registry
