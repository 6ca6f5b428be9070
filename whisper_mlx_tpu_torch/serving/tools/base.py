"""Tool system core types (reference ``daemon/tools/base.py:23-105``).

Same contract as the reference: tool functions return JSON **strings**
(so results pass verbatim into the LLM context), specs carry JSON-schema
parameter descriptions, and the ``@tool`` decorator wraps plain functions.
"""

from __future__ import annotations

import inspect
import json
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable, Protocol


@dataclass(frozen=True)
class ToolSpec:
    """JSON-schema-ish description shown to the LLM (reference base.py:23-40)."""

    name: str
    description: str
    parameters: dict[str, Any] = field(default_factory=dict)
    required: tuple[str, ...] = ()

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "description": self.description,
            "parameters": {
                "type": "object",
                "properties": self.parameters,
                "required": list(self.required),
            },
        }


@dataclass(frozen=True)
class Tool:
    """A callable tool: sync or async fn returning a JSON string
    (reference base.py:43-69)."""

    spec: ToolSpec
    fn: Callable[..., str] | Callable[..., Awaitable[str]]

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def is_async(self) -> bool:
        return inspect.iscoroutinefunction(self.fn)

    def execute(self, **kwargs: Any):
        return self.fn(**kwargs)


class ToolModule(Protocol):
    """Modules exposing a module-level ``TOOL`` (reference base.py:72-79)."""

    TOOL: Tool


def tool(
    name: str,
    description: str,
    parameters: dict[str, Any] | None = None,
    required: tuple[str, ...] | list[str] = (),
) -> Callable[[Callable[..., Any]], Tool]:
    """Decorator: plain function → Tool (reference base.py:82-105)."""

    def wrap(fn: Callable[..., Any]) -> Tool:
        return Tool(
            spec=ToolSpec(
                name=name,
                description=description,
                parameters=parameters or {},
                required=tuple(required),
            ),
            fn=fn,
        )

    return wrap


def json_error(message: str, **extra: Any) -> str:
    """Error payload surfaced to the LLM (the agent can read it and retry —
    reference registry.py:111-113 behavior)."""
    return json.dumps({"error": message, **extra})


def missing_dependency(tool_name: str, dep: str) -> str:
    return json_error(
        f"tool '{tool_name}' requires the '{dep}' package, which is not "
        "installed in this environment",
        missing_dependency=dep,
    )
