"""Profile type (reference ``daemon/profiles/base.py:24-62``).

A frozen dataclass bundling system prompt, tool set and generation
parameters — the "agent config" unit of the daemon.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable


@dataclass(frozen=True)
class Profile:
    name: str
    description: str
    system_prompt: str
    tools: tuple[str, ...] = ()
    max_tool_rounds: int = 8
    max_tokens: int = 4096
    temperature: float = 0.7
    context_augmenters: tuple[Callable[[], str], ...] = ()

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "description": self.description,
            "tools": list(self.tools),
            "max_tool_rounds": self.max_tool_rounds,
            "max_tokens": self.max_tokens,
            "temperature": self.temperature,
        }
