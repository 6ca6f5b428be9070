"""Deprecated config shim (reference ``daemon/config.py:1-94``).

The reference keeps a backwards-compat module re-exporting chat/tool/profile
symbols with a lazily-built TOOL_SPECS mapping; preserved here for drop-in
imports from older client code.
"""

from __future__ import annotations

import warnings
from typing import Any

from whisper_mlx_tpu_torch.serving.chat import (  # noqa: F401
    ChatMessage,
    ChatResponse,
    ChatService,
    ModelSize,
    QwenModel,
    ToolCall,
    ToolResult,
    create_chat_service,
)
from whisper_mlx_tpu_torch.serving.profiles import ALL_PROFILES, Profile, get_profile  # noqa: F401
from whisper_mlx_tpu_torch.serving.tools.registry import get_registry  # noqa: F401

warnings.warn(
    "whisper_mlx_tpu_torch.serving.config is deprecated; import from "
    "serving.chat / serving.tools / serving.profiles directly",
    DeprecationWarning,
    stacklevel=2,
)


class _LazyToolSpecsDict(dict):
    """dict facade over the lazy registry (reference config.py:60-94):
    touching a key imports only that tool."""

    def __getitem__(self, name: str) -> dict[str, Any]:
        tool = get_registry().get(name)
        if tool is None:
            raise KeyError(name)
        return tool.spec.to_dict()

    def __contains__(self, name: object) -> bool:
        return isinstance(name, str) and name in get_registry().available_tools

    def keys(self):  # type: ignore[override]
        return get_registry().available_tools

    def __iter__(self):
        return iter(get_registry().available_tools)

    def __len__(self) -> int:
        return len(get_registry().available_tools)


TOOL_SPECS = _LazyToolSpecsDict()
