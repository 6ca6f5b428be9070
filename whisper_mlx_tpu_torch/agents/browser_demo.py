"""Minimal browser-agent demo (reference ``demo_browser_agent.py``)."""

from __future__ import annotations

import argparse

from whisper_mlx_tpu_torch.agents.agent import ToolCallingAgent, make_model, repl_main
from whisper_mlx_tpu_torch.serving.tools.registry import get_registry

DEMO_TOOLS = ["web_search", "browser_navigate", "browser_get_text",
              "browser_click", "browser_get_elements"]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser("browser demo agent")
    parser.add_argument("--model-size", default="large")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the model: cuda (the default) or cpu")
    args = parser.parse_args(argv)
    # browser_screenshot exists only in the reference's demo agent
    # (demo_browser_agent.py:116-121), not in the daemon registry — same here
    from whisper_mlx_tpu_torch.serving.tools.browser.browser_screenshot import (
        TOOL as screenshot_tool,
    )

    agent = ToolCallingAgent(
        model=make_model(args.model_size, args.device),
        tools=get_registry().get_tools(DEMO_TOOLS) + [screenshot_tool],
        system_prompt="You browse the web to answer questions. Use the tools.",
        max_tool_rounds=6,
    )
    return repl_main(agent, "browser demo agent")


if __name__ == "__main__":
    raise SystemExit(main())
