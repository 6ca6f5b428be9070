"""Standalone mirror agent CLI (reference ``mirror_agent.py``).

The reference ships a 1,515-LoC standalone that duplicates the mirror data
store and tools; here the daemon's registry/profile are reused and only the
CLI shell is standalone (reference ``mirror_agent.py:1453-1460`` builds a
ToolCallingAgent the same way).
"""

from __future__ import annotations

import argparse

from whisper_mlx_tpu_torch.agents.agent import ToolCallingAgent, make_model, repl_main
from whisper_mlx_tpu_torch.serving.profiles.mirror import PROFILE
from whisper_mlx_tpu_torch.serving.tools.registry import get_registry


def create_mirror_agent(model_size: str = "large", verbose: bool = True,
                        device: str = "cuda") -> ToolCallingAgent:
    tools = get_registry().get_tools(list(PROFILE.tools))
    return ToolCallingAgent(
        model=make_model(model_size, device),
        tools=tools,
        system_prompt=PROFILE.system_prompt,
        max_tool_rounds=PROFILE.max_tool_rounds,
        max_tokens=PROFILE.max_tokens,
        temperature=PROFILE.temperature,
        verbose=verbose,
    )


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser("mirror agent")
    parser.add_argument("--model-size", default="large", choices=["small", "medium", "large"])
    parser.add_argument("-q", "--quiet", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the model: cuda (the default) or cpu")
    parser.add_argument("question", nargs="*", help="one-shot question (REPL if empty)")
    args = parser.parse_args(argv)
    agent = create_mirror_agent(args.model_size, verbose=not args.quiet, device=args.device)
    if args.question:
        print(agent.run(" ".join(args.question)))
        return 0
    return repl_main(agent, "mirror agent — Linear/Slack mirror analyst")


if __name__ == "__main__":
    raise SystemExit(main())
