"""Standalone code-runner agent CLI (reference ``code_runner_agent.py``).

``run_code_agent(language, description, model_size, timeout)`` (reference
:489-563) drives online playgrounds through the browser tool set; without
playwright installed the agent surfaces the structured tool errors.
"""

from __future__ import annotations

import argparse
import time

from whisper_mlx_tpu_torch.agents.agent import ToolCallingAgent, make_model
from whisper_mlx_tpu_torch.serving.profiles.code_runner import PROFILE
from whisper_mlx_tpu_torch.serving.tools.registry import get_registry


def run_code_agent(
    language: str,
    description: str,
    model_size: str = "large",
    timeout: float = 600.0,
    verbose: bool = True,
    device: str = "cuda",
) -> str:
    agent = ToolCallingAgent(
        model=make_model(model_size, device),
        tools=get_registry().get_tools(list(PROFILE.tools)),
        system_prompt=PROFILE.system_prompt,
        max_tool_rounds=PROFILE.max_tool_rounds,
        max_tokens=PROFILE.max_tokens,
        temperature=PROFILE.temperature,
        verbose=verbose,
    )
    t0 = time.perf_counter()
    result = agent.run(
        f"Write a {language} program: {description}. Run it in an online "
        f"playground and report the program and its observed output."
    )
    if time.perf_counter() - t0 > timeout:
        result += "\n(warning: exceeded requested timeout)"
    return result


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser("code runner agent")
    parser.add_argument("language")
    parser.add_argument("description", nargs="+")
    parser.add_argument("--model-size", default="large")
    parser.add_argument("--timeout", type=float, default=600.0)
    parser.add_argument("--device", default="cuda",
                        help="torch device of the model: cuda (the default) or cpu")
    args = parser.parse_args(argv)
    print(run_code_agent(args.language, " ".join(args.description),
                         args.model_size, args.timeout, device=args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
