"""ToolCallingAgent + REPL (reference ``llm.py:155-353``).

Counterpart of ``whisper_mlx_tpu/agents/agent.py``, with the same loop;
``make_model`` builds the port's ``QwenModel`` on an explicit device
(``cuda`` by default, which raises when no GPU is present).

The legacy (pre-daemon) agent: a bounded generate→parse→execute loop with
the reference's think-loop nudge — if a round produces only thinking and no
tool call or answer, the agent nudges the model to commit (reference
``llm.py:249-312``).
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field

from whisper_mlx_tpu_torch.serving.chat import (
    QwenModel,
    ModelSize,
    extract_final_response,
    extract_thinking,
    format_tools_prompt,
    parse_tool_calls,
)
from whisper_mlx_tpu_torch.serving.tools.base import Tool
from whisper_mlx_tpu_torch.serving.tools.registry import get_registry


@dataclass
class ToolCallingAgent:
    model: QwenModel
    tools: list[Tool]
    system_prompt: str = "You are a helpful assistant."
    max_tool_rounds: int = 5  # reference llm.py default
    max_tokens: int = 2048
    temperature: float = 0.7
    verbose: bool = True
    history: list[dict[str, str]] = field(default_factory=list)

    def _system(self) -> str:
        block = format_tools_prompt([t.spec for t in self.tools])
        return self.system_prompt + ("\n\n" + block if block else "")

    def run(self, user_message: str) -> str:
        tool_map = {t.name: t for t in self.tools}
        messages = (
            [{"role": "system", "content": self._system()}]
            + self.history
            + [{"role": "user", "content": user_message}]
        )
        registry = get_registry()
        final = ""
        for round_no in range(1, self.max_tool_rounds + 1):
            text = self.model.generate(messages, self.max_tokens, self.temperature)
            calls = parse_tool_calls(text)
            response = extract_final_response(text)
            if not calls:
                if not response and extract_thinking(text):
                    # think-loop nudge (reference llm.py:289-300): model only
                    # thought; push it to answer or call a tool
                    messages.append({"role": "assistant", "content": text})
                    messages.append({
                        "role": "user",
                        "content": "(Please either call a tool or give your final answer now.)",
                    })
                    continue
                final = response
                break
            results = []
            for call in calls:
                if call.name not in tool_map:
                    results.append(f'{{"error": "unknown tool: {call.name}"}}')
                    continue
                if self.verbose:
                    print(f"  [tool] {call.name}({call.arguments})", file=sys.stderr)
                t0 = time.perf_counter()
                out = registry.execute(call.name, call.arguments)
                if self.verbose:
                    print(f"  [tool] {call.name} done in "
                          f"{(time.perf_counter() - t0) * 1000:.0f}ms", file=sys.stderr)
                results.append(out)
            messages.append({"role": "assistant", "content": text})
            messages.append({
                "role": "user",
                "content": "\n".join(
                    f"<tool_response>\n{r}\n</tool_response>" for r in results
                ),
            })
        else:
            final = "(tool-round limit reached)"
        self.history.append({"role": "user", "content": user_message})
        self.history.append({"role": "assistant", "content": final})
        return final


def repl_main(agent: ToolCallingAgent, banner: str) -> int:
    """Interactive REPL (reference llm.py:317-353)."""
    print(banner)
    print("type 'exit' to quit, 'reset' to clear history\n")
    while True:
        try:
            line = input("> ").strip()
        except (EOFError, KeyboardInterrupt):
            print()
            return 0
        if not line:
            continue
        if line in ("exit", "quit"):
            return 0
        if line == "reset":
            agent.history.clear()
            print("(history cleared)")
            continue
        print(agent.run(line))


def make_model(model_size: str = "large", device: str = "cuda") -> QwenModel:
    return QwenModel.get(ModelSize(model_size), None, device)
