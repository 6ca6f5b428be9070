"""Standalone CLI agents (reference ``llm.py`` + legacy agent scripts).

The reference keeps a pre-daemon agent stack: ``ToolCallingAgent`` with a
bounded tool loop and a think-loop nudge (reference ``llm.py:198-312``), an
interactive REPL (reference ``llm.py:317-353``), and standalone mirror /
code-runner / browser-demo CLIs. These live on here as thin layers over the
same engine + tool registry the daemon uses.
"""

from whisper_mlx_tpu_torch.agents.agent import ToolCallingAgent, repl_main

__all__ = ["ToolCallingAgent", "repl_main"]
