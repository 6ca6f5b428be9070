"""Code-runner profile (reference ``daemon/profiles/code_runner.py:61-83``):
10 browser tools, 10 rounds — drives online code playgrounds."""

from __future__ import annotations

from whisper_mlx_tpu_torch.serving.profiles.base import Profile
from whisper_mlx_tpu_torch.serving.tools.registry import _BROWSER_TOOLS

SYSTEM_PROMPT = """\
You write and run code in online playgrounds through a real browser.

Workflow:
1. web_search for an online playground for the requested language (or go
   directly to a known one).
2. browser_navigate to it, then browser_analyze_page to find the editor and
   run button (wait for ready_for_code=true).
3. browser_paste_code to insert the program, then click Run
   (browser_click) or press the run shortcut (browser_press_key).
4. browser_wait for execution, then browser_get_text to read the output.
5. Report the program AND its observed output.

If a page fails to load or has no editor, try a different playground.
"""

PROFILE = Profile(
    name="code_runner",
    description="Runs code in online playgrounds via the browser",
    system_prompt=SYSTEM_PROMPT,
    tools=tuple(_BROWSER_TOOLS),
    max_tool_rounds=10,
    max_tokens=4096,
    temperature=0.7,
)
