"""Page screenshot to a session-scoped file (reference ``demo_browser_agent.py:116-121``).

The reference exposes this only inside its browser demo agent (it is not in
the daemon registry); kept unregistered here to match, and pulled in by
``agents/browser_demo.py``.
"""
import json
import os
import tempfile
import time

from whisper_mlx_tpu_torch.serving.tools.base import tool, missing_dependency
from whisper_mlx_tpu_torch.serving.tools.browser.manager import HAVE_PLAYWRIGHT, get_browser_manager


@tool(
    name="browser_screenshot",
    description="Take a screenshot of the current page and save it to a file; returns the path.",
    parameters={"path": {"type": "string", "description": "optional output path (.png)"}},
)
async def browser_screenshot(path: str = "") -> str:
    if not HAVE_PLAYWRIGHT:
        return missing_dependency("browser_screenshot", "playwright")
    if not path:
        path = os.path.join(tempfile.gettempdir(),
                            f"wtpu_browser_screenshot_{int(time.time())}.png")
    page = await get_browser_manager().page()
    await page.screenshot(path=path)
    return json.dumps({"screenshot_path": path})


TOOL = browser_screenshot
