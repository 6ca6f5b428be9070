"""Single key press (reference ``browser_press_key.py``)."""
import json
from whisper_mlx_tpu_torch.serving.tools.base import tool, missing_dependency
from whisper_mlx_tpu_torch.serving.tools.browser.manager import HAVE_PLAYWRIGHT, get_browser_manager

@tool(
    name="browser_press_key",
    description="Press a keyboard key or combo in the browser (e.g. 'Enter', 'Control+Enter').",
    parameters={"key": {"type": "string"}},
    required=["key"],
)
async def browser_press_key(key: str) -> str:
    if not HAVE_PLAYWRIGHT:
        return missing_dependency("browser_press_key", "playwright")
    page = await get_browser_manager().page()
    await page.keyboard.press(key)
    return json.dumps({"pressed": key})

TOOL = browser_press_key
