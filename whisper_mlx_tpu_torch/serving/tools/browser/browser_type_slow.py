"""Slow typing into the focused element (reference ``browser_type_slow.py``)."""
import json
from whisper_mlx_tpu_torch.serving.tools.base import tool, missing_dependency
from whisper_mlx_tpu_torch.serving.tools.browser.manager import HAVE_PLAYWRIGHT, get_browser_manager

@tool(
    name="browser_type_slow",
    description="Type text into the focused element with per-key delay (for editors that debounce input).",
    parameters={"text": {"type": "string"}, "delay_ms": {"type": "integer", "description": "per-key delay (default 50)"}},
    required=["text"],
)
async def browser_type_slow(text: str, delay_ms: int = 50) -> str:
    if not HAVE_PLAYWRIGHT:
        return missing_dependency("browser_type_slow", "playwright")
    page = await get_browser_manager().page()
    await page.keyboard.type(text, delay=max(0, min(int(delay_ms), 500)))
    return json.dumps({"typed_chars": len(text)})

TOOL = browser_type_slow
