"""Page text extraction, 3000-char truncation (reference ``browser_get_text.py``)."""
import json
from whisper_mlx_tpu_torch.serving.tools.base import tool, missing_dependency
from whisper_mlx_tpu_torch.serving.tools.browser.manager import HAVE_PLAYWRIGHT, get_browser_manager

@tool(
    name="browser_get_text",
    description="Get the visible text of the current page (or a CSS selector), truncated to 3000 chars.",
    parameters={"selector": {"type": "string", "description": "optional CSS selector"}},
)
async def browser_get_text(selector: str = "") -> str:
    if not HAVE_PLAYWRIGHT:
        return missing_dependency("browser_get_text", "playwright")
    page = await get_browser_manager().page()
    if selector:
        text = await page.locator(selector).first.inner_text()
    else:
        text = await page.locator("body").inner_text()
    truncated = len(text) > 3000
    return json.dumps({"text": text[:3000], "truncated": truncated})

TOOL = browser_get_text
