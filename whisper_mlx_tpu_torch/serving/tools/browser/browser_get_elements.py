"""Interactive element listing, ≤15 (reference ``browser_get_elements.py``)."""
import json
from whisper_mlx_tpu_torch.serving.tools.base import tool, missing_dependency
from whisper_mlx_tpu_torch.serving.tools.browser.manager import HAVE_PLAYWRIGHT, get_browser_manager

@tool(
    name="browser_get_elements",
    description="List up to 15 visible buttons and links on the current page.",
)
async def browser_get_elements() -> str:
    if not HAVE_PLAYWRIGHT:
        return missing_dependency("browser_get_elements", "playwright")
    page = await get_browser_manager().page()
    out = []
    for role in ("button", "link"):
        for el in await page.get_by_role(role).all():
            try:
                if await el.is_visible():
                    out.append({"role": role, "text": (await el.inner_text())[:80]})
            except Exception:
                continue
            if len(out) >= 15:
                break
        if len(out) >= 15:
            break
    return json.dumps({"elements": out})

TOOL = browser_get_elements
