"""Click via role→text→CSS locator chain (reference ``browser_click.py``)."""
import json
from whisper_mlx_tpu_torch.serving.tools.base import tool, missing_dependency
from whisper_mlx_tpu_torch.serving.tools.browser.manager import HAVE_PLAYWRIGHT, get_browser_manager

@tool(
    name="browser_click",
    description="Click an element: tries button/link role by name, then text, then CSS selector.",
    parameters={"target": {"type": "string", "description": "button name, link text, or CSS selector"}},
    required=["target"],
)
async def browser_click(target: str) -> str:
    if not HAVE_PLAYWRIGHT:
        return missing_dependency("browser_click", "playwright")
    page = await get_browser_manager().page()
    attempts = [
        lambda: page.get_by_role("button", name=target).first,
        lambda: page.get_by_role("link", name=target).first,
        lambda: page.get_by_text(target, exact=True).first,
        lambda: page.locator(target).first,
    ]
    for make in attempts:
        try:
            loc = make()
            await loc.click(timeout=3_000)
            return json.dumps({"clicked": target, "url": page.url})
        except Exception:
            continue
    return json.dumps({"error": f"could not click: {target}"})

TOOL = browser_click
