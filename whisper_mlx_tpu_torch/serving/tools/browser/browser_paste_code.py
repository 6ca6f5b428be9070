"""Paste code into an online editor with fallbacks
(reference ``browser_paste_code.py``: fill → editor click → clipboard → type)."""
import json
from whisper_mlx_tpu_torch.serving.tools.base import tool, missing_dependency
from whisper_mlx_tpu_torch.serving.tools.browser.manager import HAVE_PLAYWRIGHT, get_browser_manager

@tool(
    name="browser_paste_code",
    description="Paste code into a code editor on the page (textarea/monaco/codemirror), with clipboard and typing fallbacks.",
    parameters={"code": {"type": "string"}, "selector": {"type": "string", "description": "optional editor CSS selector"}},
    required=["code"],
)
async def browser_paste_code(code: str, selector: str = "") -> str:
    if not HAVE_PLAYWRIGHT:
        return missing_dependency("browser_paste_code", "playwright")
    page = await get_browser_manager().page()
    candidates = [selector] if selector else [
        "textarea", ".monaco-editor textarea", ".CodeMirror textarea",
        "[contenteditable='true']",
    ]
    for sel in candidates:
        if not sel:
            continue
        try:
            loc = page.locator(sel).first
            try:
                await loc.fill(code, timeout=3_000)
                return json.dumps({"method": "fill", "selector": sel})
            except Exception:
                pass
            await loc.click(timeout=2_000)
            await page.evaluate("navigator.clipboard.writeText(arguments[0])", code)
            await page.keyboard.press("ControlOrMeta+a")
            await page.keyboard.press("ControlOrMeta+v")
            return json.dumps({"method": "clipboard", "selector": sel})
        except Exception:
            continue
    try:
        await page.keyboard.type(code, delay=5)
        return json.dumps({"method": "type"})
    except Exception as exc:
        return json.dumps({"error": f"paste failed: {exc}"})

TOOL = browser_paste_code
