"""Editor/run-button detection (reference ``browser_analyze_page.py``):
reports whether the page looks ready for code input."""
import json
from whisper_mlx_tpu_torch.serving.tools.base import tool, missing_dependency
from whisper_mlx_tpu_torch.serving.tools.browser.manager import HAVE_PLAYWRIGHT, get_browser_manager

_EDITOR_SELECTORS = ["textarea", ".monaco-editor", ".CodeMirror", "[contenteditable='true']"]
_RUN_TEXTS = ["Run", "Execute", "Submit", "Run Code", "▶"]

@tool(
    name="browser_analyze_page",
    description="Analyze the current page for a code editor and run button; reports ready_for_code.",
)
async def browser_analyze_page() -> str:
    if not HAVE_PLAYWRIGHT:
        return missing_dependency("browser_analyze_page", "playwright")
    page = await get_browser_manager().page()
    editor = None
    for sel in _EDITOR_SELECTORS:
        try:
            if await page.locator(sel).first.is_visible(timeout=300):
                editor = sel
                break
        except Exception:
            continue
    run_button = None
    for text in _RUN_TEXTS:
        try:
            if await page.get_by_role("button", name=text).first.is_visible(timeout=300):
                run_button = text
                break
        except Exception:
            continue
    return json.dumps({
        "url": page.url,
        "title": await page.title(),
        "editor_selector": editor,
        "run_button": run_button,
        "ready_for_code": bool(editor),
    })

TOOL = browser_analyze_page
