"""Navigate + cookie-popup dismissal (reference ``browser_navigate.py:33-95``)."""
import json
from whisper_mlx_tpu_torch.serving.tools.base import tool, missing_dependency
from whisper_mlx_tpu_torch.serving.tools.browser.manager import HAVE_PLAYWRIGHT, get_browser_manager

_DISMISS_CSS = (
    "[id*='cookie'] button, [class*='cookie'] button, [id*='consent'] button,"
    "[class*='consent'] button"
)
_DISMISS_TEXTS = [
    "Accept all", "Accept All", "Accept", "I agree", "Agree", "Allow all",
    "Got it", "OK", "Continue", "Reject all", "Reject All", "Decline",
    "No thanks", "Dismiss", "Close", "Akzeptieren", "Alle akzeptieren",
    "Tout accepter", "Aceptar", "Accetta", "Aceitar", "同意", "허용",
    "Zustimmen", "Souhlasím", "Akceptuję", "Принять", "قبول",
]

@tool(
    name="browser_navigate",
    description="Navigate the shared browser to a URL; cookie popups are auto-dismissed.",
    parameters={"url": {"type": "string"}},
    required=["url"],
)
async def browser_navigate(url: str) -> str:
    if not HAVE_PLAYWRIGHT:
        return missing_dependency("browser_navigate", "playwright")
    page = await get_browser_manager().page()
    await page.goto(url, wait_until="domcontentloaded", timeout=30_000)
    # CSS style injection hiding common banners + dismiss-button chain
    try:
        await page.add_style_tag(content="[id*='cookie-banner'],[class*='cookie-banner'],[id*='CookieConsent']{display:none !important}")
    except Exception:
        pass
    dismissed = False
    for text in _DISMISS_TEXTS:
        try:
            btn = page.get_by_role("button", name=text, exact=True).first
            if await btn.is_visible(timeout=200):
                await btn.click(timeout=1_000)
                dismissed = True
                break
        except Exception:
            continue
    return json.dumps({"url": page.url, "title": await page.title(), "cookie_popup_dismissed": dismissed})

TOOL = browser_navigate
