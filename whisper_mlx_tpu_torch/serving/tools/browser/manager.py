"""Playwright browser manager singleton
(reference ``daemon/tools/browser/manager.py:35-96``).

Single async chromium instance with clipboard permissions, blocked service
workers and a consent-management (CMP) URL blocklist routed to abort. All
browser tools gate on :func:`available` — without playwright installed they
return a structured missing-dependency error (this image has no browsers).
"""

from __future__ import annotations

import asyncio

try:
    from playwright.async_api import async_playwright  # type: ignore

    HAVE_PLAYWRIGHT = True
except ImportError:
    HAVE_PLAYWRIGHT = False

# CMP/consent scripts blocked at the network layer (reference :60-84)
CMP_BLOCK_PATTERNS = [
    "**/*cookielaw*", "**/*onetrust*", "**/*cookiebot*", "**/*usercentrics*",
    "**/*consentmanager*", "**/*quantcast*", "**/*didomi*", "**/*trustarc*",
    "**/*sourcepoint*", "**/*cmp.*.js", "**/*cookie-consent*", "**/*cookieconsent*",
    "**/*gdpr*consent*", "**/*privacy-center*", "**/*sp-prod*", "**/*consensu.org*",
    "**/*cookie-law*", "**/*cookie_consent*", "**/*iubenda*", "**/*osano*",
    "**/*termly*",
]


class BrowserManager:
    _instance: "BrowserManager | None" = None

    def __init__(self) -> None:
        self._pw = None
        self._browser = None
        self._context = None
        self._page = None
        self._lock = asyncio.Lock()

    @classmethod
    def get(cls) -> "BrowserManager":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    async def page(self):
        if not HAVE_PLAYWRIGHT:
            raise RuntimeError("playwright is not installed")
        async with self._lock:
            if self._page is None or self._page.is_closed():
                if self._browser is None:
                    self._pw = await async_playwright().start()
                    # headless=False in the reference (visible browser);
                    # headless in CI-like environments
                    self._browser = await self._pw.chromium.launch(headless=True)
                    self._context = await self._browser.new_context(
                        permissions=["clipboard-read", "clipboard-write"],
                        service_workers="block",
                    )
                    for pattern in CMP_BLOCK_PATTERNS:
                        await self._context.route(pattern, lambda r: asyncio.ensure_future(r.abort()))
                self._page = await self._context.new_page()
            return self._page

    async def close(self) -> None:
        async with self._lock:
            for closer in (self._context, self._browser):
                if closer is not None:
                    try:
                        await closer.close()
                    except Exception:
                        pass
            if self._pw is not None:
                try:
                    await self._pw.stop()
                except Exception:
                    pass
            self._pw = self._browser = self._context = self._page = None


def get_browser_manager() -> BrowserManager:
    return BrowserManager.get()
