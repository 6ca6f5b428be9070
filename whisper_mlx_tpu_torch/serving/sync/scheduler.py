"""Background sync scheduler (reference ``daemon/sync/scheduler.py``).

A dedicated daemon thread with its own event loop (reference :196-232)
syncing every account's gmail + calendar on a 5-minute cadence with a
365-day lookback (reference :22-23); per-cycle exceptions are swallowed and
logged so the loop survives (reference :141-142); graceful shutdown via an
event + join (reference :235-250).
"""

from __future__ import annotations

import asyncio
import logging
import threading

from whisper_mlx_tpu_torch.serving.sync.auth import AuthUnavailable, list_accounts

logger = logging.getLogger("qwen.sync.scheduler")

SYNC_INTERVAL_SECONDS = 300  # reference :22
LOOKBACK_DAYS = 365  # reference :23

_thread: threading.Thread | None = None
_stop_event = threading.Event()


async def _sync_cycle() -> None:
    from whisper_mlx_tpu_torch.serving.sync.calendar import sync_calendar
    from whisper_mlx_tpu_torch.serving.sync.gmail import sync_gmail

    loop = asyncio.get_running_loop()
    for account in list_accounts():
        for name, fn in (("gmail", sync_gmail), ("calendar", sync_calendar)):
            try:
                await loop.run_in_executor(None, fn, account, LOOKBACK_DAYS)
            except AuthUnavailable as exc:
                logger.info("%s sync skipped for %s: %s", name, account, exc)
            except Exception:
                # swallow and continue (reference :141-142)
                logger.exception("%s sync failed for %s", name, account)


async def _run_loop() -> None:
    logger.info("sync scheduler started (interval %ss)", SYNC_INTERVAL_SECONDS)
    while not _stop_event.is_set():
        await _sync_cycle()
        for _ in range(SYNC_INTERVAL_SECONDS):
            if _stop_event.is_set():
                return
            await asyncio.sleep(1)


def _thread_main() -> None:
    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)
    try:
        loop.run_until_complete(_run_loop())
    finally:
        loop.close()


def start_scheduler() -> None:
    """Start the dedicated sync thread (reference :208-232); no-op when no
    accounts are configured."""
    global _thread
    if _thread is not None and _thread.is_alive():
        return
    if not list_accounts():
        logger.info("no google accounts configured; sync scheduler idle")
        return
    _stop_event.clear()
    _thread = threading.Thread(target=_thread_main, name="sync-scheduler", daemon=True)
    _thread.start()


def stop_scheduler(timeout: float = 5.0) -> None:
    """Graceful shutdown (reference :235-250)."""
    global _thread
    _stop_event.set()
    if _thread is not None:
        _thread.join(timeout)
        _thread = None
