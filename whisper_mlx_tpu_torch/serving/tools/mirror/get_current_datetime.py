"""Current date/time tool (reference ``daemon/tools/mirror/get_current_datetime.py``)."""

from __future__ import annotations

import json
from datetime import datetime, timedelta, timezone

from whisper_mlx_tpu_torch.serving.tools.base import tool


@tool(
    name="get_current_datetime",
    description=(
        "Get the current date and time (UTC and local), plus convenient "
        "date-range hints (today, yesterday, last 7/30 days) for use in "
        "other tools' date filters."
    ),
)
def get_current_datetime() -> str:
    now_utc = datetime.now(timezone.utc)
    now_local = now_utc.astimezone()
    today = now_local.date()
    return json.dumps({
        "utc": now_utc.isoformat(),
        "local": now_local.isoformat(),
        "timezone": str(now_local.tzinfo),
        "date": today.isoformat(),
        "ranges": {
            "today": {"after": today.isoformat(), "before": (today + timedelta(days=1)).isoformat()},
            "yesterday": {"after": (today - timedelta(days=1)).isoformat(), "before": today.isoformat()},
            "last_7_days": {"after": (today - timedelta(days=7)).isoformat(), "before": (today + timedelta(days=1)).isoformat()},
            "last_30_days": {"after": (today - timedelta(days=30)).isoformat(), "before": (today + timedelta(days=1)).isoformat()},
        },
    })


TOOL = get_current_datetime
