"""Calendar search (reference ``search_calendar.py:120-180``):
query/date-range/attendee/calendar filters."""

from __future__ import annotations

import json

from whisper_mlx_tpu_torch.serving.tools.base import tool
from whisper_mlx_tpu_torch.serving.sync import storage


def _event_time(e: dict) -> str:
    start = e.get("start")
    if isinstance(start, dict):
        return start.get("dateTime") or start.get("date") or ""
    return str(start or "")


@tool(
    name="search_calendar",
    description=(
        "Search synced calendar events: free-text query, date range "
        "(after/before ISO), attendee substring, calendar name, account."
    ),
    parameters={
        "query": {"type": "string"},
        "after": {"type": "string", "description": "ISO date lower bound"},
        "before": {"type": "string", "description": "ISO date upper bound (exclusive)"},
        "attendee": {"type": "string", "description": "attendee email/name substring"},
        "calendar": {"type": "string", "description": "calendar name substring"},
        "account": {"type": "string"},
        "limit": {"type": "integer", "description": "max results (default 10, max 50)"},
    },
)
def search_calendar(
    query: str = "", after: str = "", before: str = "", attendee: str = "",
    calendar: str = "", account: str = "", limit: int = 10,
) -> str:
    limit = max(1, min(int(limit or 10), 50))
    accounts = storage.resolve_account(account or None)
    events = []
    for acct in accounts:
        for e in storage.load_events(acct):
            t = _event_time(e)
            if after and t and t[:10] < after[:10]:
                continue
            if before and t and t[:10] >= before[:10]:
                continue
            if calendar and calendar.lower() not in (e.get("calendar", "") or "").lower():
                continue
            if attendee:
                att = " ".join(
                    (a.get("email", "") + " " + a.get("displayName", ""))
                    if isinstance(a, dict) else str(a)
                    for a in e.get("attendees", [])
                ).lower()
                if attendee.lower() not in att:
                    continue
            if query:
                hay = " ".join(
                    str(e.get(k, "") or "") for k in ("summary", "description", "location")
                ).lower()
                if query.lower() not in hay:
                    continue
            events.append(dict(e, account=acct))
    events.sort(key=_event_time)
    return json.dumps({
        "total": len(events),
        "events": [
            {
                "id": e.get("id"),
                "account": e.get("account"),
                "start": _event_time(e),
                "summary": e.get("summary"),
                "location": e.get("location"),
                "attendees": len(e.get("attendees", [])),
            }
            for e in events[:limit]
        ],
    })


TOOL = search_calendar
