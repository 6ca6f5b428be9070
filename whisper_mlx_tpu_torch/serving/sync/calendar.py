"""Calendar sync (reference ``daemon/sync/calendar.py``).

Lookback + 365-day lookahead windows (reference :30-43), per-calendar event
listing, normalization incl. attendees/conference/recurrence (reference
:71-110).
"""

from __future__ import annotations

import logging
from datetime import datetime, timedelta, timezone
from typing import Any

from whisper_mlx_tpu_torch.serving.sync import storage
from whisper_mlx_tpu_torch.serving.sync.auth import AuthUnavailable, get_credentials

logger = logging.getLogger("qwen.sync.calendar")


def normalize_event(event: dict[str, Any], calendar: str) -> dict[str, Any]:
    return {
        "id": event["id"],
        "calendar": calendar,
        "summary": event.get("summary", ""),
        "description": event.get("description"),
        "location": event.get("location"),
        "start": event.get("start", {}),
        "end": event.get("end", {}),
        "status": event.get("status"),
        "organizer": (event.get("organizer") or {}).get("email"),
        "attendees": [
            {
                "email": a.get("email"),
                "displayName": a.get("displayName"),
                "responseStatus": a.get("responseStatus"),
            }
            for a in event.get("attendees", [])
        ],
        "conference": (
            (event.get("conferenceData") or {}).get("entryPoints", [{}])[0].get("uri")
            if event.get("conferenceData") else None
        ),
        "recurrence": event.get("recurrence"),
        "recurring_event_id": event.get("recurringEventId"),
    }


class CalendarSyncer:
    def __init__(self, account: str, lookback_days: int = 365,
                 lookahead_days: int = 365):
        self.account = account
        self.lookback_days = lookback_days
        self.lookahead_days = lookahead_days

    def _service(self):
        try:
            from googleapiclient.discovery import build
        except ImportError as exc:
            raise AuthUnavailable(f"googleapiclient not installed: {exc}") from exc
        return build("calendar", "v3", credentials=get_credentials(self.account),
                     cache_discovery=False)

    def sync(self) -> dict[str, Any]:
        service = self._service()
        now = datetime.now(timezone.utc)
        time_min = (now - timedelta(days=self.lookback_days)).isoformat()
        time_max = (now + timedelta(days=self.lookahead_days)).isoformat()

        fetched = 0
        calendars = service.calendarList().list().execute().get("items", [])
        for cal in calendars:
            cal_id = cal["id"]
            cal_name = cal.get("summary", cal_id)
            page_token = None
            while True:
                resp = service.events().list(
                    calendarId=cal_id, timeMin=time_min, timeMax=time_max,
                    singleEvents=True, maxResults=250, pageToken=page_token,
                ).execute()
                for event in resp.get("items", []):
                    storage.save_event(self.account, normalize_event(event, cal_name))
                    fetched += 1
                page_token = resp.get("nextPageToken")
                if not page_token:
                    break

        stats = {"fetched": fetched, "calendars": len(calendars)}
        storage.save_sync_state(self.account, "calendar", {"stats": stats})
        logger.info("calendar sync %s: %s", self.account, stats)
        return stats


def sync_calendar(account: str, lookback_days: int = 365) -> dict[str, Any]:
    return CalendarSyncer(account, lookback_days).sync()
