"""Full calendar event fetch (reference ``get_calendar_event.py``)."""

from __future__ import annotations

import json

from whisper_mlx_tpu_torch.serving.tools.base import tool
from whisper_mlx_tpu_torch.serving.sync import storage


@tool(
    name="get_calendar_event",
    description="Fetch one synced calendar event by id (full detail incl. attendees/recurrence).",
    parameters={
        "id": {"type": "string", "description": "event id"},
        "account": {"type": "string"},
    },
    required=["id"],
)
def get_calendar_event(id: str, account: str = "") -> str:
    for acct in storage.resolve_account(account or None):
        e = storage.load_event(acct, id)
        if e is not None:
            return json.dumps(dict(e, account=acct))
    return json.dumps({"error": f"event not found: {id}"})


TOOL = get_calendar_event
