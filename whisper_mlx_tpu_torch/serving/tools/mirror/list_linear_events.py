"""Linear event feed (reference ``list_linear_events.py``): recent activity
with type/issue filters + pagination."""

from __future__ import annotations

import json

from whisper_mlx_tpu_torch.serving.tools.base import tool
from whisper_mlx_tpu_torch.serving.tools.mirror.data_store import get_data_store


@tool(
    name="list_linear_events",
    description="List recent Linear events (issue created/updated/commented...), newest first.",
    parameters={
        "issue": {"type": "string", "description": "filter by issue identifier"},
        "type": {"type": "string", "description": "filter by event type substring"},
        "limit": {"type": "integer", "description": "results per page (default 20, max 100)"},
        "page": {"type": "integer", "description": "1-based page"},
    },
)
def list_linear_events(issue: str = "", type: str = "", limit: int = 20, page: int = 1) -> str:
    limit = max(1, min(int(limit or 20), 100))
    page = max(1, int(page or 1))
    events = [
        e
        for e in get_data_store().events()
        if (not issue or e.issue_identifier == issue)
        and (not type or type.lower() in e.type.lower())
    ]
    events.sort(key=lambda e: e.created_at, reverse=True)
    total = len(events)
    start = (page - 1) * limit
    return json.dumps({
        "total": total,
        "page": page,
        "events": [
            {
                "issue": e.issue_identifier,
                "type": e.type,
                "actor": e.actor,
                "created_at": e.created_at,
            }
            for e in events[start : start + limit]
        ],
    })


TOOL = list_linear_events
