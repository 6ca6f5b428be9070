"""Slack mirror search (reference ``search_slack_messages.py``)."""

from __future__ import annotations

import json

from whisper_mlx_tpu_torch.serving.tools.base import tool
from whisper_mlx_tpu_torch.serving.tools.mirror.data_store import get_data_store


@tool(
    name="search_slack_messages",
    description=(
        "Search mirrored Slack messages (substring, case-insensitive) with "
        "optional channel/user filters and pagination."
    ),
    parameters={
        "query": {"type": "string", "description": "text to search for"},
        "channel": {"type": "string", "description": "restrict to one channel"},
        "user": {"type": "string", "description": "restrict to one user id/name"},
        "limit": {"type": "integer", "description": "results per page (default 10, max 50)"},
        "page": {"type": "integer", "description": "1-based page"},
    },
    required=["query"],
)
def search_slack_messages(
    query: str, channel: str = "", user: str = "", limit: int = 10, page: int = 1
) -> str:
    limit = max(1, min(int(limit or 10), 50))
    page = max(1, int(page or 1))
    q = query.lower()
    store = get_data_store()
    matches = [
        m
        for m in store.iter_slack_messages(channel or None)
        if q in m.text.lower() and (not user or user == m.user)
    ]
    matches.sort(key=lambda m: m.ts, reverse=True)
    total = len(matches)
    start = (page - 1) * limit
    return json.dumps({
        "total": total,
        "page": page,
        "messages": [
            {
                "channel": m.channel,
                "ts": m.ts,
                "thread_ts": m.thread_ts,
                "user": m.user,
                "text": m.text[:500],
            }
            for m in matches[start : start + limit]
        ],
    })


TOOL = search_slack_messages
