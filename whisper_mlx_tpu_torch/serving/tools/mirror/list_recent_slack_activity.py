"""Recent Slack activity overview (reference ``list_recent_slack_activity.py``):
per-channel recency with thread aggregation."""

from __future__ import annotations

import json
from collections import defaultdict

from whisper_mlx_tpu_torch.serving.tools.base import tool
from whisper_mlx_tpu_torch.serving.tools.mirror.data_store import get_data_store


@tool(
    name="list_recent_slack_activity",
    description=(
        "Overview of recent Slack activity: latest messages per channel, "
        "grouped into threads with reply counts."
    ),
    parameters={
        "channel": {"type": "string", "description": "restrict to one channel"},
        "limit": {"type": "integer", "description": "threads per channel (default 5, max 20)"},
    },
)
def list_recent_slack_activity(channel: str = "", limit: int = 5) -> str:
    limit = max(1, min(int(limit or 5), 20))
    store = get_data_store()
    channels = [channel] if channel else store.slack_channels()
    out = []
    for ch in channels:
        threads: dict[str, list] = defaultdict(list)
        for m in store.iter_slack_messages(ch):
            threads[m.thread_ts or m.ts].append(m)
        ranked = sorted(
            threads.items(),
            key=lambda kv: max(m.ts for m in kv[1]),
            reverse=True,
        )[:limit]
        out.append({
            "channel": ch,
            "threads": [
                {
                    "thread_ts": root_ts,
                    "replies": len(msgs) - 1,
                    "last_ts": max(m.ts for m in msgs),
                    "root_user": min(msgs, key=lambda m: m.ts).user,
                    "root_text": min(msgs, key=lambda m: m.ts).text[:200],
                }
                for root_ts, msgs in ranked
            ],
        })
    return json.dumps({"channels": out})


TOOL = list_recent_slack_activity
