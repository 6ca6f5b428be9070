"""Slack thread fetch (reference ``get_slack_thread.py``)."""

from __future__ import annotations

import json

from whisper_mlx_tpu_torch.serving.tools.base import tool
from whisper_mlx_tpu_torch.serving.tools.mirror.data_store import get_data_store


@tool(
    name="get_slack_thread",
    description="Fetch a full Slack thread by channel and thread timestamp.",
    parameters={
        "channel": {"type": "string", "description": "channel name"},
        "thread_ts": {"type": "string", "description": "thread root ts"},
    },
    required=["channel", "thread_ts"],
)
def get_slack_thread(channel: str, thread_ts: str) -> str:
    msgs = get_data_store().slack_thread(channel, thread_ts)
    if not msgs:
        return json.dumps({"error": f"thread not found: {channel}/{thread_ts}"})
    return json.dumps({
        "channel": channel,
        "thread_ts": thread_ts,
        "messages": [
            {"ts": m.ts, "user": m.user, "text": m.text} for m in msgs
        ],
    })


TOOL = get_slack_thread
