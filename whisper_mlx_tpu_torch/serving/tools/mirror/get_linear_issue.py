"""Single Linear issue fetch (reference ``get_linear_issue.py``): full body
with comments, description truncated at 2000 chars."""

from __future__ import annotations

import json

from whisper_mlx_tpu_torch.serving.tools.base import tool
from whisper_mlx_tpu_torch.serving.tools.mirror.data_store import get_data_store

DESCRIPTION_LIMIT = 2000


@tool(
    name="get_linear_issue",
    description="Fetch one Linear issue by identifier (e.g. 'ENG-123') with comments.",
    parameters={
        "identifier": {"type": "string", "description": "issue identifier or id"},
    },
    required=["identifier"],
)
def get_linear_issue(identifier: str) -> str:
    issue = get_data_store().get_issue(identifier)
    if issue is None:
        return json.dumps({"error": f"issue not found: {identifier}"})
    desc = issue.description
    truncated = len(desc) > DESCRIPTION_LIMIT
    return json.dumps({
        "identifier": issue.identifier,
        "title": issue.title,
        "description": desc[:DESCRIPTION_LIMIT] + ("…" if truncated else ""),
        "description_truncated": truncated,
        "state": issue.state,
        "assignee": issue.assignee,
        "creator": issue.creator,
        "team": issue.team,
        "priority": issue.priority,
        "labels": list(issue.labels),
        "created_at": issue.created_at,
        "updated_at": issue.updated_at,
        "comments": [
            {"user": c.user, "created_at": c.created_at, "body": c.body}
            for c in issue.comments
        ],
    })


TOOL = get_linear_issue
