"""Linear issue search (reference ``daemon/tools/mirror/search_linear_issues.py``):
substring query + state/assignee/team filters + pagination."""

from __future__ import annotations

import json

from whisper_mlx_tpu_torch.serving.tools.base import tool
from whisper_mlx_tpu_torch.serving.tools.mirror.data_store import get_data_store


@tool(
    name="search_linear_issues",
    description=(
        "Search the local Linear mirror. Case-insensitive substring match "
        "over title/description, with optional state/assignee/team filters "
        "and pagination (limit/page)."
    ),
    parameters={
        "query": {"type": "string", "description": "substring to match (optional)"},
        "state": {"type": "string", "description": "issue state filter, e.g. 'In Progress'"},
        "assignee": {"type": "string", "description": "assignee name substring"},
        "team": {"type": "string", "description": "team name substring"},
        "limit": {"type": "integer", "description": "results per page (default 10, max 50)"},
        "page": {"type": "integer", "description": "1-based page number"},
    },
)
def search_linear_issues(
    query: str = "",
    state: str = "",
    assignee: str = "",
    team: str = "",
    limit: int = 10,
    page: int = 1,
) -> str:
    limit = max(1, min(int(limit or 10), 50))
    page = max(1, int(page or 1))
    q = (query or "").lower()

    matches = []
    for issue in get_data_store().issues():
        if q and q not in issue.title.lower() and q not in issue.description.lower():
            continue
        if state and state.lower() != (issue.state or "").lower():
            continue
        if assignee and assignee.lower() not in (issue.assignee or "").lower():
            continue
        if team and team.lower() not in (issue.team or "").lower():
            continue
        matches.append(issue)

    matches.sort(key=lambda i: i.updated_at, reverse=True)
    total = len(matches)
    start = (page - 1) * limit
    page_items = matches[start : start + limit]
    return json.dumps({
        "total": total,
        "page": page,
        "pages": max(1, -(-total // limit)),
        "issues": [
            {
                "identifier": i.identifier,
                "title": i.title,
                "state": i.state,
                "assignee": i.assignee,
                "team": i.team,
                "updated_at": i.updated_at,
            }
            for i in page_items
        ],
    })


TOOL = search_linear_issues
