"""BM25 calendar search (reference ``search_calendar_fts.py`` — exists but
unregistered, matching the reference registry)."""

from __future__ import annotations

import json

from whisper_mlx_tpu_torch.serving.tools.base import tool
from whisper_mlx_tpu_torch.serving.sync import storage
from whisper_mlx_tpu_torch.serving.tools.google.fts.index import SearchIndex, event_text

_index: SearchIndex | None = None


def _get_index() -> SearchIndex:
    global _index
    if _index is None:
        _index = SearchIndex(storage.load_all_events, event_text)
    return _index


def invalidate_index() -> None:
    if _index is not None:
        _index.invalidate()


@tool(
    name="search_calendar_fts",
    description="Relevance-ranked (BM25) full-text search over synced calendar events.",
    parameters={
        "query": {"type": "string"},
        "account": {"type": "string"},
        "limit": {"type": "integer"},
    },
    required=["query"],
)
def search_calendar_fts(query: str, account: str = "", limit: int = 10) -> str:
    limit = max(1, min(int(limit or 10), 50))
    pred = (lambda e: e.get("account") == account) if account else None
    resp = _get_index().search(query, top_n=limit, predicate=pred)
    return json.dumps({
        "total_indexed": resp.total_indexed,
        "results": [
            {
                "score": round(r.score, 3),
                "id": r.item.get("id"),
                "account": r.item.get("account"),
                "summary": r.item.get("summary"),
            }
            for r in resp.results
        ],
    })


TOOL = search_calendar_fts
