"""BM25 email search (reference ``search_emails_fts.py`` — built but NOT
registered in the registry, matching the reference's registry state at
``daemon/tools/registry.py:229-237``)."""

from __future__ import annotations

import json

from whisper_mlx_tpu_torch.serving.tools.base import tool
from whisper_mlx_tpu_torch.serving.sync import storage
from whisper_mlx_tpu_torch.serving.tools.google.fts.index import SearchIndex, email_text

_index: SearchIndex | None = None


def _get_index() -> SearchIndex:
    global _index
    if _index is None:
        _index = SearchIndex(storage.load_all_emails, email_text)
    return _index


def invalidate_index() -> None:
    if _index is not None:
        _index.invalidate()


@tool(
    name="search_emails_fts",
    description="Relevance-ranked (BM25) full-text search over synced emails.",
    parameters={
        "query": {"type": "string"},
        "account": {"type": "string"},
        "limit": {"type": "integer", "description": "max results (default 10)"},
    },
    required=["query"],
)
def search_emails_fts(query: str, account: str = "", limit: int = 10) -> str:
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
                "date": r.item.get("date"),
                "from": r.item.get("from"),
                "subject": r.item.get("subject"),
                "snippet": (r.item.get("snippet") or r.item.get("body", ""))[:200],
            }
            for r in resp.results
        ],
    })


TOOL = search_emails_fts
