"""Generic lazily-built search index over typed items
(reference ``daemon/tools/google/fts/index.py``).

``SearchIndex[T]`` wraps a document extractor + BM25 scorer, built on first
query and rebuilt when the item provider changes (reference :45-200);
email/event text extractors at the bottom (reference :206-252).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Generic, TypeVar

from whisper_mlx_tpu_torch.serving.tools.google.fts.bm25 import BM25Scorer

T = TypeVar("T")


@dataclass
class SearchResult(Generic[T]):
    item: T
    score: float


@dataclass
class SearchResponse(Generic[T]):
    results: list[SearchResult[T]]
    total_indexed: int
    query: str


class SearchIndex(Generic[T]):
    """Lazy BM25 index over ``items_fn()`` with ``text_fn`` extraction."""

    def __init__(
        self,
        items_fn: Callable[[], list[T]],
        text_fn: Callable[[T], str],
        k1: float = 1.5,
        b: float = 0.75,
    ) -> None:
        self._items_fn = items_fn
        self._text_fn = text_fn
        self._k1, self._b = k1, b
        self._lock = threading.Lock()
        self._items: list[T] | None = None
        self._scorer: BM25Scorer | None = None

    def _ensure_built(self) -> None:
        with self._lock:
            if self._scorer is None:
                self._items = list(self._items_fn())
                self._scorer = BM25Scorer.from_documents(
                    [self._text_fn(i) for i in self._items], self._k1, self._b
                )

    def invalidate(self) -> None:
        with self._lock:
            self._items = None
            self._scorer = None

    def search(
        self,
        query: str,
        top_n: int = 10,
        predicate: Callable[[T], bool] | None = None,
    ) -> SearchResponse[T]:
        self._ensure_built()
        assert self._scorer is not None and self._items is not None
        ranked = self._scorer.rank(query, top_n=top_n * 5 if predicate else top_n)
        results = []
        for idx, score in ranked:
            item = self._items[idx]
            if predicate is not None and not predicate(item):
                continue
            results.append(SearchResult(item=item, score=score))
            if len(results) >= top_n:
                break
        return SearchResponse(results=results, total_indexed=len(self._items), query=query)


# -- extractors (reference index.py:206-252) ---------------------------------


def email_text(email: dict[str, Any]) -> str:
    parts = [
        email.get("subject", ""),
        email.get("from", ""),
        email.get("to", ""),
        email.get("snippet", ""),
        email.get("body", "")[:5000],
    ]
    return "\n".join(p for p in parts if p)


def event_text(event: dict[str, Any]) -> str:
    attendees = " ".join(
        a.get("email", "") if isinstance(a, dict) else str(a)
        for a in event.get("attendees", [])
    )
    parts = [
        event.get("summary", ""),
        event.get("description", "") or "",
        event.get("location", "") or "",
        attendees,
    ]
    return "\n".join(p for p in parts if p)
