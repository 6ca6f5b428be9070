"""Pure-Python BM25 Okapi scorer
(reference ``daemon/tools/google/fts/bm25.py``).

Stopword filtering, a ≥2-char word tokenizer, corpus statistics built once
(``from_documents``), an IDF cache, per-document scoring and ranked search
(reference :31-268).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field

STOPWORDS = frozenset(
    """a an and are as at be by for from has he in is it its of on that the to
    was were will with this these those i you your we they them our us me my
    not no or if then than so do does did done been being have had can could
    should would may might must shall about into over under out up down off
    again further once here there when where why how all any both each few
    more most other some such only own same too very just don t s""".split()
)

_TOKEN_RE = re.compile(r"[a-z0-9]{2,}")


def tokenize(text: str) -> list[str]:
    """Lowercase word tokens, ≥2 chars, stopwords removed (reference :45-75)."""
    return [t for t in _TOKEN_RE.findall(text.lower()) if t not in STOPWORDS]


@dataclass
class BM25Scorer:
    """BM25 Okapi over a fixed corpus (reference :114-222)."""

    k1: float = 1.5
    b: float = 0.75
    doc_freqs: list[dict[str, int]] = field(default_factory=list)
    doc_lens: list[int] = field(default_factory=list)
    df: dict[str, int] = field(default_factory=dict)
    avgdl: float = 0.0
    _idf_cache: dict[str, float] = field(default_factory=dict)

    @classmethod
    def from_documents(cls, documents: list[str], k1: float = 1.5, b: float = 0.75) -> "BM25Scorer":
        scorer = cls(k1=k1, b=b)
        for text in documents:
            tokens = tokenize(text)
            freqs: dict[str, int] = {}
            for t in tokens:
                freqs[t] = freqs.get(t, 0) + 1
            scorer.doc_freqs.append(freqs)
            scorer.doc_lens.append(len(tokens))
            for t in freqs:
                scorer.df[t] = scorer.df.get(t, 0) + 1
        n = len(documents)
        scorer.avgdl = (sum(scorer.doc_lens) / n) if n else 0.0
        return scorer

    @property
    def num_docs(self) -> int:
        return len(self.doc_freqs)

    def idf(self, term: str) -> float:
        cached = self._idf_cache.get(term)
        if cached is None:
            n_t = self.df.get(term, 0)
            cached = math.log((self.num_docs - n_t + 0.5) / (n_t + 0.5) + 1.0)
            self._idf_cache[term] = cached
        return cached

    def score_document(self, query_terms: list[str], doc_idx: int) -> float:
        freqs = self.doc_freqs[doc_idx]
        dl = self.doc_lens[doc_idx]
        norm = self.k1 * (1 - self.b + self.b * dl / self.avgdl) if self.avgdl else self.k1
        score = 0.0
        for term in query_terms:
            f = freqs.get(term)
            if not f:
                continue
            score += self.idf(term) * f * (self.k1 + 1) / (f + norm)
        return score

    def rank(self, query: str, top_n: int = 10) -> list[tuple[int, float]]:
        """→ [(doc_idx, score)] best-first, zero-score docs dropped
        (reference :243-268)."""
        terms = tokenize(query)
        if not terms:
            return []
        scored = [
            (i, self.score_document(terms, i)) for i in range(self.num_docs)
        ]
        scored = [(i, s) for i, s in scored if s > 0]
        scored.sort(key=lambda x: -x[1])
        return scored[:top_n]
