"""Persistent sessions (reference ``daemon/sessions.py``).

JSON file per session, path-traversal-safe ids (reference :157-161), atomic
temp-file+rename saves (reference :191-203), auto-title from the first user
message (reference :118-119), summaries (:235-264) and empty-session
pruning (:266-292).
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
import uuid
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

_SAFE_ID = re.compile(r"^[A-Za-z0-9_-]+$")

DEFAULT_SESSIONS_DIR = Path(
    os.environ.get("QWEN_SESSIONS_DIR", os.path.expanduser("~/.qwen/sessions"))
)


@dataclass
class SessionMessage:
    role: str
    content: str
    timestamp: float = field(default_factory=time.time)
    meta: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        d = {"role": self.role, "content": self.content, "timestamp": self.timestamp}
        if self.meta:
            d["meta"] = self.meta
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "SessionMessage":
        return cls(
            role=d["role"], content=d["content"],
            timestamp=d.get("timestamp", 0.0), meta=d.get("meta", {}),
        )


@dataclass
class Session:
    id: str
    title: str = ""
    profile: str = "general"
    model_size: str = "large"
    created_at: float = field(default_factory=time.time)
    updated_at: float = field(default_factory=time.time)
    messages: list[SessionMessage] = field(default_factory=list)

    def add_message(self, role: str, content: str, **meta: Any) -> SessionMessage:
        msg = SessionMessage(role=role, content=content, meta=meta)
        self.messages.append(msg)
        self.updated_at = time.time()
        if not self.title and role == "user":
            # auto-title from the first user message (reference :118-119)
            self.title = content.strip().replace("\n", " ")[:60]
        return msg

    def to_dict(self) -> dict[str, Any]:
        return {
            "id": self.id, "title": self.title, "profile": self.profile,
            "model_size": self.model_size, "created_at": self.created_at,
            "updated_at": self.updated_at,
            "messages": [m.to_dict() for m in self.messages],
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Session":
        return cls(
            id=d["id"], title=d.get("title", ""), profile=d.get("profile", "general"),
            model_size=d.get("model_size", "large"),
            created_at=d.get("created_at", 0.0), updated_at=d.get("updated_at", 0.0),
            messages=[SessionMessage.from_dict(m) for m in d.get("messages", [])],
        )

    def summary(self) -> dict[str, Any]:
        return {
            "id": self.id, "title": self.title, "profile": self.profile,
            "model_size": self.model_size, "created_at": self.created_at,
            "updated_at": self.updated_at, "message_count": len(self.messages),
        }


class SessionStore:
    def __init__(self, directory: str | Path = DEFAULT_SESSIONS_DIR):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()

    def _path(self, session_id: str) -> Path:
        # path-traversal-safe ids (reference :157-161)
        if not _SAFE_ID.match(session_id):
            raise ValueError(f"invalid session id: {session_id!r}")
        return self.directory / f"{session_id}.json"

    def create(self, profile: str = "general", model_size: str = "large",
               title: str = "") -> Session:
        session = Session(
            id=uuid.uuid4().hex[:12], title=title,
            profile=profile, model_size=model_size,
        )
        self.save(session)
        return session

    def get(self, session_id: str) -> Session | None:
        path = self._path(session_id)
        if not path.exists():
            return None
        try:
            return Session.from_dict(json.loads(path.read_text()))
        except (json.JSONDecodeError, KeyError):
            return None

    def save(self, session: Session) -> None:
        # atomic temp-file + rename (reference :191-203)
        path = self._path(session.id)
        with self._lock:
            tmp = path.with_suffix(f".tmp{os.getpid()}")
            tmp.write_text(json.dumps(session.to_dict()))
            tmp.replace(path)

    def delete(self, session_id: str) -> bool:
        path = self._path(session_id)
        if path.exists():
            path.unlink()
            return True
        return False

    def list_summaries(self) -> list[dict[str, Any]]:
        out = []
        for p in self.directory.glob("*.json"):
            try:
                s = Session.from_dict(json.loads(p.read_text()))
            except (json.JSONDecodeError, KeyError):
                continue
            out.append(s.summary())
        out.sort(key=lambda s: s["updated_at"], reverse=True)
        return out

    def prune_empty(self, max_age_seconds: float = 0.0) -> int:
        """Delete message-less sessions older than ``max_age_seconds``
        (reference :266-292)."""
        removed = 0
        now = time.time()
        for p in list(self.directory.glob("*.json")):
            try:
                s = Session.from_dict(json.loads(p.read_text()))
            except (json.JSONDecodeError, KeyError):
                continue
            if not s.messages and (now - s.updated_at) >= max_age_seconds:
                p.unlink(missing_ok=True)
                removed += 1
        return removed


_store: SessionStore | None = None
_store_lock = threading.Lock()


def get_session_store() -> SessionStore:
    global _store
    with _store_lock:
        if _store is None:
            _store = SessionStore()
        return _store


def set_session_store(store: SessionStore | None) -> None:
    global _store
    with _store_lock:
        _store = store
