"""Mirror data store: local Linear/Slack JSONL mirrors
(reference ``daemon/tools/mirror/data_store.py``).

Env-config dirs (reference :24-26), a per-request session contextvar used
by ``run_python`` for asset output dirs (reference :31-56), typed records,
and lazily-cached JSONL loading with streaming iterators + user resolution
(reference :169-341).
"""

from __future__ import annotations

import json
import os
import threading
from contextvars import ContextVar
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Iterator

LINEAR_MIRROR_DIR = os.environ.get("LINEAR_MIRROR_DIR", os.path.expanduser("~/linear-mirror"))
SLACK_MIRROR_DIR = os.environ.get(
    "VIBEOS_SLACK_MIRROR_DIR", os.path.expanduser("~/slack-mirror")
)
MIRROR_DATA_DIR = os.environ.get("MIRROR_DATA_DIR", os.path.expanduser("~/.qwen/mirror"))

# -- session context (reference data_store.py:31-56) -------------------------

_session_context: ContextVar[str | None] = ContextVar("mirror_session", default=None)


def set_session_context(session_id: str):
    return _session_context.set(session_id)


def get_session_context() -> str | None:
    return _session_context.get()


def reset_session_context(token) -> None:
    _session_context.reset(token)


def get_session_assets_dir() -> Path:
    session = get_session_context() or "default"
    path = Path(MIRROR_DATA_DIR) / "assets" / session
    path.mkdir(parents=True, exist_ok=True)
    return path


# -- records (reference data_store.py:62-163) --------------------------------


@dataclass(frozen=True)
class LinearComment:
    id: str
    body: str
    user: str
    created_at: str


@dataclass(frozen=True)
class LinearIssue:
    id: str
    identifier: str
    title: str
    description: str
    state: str
    assignee: str | None
    creator: str | None
    team: str | None
    priority: int | None
    labels: tuple[str, ...]
    created_at: str
    updated_at: str
    comments: tuple[LinearComment, ...] = ()

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "LinearIssue":
        return cls(
            id=d.get("id", ""),
            identifier=d.get("identifier", ""),
            title=d.get("title", ""),
            description=d.get("description") or "",
            state=(d.get("state") or {}).get("name") if isinstance(d.get("state"), dict) else (d.get("state") or ""),
            assignee=_person(d.get("assignee")),
            creator=_person(d.get("creator")),
            team=(d.get("team") or {}).get("name") if isinstance(d.get("team"), dict) else d.get("team"),
            priority=d.get("priority"),
            labels=tuple(
                (l.get("name") if isinstance(l, dict) else l) for l in (d.get("labels") or [])
            ),
            created_at=d.get("createdAt") or d.get("created_at") or "",
            updated_at=d.get("updatedAt") or d.get("updated_at") or "",
            comments=tuple(
                LinearComment(
                    id=c.get("id", ""),
                    body=c.get("body", ""),
                    user=_person(c.get("user")) or "",
                    created_at=c.get("createdAt") or c.get("created_at") or "",
                )
                for c in (d.get("comments") or [])
            ),
        )


def _person(p: Any) -> str | None:
    if p is None:
        return None
    if isinstance(p, dict):
        return p.get("displayName") or p.get("name") or p.get("email")
    return str(p)


@dataclass(frozen=True)
class LinearEvent:
    id: str
    issue_identifier: str
    type: str
    actor: str | None
    created_at: str
    data: dict[str, Any] = field(default_factory=dict, hash=False)


@dataclass(frozen=True)
class SlackMessage:
    channel: str
    ts: str
    thread_ts: str | None
    user: str
    text: str

    @classmethod
    def from_json(cls, channel: str, d: dict[str, Any]) -> "SlackMessage":
        return cls(
            channel=channel,
            ts=d.get("ts", ""),
            thread_ts=d.get("thread_ts"),
            user=d.get("user") or d.get("username") or "",
            text=d.get("text", ""),
        )


# -- store (reference data_store.py:169-341) --------------------------------


class MirrorDataStore:
    def __init__(
        self,
        linear_dir: str | Path = LINEAR_MIRROR_DIR,
        slack_dir: str | Path = SLACK_MIRROR_DIR,
    ) -> None:
        self.linear_dir = Path(linear_dir)
        self.slack_dir = Path(slack_dir)
        self._lock = threading.Lock()
        self._issues: list[LinearIssue] | None = None
        self._events: list[LinearEvent] | None = None
        self._users: dict[str, dict[str, Any]] | None = None

    # Linear ----------------------------------------------------------------

    def issues(self) -> list[LinearIssue]:
        with self._lock:
            if self._issues is None:
                self._issues = [
                    LinearIssue.from_json(d) for d in self._read_jsonl(self.linear_dir / "issues.jsonl")
                ]
            return self._issues

    def get_issue(self, identifier: str) -> LinearIssue | None:
        for issue in self.issues():
            if issue.identifier == identifier or issue.id == identifier:
                return issue
        return None

    def events(self) -> list[LinearEvent]:
        with self._lock:
            if self._events is None:
                self._events = [
                    LinearEvent(
                        id=d.get("id", ""),
                        issue_identifier=d.get("issueIdentifier") or d.get("issue_identifier") or "",
                        type=d.get("type", ""),
                        actor=_person(d.get("actor")),
                        created_at=d.get("createdAt") or d.get("created_at") or "",
                        data=d,
                    )
                    for d in self._read_jsonl(self.linear_dir / "events.jsonl")
                ]
            return self._events

    # Slack -----------------------------------------------------------------

    def slack_channels(self) -> list[str]:
        if not self.slack_dir.exists():
            return []
        return sorted(
            p.stem for p in self.slack_dir.glob("*.jsonl") if p.stem != "users"
        )

    def iter_slack_messages(self, channel: str | None = None) -> Iterator[SlackMessage]:
        channels = [channel] if channel else self.slack_channels()
        for ch in channels:
            for d in self._read_jsonl(self.slack_dir / f"{ch}.jsonl"):
                yield SlackMessage.from_json(ch, d)

    def slack_thread(self, channel: str, thread_ts: str) -> list[SlackMessage]:
        return sorted(
            (
                m
                for m in self.iter_slack_messages(channel)
                if m.thread_ts == thread_ts or m.ts == thread_ts
            ),
            key=lambda m: m.ts,
        )

    # users -----------------------------------------------------------------

    def users(self) -> dict[str, dict[str, Any]]:
        with self._lock:
            if self._users is None:
                self._users = {}
                for d in self._read_jsonl(self.slack_dir / "users.jsonl"):
                    uid = d.get("id") or d.get("user_id")
                    if uid:
                        self._users[uid] = d
            return self._users

    def resolve_user(self, query: str) -> list[dict[str, Any]]:
        q = query.lower()
        out = []
        for uid, d in self.users().items():
            hay = " ".join(
                str(x)
                for x in (
                    uid,
                    d.get("name"),
                    d.get("real_name"),
                    (d.get("profile") or {}).get("display_name"),
                    (d.get("profile") or {}).get("email"),
                )
                if x
            ).lower()
            if q in hay:
                out.append(d)
        return out

    def invalidate(self) -> None:
        with self._lock:
            self._issues = self._events = self._users = None

    @staticmethod
    def _read_jsonl(path: Path) -> Iterator[dict[str, Any]]:
        if not path.exists():
            return iter(())

        def gen():
            with open(path, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if line:
                        try:
                            yield json.loads(line)
                        except json.JSONDecodeError:
                            continue

        return gen()


_store: MirrorDataStore | None = None
_store_lock = threading.Lock()


def get_data_store() -> MirrorDataStore:
    global _store
    with _store_lock:
        if _store is None:
            _store = MirrorDataStore()
        return _store


def set_data_store(store: MirrorDataStore | None) -> None:
    """Test hook: swap the singleton."""
    global _store
    with _store_lock:
        _store = store
